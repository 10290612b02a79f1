// sort_native.cpp — parallel LSD radix argsort over uint64 keys.
//
// Converters sort the nnz stream by 64-bit keys (row-major COO order, block
// and diagonal keys).  numpy's introsort on 100 M int64 keys runs ~60-90 s
// single-core and was the dominant OptimizeTime term on the giant suite
// matrices.  A stable LSD radix over only the occupied key bytes
// with OpenMP-parallel histogram + scatter passes runs the same sort in a few
// seconds on 4 cores.
//
// C ABI: radix_argsort_u64(keys, n, idx_out) sorts indices so that
// keys[idx_out] is ascending (stable).  Returns 0 on success.
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Pair {
    uint64_t key;
    int64_t idx;
};

}  // namespace

extern "C" int radix_argsort_u64(const uint64_t* keys, int64_t n,
                                 int64_t* idx_out) {
    if (n <= 0) return 0;
    if (n == 1) { idx_out[0] = 0; return 0; }

    uint64_t maxk = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(max : maxk) schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i)
        if (keys[i] > maxk) maxk = keys[i];

    int passes = 0;
    for (uint64_t m = maxk; m; m >>= 8) ++passes;
    if (passes == 0) passes = 1;

    // calloc, not malloc: on this machine's gVisor-class kernel anonymous
    // first-touch faults on malloc'd pages run ~1 ms/page while calloc'd
    // mappings write at full speed (see core/hostmem.py).
    Pair* a = static_cast<Pair*>(calloc((size_t)n, sizeof(Pair)));
    Pair* b = static_cast<Pair*>(calloc((size_t)n, sizeof(Pair)));
    if (!a || !b) { free(a); free(b); return -1; }

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) { a[i].key = keys[i]; a[i].idx = i; }

#ifdef _OPENMP
    const int nt = omp_get_max_threads();
#else
    const int nt = 1;
#endif
    const int64_t chunk = (n + nt - 1) / nt;
    // hist[t][d]: count of digit d in thread t's chunk (one pass at a time)
    int64_t* hist = static_cast<int64_t*>(
        calloc((size_t)nt * 256, sizeof(int64_t)));
    if (!hist) { free(a); free(b); return -1; }

    for (int p = 0; p < passes; ++p) {
        const int shift = 8 * p;
        memset(hist, 0, (size_t)nt * 256 * sizeof(int64_t));
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
#ifdef _OPENMP
            const int t = omp_get_thread_num();
#else
            const int t = 0;
#endif
            const int64_t lo = t * chunk;
            const int64_t hi = lo + chunk < n ? lo + chunk : n;
            int64_t* h = hist + (size_t)t * 256;
            for (int64_t i = lo; i < hi; ++i)
                ++h[(a[i].key >> shift) & 0xff];
        }
        // exclusive scan in (digit, thread) order keeps the sort stable
        int64_t sum = 0;
        for (int d = 0; d < 256; ++d)
            for (int t = 0; t < nt; ++t) {
                const int64_t c = hist[(size_t)t * 256 + d];
                hist[(size_t)t * 256 + d] = sum;
                sum += c;
            }
#ifdef _OPENMP
#pragma omp parallel num_threads(nt)
#endif
        {
#ifdef _OPENMP
            const int t = omp_get_thread_num();
#else
            const int t = 0;
#endif
            const int64_t lo = t * chunk;
            const int64_t hi = lo + chunk < n ? lo + chunk : n;
            int64_t* h = hist + (size_t)t * 256;
            for (int64_t i = lo; i < hi; ++i)
                b[h[(a[i].key >> shift) & 0xff]++] = a[i];
        }
        Pair* tmp = a; a = b; b = tmp;
    }

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) idx_out[i] = a[i].idx;

    free(a); free(b); free(hist);
    return 0;
}
