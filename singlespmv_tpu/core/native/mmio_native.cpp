// Native Matrix-Market parser — the runtime's fast I/O path.
//
// Re-design of the reference's loaders (the minimal reader at
// /root/reference/src/util.cpp:30-66 and the full vendored mmio parser used by the
// CSR5 drivers): one pass over a heap buffer with pointer-walking number parsing,
// full banner semantics (pattern/integer/real/complex fields; general/symmetric/
// skew-symmetric/hermitian), symmetric expansion skipping the diagonal duplicate,
// std::sort row-major ordering and optional duplicate summing.  Exposed to Python
// via a plain C ABI (ctypes) — no pybind11 dependency.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 mmio_native.cpp -o _mmio.so

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Triple {
    int64_t r, c;
    double v;
};

inline bool triple_less(const Triple& a, const Triple& b) {
    return a.r != b.r ? a.r < b.r : a.c < b.c;
}

inline void skip_ws(const char*& p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
}

inline void skip_line(const char*& p, const char* end) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
}

}  // namespace

extern "C" {

struct MtxResult {
    int64_t n_row, n_col, nnz;
    int64_t* rows;
    int64_t* cols;
    double* vals;
    char err[256];
};

void spmv_free_result(MtxResult* res) {
    if (!res) return;
    std::free(res->rows);
    std::free(res->cols);
    std::free(res->vals);
    std::free(res);
}

static MtxResult* fail(MtxResult* res, const char* msg) {
    std::snprintf(res->err, sizeof(res->err), "%s", msg);
    return res;
}

// Parses `path`; on success err[0] == '\0' and rows/cols/vals hold nnz triplets
// (0-based, row-major sorted).  sum_duplicates != 0 merges equal (r, c) entries.
MtxResult* spmv_load_mtx(const char* path, int sum_duplicates) {
    auto* res = static_cast<MtxResult*>(std::calloc(1, sizeof(MtxResult)));
    if (!res) return nullptr;

    FILE* f = std::fopen(path, "rb");
    if (!f) return fail(res, "cannot open file");
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf[got] = '\0';
    const char* p = buf.data();
    const char* end = p + got;

    // --- banner (optional; bannerless files default to real/general) ---
    bool pattern = false, complex_field = false;
    int sym = 0;  // 0 general, 1 symmetric, -1 skew, 2 hermitian
    if (got > 2 && p[0] == '%' && p[1] == '%') {
        char banner[256] = {0};
        const char* nl = static_cast<const char*>(memchr(p, '\n', got));
        size_t len = nl ? static_cast<size_t>(nl - p) : got;
        if (len >= sizeof(banner)) len = sizeof(banner) - 1;
        std::memcpy(banner, p, len);
        for (char* q = banner; *q; ++q) *q = static_cast<char>(std::tolower(*q));
        if (!std::strstr(banner, "matrixmarket") || !std::strstr(banner, "matrix"))
            return fail(res, "bad MatrixMarket banner");
        if (std::strstr(banner, "array"))
            return fail(res, "array format not supported in native path");
        if (std::strstr(banner, "pattern")) pattern = true;
        if (std::strstr(banner, "complex")) complex_field = true;
        if (std::strstr(banner, "skew-symmetric")) sym = -1;
        else if (std::strstr(banner, "symmetric")) sym = 1;
        else if (std::strstr(banner, "hermitian")) sym = 2;
        skip_line(p, end);
    }

    // --- comments + size line ---
    for (;;) {
        skip_ws(p, end);
        if (p >= end) return fail(res, "missing size line");
        if (*p == '%' || *p == '\n') { skip_line(p, end); continue; }
        break;
    }
    char* q;
    int64_t M = std::strtoll(p, &q, 10);
    int64_t N = std::strtoll(q, &q, 10);
    int64_t L = std::strtoll(q, &q, 10);
    p = q;
    skip_line(p, end);
    if (M <= 0 || N <= 0 || L < 0) return fail(res, "bad size line");

    std::vector<Triple> t;
    t.reserve(static_cast<size_t>(sym != 0 ? 2 * L : L));
    for (int64_t i = 0; i < L; ++i) {
        skip_ws(p, end);
        while (p < end && (*p == '\n' || *p == '%')) {
            skip_line(p, end);
            skip_ws(p, end);
        }
        if (p >= end) return fail(res, "unexpected EOF in triplets");
        int64_t r = std::strtoll(p, &q, 10);
        int64_t c = std::strtoll(q, &q, 10);
        double v = 1.0;
        if (!pattern) {
            v = std::strtod(q, &q);
            if (complex_field) std::strtod(q, &q);  // drop imaginary part
        }
        p = q;
        if (r < 1 || r > M || c < 1 || c > N)
            return fail(res, "index out of range");
        --r; --c;
        t.push_back({r, c, v});
        if (sym != 0 && r != c)
            t.push_back({c, r, sym == -1 ? -v : v});
    }

    std::sort(t.begin(), t.end(), triple_less);

    size_t n_out = t.size();
    if (sum_duplicates && !t.empty()) {
        size_t w = 0;
        for (size_t i = 1; i < t.size(); ++i) {
            if (t[i].r == t[w].r && t[i].c == t[w].c) {
                t[w].v += t[i].v;
            } else {
                t[++w] = t[i];
            }
        }
        n_out = w + 1;
    }

    res->n_row = M;
    res->n_col = N;
    res->nnz = static_cast<int64_t>(n_out);
    res->rows = static_cast<int64_t*>(std::malloc(n_out * sizeof(int64_t)));
    res->cols = static_cast<int64_t*>(std::malloc(n_out * sizeof(int64_t)));
    res->vals = static_cast<double*>(std::malloc(n_out * sizeof(double)));
    if ((!res->rows || !res->cols || !res->vals) && n_out)
        return fail(res, "out of memory");
    for (size_t i = 0; i < n_out; ++i) {
        res->rows[i] = t[i].r;
        res->cols[i] = t[i].c;
        res->vals[i] = t[i].v;
    }
    return res;
}

}  // extern "C"
