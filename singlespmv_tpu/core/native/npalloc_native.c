/* npalloc_native — NEP-49 numpy data allocator for slow-huge-fault hosts.
 *
 * On this machine's microVM kernel a 2 MB transparent-huge-page write fault
 * stalls ~360 ms, and numpy madvises MADV_HUGEPAGE on every buffer >= 4 MB by
 * default — so np.empty/np.full/np.arange/astype and every large ufunc
 * temporary take minutes at GB scale (measured: 1 GB np.empty+fill 72.6 s
 * = 200 huge faults x 0.36 s; plain 4 KB faults run ~2 GB/s).  This handler
 * routes every numpy data allocation >= 128 KB through mmap with
 * MADV_NOHUGEPAGE (defensive: the package also turns numpy's own madvise
 * off), plus a thread-safe freelist so repeated conversions (format sweeps)
 * reuse already-faulted memory and skip even the 4 KB fault cost.
 *
 * The reference avoids this class of cost with _mm_malloc arenas
 * (reference src/util.cpp:92-102); this is the host-side analog.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION  /* exposes PyDataMem_SetHandler */
#include <numpy/arrayobject.h>

#include <malloc.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#define TH ((size_t)(128u * 1024u))        /* glibc's initial mmap threshold:
                                              everything >= TH is ours, so no
                                              glibc-mmap'd chunk ever reaches
                                              the realloc magic probe below */
#define HUGE_SZ ((size_t)(2u * 1024u * 1024u))
#define MAGIC 0x53704d56416c6c6fULL

typedef struct {
    uint64_t magic;
    size_t map_len;   /* total mmap length */
    void *map_base;   /* mmap base (data is aligned up from it) */
    size_t data_cap;  /* usable bytes at the data pointer */
} hdr_t;

#define FL_SLOTS 256
typedef struct { size_t cap; void *data; } fl_ent;
static fl_ent g_fl[FL_SLOTS];
static int g_fl_n = 0;
static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
static uint64_t g_hits = 0, g_maps = 0;

static hdr_t *hdr_of(void *data) {
    return (hdr_t *)((char *)data - sizeof(hdr_t));
}

static size_t round_cap(size_t size) {
    /* Power-of-two classes at every scale: beyond ~2.5 GB of process
     * lifetime this kernel's anonymous first-touch faults drop to
     * ~0.2 ms/page (~25-90 s/GB), so block REUSE is everything — and
     * exact-size caching never matches the varied large temporaries a
     * convert makes.  Pow2 classes trade <=2x VA waste (RAM is 125 GB)
     * for a freelist that actually hits. */
    size_t c = TH;
    while (c < size) c <<= 1;
    return c;
}

static void *map_new(size_t cap) {
    size_t need = cap + 4096 + HUGE_SZ;   /* header page + alignment slack */
    void *raw = mmap(NULL, need, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (raw == MAP_FAILED) return NULL;
    uintptr_t data = (((uintptr_t)raw + 4096 + HUGE_SZ - 1)
                      & ~((uintptr_t)HUGE_SZ - 1));
    (void)madvise((void *)data, cap, MADV_NOHUGEPAGE);
    hdr_t *h = hdr_of((void *)data);
    h->magic = MAGIC;
    h->map_len = need;
    h->map_base = raw;
    h->data_cap = cap;
    return (void *)data;
}

static void *big_alloc(size_t size, int zero) {
    size_t cap = round_cap(size);
    void *data = NULL;
    pthread_mutex_lock(&g_mu);
    int best = -1;
    for (int i = 0; i < g_fl_n; i++) {    /* exact class, else smallest
                                             cached block within 4x (cross-
                                             class reuse after prefault) */
        if (g_fl[i].cap == cap) { best = i; break; }
        if (g_fl[i].cap > cap && g_fl[i].cap <= cap * 4 &&
            (best < 0 || g_fl[i].cap < g_fl[best].cap))
            best = i;
    }
    if (best >= 0) {
        data = g_fl[best].data;
        g_fl[best] = g_fl[--g_fl_n];
        g_hits++;
    }
    pthread_mutex_unlock(&g_mu);
    if (data) {
        if (zero) memset(data, 0, size);
        return data;
    }
    pthread_mutex_lock(&g_mu);
    g_maps++;
    pthread_mutex_unlock(&g_mu);
    return map_new(cap);   /* fresh anonymous mmap is already zeroed */
}

static void big_free(void *data) {
    hdr_t *h = hdr_of(data);
    pthread_mutex_lock(&g_mu);
    if (g_fl_n < FL_SLOTS) {
        g_fl[g_fl_n].cap = h->data_cap;
        g_fl[g_fl_n].data = data;
        g_fl_n++;
        data = NULL;
    }
    pthread_mutex_unlock(&g_mu);
    if (data) munmap(h->map_base, h->map_len);
}

/* ------------------------------- NEP-49 handler ------------------------- */

static void *h_malloc(void *ctx, size_t size) {
    (void)ctx;
    if (size >= TH) return big_alloc(size, 0);
    return malloc(size);
}

static void *h_calloc(void *ctx, size_t nelem, size_t elsize) {
    (void)ctx;
    size_t size = nelem * elsize;  /* numpy validates overflow upstream */
    if (size >= TH) return big_alloc(size, 1);
    return calloc(nelem, elsize);
}

static void h_free(void *ctx, void *ptr, size_t size) {
    (void)ctx;
    if (!ptr) return;
    if (size >= TH) {       /* every >=TH allocation from this handler is ours */
        big_free(ptr);
        return;
    }
    free(ptr);
}

static void *h_realloc(void *ctx, void *ptr, size_t new_size) {
    (void)ctx;
    if (!ptr) return h_malloc(NULL, new_size);
    /* numpy routes realloc to the handler that allocated ptr, so ptr is
     * either ours (>= TH at allocation: magic header just below) or a glibc
     * heap chunk (< TH: glibc never mmap-serves < 128 KB, so the preceding
     * bytes are mapped arena metadata and the probe read is safe). */
    hdr_t *h = hdr_of(ptr);
    if (h->magic == MAGIC) {
        if (new_size <= h->data_cap) return ptr;
        void *n = big_alloc(new_size, 0);
        if (!n) return NULL;
        memcpy(n, ptr, h->data_cap);
        big_free(ptr);
        return n;
    }
    if (new_size >= TH) {   /* glibc-owned small block growing large */
        size_t old = malloc_usable_size(ptr);
        void *n = big_alloc(new_size, 0);
        if (!n) return NULL;
        memcpy(n, ptr, old < new_size ? old : new_size);
        free(ptr);
        return n;
    }
    return realloc(ptr, new_size);
}

static PyDataMem_Handler g_handler = {
    "singlespmv_hugepage",
    1,
    {
        NULL,
        h_malloc,
        h_calloc,
        h_realloc,
        h_free,
    },
};

/* --------------------------------- module ------------------------------- */

static PyObject *py_install(PyObject *self, PyObject *args) {
    (void)self; (void)args;
    PyObject *cap = PyCapsule_New(&g_handler, "mem_handler", NULL);
    if (!cap) return NULL;
    PyObject *old = PyDataMem_SetHandler(cap);
    Py_DECREF(cap);
    return old ? old : Py_None;
}

static PyObject *py_prefault(PyObject *self, PyObject *args) {
    /* Pay the one-time slow-fault cost up front: allocate `count` blocks of
     * `block_bytes`, touch every page twice (this kernel's pages reach full
     * write speed only after the second touch), then park them on the
     * freelist for converts to reuse.  Releases the GIL while touching. */
    (void)self;
    Py_ssize_t block_bytes, count;
    if (!PyArg_ParseTuple(args, "nn", &block_bytes, &count)) return NULL;
    if (count > FL_SLOTS) count = FL_SLOTS;
    void *blocks[FL_SLOTS];
    Py_ssize_t got = 0;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < count; i++) {
        void *d = big_alloc((size_t)block_bytes, 0);
        if (!d) break;
        memset(d, 0, (size_t)block_bytes);
        memset(d, 1, (size_t)block_bytes);
        blocks[got++] = d;
    }
    for (Py_ssize_t i = 0; i < got; i++) big_free(blocks[i]);
    Py_END_ALLOW_THREADS
    return PyLong_FromSsize_t(got);
}

static PyObject *py_stats(PyObject *self, PyObject *args) {
    (void)self; (void)args;
    pthread_mutex_lock(&g_mu);
    PyObject *d = Py_BuildValue("{s:K,s:K,s:i}", "freelist_hits", g_hits,
                                "mmaps", g_maps, "cached", g_fl_n);
    pthread_mutex_unlock(&g_mu);
    return d;
}

static PyMethodDef methods[] = {
    {"install", py_install, METH_NOARGS,
     "Install the hugepage NEP-49 handler; returns the previous handler."},
    {"prefault", py_prefault, METH_VARARGS,
     "prefault(block_bytes, count): pre-touch blocks onto the freelist."},
    {"stats", py_stats, METH_NOARGS, "Allocator counters."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_npalloc", NULL, -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__npalloc(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
