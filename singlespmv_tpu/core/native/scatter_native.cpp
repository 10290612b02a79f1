// Parallel grid scatter for convert layouts.
//
// Layout converts can end with fancy-index scatters (grid[r, c] = v over
// 10⁷-10⁸ entries); numpy runs them single-threaded at ~10⁸/s, which is the
// residual host cost of giant converts after the native radix sorts.  Positions
// are unique by construction (each nnz owns one slot), so a plain parallel
// loop is race-free.  C ABI for ctypes; original code, no reference analog
// (the reference's converts are single-pass C++ loops over tiny arrays).
#include <cstdint>
#include <cstring>

extern "C" {

#define DEF_SCATTER(NAME, T)                                               \
int NAME(T *grid, int64_t lanes_per_row,                                   \
         const int64_t *rows, const int64_t *lanes, const T *vals,         \
         int64_t n) {                                                      \
    _Pragma("omp parallel for schedule(static)")                           \
    for (int64_t i = 0; i < n; ++i) {                                      \
        grid[rows[i] * lanes_per_row + lanes[i]] = vals[i];                \
    }                                                                      \
    return 0;                                                              \
}

DEF_SCATTER(grid_scatter_i8, int8_t)
DEF_SCATTER(grid_scatter_f32, float)
DEF_SCATTER(grid_scatter_f64, double)

}  // extern "C"
