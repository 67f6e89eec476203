// K2 and K3: the two fine-level legs of the stacked V-cycle.
//
// Replaces fpr_tpu/ops/pallas2d.py::_smooth2r_stk_kernel (K2, built at
// pallas2d.py:1169, wrapped by smooth2r_stk) and
// fpr_tpu/ops/pallas2d.py::_corr_smooth2_stk_kernel (K3, built at
// pallas2d.py:1381, wrapped by corr_smooth2_stk).
//
//   K2 (down leg): ns damped-Jacobi sweeps  u += alpha h^2/C res(u),
//                  then the residual res(u) that is restricted next;
//   K3 (up leg):   u -= P(coarse correction), then ns sweeps, with the sum
//                  of squares of the residual that fed the last sweep;
//
// where res(u) = (u_N + u_S + u_W + u_E - C u) / h^2 - f on the interior,
// 0 on the boundary, C = 4 + c h^2 with c read from device memory.  With
// elim, after each sweep (and in K3 once before the first) the side columns
// become copies of their interior neighbours on every row
// (pallas2d.py::_elim_copy).  P interpolates the coarse correction in x
// first (x_interleave_coarse, done by the caller), then in y here:
// even fine rows take a coarse row, odd rows the mean of two
// (pallas2d.py:1292-1301).
//
// The same code runs #6 and #7 (pallas2d.py::_smooth2r_kernel and
// ::_corr_smooth2_kernel) with their shard hooks (pallas2d.py:547-573,
// 802-825): local row y is global row row_off + y of an ny_g-row grid and
// local column x global column col_off + x of an nx_g-column grid (col_off
// < 0 on a 2D mesh's left-edge shards); the interior follows the global
// row and column and leaves out the local first and last rows and columns,
// and the norm covers the owned cells, rows [own0, own1) x columns
// [ownc0, ownc1).  row_off must be even, so that the y interpolation's row
// parity is the global one; corrx is then the window of the x-interleaved
// coarse correction whose row k is global coarse row row_off/2 + k.
// col_off is even too (the restriction's column parity).  elim copies the
// local side columns, so it takes whole columns (the wrapper checks).  The
// column tests are compiled in only where the column hooks are not whole
// (the template flag COLS), as in defect.cu: they cost 2-4 % of a launch.
//
// Bound on the H100: memory bandwidth.  A sweep reads u and f and writes u
// (3 f32 words per cell, about 10 flops); the residual pass the same.
//
// Design: one launch per sweep, one thread per cell, reading one buffer
// and writing another (ping-pong), so no launch reads what it writes; the
// TPU kernels instead alias their output onto the level state and keep all
// ns sweeps on one VMEM slab.  The first sweep of K3 computes u - P for its
// neighbours on the fly, and K2's first sweep with a zero iterate is the
// closed form w * (-f).  The norm goes to per-block partials.  Left for
// later: several sweeps per launch on a shared-memory tile with a halo of
// ns rows, which cuts the traffic of a leg from about 3(ns+1) words per
// cell to 3.
#include "fpr_common.cuh"

namespace {

enum : int { SRC_ARRAY = 0, SRC_ZERO = 1, SRC_CORR = 2 };

__device__ __forceinline__ int elim_col(int x, int nx) {
    return x == 0 ? 1 : (x == nx - 1 ? nx - 2 : x);
}

template <bool COLS>
__device__ __forceinline__ bool is_interior(int y, int x, int ny, int nx, int gy, int ny_g,
                                            int gx, int nx_g) {
    return x > 0 && y > 0 && x < nx - 1 && y < ny - 1 && gy > 0 && gy < ny_g - 1 &&
           (!COLS || (gx > 0 && gx < nx_g - 1));
}

// The sweep's input field at (y, x).  SRC_CORR: u - P, with the pre-sweep
// side-column copy when elim is set.
__device__ __forceinline__ float value_at(const float* __restrict__ u,
                                          const float* __restrict__ corrx, int src,
                                          bool elim, int nx, int y, int x) {
    if (src != SRC_CORR) return u[y * nx + x];
    if (elim) x = elim_col(x, nx);
    const int k = y >> 1;
    const float c0 = corrx[k * nx + x];
    const float p = (y & 1) ? (c0 + corrx[(k + 1) * nx + x]) * 0.5f : c0;
    return u[y * nx + x] - p;
}

__device__ __forceinline__ float residual_at(const float* __restrict__ u,
                                             const float* __restrict__ f,
                                             const float* __restrict__ corrx, int src,
                                             bool elim, float C, float inv_h2, int nx,
                                             int y, int x) {
    const float vm = value_at(u, corrx, src, elim, nx, y - 1, x);
    const float vp = value_at(u, corrx, src, elim, nx, y + 1, x);
    const float vl = value_at(u, corrx, src, elim, nx, y, x - 1);
    const float vr = value_at(u, corrx, src, elim, nx, y, x + 1);
    const float v = value_at(u, corrx, src, elim, nx, y, x);
    return (vm + vp + vl + vr - C * v) * inv_h2 - f[y * nx + x];
}

template <bool COLS>
__global__ void __launch_bounds__(FPR_THREADS)
sweep_kernel(const float* __restrict__ u, const float* __restrict__ f,
             const float* __restrict__ corrx, const float* __restrict__ c, float h2,
             float inv_h2, float alpha, int ny, int nx, int src, int elim, int row_off,
             int ny_g, int own0, int own1, int col_off, int nx_g, int ownc0, int ownc1,
             float* __restrict__ out, float* __restrict__ partials) {
    __shared__ float sh[FPR_BY];
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    const int gy = row_off + y;
    float rsq = 0.0f;
    if (x < nx && y < ny) {
        // the constants in the order of pallas2d.py:1080-1082
        const float C = 4.0f + c[0] * h2;
        const float w = alpha * (h2 / C);
        const int xe = elim ? elim_col(x, nx) : x;
        float o;
        if (src == SRC_ZERO) {
            // u == 0: res = -f on the interior (pallas2d.py:1100-1102)
            const float r1 =
                is_interior<COLS>(y, xe, ny, nx, gy, ny_g, col_off + xe, nx_g) ? -f[y * nx + xe]
                                                                              : 0.0f;
            o = w * r1;
        } else {
            const float r = is_interior<COLS>(y, x, ny, nx, gy, ny_g, col_off + x, nx_g)
                                ? residual_at(u, f, corrx, src, elim, C, inv_h2, nx, y, x)
                                : 0.0f;
            if (y >= own0 && y < own1 && (!COLS || (x >= ownc0 && x < ownc1))) rsq = r * r;
            if (xe == x) {
                o = value_at(u, corrx, src, elim, nx, y, x) + w * r;
            } else {
                const float re = is_interior<COLS>(y, xe, ny, nx, gy, ny_g, col_off + xe, nx_g)
                                     ? residual_at(u, f, corrx, src, elim, C, inv_h2, nx, y, xe)
                                     : 0.0f;
                o = value_at(u, corrx, src, elim, nx, y, xe) + w * re;
            }
        }
        out[y * nx + x] = o;
    }
    if (partials) {
        rsq = fpr::block_sum(rsq, sh);
        if (fpr::block_leader()) partials[fpr::block_id()] = rsq;
    }
}

template <bool COLS>
__global__ void __launch_bounds__(FPR_THREADS)
residual_kernel(const float* __restrict__ u, const float* __restrict__ f,
                const float* __restrict__ c, float h2, float inv_h2, int ny, int nx,
                int row_off, int ny_g, int col_off, int nx_g, float* __restrict__ res) {
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    if (x >= nx || y >= ny) return;
    const float C = 4.0f + c[0] * h2;
    res[y * nx + x] = is_interior<COLS>(y, x, ny, nx, row_off + y, ny_g, col_off + x, nx_g)
                          ? residual_at(u, f, nullptr, SRC_ARRAY, false, C, inv_h2, nx, y, x)
                          : 0.0f;
}

}  // namespace

extern "C" {

// One damped-Jacobi sweep out = sweep(src(u)).  src: 0 u as is, 1 a zero
// iterate (u unused), 2 u - P(corrx) with corrx the (ny/2+1, nx)
// x-interleaved coarse correction.  partials: null, or (fpr_num_blocks,)
// f32 for the per-block sums of res^2 of the sweep's input over the owned
// cells.  row_off, ny_g, own0, own1: the row hooks; col_off, nx_g, ownc0,
// ownc1: the column hooks.
int fpr_sweep(const float* u, const float* f, const float* corrx, const float* c,
              float h2, float inv_h2, float alpha, int ny, int nx, int src, int elim,
              int row_off, int ny_g, int own0, int own1, int col_off, int nx_g, int ownc0,
              int ownc1, float* out, float* partials, cudaStream_t stream) {
    const bool cols = !(col_off == 0 && nx_g == nx && ownc0 == 0 && ownc1 == nx);
    auto kernel = cols ? sweep_kernel<true> : sweep_kernel<false>;
    kernel<<<fpr::grid_of(ny, nx), dim3(FPR_BX, FPR_BY), 0, stream>>>(
        u, f, corrx, c, h2, inv_h2, alpha, ny, nx, src, elim, row_off, ny_g, own0, own1,
        col_off, nx_g, ownc0, ownc1, out, partials);
    return static_cast<int>(cudaGetLastError());
}

int fpr_residual(const float* u, const float* f, const float* c, float h2,
                 float inv_h2, int ny, int nx, int row_off, int ny_g, int col_off, int nx_g,
                 float* res, cudaStream_t stream) {
    auto kernel = (col_off == 0 && nx_g == nx) ? residual_kernel<false> : residual_kernel<true>;
    kernel<<<fpr::grid_of(ny, nx), dim3(FPR_BX, FPR_BY), 0, stream>>>(
        u, f, c, h2, inv_h2, ny, nx, row_off, ny_g, col_off, nx_g, res);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
