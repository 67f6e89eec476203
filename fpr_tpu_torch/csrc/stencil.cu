// #5: the 5-point stencil pass of the multigrid smoother, residual and CG
// matvec, in float32 and float64.
//
// Replaces fpr_tpu/ops/pallas2d.py::_stencil_kernel (built at
// pallas2d.py:277; wrappers smooth_rp, smooth2_rp, residual_rp,
// matvec_rp, matvec_dot_rp and the physical jacobi_step, residual,
// matvec).  Per cell of the physical (ny, nx) array:
//
//   smooth:     res = (u_N + u_S + u_W + u_E - C u) * (1/h^2) - f
//               out = u + (alpha (h^2 / C)) res,  acc += res^2
//   residual:   out = res,                        acc += res^2
//   matvec:     out = (u_N + u_S + u_W + u_E - 4 u) * (1/h^2) - c u,
//               acc += u * out
//   matvec_dot: acc += u * out, no field written
//
// on the interior; res and the matvec are 0 on the boundary ring (so
// smooth passes u through there).  C = 4 + c h^2 with c read from device
// memory (a Helmholtz shift computed on the device needs no host read).
// The operation order is the TPU kernel's (pallas2d.py:174-251), not
// stencil2d's; with -fmad=false every product and sum is rounded on its
// own, so the kernel is bitwise equal to its plain PyTorch version
// (ops/stencil_pass.py).  smooth2 (two chained sweeps, the norm of the
// second) is two launches of smooth.
//
// Bound on the H100: memory bandwidth.  A pass reads u (and f) and writes
// one field: 12 B/cell (smooth, residual), 8 (matvec) or 4 (matvec_dot)
// in float32, twice that in float64, for about 10 operations per cell.
//
// Design: one thread per cell, neighbours read from global memory (the
// y neighbours of a 32x8 block mostly hit L1/L2), the sum to per-block
// partials in a fixed order.  Left for later: shared-memory tiles, and
// smooth2 in one pass with a halo of two rows.
#include "fpr_common.cuh"

namespace {

enum : int { MODE_SMOOTH = 0, MODE_RESIDUAL = 1, MODE_MATVEC = 2, MODE_MATVEC_DOT = 3 };

template <typename T>
__device__ __forceinline__ T warp_sum_t(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// fpr::block_sum for float and double: warp tree, then warp 0 over the
// FPR_BY warp results; valid in thread (0, 0).
template <typename T>
__device__ __forceinline__ T block_sum_t(T v, T* sh) {
    v = warp_sum_t(v);
    __syncthreads();
    if (threadIdx.x == 0) sh[threadIdx.y] = v;
    __syncthreads();
    if (threadIdx.y == 0) {
        v = threadIdx.x < FPR_BY ? sh[threadIdx.x] : T(0);
        v = warp_sum_t(v);
    }
    return v;
}

template <typename T>
__global__ void __launch_bounds__(FPR_THREADS)
stencil_kernel(const T* __restrict__ u, const T* __restrict__ f, const T* __restrict__ c,
               T h2, T inv_h2, T alpha, int ny, int nx, int mode, T* __restrict__ out,
               T* __restrict__ partials) {
    __shared__ T sh[FPR_BY];
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    T acc = T(0);
    if (x < nx && y < ny) {
        const int i = y * nx + x;
        const T center = u[i];
        const bool interior = x > 0 && y > 0 && x < nx - 1 && y < ny - 1;
        const T cv = c[0];
        T o;
        if (mode == MODE_MATVEC || mode == MODE_MATVEC_DOT) {
            o = T(0);
            if (interior)
                o = (u[i - nx] + u[i + nx] + u[i - 1] + u[i + 1] - T(4) * center) * inv_h2
                    - cv * center;
            acc = center * o;
        } else {
            // the constants in the order of pallas2d.py:176-178
            const T C = T(4) + cv * h2;
            T res = T(0);
            if (interior)
                res = (u[i - nx] + u[i + nx] + u[i - 1] + u[i + 1] - C * center) * inv_h2 - f[i];
            acc = res * res;
            o = mode == MODE_SMOOTH ? center + (alpha * (h2 / C)) * res : res;
        }
        if (mode != MODE_MATVEC_DOT) out[i] = o;
    }
    if (partials) {
        acc = block_sum_t(acc, sh);
        if (fpr::block_leader()) partials[fpr::block_id()] = acc;
    }
}

template <typename T>
int launch(const T* u, const T* f, const T* c, T h2, T inv_h2, T alpha, int ny, int nx,
           int mode, T* out, T* partials, cudaStream_t stream) {
    stencil_kernel<T><<<fpr::grid_of(ny, nx), dim3(FPR_BX, FPR_BY), 0, stream>>>(
        u, f, c, h2, inv_h2, alpha, ny, nx, mode, out, partials);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One pass over the (ny, nx) field u.  mode: 0 smooth, 1 residual, 2 matvec,
// 3 matvec_dot.  f: the rhs (modes 0, 1; null otherwise).  c: the shift, one
// element on the device.  h2, inv_h2, alpha: h*h, 1/(h*h) and the damping,
// rounded to the type on the host.  out: (ny, nx), null for matvec_dot.
// partials: null, or (kernels.num_blocks_3d(1, ny, nx),) of the type for the
// per-block sums.
int fpr_stencil_f32(const float* u, const float* f, const float* c, float h2, float inv_h2,
                    float alpha, int ny, int nx, int mode, float* out, float* partials,
                    cudaStream_t stream) {
    return launch<float>(u, f, c, h2, inv_h2, alpha, ny, nx, mode, out, partials, stream);
}

int fpr_stencil_f64(const double* u, const double* f, const double* c, double h2,
                    double inv_h2, double alpha, int ny, int nx, int mode, double* out,
                    double* partials, cudaStream_t stream) {
    return launch<double>(u, f, c, h2, inv_h2, alpha, ny, nx, mode, out, partials, stream);
}

}  // extern "C"
