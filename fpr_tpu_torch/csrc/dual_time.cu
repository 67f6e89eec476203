// Part 1's pseudo-time iteration in float32: the counterpart of TPU
// kernels #8 and #10.
//
// Replaces fpr_tpu/ops/pallas3d.py::_dual_time_kernel (built at
// pallas3d.py:834, wrapped by dual_time_step_padded) and, launched K times
// over a ping-pong pair, ::_dual_timek_stacked_kernel (pallas3d.py:691,
// dual_time_stepk_stacked).  One launch computes, on an (nz, ny, nx) field
// with x fastest,
//
//     lap = ((xp - 2c) + xm) / dx^2 + ((yp - 2c) + ym) / dy^2 + ((zp - 2c) + zm) / dz^2
//     dH  = (c - ht) * (1/dt) - D * lap               (interior cells)
//     out = c - dtau * dH                             (interior; the faces are copied)
//
// in the Pallas kernel's operation order (pallas3d.py:223-249), with the
// constants rounded to float32 from float64 on the host, and, when
// partials is not null, per-block partial sums of dH^2 that the caller adds
// in a fixed order (no float atomics: reruns give the same bits).
//
// Bound on the H100: memory bandwidth.  A cell reads Htau and Ht and writes
// Htau', 12 bytes, against 27 flops: one 512^3 iteration moves 1.61 GB, at
// least 0.48 ms at 3.35 TB/s, and needs 0.05 ms of float32 issue.
//
// Design: one thread per cell, the six neighbours read from global memory
// (the x neighbours lie in the warp's own cache lines; the y and z ones were
// read by the neighbouring rows and planes and mostly hit L1/L2).  out must
// not be htau: blocks run in no order, so an in-place stencil would read
// neighbours already updated.  The caller ping-pongs two buffers where the
// TPU kernels alias their output onto the input (pallas3d.py:706-708).
// The TPU's K-fused kernel (#10) keeps K sweeps on chip per pass over HBM,
// which is its reason to exist; here each of the K launches makes a full
// pass, 3x the bytes of the fused work for K = 3.  Keeping the sweeps on
// chip (shared-memory z-marching with TMA loads) is later work.
#include "fpr_common.cuh"

namespace {

__global__ void __launch_bounds__(FPR_THREADS)
dual_time_kernel(const float* __restrict__ ht, const float* __restrict__ htau,
                 float* __restrict__ out, float* __restrict__ partials, float inv_dx2,
                 float inv_dy2, float inv_dz2, float inv_dt, float D, float dtau, int nz,
                 int ny, int nx) {
    __shared__ float sh[FPR_BY];
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    const int z = blockIdx.z;
    float dsq = 0.0f;

    if (x < nx && y < ny) {
        const size_t sy = static_cast<size_t>(nx);
        const size_t sz = sy * ny;
        const size_t i = z * sz + y * sy + x;
        const float c = htau[i];
        float v = c;
        if (x > 0 && y > 0 && z > 0 && x < nx - 1 && y < ny - 1 && z < nz - 1) {
            const float lap = ((htau[i + 1] - 2.0f * c) + htau[i - 1]) * inv_dx2
                            + ((htau[i + sy] - 2.0f * c) + htau[i - sy]) * inv_dy2
                            + ((htau[i + sz] - 2.0f * c) + htau[i - sz]) * inv_dz2;
            const float dh = (c - ht[i]) * inv_dt - D * lap;
            v = c - dtau * dh;
            dsq = dh * dh;
        }
        out[i] = v;
    }

    if (partials != nullptr) {  // the same for every block of the launch
        dsq = fpr::block_sum(dsq, sh);
        if (fpr::block_leader()) partials[fpr::block_id()] = dsq;
    }
}

}  // namespace

extern "C" {

// One iteration.  partials: null (no norm) or n_partials f32, one per block
// of the (nx/32, ny/8, nz) grid; a length that does not fit the grid, or
// nz beyond the grid's z limit, is refused with cudaErrorInvalidValue.
// Returns the launch's cudaError_t.
int fpr_dual_time(const float* ht, const float* htau, float* out, float* partials,
                  int n_partials, float inv_dx2, float inv_dy2, float inv_dz2,
                  float inv_dt, float D, float dtau, int nz, int ny, int nx,
                  cudaStream_t stream) {
    const dim3 grid = fpr::grid_of_3d(nz, ny, nx);
    if (nz > 65535 || (partials != nullptr &&
                       static_cast<long long>(n_partials) !=
                           static_cast<long long>(grid.x) * grid.y * grid.z)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    dual_time_kernel<<<grid, dim3(FPR_BX, FPR_BY), 0, stream>>>(
        ht, htau, out, partials, inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau, nz, ny, nx);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
