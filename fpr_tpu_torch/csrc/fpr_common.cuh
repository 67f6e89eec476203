// Shared pieces of the fpr_tpu_torch kernels: the block shape, the
// double-single error-free transforms, and deterministic block reductions.
//
// Build contract: every .cu file of this library is compiled with
// -fmad=false.  The error-free transforms below (two_sum, Veltkamp split,
// Dekker product) are exact only when each single-precision operation is
// rounded on its own; nvcc's default contraction of a*b+c into one FMA
// breaks the split (fpr_tpu/ops/ds.py:14-17, 93-99).  The f32 Jacobi legs
// need the same control to be bitwise equal to their plain PyTorch
// versions, which PyTorch runs one rounded operation at a time.
#pragma once

#include <cuda_runtime.h>

// One thread per cell; a block covers FPR_BY rows of FPR_BX columns, so a
// warp reads one contiguous 128-byte row segment.
#define FPR_BX 32
#define FPR_BY 8
#define FPR_THREADS (FPR_BX * FPR_BY)

namespace fpr {

inline dim3 grid_of(int ny, int nx) {
    return dim3((nx + FPR_BX - 1) / FPR_BX, (ny + FPR_BY - 1) / FPR_BY);
}

// One block layer per z plane of an (nz, ny, nx) field.
inline dim3 grid_of_3d(int nz, int ny, int nx) {
    return dim3((nx + FPR_BX - 1) / FPR_BX, (ny + FPR_BY - 1) / FPR_BY, nz);
}

// s + e == a + b exactly (fpr_tpu/ops/ds.py::two_sum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
    s = a + b;
    const float bb = s - a;
    e = (a - (s - bb)) + (b - bb);
}

// s + e == a + b exactly, requires |a| >= |b| (ds.py::quick_two_sum).
__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
    s = a + b;
    e = b - (s - a);
}

// (xh, xl) + (yh, yl), renormalised (ds.py::ds_add).
__device__ __forceinline__ void ds_add(float xh, float xl, float yh, float yl,
                                       float& zh, float& zl) {
    float s, e;
    two_sum(xh, yh, s, e);
    e = e + (xl + yl);
    quick_two_sum(s, e, zh, zl);
}

// Veltkamp split with 2^12 + 1 (ds.py::split).
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
    const float t = a * 4097.0f;
    hi = t - (t - a);
    lo = a - hi;
}

// p + e == a * b exactly, without FMA (ds.py::two_prod).
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
    p = a * b;
    float ah, al, bh, bl;
    split(a, ah, al);
    split(b, bh, bl);
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// (xh, xl) * (yh, yl), dropping xl*yl (ds.py::ds_mul_ds).
__device__ __forceinline__ void ds_mul_ds(float xh, float xl, float yh, float yl,
                                          float& zh, float& zl) {
    float p, e;
    two_prod(xh, yh, p, e);
    e = e + (xh * yl + xl * yh);
    quick_two_sum(p, e, zh, zl);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// Block reductions in a fixed order (warp tree, then warp 0 over the
// FPR_BY warp results), so a rerun gives the same bits.  Every thread of
// the block must call them; the result is valid in thread (0, 0).
__device__ __forceinline__ float block_sum(float v, float* sh) {
    v = warp_sum(v);
    __syncthreads();
    if (threadIdx.x == 0) sh[threadIdx.y] = v;
    __syncthreads();
    if (threadIdx.y == 0) {
        v = threadIdx.x < FPR_BY ? sh[threadIdx.x] : 0.0f;
        v = warp_sum(v);
    }
    return v;
}

// block_sum for a block of NT threads numbered tid (a multiple of 32, at
// most 1024), in the same fixed order; valid in thread 0.
template <int NT>
__device__ __forceinline__ float block_sum_n(float v, float* sh, int tid) {
    v = warp_sum(v);
    __syncthreads();
    if ((tid & 31) == 0) sh[tid >> 5] = v;
    __syncthreads();
    if (tid < 32) v = warp_sum(tid < NT / 32 ? sh[tid] : 0.0f);
    return v;
}

// Maximum of non-negative values.
__device__ __forceinline__ float block_max(float v, float* sh) {
    v = warp_max(v);
    __syncthreads();
    if (threadIdx.x == 0) sh[threadIdx.y] = v;
    __syncthreads();
    if (threadIdx.y == 0) {
        v = threadIdx.x < FPR_BY ? sh[threadIdx.x] : 0.0f;
        v = warp_max(v);
    }
    return v;
}

// Row-major block index over a 2D or 3D grid (blockIdx.z is 0 on a 2D one).
__device__ __forceinline__ int block_id() {
    return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
__device__ __forceinline__ int num_blocks() { return gridDim.x * gridDim.y * gridDim.z; }
__device__ __forceinline__ bool block_leader() { return threadIdx.x == 0 && threadIdx.y == 0; }

}  // namespace fpr
