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

#include <atomic>

// One thread per cell; a block covers FPR_BY rows of FPR_BX columns, so a
// warp reads one contiguous 128-byte row segment.
#define FPR_BX 32
#define FPR_BY 8
#define FPR_THREADS (FPR_BX * FPR_BY)

namespace fpr {

// The tile of the single-pass 2D kernels K1 (defect.cu) and K4
// (ns_fused.cu): a block of TILE_WARPS warps owns TILE_X columns x
// TILE_WARPS * S rows, S <= TILE_S_MAX rows a thread chosen per launch;
// lane l of warp w holds column l of the tile and its rows w S .. w S + S - 1.
// The block's region adds a one-cell halo around the tile, kept in shared
// memory as a plane of TILE_PW-wide rows.
constexpr int TILE_X = 32, TILE_WARPS = 8, TILE_NT = 32 * TILE_WARPS, TILE_S_MAX = 4;
constexpr int TILE_PW = TILE_X + 2;
constexpr int TILE_PLANE = (TILE_WARPS * TILE_S_MAX + 2) * TILE_PW;

// The halo cell that a thread of a tile of TY rows fills, in region
// coordinates (row -1 .. TY, column -1 .. TILE_X): warp 0 the row above the
// tile, the last warp the row below, warps 1 and 2 the left and the right
// column (lanes < TY <= 32).  False for the other threads.
__device__ __forceinline__ bool tile_halo(int w, int lane, int TY, int& ry, int& rx) {
    if (w == 0 || w == TILE_WARPS - 1) {
        ry = w == 0 ? -1 : TY;
        rx = lane;
        return true;
    }
    if ((w == 1 || w == 2) && lane < TY) {
        ry = lane;
        rx = w == 1 ? -1 : TILE_X;
        return true;
    }
    return false;
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

// C = 4 + c h^2 as a ds pair from a float32 c and h2 = h^2, in the order of
// the EFTs of fpr_tpu/ops/ds.py::_defect_scalars' float32 branch
// (fpr_tpu_torch/ops/ds.py::defect_scalars).
__device__ __forceinline__ void c_pair(float c, float h2, float& hi, float& lo) {
    float p, pe, s, se;
    two_prod(c, h2, p, pe);
    two_sum(4.0f, p, s, se);
    quick_two_sum(s, se + pe, hi, lo);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
    for (int o = 16; o > 0; o >>= 1) v = max_of(v, __shfl_down_sync(0xffffffffu, v, o));
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

// block_sum_n over NQ values of type T (float or double) at once, value q
// summed, or its maximum taken where bit q of max_mask is set (non-negative
// values), in the same fixed order, with one pair of barriers for all of
// them; sh holds NQ * NT / 32 values.  Valid in thread 0.
template <int NT, int NQ, typename T>
__device__ __forceinline__ void block_reduce_n(T (&v)[NQ], unsigned max_mask, T* sh, int tid) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = (max_mask >> q) & 1u ? warp_max(v[q]) : warp_sum(v[q]);
    __syncthreads();
    if ((tid & 31) == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) sh[q * (NT / 32) + (tid >> 5)] = v[q];
    }
    __syncthreads();
    if (tid < 32) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            const T x = tid < NT / 32 ? sh[q * (NT / 32) + tid] : T(0);
            v[q] = (max_mask >> q) & 1u ? warp_max(x) : warp_sum(x);
        }
    }
}

// The sums of a launch finished in the launch, in float (K1, K4, the
// tested #8 and #11) or double (#5 in float64): every block reduces its NQ
// values (block_reduce_n); thread 0 writes them to partials[q * nb + b],
// makes them visible device-wide and takes a ticket from *counter; the
// block that takes the last ticket adds the partials (thread t folds
// blocks t, t + NT, ... in order, then block_reduce_n), so a rerun gives
// the same bits, and re-arms *counter to 0 for the next launch.  Returns
// true in thread 0 of the last block only, with the launch's totals in v.
// Every thread of every block must call it; the counter must not be used
// by two launches at once.  On an H100 this form was the fastest of those
// tried (PERF.md §6): a ticket with acquire semantics empties the SM's L1
// under the other blocks' feet, and a fold by one warp lengthens the
// launch's tail.
template <int NT, int NQ, typename T>
__device__ __forceinline__ bool finish_launch(T (&v)[NQ], unsigned max_mask, T* partials,
                                              unsigned* counter, T* sh, int tid) {
    __shared__ bool is_last;
    const unsigned nb = gridDim.x * gridDim.y * gridDim.z;
    const unsigned b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    block_reduce_n<NT, NQ>(v, max_mask, sh, tid);
    if (tid == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) partials[q * nb + b] = v[q];
        __threadfence();
        is_last = atomicAdd(counter, 1u) == nb - 1;
    }
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
    T acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        const bool mx = (max_mask >> q) & 1u;
        T a = T(0);
        for (unsigned j = tid; j < nb; j += NT) {
            const T x = __ldcg(partials + q * nb + j);
            a = mx ? max_of(a, x) : a + x;
        }
        acc[q] = a;
    }
    block_reduce_n<NT, NQ>(acc, max_mask, sh, tid);
    if (tid != 0) return false;
    *counter = 0u;
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = acc[q];
    return true;
}

// The (gx, gy, nz) tile grid of a 3D launch (grid_of_3d), n = gx gy nz tiles,
// for blocks that take the tiles in turn: tile t is (t % gx, t / gx % gy,
// t / (gx gy)).
struct Tiles {
    unsigned gx, gy, n;
};

// f(bx, by, bz) for the tiles blockIdx.x, blockIdx.x + gridDim.x, ... < n of
// a 1D grid, in that order, the coordinates stepped with carries instead of
// three divisions a tile.
template <typename F>
__device__ __forceinline__ void for_tiles(const Tiles& tl, F&& f) {
    const unsigned plane = tl.gx * tl.gy, step = gridDim.x;
    const unsigned sx = step % tl.gx, sy = step / tl.gx % tl.gy, sz = step / plane;
    unsigned bx = blockIdx.x % tl.gx, by = blockIdx.x / tl.gx % tl.gy, bz = blockIdx.x / plane;
    for (unsigned t = blockIdx.x; t < tl.n; t += step) {
        f(bx, by, bz);
        bx += sx;
        if (bx >= tl.gx) {
            bx -= tl.gx;
            ++by;
        }
        by += sy;
        if (by >= tl.gy) {
            by -= tl.gy;
            ++bz;
        }
        bz += sz;
    }
}

// The blocks of FPR_THREADS threads of kernel that the current card holds at
// once (SMs x resident blocks), read from the runtime at the first call and
// kept in cached: the grid of a launch whose blocks take the tiles in turn.
template <typename Kernel>
cudaError_t card_slots(Kernel kernel, std::atomic<int>& cached, int& slots) {
    slots = cached.load();
    if (slots > 0) return cudaSuccess;
    int dev = 0, n = 0, r = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, FPR_THREADS, 0);
    }
    if (err != cudaSuccess) return err;
    if (n < 1 || r < 1) return cudaErrorInvalidConfiguration;
    slots = n * r;
    cached.store(slots);
    return cudaSuccess;
}

// Part 1's pseudo-time loop test, finished in the launch of the iteration
// that makes its sum (#8, #11): the caller's carry scalars and constants.
// Laid out as fpr_tpu_torch/kernels' LoopTestArgs.
struct LoopTest {
    unsigned* ticket;              // finish_launch's ticket word, 0 between launches
    float* sumsq;                  // the launch's sum of dH^2
    float* err;                    // sqrt(sumsq) * dt / sqrt_n
    int* it;                       // the iteration count, one more a launch
    int* go;                       // the loop's predicate: err > tol && it < iter_max
    float dt, sqrt_n, tol;
    int iter_max;
};

// The loop test from the launch's sum, in thread 0 of the block that
// finish_launch returned true in, with it_prev the count read at the
// block's start (before its ticket, so before this launch writes it): each
// operation rounded on its own, in the order of the plain test's torch
// operations (ops/dual_time.py loop_test_plain: sqrt, times dt, over sqrt_n;
// then it + 1 and the predicate), so err, it and go are what it makes of the
// same sum.
__device__ __forceinline__ void finish_test(const LoopTest& t, float sumsq, int it_prev) {
    const float err = sqrtf(sumsq) * t.dt / t.sqrt_n;
    const int it = it_prev + 1;
    *t.sumsq = sumsq;
    *t.err = err;
    *t.it = it;
    *t.go = err > t.tol && it < t.iter_max ? 1 : 0;
}

// Row-major block index over a 2D or 3D grid (blockIdx.z is 0 on a 2D one).
__device__ __forceinline__ int block_id() {
    return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
__device__ __forceinline__ bool block_leader() { return threadIdx.x == 0 && threadIdx.y == 0; }

}  // namespace fpr
