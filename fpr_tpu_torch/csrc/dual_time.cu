// Part 1's pseudo-time iteration in float32: the counterpart of TPU
// kernel #8.
//
// Replaces fpr_tpu/ops/pallas3d.py::_dual_time_kernel (#8, built at
// pallas3d.py:834, wrapped by dual_time_step_padded, with its update box).
// The K-sweep kernels #9 and #10 have their own counterpart,
// csrc/dual_timek.cu, with the same per-cell arithmetic.  One launch
// computes, on the
// planes [w0, w0 + nw) of an (nz, ny, nx) field with x fastest,
//
//     lap = ((xp - 2c) + xm) / dx^2 + ((yp - 2c) + ym) / dy^2 + ((zp - 2c) + zm) / dz^2
//     dH  = (c - ht) * (1/dt) - D * lap               (cells inside the update box)
//     out = c - dtau * dH                             (inside the box; other cells copied)
//
// in the Pallas kernel's operation order (pallas3d.py:223-249), with the
// constants rounded to float32 from float64 on the host, and, when
// partials is not null, per-block partial sums of dH^2 over the box that
// the caller adds in a fixed order (no float atomics: reruns give the same
// bits).  The tested form (a LoopTest given) instead launches as many
// blocks as the card holds at once, which take the tiles in turn, and
// finishes the sum in the launch (fpr::finish_launch: per-block sums folded
// in a fixed order), then the pseudo-time loop's test after it
// (fpr::finish_test): err, the iteration count and the loop's predicate, so
// that a loop pass is this one launch.  One block a tile would pay the
// ticket's fence and atomic in each of 8192 blocks at 128^3 (21.1 against
// 11.7 device us on an H100, PERF.md), and leave 8192 partials to fold.  The box is inclusive, in the field's own coordinates, and lies
// inside [1, n-2] on every axis, so that every stencil read is in range:
// a single device's box is the interior, a shard's box comes from its
// global-edge masks (pallas3d.py:235-246).  Planes outside the window are
// not written.
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
// TPU kernel aliases its output onto the input (pallas3d.py:706-708).
#include <algorithm>
#include <atomic>

#include "fpr_common.cuh"

namespace {

struct Box {
    int z0, z1, y0, y1, x0, x1;
};

// One thread's cell of the launch grid's tile (bx, by, bz) of the window:
// out written, dH^2 returned (0 outside the box and the field).
__device__ __forceinline__ float update_cell(const float* __restrict__ ht,
                                             const float* __restrict__ htau,
                                             float* __restrict__ out, float inv_dx2,
                                             float inv_dy2, float inv_dz2, float inv_dt, float D,
                                             float dtau, int ny, int nx, int w0, const Box& box,
                                             unsigned bx, unsigned by, unsigned bz) {
    const int x = bx * FPR_BX + threadIdx.x;
    const int y = by * FPR_BY + threadIdx.y;
    const int z = w0 + bz;
    float dsq = 0.0f;

    if (x < nx && y < ny) {
        const size_t sy = static_cast<size_t>(nx);
        const size_t sz = sy * ny;
        const size_t i = z * sz + y * sy + x;
        const float c = htau[i];
        float v = c;
        if (x >= box.x0 && x <= box.x1 && y >= box.y0 && y <= box.y1 && z >= box.z0 &&
            z <= box.z1) {
            const float lap = ((htau[i + 1] - 2.0f * c) + htau[i - 1]) * inv_dx2
                            + ((htau[i + sy] - 2.0f * c) + htau[i - sy]) * inv_dy2
                            + ((htau[i + sz] - 2.0f * c) + htau[i - sz]) * inv_dz2;
            const float dh = (c - ht[i]) * inv_dt - D * lap;
            v = c - dtau * dh;
            dsq = dh * dh;
        }
        out[i] = v;
    }
    return dsq;
}

// The untested form: one block a tile of the (nx/32, ny/8, nw) grid, its
// partial sum into partials (if not null).  The tested form: blocks that
// take the tiles in turn (fpr::Tiles), each thread adding its cells' dH^2
// in that order, the sum and the loop test finished in the launch.
template <bool TESTED>
__global__ void __launch_bounds__(FPR_THREADS)
dual_time_kernel(const float* __restrict__ ht, const float* __restrict__ htau,
                 float* __restrict__ out, float* __restrict__ partials, float inv_dx2,
                 float inv_dy2, float inv_dz2, float inv_dt, float D, float dtau, int ny,
                 int nx, int w0, Box box, fpr::Tiles tiles, fpr::LoopTest test) {
    __shared__ float sh[FPR_BY];
    if constexpr (TESTED) {
        const int it_prev = fpr::block_leader() ? *test.it : 0;
        float v[1] = {0.0f};
        fpr::for_tiles(tiles, [&](unsigned bx, unsigned by, unsigned bz) {
            v[0] += update_cell(ht, htau, out, inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau, ny,
                                nx, w0, box, bx, by, bz);
        });
        if (fpr::finish_launch<FPR_THREADS, 1>(v, 0u, partials, test.ticket, sh,
                                               threadIdx.y * FPR_BX + threadIdx.x)) {
            fpr::finish_test(test, v[0], it_prev);
        }
    } else {
        float dsq = update_cell(ht, htau, out, inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau, ny,
                                nx, w0, box, blockIdx.x, blockIdx.y, blockIdx.z);
        if (partials != nullptr) {  // the same for every block of the launch
            dsq = fpr::block_sum(dsq, sh);
            if (fpr::block_leader()) partials[fpr::block_id()] = dsq;
        }
    }
}

}  // namespace

extern "C" {

// One iteration over the planes [w0, w0 + nw) of an (nz, ny, nx) field,
// updating the cells of the inclusive box (z0..z1, y0..y1, x0..x1) and
// copying the others.  partials: null (no norm) or n_partials f32, one per
// block of the (nx/32, ny/8, nw) grid.  A window outside the field, nw
// beyond the grid's z limit, a non-empty box outside [1, n-2], or a
// partials length that does not fit the grid is refused with
// cudaErrorInvalidValue.  test: null, or the loop test to finish in the
// launch (the tested form; needs partials, and its ticket word must not be
// in use by another launch at once).  Returns the launch's cudaError_t.
int fpr_dual_time(const float* ht, const float* htau, float* out, float* partials,
                  int n_partials, float inv_dx2, float inv_dy2, float inv_dz2,
                  float inv_dt, float D, float dtau, int nz, int ny, int nx, int w0,
                  int nw, int z0, int z1, int y0, int y1, int x0, int x1,
                  const fpr::LoopTest* test, cudaStream_t stream) {
    const dim3 grid = fpr::grid_of_3d(nw, ny, nx);
    const bool empty = z0 > z1 || y0 > y1 || x0 > x1;
    const bool box_ok = empty || (z0 >= 1 && z1 <= nz - 2 && y0 >= 1 && y1 <= ny - 2 &&
                                  x0 >= 1 && x1 <= nx - 2);
    if (nw < 1 || nw > 65535 || w0 < 0 || w0 + nw > nz || !box_ok ||
        (partials != nullptr && static_cast<long long>(n_partials) !=
                                    static_cast<long long>(grid.x) * grid.y * grid.z) ||
        (test != nullptr && partials == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Box box{z0, z1, y0, y1, x0, x1};
    const fpr::Tiles tl{grid.x, grid.y, grid.x * grid.y * grid.z};
    if (test != nullptr) {
        static std::atomic<int> slots_cached{0};
        int slots = 0;
        const cudaError_t err = fpr::card_slots(dual_time_kernel<true>, slots_cached, slots);
        if (err != cudaSuccess) return static_cast<int>(err);
        dual_time_kernel<true><<<std::min(tl.n, static_cast<unsigned>(slots)),
                                 dim3(FPR_BX, FPR_BY), 0, stream>>>(
            ht, htau, out, partials, inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau, ny, nx, w0,
            box, tl, *test);
    } else {
        dual_time_kernel<false><<<grid, dim3(FPR_BX, FPR_BY), 0, stream>>>(
            ht, htau, out, partials, inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau, ny, nx, w0,
            box, tl, fpr::LoopTest{});
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
