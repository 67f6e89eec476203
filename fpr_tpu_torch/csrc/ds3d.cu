// Part 1's pseudo-time iteration in double-single arithmetic: the
// counterpart of TPU kernel #11.
//
// Replaces fpr_tpu/ops/ds3d.py::_ds3d_kernel (built at ds3d.py:212,
// wrapped by dual_time_step_ds_padded).  State is a hi/lo float32 pair,
// about 48 mantissa bits, stored as two (nz, ny, nx) planes (hi, then lo).
// One launch computes, in the JAX kernel's order (ds3d.py:120-182):
//
//     dd*  = (p + m) - 2c per axis: two_sum(p, m), two_sum(s, -2c), lo sum
//     lap  = ddx bx + ddy by + ddz bz                 (ds_mul_ds, ds_add)
//     dH   = (c - ht) inv_dt - lap                    (interior cells)
//     out  = c - dtau dH                              (interior; the faces are copied)
//
// with b* = D/d*^2, inv_dt = 1/dt and dtau as ds pairs split from float64
// on the host (ds3d.py:201-207), and, when partials is not null, per-block
// partial sums of dH_hi^2 in float32 (ds3d.py:182), added by the caller in
// a fixed order; or, in the tested form (a LoopTest given), that float32
// sum finished in the launch and the pseudo-time loop's test after it, on
// as many blocks as the card holds at once, its htau and out a ping-pong
// pair that the count picks from, as csrc/dual_time.cu's tested form does.
// The error-free transforms of fpr_common.cuh need the build's
// -fmad=false.
//
// Bound on the H100: memory bandwidth.  A cell reads Htau and Ht hi/lo and
// writes Htau' hi/lo, 24 bytes, against about 190 float32 operations: one
// 128^3 iteration moves 50 MB, at least 15 us at 3.35 TB/s, and needs 6 us
// of float32 issue at 67 TFLOP/s, so the arithmetic is not far behind.
//
// Design: as csrc/dual_time.cu, one thread per cell with its neighbours
// from global memory, and out a buffer other than htau (the caller
// ping-pongs two pairs; the TPU kernel DMA'd into a separate output too).
#include <algorithm>
#include <atomic>

#include "fpr_common.cuh"

namespace {

// (p + m) - 2c in ds, exact up to the final lo sum (ds3d.py::second_diff).
__device__ __forceinline__ void second_diff(float ph, float pl, float mh, float ml,
                                            float ch, float cl, float& t, float& lo) {
    float s, e1, e2;
    fpr::two_sum(ph, mh, s, e1);
    fpr::two_sum(s, -2.0f * ch, t, e2);
    lo = (e1 + e2) + ((pl + ml) - 2.0f * cl);
}

struct DsConsts {
    float inv_dt_h, inv_dt_l, bx_h, bx_l, by_h, by_l, bz_h, bz_l, dtau_h, dtau_l;
};

// One thread's cell of the launch grid's tile (bx, by, bz): out written,
// dH_hi^2 returned (0 on the faces and outside the field).
__device__ __forceinline__ float update_cell(const float* __restrict__ ht,
                                             const float* __restrict__ htau,
                                             float* __restrict__ out, const DsConsts& k, int nz,
                                             int ny, int nx, unsigned bx, unsigned by,
                                             unsigned bz) {
    const int x = bx * FPR_BX + threadIdx.x;
    const int y = by * FPR_BY + threadIdx.y;
    const int z = bz;
    float dsq = 0.0f;

    if (x < nx && y < ny) {
        const size_t sy = static_cast<size_t>(nx);
        const size_t sz = sy * ny;
        const size_t n = sz * nz;  // the lo plane follows the hi plane
        const size_t i = z * sz + y * sy + x;
        const float* hh = htau;
        const float* hl = htau + n;
        const float ch = hh[i], cl = hl[i];
        float nh = ch, nl = cl;
        if (x > 0 && y > 0 && z > 0 && x < nx - 1 && y < ny - 1 && z < nz - 1) {
            float zh, zl, yh, yl, xh, xl;
            second_diff(hh[i + sz], hl[i + sz], hh[i - sz], hl[i - sz], ch, cl, zh, zl);
            second_diff(hh[i + sy], hl[i + sy], hh[i - sy], hl[i - sy], ch, cl, yh, yl);
            second_diff(hh[i + 1], hl[i + 1], hh[i - 1], hl[i - 1], ch, cl, xh, xl);

            float lh, ll, th, tl;
            fpr::ds_mul_ds(xh, xl, k.bx_h, k.bx_l, lh, ll);
            fpr::ds_mul_ds(yh, yl, k.by_h, k.by_l, th, tl);
            fpr::ds_add(lh, ll, th, tl, lh, ll);
            fpr::ds_mul_ds(zh, zl, k.bz_h, k.bz_l, th, tl);
            fpr::ds_add(lh, ll, th, tl, lh, ll);

            float s, e;
            fpr::two_sum(ch, -ht[i], s, e);
            const float sl = e + (cl - ht[n + i]);
            float mh, ml;
            fpr::ds_mul_ds(s, sl, k.inv_dt_h, k.inv_dt_l, mh, ml);

            float dh, dl;
            fpr::ds_add(mh, ml, -lh, -ll, dh, dl);
            float ph, pe;
            fpr::ds_mul_ds(dh, dl, k.dtau_h, k.dtau_l, ph, pe);
            fpr::ds_add(ch, cl, -ph, -pe, nh, nl);
            dsq = dh * dh;
        }
        out[i] = nh;
        out[n + i] = nl;
    }
    return dsq;
}

// The untested form: one block a tile of the (nx/32, ny/8, nz) grid, htau
// into out, its partial sum into partials (if not null).  The tested form:
// blocks that take the tiles in turn (fpr::Tiles), each thread adding its
// cells' dH_hi^2 in that order, the sum and the loop test finished in the
// launch; htau into out when the count it starts from is even, htau_odd
// into out_odd when it is odd, the pair passed twice as in
// csrc/dual_time.cu.
template <bool TESTED>
__global__ void __launch_bounds__(FPR_THREADS)
ds3d_kernel(const float* __restrict__ ht, const float* __restrict__ htau, float* out,
            const float* __restrict__ htau_odd, float* out_odd, float* __restrict__ partials,
            DsConsts k, int nz, int ny, int nx, fpr::Tiles tiles, fpr::LoopTest test) {
    __shared__ float sh[FPR_BY];
    if constexpr (TESTED) {
        // the count the launch starts from, read once a block (before its
        // ticket, so before the last block writes it) and shared
        __shared__ int it_shared;
        if (fpr::block_leader()) it_shared = *test.it;
        __syncthreads();
        const int it_prev = it_shared;
        const bool odd = it_prev & 1;
        const float* src = odd ? htau_odd : htau;
        float* dst = odd ? out_odd : out;
        float v[1] = {0.0f};
        fpr::for_tiles(tiles, [&](unsigned bx, unsigned by, unsigned bz) {
            v[0] += update_cell(ht, src, dst, k, nz, ny, nx, bx, by, bz);
        });
        if (fpr::finish_launch<FPR_THREADS, 1>(v, 0u, partials, test.ticket, sh,
                                               threadIdx.y * FPR_BX + threadIdx.x)) {
            fpr::finish_test(test, v[0], it_prev);
        }
    } else {
        float dsq = update_cell(ht, htau, out, k, nz, ny, nx, blockIdx.x, blockIdx.y,
                                blockIdx.z);
        if (partials != nullptr) {  // the same for every block of the launch
            dsq = fpr::block_sum(dsq, sh);
            if (fpr::block_leader()) partials[fpr::block_id()] = dsq;
        }
    }
}

}  // namespace

extern "C" {

// One ds iteration on (2, nz, ny, nx) hi/lo state.  The ten constants are
// the (hi, lo) pairs of 1/dt, D/dx^2, D/dy^2, D/dz^2 and dtau.  partials and
// test as for fpr_dual_time, htau and out the tested form's ping-pong pair
// as there.  Returns the launch's cudaError_t.
int fpr_ds3d(const float* ht, float* htau, float* out, float* partials,
             int n_partials, float inv_dt_h, float inv_dt_l, float bx_h, float bx_l,
             float by_h, float by_l, float bz_h, float bz_l, float dtau_h, float dtau_l,
             int nz, int ny, int nx, const fpr::LoopTest* test, cudaStream_t stream) {
    const dim3 grid = fpr::grid_of_3d(nz, ny, nx);
    const long long tiles = static_cast<long long>(grid.x) * grid.y * grid.z;
    if (nz > 65535 || (partials != nullptr && n_partials != tiles) ||
        (test != nullptr && (partials == nullptr || htau == out))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const DsConsts k{inv_dt_h, inv_dt_l, bx_h, bx_l, by_h, by_l, bz_h, bz_l, dtau_h, dtau_l};
    const fpr::Tiles tl{grid.x, grid.y, static_cast<unsigned>(tiles)};
    if (test != nullptr) {
        static std::atomic<int> slots_cached{0};
        int slots = 0;
        const cudaError_t err = fpr::card_slots(ds3d_kernel<true>, slots_cached, slots);
        if (err != cudaSuccess) return static_cast<int>(err);
        ds3d_kernel<true><<<static_cast<unsigned>(std::min<long long>(tiles, slots)),
                            dim3(FPR_BX, FPR_BY), 0, stream>>>(ht, htau, out, out, htau,
                                                               partials, k, nz, ny, nx, tl,
                                                               *test);
    } else {
        ds3d_kernel<false><<<grid, dim3(FPR_BX, FPR_BY), 0, stream>>>(
            ht, htau, out, htau, out, partials, k, nz, ny, nx, tl, fpr::LoopTest{});
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
