// K1: the double-single defect pass of the ds multigrid outer loop.
//
// Replaces fpr_tpu/ops/ds.py::_defect_kernel (built at ds.py:498, wrapped
// by defect_pass and defect_pass_stk).  One pass computes
//
//     u' = u - scale * e                      (double-single update)
//     u' = BCs(u')                            (optional NS temperature BCs)
//     r  = (u'_N + u'_S + u'_W + u'_E - C u') / h^2 - f   (ds residual)
//
// with C = 4 + c h^2 as a ds pair read from device memory, and per-block
// partials of sum(r_hi^2) over the interior, max |du'/dy| and max |du'/dx|
// over the interior, and sum(u'_hi^2) over the domain.
//
// Shard hooks (ds.py:355-372 and 575-641: row_off/ny_mask, col_off/nx_mask,
// own_lanes, raw_sumsq): local row y is global row row_off + y of an
// ny_g-row grid, local column x global column col_off + x of an nx_g-column
// grid (col_off < 0 on a 2D mesh's left-edge shards).  The BCs' Dirichlet
// rows and the interior follow the global row and column, and the local
// first and last rows and columns, which lack an outer neighbour, are never
// interior.  The sums and maxima cover the owned local cells, rows
// [own0, own1) x columns [ownc0, ownc1), only: a ghost column is an interior
// cell that the x-neighbour owns.  sum(u'^2) covers the owned cells inside
// the global grid.  A single device passes row_off = col_off = 0, the
// physical sizes, and owns every cell.  The BCs' Neumann columns are the
// local side columns, so apply_bcs takes whole columns (the wrapper checks).
// The column tests are compiled in only where the column hooks are not
// whole (the template flag COLS): in every launch they cost 2-4 % of the
// device time (scripts/kernel_times.py, PERF.md), which the single device
// and the row shards need not pay.
//
// Bound on the H100: memory bandwidth.  A cell reads u hi/lo, f (one or
// two planes) and e, and writes u' hi/lo and r: 6-8 f32 words, against
// about 120 flops of ds arithmetic.
//
// Design: one thread per cell on the physical (ny, nx) arrays.  The TPU
// kernel applies the update and the BCs to a whole halo window, so its
// stencil reads updated, BC'd neighbours; here each thread recomputes the
// updated, BC'd value of its four neighbours itself (their loads hit L1/L2),
// which keeps it one launch with no intermediate plane.  Cross-block sums go
// to a per-block partials buffer that the caller adds in a fixed order.
// Left for later: shared-memory tiles so each value is loaded and updated
// once per block.
#include "fpr_common.cuh"

namespace {

enum : int {
    APPLY_BCS = 1,
    C_ZERO = 2,
    F_SINGLE = 4,
    VELOCITY_MAX = 8,
    FIELD_SUMSQ = 16,
};

// The updated (and, with bcs, BC'd) ds value at local (y, x), global row
// gy.  BCs: Dirichlet rows first (1 at gy = 0, 0 at gy = ny_g-1, lo part
// 0), then the Neumann column copies, which read the Dirichlet'd field, so
// they win at the corners (fpr_tpu/core/bc.py::ns_temperature_bcs).
__device__ __forceinline__ void updated(const float* __restrict__ uh,
                                        const float* __restrict__ ul,
                                        const float* __restrict__ e, float scale,
                                        bool bcs, int ny_g, int nx, int y, int gy, int x,
                                        float& h, float& l) {
    if (bcs) {
        if (gy == 0) { h = 1.0f; l = 0.0f; return; }
        if (gy == ny_g - 1) { h = 0.0f; l = 0.0f; return; }
        if (x == 0) x = 1;
        else if (x == nx - 1) x = nx - 2;
    }
    const int i = y * nx + x;
    float ph, pe;
    fpr::two_prod(e ? e[i] : 0.0f, scale, ph, pe);
    fpr::ds_add(uh[i], ul[i], -ph, -pe, h, l);
}

template <bool COLS>
__global__ void __launch_bounds__(FPR_THREADS)
defect_kernel(const float* __restrict__ uh, const float* __restrict__ ul,
              const float* __restrict__ fh, const float* __restrict__ fl,
              const float* __restrict__ e, const float* __restrict__ cpair,
              float scale, float inv_h2, float inv2h, int ny, int nx, int flags,
              int row_off, int ny_g, int own0, int own1, int col_off, int nx_g, int ownc0,
              int ownc1, float* __restrict__ uh_out,
              float* __restrict__ ul_out, float* __restrict__ r_out,
              float* __restrict__ partials) {
    __shared__ float sh[FPR_BY];
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    const int gy = row_off + y;
    const int gx = col_off + x;
    const bool bcs = flags & APPLY_BCS;
    const bool own = y >= own0 && y < own1 && (!COLS || (x >= ownc0 && x < ownc1));
    float rsq = 0.0f, vx = 0.0f, vy = 0.0f, usq = 0.0f;

    if (x < nx && y < ny) {
        const int i = y * nx + x;
        float ch, cl;
        updated(uh, ul, e, scale, bcs, ny_g, nx, y, gy, x, ch, cl);
        uh_out[i] = ch;
        ul_out[i] = cl;
        if (own && gy >= 0 && gy < ny_g && (!COLS || (gx >= 0 && gx < nx_g))) usq = ch * ch;
        float r = 0.0f;
        if (x > 0 && y > 0 && x < nx - 1 && y < ny - 1 && gy > 0 && gy < ny_g - 1 &&
            (!COLS || (gx > 0 && gx < nx_g - 1))) {
            float uph, upl, dnh, dnl, lfh, lfl, rth, rtl;
            updated(uh, ul, e, scale, bcs, ny_g, nx, y - 1, gy - 1, x, uph, upl);
            updated(uh, ul, e, scale, bcs, ny_g, nx, y + 1, gy + 1, x, dnh, dnl);
            updated(uh, ul, e, scale, bcs, ny_g, nx, y, gy, x - 1, lfh, lfl);
            updated(uh, ul, e, scale, bcs, ny_g, nx, y, gy, x + 1, rth, rtl);
            // neighbour sum as a two_sum cascade (ds.py:325-333)
            float s1, e1, s2, e2, sh_, e3;
            fpr::two_sum(uph, dnh, s1, e1);
            fpr::two_sum(lfh, rth, s2, e2);
            fpr::two_sum(s1, s2, sh_, e3);
            const float sl_ = ((e1 + e2) + e3) + ((upl + dnl) + (lfl + rtl));
            float cuh, cul;
            if (flags & C_ZERO) {
                cuh = ch * 4.0f;
                cul = cl * 4.0f;
            } else {
                fpr::ds_mul_ds(ch, cl, cpair[0], cpair[1], cuh, cul);
            }
            float th, tl;
            fpr::ds_add(sh_, sl_, -cuh, -cul, th, tl);
            th = th * inv_h2;  // exact: inv_h2 is a power of two
            tl = tl * inv_h2;
            float rs, re;
            fpr::two_sum(th, -fh[i], rs, re);
            r = (flags & F_SINGLE) ? rs + (re + tl) : rs + (re + (tl - fl[i]));
            if (own) rsq = r * r;
            if (own && (flags & VELOCITY_MAX)) {
                vx = fabsf((dnh - uph) * inv2h);
                vy = fabsf((rth - lfh) * inv2h);
            }
        }
        r_out[i] = r;
    }

    const int nb = fpr::num_blocks(), b = fpr::block_id();
    rsq = fpr::block_sum(rsq, sh);
    if (fpr::block_leader()) partials[b] = rsq;
    if (flags & VELOCITY_MAX) {
        vx = fpr::block_max(vx, sh);
        if (fpr::block_leader()) partials[nb + b] = vx;
        vy = fpr::block_max(vy, sh);
        if (fpr::block_leader()) partials[2 * nb + b] = vy;
    }
    if (flags & FIELD_SUMSQ) {
        usq = fpr::block_sum(usq, sh);
        if (fpr::block_leader()) partials[3 * nb + b] = usq;
    }
}

}  // namespace

extern "C" {

// Blocks of the launch grid for an (ny, nx) array: the length of each row
// of a partials buffer.
int fpr_num_blocks(int ny, int nx) {
    const dim3 g = fpr::grid_of(ny, nx);
    return static_cast<int>(g.x * g.y);
}

// partials: (4, fpr_num_blocks) f32.  fl may be null when F_SINGLE, e null
// for a zero correction.  row_off, ny_g, own0, own1: the row hooks;
// col_off, nx_g, ownc0, ownc1: the column hooks.  Returns the launch's
// cudaError_t.
int fpr_defect(const float* uh, const float* ul, const float* fh, const float* fl,
               const float* e, const float* cpair, float scale, float inv_h2,
               float inv2h, int ny, int nx, int flags, int row_off, int ny_g, int own0,
               int own1, int col_off, int nx_g, int ownc0, int ownc1, float* uh_out,
               float* ul_out, float* r_out, float* partials, cudaStream_t stream) {
    const bool cols = !(col_off == 0 && nx_g == nx && ownc0 == 0 && ownc1 == nx);
    auto kernel = cols ? defect_kernel<true> : defect_kernel<false>;
    kernel<<<fpr::grid_of(ny, nx), dim3(FPR_BX, FPR_BY), 0, stream>>>(
        uh, ul, fh, fl, e, cpair, scale, inv_h2, inv2h, ny, nx, flags, row_off, ny_g, own0,
        own1, col_off, nx_g, ownc0, ownc1, uh_out, ul_out, r_out, partials);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
