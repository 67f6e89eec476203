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
// once per block, and the shard hooks (row/column offsets, owned lanes).
#include "fpr_common.cuh"

namespace {

enum : int {
    APPLY_BCS = 1,
    C_ZERO = 2,
    F_SINGLE = 4,
    VELOCITY_MAX = 8,
    FIELD_SUMSQ = 16,
};

// The updated (and, with bcs, BC'd) ds value at (y, x).  BCs: Dirichlet
// rows first (1 at y = 0, 0 at y = ny-1, lo part 0), then the Neumann
// column copies, which read the Dirichlet'd field, so they win at the
// corners (fpr_tpu/core/bc.py::ns_temperature_bcs).
__device__ __forceinline__ void updated(const float* __restrict__ uh,
                                        const float* __restrict__ ul,
                                        const float* __restrict__ e, float scale,
                                        bool bcs, int ny, int nx, int y, int x,
                                        float& h, float& l) {
    if (bcs) {
        if (y == 0) { h = 1.0f; l = 0.0f; return; }
        if (y == ny - 1) { h = 0.0f; l = 0.0f; return; }
        if (x == 0) x = 1;
        else if (x == nx - 1) x = nx - 2;
    }
    const int i = y * nx + x;
    float ph, pe;
    fpr::two_prod(e ? e[i] : 0.0f, scale, ph, pe);
    fpr::ds_add(uh[i], ul[i], -ph, -pe, h, l);
}

__global__ void __launch_bounds__(FPR_THREADS)
defect_kernel(const float* __restrict__ uh, const float* __restrict__ ul,
              const float* __restrict__ fh, const float* __restrict__ fl,
              const float* __restrict__ e, const float* __restrict__ cpair,
              float scale, float inv_h2, float inv2h, int ny, int nx, int flags,
              float* __restrict__ uh_out, float* __restrict__ ul_out,
              float* __restrict__ r_out, float* __restrict__ partials) {
    __shared__ float sh[FPR_BY];
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    const bool bcs = flags & APPLY_BCS;
    float rsq = 0.0f, vx = 0.0f, vy = 0.0f, usq = 0.0f;

    if (x < nx && y < ny) {
        const int i = y * nx + x;
        float ch, cl;
        updated(uh, ul, e, scale, bcs, ny, nx, y, x, ch, cl);
        uh_out[i] = ch;
        ul_out[i] = cl;
        usq = ch * ch;
        float r = 0.0f;
        if (x > 0 && y > 0 && x < nx - 1 && y < ny - 1) {
            float uph, upl, dnh, dnl, lfh, lfl, rth, rtl;
            updated(uh, ul, e, scale, bcs, ny, nx, y - 1, x, uph, upl);
            updated(uh, ul, e, scale, bcs, ny, nx, y + 1, x, dnh, dnl);
            updated(uh, ul, e, scale, bcs, ny, nx, y, x - 1, lfh, lfl);
            updated(uh, ul, e, scale, bcs, ny, nx, y, x + 1, rth, rtl);
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
            rsq = r * r;
            if (flags & VELOCITY_MAX) {
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
// for a zero correction.  Returns the launch's cudaError_t.
int fpr_defect(const float* uh, const float* ul, const float* fh, const float* fl,
               const float* e, const float* cpair, float scale, float inv_h2,
               float inv2h, int ny, int nx, int flags, float* uh_out,
               float* ul_out, float* r_out, float* partials, cudaStream_t stream) {
    defect_kernel<<<fpr::grid_of(ny, nx), dim3(FPR_BX, FPR_BY), 0, stream>>>(
        uh, ul, fh, fl, e, cpair, scale, inv_h2, inv2h, ny, nx, flags, uh_out,
        ul_out, r_out, partials);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
