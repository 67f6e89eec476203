// K1: the double-single defect pass of the ds multigrid outer loop.
//
// Replaces fpr_tpu/ops/ds.py::_defect_kernel (built at ds.py:498, wrapped
// by defect_pass and defect_pass_stk).  One pass computes
//
//     u' = u - scale * e                      (double-single update)
//     u' = BCs(u')                            (optional NS temperature BCs)
//     r  = (u'_N + u'_S + u'_W + u'_E - C u') / h^2 - f   (ds residual)
//
// with C = 4 + c h^2 as a ds pair, and sum(r_hi^2) over the interior, max
// |du'/dy| and max |du'/dx| over the interior, sum(u'_hi^2) over the
// domain, and r_rms = sqrt(sum(r_hi^2) / n_cells), all finished in the
// launch.
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
// whole (the template flag COLS), which the single device and the row
// shards need not pay.
//
// Bound on the H100: a cell reads u hi/lo, f (one or two planes) and e and
// writes u' hi/lo and r: 24-32 bytes, 8.8 us at 513 x 2049 and 141 us at
// 4097^2 at 3.35 TB/s.  The one-thread-a-cell kernel before this one
// recomputed the update (under -fmad=false a Dekker product, a ds_add and
// three loads, about 35 instructions) of each of a cell's four neighbours,
// paid up to four block reductions per 256 cells and left the cross-block
// sums to nine more launches.  What bounds this kernel (PERF.md §6):
// at 4097^2 its bytes (66 % of the bound); at 513 x 2049 the memory latency
// that its blocks do not hide.  There a launch is under two turns of tiles
// on the blocks the card holds at once, and in each turn a block loads its
// tile, waits at a barrier, computes and stores, so loads, issue and the
// finish of the sums run largely one after another.
//
// Design: a tile of 32 columns x 8 S rows in shared memory (fpr::TILE_*;
// S rows a thread, 1 <= S <= 4).  The launch has as many blocks as the
// card holds at once (at most one a tile), which take the tiles in turn
// and keep their sums in registers across tiles; S is the largest up to 3
// that still gives every block a tile (ops/ds.py, kernels.tile_plan, from
// the card's SMs and resident blocks).  For a tile, each thread updates its
// S cells once and writes u', loading their f too, and four warps update
// one cell each of the one-cell halo, so a cell costs 1 + (64 + 16 S) /
// (256 S) updates (1.15 at S = 3).  The region's values go to a shared
// plane; after one barrier each cell takes itself and its four neighbours
// from the plane and computes its residual in the plain version's
// operation order (the two_sum cascade of ds.py:325-333), so the fields
// are bitwise those of ops/ds.py::defect_pass_plain.  The sums are
// finished in the launch (fpr::finish_launch): one block reduction for all
// four, partials, a ticket, and the last block's fold and r_rms.  Kept
// against a y-march (one thread a column, x neighbours by shuffles), which
// was slower at both shapes, and one block a tile, slower too; holding the
// cells in registers as well was no faster (PERF.md §6).
#include "fpr_common.cuh"

namespace {

enum : int {
    APPLY_BCS = 1,
    C_ZERO = 2,
    F_SINGLE = 4,
    VELOCITY_MAX = 8,
    FIELD_SUMSQ = 16,
};
// where C comes from: the pair by value, a device pair, or a device
// float32 c (C derived as ops/ds.py::defect_scalars does)
enum : int { C_VALUE = 0, C_PAIR = 1, C_SCALAR = 2 };

constexpr int NT = fpr::TILE_NT, S_MAX = fpr::TILE_S_MAX, PW = fpr::TILE_PW;
// the launch's quantities: sum r^2, max |du/dy|, max |du/dx|, sum u^2
constexpr int NQ = 4;
constexpr unsigned MAXIMA = 0b0110u;

struct Params {
    const float *uh, *ul, *fh, *fl, *e;  // fl null when F_SINGLE, e null for 0
    const float* c;                      // by c_kind; null for C_VALUE
    int c_kind;
    float C_hi, C_lo, h2;
    float scale, inv_h2, inv2h, n_cells;
    const float* scale_dev;              // the scale on the device, or null for scale
    int ny, nx, flags, S;
    int row_off, ny_g, own0, own1, col_off, nx_g, ownc0, ownc1;
    float *uh_out, *ul_out, *r_out;
    float* partials;    // (NQ, blocks)
    unsigned* counter;  // 0 between launches
    float* out;         // [sum r^2, max|du/dy|, max|du/dx|, sum u^2, r_rms]
};

// The updated (and, with bcs, BC'd) ds value at local (y, x), global row
// gy.  BCs: Dirichlet rows first (1 at gy = 0, 0 at gy = ny_g-1, lo part
// 0), then the Neumann column copies, which read the Dirichlet'd field, so
// they win at the corners (fpr_tpu/core/bc.py::ns_temperature_bcs).
__device__ __forceinline__ void updated(const Params& p, bool bcs, int y, int gy, int x,
                                        float& h, float& l) {
    if (bcs) {
        if (gy == 0) { h = 1.0f; l = 0.0f; return; }
        if (gy == p.ny_g - 1) { h = 0.0f; l = 0.0f; return; }
        if (x == 0) x = 1;
        else if (x == p.nx - 1) x = p.nx - 2;
    }
    const int i = y * p.nx + x;
    float ph, pe;
    fpr::two_prod(p.e ? p.e[i] : 0.0f, p.scale_dev ? *p.scale_dev : p.scale, ph, pe);
    fpr::ds_add(p.uh[i], p.ul[i], -ph, -pe, h, l);
}

template <bool COLS>
__global__ void __launch_bounds__(NT) defect_kernel(const Params p) {
    __shared__ float2 plane[fpr::TILE_PLANE];
    __shared__ float red[NQ * NT / 32];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int S = p.S, TY = fpr::TILE_WARPS * S, nx = p.nx, ny = p.ny;
    const int tiles_x = (nx + fpr::TILE_X - 1) / fpr::TILE_X;
    const int n_tiles = tiles_x * ((ny + TY - 1) / TY);
    const bool bcs = p.flags & APPLY_BCS, f_single = p.flags & F_SINGLE;
    float Ch = p.C_hi, Cl = p.C_lo;
    if (p.c_kind == C_PAIR) {
        Ch = p.c[0];
        Cl = p.c[1];
    } else if (p.c_kind == C_SCALAR) {
        fpr::c_pair(p.c[0], p.h2, Ch, Cl);
    }
    float rsq = 0.0f, vx = 0.0f, vy = 0.0f, usq = 0.0f;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int x0 = t % tiles_x * fpr::TILE_X, y0 = t / tiles_x * TY;
        const int x = x0 + lane, gx = p.col_off + x;
        const bool x_in = x < nx;

        // the thread's cells, updated once, into the output and the plane,
        // with their f into registers; then its halo cell, if it has one
        float fh[S_MAX], fl[S_MAX];
#pragma unroll
        for (int s = 0; s < S_MAX; ++s) {
            fh[s] = fl[s] = 0.0f;
            if (s >= S) continue;
            const int ry = w * S + s, y = y0 + ry;
            float h = 0.0f, l = 0.0f;
            if (x_in && y < ny) {
                const int i = y * nx + x;
                fh[s] = p.fh[i];
                if (!f_single) fl[s] = p.fl[i];
                updated(p, bcs, y, p.row_off + y, x, h, l);
                p.uh_out[i] = h;
                p.ul_out[i] = l;
            }
            plane[(ry + 1) * PW + lane + 1] = make_float2(h, l);
        }
        {
            int ry, rx;
            if (fpr::tile_halo(w, lane, TY, ry, rx)) {
                const int y = y0 + ry, xh = x0 + rx;
                float h = 0.0f, l = 0.0f;
                if (y >= 0 && y < ny && xh >= 0 && xh < nx) {
                    updated(p, bcs, y, p.row_off + y, xh, h, l);
                }
                plane[(ry + 1) * PW + rx + 1] = make_float2(h, l);
            }
        }
        __syncthreads();

        const bool x_int = x > 0 && x < nx - 1 && (!COLS || (gx > 0 && gx < p.nx_g - 1));
        const bool x_own = !COLS || (x >= p.ownc0 && x < p.ownc1);
        const bool x_phys = !COLS || (gx >= 0 && gx < p.nx_g);
#pragma unroll
        for (int s = 0; s < S_MAX; ++s) {
            const int ry = w * S + s, y = y0 + ry, gy = p.row_off + y;
            if (s >= S || !x_in || y >= ny) continue;
            const float2* a = plane + (ry + 1) * PW + lane + 1;
            const float ch = a[0].x, cl = a[0].y;
            const bool own = x_own && y >= p.own0 && y < p.own1;
            if ((p.flags & FIELD_SUMSQ) && own && gy >= 0 && gy < p.ny_g && x_phys) {
                usq += ch * ch;
            }
            float r = 0.0f;
            if (x_int && y > 0 && y < ny - 1 && gy > 0 && gy < p.ny_g - 1) {
                const float2 up = a[-PW], dn = a[PW], lf = a[-1], rt = a[1];
                // neighbour sum as a two_sum cascade (ds.py:325-333)
                float s1, e1, s2, e2, sh_, e3;
                fpr::two_sum(up.x, dn.x, s1, e1);
                fpr::two_sum(lf.x, rt.x, s2, e2);
                fpr::two_sum(s1, s2, sh_, e3);
                const float sl_ = ((e1 + e2) + e3) + ((up.y + dn.y) + (lf.y + rt.y));
                float cuh, cul;
                if (p.flags & C_ZERO) {
                    cuh = ch * 4.0f;
                    cul = cl * 4.0f;
                } else {
                    fpr::ds_mul_ds(ch, cl, Ch, Cl, cuh, cul);
                }
                float th, tl;
                fpr::ds_add(sh_, sl_, -cuh, -cul, th, tl);
                th = th * p.inv_h2;  // exact: inv_h2 is a power of two
                tl = tl * p.inv_h2;
                float rs, re;
                fpr::two_sum(th, -fh[s], rs, re);
                r = f_single ? rs + (re + tl) : rs + (re + (tl - fl[s]));
                if (own) {
                    rsq += r * r;
                    if (p.flags & VELOCITY_MAX) {
                        vx = fmaxf(vx, fabsf((dn.x - up.x) * p.inv2h));
                        vy = fmaxf(vy, fabsf((rt.x - lf.x) * p.inv2h));
                    }
                }
            }
            p.r_out[y * nx + x] = r;
        }
        __syncthreads();  // the plane is the next tile's
    }

    float v[NQ] = {rsq, vx, vy, usq};
    if (fpr::finish_launch<NT, NQ>(v, MAXIMA, p.partials, p.counter, red, tid)) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) p.out[q] = v[q];
        p.out[NQ] = __fsqrt_rn(__fdiv_rn(v[0], p.n_cells));  // IEEE, as torch.sqrt(s / n)
    }
}

int n_tiles(int ny, int nx, int S) {
    const int ty = fpr::TILE_WARPS * S;
    return ((nx + fpr::TILE_X - 1) / fpr::TILE_X) * ((ny + ty - 1) / ty);
}

}  // namespace

extern "C" {

// The card's SMs and the blocks of the defect kernel (cols: its column-hook
// form) that one SM holds at once, for the wrapper's choice of S.
int fpr_defect_fill(int cols, int* sms, int* per_sm) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, cols ? defect_kernel<true> : defect_kernel<false>, NT, 0);
    }
    return static_cast<int>(err);
}

// One defect pass over (ny, nx) f32 planes with S (1 .. fpr::TILE_S_MAX)
// rows a thread, on `blocks` blocks (1 .. the tiles) that take the tiles in
// turn.  fl may be null when F_SINGLE, e null for a zero correction.  C:
// c_kind C_VALUE takes (C_hi, C_lo), C_PAIR the device pair c, C_SCALAR
// derives it from the device c and h2.  scale_dev: the scale as a device
// float (a CG step length computed on the device), or null for scale.  row_off, ny_g, own0, own1: the row
// hooks; col_off, nx_g, ownc0, ownc1: the column hooks.  partials: 4 x
// blocks f32, scratch; counter: a device word that is 0 and used by no
// other launch in flight (0 again after this one); out: 5 f32, [sum r^2,
// max|du/dy|, max|du/dx|, sum u^2, sqrt(sum r^2 / n_cells)].  Bad
// arguments are refused with cudaErrorInvalidValue.  Returns the launch's
// cudaError_t.
int fpr_defect(const float* uh, const float* ul, const float* fh, const float* fl,
               const float* e, const float* c, int c_kind, float C_hi, float C_lo, float h2,
               float scale, const float* scale_dev, float inv_h2, float inv2h,
               float n_cells, int ny, int nx, int flags, int S, int blocks, int row_off, int ny_g, int own0, int own1,
               int col_off, int nx_g, int ownc0, int ownc1, float* uh_out, float* ul_out,
               float* r_out, float* partials, unsigned* counter, float* out,
               cudaStream_t stream) {
    if (S < 1 || S > S_MAX || ny < 3 || nx < 3 || blocks < 1 || blocks > n_tiles(ny, nx, S) ||
        !uh || !ul || !fh || (!(flags & F_SINGLE) && !fl) || c_kind < C_VALUE ||
        c_kind > C_SCALAR || (c_kind != C_VALUE && !c) || !uh_out || !ul_out || !r_out ||
        !partials || !counter || !out) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Params p{uh, ul, fh, fl, e, c, c_kind, C_hi, C_lo, h2, scale, inv_h2, inv2h,
                   n_cells, scale_dev, ny, nx, flags, S, row_off, ny_g, own0, own1, col_off, nx_g,
                   ownc0, ownc1, uh_out, ul_out, r_out, partials, counter, out};
    const bool cols = !(col_off == 0 && nx_g == nx && ownc0 == 0 && ownc1 == nx);
    auto kernel = cols ? defect_kernel<true> : defect_kernel<false>;
    kernel<<<blocks, NT, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
