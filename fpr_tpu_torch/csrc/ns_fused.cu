// K4: the fused Navier-Stokes operator pass.
//
// Replaces fpr_tpu/ops/pallas_ns.py::_ns_kernel (built at pallas_ns.py:389,
// wrapped by ns_fused_rp) in both its modes and both its defect options:
//
//   T <- BCs(T)  (Dirichlet bottom/top, then Neumann sides: Neumann wins at
//                 the corners)
//   vx = dS/dy, vy = -dS/dx; B = Ra dT/dx; dT2 = k lap T, dW2 = Pr lap W
//   (no diffusion when beta == 1); first-order upwind advection
//   explicit: T' = T + dt (dT2 - dTx - dTy),  W' = W + dt (dW2 - dWx - dWy - Pr B)
//   rhs:      T' = -cT (T + dt ((1-beta) dT2 - dTx - dTy)), W' likewise with cW
//
// On the boundary T' carries the BC'd T and W' the old W (explicit), or
// -c times them (rhs).  Also sum(T'^2) and sum(W'^2), finished in the
// launch; with the defect flag (explicit only) the next stream-function solve's
// initial ds defect r = A S - W' (S a hi/lo pair, c = 0; formula for
// formula ds.py's defect with scale 0), sum(r^2), and max |dS/dy|,
// max |dS/dx| of S over the interior.  With the Helmholtz flag (rhs only,
// pallas_ns.py:82-88, 266-296) the two Helmholtz solves' warm-start
// defects rT = A_cT (BC(T), 0) - T' and rW = A_cW (W, 0) - W' in ds
// arithmetic, formula for formula K1's with a zero lo plane, the C pairs
// against ds_mul_ds and an exactly-f32 rhs, and sum(rT^2), sum(rW^2), with
// their rms over the global cells.  No solver path launches the Helmholtz
// flag, as in the JAX package (pallas_ns.py:455-459, measured slower than
// two defect passes).
// The Helmholtz defects are a template flag (HELM), compiled into the
// launches that compute them only: behind a runtime test in every launch,
// their registers cost the other modes 6 % of their device time
// (scripts/kernel_times.py, PERF.md).
//
// Row hooks (pallas_ns.py:431-495, row_off/ny_mask): local row y is global
// row row_off + y of an ny_g-row grid.  The T BCs' Dirichlet rows and the
// interior follow the global row, and the local first and last rows, which
// lack an outer neighbour, are never interior; outputs outside the global
// grid are 0; the sums and maxima cover the owned rows [own0, own1).
//
// Bound on the H100: a cell reads T, W, S (and S lo) and writes T', W'
// (and r, or rT and rW): 20-28 bytes, 6.3-8.8 us at 513 x 2049 at 3.35
// TB/s, against about 80 flops (about 200 with the Helmholtz defects).  The
// one-thread-a-cell kernel before this one loaded the 5-point
// neighbourhoods of T (each through the BCs), W and S through L1, paid up
// to five block reductions per 256 cells and left the cross-block sums and
// the rms to up to nine more launches.  What bounds this kernel (PERF.md
// §6): as K1's (defect.cu), the memory latency that a turn of resident
// blocks, each loading, waiting at a barrier and computing, does not hide;
// in the rhs and Helmholtz modes the one-thread-a-cell kernel, with more
// resident warps and no barrier, was faster on the device alone, though not
// a whole call.  K4 runs at the NS shape only; at 4097^2 it would be bound
// by its bytes as K1 is.
//
// Design: the tile of defect.cu (fpr::TILE_*, kernels.tile_plan): blocks as
// many as the card holds at once take tiles of 32 columns x 8 S rows in
// turn.  Each thread loads its cells' BC'd T, W, S and S lo once, into
// registers and a shared plane, and four warps one cell each of the
// one-cell halo; after one barrier a cell takes its y neighbours from the
// registers (the plane at the strip's ends) and its x neighbours from the
// plane, in the plain version's operation order, so the fields are bitwise
// those of ops/ns_fused.py::ns_fused_plain.  A thread adds its cells'
// squares and maxima in registers, and the sums are finished in the launch
// (fpr::finish_launch): one block reduction for all six, partials, a
// ticket, the last block's fold and the rms values.  dt, cT and cW are read
// from device memory, and the Helmholtz C = 4 + c h^2 pairs derived from cT
// and cW in the kernel (fpr::c_pair), so a call is one launch.  Kept
// against a y-march (one thread a column, the rows above, at and below in
// registers, x neighbours through L1), which was slower (PERF.md §6).
#include "fpr_common.cuh"

namespace {

enum : int { MODE_RHS = 1, WITH_DEFECT = 2, USE_DIF = 4, HELM_DEFECT = 8 };

constexpr int NT = fpr::TILE_NT, S_MAX = fpr::TILE_S_MAX, PW = fpr::TILE_PW;
// the launch's quantities: sum T'^2, sum W'^2, sum r^2 (rT^2 with the
// Helmholtz flag), max |dS/dy|, max |dS/dx|, sum rW^2
constexpr int NQ = 6;
constexpr unsigned MAXIMA = 0b011000u;

struct Params {
    const float *T, *W, *Sh, *Sl;  // Sl with the defect flag only
    const float *dt, *cT, *cW;     // cT and cW in rhs mode only
    float inv2h, inv_h, inv_h2, h2, Pr, Ra, k, wdif, n_cells;
    int ny, nx, flags, S, row_off, ny_g, own0, own1;
    float *T_out, *W_out, *r_out, *rw_out;
    float* partials;    // (NQ, blocks)
    unsigned* counter;  // 0 between launches
    float* out;         // [the NQ quantities, sqrt(q2 / n_cells), sqrt(q5 / n_cells)]
};

// BC'd temperature at local (y, x), global row gy: Dirichlet rows, then the
// Neumann copies of the Dirichlet'd field.
__device__ __forceinline__ float t_bc(const Params& p, int y, int gy, int x) {
    if (gy == 0) return 1.0f;
    if (gy == p.ny_g - 1) return 0.0f;
    if (x == 0) x = 1;
    else if (x == p.nx - 1) x = p.nx - 2;
    return p.T[y * p.nx + x];
}

// A region cell's values: BC'd T, W, S hi, S lo (0 without the defect flag).
__device__ __forceinline__ float4 cell(const Params& p, bool defect, int y, int x) {
    const int i = y * p.nx + x;
    return make_float4(t_bc(p, y, p.row_off + y, x), p.W[i], p.Sh[i], defect ? p.Sl[i] : 0.0f);
}

// The ds residual of the warm start (X, 0) against an exactly-f32 rhs:
// ds.py's defect formula with every lo part 0, C = (C_hi, C_lo) by ds_mul_ds
// (pallas_ns.py:276-290).  The zero lo terms are added as there: adding
// +0.0f is not an identity for -0.0f, so the compiler keeps them.
__device__ __forceinline__ float helm_residual(float xc, float xu, float xd, float xl,
                                               float xr, float C_hi, float C_lo,
                                               float inv_h2, float rhs) {
    const float z = 0.0f;
    float s1, e1, s2, e2, sh_, e3;
    fpr::two_sum(xu, xd, s1, e1);
    fpr::two_sum(xl, xr, s2, e2);
    fpr::two_sum(s1, s2, sh_, e3);
    const float sl_ = ((e1 + e2) + e3) + ((z + z) + (z + z));
    float cuh, cul;
    fpr::ds_mul_ds(xc, z, C_hi, C_lo, cuh, cul);
    float th, tl;
    fpr::ds_add(sh_, sl_, -cuh, -cul, th, tl);
    th = th * inv_h2;  // exact: a power of two
    tl = tl * inv_h2;
    float rs, re;
    fpr::two_sum(th, -rhs, rs, re);
    return rs + (re + tl);
}

template <bool HELM>
__global__ void __launch_bounds__(NT) ns_kernel(const Params p) {
    __shared__ float4 plane[fpr::TILE_PLANE];
    __shared__ float red[NQ * NT / 32];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int S = p.S, TY = fpr::TILE_WARPS * S, nx = p.nx, ny = p.ny;
    const int tiles_x = (nx + fpr::TILE_X - 1) / fpr::TILE_X;
    const int n_tiles = tiles_x * ((ny + TY - 1) / TY);
    const bool rhs = p.flags & MODE_RHS;
    const bool defect = p.flags & WITH_DEFECT;
    const float dt = p.dt[0];
    const float cT = rhs ? p.cT[0] : 0.0f, cW = rhs ? p.cW[0] : 0.0f;
    float CT_hi = 0.0f, CT_lo = 0.0f, CW_hi = 0.0f, CW_lo = 0.0f;
    if (HELM) {
        fpr::c_pair(cT, p.h2, CT_hi, CT_lo);
        fpr::c_pair(cW, p.h2, CW_hi, CW_lo);
    }
    const float inv2h = p.inv2h, inv_h = p.inv_h, inv_h2 = p.inv_h2;
    float tsq = 0.0f, wsq = 0.0f, rsq = 0.0f, vxa = 0.0f, vya = 0.0f, rwsq = 0.0f;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int x0 = t % tiles_x * fpr::TILE_X, y0 = t / tiles_x * TY;
        const int x = x0 + lane;
        const bool x_in = x < nx;

        // the thread's cells, loaded once, into registers and the plane;
        // then its halo cell, if it has one
        float4 v[S_MAX];
#pragma unroll
        for (int s = 0; s < S_MAX; ++s) {
            v[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (s >= S) continue;
            const int ry = w * S + s, y = y0 + ry;
            if (x_in && y < ny) v[s] = cell(p, defect, y, x);
            plane[(ry + 1) * PW + lane + 1] = v[s];
        }
        {
            int ry, rx;
            if (fpr::tile_halo(w, lane, TY, ry, rx)) {
                const int y = y0 + ry, xh = x0 + rx;
                plane[(ry + 1) * PW + rx + 1] = y >= 0 && y < ny && xh >= 0 && xh < nx
                                                    ? cell(p, defect, y, xh)
                                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
        }
        __syncthreads();

#pragma unroll
        for (int s = 0; s < S_MAX; ++s) {
            const int ry = w * S + s, y = y0 + ry, gy = p.row_off + y;
            if (s >= S || !x_in || y >= ny) continue;
            const int i = y * nx + x;
            const float Tc = v[s].x, Wc = v[s].y;
            const bool interior =
                x > 0 && y > 0 && x < nx - 1 && y < ny - 1 && gy > 0 && gy < p.ny_g - 1;
            const bool phys = gy >= 0 && gy < p.ny_g;
            const bool own = y >= p.own0 && y < p.own1;
            float4 U = make_float4(0.0f, 0.0f, 0.0f, 0.0f), D = U, L = U, R = U;
            float to, wo;
            float termT = 0.0f, termW = 0.0f;
            float vx = 0.0f, vy = 0.0f;
            if (interior) {
                // y neighbours from the registers, at the strip's ends from
                // the plane; x neighbours from the plane
                const float4* a = plane + (ry + 1) * PW + lane + 1;
                U = s == 0 ? a[-PW] : v[s > 0 ? s - 1 : 0];
                D = s + 1 < S ? v[s + 1 < S_MAX ? s + 1 : s] : a[PW];
                L = a[-1];
                R = a[1];
                vx = (D.z - U.z) * inv2h;
                vy = -(R.z - L.z) * inv2h;
                const float B = p.Ra * (R.x - L.x) * inv2h;
                float dT2 = 0.0f, dW2 = 0.0f;
                if (p.flags & USE_DIF) {
                    dT2 = p.k * ((U.x + D.x + L.x + R.x - 4.0f * Tc) * inv_h2);
                    dW2 = p.Pr * ((U.y + D.y + L.y + R.y - 4.0f * Wc) * inv_h2);
                }
                const float dTx = vx * (vx > 0.0f ? (Tc - L.x) * inv_h : (R.x - Tc) * inv_h);
                const float dTy = vy * (vy > 0.0f ? (Tc - U.x) * inv_h : (D.x - Tc) * inv_h);
                const float dWx = vx * (vx > 0.0f ? (Wc - L.y) * inv_h : (R.y - Wc) * inv_h);
                const float dWy = vy * (vy > 0.0f ? (Wc - U.y) * inv_h : (D.y - Wc) * inv_h);
                const float PrB = p.Pr * B;
                if (rhs) {
                    termT = p.wdif * dT2 - dTx - dTy;
                    termW = p.wdif * dW2 - dWx - dWy - PrB;
                } else {
                    termT = dT2 - dTx - dTy;
                    termW = dW2 - dWx - dWy - PrB;
                }
            }
            if (rhs) {
                to = -cT * (Tc + dt * termT);
                wo = -cW * (Wc + dt * termW);
            } else {
                to = interior ? Tc + dt * termT : Tc;
                wo = interior ? Wc + dt * termW : Wc;
            }
            if (!phys) to = wo = 0.0f;
            p.T_out[i] = to;
            p.W_out[i] = wo;
            if (own) {
                tsq += to * to;
                wsq += wo * wo;
            }

            if (defect) {
                float r = 0.0f;
                if (interior) {
                    float s1, e1, s2, e2, sh_, e3;
                    fpr::two_sum(U.z, D.z, s1, e1);
                    fpr::two_sum(L.z, R.z, s2, e2);
                    fpr::two_sum(s1, s2, sh_, e3);
                    const float sl_ = ((e1 + e2) + e3) + ((U.w + D.w) + (L.w + R.w));
                    float th, tl;
                    fpr::ds_add(sh_, sl_, -(v[s].z * 4.0f), -(v[s].w * 4.0f), th, tl);
                    th = th * inv_h2;  // exact: a power of two
                    tl = tl * inv_h2;
                    float rs, re;
                    fpr::two_sum(th, -wo, rs, re);
                    r = rs + (re + tl);
                    if (own) {
                        rsq += r * r;
                        vxa = fmaxf(vxa, fabsf(vx));
                        vya = fmaxf(vya, fabsf(vy));
                    }
                }
                p.r_out[i] = r;
            }

            if (HELM) {
                float rT = 0.0f, rW = 0.0f;
                if (interior) {
                    rT = helm_residual(Tc, U.x, D.x, L.x, R.x, CT_hi, CT_lo, inv_h2, to);
                    rW = helm_residual(Wc, U.y, D.y, L.y, R.y, CW_hi, CW_lo, inv_h2, wo);
                }
                p.r_out[i] = rT;
                p.rw_out[i] = rW;
                if (own) {
                    rsq += rT * rT;
                    rwsq += rW * rW;
                }
            }
        }
        __syncthreads();  // the plane is the next tile's
    }

    float q[NQ] = {tsq, wsq, rsq, vxa, vya, rwsq};
    if (fpr::finish_launch<NT, NQ>(q, MAXIMA, p.partials, p.counter, red, tid)) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) p.out[j] = q[j];
        // IEEE division and sqrt, as torch.sqrt(s / n)
        p.out[NQ] = __fsqrt_rn(__fdiv_rn(q[2], p.n_cells));
        p.out[NQ + 1] = __fsqrt_rn(__fdiv_rn(q[5], p.n_cells));
    }
}

int n_tiles(int ny, int nx, int S) {
    const int ty = fpr::TILE_WARPS * S;
    return ((nx + fpr::TILE_X - 1) / fpr::TILE_X) * ((ny + ty - 1) / ty);
}

}  // namespace

extern "C" {

// The card's SMs and the blocks of the NS kernel (helm: its Helmholtz-defect
// form) that one SM holds at once, for the wrapper's choice of S.
int fpr_ns_fill(int helm, int* sms, int* per_sm) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, helm ? ns_kernel<true> : ns_kernel<false>, NT, 0);
    }
    return static_cast<int>(err);
}

// One NS operator pass over (ny, nx) f32 planes with S (1 ..
// fpr::TILE_S_MAX) rows a thread, on `blocks` blocks (1 .. the tiles) that
// take the tiles in turn.  T, W: the planes of the stacked state; Sh (and Sl
// with the defect flag) the stream function; dt, cT, cW: device f32
// scalars (cT and cW in rhs mode only).  r_out: r with the defect flag, rT
// with the Helmholtz flag; rw_out: rW.  row_off, ny_g, own0, own1: the row
// hooks.  partials: 6 x blocks f32, scratch; counter: a device word that
// is 0 and used by no other launch in flight (0 again after this one);
// out: 8 f32, [sum T'^2, sum W'^2, sum r^2 (rT^2),
// max|dS/dy|, max|dS/dx|, sum rW^2, sqrt(out[2] / n_cells), sqrt(out[5] /
// n_cells)].  Bad arguments are refused with cudaErrorInvalidValue.  Returns
// the launch's cudaError_t.
int fpr_ns_fused(const float* T, const float* W, const float* Sh, const float* Sl,
                 const float* dt, const float* cT, const float* cW, float inv2h, float inv_h,
                 float inv_h2, float h2, float Pr, float Ra, float k, float wdif, float n_cells,
                 int ny, int nx, int flags, int S, int blocks, int row_off, int ny_g, int own0,
                 int own1, float* T_out, float* W_out, float* r_out, float* rw_out,
                 float* partials, unsigned* counter, float* out, cudaStream_t stream) {
    const bool rhs = flags & MODE_RHS, defect = flags & WITH_DEFECT, helm = flags & HELM_DEFECT;
    if (S < 1 || S > S_MAX || ny < 3 || nx < 3 || blocks < 1 || blocks > n_tiles(ny, nx, S) ||
        !T || !W || !Sh || !dt || (defect && (rhs || !Sl || !r_out)) ||
        (rhs && (!cT || !cW)) || (helm && (!rhs || defect || !r_out || !rw_out)) || !T_out ||
        !W_out || !partials || !counter || !out) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Params p{T, W, Sh, Sl, dt, cT, cW, inv2h, inv_h, inv_h2, h2, Pr, Ra, k, wdif,
                   n_cells, ny, nx, flags, S, row_off, ny_g, own0, own1, T_out, W_out, r_out,
                   rw_out, partials, counter, out};
    auto kernel = helm ? ns_kernel<true> : ns_kernel<false>;
    kernel<<<blocks, NT, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
