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
// -c times them (rhs).  Per-block partials of sum(T'^2) and sum(W'^2); with
// the defect flag (explicit only) also the next stream-function solve's
// initial ds defect r = A S - W' (S a hi/lo pair, c = 0; formula for
// formula ds.py's defect with scale 0), sum(r^2), and max |dS/dy|,
// max |dS/dx| of S over the interior.  With the Helmholtz flag (rhs only,
// pallas_ns.py:82-88, 266-296) the two Helmholtz solves' warm-start
// defects rT = A_cT (BC(T), 0) - T' and rW = A_cW (W, 0) - W' in ds
// arithmetic, formula for formula K1's with a zero lo plane, the C pairs
// against ds_mul_ds and an exactly-f32 rhs, and sum(rT^2), sum(rW^2).  dt,
// cT and cW, and the C = 4 + c h^2 pairs of cT and cW, are read from device
// memory.  No solver path launches the Helmholtz flag, as in the JAX
// package (pallas_ns.py:455-459, measured slower than two defect passes).
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
// Bound on the H100: memory bandwidth.  A cell reads T, W, S (and S lo) and
// writes T', W' (and r, or rT and rW): 5-7 f32 words against about 80 flops
// (about 200 with the Helmholtz defects).
//
// Design: one thread per cell.  Each thread applies the T BCs to the five
// T values it reads, so the stencils see BC'd neighbours as on the TPU,
// where the BCs cover the whole halo window.  Left for later: a
// shared-memory tile so the 5-point reads of T, W and S are loaded once.
#include "fpr_common.cuh"

namespace {

enum : int { MODE_RHS = 1, WITH_DEFECT = 2, USE_DIF = 4, HELM_DEFECT = 8 };

// BC'd temperature at local (y, x), global row gy: Dirichlet rows, then the
// Neumann copies of the Dirichlet'd field.
__device__ __forceinline__ float t_bc(const float* __restrict__ T, int ny_g, int nx,
                                      int y, int gy, int x) {
    if (gy == 0) return 1.0f;
    if (gy == ny_g - 1) return 0.0f;
    if (x == 0) x = 1;
    else if (x == nx - 1) x = nx - 2;
    return T[y * nx + x];
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
__global__ void __launch_bounds__(FPR_THREADS)
ns_kernel(const float* __restrict__ T, const float* __restrict__ W,
          const float* __restrict__ Sh, const float* __restrict__ Sl,
          const float* __restrict__ scal, const float* __restrict__ cpairs, float inv2h,
          float inv_h, float inv_h2, float Pr, float Ra, float k, float wdif, int ny, int nx,
          int flags, int row_off, int ny_g, int own0, int own1, float* __restrict__ T_out,
          float* __restrict__ W_out, float* __restrict__ r_out, float* __restrict__ rw_out,
          float* __restrict__ partials) {
    __shared__ float sh[FPR_BY];
    const int x = blockIdx.x * FPR_BX + threadIdx.x;
    const int y = blockIdx.y * FPR_BY + threadIdx.y;
    const int gy = row_off + y;
    const bool rhs = flags & MODE_RHS;
    const bool defect = flags & WITH_DEFECT;
    const bool helm = HELM;
    const bool own = y >= own0 && y < own1;
    float tsq = 0.0f, wsq = 0.0f, rsq = 0.0f, vxa = 0.0f, vya = 0.0f, rwsq = 0.0f;

    if (x < nx && y < ny) {
        const int i = y * nx + x;
        const float dt = scal[0];
        const float Tc = t_bc(T, ny_g, nx, y, gy, x);
        const float Wc = W[i];
        const bool interior =
            x > 0 && y > 0 && x < nx - 1 && y < ny - 1 && gy > 0 && gy < ny_g - 1;
        const bool phys = gy >= 0 && gy < ny_g;
        float to, wo;
        float termT = 0.0f, termW = 0.0f;
        float vx = 0.0f, vy = 0.0f;
        float Tu = 0.0f, Td = 0.0f, Tl = 0.0f, Tr = 0.0f;
        float Wu = 0.0f, Wd = 0.0f, Wl = 0.0f, Wr = 0.0f;
        if (interior) {
            Tu = t_bc(T, ny_g, nx, y - 1, gy - 1, x);
            Td = t_bc(T, ny_g, nx, y + 1, gy + 1, x);
            Tl = t_bc(T, ny_g, nx, y, gy, x - 1);
            Tr = t_bc(T, ny_g, nx, y, gy, x + 1);
            Wu = W[i - nx], Wd = W[i + nx], Wl = W[i - 1], Wr = W[i + 1];
            const float Su = Sh[i - nx], Sd = Sh[i + nx], Sl_ = Sh[i - 1], Sr = Sh[i + 1];
            vx = (Sd - Su) * inv2h;
            vy = -(Sr - Sl_) * inv2h;
            const float B = Ra * (Tr - Tl) * inv2h;
            float dT2 = 0.0f, dW2 = 0.0f;
            if (flags & USE_DIF) {
                dT2 = k * ((Tu + Td + Tl + Tr - 4.0f * Tc) * inv_h2);
                dW2 = Pr * ((Wu + Wd + Wl + Wr - 4.0f * Wc) * inv_h2);
            }
            const float dTx = vx * (vx > 0.0f ? (Tc - Tl) * inv_h : (Tr - Tc) * inv_h);
            const float dTy = vy * (vy > 0.0f ? (Tc - Tu) * inv_h : (Td - Tc) * inv_h);
            const float dWx = vx * (vx > 0.0f ? (Wc - Wl) * inv_h : (Wr - Wc) * inv_h);
            const float dWy = vy * (vy > 0.0f ? (Wc - Wu) * inv_h : (Wd - Wc) * inv_h);
            const float PrB = Pr * B;
            if (rhs) {
                termT = wdif * dT2 - dTx - dTy;
                termW = wdif * dW2 - dWx - dWy - PrB;
            } else {
                termT = dT2 - dTx - dTy;
                termW = dW2 - dWx - dWy - PrB;
            }
        }
        if (rhs) {
            to = -scal[1] * (Tc + dt * termT);
            wo = -scal[2] * (Wc + dt * termW);
        } else {
            to = interior ? Tc + dt * termT : Tc;
            wo = interior ? Wc + dt * termW : Wc;
        }
        if (!phys) to = wo = 0.0f;
        T_out[i] = to;
        W_out[i] = wo;
        if (own) {
            tsq = to * to;
            wsq = wo * wo;
        }

        if (defect) {
            float r = 0.0f;
            if (interior) {
                float s1, e1, s2, e2, sh_, e3;
                fpr::two_sum(Sh[i - nx], Sh[i + nx], s1, e1);
                fpr::two_sum(Sh[i - 1], Sh[i + 1], s2, e2);
                fpr::two_sum(s1, s2, sh_, e3);
                const float sl_ = ((e1 + e2) + e3) +
                                  ((Sl[i - nx] + Sl[i + nx]) + (Sl[i - 1] + Sl[i + 1]));
                float th, tl;
                fpr::ds_add(sh_, sl_, -(Sh[i] * 4.0f), -(Sl[i] * 4.0f), th, tl);
                th = th * inv_h2;  // exact: a power of two
                tl = tl * inv_h2;
                float rs, re;
                fpr::two_sum(th, -wo, rs, re);
                r = rs + (re + tl);
                if (own) {
                    rsq = r * r;
                    vxa = fabsf(vx);
                    vya = fabsf(vy);
                }
            }
            r_out[i] = r;
        }

        if (helm) {
            float rT = 0.0f, rW = 0.0f;
            if (interior) {
                rT = helm_residual(Tc, Tu, Td, Tl, Tr, cpairs[0], cpairs[1], inv_h2, to);
                rW = helm_residual(Wc, Wu, Wd, Wl, Wr, cpairs[2], cpairs[3], inv_h2, wo);
            }
            r_out[i] = rT;
            rw_out[i] = rW;
            if (own) {
                rsq = rT * rT;
                rwsq = rW * rW;
            }
        }
    }

    const int nb = fpr::num_blocks(), b = fpr::block_id();
    tsq = fpr::block_sum(tsq, sh);
    if (fpr::block_leader()) partials[b] = tsq;
    wsq = fpr::block_sum(wsq, sh);
    if (fpr::block_leader()) partials[nb + b] = wsq;
    if (defect) {
        rsq = fpr::block_sum(rsq, sh);
        if (fpr::block_leader()) partials[2 * nb + b] = rsq;
        vxa = fpr::block_max(vxa, sh);
        if (fpr::block_leader()) partials[3 * nb + b] = vxa;
        vya = fpr::block_max(vya, sh);
        if (fpr::block_leader()) partials[4 * nb + b] = vya;
    }
    if (helm) {
        rsq = fpr::block_sum(rsq, sh);
        if (fpr::block_leader()) partials[2 * nb + b] = rsq;
        rwsq = fpr::block_sum(rwsq, sh);
        if (fpr::block_leader()) partials[3 * nb + b] = rwsq;
    }
}

}  // namespace

extern "C" {

// T, W: (ny, nx) planes of the stacked state; Sh (and Sl with the defect
// flag) the stream function; scal: device f32 [dt, cT, cW]; cpairs: with the
// Helmholtz flag device f32 [CT_hi, CT_lo, CW_hi, CW_lo], else unused.
// r_out: r with the defect flag, rT with the Helmholtz flag; rw_out: rW.
// partials: (5, fpr_num_blocks) f32.  row_off, ny_g, own0, own1: the row
// hooks.  Returns the launch's cudaError_t.
int fpr_ns_fused(const float* T, const float* W, const float* Sh, const float* Sl,
                 const float* scal, const float* cpairs, float inv2h, float inv_h,
                 float inv_h2, float Pr, float Ra, float k, float wdif, int ny, int nx,
                 int flags, int row_off, int ny_g, int own0, int own1, float* T_out,
                 float* W_out, float* r_out, float* rw_out, float* partials,
                 cudaStream_t stream) {
    auto kernel = (flags & HELM_DEFECT) ? ns_kernel<true> : ns_kernel<false>;
    kernel<<<fpr::grid_of(ny, nx), dim3(FPR_BX, FPR_BY), 0, stream>>>(
        T, W, Sh, Sl, scal, cpairs, inv2h, inv_h, inv_h2, Pr, Ra, k, wdif, ny, nx, flags,
        row_off, ny_g, own0, own1, T_out, W_out, r_out, rw_out, partials);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
