"""Matrix-free Krylov solvers for (nabla^2 - c) x = b
(fpr_tpu/solvers/krylov.py: cg, mg_preconditioned_cg, mg_pcg_ds).

- ``cg``: textbook conjugate gradient from x = 0, to ||r|| < tol ||b||
  (the reference's cg!, krylov.jl:55-91), with the matvec of
  ``stencil2d`` (policy JNP) or of the stencil-pass kernel #5 (PALLAS).
- ``mg_preconditioned_cg``: flexible (Polak-Ribiere) CG preconditioned by
  V-cycles from zero.
- ``mg_pcg_ds``: the same flexible PCG with the iterate in double-single,
  one float32 V-cycle as the preconditioner (``vcycle_stk``, or
  ``vcycle_rp`` outside the fused legs' configuration) and true-residual
  replacement: each step folds alpha p into the iterate and re-evaluates
  the residual in one ds defect pass (K1), so the exit tests the true
  defect, as ``mg_solve_ds`` does.  Its curvature p.Ap is the
  cancellation-free gradient form summed row by row (``dots="rowsum64"``),
  or the #5 kernel's ``matvec_dot_rp`` (``dots="kernel"``), which stalls
  on fine grids (the JAX docstring).

The JAX ``lax.while_loop``s are host loops: each test of the loop
condition reads one scalar from the device.  Arrays are physical (ny, nx).
"""

from __future__ import annotations

import torch

from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import stencil2d, stencil_pass


def _matvec_for(policy: ExecutionPolicy):
    return stencil_pass.matvec if policy is ExecutionPolicy.PALLAS else stencil2d.matvec


def _inf(like):
    return torch.full((), float("inf"), dtype=like.dtype, device=like.device)


def cg(b, hx, hy, c, tol, nmax: int, policy=ExecutionPolicy.JNP):
    """Solve (nabla^2 - c) x = b from x = 0 (krylov.cg).  Returns
    (x, r_rms, iterations)."""
    matvec = _matvec_for(policy)
    tolb = tol * torch.sqrt(torch.sum(b * b))
    x, r, p = torch.zeros_like(b), b, b
    rho = torch.sum(b * b)
    normr, i = _inf(b), 0
    while i < nmax and bool(normr >= tolb):
        Ap = matvec(p, hx, hy, c)
        alpha = rho / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rho_new = torch.sum(r * r)
        normr = torch.sqrt(rho_new)
        p = r + (rho_new / rho) * p
        rho = rho_new
        i += 1
    return x, torch.sqrt(torch.sum(r * r) / b.new_full((), b.numel())), i


def mg_preconditioned_cg(b, h, c, tol, nmax: int, mg_cfg: MGConfig = MGConfig(),
                         n_precond_cycles: int = 1):
    """Flexible PCG with z = M^-1 r from ``n_precond_cycles`` V-cycles from
    zero and the Polak-Ribiere beta z_new.(r_new - r_old) / z_old.r_old
    (krylov.mg_preconditioned_cg): injection restriction is not the
    adjoint of bilinear prolongation, so the V-cycle is not symmetric.
    Returns (x, r_rms, iterations)."""
    from fpr_tpu_torch.solvers.multigrid import vcycle

    matvec = _matvec_for(mg_cfg.policy)
    tolb = tol * torch.sqrt(torch.sum(b * b))

    def precond(r):
        z = torch.zeros_like(r)
        for _ in range(n_precond_cycles):
            z, _ = vcycle(z, r, h, c, tol, mg_cfg, apply_bcs=False)
        return z

    x, r = torch.zeros_like(b), b
    p = precond(b)
    rz = torch.sum(b * p)
    normr, i = _inf(b), 0
    while i < nmax and bool(normr >= tolb):
        Ap = matvec(p, h, h, c)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r_new = r - alpha * Ap
        normr = torch.sqrt(torch.sum(r_new * r_new))
        z_new = precond(r_new)
        rz_new = torch.sum(r_new * z_new)
        beta = torch.sum(z_new * (r_new - r)) / rz
        p = z_new + beta * p
        r, rz = r_new, rz_new
        i += 1
    return x, torch.sqrt(torch.sum(r * r) / b.new_full((), b.numel())), i


def _rowsum64(v: torch.Tensor) -> torch.Tensor:
    """Each row summed in float32, the row sums in float64, back to float32
    (krylov.py:245-249)."""
    return torch.sum(torch.sum(v, dim=1).to(torch.float64)).to(torch.float32)


def mg_pcg_ds(f, h: float, c, tol: float, niters: int, cfg: MGConfig = MGConfig(),
              return_pair: bool = False, dots: str = "rowsum64"):
    """Flexible CG on (nabla^2 - c) u = f with a double-single iterate, a
    float32 V-cycle preconditioner and true-residual replacement
    (krylov.mg_pcg_ds).  Zero initial guess.

    dots: "rowsum64" (the dots z.r summed row by row into float64, the
    curvature p.Ap in its gradient form) or "kernel" (flat float32 dots and
    the #5 kernel's ``matvec_dot_rp``).  The framework's residual is
    r = A u - f, the negated textbook one, so the update is u -= alpha p,
    the defect pass's u - scale e with scale = alpha.

    Returns (u, r_rms, iterations) in f's dtype, or ((hi, lo), r_rms,
    iterations) with return_pair.
    """
    from fpr_tpu_torch.solvers.multigrid import (_stk_eligible, _warn_unconverged, vcycle_rp,
                                                 vcycle_stk)

    if dots not in ("rowsum64", "kernel"):
        raise ValueError(f"dots must be 'rowsum64' or 'kernel', got {dots!r}")
    f32 = torch.float32
    ny, nx = f.shape
    f_ds = dsm.to_ds(f) if f.dtype == torch.float64 else f.to(f32)[None]
    f_rms = stencil2d.rms(f)
    tolf = (tol * f_rms).to(f32)
    stk = _stk_eligible(cfg)
    inv_h2 = f_ds.new_full((), 1.0 / (float(h) * float(h)))
    c_zero = not isinstance(c, torch.Tensor) and float(c) == 0.0
    C = dsm.defect_scalars(c, h, f.device)

    def precond(r):
        if stk:
            L = torch.empty((2, ny, nx), dtype=f32, device=f.device)
            L[1] = r
            L, _ = vcycle_stk(L, h, c, tol, cfg, assume_zero_u=True)
            return L[0]
        return vcycle_rp(None, r, h, c, tol, cfg, assume_zero_u=True)[0]

    def dot(a, b):
        return _rowsum64(a * b) if dots == "rowsum64" else torch.sum(a * b)

    def curvature(p):
        """p.Ap = -(sum (dx p)^2 + sum (dy p)^2)/h^2 - c sum p^2 for p zero
        on the boundary: only same-sign terms, no cancellation
        (krylov.py:252-277)."""
        ddx = p[:, 1:] - p[:, :-1]
        ddy = p[1:, :] - p[:-1, :]
        quad = (_rowsum64(ddx * ddx) + _rowsum64(ddy * ddy)) * inv_h2
        if c_zero:
            return -quad
        return -(quad + stencil2d.as_scalar(c, p) * _rowsum64(p * p))

    u_ds = torch.zeros((2, ny, nx), dtype=f32, device=f.device)
    # r_old = r0 makes the first beta exactly 0 with p = 0, so the first
    # direction is z; the initial rz_old is never consumed
    r = r_old = -f_ds[0]
    p = torch.zeros((ny, nx), dtype=f32, device=f.device)
    rz_old = f_ds.new_full((), 1.0)
    r_rms, it = f_rms.to(f32), 0
    while it < niters and bool(r_rms >= tolf):
        z = precond(r)
        s1, s2 = dot(z, r), dot(z, r_old)
        p = z + ((s1 - s2) / rz_old) * p
        pAp = curvature(p) if dots == "rowsum64" else stencil_pass.matvec_dot_rp(p, h, c)
        alpha = s1 / pAp
        u_ds, r_new, r_rms = dsm.defect_pass(u_ds, f_ds, p, alpha, h, c, C=C)
        r_old, r, rz_old = r, r_new, s1
        it += 1
    _warn_unconverged("mg_pcg_ds", r_rms, tolf, it, niters)
    if return_pair:
        return (u_ds[0], u_ds[1]), r_rms, it
    return u_ds[0].to(f.dtype) + u_ds[1].to(f.dtype), r_rms.to(f.dtype), it
