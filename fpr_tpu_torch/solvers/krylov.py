"""Matrix-free Krylov solvers for (nabla^2 - c) x = b
(fpr_tpu/solvers/krylov.py: cg, mg_preconditioned_cg, mg_pcg_ds,
mg_pcg_ds_jit).

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

Each loop is a ``core.loops.while_loop`` with JAX's carry: on CUDA one
launch of a cached CUDA graph a call, or a part of the caller's graph
(``cg_device``, the coarse solve of a V-cycle); the host reads the
iteration count once, at the end.  Arrays are physical (ny, nx).
"""

from __future__ import annotations

import torch

from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import stencil2d, stencil_pass
from fpr_tpu_torch.solvers.multigrid import (_c_arg, _c_key, _inf, _int0, _stk_eligible,
                                             _warn_unconverged, vcycle, vcycle_rp, vcycle_stk)


def _matvec_for(policy: ExecutionPolicy):
    return stencil_pass.matvec if policy is ExecutionPolicy.PALLAS else stencil2d.matvec


def cg(b, hx, hy, c, tol, nmax: int, policy=ExecutionPolicy.JNP):
    """Solve (nabla^2 - c) x = b from x = 0 (krylov.cg).  Returns
    (x, r_rms, iterations)."""
    x, r_rms, i = cg_device(b, hx, hy, c, tol, nmax, policy)
    return x, r_rms, int(i)


def cg_device(b, hx, hy, c, tol, nmax: int, policy=ExecutionPolicy.JNP):
    """``cg`` with the iteration count a 0-dim int32 tensor, no host read:
    the form a captured body calls."""
    matvec = _matvec_for(policy)

    def solve(a):
        b, cc = a["b"], c if a["c"] is None else a["c"]
        tolb = tol * torch.sqrt(torch.sum(b * b))

        def cond(s):
            return (s["i"] < nmax) & (s["normr"] >= tolb)

        def body(s):
            p, rho = s["p"], s["rho"]
            Ap = matvec(p, hx, hy, cc)
            alpha = rho / torch.sum(p * Ap)
            x = s["x"] + alpha * p
            r = s["r"] - alpha * Ap
            rho_new = torch.sum(r * r)
            normr = torch.sqrt(rho_new)
            p = r + (rho_new / rho) * p
            return dict(x=x, r=r, p=p, rho=rho_new, normr=normr, i=s["i"] + 1)

        s = loops.while_loop(cond, body, dict(x=torch.zeros_like(b), r=b, p=b,
                                              rho=torch.sum(b * b), normr=_inf(b), i=_int0(b)))
        r = s["r"]
        return s["x"], torch.sqrt(torch.sum(r * r) / b.new_full((), b.numel())), s["i"]

    return loops.device_call(solve, dict(b=b, c=_c_arg(c)),
                             key=("cg", float(hx), float(hy), _c_key(c), float(tol), nmax, policy))


def mg_preconditioned_cg(b, h, c, tol, nmax: int, mg_cfg: MGConfig = MGConfig(),
                         n_precond_cycles: int = 1):
    """Flexible PCG with z = M^-1 r from ``n_precond_cycles`` V-cycles from
    zero and the Polak-Ribiere beta z_new.(r_new - r_old) / z_old.r_old
    (krylov.mg_preconditioned_cg): injection restriction is not the
    adjoint of bilinear prolongation, so the V-cycle is not symmetric.
    Returns (x, r_rms, iterations)."""
    matvec = _matvec_for(mg_cfg.policy)

    def solve(a):
        b, cc = a["b"], c if a["c"] is None else a["c"]
        tolb = tol * torch.sqrt(torch.sum(b * b))

        def precond(r):
            z = torch.zeros_like(r)
            for _ in range(n_precond_cycles):
                z, _ = vcycle(z, r, h, cc, tol, mg_cfg, apply_bcs=False)
            return z

        def cond(s):
            return (s["i"] < nmax) & (s["normr"] >= tolb)

        def body(s):
            p, r, rz = s["p"], s["r"], s["rz"]
            Ap = matvec(p, h, h, cc)
            alpha = rz / torch.sum(p * Ap)
            x = s["x"] + alpha * p
            r_new = r - alpha * Ap
            normr = torch.sqrt(torch.sum(r_new * r_new))
            z_new = precond(r_new)
            rz_new = torch.sum(r_new * z_new)
            beta = torch.sum(z_new * (r_new - r)) / rz
            p = z_new + beta * p
            return dict(x=x, r=r_new, p=p, rz=rz_new, normr=normr, i=s["i"] + 1)

        p = precond(b)
        s = loops.while_loop(cond, body, dict(x=torch.zeros_like(b), r=b, p=p,
                                              rz=torch.sum(b * p), normr=_inf(b), i=_int0(b)))
        r = s["r"]
        return s["x"], torch.sqrt(torch.sum(r * r) / b.new_full((), b.numel())), s["i"]

    x, r_rms, i = loops.device_call(
        solve, dict(b=b, c=_c_arg(c)),
        key=("mg_preconditioned_cg", float(h), _c_key(c), float(tol), nmax, mg_cfg,
             n_precond_cycles))
    return x, r_rms, int(i)


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
    if dots not in ("rowsum64", "kernel"):
        raise ValueError(f"dots must be 'rowsum64' or 'kernel', got {dots!r}")

    def solve(a):
        s, step = _pcg_ds_start(a, h, c, tol, cfg, dots)
        s = loops.while_loop(lambda s: _pcg_ds_cond(s, a, niters), lambda s: step(s)[0], s)
        return s["u"], s["r_rms"], s["it"]

    args = _pcg_ds_args(f, c, tol)
    u_ds, r_rms, it = loops.device_call(
        solve, args,
        key=("mg_pcg_ds", float(h), _c_key(c), float(tol), niters, cfg, dots))
    it = int(it)  # the host's one read
    _warn_unconverged("mg_pcg_ds", r_rms, args["tolf"], it, niters)
    if return_pair:
        return (u_ds[0], u_ds[1]), r_rms, it
    return u_ds[0].to(f.dtype) + u_ds[1].to(f.dtype), r_rms.to(f.dtype), it


def _pcg_ds_args(f, c, tol: float) -> dict:
    """mg_pcg_ds's device arguments: f as a ds stack (one plane for a
    float32 f), tol rms(f) and rms(f) in float32, and c."""
    f32 = torch.float32
    f_rms = stencil2d.rms(f)
    return dict(f=dsm.to_ds(f) if f.dtype == torch.float64 else f.to(f32)[None],
                tolf=(tol * f_rms).to(f32), f_rms=f_rms.to(f32), c=_c_arg(c))


def _pcg_ds_cond(s, a, niters: int):
    return (s["it"] < niters) & (s["r_rms"] >= a["tolf"])


def _pcg_ds_start(a, h: float, c, tol: float, cfg: MGConfig, dots: str):
    """(the first carry, step) of mg_pcg_ds on its device arguments a;
    step(carry) -> (the next carry, dict(z, s1, s2, beta, pAp, alpha)): one
    iteration, with the values a reference inspects."""
    f32 = torch.float32
    f_ds = a["f"]
    _, ny, nx = f_ds.shape
    cc = c if a["c"] is None else a["c"]
    stk = _stk_eligible(cfg)
    c_zero = not isinstance(c, torch.Tensor) and float(c) == 0.0
    inv_h2 = f_ds.new_full((), 1.0 / (float(h) * float(h)))
    C = dsm.defect_scalars(cc, h, f_ds.device)

    def dot(a, b):
        return _rowsum64(a * b) if dots == "rowsum64" else torch.sum(a * b)

    def precond(r):
        if stk:
            L = torch.empty((2, ny, nx), dtype=f32, device=r.device)
            L[1] = r
            L, _ = vcycle_stk(L, h, cc, tol, cfg, assume_zero_u=True)
            return L[0]
        return vcycle_rp(None, r, h, cc, tol, cfg, assume_zero_u=True)[0]

    def curvature(p):
        """p.Ap = -(sum (dx p)^2 + sum (dy p)^2)/h^2 - c sum p^2 for p zero
        on the boundary: only same-sign terms, no cancellation
        (krylov.py:252-277).  Each difference is squared in place and summed
        before the next is formed: one field of temporaries."""
        ddx = p[:, 1:] - p[:, :-1]
        qx = _rowsum64(ddx.mul_(ddx))
        del ddx
        ddy = p[1:, :] - p[:-1, :]
        quad = (qx + _rowsum64(ddy.mul_(ddy))) * inv_h2
        del ddy
        if c_zero:
            return -quad
        return -(quad + stencil2d.as_scalar(cc, p) * _rowsum64(p * p))

    def step(s):
        r = s["r"]
        z = precond(r)
        s1, s2 = dot(z, r), dot(z, s["r_old"])
        beta = (s1 - s2) / s["rz_old"]
        p = z + beta * s["p"]
        pAp = curvature(p) if dots == "rowsum64" else stencil_pass.matvec_dot_rp(p, h, cc)
        alpha = s1 / pAp
        u_ds, r_new, r_rms = dsm.defect_pass(s["u"], f_ds, p, alpha, h, cc, C=C)
        return (dict(u=u_ds, r=r_new, r_old=r, p=p, rz_old=s1, r_rms=r_rms, it=s["it"] + 1),
                dict(z=z, s1=s1, s2=s2, beta=beta, pAp=pAp, alpha=alpha))

    # r_old = r0 makes the first beta exactly 0 with p = 0, so the first
    # direction is z; the initial rz_old is never consumed
    r0 = -f_ds[0]
    s = dict(u=torch.zeros((2, ny, nx), dtype=f32, device=f_ds.device), r=r0, r_old=r0,
             p=torch.zeros((ny, nx), dtype=f32, device=f_ds.device),
             rz_old=f_ds.new_full((), 1.0), r_rms=a["f_rms"], it=_int0(f_ds))
    return s, step


def _mg_pcg_ds_history(f, h: float, c, tol: float, niters: int, cfg: MGConfig = MGConfig(),
                       dots: str = "rowsum64"):
    """mg_pcg_ds's iterations one at a time, outside any graph, with the
    loop's test read on the host: yields (carry, dict(z, s1, s2, beta, pAp,
    alpha)) after each, for a reference that inspects every iteration (the
    tests, ``chip_smoke.py``).  The same step as the solve's, so under
    ``loops.host_loops()`` its carries are the host loop's."""
    a = _pcg_ds_args(f, c, tol)
    s, step = _pcg_ds_start(a, h, c, tol, cfg, dots)
    while bool(_pcg_ds_cond(s, a, niters)):
        s, d = step(s)
        yield s, d


# JAX's benchmark entry point (krylov.mg_pcg_ds_jit): mg_pcg_ds, which
# starts from zero and is one launch of its cached CUDA graph
mg_pcg_ds_jit = mg_pcg_ds
