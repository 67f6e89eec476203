"""Geometric multigrid for (nabla^2 - c) u = f on 2^k+1 grids, and the
defect-correction solvers around it (fpr_tpu/solvers/multigrid.py:
_warn_unconverged, _smooth_fns, _coarse_solve, vcycle, mg_solve,
PALLAS_MIN_AREA, vcycle_rp, _stk_eligible, vcycle_stk, mg_solve_rp,
mg_solve_mixed, _auto_inner_cycles, _fmg_guess, mg_solve_ds_rp,
mg_solve_ds, and the jitted entry points mg_solve_jit, mg_solve_mixed_jit
and mg_solve_ds_jit, which are the same calls here).

- ``vcycle`` / ``mg_solve``: the reference-semantics V-cycle and its
  iterate loop (damped Jacobi or red-black GS, injection or full
  weighting, bilinear prolongation, Jacobi, CG or DST coarse solve), in
  plain PyTorch (policy JNP) or with the smoother and residual of the
  stencil-pass kernel #5 at every level (policy PALLAS, float32 or
  float64).
- ``vcycle_rp``: the V-cycle whose levels of at least ``PALLAS_MIN_AREA``
  cells run the legs #6 ``smooth2r_split`` and #7 ``corr_smooth2`` (or,
  outside their configuration, sweeps of #5), handing the smaller levels
  to ``vcycle`` with policy JNP.  ``mg_solve_rp`` iterates it;
  ``mg_solve_mixed`` runs it in float32 on the normalised float64 defect.
- ``vcycle_stk``: the V-cycle on the stacked level state, with the fused
  legs K2 ``smooth_down`` and K3 ``corr_up``.
- ``mg_solve_ds_rp`` / ``mg_solve_ds``: u and f as hi/lo float32 pairs;
  each outer iteration is V-cycles on the float32 defect (``vcycle_stk``,
  or ``vcycle_rp`` outside the fused legs' configuration), then one ds
  defect pass (K1), which also gives the true defect norm.  ``fmg``: a
  full-multigrid initial guess of the first correction (``_fmg_guess``)
  before the loop.

Every outer loop (``mg_solve``, ``mg_solve_rp``, ``mg_solve_mixed``,
``mg_solve_ds_rp``) and the coarse Jacobi and CG solves are
``core.loops.while_loop``s inside a ``core.loops.device_call``, as the JAX
package's ``lax.while_loop``s: on CUDA one CUDA graph a solve (or a part of
the caller's graph), the host reading nothing until the public entry point
reads (r_rms, tolf, outer count) once at its end, for the count it returns
and the non-convergence warning.  The level state of the
stacked V-cycle is a (2, ny, nx) tensor L = [u | f]: the up leg writes the
new iterate into L[0] and the defect pass writes the new rhs into L[1], in
both cases from buffers the kernel does not write, so no kernel reads what
it writes.  Arrays are physical (ny, nx): the ``_rp`` solvers keep the
JAX names but take no row-padded layout.  The correction cycles of the
defect-correction solvers smooth with eliminated BCs exactly when
apply_bcs is set (the JAX ``_ELIM_BC_SMOOTH`` default).  The fused DST
correction is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpr_tpu_torch.core import bc, loops
from fpr_tpu_torch.core.config import (CoarseSolver, ExecutionPolicy, MGConfig, Restriction,
                                       Smoother)
from fpr_tpu_torch.core.grid import mg_levels
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import stencil2d, stencil_pass, transfer
from fpr_tpu_torch.ops.vcycle_legs import corr_smooth2, corr_up, smooth2r_split, smooth_down
from fpr_tpu_torch.solvers.dst import dst_solve

# levels with fewer cells run the plain-PyTorch V-cycle; the same cut as
# the JAX package (multigrid.py:285), so the ladders and the outer counts
# match it
PALLAS_MIN_AREA = 1024 * 1024


def _warn_unconverged(solver: str, r_rms, tolf, it: int, niters: int,
                      apply_bcs: bool = False) -> None:
    """Print a warning when an outer loop stopped at niters above tolerance
    (multigrid._warn_unconverged, its text; the reference's "Couldn't
    converge", multigrid.jl:78-80).  r_rms, tolf: host numbers (a solve's
    ``_outcome``) or tensors, read only when it reached niters."""
    if it < niters:
        return
    r, t = float(r_rms), float(tolf)
    if not r >= t:
        return
    hint = (" (known cold-BC stagnation: the jnp-tier iterate cycle smooths "
            "the Neumann side columns as Dirichlet-0 — reference-parity "
            "behavior; the ds/rp correction cycles avoid it via eliminated-BC "
            "smoothing (_ELIM_BC_SMOOTH), see mg_solve_ds_rp's docstring)" if apply_bcs else "")
    # JAX prints the two as float32
    print(f"WARNING: {solver} exited at niters={niters} with r_rms {float(np.float32(r)):.3e} "
          f">= tol*rms(f) {float(np.float32(t)):.3e} — NOT converged{hint}")


def _outcome(out: dict):
    """(r_rms, tolf, outer count) of a solve's device results on the host,
    in one transfer: the solve's one host read."""
    r, t, it = torch.stack([out["r_rms"].double(), out["tolf"].double(),
                            out["it"].double()]).tolist()
    return r, t, int(it)


def _smooth_fns(cfg: MGConfig):
    """(smoother, residual) of the configured policy and smoother
    (multigrid._smooth_fns): PALLAS takes the stencil-pass kernel, JNP plain
    PyTorch; red-black GS is plain PyTorch under both."""
    if cfg.policy is ExecutionPolicy.PALLAS:
        residual, jacobi = stencil_pass.residual, stencil_pass.jacobi_step
    else:
        residual, jacobi = stencil2d.residual, stencil2d.jacobi_step

    if cfg.smoother is Smoother.RED_BLACK_GS:
        def smooth(u, f, h, c, with_norm):
            return stencil2d.red_black_gs_step(u, f, h, c, with_norm=with_norm)
    else:
        def smooth(u, f, h, c, with_norm):
            return jacobi(u, f, h, c, alpha=cfg.jacobi_damping, with_norm=with_norm)

    return smooth, residual


def _smoother(cfg: MGConfig, elim: bool):
    """The smoother of ``_smooth_fns``; elim: the side columns become copies
    of their interior neighbours after every sweep."""
    smooth0, _ = _smooth_fns(cfg)
    if not elim:
        return smooth0

    def smooth(u, f, h, c, with_norm):
        u, r = smooth0(u, f, h, c, with_norm)
        u = u.clone()
        u[:, 0] = u[:, 1]
        u[:, -1] = u[:, -2]
        return u, r

    return smooth


def _c_key(c):
    """What a cached graph bakes in of c: its value, or that it is a tensor
    (then an input of the graph)."""
    return "tensor" if isinstance(c, torch.Tensor) else float(c)


def _c_arg(c):
    return c if isinstance(c, torch.Tensor) else None


def _coarse_solve(u, f, h, c, tol, cfg: MGConfig, elim=False):
    """The coarse solve (multigrid._coarse_solve): DST; CG from zero (the
    incoming iterate is discarded, as the reference's cg! overwrites it);
    or at most 20*coarse_size smooths until the residual rms drops below
    tol*rms(f), a ``while_loop``."""
    max_iters = 20 * cfg.coarse_size
    if cfg.coarse_solver is CoarseSolver.DST:
        return dst_solve(u, f, h, c)
    if cfg.coarse_solver is CoarseSolver.CG:
        from fpr_tpu_torch.solvers.krylov import cg_device

        x, r_rms, _ = cg_device(f, h, h, c, tol, max_iters, policy=cfg.policy)
        return x, r_rms
    smooth = _smoother(cfg, elim)

    def solve(a):
        f, cc = a["f"], c if a["c"] is None else a["c"]
        tol_rhs = tol * stencil2d.rms(f)

        def cond(s):
            return (s[2] < max_iters) & (s[1] >= tol_rhs)

        def body(s):
            u, r_rms = smooth(s[0], f, h, cc, True)
            return u, r_rms, s[2] + 1

        u, r_rms, _ = loops.while_loop(cond, body, (a["u"], _inf(a["u"]), _int0(f)))
        return u, r_rms

    return loops.device_call(solve, dict(u=u, f=f, c=_c_arg(c)),
                             key=("coarse_jacobi", cfg, float(h), _c_key(c), float(tol), elim))


def _inf(like):
    return torch.full((), float("inf"), dtype=like.dtype, device=like.device)


def _int0(like):
    """A 0-dim int32 zero on like's device: a loop counter, as in JAX."""
    return torch.zeros((), dtype=torch.int32, device=like.device)


def vcycle(u, f, h, c, tol, cfg: MGConfig, apply_bcs=False, elim=False):
    """One V-cycle; returns (u, rms of the residual fed to the last fine
    post-smooth) (multigrid.vcycle).  elim: the side columns become copies
    of their interior neighbours after every sweep (set only by the
    correction cycles' small-level subtree)."""
    smooth, residual = _smoother(cfg, elim), _smooth_fns(cfg)[1]
    ny, nx = u.shape
    mg_levels(nx, ny, cfg.coarse_size)  # validates the 2^k+1 sides
    restrict = (transfer.restrict_full_weighting
                if cfg.resolved_restriction() is Restriction.FULL_WEIGHTING
                else transfer.restrict)

    def descend(u, f, h, top):
        nyl, nxl = u.shape
        if min(nxl, nyl) <= cfg.coarse_size:
            return _coarse_solve(u, f, h, c, tol, cfg, elim)
        for _ in range(cfg.pre_smooth):
            u, _ = smooth(u, f, h, c, False)
        res_c = restrict(residual(u, f, h, c), apply_bcs=apply_bcs)
        corr_c, _ = descend(torch.zeros_like(res_c), res_c, h * 2.0, False)
        u = u - transfer.prolongate(corr_c, u.shape, apply_bcs=apply_bcs)
        r_rms = None
        for s in range(cfg.post_smooth):
            want = top and s == cfg.post_smooth - 1
            u, r = smooth(u, f, h, c, want)
            if want:
                r_rms = r
        return u, r_rms

    return descend(u, f, h, True)


def _outer(step, u0, f, c, tol: float, niters: int, key):
    """The outer loop of ``mg_solve``, ``mg_solve_rp`` and ``mg_solve_mixed``
    as one device call: JAX's while_loop over (u, r_rms, it), r_rms from
    inf in u's dtype and it an int32 counter, step(u, f, c) -> (u, r_rms)
    while it < niters and r_rms >= tolf = tol rms(f).  key: what step bakes
    in.  Returns the device results dict(u, r_rms, it, tolf); no host read."""

    def solve(a):
        f, cc = a["f"], c if a["c"] is None else a["c"]
        tolf = tol * stencil2d.rms(f)

        def cond(s):
            return (s[2] < niters) & (s[1] >= tolf)

        def body(s):
            u, r_rms = step(s[0], f, cc)
            return u, r_rms, s[2] + 1

        u, r_rms, it = loops.while_loop(cond, body, (a["u"], _inf(a["u"]), _int0(f)))
        return dict(u=u, r_rms=r_rms, it=it, tolf=tolf)

    return loops.device_call(solve, dict(u=u0, f=f, c=_c_arg(c)), key=key)


def _mg_solve(u0, f, h: float, c, tol: float, niters: int, apply_bcs=False,
              cfg: MGConfig = MGConfig()):
    """mg_solve's device results (``_outer``), for a caller that reads them
    itself."""

    def step(u, f, c):
        if apply_bcs:
            u = bc.ns_temperature_bcs(u)
        return vcycle(u, f, h, c, tol, cfg, apply_bcs=apply_bcs)

    return _outer(step, u0, f, c, tol, niters,
                  key=("mg_solve", cfg, float(h), _c_key(c), float(tol), niters, apply_bcs))


def mg_solve(u0, f, h: float, c, tol: float, niters: int, apply_bcs=False,
             cfg: MGConfig = MGConfig()):
    """V-cycles until r_rms < tol * rms(f) (multigrid.mg_solve); with
    apply_bcs the NS temperature BCs are applied to u before every cycle.
    Returns (u, r_rms, iterations)."""
    out = _mg_solve(u0, f, h, c, tol, niters, apply_bcs, cfg)
    r, t, it = _outcome(out)
    _warn_unconverged("mg_solve", r, t, it, niters, apply_bcs)
    return out["u"], out["r_rms"], it


# JAX's jitted mg_solve (multigrid.mg_solve_jit): mg_solve is already one
# launch of its cached CUDA graph
mg_solve_jit = mg_solve


def vcycle_rp(u, f, h, c, tol, cfg: MGConfig, apply_bcs=False, assume_zero_u=False,
              elim=False):
    """One V-cycle with the fused legs at large levels (multigrid.vcycle_rp).

    Levels of at least PALLAS_MIN_AREA cells run #6 ``smooth2r_split`` and
    #7 ``corr_smooth2`` (with injection and 1-6 smooths), or else sweeps of
    #5 ``stencil_pass.smooth_rp`` around ``residual_rp``; smaller levels,
    a level at the coarse size, and a smoother other than Jacobi go to
    ``vcycle`` with policy JNP.  assume_zero_u: the iterate is zero and
    u is never read (it may be None).  elim: eliminated-BC smoothing on the
    fused legs and the subtree (correction cycles only).
    Returns (u', r_rms of the final fine-level smooth).
    """
    ny, nx = f.shape
    if (cfg.smoother is not Smoother.JACOBI or ny * nx < PALLAS_MIN_AREA
            or min(ny, nx) <= cfg.coarse_size):
        sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
        u0 = torch.zeros_like(f) if assume_zero_u else u
        return vcycle(u0, f, h, c, tol, sub_cfg, apply_bcs=apply_bcs, elim=elim)

    alpha = cfg.jacobi_damping
    injection = cfg.resolved_restriction() is not Restriction.FULL_WEIGHTING
    if injection and 1 <= cfg.pre_smooth <= 6:
        u, res = smooth2r_split(u, f, h, c, alpha, zero_u=assume_zero_u, ns=cfg.pre_smooth,
                                elim=elim)
        res_c = transfer.restrict(res, apply_bcs=apply_bcs)
    else:
        if assume_zero_u:
            u = torch.zeros_like(f)
        for _ in range(cfg.pre_smooth):
            u, _ = stencil_pass.smooth_rp(u, f, h, c, alpha, with_norm=False)
        res = stencil_pass.residual_rp(u, f, h, c)
        restrict = transfer.restrict if injection else transfer.restrict_full_weighting
        res_c = restrict(res, apply_bcs=apply_bcs)

    corr, _ = vcycle_rp(None, res_c, h * 2.0, c, tol, cfg, apply_bcs=apply_bcs,
                        assume_zero_u=True, elim=elim)

    if 1 <= cfg.post_smooth <= 6:
        return corr_smooth2(u, f, corr, h, c, alpha, apply_bcs=apply_bcs, with_norm=True,
                            ns=cfg.post_smooth, elim=elim)
    u = u - transfer.prolongate(corr, (ny, nx), apply_bcs=apply_bcs)
    r_rms = None
    for s in range(cfg.post_smooth):
        want = s == cfg.post_smooth - 1
        u, r = stencil_pass.smooth_rp(u, f, h, c, alpha, with_norm=want)
        if want:
            r_rms = r
    return u, r_rms


def _stk_eligible(cfg: MGConfig) -> bool:
    """The fused legs of the stacked V-cycle take the Jacobi smoother, 1-6
    pre- and post-smooths and injection (multigrid._stk_eligible)."""
    return (cfg.smoother is Smoother.JACOBI and 1 <= cfg.pre_smooth <= 6
            and 1 <= cfg.post_smooth <= 6
            and cfg.resolved_restriction() is not Restriction.FULL_WEIGHTING)


def vcycle_stk(L, h, c, tol, cfg: MGConfig, apply_bcs=False, assume_zero_u=False,
               elim=False):
    """One V-cycle on the level state L = [u | f] (multigrid.vcycle_stk).

    L: (2, ny, nx).  assume_zero_u: the iterate is zero and L[0] is
    unspecified, never read.  The new iterate is written into L[0]; L[1]
    is not touched.  Returns (L, r_rms of the final fine-level sweep).
    """
    _, ny, nx = L.shape
    if ny * nx < PALLAS_MIN_AREA or min(ny, nx) <= cfg.coarse_size:
        sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
        u = torch.zeros_like(L[1]) if assume_zero_u else L[0]
        u, r_rms = vcycle(u, L[1], h, c, tol, sub_cfg, apply_bcs=apply_bcs, elim=elim)
        L[0] = u
        return L, r_rms

    alpha = cfg.jacobi_damping
    u, res = smooth_down(None if assume_zero_u else L[0], L[1], h, c, alpha,
                         ns=cfg.pre_smooth, elim=elim)
    res_c = transfer.restrict(res, apply_bcs=apply_bcs)
    Lc = res_c.new_empty((2,) + tuple(res_c.shape))
    Lc[1] = res_c
    Lc, _ = vcycle_stk(Lc, h * 2.0, c, tol, cfg, apply_bcs=apply_bcs,
                       assume_zero_u=True, elim=elim)
    corrx = transfer.x_interleave_coarse(Lc[0], apply_bcs=apply_bcs)
    _, r_rms = corr_up(u, L[1], corrx, h, c, alpha, ns=cfg.post_smooth, elim=elim,
                       with_norm=True, out=L[0])
    return L, r_rms


def mg_solve_rp(u0, f, h: float, c, tol: float, niters: int, apply_bcs=False,
                cfg: MGConfig = MGConfig()):
    """``mg_solve`` with ``vcycle_rp`` (multigrid.mg_solve_rp): the iterate
    path, so its cycles smooth without eliminated BCs; no warning, as in
    JAX.  Returns (u, r_rms, iterations)."""

    def step(u, f, c):
        if apply_bcs:
            u = bc.ns_temperature_bcs(u)
        return vcycle_rp(u, f, h, c, tol, cfg, apply_bcs)

    out = _outer(step, u0, f, c, tol, niters,
                 key=("mg_solve_rp", cfg, float(h), _c_key(c), float(tol), niters, apply_bcs))
    return out["u"], out["r_rms"], int(out["it"])  # the host's one read


def _mg_solve_mixed(u0, f, h: float, c, tol: float, niters: int, apply_bcs=False,
                    cfg: MGConfig = MGConfig(), inner_cycles: int = 1):
    """mg_solve_mixed's device results (``_outer``), for a caller that
    reads them itself."""
    tiny = torch.finfo(u0.dtype).tiny

    def step(u, f, c):
        if apply_bcs:
            u = bc.ns_temperature_bcs(u)
        r = stencil2d.residual(u, f, h, c)
        safe = torch.clamp_min(stencil2d.rms(r), tiny)
        r32 = (r / safe).to(torch.float32)
        e, e_rms = None, None
        for cyc in range(inner_cycles):
            e, e_rms = vcycle_rp(e, r32, h, c, tol, cfg, apply_bcs=apply_bcs,
                                 assume_zero_u=(cyc == 0), elim=apply_bcs)
        u = u - e.to(u.dtype) * safe
        return u, e_rms.to(u.dtype) * safe

    return _outer(step, u0, f, c, tol, niters,
                  key=("mg_solve_mixed", cfg, float(h), _c_key(c), float(tol), niters, apply_bcs,
                       inner_cycles))


def mg_solve_mixed(u0, f, h: float, c, tol: float, niters: int, apply_bcs=False,
                   cfg: MGConfig = MGConfig(), inner_cycles: int = 1):
    """Mixed-precision defect correction (multigrid.mg_solve_mixed): u and
    the defect in u0's dtype (float64), the V-cycles in float32 on the
    normalised defect,

        r = A u - f,  safe = max(rms(r), tiny),  e = MG_f32(r / safe),
        u -= safe * e,

    until the post-correction estimate safe * rms(A e - r/safe) (the last
    fine-level residual of the inner cycles) is below tol * rms(f).
    Returns (u, r_rms, outer_iterations)."""
    out = _mg_solve_mixed(u0, f, h, c, tol, niters, apply_bcs, cfg, inner_cycles)
    r, t, it = _outcome(out)
    _warn_unconverged("mg_solve_mixed", r, t, it, niters, apply_bcs)
    return out["u"], out["r_rms"], it


# JAX's jitted mg_solve_mixed (multigrid.mg_solve_mixed_jit), the same call
mg_solve_mixed_jit = mg_solve_mixed


def _auto_inner_cycles(ny: int, nx: int, cfg: MGConfig = MGConfig()) -> int:
    """V-cycles per outer iteration (multigrid._auto_inner_cycles): one with
    deep smoothing or at 8193 cells a side and beyond, else two."""
    if cfg.pre_smooth >= 3:
        return 1
    return 1 if max(ny, nx) >= 8193 else 2


def _fmg_guess(r32, h: float, c, tol: float, cfg: MGConfig, apply_bcs=False):
    """Full-multigrid initial guess for A e = r32, float32 (ny, nx)
    (multigrid._fmg_guess): the rhs restricted down the ladder with full
    weighting, the coarsest level solved from zero by the coarse solver
    (its smoother without eliminated BCs), then per level upward one
    prolongation and one ``vcycle_stk`` from it.  No loop but the coarse
    solve's.  JAX measured it slower at scale than the loop it shortens
    (fpr_tpu/solvers/multigrid.py:689-696), so it is off by default."""
    levels = [(h, r32)]
    while min(levels[-1][1].shape) > cfg.coarse_size:
        hl, rl = levels[-1]
        levels.append((hl * 2.0, transfer.restrict_full_weighting(rl, apply_bcs=apply_bcs)))
    hl, rl = levels[-1]
    e, _ = _coarse_solve(torch.zeros_like(rl), rl, hl, c, tol, cfg)
    for hl, rl in reversed(levels[:-1]):
        e = transfer.prolongate(e, tuple(rl.shape), apply_bcs=apply_bcs)
        L, _ = vcycle_stk(torch.stack([e, rl]), hl, c, tol, cfg, apply_bcs=apply_bcs,
                          elim=apply_bcs)
        e = L[0]
    return e


def mg_solve_ds_rp(u_ds, f_ds, tolf, h: float, c, niters: int,
                   cfg: MGConfig = MGConfig(), inner_cycles=None, apply_bcs=False,
                   r0=None, tol: float = 1e-7, velocity_max=False, field_sumsq=False,
                   fmg=False, extras0=None):
    """Double-single defect-correction core (multigrid.mg_solve_ds_rp).

    u_ds: (2, ny, nx) float32 hi/lo, or None for zero.  f_ds: (1, ny, nx)
    for an exactly-float32 rhs, or (2, ny, nx).  tolf: absolute tolerance on
    the defect rms (a float or a 0-dim tensor).  c: a Python number or a
    0-dim float32 tensor.  r0: an initial (defect, rms) replacing the first
    defect pass; with an extras flag it needs extras0, the (max_vx,
    max_vy, sumsq) that pass would have given.  velocity_max /
    field_sumsq: K1's max|du/dy|, max|du/dx| and sum(u_hi^2) of the
    returned iterate, returned as JAX's extras tuple (max_vx, max_vy,
    sumsq) when either flag is set (zeros where not asked for).  apply_bcs: the NS temperature BCs, with eliminated-BC
    smoothing in the correction cycles (multigrid.py:300-315).  The
    correction cycles are ``vcycle_stk`` when ``_stk_eligible(cfg)``, else
    ``vcycle_rp``.  fmg: start the loop from ``_fmg_guess``'s correction,
    folded in by one defect pass (a cfg that is not stk-eligible ignores
    it, as in JAX).

    The outer loop is a ``while_loop`` over (u_ds, L or r32, r_rms, extras,
    it), as in JAX: on CUDA one launch of a cached CUDA graph (or a part of
    the caller's graph), no host read.  Returns (u_ds', r_rms,
    outer_iterations[, extras]), the count a 0-dim int32 tensor on the
    device.
    """
    _, ny, nx = f_ds.shape
    if inner_cycles is None:
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    extras_on = velocity_max or field_sumsq
    if extras_on and r0 is not None and extras0 is None:
        raise ValueError("extras flags with r0 need extras0")
    if not isinstance(tolf, torch.Tensor):
        tolf = torch.full((), float(tolf), dtype=torch.float32, device=f_ds.device)
    args = dict(u=u_ds, f=f_ds, tolf=tolf.to(torch.float32), c=_c_arg(c),
                r0=None if r0 is None else tuple(r0),
                ex0=tuple(extras0) if extras_on and r0 is not None else None)
    key = ("mg_solve_ds_rp", cfg, float(h), _c_key(c), niters, inner_cycles, apply_bcs,
           float(tol), velocity_max, field_sumsq, fmg)

    def solve(a):
        return _ds_outer(a, h, c if a["c"] is None else a["c"], niters, cfg, inner_cycles,
                         apply_bcs, tol, velocity_max, field_sumsq, fmg)

    out = loops.device_call(solve, args, key=key)
    return out if extras_on else out[:3]


def _ds_outer(a, h, c, niters, cfg, inner_cycles, apply_bcs, tol, velocity_max,
              field_sumsq=False, fmg=False):
    """mg_solve_ds_rp on its graph's inputs a; returns (u_ds, r_rms, it,
    extras)."""
    f_ds, tolf = a["f"], a["tolf"]
    _, ny, nx = f_ds.shape
    dev = f_ds.device
    c_t = stencil2d.as_scalar(c, f_ds[0])
    C = dsm.defect_scalars(c, h, dev)
    kw = dict(apply_bcs=apply_bcs, velocity_max=velocity_max, field_sumsq=field_sumsq)
    extras_on = velocity_max or field_sumsq

    u_ds = a["u"]
    if u_ds is None:
        u_ds = torch.zeros((2, ny, nx), dtype=torch.float32, device=dev)
    if a["r0"] is not None:
        r32, r_rms = a["r0"]
        extras = a["ex0"] or ()
    else:
        out = dsm.defect_pass(u_ds, f_ds, None, 0.0, h, c, C=C, **kw)
        u_ds, r32, r_rms = out[:3]
        extras = out[3] if extras_on else ()

    stk = _stk_eligible(cfg)
    if stk and fmg:
        # the first correction from the FMG guess, folded into u by one
        # defect pass, which also writes the loop's first defect into L[1]
        e0 = _fmg_guess(r32, h, c_t, tol, cfg, apply_bcs=apply_bcs)
        out = dsm.defect_pass_stk(u_ds, f_ds, torch.stack([e0, r32]), 1.0, h, c, C=C, **kw)
        u_ds, L, r_rms = out[:3]
        extras = out[3] if extras_on else ()
    elif stk:
        L = torch.empty((2, ny, nx), dtype=torch.float32, device=dev)
        L[1] = r32

    def cond(s):
        return (s["it"] < niters) & (s["r_rms"] >= tolf)

    def body(s):
        if stk:
            L = s["s"]
            for cyc in range(inner_cycles):
                L, _ = vcycle_stk(L, h, c_t, tol, cfg, apply_bcs=apply_bcs,
                                  assume_zero_u=(cyc == 0), elim=apply_bcs)
            out = dsm.defect_pass_stk(s["u"], f_ds, L, 1.0, h, c, C=C, **kw)
        else:
            e = None
            for cyc in range(inner_cycles):
                e, _ = vcycle_rp(e, s["s"], h, c_t, tol, cfg, apply_bcs=apply_bcs,
                                 assume_zero_u=(cyc == 0), elim=apply_bcs)
            out = dsm.defect_pass(s["u"], f_ds, e, 1.0, h, c, C=C, **kw)
        return dict(u=out[0], s=out[1], r_rms=out[2], ex=out[3] if extras_on else (),
                    it=s["it"] + 1)

    s = loops.while_loop(cond, body, dict(u=u_ds, s=L if stk else r32, r_rms=r_rms,
                                          ex=tuple(extras), it=_int0(f_ds)), donate=True,
                         name="outer")
    return s["u"], s["r_rms"], s["it"], s["ex"]


def mg_solve_ds(u0, f, h: float, c, tol: float, niters: int,
                cfg: MGConfig = MGConfig(), inner_cycles=None, return_pair=False,
                apply_bcs=False, fmg=False, *, device=None):
    """Defect-correction MG with the double-single defect pass
    (multigrid.mg_solve_ds, with its positional order).

    f: (ny, nx) float32 or float64 tensor or array; u0: the same, or None
    for a zero guess.  fmg: a full-multigrid first correction
    (``mg_solve_ds_rp``).  device: where to solve (required when f is not a
    tensor; by default f's device).  Returns (u, r_rms, outer_iterations)
    in f's dtype, or ((u_hi, u_lo), r_rms, outer_iterations) with
    return_pair.  On CUDA the solve is one launch of a cached CUDA graph;
    the host reads (r_rms, tolf, outer count) once, at the end.
    """
    if device is None:
        if not isinstance(f, torch.Tensor):
            raise ValueError("mg_solve_ds: pass device= when f is not a tensor")
        device = f.device
    f = torch.as_tensor(f).to(device)
    u0 = None if u0 is None else torch.as_tensor(u0).to(device)

    def solve(a):
        f = a["f"]
        f_ds = f.to(torch.float32)[None] if f.dtype != torch.float64 else dsm.to_ds(f)
        f_rms = stencil2d.rms(f)
        tolf = (tol * f_rms).to(torch.float32)
        if a["u0"] is None and not apply_bcs:
            u_ds, r0 = None, (-f_ds[0], f_rms.to(torch.float32))
        else:
            u_ds = dsm.to_ds(a["u0"]) if a["u0"] is not None else None
            r0 = None
        u_ds, r_rms, it = mg_solve_ds_rp(u_ds, f_ds, tolf, h, c if a["c"] is None else a["c"],
                                         niters, cfg=cfg, inner_cycles=inner_cycles,
                                         apply_bcs=apply_bcs, r0=r0, tol=tol, fmg=fmg)
        return dict(u=u_ds, r_rms=r_rms, it=it, tolf=tolf)

    out = loops.device_call(solve, dict(f=f, u0=u0, c=_c_arg(c)),
                            key=("mg_solve_ds", cfg, float(h), _c_key(c), float(tol), niters,
                                 inner_cycles, apply_bcs, fmg))
    r, t, it = _outcome(out)
    u_ds, r_rms = out["u"], out["r_rms"]
    _warn_unconverged("mg_solve_ds", r, t, it, niters, apply_bcs)
    if return_pair:
        return (u_ds[0], u_ds[1]), r_rms, it
    u = u_ds[0].to(f.dtype) + u_ds[1].to(f.dtype)
    return u, r_rms.to(f.dtype), it


def mg_solve_ds_jit(f, h: float, c, tol: float, niters: int, cfg: MGConfig = MGConfig(),
                    inner_cycles=None, return_pair=False, fmg=False, *, device=None):
    """JAX's zero-initial-guess benchmark entry point
    (multigrid.mg_solve_ds_jit): ``mg_solve_ds(None, f, ...)``, one launch of
    the same cached CUDA graph."""
    return mg_solve_ds(None, f, h, c, tol, niters, cfg=cfg, inner_cycles=inner_cycles,
                       return_pair=return_pair, fmg=fmg, device=device)
