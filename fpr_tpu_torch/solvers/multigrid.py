"""Geometric multigrid for (nabla^2 - c) u = f on 2^k+1 grids, and the
double-single defect-correction solver around it
(fpr_tpu/solvers/multigrid.py: _smooth_fns, _coarse_solve, vcycle,
PALLAS_MIN_AREA, _stk_eligible, vcycle_stk, _auto_inner_cycles,
mg_solve_ds_rp, mg_solve_ds).

- ``vcycle``: the reference-semantics V-cycle in plain PyTorch (damped
  Jacobi, injection, bilinear prolongation, Jacobi or DST coarse solve).
  It runs every level below ``PALLAS_MIN_AREA`` cells.
- ``vcycle_stk``: the V-cycle whose levels of at least ``PALLAS_MIN_AREA``
  cells run the two fused legs (K2 ``smooth_down``, K3 ``corr_up``).
- ``mg_solve_ds_rp`` / ``mg_solve_ds``: u and f as hi/lo float32 pairs;
  each outer iteration is V-cycles on the float32 defect, then one ds
  defect pass (K1), which also gives the true defect norm.

The JAX solvers' ``lax.while_loop``s are host loops here: each test of a
loop condition reads one scalar from the device.  The level state of the
stacked V-cycle is a (2, ny, nx) tensor L = [u | f]: the up leg writes the
new iterate into L[0] and the defect pass writes the new rhs into L[1], in
both cases from buffers the kernel does not write, so no kernel reads what
it writes.  Arrays are physical (ny, nx).  FMG, the fused DST correction
and the other JAX tiers are not ported.
"""

from __future__ import annotations

import torch

from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.core.grid import mg_levels
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import stencil2d, transfer
from fpr_tpu_torch.ops.vcycle_legs import corr_up, smooth_down
from fpr_tpu_torch.solvers.dst import dst_solve

# levels with fewer cells run the plain-PyTorch V-cycle; the same cut as
# the JAX package (multigrid.py:285), so the ladders and the outer counts
# match it
PALLAS_MIN_AREA = 1024 * 1024

def _smooth_fns(cfg: MGConfig, elim: bool = False):
    """The damped-Jacobi smoother (multigrid._smooth_fns, jnp tier), with the
    side-column copy after each sweep when elim."""

    def smooth(u, f, h, c, with_norm):
        u, r = stencil2d.jacobi_step(u, f, h, c, alpha=cfg.jacobi_damping,
                                     with_norm=with_norm)
        if elim:
            u = u.clone()
            u[:, 0] = u[:, 1]
            u[:, -1] = u[:, -2]
        return u, r

    return smooth


def _coarse_solve(u, f, h, c, tol, cfg: MGConfig, smooth):
    """DST solve, or at most 20*coarse_size Jacobi sweeps until the residual
    rms drops below tol*rms(f) (multigrid._coarse_solve)."""
    if cfg.coarse_solver is CoarseSolver.DST:
        return dst_solve(u, f, h, c)
    tol_rhs = tol * stencil2d.rms(f)
    r_rms = None
    for _ in range(20 * cfg.coarse_size):
        if r_rms is not None and not bool(r_rms >= tol_rhs):
            break
        u, r_rms = smooth(u, f, h, c, True)
    return u, r_rms


def vcycle(u, f, h, c, tol, cfg: MGConfig, apply_bcs=False, elim=False):
    """One V-cycle; returns (u, rms of the residual fed to the last fine
    post-smooth) (multigrid.vcycle, Jacobi smoother, injection)."""
    smooth = _smooth_fns(cfg, elim)
    ny, nx = u.shape
    mg_levels(nx, ny, cfg.coarse_size)  # validates the 2^k+1 sides

    def descend(u, f, h, top):
        nyl, nxl = u.shape
        if min(nxl, nyl) <= cfg.coarse_size:
            return _coarse_solve(u, f, h, c, tol, cfg, smooth)
        for _ in range(cfg.pre_smooth):
            u, _ = smooth(u, f, h, c, False)
        res_c = transfer.restrict(stencil2d.residual(u, f, h, c), apply_bcs=apply_bcs)
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


def _stk_eligible(cfg: MGConfig) -> bool:
    """The fused legs take 1-6 pre- and post-smooths."""
    return 1 <= cfg.pre_smooth <= 6 and 1 <= cfg.post_smooth <= 6


def vcycle_stk(L, h, c, tol, cfg: MGConfig, apply_bcs=False, assume_zero_u=False,
               elim=False):
    """One V-cycle on the level state L = [u | f] (multigrid.vcycle_stk).

    L: (2, ny, nx).  assume_zero_u: the iterate is zero and L[0] is
    unspecified, never read.  The new iterate is written into L[0]; L[1]
    is not touched.  Returns (L, r_rms of the final fine-level sweep).
    """
    _, ny, nx = L.shape
    if ny * nx < PALLAS_MIN_AREA or min(ny, nx) <= cfg.coarse_size:
        u = torch.zeros_like(L[1]) if assume_zero_u else L[0]
        u, r_rms = vcycle(u, L[1], h, c, tol, cfg, apply_bcs=apply_bcs, elim=elim)
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


def _auto_inner_cycles(ny: int, nx: int, cfg: MGConfig = MGConfig()) -> int:
    """V-cycles per outer iteration (multigrid._auto_inner_cycles): one with
    deep smoothing or at 8193 cells a side and beyond, else two."""
    if cfg.pre_smooth >= 3:
        return 1
    return 1 if max(ny, nx) >= 8193 else 2


def mg_solve_ds_rp(u_ds, f_ds, tolf, h: float, c, niters: int,
                   cfg: MGConfig = MGConfig(), inner_cycles=None, apply_bcs=False,
                   r0=None, tol: float = 1e-7, velocity_max=False, extras0=None):
    """Double-single defect-correction core (multigrid.mg_solve_ds_rp).

    u_ds: (2, ny, nx) float32 hi/lo, or None for zero.  f_ds: (1, ny, nx)
    for an exactly-float32 rhs, or (2, ny, nx).  tolf: absolute tolerance on
    the defect rms (a float or a 0-dim tensor).  c: a Python number or a
    0-dim float32 tensor.  r0: an initial (defect, rms) replacing the first
    defect pass; with velocity_max it needs extras0, the (max|du/dy|,
    max|du/dx|) that pass would have given.  velocity_max: also return
    those maxima of the returned iterate.  apply_bcs: the NS temperature
    BCs, with eliminated-BC smoothing in the correction cycles
    (multigrid.py:300-315).

    Returns (u_ds', r_rms, outer_iterations[, (max|du/dy|, max|du/dx|)]).
    """
    if not _stk_eligible(cfg):
        raise NotImplementedError("the ported solver runs the fused legs only: "
                                  "pre_smooth and post_smooth in [1, 6]")
    _, ny, nx = f_ds.shape
    if inner_cycles is None:
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    if velocity_max and r0 is not None and extras0 is None:
        raise ValueError("velocity_max with r0 needs extras0")
    dev = f_ds.device
    tolf = torch.as_tensor(tolf, dtype=torch.float32, device=dev)
    c_t = stencil2d.as_scalar(c, f_ds[0])
    C = dsm.defect_scalars(c, h, dev)
    kw = dict(apply_bcs=apply_bcs, velocity_max=velocity_max)

    if u_ds is None:
        u_ds = torch.zeros((2, ny, nx), dtype=torch.float32, device=dev)
    if r0 is not None:
        r32, r_rms = r0
        extras = tuple(extras0) if velocity_max else ()
    else:
        out = dsm.defect_pass(u_ds, f_ds, None, 0.0, h, c, C=C, **kw)
        u_ds, r32, r_rms = out[:3]
        extras = out[3][:2] if velocity_max else ()

    L = torch.empty((2, ny, nx), dtype=torch.float32, device=dev)
    L[1] = r32
    it = 0
    while it < niters and bool(r_rms >= tolf):
        for cyc in range(inner_cycles):
            L, _ = vcycle_stk(L, h, c_t, tol, cfg, apply_bcs=apply_bcs,
                              assume_zero_u=(cyc == 0), elim=apply_bcs)
        out = dsm.defect_pass_stk(u_ds, f_ds, L, 1.0, h, c, C=C, **kw)
        u_ds, L, r_rms = out[:3]
        if velocity_max:
            extras = out[3][:2]
        it += 1
    if velocity_max:
        return u_ds, r_rms, it, extras
    return u_ds, r_rms, it


def mg_solve_ds(u0, f, h: float, c, tol: float, niters: int,
                cfg: MGConfig = MGConfig(), inner_cycles=None, return_pair=False,
                apply_bcs=False, device=None):
    """Defect-correction MG with the double-single defect pass
    (multigrid.mg_solve_ds).

    f: (ny, nx) float32 or float64 tensor or array; u0: the same, or None
    for a zero guess.  device: where to solve (required when f is not a
    tensor; by default f's device).  Returns (u, r_rms, outer_iterations)
    in f's dtype, or ((u_hi, u_lo), r_rms, outer_iterations) with
    return_pair.
    """
    if device is None:
        if not isinstance(f, torch.Tensor):
            raise ValueError("mg_solve_ds: pass device= when f is not a tensor")
        device = f.device
    f = torch.as_tensor(f).to(device)

    def pack(a):
        a = torch.as_tensor(a).to(device)
        if a.dtype == torch.float64:
            hi = a.to(torch.float32)
            return torch.stack([hi, (a - hi.to(torch.float64)).to(torch.float32)])
        return torch.stack([a.to(torch.float32), torch.zeros_like(a, dtype=torch.float32)])

    f_ds = f.to(torch.float32)[None] if f.dtype != torch.float64 else pack(f)
    f_rms = stencil2d.rms(f)
    tolf = (tol * f_rms).to(torch.float32)
    if u0 is None and not apply_bcs:
        u_ds = None
        r0 = (-f_ds[0], f_rms.to(torch.float32))
    else:
        u_ds = pack(u0) if u0 is not None else None
        r0 = None
    u_ds, r_rms, it = mg_solve_ds_rp(u_ds, f_ds, tolf, h, c, niters, cfg=cfg,
                                     inner_cycles=inner_cycles, apply_bcs=apply_bcs,
                                     r0=r0, tol=tol)
    if return_pair:
        return (u_ds[0], u_ds[1]), r_rms, it
    u = u_ds[0].to(f.dtype) + u_ds[1].to(f.dtype)
    return u, r_rms.to(f.dtype), it
