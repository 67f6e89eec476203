"""The fused Navier-Stokes operator pass K4 (fpr_tpu/ops/pallas_ns.py::
ns_fused_rp: modes ``explicit`` with ``with_defect`` and ``rhs`` with
``with_sumsq`` and ``with_helm_defect``).

One pass over the stacked (2, ny, nx) float32 state TW = [T | W] and the
stream function S:

    T <- BCs(T)  (Dirichlet bottom 1 / top 0, then Neumann sides)
    vx = dS/dy, vy = -dS/dx, B = Ra dT/dx, dT2 = k lap T, dW2 = Pr lap W
    (no diffusion when beta == 1), first-order upwind advection dTx ... dWy
    explicit: T' = T + dt (dT2 - dTx - dTy), W' = W + dt (dW2 - dWx - dWy - Pr B)
    rhs:      T' = -cT (T + dt ((1-beta) dT2 - dTx - dTy)), W' likewise with cW

On the boundary T' is the BC'd T and W' the old W (explicit), or -c times
them (rhs).  Also returned: sum(T'^2) and sum(W'^2); with ``with_defect``
(explicit only, S the (2, ny, nx) ds pair) the next stream-function
solve's initial defect r = A S - W' in ds arithmetic, its rms, and the
curl maxima max|dS/dy|, max|dS/dx| of S.  With ``with_helm_defect`` (rhs
only, pallas_ns.py:82-88, 266-296) the two Helmholtz solves' warm-start
defects rT = A_cT (BC(T), 0) - T' and rW = A_cW (W, 0) - W' in ds
arithmetic, exactly what K1 (``ds.defect_pass``, scale 0, T with
apply_bcs) gives on those warm starts, and their sums of squares.  No
solver path uses that mode, as in the JAX package, whose fast loop measured
it slower than the two separate defect passes (pallas_ns.py:455-459).  dt,
cT and cW are 0-dim device tensors.  The port's arrays are physical.  On a
row shard ``rows`` (``ops.rows.Rows``) gives the row hooks: the T BCs'
Dirichlet rows and the interior follow the global row, outputs outside the
global grid are 0, and the sums and maxima cover the owned rows
(pallas_ns.py:431-495).
"""

from __future__ import annotations

import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import bc
from fpr_tpu_torch.ops import rows as rowhooks
from fpr_tpu_torch.ops.ds import defect_pass_plain, defect_scalars, ds_add, two_sum
from fpr_tpu_torch.ops.rows import Rows

_MODE_RHS, _WITH_DEFECT, _USE_DIF, _HELM_DEFECT = 1, 2, 4, 8


def _use_dif(beta: float) -> bool:
    return abs(beta - 1.0) > 1e-8


def ns_fused_plain(TW, S, scal, h, Pr, Ra, k, beta, mode, with_defect, rows=None,
                   helm=False):
    """Plain PyTorch version of K4; see ``ns_fused_rp``.  scal: (dt, cT, cW),
    0-dim tensors (cT and cW None in explicit mode); helm: the Helmholtz
    defects.  Returns (out, r, sums) with r the defect, the (2, ny, nx)
    [rT | rW], or None, and sums the 8 values [sum T'^2, sum W'^2, sum r^2
    (rT^2), max|dS/dy|, max|dS/dx|, sum rW^2, rms of sums[2], rms of
    sums[5]] (0 where the mode has none), the rms over the global cells."""
    dt = scal[0]
    n_loc = TW.shape[1]
    rows = Rows.whole(n_loc) if rows is None else rows
    zero = TW.new_zeros(())
    T = bc.ns_temperature_bcs(TW[0], rows)
    W = TW[1]
    m = rows.interior(n_loc, TW.device)[1:-1, None]
    Sh = S[0] if with_defect else S
    I = (slice(1, -1), slice(1, -1))
    up, dn, lf, rt = (slice(None, -2), slice(1, -1)), (slice(2, None), slice(1, -1)), \
        (slice(1, -1), slice(None, -2)), (slice(1, -1), slice(2, None))
    _2h, _h, _h2 = 0.5 / h, 1.0 / h, 1.0 / (h * h)
    vx = (Sh[dn] - Sh[up]) * _2h
    vy = -(Sh[rt] - Sh[lf]) * _2h
    B = Ra * (T[rt] - T[lf]) * _2h

    def lap(F):
        return (F[up] + F[dn] + F[lf] + F[rt] - 4.0 * F[I]) * _h2

    dT2 = k * lap(T) if _use_dif(beta) else zero
    dW2 = Pr * lap(W) if _use_dif(beta) else zero

    def upwind(F, v, back_sl, fwd_sl):
        back = (F[I] - F[back_sl]) * _h
        fwd = (F[fwd_sl] - F[I]) * _h
        return v * torch.where(v > 0, back, fwd)

    dTx, dTy = upwind(T, vx, lf, rt), upwind(T, vy, up, dn)
    dWx, dWy = upwind(W, vx, lf, rt), upwind(W, vy, up, dn)
    PrB = Pr * B
    if mode == "explicit":
        T_out, W_out = T.clone(), W.clone()
        T_out[I] = torch.where(m, T[I] + dt * (dT2 - dTx - dTy), T[I])
        W_out[I] = torch.where(m, W[I] + dt * (dW2 - dWx - dWy - PrB), W[I])
    else:
        wdif = 1.0 - beta
        termT, termW = torch.zeros_like(T), torch.zeros_like(W)
        termT[I] = torch.where(m, wdif * dT2 - dTx - dTy, zero)
        termW[I] = torch.where(m, wdif * dW2 - dWx - dWy - PrB, zero)
        T_out = -scal[1] * (T + dt * termT)
        W_out = -scal[2] * (W + dt * termW)
    phys = rows.physical(n_loc, TW.device)[:, None]
    out = torch.where(phys, torch.stack([T_out, W_out]), zero)
    own = slice(*rows.own)
    sums = torch.stack([torch.sum((out[0] * out[0])[own]), torch.sum((out[1] * out[1])[own]),
                        zero, zero, zero, zero, zero, zero])
    r = None
    if with_defect:
        Sl = S[1]
        s1, e1 = two_sum(Sh[up], Sh[dn])
        s2, e2 = two_sum(Sh[lf], Sh[rt])
        sh_, e3 = two_sum(s1, s2)
        sl_ = ((e1 + e2) + e3) + ((Sl[up] + Sl[dn]) + (Sl[lf] + Sl[rt]))
        th, tl = ds_add(sh_, sl_, -(Sh[I] * 4.0), -(Sl[I] * 4.0))
        th, tl = th * _h2, tl * _h2
        rs, re = two_sum(th, -out[1][I])
        r = torch.zeros_like(W)
        r[I] = torch.where(m, rs + (re + tl), zero)
        y = torch.arange(n_loc, device=TW.device)
        mo = m & ((y >= rows.own[0]) & (y < rows.own[1]))[1:-1, None]
        sums[2] = torch.sum((r * r)[own])
        sums[3] = torch.amax(torch.where(mo, torch.abs(vx), zero))
        sums[4] = torch.amax(torch.where(mo, torch.abs(vy), zero))
    if helm:
        # K1's arithmetic on the warm starts (T, 0) with the BCs and (W, 0),
        # the C = 4 + c h^2 pairs in the EFT order of pallas_ns.py:473-485
        # (ds._defect_scalars' float32 branch)
        zl = torch.zeros_like(W)
        _, rT, sT = defect_pass_plain(torch.stack([TW[0], zl]), out[0:1], None, 0.0, h,
                                      defect_scalars(scal[1], h, TW.device), False,
                                      apply_bcs=True, rows=rows)
        _, rW, sW = defect_pass_plain(torch.stack([W, zl]), out[1:2], None, 0.0, h,
                                      defect_scalars(scal[2], h, TW.device), False, rows=rows)
        r = torch.stack([rT, rW])
        sums[2], sums[5] = sT[0], sW[0]
    n_cells = sums.new_full((), float(TW.shape[2] * rows.ny))
    sums[6], sums[7] = torch.sqrt(sums[2] / n_cells), torch.sqrt(sums[5] / n_cells)
    return out, r, sums


def _plan(t: torch.Tensor, ny: int, nx: int, helm: bool) -> tuple[int, int]:
    """(S, blocks) of an NS-kernel launch over (ny, nx) on t's card
    (``kernels.tile_plan``)."""
    return kernels.tile_plan(ny, nx, *kernels.card_fill("fpr_ns_fill", int(helm),
                                                          t.device.index))


def _launch_ns(TW, Sh, Sl, scal, h, Pr, Ra, k, beta, flags, hooks, out, r, rw, sums, plan):
    """One launch of the NS kernel (csrc/ns_fused.cu) with plan = (S rows a
    thread, blocks): [T' | W'] into out, r (the defect, or rT) into r, rW
    into rw, and the 8 values of ``ns_fused_plain``'s sums into sums.  Sl:
    S's lo plane with the defect flag, else None; scal: (dt, cT, cW) (cT, cW
    None in explicit mode); hooks: (row_off, ny_g, own0, own1)."""
    _, ny, nx = TW.shape
    S, blocks = plan
    partials = torch.empty(6 * blocks, dtype=torch.float32, device=TW.device)
    dt, cT, cW = scal
    err = kernels.lib().fpr_ns_fused(
        TW[0].data_ptr(), TW[1].data_ptr(), Sh.data_ptr(), kernels.ptr(Sl), dt.data_ptr(),
        kernels.ptr(cT), kernels.ptr(cW), 0.5 / h, 1.0 / h, 1.0 / (h * h), h * h, Pr, Ra, k,
        1.0 - beta, float(nx * hooks[1]), ny, nx, flags, S, blocks, *hooks, out[0].data_ptr(),
        out[1].data_ptr(), kernels.ptr(r), kernels.ptr(rw), partials.data_ptr(),
        kernels.launch_counter(TW).data_ptr(), sums.data_ptr(), kernels.stream(TW))
    kernels.check(err, "fpr_ns_fused")


def _ns_fused_cuda(TW, S, scal, h, Pr, Ra, k, beta, mode, with_defect, rows=None,
                   helm=False):
    """K4 on the card (csrc/ns_fused.cu), one launch and nothing else; see
    ``ns_fused_rp`` and ``ns_fused_plain``.  The Helmholtz-defect launches count as
    ``ns_fused_helm``."""
    rhs = mode == "rhs"
    dt, cT, cW = scal
    kernels.require_cuda_f32("ns_fused_rp", TW, S, dt, *((cT, cW) if rhs else ()))
    _, ny, nx = TW.shape
    rows = Rows.whole(ny) if rows is None else rows
    out = torch.empty_like(TW)
    r = torch.empty_like(TW) if helm else (torch.empty_like(TW[0]) if with_defect else None)
    sums = TW.new_empty(8)
    flags = ((_MODE_RHS if rhs else 0) | (_WITH_DEFECT if with_defect else 0)
             | (_USE_DIF if _use_dif(beta) else 0) | (_HELM_DEFECT if helm else 0))
    _launch_ns(TW, S[0] if with_defect else S, S[1] if with_defect else None,
               (dt, cT, cW) if rhs else (dt, None, None), h, Pr, Ra, k, beta, flags,
               rows.args(), out, r[0] if helm else r, r[1] if helm else None, sums,
               _plan(TW, ny, nx, helm))
    kernels.launches["ns_fused_helm" if helm else "ns_fused"] += 1
    return out, r, sums


def ns_fused_rp(TW, S, dt, h, Pr, Ra, k=1.0, beta=0.0, mode="explicit", cT=None,
                cW=None, with_sumsq=False, with_defect=False, rows=None,
                with_helm_defect=False):
    """K4: the fused NS operator pass (pallas_ns.ns_fused_rp).

    TW: (2, ny, nx) float32 [T | W]; S: (ny, nx) stream function, or the
    (2, ny, nx) ds pair with ``with_defect``.  dt (and cT, cW in rhs mode):
    0-dim float32 tensors on TW's device.

    Returns out; with ``with_sumsq`` (out, (sum T'^2, sum W'^2)); with
    ``with_defect`` (out, (sum T'^2, sum W'^2), (r, r_rms),
    (max|dS/dy|, max|dS/dx|, 0)); with ``with_helm_defect`` (rhs only) (out,
    (sum T'^2, sum W'^2), (rT, rT_rms), (rW, rW_rms)), the Helmholtz
    solves' initial defects, each to feed its ``mg_solve_ds_rp(r0=...)``.
    The rms values are over the global nx*ny cells.  rows: the row hooks
    of a shard's local rows (None: one device); the sums are then the owned
    rows'.  A CPU tensor runs the plain version, a CUDA tensor the kernel.
    """
    if mode not in ("explicit", "rhs"):
        raise ValueError(f"mode must be 'explicit' or 'rhs', got {mode!r}")
    if with_defect and (mode != "explicit" or S.dim() != 3):
        raise ValueError("with_defect is explicit-only and needs the (2, ny, nx) ds S")
    if with_helm_defect and (mode != "rhs" or with_defect):
        raise ValueError("with_helm_defect is rhs-only and excludes with_defect")
    if mode == "rhs" and (cT is None or cW is None):
        raise ValueError("rhs mode needs cT and cW")
    scal = tuple(None if c is None else c.reshape(()).to(TW.dtype)
                 for c in (dt, *((cT, cW) if mode == "rhs" else (None, None))))
    if rows is not None:
        rowhooks.check("ns_fused_rp", rows, TW.shape[1])
    fn = ns_fused_plain if TW.device.type == "cpu" else _ns_fused_cuda
    out, r, sums = fn(TW, S, scal, float(h), float(Pr), float(Ra), float(k),
                      float(beta), mode, with_defect, rows, with_helm_defect)
    if with_helm_defect:
        return out, (sums[0], sums[1]), (r[0], sums[6]), (r[1], sums[7])
    if with_defect:
        # sums[5], the rW^2 of the Helmholtz mode, is 0 here
        return out, (sums[0], sums[1]), (r, sums[6]), (sums[3], sums[4], sums[5])
    if with_sumsq:
        return out, (sums[0], sums[1])
    return out
