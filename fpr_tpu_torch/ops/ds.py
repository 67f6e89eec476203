"""Double-single (two-float32) arithmetic and the defect pass K1
(fpr_tpu/ops/ds.py: the error-free transforms, ds_neg, ds_mul_f1,
to_ds, from_ds, _defect_scalars, defect_pass, defect_pass_stk).

A double-single value is a pair hi + lo of float32 tensors with
|lo| <= ulp(hi)/2, about 48 mantissa bits.  The transforms below are exact
only if every float32 operation is rounded on its own, which eager
PyTorch does (one kernel per operation, no contraction) and which the
CUDA kernel gets from ``-fmad=false``.

The defect pass: u' = u - scale e, optional NS temperature BCs on u', the
residual r = A u' - f in ds arithmetic (its hi part is returned), and
sum(r^2).  The port's arrays are physical (ny, nx) planes: u_ds is
(2, ny, nx) hi/lo, f_ds (1, ny, nx) for an exactly-float32 rhs or
(2, ny, nx), e and r (ny, nx).  On a row shard the arrays are the shard's
local rows and ``rows`` (``ops.rows.Rows``) gives the row hooks: the
BCs' Dirichlet rows and the interior follow the global row, and the sums
and maxima cover the owned rows (ds.py:575-641).  On a 2D-mesh shard
``cols`` (``ops.rows.Cols``) adds the column hooks: the interior follows
the global column too, and the sums and maxima cover the owned columns
(K1's ``own_lanes``, ds.py:355-372).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import bc
from fpr_tpu_torch.ops import rows as rowhooks
from fpr_tpu_torch.ops.rows import Cols, Rows

# ---------------------------------------------------------------------------
# error-free transforms (tensors of any shape; scalars as 0-dim tensors)
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """s + err == a + b exactly, requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def ds_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl), renormalised."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def ds_neg(xh, xl):
    """-(xh, xl)."""
    return -xh, -xl


def split(a):
    """Veltkamp split a == hi + lo into 12-bit-mantissa halves."""
    t = a * 4097.0
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly (Dekker product, no FMA)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ds_mul_f1(xh, xl, c):
    """(xh, xl) * c for a float32 scalar or tensor c."""
    p, e = two_prod(xh, c)
    e = e + xl * c
    return quick_two_sum(p, e)


def ds_mul_ds(xh, xl, yh, yl):
    """(xh, xl) * (yh, yl), dropping xl*yl."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def f32_pair(x: float):
    """A Python float as (hi, lo) float32 values, as Python floats."""
    hi = float(np.float32(x))
    return hi, float(np.float32(x - hi))


def to_ds(a: torch.Tensor) -> torch.Tensor:
    """An (ny, nx) field as a (2, ny, nx) float32 hi/lo pair (ds.to_ds): a
    float64 field split so that hi + lo keeps ~48 bits, any other (hi, 0)."""
    hi = a.to(torch.float32)
    if a.dtype != torch.float64:
        return torch.stack([hi, torch.zeros_like(hi)])
    return torch.stack([hi, (a - hi.to(torch.float64)).to(torch.float32)])


def from_ds(hi, lo, dtype=torch.float64):
    """hi + lo in dtype (ds.from_ds)."""
    return hi.to(dtype) + lo.to(dtype)


def _is_pow2(x: float) -> bool:
    m, _ = math.frexp(x)
    return m == 0.5


# ---------------------------------------------------------------------------
# the defect pass
# ---------------------------------------------------------------------------


def defect_scalars(c, h: float, device) -> torch.Tensor:
    """C = 4 + c h^2 as a ds pair: a (2,) float32 device tensor
    (ds._defect_scalars).  A Python c is split in float64 on the host; a
    float32 tensor c (a runtime Helmholtz shift) through error-free
    transforms on the device, keeping all ~48 bits of C."""
    if not isinstance(c, torch.Tensor):
        return _pair_tensor(f32_pair(4.0 + float(c) * float(h) * float(h)), device)
    if c.dtype != torch.float32:
        raise ValueError(f"a tensor c must be float32, got {c.dtype}")
    h2 = c.new_full((), float(h) * float(h))
    p, pe = two_prod(c, h2)
    s, se = two_sum(c.new_full((), 4.0), p)
    return torch.stack(quick_two_sum(s, se + pe))


def _pair_tensor(pair, device) -> torch.Tensor:
    """A (hi, lo) pair of Python floats as a (2,) float32 device tensor, by
    fills: no host-to-device copy, which a CUDA graph's capture refuses."""
    C = torch.empty(2, dtype=torch.float32, device=device)
    C[0].fill_(pair[0])
    C[1].fill_(pair[1])
    return C


def c_source(c, h):
    """What the defect pass takes for C = 4 + c h^2 when the caller has no
    pair: a Python c split in float64 on the host, as a (hi, lo) pair of
    floats; a float32 tensor c as itself (0-dim), from which the pass
    derives the pair as ``defect_scalars`` does."""
    if isinstance(c, torch.Tensor):
        return c.reshape(())
    return f32_pair(4.0 + float(c) * float(h) * float(h))


def _c_pair(C, h, device):
    """The (2,) float32 C pair from any form the defect pass takes: the
    pair itself, or a ``c_source``."""
    if isinstance(C, tuple):
        return _pair_tensor(C, device)
    return defect_scalars(C, h, device) if C.dim() == 0 else C


def _scale(scale, like):
    """The update's scale as a 0-dim float32 tensor: a Python number, or a
    device scalar (no host read)."""
    if isinstance(scale, torch.Tensor):
        return scale.reshape(()).to(like.dtype)
    return like.new_full((), float(scale))


def defect_pass_plain(u_ds, f_ds, e, scale, h, C, c_zero, apply_bcs=False,
                      velocity_max=False, field_sumsq=False, r_out=None, rows=None,
                      cols=None):
    """Plain PyTorch version of K1; see ``defect_pass``.  C: the (2,) C
    pair or a ``c_source``, unused (None) when c_zero.  Returns (u', r,
    [sum r^2, max|du/dy|, max|du/dx|, sum u^2, r_rms])."""
    uh, ul = u_ds[0], u_ds[1]
    n_loc, m_loc = uh.shape
    rows = Rows.whole(n_loc) if rows is None else rows
    cols = Cols.whole(m_loc) if cols is None else cols
    if e is None:
        e = torch.zeros_like(uh)
    ph, pe = two_prod(e, _scale(scale, uh))
    uh, ul = ds_add(uh, ul, -ph, -pe)
    if apply_bcs:
        g = rows.global_rows(n_loc, uh.device)[:, None]
        zero = uh.new_zeros(())
        uh = torch.where(g == 0, uh.new_ones(()), torch.where(g == rows.ny - 1, zero, uh))
        ul = torch.where((g == 0) | (g == rows.ny - 1), zero, ul)
        uh, ul = bc.neumann_left_right(uh), bc.neumann_left_right(ul)
    inv_h2 = 1.0 / (float(h) * float(h))
    I = (slice(1, -1), slice(1, -1))
    up, dn, lf, rt = (slice(None, -2), slice(1, -1)), (slice(2, None), slice(1, -1)), \
        (slice(1, -1), slice(None, -2)), (slice(1, -1), slice(2, None))
    s1, e1 = two_sum(uh[up], uh[dn])
    s2, e2 = two_sum(uh[lf], uh[rt])
    sh_, e3 = two_sum(s1, s2)
    sl_ = ((e1 + e2) + e3) + ((ul[up] + ul[dn]) + (ul[lf] + ul[rt]))
    if c_zero:
        cuh, cul = uh[I] * 4.0, ul[I] * 4.0
    else:
        C = _c_pair(C, h, uh.device)
        cuh, cul = ds_mul_ds(uh[I], ul[I], C[0], C[1])
    th, tl = ds_add(sh_, sl_, -cuh, -cul)
    th, tl = th * inv_h2, tl * inv_h2
    rs, re = two_sum(th, -f_ds[0][I])
    if f_ds.shape[0] == 1:
        r_int = rs + (re + tl)
    else:
        r_int = rs + (re + (tl - f_ds[1][I]))
    interior = (rows.interior(n_loc, uh.device)[1:-1, None]
                & cols.interior(m_loc, uh.device)[None, 1:-1])
    r_int = torch.where(interior, r_int, r_int.new_zeros(()))
    r = torch.zeros_like(uh) if r_out is None else r_out.zero_()
    r[I] = r_int
    sums = r.new_zeros(5)
    own = (slice(*rows.own), slice(*cols.own))
    sums[0] = torch.sum((r * r)[own])
    if velocity_max:
        inv2h = 0.5 / float(h)
        m = interior & (rows.owned(n_loc, uh.device)[1:-1, None]
                        & cols.owned(m_loc, uh.device)[None, 1:-1])
        zero = r.new_zeros(())
        sums[1] = torch.amax(torch.where(m, torch.abs((uh[dn] - uh[up]) * inv2h), zero))
        sums[2] = torch.amax(torch.where(m, torch.abs((uh[rt] - uh[lf]) * inv2h), zero))
    if field_sumsq:
        sums[3] = torch.sum((uh * uh)[rows.owned_physical(n_loc), cols.owned_physical(m_loc)])
    sums[4] = torch.sqrt(sums[0] / sums.new_full((), float(n_loc * m_loc)))
    return torch.stack([uh, ul]), r, sums


_APPLY_BCS, _C_ZERO, _F_SINGLE, _VELOCITY_MAX, _FIELD_SUMSQ = 1, 2, 4, 8, 16
_C_VALUE, _C_PAIR, _C_SCALAR = 0, 1, 2


def _plan(t: torch.Tensor, ny: int, nx: int, cols: bool) -> tuple[int, int]:
    """(S, blocks) of a defect-kernel launch over (ny, nx) on t's card
    (``kernels.tile_plan``; S up to 3, which on an H100 was as fast as 4 at
    513 x 2049 and faster at 4097^2, PERF.md §6)."""
    return kernels.tile_plan(ny, nx, *kernels.card_fill("fpr_defect_fill", int(cols),
                                                          t.device.index), s_max=3)


def _launch_defect(u_ds, f_ds, e, C, scale, h, flags, hooks, u_out, r, out, plan):
    """One launch of the defect kernel (csrc/defect.cu) with plan = (S rows
    a thread, blocks): u' into u_out, r into r, and [sum r^2, max|du/dy|,
    max|du/dx|, sum u^2, r_rms] into out.  C: None (c = 0, the x4 path), a
    (2,) device C pair, a 0-dim device float32 c, or a (hi, lo) pair of
    Python floats.  hooks: (row_off, ny_g, own0, own1, col_off, nx_g, ownc0,
    ownc1)."""
    _, ny, nx = u_ds.shape
    if C is None or isinstance(C, tuple):
        kind, c_ptr, (c_hi, c_lo) = _C_VALUE, None, C or (0.0, 0.0)
    else:
        kind, c_ptr, c_hi, c_lo = (_C_PAIR if C.dim() else _C_SCALAR), C.data_ptr(), 0.0, 0.0
    S, blocks = plan
    partials = torch.empty(4 * blocks, dtype=torch.float32, device=u_ds.device)
    hh = float(h) * float(h)
    on_device = isinstance(scale, torch.Tensor)
    err = kernels.lib().fpr_defect(
        u_ds[0].data_ptr(), u_ds[1].data_ptr(), f_ds[0].data_ptr(),
        f_ds[1].data_ptr() if f_ds.shape[0] == 2 else None, kernels.ptr(e), c_ptr, kind,
        c_hi, c_lo, hh, 0.0 if on_device else float(scale),
        scale.data_ptr() if on_device else None, 1.0 / hh, 0.5 / float(h), float(nx * ny),
        ny, nx,
        flags, S, blocks, *hooks, u_out[0].data_ptr(), u_out[1].data_ptr(), r.data_ptr(),
        partials.data_ptr(), kernels.launch_counter(u_ds).data_ptr(), out.data_ptr(),
        kernels.stream(u_ds))
    kernels.check(err, "fpr_defect")


def _defect_cuda(u_ds, f_ds, e, scale, h, C, c_zero, apply_bcs=False,
                 velocity_max=False, field_sumsq=False, r_out=None, rows=None, cols=None):
    """K1 on the card (csrc/defect.cu), one launch and nothing else; see
    ``defect_pass`` and ``defect_pass_plain``.  C: the (2,) device C pair or
    a ``c_source`` (a (hi, lo) pair of floats, or a 0-dim device c from
    which the kernel derives the pair); unused when c_zero."""
    C = None if c_zero else C
    if isinstance(scale, torch.Tensor):
        scale = scale.reshape(()).to(torch.float32).contiguous()
    kernels.require_cuda_f32("defect_pass", u_ds, f_ds, e, r_out,
                             C if isinstance(C, torch.Tensor) else None,
                             scale if isinstance(scale, torch.Tensor) else None)
    _, ny, nx = u_ds.shape
    rows = Rows.whole(ny) if rows is None else rows
    cols = Cols.whole(nx) if cols is None else cols
    u_out = torch.empty_like(u_ds)
    r = torch.empty_like(u_ds[0]) if r_out is None else r_out
    out = u_ds.new_empty(5)
    flags = ((_APPLY_BCS if apply_bcs else 0) | (_C_ZERO if c_zero else 0)
             | (_F_SINGLE if f_ds.shape[0] == 1 else 0)
             | (_VELOCITY_MAX if velocity_max else 0) | (_FIELD_SUMSQ if field_sumsq else 0))
    _launch_defect(u_ds, f_ds, e, C, scale, h, flags, rows.args() + cols.args(), u_out, r,
                   out, _plan(u_ds, ny, nx, not cols.is_whole(nx)))
    kernels.launches["defect"] += 1
    return u_out, r, out


def _pass(u_ds, f_ds, e, scale, h, c, C, r_out, apply_bcs, velocity_max, field_sumsq,
          rows=None, raw_sumsq=False, cols=None):
    """The shared body of defect_pass and defect_pass_stk."""
    inv_h2 = 1.0 / (float(h) * float(h))
    if not _is_pow2(inv_h2):
        raise ValueError(f"1/h^2 = {inv_h2} must be a power of two (h = 1/2^k)")
    if f_ds.dim() != 3 or f_ds.shape[0] not in (1, 2):
        raise ValueError(f"f_ds must be (1|2, ny, nx), got {tuple(f_ds.shape)}")
    if rows is not None:
        rowhooks.check("defect_pass", rows, u_ds.shape[1])
    rowhooks.check_cols("defect_pass", cols, u_ds.shape[2], apply_bcs=apply_bcs)
    c_zero = not isinstance(c, torch.Tensor) and float(c) == 0.0
    if C is None and not c_zero:
        C = c_source(c, h)
    fn = defect_pass_plain if u_ds.device.type == "cpu" else _defect_cuda
    u_out, r, sums = fn(u_ds, f_ds, e, scale, h, C, c_zero, apply_bcs=apply_bcs,
                        velocity_max=velocity_max, field_sumsq=field_sumsq, r_out=r_out,
                        rows=rows, cols=cols)
    r_rms = sums[0] if raw_sumsq else sums[4]
    extras = (sums[1], sums[2], sums[3]) if velocity_max or field_sumsq else None
    return u_out, r, r_rms, extras


def defect_pass(u_ds, f_ds, e, scale, h, c, C=None, apply_bcs=False,
                velocity_max=False, field_sumsq=False, rows=None, raw_sumsq=False,
                cols=None):
    """K1: u' = u - scale*e (ds), [NS temperature BCs on u'], r = A u' - f
    (ds), sum(r_hi^2)  (ds.defect_pass).

    u_ds: (2, ny, nx) float32 hi/lo.  f_ds: (1, ny, nx) for an exactly
    float32 rhs (f_single) or (2, ny, nx).  e: (ny, nx) float32, or None for
    zero.  scale: a Python number, or a 0-dim float32 tensor on u's device
    (a step length computed there, read by the kernel: no host read).
    c: the Helmholtz shift, a Python number (0 takes the exact x4
    path) or a float32 tensor; C: its ``defect_scalars`` pair, if the caller
    has it already.  1/h^2 must be a power of two.

    Returns (u_ds', r, r_rms) with r_rms = sqrt(sum(r^2)/(nx ny)), plus
    (max|du'/dy|, max|du'/dx|, sum(u'_hi^2)) when velocity_max or
    field_sumsq (zeros where not asked for).  A CPU tensor runs the plain
    version, a CUDA tensor the kernel.

    rows: the row hooks of a row shard (``ops.rows.Rows``; None is one
    device).  raw_sumsq: return the (owned rows') sum(r^2) in place of
    r_rms, for the sharded solver to add across shards before it
    normalises by the global cell count.  cols: the column hooks of a
    2D-mesh shard (``ops.rows.Cols``; even offset, not with apply_bcs).
    """
    u_out, r, r_rms, extras = _pass(u_ds, f_ds, e, scale, h, c, C, None, apply_bcs,
                                    velocity_max, field_sumsq, rows, raw_sumsq, cols)
    return (u_out, r, r_rms) + (() if extras is None else (extras,))


def defect_pass_stk(u_ds, f_ds, L, scale, h, c, C=None, apply_bcs=False,
                    velocity_max=False, field_sumsq=False):
    """defect_pass on the (2, ny, nx) level state L = [e | rhs] of the
    stacked V-cycle (ds.defect_pass_stk): e = L[0], and the new defect is
    written into L[1], which the kernel does not read.  L[0] keeps the old
    correction and counts as unspecified: the next cycle starts from a
    zero iterate and never reads it.  Returns (u_ds', L, r_rms[, extras]).
    """
    u_out, _, r_rms, extras = _pass(u_ds, f_ds, L[0], scale, h, c, C, L[1], apply_bcs,
                                    velocity_max, field_sumsq)
    return (u_out, L, r_rms) + (() if extras is None else (extras,))
