"""The fine-level legs of the V-cycle: K2 and K3 of the stacked V-cycle
(fpr_tpu/ops/pallas2d.py: smooth2r_stk, corr_smooth2_stk) and #6 and #7 of
the row-padded one (pallas2d.smooth2r_split_rp, corr_smooth2_rp).

- ``smooth_down`` (K2, pallas2d.smooth2r_stk): ``ns`` damped-Jacobi sweeps
  u += alpha h^2/C res(u), then the residual res(u) to restrict.
- ``corr_up`` (K3, pallas2d.corr_smooth2_stk): u -= P(coarse correction),
  then ``ns`` sweeps, and the rms of the residual that fed the last sweep.
- ``smooth2r_split`` (#6) and ``corr_smooth2`` (#7): the same two legs for
  ``vcycle_rp``, with their own launch counters.  On the TPU they differ
  from K2/K3 only in buffer donation and DMA streams (separate u and f
  buffers, no aliasing; pallas2d.py:950-980); the port's legs read u and f
  from separate tensors anyway, so the four entry points launch the same
  CUDA code.  ``corr_smooth2`` takes the coarse correction itself and
  interpolates it in x here, as ``corr_smooth2_rp`` does.
- ``corr_smooth2_raw`` (#7, pallas2d.corr_smooth2_raw): the up leg on a
  prebuilt x-interleaved correction window, for the row-sharded V-cycle.

#6 and #7 take the shard hooks of the TPU kernels: the row hooks (row_off,
ny_mask; ``ops.rows.Rows``) of a row shard and the column hooks (col_off,
nx_mask; ``ops.rows.Cols``) of a 2D-mesh shard.  The interior follows the
global row and column, the local first and last rows and columns are never
interior, and a norm covers the owned cells.  Both offsets must be even
(the transfers' parity), and elim, which copies the local side columns,
takes whole columns.

res(u) = (u_N + u_S + u_W + u_E - C u)/h^2 - f on the interior and 0 on
the boundary, with C = 4 + c h^2.  The constants C, 1/h^2 and
w = alpha (h^2/C) go from Python floats to the working type at the same
points as in the TPU kernels, with c a runtime scalar tensor.  ``elim``
copies the side columns from their interior neighbours on every row after
each sweep, and in ``corr_up`` once before the first.  P is the coarse
correction interpolated in x first (``transfer.x_interleave_coarse``, done
by the caller), then in y: even fine rows take a coarse row, odd rows the
mean of two.

The port's arrays are physical (ny, nx) tensors.  The residual of
``smooth_down`` is plain, not parity-split; ``transfer.restrict`` of it
gives the values ``transfer.restrict_ps`` gives on the TPU.

The plain versions are dtype-generic (float32 and float64).  On the card
each call of the four entry points is one launch of the leg kernel
(csrc/vcycle_legs.cu: all ``ns`` sweeps on a tile in shared memory), in
float32, bitwise equal to the plain version; its output is never an input
(the TPU legs alias theirs onto the level state instead), and the up leg's
norm comes from one partial sum per block, the grid's size from
``leg_blocks``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.ops import rows as rowhooks
from fpr_tpu_torch.ops import transfer
from fpr_tpu_torch.ops.rows import Cols, Rows
from fpr_tpu_torch.ops.stencil2d import as_scalar

_DOWN, _DOWN_ZERO, _UP = 0, 1, 2  # fpr_leg's modes


def _consts(c, h, like):
    """(C, 1/h^2, w) in like's dtype, in the order of pallas2d.py:1080-1082."""
    c = as_scalar(c, like)
    h2 = like.new_full((), float(h) * float(h))
    C = 4.0 + c * h2
    return C, 1.0 / (float(h) * float(h)), h2 / C


def _hook_mask(res, rows, cols):
    """res with the cells that are not interior under the shard hooks
    zeroed (nothing to do on one device)."""
    if rows is None and cols is None:
        return res
    ny, nx = res.shape
    m = ((Rows.whole(ny) if rows is None else rows).interior(ny, res.device)[:, None]
         & (Cols.whole(nx) if cols is None else cols).interior(nx, res.device)[None, :])
    return torch.where(m, res, res.new_zeros(()))


def _residual(v, f, C, inv_h2, rows=None, cols=None):
    # the legs' operation order (pallas2d.py:1088-1095), not stencil2d's:
    # the kernels and the TPU legs round this way
    res = torch.zeros_like(v)
    res[1:-1, 1:-1] = (
        v[:-2, 1:-1] + v[2:, 1:-1] + v[1:-1, :-2] + v[1:-1, 2:] - C * v[1:-1, 1:-1]
    ) * inv_h2 - f[1:-1, 1:-1]
    return _hook_mask(res, rows, cols)


def _elim(v):
    v = v.clone()
    v[:, 0] = v[:, 1]
    v[:, -1] = v[:, -2]
    return v


def prolong_y(corrx: torch.Tensor, ny: int) -> torch.Tensor:
    """P: the x-interleaved coarse rows interpolated in y to ny rows (corrx
    has ny//2 + 1 rows)."""
    P = corrx.new_empty((ny, corrx.shape[1]))
    n_even, n_odd = (ny + 1) // 2, ny // 2
    P[0::2] = corrx[:n_even]
    P[1::2] = (corrx[:n_odd] + corrx[1:n_odd + 1]) * 0.5
    return P


def smooth_down_plain(u, f, h, c, alpha=0.8, ns=2, elim=False, rows=None, cols=None):
    """Plain PyTorch version of K2 and #6; see ``smooth_down`` and
    ``smooth2r_split``."""
    C, inv_h2, hc = _consts(c, h, f)
    w = f.new_full((), float(alpha)) * hc
    if u is None:
        r1 = torch.zeros_like(f)
        r1[1:-1, 1:-1] = -f[1:-1, 1:-1]
        v = w * _hook_mask(r1, rows, cols)
    else:
        v = u + w * _residual(u, f, C, inv_h2, rows, cols)
    if elim:
        v = _elim(v)
    for _ in range(ns - 1):
        v = v + w * _residual(v, f, C, inv_h2, rows, cols)
        if elim:
            v = _elim(v)
    return v, _residual(v, f, C, inv_h2, rows, cols)


def corr_up_plain(u, f, corrx, h, c, alpha=0.8, ns=2, elim=False,
                  with_norm=False, out=None, rows=None, cols=None):
    """Plain PyTorch version of K3 and #7; see ``corr_up`` and
    ``corr_smooth2_raw``."""
    C, inv_h2, hc = _consts(c, h, f)
    w = f.new_full((), float(alpha)) * hc
    v = u - prolong_y(corrx, u.shape[0])
    if elim:
        v = _elim(v)
    res = None
    for _ in range(ns):
        res = _residual(v, f, C, inv_h2, rows, cols)
        v = v + w * res
        if elim:
            v = _elim(v)
    if out is not None:
        out.copy_(v)
        v = out
    if not with_norm:
        return v, None
    ny, nx = res.shape
    rows = Rows.whole(ny) if rows is None else rows
    cols = Cols.whole(nx) if cols is None else cols
    n = res.new_full((), float(rows.ny * cols.nx))
    return v, torch.sqrt(torch.sum((res * res)[slice(*rows.own), slice(*cols.own)]) / n)


def _check(name, ns, f, rows=None, cols=None, elim=False):
    if not 1 <= ns <= 6:
        raise ValueError(f"{name}: ns must be in [1, 6], got {ns}")
    if f.dim() != 2 or min(f.shape) < 3:
        raise ValueError(f"{name}: expected an (ny, nx) tensor, got {tuple(f.shape)}")
    if rows is not None:
        rowhooks.check(name, rows, f.shape[0])
        if rows.off % 2:
            raise ValueError(f"{name}: the row offset {rows.off} must be even (the y "
                             "interpolation's row parity)")
    rowhooks.check_cols(name, cols, f.shape[1], elim=elim)


def _hooks(f, rows, cols):
    """The kernels' (row_off, ny_g, own0, own1, col_off, nx_g, ownc0, ownc1)."""
    ny, nx = f.shape
    return ((Rows.whole(ny) if rows is None else rows).args()
            + (Cols.whole(nx) if cols is None else cols).args())


@functools.lru_cache(maxsize=None)
def leg_blocks(up: bool, ns: int, ny: int, nx: int) -> int:
    """The blocks of a launch of the leg kernel over (ny, nx) with ns sweeps
    on this process's card: the length of the up leg's partials.  The grid
    is chosen in C (fpr_leg_blocks); the answer is kept per shape."""
    n = ctypes.c_int(0)
    kernels.check(kernels.lib().fpr_leg_blocks(int(up), ns, ny, nx, ctypes.byref(n)),
                  "fpr_leg_blocks")
    return n.value


def _launch_leg(mode, u, f, corrx, c, h, alpha, ns, elim, hooks, out, res, partials):
    """One launch of the leg kernel (csrc/vcycle_legs.cu): the down leg
    (mode _DOWN from u, _DOWN_ZERO from a zero iterate) into out and res,
    or the up leg (_UP) into out and partials (or None)."""
    ny, nx = f.shape
    h2 = float(h) * float(h)
    err = kernels.lib().fpr_leg(
        kernels.ptr(u), f.data_ptr(), kernels.ptr(corrx), c.data_ptr(), h2, 1.0 / h2,
        float(alpha), ny, nx, ns, mode, int(elim), *hooks, out.data_ptr(), kernels.ptr(res),
        kernels.ptr(partials), 0 if partials is None else partials.numel(), kernels.stream(f))
    kernels.check(err, "fpr_leg")


def _down_cuda(name, u, f, h, c, alpha, ns, elim, rows=None, cols=None):
    """The down leg on the card, one launch, counted as ``name``."""
    c = as_scalar(c, f)
    kernels.require_cuda_f32(name, u, f, c)
    out, res = torch.empty_like(f), torch.empty_like(f)
    _launch_leg(_DOWN_ZERO if u is None else _DOWN, u, f, None, c, h, alpha, ns, elim,
                _hooks(f, rows, cols), out, res, None)
    kernels.launches[name] += 1
    return out, res


def _smooth_down_cuda(u, f, h, c, alpha=0.8, ns=2, elim=False):
    """K2 on the card; see ``smooth_down``."""
    return _down_cuda("smooth_down", u, f, h, c, alpha, ns, elim)


def _smooth2r_split_cuda(u, f, h, c, alpha=0.8, ns=2, elim=False, rows=None, cols=None):
    """#6 on the card; see ``smooth2r_split``."""
    return _down_cuda("smooth2r_split", u, f, h, c, alpha, ns, elim, rows, cols)


def _up_cuda(name, u, f, corrx, h, c, alpha, ns, elim, with_norm, out, rows=None,
             cols=None):
    """The up leg on the card, one launch, counted as ``name``."""
    c = as_scalar(c, f)
    kernels.require_cuda_f32(name, u, f, corrx, c, out)
    if out is None:
        out = torch.empty_like(f)
    elif out.data_ptr() == u.data_ptr():
        raise ValueError(f"{name}: out must not alias u")
    ny, nx = f.shape
    partials = (torch.empty(leg_blocks(True, ns, ny, nx), dtype=torch.float32, device=f.device)
                if with_norm else None)
    hooks = _hooks(f, rows, cols)
    _launch_leg(_UP, u, f, corrx, c, h, alpha, ns, elim, hooks, out, None, partials)
    kernels.launches[name] += 1
    if not with_norm:
        return out, None
    return out, torch.sqrt(partials.sum() / float(hooks[5] * hooks[1]))


def _corr_up_cuda(u, f, corrx, h, c, alpha=0.8, ns=2, elim=False,
                  with_norm=False, out=None):
    """K3 on the card; see ``corr_up``."""
    return _up_cuda("corr_up", u, f, corrx, h, c, alpha, ns, elim, with_norm, out)


def _corr_smooth2_cuda(u, f, corrx, h, c, alpha=0.8, ns=2, elim=False,
                       with_norm=False, out=None, rows=None, cols=None):
    """#7 on the card; see ``corr_smooth2`` and ``corr_smooth2_raw``."""
    return _up_cuda("corr_smooth2", u, f, corrx, h, c, alpha, ns, elim, with_norm, out, rows,
                    cols)


def smooth_down(u, f, h, c, alpha=0.8, ns=2, elim=False):
    """K2, the down leg (pallas2d.smooth2r_stk).

    u: the (ny, nx) iterate, or None for a zero iterate (zero_u: the first
    sweep is the closed form w * (-f)).  f: the (ny, nx) rhs.  c: the
    shift, a Python number or a 0-dim tensor.  Returns (u', res) with u'
    after ``ns`` sweeps (1..6) and res its residual.  A CPU tensor runs the
    plain version, a CUDA tensor the kernel.
    """
    _check("smooth_down", ns, f)
    if f.device.type == "cpu":
        return smooth_down_plain(u, f, h, c, alpha, ns, elim)
    return _smooth_down_cuda(u, f, h, c, alpha, ns, elim)


def corr_up(u, f, corrx, h, c, alpha=0.8, ns=2, elim=False, with_norm=False,
            out=None):
    """K3, the up leg (pallas2d.corr_smooth2_stk).

    u: the (ny, nx) iterate after the down leg; corrx: the
    (ny//2 + 1, nx) x-interleaved coarse correction.  Writes
    u - P(corrx) after ``ns`` sweeps into ``out`` (a new tensor if None),
    which must not be u.  Returns (out, r_rms or None), r_rms the rms over
    all nx*ny cells of the residual that fed the last sweep.
    """
    _check("corr_up", ns, f)
    if corrx.shape != ((f.shape[0] - 1) // 2 + 1, f.shape[1]):
        raise ValueError(f"corrx {tuple(corrx.shape)} does not fit {tuple(f.shape)}")
    if out is not None and out.data_ptr() == u.data_ptr():
        raise ValueError("corr_up: out must not alias u")
    if f.device.type == "cpu":
        return corr_up_plain(u, f, corrx, h, c, alpha, ns, elim, with_norm, out)
    return _corr_up_cuda(u, f, corrx, h, c, alpha, ns, elim, with_norm, out)


def smooth2r_split(u, f, h, c, alpha=0.8, zero_u=False, ns=2, elim=False, rows=None,
                   cols=None):
    """#6, the down leg of ``vcycle_rp`` and of the sharded V-cycles
    (pallas2d.smooth2r_split_rp).  u: the (ny, nx) iterate, never read with
    zero_u (it may be None).  rows, cols: the row and column hooks of a
    shard's local cells (None: one device).  Returns (u', res) as
    ``smooth_down`` does; ``transfer.restrict`` of res is the TPU's
    ``restrict_ps`` of its parity-split residual.
    """
    _check("smooth2r_split", ns, f, rows, cols, elim)
    u = None if zero_u else u
    if f.device.type == "cpu":
        return smooth_down_plain(u, f, h, c, alpha, ns, elim, rows, cols)
    return _smooth2r_split_cuda(u, f, h, c, alpha, ns, elim, rows, cols)


def corr_smooth2(u, f, corr, h, c, alpha=0.8, apply_bcs=False, with_norm=False, ns=2,
                 elim=False):
    """#7, the up leg of ``vcycle_rp`` (pallas2d.corr_smooth2_rp, one
    device): u - P(corr), then ``ns`` sweeps.  corr: the coarse level's
    ((ny-1)/2+1, (nx-1)/2+1) correction, interpolated in x here (with the
    Neumann copies when apply_bcs) and in y by the kernel.  Returns
    (u', r_rms or None) in a new tensor.
    """
    _check("corr_smooth2", ns, f)
    corrx = transfer.x_interleave_coarse(corr, apply_bcs=apply_bcs)
    if corrx.shape != ((f.shape[0] - 1) // 2 + 1, f.shape[1]):
        raise ValueError(f"corr {tuple(corr.shape)} does not fit {tuple(f.shape)}")
    if f.device.type == "cpu":
        return corr_up_plain(u, f, corrx, h, c, alpha, ns, elim, with_norm)
    return _corr_smooth2_cuda(u, f, corrx, h, c, alpha, ns, elim, with_norm)


def corr_smooth2_raw(u, f, corrx, h, c, alpha=0.8, with_norm=False, ns=2, elim=False,
                     rows=None, cols=None):
    """#7 on a prebuilt correction window (pallas2d.corr_smooth2_raw): u -
    P(corrx), then ``ns`` sweeps, for the sharded V-cycles.

    u, f: a shard's local (n, m) cells; corrx: the (n//2 + 1, m)
    x-interleaved coarse correction whose row k is global coarse row
    rows.off/2 + k (with the shard's coarse halo rows; zeros past the
    global edge) and whose column x is the fine column of u's column x.
    Returns (u', r_rms or None) in a new tensor, r_rms over the owned
    cells' residual and the global ny*nx cells.
    """
    _check("corr_smooth2_raw", ns, f, rows, cols, elim)
    if corrx.shape != (f.shape[0] // 2 + 1, f.shape[1]):
        raise ValueError(f"corrx {tuple(corrx.shape)} does not fit {tuple(f.shape)}")
    if f.device.type == "cpu":
        return corr_up_plain(u, f, corrx, h, c, alpha, ns, elim, with_norm, rows=rows,
                             cols=cols)
    return _corr_smooth2_cuda(u, f, corrx, h, c, alpha, ns, elim, with_norm, rows=rows,
                              cols=cols)
