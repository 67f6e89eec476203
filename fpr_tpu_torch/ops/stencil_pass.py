"""The stencil pass, TPU kernel #5 (fpr_tpu/ops/pallas2d.py: _stencil_kernel
and its wrappers smooth_rp, smooth2_rp, residual_rp, matvec_rp,
matvec_dot_rp, jacobi_step, residual, matvec).

One pass over an (ny, nx) field, with C = 4 + c h^2:

- ``smooth_rp``: one damped-Jacobi sweep u + alpha (h^2/C) res, res =
  (u_N + u_S + u_W + u_E - C u)/h^2 - f on the interior (0 on the
  boundary), with the rms of res;
- ``smooth2_rp``: two chained sweeps in one pass, the rms of the second's
  residual;
- ``residual_rp``: res;
- ``matvec_rp``: (nabla^2 - c) x = (x_N + x_S + x_W + x_E - 4 x)/h^2 - c x
  on the interior, optionally with sum(x * Ax);
- ``matvec_dot_rp``: sum(x * Ax) alone, writing no field (the PCG
  curvature, ``krylov.mg_pcg_ds(dots="kernel")``).

The operation order is the TPU kernel's, which differs from
``stencil2d``'s (``stencil2d.matvec`` takes split x/y second
differences).  c is a Python number or a 0-dim tensor; on the card it is
read by pointer, so a shift computed on the device costs no host read.

The port's arrays are physical, so the ``_rp`` functions keep the JAX
names but take and return (ny, nx) tensors: the row padding of the TPU
layout (``PAD`` ghost rows, columns to a multiple of ``LANE``) exists
only for Mosaic's tiling.  ``pad2d`` / ``unpad2d`` / ``pick_br`` convert
between that layout and physical tensors for callers that move operands
between the two packages.  ``jacobi_step``, ``residual`` and ``matvec``
are the JAX package's physical drop-ins (the PALLAS policy of
``mg_solve`` and ``cg``).

A CPU tensor runs the plain PyTorch version; a CUDA tensor (float32 or
float64) runs csrc/stencil.cu, one launch a call in every mode, or raises.
The kernel writes its sum (and the rms of a sum of res^2) to a device
buffer, so a call needs no host read and no second launch.
"""

from __future__ import annotations

import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.ops.stencil2d import as_scalar

MODES = {"smooth": 0, "residual": 1, "matvec": 2, "matvec_dot": 3, "smooth2": 4}

# the TPU row-padded layout (pallas2d.py:41-105)
PAD = 8
LANE = 128


def pick_br(ny: int, nx: int, itemsize: int) -> int:
    """Block rows of the TPU layout (pallas2d._pick_br): a multiple of 16
    within a 100 MB VMEM budget, balanced over the row blocks."""
    fit = int(100 * 1024 * 1024 / (8.5 * nx * itemsize)) - 2 * PAD
    br_max = min(512, max(16, (fit // 16) * 16))
    blocks = -(-ny // br_max)
    return min(br_max, -(-(-(-ny // blocks)) // 16) * 16)


def padded_rows(ny: int, br: int) -> int:
    return PAD + -(-ny // br) * br + PAD


def padded_cols(nx: int) -> int:
    return -(-nx // LANE) * LANE


def pad2d(a: torch.Tensor, br: int) -> torch.Tensor:
    """Physical (ny, nx) -> the TPU layout (padded_rows, padded_cols), zeros
    elsewhere (pallas2d.pad2d)."""
    ny, nx = a.shape
    out = a.new_zeros((padded_rows(ny, br), padded_cols(nx)))
    out[PAD:PAD + ny, :nx] = a
    return out


def unpad2d(ap: torch.Tensor, ny: int, nx: int | None = None) -> torch.Tensor:
    """The physical rows and columns of a TPU-layout array (pallas2d.unpad2d)."""
    nx = ap.shape[1] if nx is None else nx
    return ap[PAD:PAD + ny, :nx]


def _consts(h, like):
    """h^2 and 1/h^2 rounded to like's dtype (pallas2d.py:176-177)."""
    h = float(h)
    return like.new_full((), h * h), like.new_full((), 1.0 / (h * h))


def stencil_plain(mode: str, u, f, h, c, alpha=0.8, with_acc=True):
    """Plain PyTorch version of the kernel: (out or None, sums or None),
    sums = [acc, sqrt(acc / (ny nx))] with acc the sum of res^2 (smooth,
    smooth2, residual), or [acc] with acc the sum of u * Au (matvec,
    matvec_dot)."""
    c = as_scalar(c, u)
    if mode == "smooth2":
        u1, _ = stencil_plain("smooth", u, f, h, c, alpha, with_acc=False)
        return stencil_plain("smooth", u1, f, h, c, alpha, with_acc)
    h2, inv_h2 = _consts(h, u)
    I = (slice(1, -1), slice(1, -1))
    near = u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
    out = torch.zeros_like(u)
    if mode in ("matvec", "matvec_dot"):
        out[I] = (near - 4.0 * u[I]) * inv_h2 - c * u[I]
        sums = torch.sum(u * out)[None] if with_acc or mode == "matvec_dot" else None
        return (None if mode == "matvec_dot" else out), sums
    C = 4.0 + c * h2
    out[I] = (near - C * u[I]) * inv_h2 - f[I]
    if with_acc:
        acc = torch.sum(out * out)
        sums = torch.stack([acc, torch.sqrt(acc / acc.new_full((), float(u.numel())))])
    else:
        sums = None
    if mode == "smooth":
        out = u + (u.new_full((), float(alpha)) * (h2 / C)) * out
    return out, sums


def _plan(u, mode: str, with_acc: bool) -> tuple[int, int]:
    """(S, blocks) of a kernel launch over u on its card: S from
    ``kernels.tile_plan`` (the SMs and resident blocks of the kernel's
    form); with the sum as many blocks as the card holds at once, which
    take the tiles in turn (one partial a block), without it one block a
    tile.  On an H100 each was the faster for its modes at 513 x 2049,
    4097^2 and 2049^2 (PERF.md §6)."""
    ny, nx = u.shape
    variant = MODES[mode] * 4 + 2 * (u.dtype == torch.float64) + int(with_acc)
    S, blocks = kernels.tile_plan(ny, nx, *kernels.card_fill("fpr_stencil_fill", variant,
                                                              u.device.index))
    return S, (blocks if with_acc else kernels.n_tiles(ny, nx, S))


def _launch(mode, u, f, c, h, alpha, out, partials, sums, plan):
    """One launch of csrc/stencil.cu with plan = (S rows a thread, blocks):
    the field into out (None for matvec_dot), [acc] or [acc, rms] (see
    ``stencil_plain``) into sums, with the blocks' partials ((blocks,)
    scratch) in partials (both None without the sum)."""
    ny, nx = u.shape
    S, blocks = plan
    fn = kernels.lib().fpr_stencil_f64 if u.dtype == torch.float64 else \
        kernels.lib().fpr_stencil_f32
    counter = None if sums is None else kernels.launch_counter(u)
    h = float(h)
    err = fn(u.data_ptr(), kernels.ptr(f), c.data_ptr(), h * h, 1.0 / (h * h), float(alpha),
             float(ny * nx), ny, nx, MODES[mode], S, blocks, kernels.ptr(out),
             kernels.ptr(partials), kernels.ptr(counter), kernels.ptr(sums), kernels.stream(u))
    kernels.check(err, "fpr_stencil")


def _stencil_cuda(mode: str, u, f, h, c, alpha=0.8, with_acc=True):
    """The kernel on the card (csrc/stencil.cu), one launch and nothing
    else; see ``stencil_plain``."""
    c = as_scalar(c, u)
    kernels.require_cuda("stencil", (torch.float32, torch.float64), u, f, c)
    with_acc = with_acc or mode == "matvec_dot"
    S, blocks = _plan(u, mode, with_acc)
    out = None if mode == "matvec_dot" else torch.empty_like(u)
    sums = u.new_empty(1 if mode.startswith("matvec") else 2) if with_acc else None
    partials = u.new_empty(blocks) if with_acc else None
    _launch(mode, u, f, c, h, alpha, out, partials, sums, (S, blocks))
    kernels.launches["stencil"] += 1
    kernels.launches[f"stencil_{mode}"] += 1
    return out, sums


def _pass(mode, u, f, h, c, alpha=0.8, with_acc=False):
    if u.dim() != 2 or min(u.shape) < 3:
        raise ValueError(f"stencil pass: expected an (ny, nx) tensor, got {tuple(u.shape)}")
    if f is not None and f.shape != u.shape:
        raise ValueError(f"stencil pass: f {tuple(f.shape)} does not match u {tuple(u.shape)}")
    if u.device.type == "cpu":
        return stencil_plain(mode, u, f, h, c, alpha, with_acc)
    return _stencil_cuda(mode, u, f, h, c, alpha, with_acc)


def smooth_rp(u, f, h, c, alpha=0.8, with_norm=True):
    """One damped-Jacobi sweep (pallas2d.smooth_rp).  Returns (u', r_rms or
    None), r_rms = sqrt(sum(res^2)/(nx ny)) of the residual that fed it."""
    out, sums = _pass("smooth", u, f, h, c, alpha, with_norm)
    return out, (sums[1] if with_norm else None)


def smooth2_rp(u, f, h, c, alpha=0.8, with_norm=True):
    """Two chained sweeps in one pass (pallas2d.smooth2_rp); r_rms of the
    second's residual."""
    out, sums = _pass("smooth2", u, f, h, c, alpha, with_norm)
    return out, (sums[1] if with_norm else None)


def residual_rp(u, f, h, c):
    """res = (nabla^2 - c) u - f (pallas2d.residual_rp)."""
    return _pass("residual", u, f, h, c)[0]


def matvec_rp(x, h, c, with_dot=False):
    """(nabla^2 - c) x (pallas2d.matvec_rp); with_dot also returns
    sum(x * Ax)."""
    out, sums = _pass("matvec", x, None, h, c, with_acc=with_dot)
    return (out, sums[0]) if with_dot else out


def matvec_dot_rp(x, h, c):
    """sum(x * (nabla^2 - c) x) without writing Ax (pallas2d.matvec_dot_rp)."""
    return _pass("matvec_dot", x, None, h, c)[1][0]


# the physical drop-ins of the PALLAS policy (pallas2d.py:903-925)
residual = residual_rp
jacobi_step = smooth_rp


def matvec(x, hx, hy, c):
    """(nabla^2 - c) x; the kernel needs hx == hy."""
    if hx != hy:
        raise ValueError(f"the stencil pass needs hx == hy, got {hx} and {hy}")
    return matvec_rp(x, hx, c)
