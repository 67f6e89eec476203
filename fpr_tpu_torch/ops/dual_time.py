"""Part 1's float32 pseudo-time kernel, counterpart of TPU kernels #8 and #10
(fpr_tpu/ops/pallas3d.py: _dual_time_kernel / dual_time_step_padded and
_dual_timek_stacked_kernel / dual_time_stepk_stacked).

One iteration on (nz, ny, nx) fields, x last:

    dHdtau = (Htau - Ht) (1/dt) - D nabla^2 Htau     (interior)
    Htau'  = Htau - dtau dHdtau                      (interior; faces copied)

with the Pallas kernels' operation order and their constants: 1/dx^2,
1/dy^2, 1/dz^2, 1/dt, D and dtau computed in float64 and rounded to the
field's dtype (pallas3d.py:223-249).  The JNP tier (``ops/stencil3d.py``)
divides by dt instead and rounds differently.

- ``dual_time_step``: one iteration and sum(dHdtau^2) (#8).
- ``dual_time_stepk``: K iterations and the LAST one's sum(dHdtau^2)
  (#10's function).  The kernel is launched K times over a ping-pong pair
  and forms the norm on the last launch only; the TPU kernel keeps the K
  sweeps on chip instead (see csrc/dual_time.cu).

A CPU tensor runs ``dual_time_step_plain``; a CUDA tensor the kernel
(csrc/dual_time.cu, float32 only) or an error.  The output is a buffer
other than the input, never the input itself: the TPU kernels alias their
output onto the input, which races across the card's blocks.  Callers in a
loop pass ``out``/``scratch`` and a ``kernels.partials_3d`` buffer, so that
nothing is allocated per call.

``pad3d``/``pad_ht``/``stack_state_k``/``unstack_state_k`` build the JAX
kernels' padded layouts in numpy, and ``state_from_jax``/``state_to_jax``
convert a state between those layouts and the port's physical tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from fpr_tpu_torch import kernels

# ---------------------------------------------------------------------------
# the iteration
# ---------------------------------------------------------------------------


def coeffs(dt, dtau, dx, dy, dz, D) -> tuple:
    """(1/dx^2, 1/dy^2, 1/dz^2, 1/dt, D, dtau) as float64 Python floats, in
    the kernel's argument order; each rounds to the field's dtype on use."""
    return (1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz), 1.0 / dt, float(D),
            float(dtau))


def dual_time_step_plain(Ht, Htau, cf, out=None):
    """Plain PyTorch version of the kernel: one iteration in its operation
    order.  cf: ``coeffs(...)``.  Writes ``out`` (a new tensor if None) and
    returns (out, sum(dHdtau^2) over the interior)."""
    inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau = (Htau.new_full((), v) for v in cf)
    I = (slice(1, -1),) * 3
    c = Htau[I]
    c2 = 2.0 * c
    lap = (((Htau[1:-1, 1:-1, 2:] - c2) + Htau[1:-1, 1:-1, :-2]) * inv_dx2
           + ((Htau[1:-1, 2:, 1:-1] - c2) + Htau[1:-1, :-2, 1:-1]) * inv_dy2
           + ((Htau[2:, 1:-1, 1:-1] - c2) + Htau[:-2, 1:-1, 1:-1]) * inv_dz2)
    dh = (c - Ht[I]) * inv_dt - D * lap
    out = torch.empty_like(Htau) if out is None else out
    out.copy_(Htau)
    out[I] = c - dtau * dh
    return out, torch.sum(dh * dh)


def dual_time_stepk_plain(Ht, Htau, K, cf, scratch=None):
    """K iterations of ``dual_time_step_plain`` over the pair (Htau,
    scratch), with the buffer use of ``dual_time_stepk``."""
    src, dst = Htau, torch.empty_like(Htau) if scratch is None else scratch
    for _ in range(K):
        dst, sumsq = dual_time_step_plain(Ht, src, cf, out=dst)
        src, dst = dst, src
    return src, sumsq


def _launch(Ht, Htau, cf, out, partials):
    nz, ny, nx = Htau.shape
    err = kernels.lib().fpr_dual_time(
        Ht.data_ptr(), Htau.data_ptr(), out.data_ptr(), kernels.ptr(partials),
        0 if partials is None else partials.numel(), *cf, nz, ny, nx, kernels.stream(Htau))
    kernels.check(err, "fpr_dual_time")


def _dual_time_cuda(Ht, Htau, cf, out=None, partials=None):
    """One iteration on the card (csrc/dual_time.cu); see ``dual_time_step``."""
    kernels.require_cuda_f32("dual_time_step", Ht, Htau, out, partials)
    out = torch.empty_like(Htau) if out is None else out
    partials = kernels.partials_3d(Htau.shape, Htau.device) if partials is None else partials
    _launch(Ht, Htau, cf, out, partials)
    kernels.launches["dual_time"] += 1
    return out, partials.sum()


def _dual_timek_cuda(Ht, Htau, K, cf, scratch=None, partials=None):
    """K launches on the card, the norm on the last; see ``dual_time_stepk``."""
    kernels.require_cuda_f32("dual_time_stepk", Ht, Htau, scratch, partials)
    src, dst = Htau, torch.empty_like(Htau) if scratch is None else scratch
    partials = kernels.partials_3d(Htau.shape, Htau.device) if partials is None else partials
    for j in range(K):
        _launch(Ht, src, cf, dst, partials if j == K - 1 else None)
        src, dst = dst, src
    kernels.launches["dual_timek"] += 1
    return src, partials.sum()


def _check(name, Ht, Htau, out):
    if Htau.dim() != 3 or min(Htau.shape) < 3:
        raise ValueError(f"{name}: expected an (nz, ny, nx) field, got {tuple(Htau.shape)}")
    if Ht.shape != Htau.shape or Ht.dtype != Htau.dtype:
        raise ValueError(f"{name}: Ht {tuple(Ht.shape)} {Ht.dtype} does not match Htau "
                         f"{tuple(Htau.shape)} {Htau.dtype}")
    if out is not None:
        if out.shape != Htau.shape or out.dtype != Htau.dtype:
            raise ValueError(f"{name}: output buffer {tuple(out.shape)} {out.dtype} does "
                             "not match Htau")
        if out.data_ptr() == Htau.data_ptr():
            raise ValueError(f"{name}: the output buffer must not be Htau")


def dual_time_step(Ht, Htau, dt, dtau, dx, dy, dz, D, *, out=None, partials=None):
    """One pseudo-time iteration (#8, pallas3d.dual_time_step_padded on the
    physical field).

    Writes Htau' into ``out`` (a new tensor if None; never Htau) and returns
    (out, sum(dHdtau^2) over the interior) as a 0-dim tensor.  partials: a
    ``kernels.partials_3d`` buffer to reuse on CUDA.
    """
    _check("dual_time_step", Ht, Htau, out)
    cf = coeffs(dt, dtau, dx, dy, dz, D)
    if Htau.device.type == "cpu":
        return dual_time_step_plain(Ht, Htau, cf, out)
    return _dual_time_cuda(Ht, Htau, cf, out, partials)


def dual_time_stepk(Ht, Htau, K, dt, dtau, dx, dy, dz, D, *, scratch=None, partials=None):
    """K pseudo-time iterations and the last one's sum(dHdtau^2) (#10,
    pallas3d.dual_time_stepk_stacked on physical fields).

    Iteration j reads what iteration j-1 wrote and writes the other of the
    pair (Htau, scratch): scratch for odd j, Htau for even j, so for K >= 2
    Htau is overwritten.  scratch None takes a new tensor.  Returns (the
    buffer of the last iteration, sumsq): scratch when K is odd, Htau when
    K is even.
    """
    if K < 1:
        raise ValueError(f"dual_time_stepk: K must be >= 1, got {K}")
    _check("dual_time_stepk", Ht, Htau, scratch)
    cf = coeffs(dt, dtau, dx, dy, dz, D)
    if Htau.device.type == "cpu":
        return dual_time_stepk_plain(Ht, Htau, K, cf, scratch)
    return _dual_timek_cuda(Ht, Htau, K, cf, scratch, partials)


# ---------------------------------------------------------------------------
# the JAX kernels' layouts (numpy)
# ---------------------------------------------------------------------------


def _pad_yx(ny: int, nx: int) -> tuple[int, int]:
    """y rounded up to 8 rows, x to 128 lanes (pallas3d._pad_yx)."""
    return -(-ny // 8) * 8, -(-nx // 128) * 128


def _pad(H, z_ghosts: int):
    nz, ny, nx = H.shape
    ny8, nx128 = _pad_yx(ny, nx)
    return np.pad(H, ((z_ghosts, z_ghosts), (0, ny8 - ny), (0, nx128 - nx)))


def pad3d(H: np.ndarray) -> np.ndarray:
    """Physical (nz, ny, nx) -> the padded Htau (nz+2, ny8, nx128) with zero
    ghosts (pallas3d.pad3d)."""
    return _pad(H, 1)


def pad_ht(H: np.ndarray) -> np.ndarray:
    """Physical Ht -> the tile-padded (nz, ny8, nx128) (pallas3d.pad_ht)."""
    return _pad(H, 0)


def stack_state_k(Ht: np.ndarray, Htau: np.ndarray, K: int = 3) -> np.ndarray:
    """Physical Ht, Htau -> the stacked K-state (2, nz+2K, ny8, nx128), plane
    set 0 Htau and 1 Ht (pallas3d.stack_state_k)."""
    return np.stack([_pad(Htau, K), _pad(Ht, K)])


def unstack_state_k(state: np.ndarray, shape, K: int = 3) -> np.ndarray:
    """The stacked K-state -> physical Htau (pallas3d.unstack_state_k)."""
    nz, ny, nx = shape
    return state[0, K:K + nz, :ny, :nx]


def state_from_jax(a, shape, layout: str = "pad3d", K: int = 3):
    """A JAX kernel state (a numpy array) as the port's physical CPU tensors.

    layout "pad3d": a ``pad3d`` Htau -> (nz, ny, nx); "pad_ht": a ``pad_ht``
    Ht -> (nz, ny, nx); "stacked": a ``stack_state_k`` state -> (Ht, Htau).
    Only physical cells are read, never ghost planes or tile padding.
    """
    a = np.asarray(a)
    nz, ny, nx = shape
    as_t = lambda v: torch.tensor(np.ascontiguousarray(v))  # noqa: E731
    if layout == "pad3d":
        return as_t(a[1:1 + nz, :ny, :nx])
    if layout == "pad_ht":
        return as_t(a[:nz, :ny, :nx])
    if layout == "stacked":
        return as_t(a[1, K:K + nz, :ny, :nx]), as_t(unstack_state_k(a, shape, K))
    raise ValueError(f"unknown layout {layout!r}")


def state_to_jax(H, layout: str = "pad3d", K: int = 3) -> np.ndarray:
    """The port's physical tensors as a JAX kernel state (numpy): "pad3d" and
    "pad_ht" take one (nz, ny, nx) tensor, "stacked" the pair (Ht, Htau)."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    if layout == "pad3d":
        return pad3d(host(H))
    if layout == "pad_ht":
        return pad_ht(host(H))
    if layout == "stacked":
        return stack_state_k(host(H[0]), host(H[1]), K)
    raise ValueError(f"unknown layout {layout!r}")
