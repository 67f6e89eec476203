"""Part 1's double-single pseudo-time kernel, counterpart of TPU kernel #11
(fpr_tpu/ops/ds3d.py: _ds3d_kernel, dual_time_step_ds_padded, to_ds_padded,
from_ds_padded, pad3d_ds).

The float32 iteration of ``ops/dual_time.py`` on ~48-bit double-single
state, for tolerances below the float32 floor (down to 1e-10 at 128^3 in
the reference's work-precision sweep):

    dHdtau = (Htau - Ht)/dt - D lap(Htau)     (ds arithmetic, interior)
    Htau'  = Htau - dtau dHdtau               (ds; faces copied)
    sumsq  = sum(dHdtau_hi^2)                 (float32)

State is a (2, nz, ny, nx) float32 tensor, hi then lo.  The constants
1/dt, D/dx^2, D/dy^2, D/dz^2 and dtau are ds pairs split from float64 on
the host (``ds.f32_pair``), so a spacing like 10/127 keeps full precision.
The operation order is the JAX kernel's (ds3d.py:120-182).

A CPU tensor runs ``ds3d_step_plain``; a CUDA tensor the kernel
(csrc/ds3d.cu) or an error.  ``dual_time_step_ds_pair`` iterates on a
ping-pong pair of states, the side read picked by the loop's count, and
the pseudo-time loop's test (``dual_time.LoopTest``) follows the
iteration, in the kernel's launch on the card (its tested form), as
``dual_time.dual_time_step_pair``'s does.  As in ``ops/dual_time.py`` the
output is a buffer other than the input.

``to_ds_padded``/``from_ds_padded``/``pad3d_ds`` build the JAX kernel's
padded ds layout in numpy, and ``state_from_jax``/``state_to_jax`` convert
between it and the port's pairs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.ops.dual_time import _pad_yx, _require_test, pair_step_plain
from fpr_tpu_torch.ops.ds import ds_add, ds_mul_ds, f32_pair, two_sum


def to_ds(H: torch.Tensor) -> torch.Tensor:
    """A float64 (nz, ny, nx) field -> its (2, nz, ny, nx) float32 hi/lo pair
    (ds3d.to_ds_padded without the padding); hi + lo == H to ~2^-48."""
    hi = H.float()
    return torch.stack([hi, (H - hi.double()).float()])


def from_ds(H_ds: torch.Tensor) -> torch.Tensor:
    """A hi/lo pair -> float64 hi + lo."""
    return H_ds[0].double() + H_ds[1].double()


def ds_coeffs(dt, dtau, dx, dy, dz, D) -> tuple:
    """The (hi, lo) pairs of 1/dt, D/dx^2, D/dy^2, D/dz^2 and dtau, split from
    float64 as ds3d._build_ds3d does: ten floats in the kernel's order."""
    return (*f32_pair(1.0 / dt), *f32_pair(D / (dx * dx)), *f32_pair(D / (dy * dy)),
            *f32_pair(D / (dz * dz)), *f32_pair(dtau))


_I = (slice(1, -1),) * 3
_NB = {  # (plus, minus) neighbour windows of the interior, per axis
    "z": ((slice(2, None), slice(1, -1), slice(1, -1)),
          (slice(None, -2), slice(1, -1), slice(1, -1))),
    "y": ((slice(1, -1), slice(2, None), slice(1, -1)),
          (slice(1, -1), slice(None, -2), slice(1, -1))),
    "x": ((slice(1, -1), slice(1, -1), slice(2, None)),
          (slice(1, -1), slice(1, -1), slice(None, -2))),
}


def ds3d_step_plain(Ht_ds, Htau_ds, cp, out=None):
    """Plain PyTorch version of the kernel: one ds iteration in its operation
    order.  cp: ``ds_coeffs(...)``.  Writes ``out`` (a new tensor if None)
    and returns (out, sum(dHdtau_hi^2) over the interior)."""
    idt_h, idt_l, bx_h, bx_l, by_h, by_l, bz_h, bz_l, dtau_h, dtau_l = (
        Htau_ds.new_full((), v) for v in cp)
    uh, ul = Htau_ds[0], Htau_ds[1]
    ch, cl = uh[_I], ul[_I]

    def second_diff(axis):
        p, m = _NB[axis]
        s, e1 = two_sum(uh[p], uh[m])
        t, e2 = two_sum(s, -2.0 * ch)
        return t, (e1 + e2) + ((ul[p] + ul[m]) - 2.0 * cl)

    ddz, ddy, ddx = second_diff("z"), second_diff("y"), second_diff("x")
    lap = ds_mul_ds(*ddx, bx_h, bx_l)
    lap = ds_add(*lap, *ds_mul_ds(*ddy, by_h, by_l))
    lap = ds_add(*lap, *ds_mul_ds(*ddz, bz_h, bz_l))
    s, e = two_sum(ch, -Ht_ds[0][_I])
    term = ds_mul_ds(s, e + (cl - Ht_ds[1][_I]), idt_h, idt_l)
    dh_h, dh_l = ds_add(*term, -lap[0], -lap[1])
    ph, pe = ds_mul_ds(dh_h, dh_l, dtau_h, dtau_l)
    nh, nl = ds_add(ch, cl, -ph, -pe)
    out = torch.empty_like(Htau_ds) if out is None else out
    out.copy_(Htau_ds)
    out[0][_I] = nh
    out[1][_I] = nl
    return out, torch.sum(dh_h * dh_h)


def _launch_ds(Ht_ds, Htau_ds, cp, out, partials, test=None):
    """One launch of #11 (its tested form when test, a
    ``kernels.LoopTestArgs``, is given, with (Htau_ds, out) the ping-pong
    pair); the buffers as the callers make them."""
    _, nz, ny, nx = Htau_ds.shape
    err = kernels.lib().fpr_ds3d(
        Ht_ds.data_ptr(), Htau_ds.data_ptr(), out.data_ptr(), partials.data_ptr(),
        partials.numel(), *cp, nz, ny, nx, None if test is None else ctypes.addressof(test),
        kernels.stream(Htau_ds))
    kernels.check(err, "fpr_ds3d")
    kernels.launches["ds3d"] += 1


def _ds3d_cuda(Ht_ds, Htau_ds, cp, out=None, partials=None):
    """One ds iteration on the card (csrc/ds3d.cu); see ``dual_time_step_ds``."""
    kernels.require_cuda_f32("dual_time_step_ds", Ht_ds, Htau_ds, out, partials)
    out = torch.empty_like(Htau_ds) if out is None else out
    if partials is None:
        partials = kernels.partials_3d(Htau_ds.shape[1:], Htau_ds.device)
    _launch_ds(Ht_ds, Htau_ds, cp, out, partials)
    return out, partials.sum()


def _ds3d_pair_cuda(Ht_ds, pair, cp, test, partials=None):
    """#11's tested form: one ds iteration on the pair, the side read picked
    by the count in the launch, and the loop test finished there; see
    ``dual_time_step_ds_pair``.  The sum lands in a new 0-dim tensor."""
    kernels.require_cuda_f32("dual_time_step_ds_pair", Ht_ds, pair[0], pair[1], partials)
    _require_test("dual_time_step_ds_pair", test)
    if partials is None:
        partials = kernels.partials_3d(Ht_ds.shape[1:], Ht_ds.device)
    sumsq = torch.empty((), dtype=torch.float32, device=Ht_ds.device)
    _launch_ds(Ht_ds, pair[0], cp, pair[1], partials, kernels.loop_test_args(Ht_ds, sumsq, test))
    return pair, sumsq


def _check_ds(name, Ht_ds, Htau_ds, out):
    if Htau_ds.dim() != 4 or Htau_ds.shape[0] != 2 or min(Htau_ds.shape[1:]) < 3:
        raise ValueError(f"{name}: expected a (2, nz, ny, nx) pair, got "
                         f"{tuple(Htau_ds.shape)}")
    if Htau_ds.dtype != torch.float32:
        raise ValueError(f"{name}: ds pairs are float32, got {Htau_ds.dtype}")
    for what, t in (("Ht_ds", Ht_ds), ("out", out)):
        if t is not None and (t.shape != Htau_ds.shape or t.dtype != torch.float32):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype} does not match "
                             "Htau_ds")
    if out is not None and out.data_ptr() == Htau_ds.data_ptr():
        raise ValueError(f"{name}: the output buffer must not be Htau_ds")


def dual_time_step_ds(Ht_ds, Htau_ds, dt, dtau, dx, dy, dz, D, *, out=None, partials=None):
    """One ds pseudo-time iteration (#11, ds3d.dual_time_step_ds_padded on
    physical pairs).

    Ht_ds, Htau_ds: (2, nz, ny, nx) float32 hi/lo.  Writes Htau' into
    ``out`` (a new tensor if None; never Htau_ds) and returns (out,
    sum(dHdtau_hi^2) over the interior, float32).  partials: a
    ``kernels.partials_3d`` buffer over (nz, ny, nx) to reuse on CUDA.
    """
    _check_ds("dual_time_step_ds", Ht_ds, Htau_ds, out)
    cp = ds_coeffs(dt, dtau, dx, dy, dz, D)
    if Htau_ds.device.type == "cpu":
        return ds3d_step_plain(Ht_ds, Htau_ds, cp, out)
    return _ds3d_cuda(Ht_ds, Htau_ds, cp, out, partials)


def dual_time_step_ds_pair(Ht_ds, pair, dt, dtau, dx, dy, dz, D, *, test, partials=None):
    """One ds pseudo-time iteration on a ping-pong pair of (2, nz, ny, nx)
    hi/lo states and the loop test after it (#11's tested form): reads
    pair[test.it & 1], writes pair[(test.it + 1) & 1], as
    ``dual_time.dual_time_step_pair`` does (pair: a (2, 2, nz, ny, nx)
    tensor, two states).  Returns (pair,
    sum(dHdtau_hi^2) over the interior, float32).
    """
    if pair.dim() != 5 or pair.shape[0] != 2:
        raise ValueError(f"dual_time_step_ds_pair: expected a (2, 2, nz, ny, nx) pair, got "
                         f"{tuple(pair.shape)}")
    _check_ds("dual_time_step_ds_pair", Ht_ds, pair[0], pair[1])
    cp = ds_coeffs(dt, dtau, dx, dy, dz, D)
    if Ht_ds.device.type == "cpu":
        return pair_step_plain(lambda src: ds3d_step_plain(Ht_ds, src, cp), pair, test)
    return _ds3d_pair_cuda(Ht_ds, pair, cp, test, partials)


# ---------------------------------------------------------------------------
# the JAX kernel's layout (numpy)
# ---------------------------------------------------------------------------


def pad3d_ds(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(nz, ny, nx) hi/lo -> (2, nz+2, ny8, nx128) with zero ghosts and
    padding (ds3d.pad3d_ds)."""
    nz, ny, nx = hi.shape
    ny8, nx128 = _pad_yx(ny, nx)
    pads = ((1, 1), (0, ny8 - ny), (0, nx128 - nx))
    return np.stack([np.pad(hi, pads), np.pad(lo, pads)])


def to_ds_padded(H: np.ndarray) -> np.ndarray:
    """float64 physical field -> the JAX ds-padded state (ds3d.to_ds_padded)."""
    hi = H.astype(np.float32)
    return pad3d_ds(hi, (H - hi.astype(H.dtype)).astype(np.float32))


def from_ds_padded(Hds: np.ndarray, shape, dtype=np.float64) -> np.ndarray:
    """The physical field of a ds-padded state in dtype, read from interior
    planes only: kernel outputs leave the z-ghost planes unspecified
    (ds3d.from_ds_padded)."""
    nz, ny, nx = shape
    return (Hds[0, 1:1 + nz, :ny, :nx].astype(dtype)
            + Hds[1, 1:1 + nz, :ny, :nx].astype(dtype))


def state_from_jax(a, shape, layout: str = "padded") -> torch.Tensor:
    """A JAX ds state (numpy) as the port's (2, nz, ny, nx) CPU pair.

    layout "padded": the (2, nz+2, ny8, nx128) Htau state, read from its
    interior planes only; "ht": the solve's Ht view ``state[:, 1:1+nz]``,
    (2, nz, ny8, nx128).
    """
    a = np.asarray(a)
    nz, ny, nx = shape
    if layout == "padded":
        a = a[:, 1:1 + nz]
    elif layout != "ht":
        raise ValueError(f"unknown layout {layout!r}")
    return torch.tensor(np.ascontiguousarray(a[:, :nz, :ny, :nx]))


def state_to_jax(H_ds: torch.Tensor, layout: str = "padded") -> np.ndarray:
    """The port's pair as a JAX ds state: "padded" (zero ghosts) or "ht"."""
    hi, lo = (t.detach().cpu().numpy() for t in H_ds)
    padded = pad3d_ds(hi, lo)
    if layout == "padded":
        return padded
    if layout == "ht":
        return padded[:, 1:1 + hi.shape[0]]
    raise ValueError(f"unknown layout {layout!r}")
