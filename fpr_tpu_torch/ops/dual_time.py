"""Part 1's float32 pseudo-time kernel, counterpart of TPU kernels #8, #9 and
#10 (fpr_tpu/ops/pallas3d.py: _dual_time_kernel / dual_time_step_padded,
_dual_timek_kernel / dual_time_stepk_padded and _dual_timek_stacked_kernel /
dual_time_stepk_stacked).

One iteration on (nz, ny, nx) fields, x last:

    dHdtau = (Htau - Ht) (1/dt) - D nabla^2 Htau     (interior)
    Htau'  = Htau - dtau dHdtau                      (interior; faces copied)

with the Pallas kernels' operation order and their constants: 1/dx^2,
1/dy^2, 1/dz^2, 1/dt, D and dtau computed in float64 and rounded to the
field's dtype (pallas3d.py:223-249).  The JNP tier (``ops/stencil3d.py``)
divides by dt instead and rounds differently.

- ``dual_time_step``: one iteration and sum(dHdtau^2) (#8).
- ``dual_time_step_pair``: one iteration on a ping-pong pair, reading the
  side that the loop's count picks and writing the other, and the
  pseudo-time loop's test after it (a ``LoopTest``: err, the iteration
  count, the loop's predicate), finished in the kernel's launch on the
  card (its tested form) and by ``pair_step_plain`` on the CPU.
  ``loop_test_plain`` is also the test of the tiers without a tested form
  (JNP, #10).
- ``dual_time_stepk``: K iterations and the LAST one's sum(dHdtau^2)
  (#10's function).  On the card it runs the K-sweep kernel
  (csrc/dual_timek.cu), which keeps the intermediate sweeps on chip, once
  per pass of at most ``kernels.K_MAX`` sweeps (``split_passes``).
- ``dual_time_box``: one iteration over a window of planes with #8's
  update box, for the sharded tier's ghost-padded blocks: the cells inside
  the inclusive box are updated, the others copied, and the sums of
  dHdtau^2 come back as per-window partials (per block on the card, per
  plane on the CPU) that ``.sum()`` turns into the norm.  The
  single-device calls above are the box (1, n-2) on every axis.
- ``dual_time_stepk_padded``: K iterations on a K-deep z-ghost-padded
  shard block (#9): sweep j updates the owned planes and K-j ghost planes
  on each side inside the z-bounds, so one K-plane halo exchange feeds K
  iterations; the norm is the last sweep's over the owned planes.  On the
  card, the K-sweep kernel, once per pass as for #10.

A CPU tensor runs the plain PyTorch versions; a CUDA tensor the kernels
(csrc/dual_time.cu and csrc/dual_timek.cu, float32 only) or an error.  The
output is a buffer other than the input, never the input itself: the TPU
kernels alias their output onto the input, which races across the card's
blocks.  The K-sweep calls write their result into ``scratch`` and leave
their input unwritten, on both devices (passes or sweeps beyond the first
pair go through a temporary buffer).  Callers in a loop pass
``out``/``scratch`` and a partials buffer (``kernels.partials_3d`` for
one iteration, ``fused_partials`` for K), so that nothing is allocated per
call.

``pad3d``/``pad_ht``/``stack_state_k``/``unstack_state_k`` build the JAX
kernels' padded layouts in numpy, and ``state_from_jax``/``state_to_jax``
convert a state between those layouts and the port's physical tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

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


@dataclasses.dataclass(frozen=True)
class LoopTest:
    """The pseudo-time loop's test after a pass of its body: err =
    sqrt(sumsq) dt / sqrt_n, it plus the pass's iterations, and go = (err >
    tol) & (it < iter_max), written into the 0-dim buffers err (the sum's
    dtype), it and go (int32) of the loop's carry.  dt, sqrt_n and tol are
    the tested kernels' arguments, rounded there to float32; ``consts``
    holds them as 0-dim tensors of err's dtype and device, the plain test's.
    Make them with ``loop_test``."""
    err: torch.Tensor
    it: torch.Tensor
    go: torch.Tensor
    dt: float
    sqrt_n: float
    tol: float
    iter_max: int
    consts: tuple


def loop_test(like, dt, sqrt_n, tol, iter_max):
    """The LoopTest maker of a loop on like's dtype and device:
    ``make(err, it, go)`` on the carry's buffers.  The plain test's
    constants are made here, once, so that a body captured in a graph makes
    none a pass."""
    consts = tuple(like.new_full((), float(v)) for v in (dt, sqrt_n, tol))
    return functools.partial(LoopTest, dt=dt, sqrt_n=sqrt_n, tol=tol, iter_max=iter_max,
                             consts=consts)


def loop_go(test: LoopTest) -> None:
    """The loop's predicate from test's err and it, into its go."""
    torch.logical_and(test.err > test.consts[2], test.it < test.iter_max, out=test.go)


def loop_test_plain(result, test: LoopTest, iters: int = 1):
    """The loop test of a pass's result (out, sumsq) that made ``iters``
    iterations, in torch's operations and in the tested kernels' order:
    sqrt, times dt, over sqrt_n, then it + iters and the predicate; returns
    result."""
    dt, sqrt_n, _ = test.consts
    torch.div(torch.sqrt(result[1]).mul_(dt), sqrt_n, out=test.err)
    test.it.add_(iters)
    loop_go(test)
    return result


def pair_step_plain(step, pair, test: LoopTest):
    """The plain version of a tested step on a ping-pong pair (a (2, ...)
    tensor): step(src) -> (Htau', sumsq) on pair[test.it & 1], Htau' put
    into pair[(test.it + 1) & 1], then ``loop_test_plain``.  The sides are
    picked on the device (a gather and a scatter indexed by the count), so
    that a graph replays it with no host read.  Returns (pair, sumsq)."""
    side = (test.it & 1).reshape(1).long()
    new, sumsq = step(pair.index_select(0, side)[0])
    pair.index_copy_(0, 1 - side, new[None])
    loop_test_plain((pair, sumsq), test)
    return pair, sumsq


def _require_test(name, test: LoopTest) -> None:
    kernels.require_cuda_f32(name, test.err)
    kernels.require_cuda(name, (torch.int32,), test.it, test.go)
    if any(t.numel() != 1 for t in (test.err, test.it, test.go)):
        raise ValueError(f"{name}: the loop test's err, it and go are one-element tensors")


def dual_time_step_plain(Ht, Htau, cf, out=None):
    """Plain PyTorch version of the kernel: one iteration, the boxed launch
    of ``dual_time_box_plain`` with the box (1, n-2) on every axis over
    every plane.  cf: ``coeffs(...)``.  Writes ``out`` (a new tensor if
    None) and returns (out, sum(dHdtau^2) over the interior) as one
    torch.sum, not a sum of per-plane partials: the single-device tiers'
    iteration counts on the CPU are held to the JAX package's with this
    order."""
    out = torch.empty_like(Htau) if out is None else out
    dh = dual_time_box_plain(Ht, Htau, cf, interior_box(Htau.shape), (0, Htau.shape[0] - 1), out)
    return out, torch.sum(dh * dh)


def dual_time_stepk_plain(Ht, Htau, K, cf, scratch=None):
    """K iterations of ``dual_time_step_plain``, with the buffer contract of
    ``dual_time_stepk``: the result in scratch, Htau not written."""
    scratch = torch.empty_like(Htau) if scratch is None else scratch
    sumsq = _chain(K, Htau, scratch,
                   lambda m, src, dst: dual_time_step_plain(Ht, src, cf, out=dst)[1])
    return scratch, sumsq


def split_passes(K: int) -> list[int]:
    """K sweeps as consecutive fused passes of at most ``kernels.K_MAX``
    sweeps each, as even as possible, the longer first: 5 -> [3, 2],
    8 -> [4, 4]."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    n = -(-K // kernels.K_MAX)
    q, r = divmod(K, n)
    return [q + 1] * r + [q] * (n - r)


def _chain(n, src, dst, stage):
    """n stages from src into dst that never write src: stage(m, s, d)
    reads s and writes d.  The last stage writes dst; going back from it
    the stages alternate with a temporary buffer.  Returns the last stage's
    value."""
    tmp = torch.empty_like(dst) if n > 1 else None
    for m in range(n):
        d = dst if (n - 1 - m) % 2 == 0 else tmp
        out = stage(m, src, d)
        src = d
    return out


def _fused_passes(K, src, dst, launch):
    """K sweeps as the passes of ``split_passes``: launch(s, d, a, k, last)
    makes sweeps a+1..a+k from s into d, the norm when last; see
    ``_chain``."""
    ks = split_passes(K)
    first = np.cumsum([0] + ks[:-1])
    _chain(len(ks), src, dst,
           lambda m, s, d: launch(s, d, int(first[m]), ks[m], m == len(ks) - 1))


def _zboxes(nz, K, a, k, z_bounds=None):
    """The z boxes of sweeps a+1..a+k of K: the interior on every sweep for
    #10 (z_bounds None); for #9 sweep j's window (j, nz-1-j) clipped to the
    local z_bounds, shifted by the K ghost planes."""
    if z_bounds is None:
        return [(1, nz - 2)] * k
    zb0, zb1 = z_bounds
    return [(max(zb0 + K, j), min(zb1 + K, nz - 1 - j)) for j in range(a + 1, a + k + 1)]


def fused_partials(Htau, n_out: int, K: int) -> torch.Tensor:
    """The partials buffer of a K-sweep call whose last pass writes n_out
    planes of Htau's (ny, nx): per block (float32) on the card, per plane
    (Htau's dtype, #9's plain version) on the CPU.  Every entry is written
    by the call: no zeroing needed."""
    _, ny, nx = Htau.shape
    if Htau.device.type == "cpu":
        return Htau.new_zeros(n_out)
    n = ctypes.c_int(0)
    with torch.cuda.device(Htau.device):
        err = kernels.lib().fpr_dual_timek_blocks(split_passes(K)[-1], n_out, ny, nx,
                                                   ctypes.byref(n))
    kernels.check(err, "fpr_dual_timek_blocks")
    return torch.empty(n.value, dtype=torch.float32, device=Htau.device)


def interior_box(shape) -> tuple:
    """The update box of a single device: every interior cell."""
    nz, ny, nx = shape
    return (1, nz - 2, 1, ny - 2, 1, nx - 2)


def _launch(Ht, Htau, cf, out, partials, box=None, window=None, test=None):
    nz, ny, nx = Htau.shape
    w0, w1 = (0, nz - 1) if window is None else window
    box = interior_box(Htau.shape) if box is None else box
    err = kernels.lib().fpr_dual_time(
        Ht.data_ptr(), Htau.data_ptr(), out.data_ptr(), kernels.ptr(partials),
        0 if partials is None else partials.numel(), *cf, nz, ny, nx, w0, w1 - w0 + 1,
        *box, None if test is None else ctypes.addressof(test), kernels.stream(Htau))
    kernels.check(err, "fpr_dual_time")


def _dual_time_cuda(Ht, Htau, cf, out=None, partials=None):
    """One iteration on the card: the boxed launch with the interior box over
    every plane; see ``dual_time_step``."""
    out = torch.empty_like(Htau) if out is None else out
    partials = kernels.partials_3d(Htau.shape, Htau.device) if partials is None else partials
    _dual_time_box_cuda(Ht, Htau, cf, interior_box(Htau.shape), (0, Htau.shape[0] - 1), out,
                        partials)
    return out, partials.sum()


def _dual_time_pair_cuda(Ht, pair, cf, test, partials=None):
    """#8's tested form: one iteration on the pair, the side read picked by
    the count in the launch, and the loop test finished there; see
    ``dual_time_step_pair``.  The sum lands in a new 0-dim tensor."""
    kernels.require_cuda_f32("dual_time_step_pair", Ht, pair[0], pair[1], partials)
    _require_test("dual_time_step_pair", test)
    partials = kernels.partials_3d(Ht.shape, Ht.device) if partials is None else partials
    sumsq = torch.empty((), dtype=torch.float32, device=Ht.device)
    _launch(Ht, pair[0], cf, pair[1], partials, test=kernels.loop_test_args(Ht, sumsq, test))
    kernels.launches["dual_time"] += 1
    return pair, sumsq


def _launch_k(Ht, src, cf, out, partials, zboxes, planes, ht_shift):
    """One launch of the K-sweep kernel: len(zboxes) sweeps with the z
    boxes zboxes over the interior rows and columns, the output planes
    (o0, o1) of the last one into out."""
    nz, ny, nx = src.shape
    zbox = (ctypes.c_int * (2 * len(zboxes)))(*(v for zb in zboxes for v in zb))
    err = kernels.lib().fpr_dual_timek(
        Ht.data_ptr(), src.data_ptr(), out.data_ptr(), kernels.ptr(partials),
        0 if partials is None else partials.numel(), *cf, len(zboxes), nz, ny, nx, ht_shift,
        *planes, ctypes.addressof(zbox), 1, ny - 2, 1, nx - 2, kernels.stream(src))
    kernels.check(err, "fpr_dual_timek")


def _dual_timek_cuda(Ht, Htau, K, cf, scratch=None, partials=None):
    """The K-sweep kernel once per pass; see ``dual_time_stepk``."""
    kernels.require_cuda_f32("dual_time_stepk", Ht, Htau, scratch, partials)
    scratch = torch.empty_like(Htau) if scratch is None else scratch
    nz = Htau.shape[0]
    partials = fused_partials(Htau, nz, K) if partials is None else partials
    _fused_passes(K, Htau, scratch, lambda s, d, a, k, last: _launch_k(
        Ht, s, cf, d, partials if last else None, _zboxes(nz, K, a, k), (0, nz - 1), 0))
    kernels.launches["dual_timek"] += 1
    return scratch, partials.sum()


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


def dual_time_step_pair(Ht, pair, dt, dtau, dx, dy, dz, D, *, test, partials=None):
    """One pseudo-time iteration on a ping-pong pair and the loop test
    after it (#8's tested form).

    pair: a (2, nz, ny, nx) tensor, two buffers.  The iteration reads
    pair[test.it & 1] and writes Htau' into pair[(test.it + 1) & 1], the
    count read on the device, then writes the loop test into test's
    buffers (a ``LoopTest``; its count one more).
    Returns (pair, sum(dHdtau^2) over the interior).  On the card the
    kernel's launch picks the side, finishes the sum (its fold in another
    fixed order than ``partials.sum()``'s) and the test; partials: a
    ``kernels.partials_3d`` buffer to reuse there.
    """
    if pair.dim() != 4 or pair.shape[0] != 2:
        raise ValueError(f"dual_time_step_pair: expected a (2, nz, ny, nx) pair, got "
                         f"{tuple(pair.shape)}")
    _check("dual_time_step_pair", Ht, pair[0], pair[1])
    cf = coeffs(dt, dtau, dx, dy, dz, D)
    if Ht.device.type == "cpu":
        return pair_step_plain(lambda src: dual_time_step_plain(Ht, src, cf), pair, test)
    return _dual_time_pair_cuda(Ht, pair, cf, test, partials)


def dual_time_stepk(Ht, Htau, K, dt, dtau, dx, dy, dz, D, *, scratch=None, partials=None):
    """K pseudo-time iterations and the last one's sum(dHdtau^2) (#10,
    pallas3d.dual_time_stepk_stacked on physical fields).

    Writes the K-th iterate into scratch (a new tensor if None) and never
    writes Htau.  Returns (scratch, sumsq).  partials: a ``fused_partials(
    Htau, nz, K)`` buffer to reuse on CUDA.
    """
    if K < 1:
        raise ValueError(f"dual_time_stepk: K must be >= 1, got {K}")
    _check("dual_time_stepk", Ht, Htau, scratch)
    cf = coeffs(dt, dtau, dx, dy, dz, D)
    if Htau.device.type == "cpu":
        return dual_time_stepk_plain(Ht, Htau, K, cf, scratch)
    return _dual_timek_cuda(Ht, Htau, K, cf, scratch, partials)


# ---------------------------------------------------------------------------
# the update box (#8 on a shard) and the K-deep ghost blocks (#9)
# ---------------------------------------------------------------------------


def box_partials(Htau, nw: int) -> torch.Tensor:
    """The partials buffer of a boxed launch over nw planes of Htau's
    (ny, nx): per block (float32) on the card, per plane (Htau's dtype) on
    the CPU.  Every entry is written by the launch: no zeroing needed."""
    _, ny, nx = Htau.shape
    if Htau.device.type == "cpu":
        return Htau.new_zeros(nw)
    return torch.empty(kernels.num_blocks_3d(nw, ny, nx), dtype=torch.float32,
                       device=Htau.device)


def plane_partials(partials, k: int, Htau) -> torch.Tensor:
    """The part of a window's partials that belongs to its k-th plane: the
    buffer a one-plane launch over that plane writes, so that the window's
    sum keeps the order of a single launch over it."""
    _, ny, nx = Htau.shape
    b = 1 if Htau.device.type == "cpu" else kernels.num_blocks_3d(1, ny, nx)
    return partials[k * b:(k + 1) * b]


def dual_time_box_plain(Ht, Htau, cf, box, window, out, partials=None, ht_shift=0):
    """Plain PyTorch version of one boxed launch, in the kernel's operation
    order; see ``dual_time_box``.  partials: None, or nw entries that get
    the per-plane sums of dHdtau^2 over the box, each plane summed alone.
    Returns dHdtau over the box (None when the box misses the window)."""
    w0, w1 = window
    z0, z1, y0, y1, x0, x1 = box
    out[w0:w1 + 1] = Htau[w0:w1 + 1]
    if partials is not None:
        partials.zero_()
    a, b = max(z0, w0), min(z1, w1)
    if a > b or y0 > y1 or x0 > x1:
        return None
    inv_dx2, inv_dy2, inv_dz2, inv_dt, D, dtau = (Htau.new_full((), v) for v in cf)
    Z, Y, X = slice(a, b + 1), slice(y0, y1 + 1), slice(x0, x1 + 1)
    c = Htau[Z, Y, X]
    c2 = 2.0 * c
    lap = (((Htau[Z, Y, x0 + 1:x1 + 2] - c2) + Htau[Z, Y, x0 - 1:x1]) * inv_dx2
           + ((Htau[Z, y0 + 1:y1 + 2, X] - c2) + Htau[Z, y0 - 1:y1, X]) * inv_dy2
           + ((Htau[a + 1:b + 2, Y, X] - c2) + Htau[a - 1:b, Y, X]) * inv_dz2)
    dh = (c - Ht[a - ht_shift:b + 1 - ht_shift, Y, X]) * inv_dt - D * lap
    out[Z, Y, X] = c - dtau * dh
    if partials is not None:
        d2 = dh * dh
        for k in range(b - a + 1):
            partials[a - w0 + k] = torch.sum(d2[k])
    return dh


def _check_box(name, shape, box, window, ht_shift=0):
    nz, ny, nx = shape
    w0, w1 = window
    if not 0 <= w0 <= w1 < nz:
        raise ValueError(f"{name}: window {window} outside {nz} planes")
    z0, z1, y0, y1, x0, x1 = box
    if z0 > z1 or y0 > y1 or x0 > x1:
        return
    if not (1 <= z0 and z1 <= nz - 2 and 1 <= y0 and y1 <= ny - 2 and 1 <= x0
            and x1 <= nx - 2 and z0 - ht_shift >= 0):
        raise ValueError(f"{name}: box {box} outside the interior of {tuple(shape)}")


def dual_time_box(Ht, Htau, box, dt, dtau, dx, dy, dz, D, *, window=None, out=None,
                  partials=None):
    """One iteration with #8's update box (pallas3d.dual_time_step_padded's
    ``bounds``) over the planes window = (w0, w1) of Htau (default all).

    box = (z0, z1, y0, y1, x0, x1): inclusive, in Htau's own coordinates,
    inside [1, n-2] on each axis when not empty; cells of the window outside
    it are copied, planes outside the window not written.  Ht has Htau's
    planes.  out: a new tensor if None, never Htau.  partials:
    ``box_partials(Htau, nw)`` or a slice of one (``plane_partials``);
    None takes a new one.  Returns (out, partials); partials.sum() is
    sum(dHdtau^2) over the box.
    """
    window = (0, Htau.shape[0] - 1) if window is None else tuple(window)
    _check_box("dual_time_box", Htau.shape, box, window)
    if out is None:
        out = torch.empty_like(Htau)
    elif out.data_ptr() == Htau.data_ptr():
        raise ValueError("dual_time_box: the output buffer must not be Htau")
    if partials is None:
        partials = box_partials(Htau, window[1] - window[0] + 1)
    cf = coeffs(dt, dtau, dx, dy, dz, D)
    if Htau.device.type == "cpu":
        dual_time_box_plain(Ht, Htau, cf, box, window, out, partials)
    else:
        _dual_time_box_cuda(Ht, Htau, cf, box, window, out, partials)
    return out, partials


def _dual_time_box_cuda(Ht, Htau, cf, box, window, out, partials):
    """A boxed launch on the card, counted as ``dual_time``."""
    kernels.require_cuda_f32("dual_time_box", Ht, Htau, out, partials)
    _launch(Ht, Htau, cf, out, partials, box, window)
    kernels.launches["dual_time"] += 1


def dual_time_stepk_padded_plain(Ht_k, Hp, K, cf, z_bounds, scratch=None, partials=None):
    """Plain PyTorch version of #9; see ``dual_time_stepk_padded``: sweep j
    writes its window (j, nz-1-j), the cells of its box updated."""
    nz, ny, nx = Hp.shape
    scratch = torch.empty_like(Hp) if scratch is None else scratch
    partials = Hp.new_zeros(nz - 2 * K) if partials is None else partials

    def sweep(m, src, dst):
        j = m + 1
        (z0, z1), = _zboxes(nz, K, m, 1, z_bounds)
        w, box = (j, nz - 1 - j), (z0, z1, 1, ny - 2, 1, nx - 2)
        _check_box("dual_time_stepk_padded", Hp.shape, box, w, 1)
        dual_time_box_plain(Ht_k, src, cf, box, w, dst, partials if j == K else None, 1)

    _chain(K, Hp, scratch, sweep)
    return scratch, partials.sum()


def _dual_time_stepk_padded_cuda(Ht_k, Hp, K, cf, z_bounds, scratch=None, partials=None):
    """#9 on the card: the K-sweep kernel once per pass; a pass ending at
    sweep j writes the window (j, nz-1-j), the last one the owned planes."""
    kernels.require_cuda_f32("dual_time_stepk_padded", Ht_k, Hp, scratch, partials)
    nz, ny, nx = Hp.shape
    scratch = torch.empty_like(Hp) if scratch is None else scratch
    partials = fused_partials(Hp, nz - 2 * K, K) if partials is None else partials
    for j, (z0, z1) in enumerate(_zboxes(nz, K, 0, K, z_bounds), 1):
        _check_box("dual_time_stepk_padded", Hp.shape, (z0, z1, 1, ny - 2, 1, nx - 2),
                   (j, nz - 1 - j), 1)
    _fused_passes(K, Hp, scratch, lambda s, d, a, k, last: _launch_k(
        Ht_k, s, cf, d, partials if last else None, _zboxes(nz, K, a, k, z_bounds),
        (a + k, nz - 1 - a - k), 1))
    kernels.launches["dual_timek_padded"] += 1
    return scratch, partials.sum()


def dual_time_stepk_padded(Ht_k, Hp, K, dt, dtau, dx, dy, dz, D, *, z_bounds=None,
                           scratch=None, partials=None):
    """K fused pseudo-time iterations on a K-deep z-ghost-padded shard block
    (#9, pallas3d.dual_time_stepk_padded, physical y and x).

    Hp: (nz_l + 2K, ny, nx), physical plane p at K + p, the K ghost planes
    on each side refreshed (``halo.refresh_ghosts_zk``).  Ht_k: (nz_l + 2K -
    2, ny, nx), plane p at K - 1 + p.  z_bounds: the inclusive local planes
    that may be updated, reaching into the ghosts on an interior shard edge
    (default (1, nz_l - 2), a whole domain).  Sweep j updates planes [j,
    nz_l + 2K - 1 - j].  Writes the owned planes of the K-th sweep into
    scratch (a new tensor if None) and never writes Hp; scratch's ghost
    planes are left unspecified.  Returns (scratch, sum(dHdtau^2) of the
    last sweep over the owned planes).  partials: a ``fused_partials(Hp,
    nz_l, K)`` buffer to reuse.
    """
    nz = Hp.shape[0]
    nzl = nz - 2 * K
    if K < 1 or nzl < 1:
        raise ValueError(f"dual_time_stepk_padded: K={K} does not fit {nz} planes")
    if Hp.dim() != 3 or Ht_k.shape != (nz - 2, *Hp.shape[1:]) or Ht_k.dtype != Hp.dtype:
        raise ValueError(f"dual_time_stepk_padded: Ht_k {tuple(Ht_k.shape)} does not fit Hp "
                         f"{tuple(Hp.shape)} with K={K}")
    if scratch is not None and (scratch.shape != Hp.shape or scratch.data_ptr() == Hp.data_ptr()):
        raise ValueError("dual_time_stepk_padded: scratch must be a second buffer of Hp's shape")
    z_bounds = (1, nzl - 2) if z_bounds is None else tuple(z_bounds)
    cf = coeffs(dt, dtau, dx, dy, dz, D)
    if Hp.device.type == "cpu":
        return dual_time_stepk_padded_plain(Ht_k, Hp, K, cf, z_bounds, scratch, partials)
    return _dual_time_stepk_padded_cuda(Ht_k, Hp, K, cf, z_bounds, scratch, partials)


def pad3dk(H: torch.Tensor, K: int) -> torch.Tensor:
    """Physical (nz, ny, nx) -> (nz + 2K, ny, nx) with K zero ghost planes on
    each side (pallas3d.pad3dk without its tile padding)."""
    return torch.nn.functional.pad(H, (0, 0, 0, 0, K, K))


def pad_htk(H: torch.Tensor, K: int) -> torch.Tensor:
    """Physical Ht -> (nz + 2K - 2, ny, nx) with K - 1 zero ghost planes on
    each side (pallas3d.pad_htk without its tile padding)."""
    return torch.nn.functional.pad(H, (0, 0, 0, 0, K - 1, K - 1))


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
