"""3D pseudo-transient ("dual-time") diffusion to steady state
(fpr_tpu/models/diffusion3d.py: DiffusionResult, solve, probe_nearest,
probe_trilinear).

Each backward-Euler step of

    dH/dt = D nabla^2 H,  H = 0 on all faces, a Gaussian at t = 0

is solved by pseudo-time iteration Htau' = Htau - dtau R(Htau), with
R = (Htau - Ht)/dt - D nabla^2 Htau, until ||R dt||_2 / sqrt(N) <= tol;
then Ht <- Htau.  ``cfg.policy`` picks the tier of the iteration: JNP
(``ops/stencil3d.py``), PALLAS (``ops/dual_time.py``, K = check_every
iterations per call) or PALLAS_DS (``ops/ds3d.py``).

The loop over iterations is a ``core.loops.while_loop`` over (Htau, err,
it, go), as JAX's ``lax.while_loop`` over (Htau, err, it) with its cond
carried: on CUDA one launch of a cached CUDA graph a physical step, the
host reading the iteration count and err once per physical step, as JAX
does.  Every tier's body is one call of its step, which also writes the
loop test (``dual_time.LoopTest``) into the carry's err, it and go: err =
sqrt(sumsq) dt / sqrt_n in the field's dtype (float32 for the kernel tiers
and ds), it + K, go = (err > tol) & (it < iter_max) with tol rounded to
that dtype; cond reads go.  The float64 test of convergence is the host's.
Iterations advance by K per call; convergence is err <= tol, not the
count.  The kernel tiers iterate on a ping-pong pair of buffers, each call
writing the one it does not read, so that no pass copies a field.

``_stepper`` is the one place that picks the tier's step and loop, from
the policy and K.  The K=1 kernel tiers (PALLAS with check_every 1,
PALLAS_DS) carry the pair itself: their step reads the side that the
carried count picks, writes the other and finishes the loop test (on the
card all in one launch of #8's or #11's tested form), so that a loop pass
is that launch and the WHILE's set node, and the commit Ht <- Htau copies
the side that the last count picks, chosen on the device.  The fused
K-sweep (#10, K > 1) carries the side a pass reads, known at capture for
two passes at a time (the loop unrolled twice), and JNP makes a new field
a pass; both follow their step with ``dual_time.loop_test_plain``.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import bc, loops, trace
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.core.grid import Grid3D, outer_steps, pseudo_timestep
from fpr_tpu_torch.ops import ds3d, dual_time, stencil3d
from fpr_tpu_torch.utils.timing import BenchResults, diffusion_bench_results

_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class DiffusionResult:
    x: np.ndarray            # cell-centre x coordinates
    H: np.ndarray            # final field (nz, ny, nx)
    iters_total: int         # pseudo-time iterations, all physical steps
    timed_iters: int         # iterations inside the timed window
    bench: BenchResults
    converged: bool


def _commit_pair(Ht: torch.Tensor, pair: torch.Tensor, it: torch.Tensor) -> torch.Tensor:
    """Ht <- pair[it & 1], the side chosen on the device; returns Ht."""
    torch.index_select(pair, 0, (it & 1).reshape(1), out=Ht.unsqueeze(0))
    return Ht


def _stepper(cfg: DiffusionConfig, kw: dict, Ht: torch.Tensor):
    """(Htau, step, unroll, commit) for cfg.policy on Ht's device: the
    loop's first field leaf, step(Ht, Htau, test) -> (Htau', sumsq), which
    also writes the loop test of its iterations into test (a
    ``dual_time.LoopTest``), the unroll of the loop around it, and
    commit(Ht, Htau, it) -> the new Ht from the loop's last field leaf and
    count.  For the K=1 kernel tiers the leaf is the pair itself, (2,
    *Ht.shape), side 0 a copy of Ht, which every pass returns unchanged;
    elsewhere it is the field a pass reads."""
    if cfg.policy is ExecutionPolicy.JNP:
        def step(Ht, Htau, test):
            return dual_time.loop_test_plain(stencil3d.dual_time_step(Ht, Htau, **kw), test)

        return Ht.clone(), step, 1, lambda Ht, Htau, it: Htau

    K = cfg.check_every if cfg.policy is ExecutionPolicy.PALLAS else 1
    partials = (dual_time.fused_partials(Ht, Ht.shape[0], K) if K > 1
                else kernels.partials_3d(Ht.shape[-3:], Ht.device))
    if K == 1:
        tested = (ds3d.dual_time_step_ds_pair if cfg.policy is ExecutionPolicy.PALLAS_DS
                  else dual_time.dual_time_step_pair)
        pair = torch.empty((2, *Ht.shape), dtype=Ht.dtype, device=Ht.device)
        pair[0].copy_(Ht)

        def step(Ht, pair, test):
            return tested(Ht, pair, **kw, partials=partials, test=test)

        return pair, step, 1, _commit_pair

    bufs = (Ht.clone(), torch.empty_like(Ht))

    def other(Htau):
        return bufs[1] if Htau is bufs[0] else bufs[0]

    def step(Ht, Htau, test):
        return dual_time.loop_test_plain(dual_time.dual_time_stepk(
            Ht, Htau, K, **kw, scratch=other(Htau), partials=partials), test, K)
    return bufs[0], step, 2, lambda Ht, Htau, it: Ht.copy_(Htau)


def _physical_step(a: dict, cfg: DiffusionConfig, kw: dict) -> dict:
    """One physical step on Ht = a["Ht"]: the pseudo-time while_loop, then
    the commit (diffusion3d._step_fn's physical_step).  Returns the new Ht,
    the last err and the iterations."""
    Ht = a["Ht"]
    Htau, step, unroll, commit = _stepper(cfg, kw, Ht)
    test = dual_time.loop_test(Ht, cfg.dt, float(np.sqrt(cfg.nx * cfg.ny * cfg.nz)), cfg.tol,
                               cfg.iter_max)
    it = torch.zeros((), dtype=torch.int32, device=Ht.device)
    first = test(Ht.new_full((), float("inf")), it, torch.empty_like(it))
    dual_time.loop_go(first)

    def body(s):
        return (step(Ht, s[0], test(*s[1:]))[0], *s[1:])

    Htau, err, it, _ = loops.while_loop(lambda s: s[3], body,
                                        (Htau, first.err, first.it, first.go), unroll=unroll,
                                        donate=True, name="diffusion.pseudo_time")
    return dict(Ht=commit(Ht, Htau, it), err=err, it=it)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@trace.spanned("diffusion.solve")
def solve(cfg: DiffusionConfig = DiffusionConfig(), dtype=torch.float32,
          verbose: bool = False, *, device="cuda") -> DiffusionResult:
    """Single-device solve with the reference's 3-step timing warm-up
    (diffusion3d.solve).

    dtype: float32 or float64 for JNP; the PALLAS tier on CUDA takes float32
    only (its kernel does), and PALLAS_DS keeps float32 hi/lo pairs whatever
    dtype says (float64 on CUDA is refused there too).  device: where to run;
    the CPU runs the kernels' plain PyTorch versions.  Spans (``core.trace``):
    ``diffusion.solve`` around the call, and inside it
    ``diffusion.init_fields``, ``diffusion.host_read`` (a step) and
    ``diffusion.copy_out``; on PALLAS_DS ``diffusion.to_ds`` (the hi/lo
    split) inside ``diffusion.init_fields`` and ``diffusion.from_ds`` (the
    float64 join) inside ``diffusion.copy_out``.
    """
    dev = torch.device(device)
    policy = cfg.policy
    ds_tier = policy is ExecutionPolicy.PALLAS_DS
    if dtype not in _NP:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    if dev.type == "cuda" and policy is not ExecutionPolicy.JNP and dtype != torch.float32:
        raise ValueError(f"policy {policy.value} runs float32 CUDA kernels; got {dtype}")
    if policy is ExecutionPolicy.PALLAS and cfg.check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {cfg.check_every}")

    grid = Grid3D(cfg.nx, cfg.ny, cfg.nz, cfg.lx, cfg.ly, cfg.lz)
    nt = outer_steps(cfg.ttot, cfg.dt)
    kw = dict(dt=cfg.dt, dtau=pseudo_timestep(grid.dx, grid.dy, grid.dz, cfg.D),
              dx=grid.dx, dy=grid.dy, dz=grid.dz, D=cfg.D)
    with trace.span("diffusion.init_fields"):
        Ht = bc.dirichlet_faces_3d(
            stencil3d.init_gaussian(grid, torch.float64 if ds_tier else dtype, device=dev))
        if ds_tier:  # the float64 field is not kept on the device
            with trace.span("diffusion.to_ds"):
                Ht = ds3d.to_ds(Ht)
    physical_step = functools.partial(_physical_step, cfg=cfg, kw=kw)
    key = ("diffusion3d", cfg, Ht.dtype)

    iters_total = timed_iters = 0
    converged = True
    tic = time.perf_counter()
    for it_outer in range(nt):
        if it_outer == 3:  # warm-up (ref part1_kernel_programming.jl:170-176)
            _sync(dev)
            tic = time.perf_counter()
            timed_iters = 0
        out = loops.device_call(physical_step, dict(Ht=Ht), key=key)
        Ht = out["Ht"]
        # the host's one read a physical step: err (in the field's dtype,
        # exact in float64) and the iterations
        with trace.span("diffusion.host_read"):
            err, it = torch.stack([out["err"].double(), out["it"].double()]).tolist()
        it = int(it)
        iters_total += it
        timed_iters += it
        if not err <= cfg.tol:  # the JAX driver's test, in float64
            converged = False
        if verbose:
            print(f"step {it_outer}: {it} iters, err={err:.3e}")
    _sync(dev)
    delta_t = time.perf_counter() - tic

    with trace.span("diffusion.copy_out"):
        if ds_tier:
            with trace.span("diffusion.from_ds"):
                Ht = ds3d.from_ds(Ht)
        H = Ht.cpu().numpy()
    bench = diffusion_bench_results(
        delta_t, timed_iters, cfg.nx, cfg.ny, cfg.nz,
        word_bytes=8 if ds_tier else Ht.element_size(),
        model="plain" if policy is ExecutionPolicy.JNP else "fused",
    )
    return DiffusionResult(x=grid.coords1d("x"), H=H, iters_total=iters_total,
                           timed_iters=timed_iters, bench=bench, converged=converged)


def probe_nearest(H: np.ndarray, grid: Grid3D, point=(4.5, 4.5, 4.5)) -> float:
    """H at the cell nearest a physical point, H[round(p/d)]
    (diffusion3d.probe_nearest): the ``val`` column of the reference's
    work-precision CSVs, e.g. 0.0799870 at 128^3, ttot 2, tol 1e-6."""
    px, py, pz = point
    return float(H[int(round(pz / grid.dz)), int(round(py / grid.dy)),
                   int(round(px / grid.dx))])


def probe_trilinear(H: np.ndarray, grid: Grid3D, point=(4.5, 4.5, 4.5)) -> float:
    """Trilinear interpolation of H at a physical point, on cell centres
    (diffusion3d.probe_trilinear)."""
    px, py, pz = point

    def locate(p, d, n):
        s = p / d - 0.5
        i0 = int(np.clip(np.floor(s), 0, n - 2))
        return i0, np.clip(s - i0, 0.0, 1.0)

    ix, wx = locate(px, grid.dx, grid.nx)
    iy, wy = locate(py, grid.dy, grid.ny)
    iz, wz = locate(pz, grid.dz, grid.nz)
    c = H[iz:iz + 2, iy:iy + 2, ix:ix + 2]
    w = (np.asarray([1 - wz, wz]).reshape(2, 1, 1)
         * np.asarray([1 - wy, wy]).reshape(1, 2, 1)
         * np.asarray([1 - wx, wx]).reshape(1, 1, 2))
    return float((c * w).sum())
