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
it), as JAX's ``lax.while_loop``: on CUDA one launch of a cached CUDA
graph a physical step, the host reading the iteration count and err once
per physical step, as JAX does.  err = sqrt(sumsq) dt / sqrt(N) is formed
on the device in the field's dtype (float32 for the kernel tiers and ds)
and compared there with tol rounded to that dtype; the float64 test of
convergence is the host's.  Iterations advance by K per call; convergence
is err <= tol, not the count.  The kernel tiers iterate on a ping-pong pair
of buffers (each call writes the one it does not read, two calls a graph
pass, so no pass copies a field); the commit Ht <- Htau is a device copy.
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


def _stepper(cfg: DiffusionConfig, kw: dict, Ht: torch.Tensor):
    """(Htau, step, unroll) for cfg.policy: the first Htau (a copy of Ht),
    step(Ht, Htau) -> (Htau', sumsq), and the unroll of the loop around it."""
    if cfg.policy is ExecutionPolicy.JNP:
        def step(Ht, Htau):
            return stencil3d.dual_time_step(Ht, Htau, **kw)

        return Ht.clone(), step, 1

    bufs = (Ht.clone(), torch.empty_like(Ht))
    fused = cfg.policy is ExecutionPolicy.PALLAS and cfg.check_every > 1
    partials = (dual_time.fused_partials(Ht, Ht.shape[0], cfg.check_every) if fused
                else kernels.partials_3d(Ht.shape[-3:], Ht.device))

    def other(Htau):
        return bufs[1] if Htau is bufs[0] else bufs[0]

    if cfg.policy is ExecutionPolicy.PALLAS_DS:
        def step(Ht, Htau):
            return ds3d.dual_time_step_ds(Ht, Htau, **kw, out=other(Htau), partials=partials)
    elif not fused:
        def step(Ht, Htau):
            return dual_time.dual_time_step(Ht, Htau, **kw, out=other(Htau),
                                            partials=partials)
    else:
        def step(Ht, Htau):
            return dual_time.dual_time_stepk(Ht, Htau, cfg.check_every, **kw,
                                             scratch=other(Htau), partials=partials)
    return bufs[0], step, 2


def _physical_step(a: dict, cfg: DiffusionConfig, kw: dict, K: int) -> dict:
    """One physical step on Ht = a["Ht"]: the pseudo-time while_loop, then
    the commit (diffusion3d._step_fn's physical_step).  Returns the new Ht,
    the last err and the iterations."""
    Ht = a["Ht"]
    Htau, step, unroll = _stepper(cfg, kw, Ht)
    tol, dt, sqrt_n = (Ht.new_full((), v) for v in (cfg.tol, cfg.dt, float(np.sqrt(
        cfg.nx * cfg.ny * cfg.nz))))

    def cond(s):
        return (s[1] > tol) & (s[2] < cfg.iter_max)

    def body(s):
        Htau, sumsq = step(Ht, s[0])
        return Htau, torch.sqrt(sumsq) * dt / sqrt_n, s[2] + K

    Htau, err, it = loops.while_loop(
        cond, body, (Htau, Ht.new_full((), float("inf")),
                     torch.zeros((), dtype=torch.int32, device=Ht.device)),
        unroll=unroll, donate=True, name="diffusion.pseudo_time")
    Ht = Htau if cfg.policy is ExecutionPolicy.JNP else Ht.copy_(Htau)
    return dict(Ht=Ht, err=err, it=it)


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
    ``diffusion.copy_out``.
    """
    dev = torch.device(device)
    policy = cfg.policy
    ds_tier = policy is ExecutionPolicy.PALLAS_DS
    if dtype not in _NP:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    if dev.type == "cuda" and policy is not ExecutionPolicy.JNP and dtype != torch.float32:
        raise ValueError(f"policy {policy.value} runs float32 CUDA kernels; got {dtype}")
    K = cfg.check_every if policy is ExecutionPolicy.PALLAS else 1
    if K < 1:
        raise ValueError(f"check_every must be >= 1, got {cfg.check_every}")

    grid = Grid3D(cfg.nx, cfg.ny, cfg.nz, cfg.lx, cfg.ly, cfg.lz)
    nt = outer_steps(cfg.ttot, cfg.dt)
    kw = dict(dt=cfg.dt, dtau=pseudo_timestep(grid.dx, grid.dy, grid.dz, cfg.D),
              dx=grid.dx, dy=grid.dy, dz=grid.dz, D=cfg.D)
    with trace.span("diffusion.init_fields"):
        H0 = bc.dirichlet_faces_3d(
            stencil3d.init_gaussian(grid, torch.float64 if ds_tier else dtype, device=dev))
        Ht = ds3d.to_ds(H0) if ds_tier else H0
        del H0  # the ds tier's float64 field is not kept on the device
    physical_step = functools.partial(_physical_step, cfg=cfg, kw=kw, K=K)
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
        H = (ds3d.from_ds(Ht) if ds_tier else Ht).cpu().numpy()
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
