"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

Profiles (torch.profiler, CPU + CUDA) a window of NS explicit steps and of
NS semi-implicit steps at 2049x513, one MG solve at 4097^2 (DST-513,
V(5,5)), 8 steps of the NS host loop (beta=0.5, mg_solver="mixed",
float64) at 2049x513, one mixed-precision MG solve at 4097^2 (default
MGConfig, float64), and the pseudo-time loop of part 1's diffusion solve in each
kernel tier (step calls with one host read of the norm each: 100 calls of
K=3 iterations at 512^3 float32, 2000 calls at 128^3 float32 and 2000 at
128^3 double-single; the field's set-up is outside the window), and the
sharded tiers on a virtual mesh of shards on the one card: one physical
diffusion step at 512^3 on 4 z-shards (K=3, 300 iterations) and at 128^3
on 2x2x2 shards (to convergence), one ``mg_solve_ds_sharded`` at 4097^2
on 4 row shards, one ``mg_solve_ds_sharded_2d`` at 4097^2 on a 2x2 (y, x)
mesh, 20 explicit and 8 semi-implicit steps of ``simulate_fast_sharded``
at 2049x513 on 4 row shards, one ``mg_solve_sharded`` (the GSPMD tier) at
2049^2 float64 on 4 row shards, and 3 steps of the host loop's
``simulate(mesh=)`` at 2049x513 float64 on 4 row shards; each window
after a warm-up run, and two diffusion solves at 128^3 (K=1 to tol 1e-6,
ds to 1e-10, ttot 0.4).  It prints per window the wall time (the run
unprofiled), the summed device time (kernels and memory copies, profiled as
host loops: the profiler sees no kernel inside a CUDA graph's conditional
node), the device time of the copy kernels (the halo exchange's face copies, and casts), the device
launches (every kernel and copy the profiler saw), the kernel launch
counts of the port's CUDA wrappers, and the top device kernels and
copies.

Run from the repo root on a GPU machine:  python scripts/torch_profile.py
[ROOT] [--only TEXT ...].  ROOT (default: this checkout) is the root of the
checkout whose ``fpr_tpu_torch`` is profiled, such as an unpacked ``git
archive`` of another commit; --only keeps the windows whose labels
begin with one of the texts, e.g. ``--only "MG 4097^2" "NS explicit"``.
"""

import argparse
import contextlib
import os
import sys
import time

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument("root", nargs="?", default=os.path.join(os.path.dirname(__file__), ".."))
ARGS.add_argument("--only", nargs="*", default=None)
OPTS = ARGS.parse_args(sys.argv[1:] if __name__ == "__main__" else [])
sys.path.insert(0, os.path.abspath(OPTS.root))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fpr_tpu_torch import kernels  # noqa: E402
from fpr_tpu_torch.core import bc  # noqa: E402
from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig,  # noqa: E402
                                       ExecutionPolicy, MGConfig, NSConfig)
from fpr_tpu_torch.core.grid import Grid3D, pseudo_timestep  # noqa: E402
from fpr_tpu_torch.models import diffusion3d  # noqa: E402
from fpr_tpu_torch.ops import ds3d, dual_time, stencil3d  # noqa: E402
from fpr_tpu_torch.models.dist_ns import simulate_fast_sharded  # noqa: E402
from fpr_tpu_torch.models.navier_stokes import simulate, simulate_fast  # noqa: E402
from fpr_tpu_torch.parallel import dist_diffusion  # noqa: E402
from fpr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from fpr_tpu_torch.solvers.dist_mg_ds import (mg_solve_ds_sharded,  # noqa: E402
                                               mg_solve_ds_sharded_2d)
from fpr_tpu_torch.solvers.dist_multigrid import mg_solve_sharded  # noqa: E402
from fpr_tpu_torch.solvers.multigrid import mg_solve_ds, mg_solve_mixed  # noqa: E402


try:
    from fpr_tpu_torch.core.loops import host_loops  # noqa: E402
except ImportError:  # a tree from before the on-device loops
    host_loops = contextlib.nullcontext


def window(label, fn, top=12):
    """The wall time of fn (after a warm-up run), and the device time of its
    kernels from the profiler.  The profiler sees no kernel inside a CUDA
    graph's conditional node, so it profiles the same work as host loops
    (``loops.host_loops()``: the same kernels on the same data, launched
    one by one).  That device time is not set against the wall of the run
    as it runs: the two run in different modes."""
    if OPTS.only is not None and not any(label.startswith(t) for t in OPTS.only):
        return
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels.reset_launches()
    with host_loops(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        eager = time.perf_counter() - t0
    counts = getattr(kernels, "sync_launches", lambda: dict(kernels.launches))()
    evs = [e for e in prof.key_averages()
           if e.device_type.name == "CUDA" and (e.device_time_total or 0) > 0]
    device = sum(e.device_time_total for e in evs) / 1e6
    copies = sum(e.device_time_total for e in evs if "copy" in e.key.lower()) / 1e6
    print(f"[{label}] wall {wall:.4f} s  device time (kernels + copies) {device:.4f} s  "
          f"(host loops, profiled: wall {eager:.4f} s)  copy kernels "
          f"{copies:.4f} s  device launches {sum(e.count for e in evs)}  wrapper launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:top]:
        print(f"   {e.device_time_total / 1e3:10.2f} ms  n={e.count:6d}  {e.key[:90]}")


def diffusion_loop(cfg, calls):
    """The inner loop of diffusion3d.solve on its initial field: ``calls``
    step calls, each writing the loop test and followed by the host read
    of its norm."""
    g = Grid3D(cfg.nx, cfg.ny, cfg.nz)
    kw = dict(dt=cfg.dt, dtau=pseudo_timestep(g.dx, g.dy, g.dz, cfg.D), dx=g.dx, dy=g.dy,
              dz=g.dz, D=cfg.D)
    ds_tier = cfg.policy is ExecutionPolicy.PALLAS_DS
    H = bc.dirichlet_faces_3d(stencil3d.init_gaussian(
        g, torch.float64 if ds_tier else torch.float32, device="cuda"))
    Ht = ds3d.to_ds(H) if ds_tier else H
    Htau, step, _ = diffusion3d._stepper(cfg, kw, Ht)
    state = {"Htau": Htau}
    test = ()
    if hasattr(dual_time, "loop_test"):  # a tree whose every step writes the loop test
        test = (dual_time.loop_test(Ht, cfg.dt, float(np.sqrt(cfg.nx * cfg.ny * cfg.nz)),
                                    cfg.tol, cfg.iter_max)(
            Ht.new_full((), float("inf")), torch.zeros((), dtype=torch.int32, device="cuda"),
            torch.ones((), dtype=torch.int32, device="cuda")),)

    def run():
        for _ in range(calls):
            state["Htau"], sumsq = step(Ht, state["Htau"], *test)
            float(sumsq)
    return run


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_profile: no CUDA device")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    ns_kw = dict(nx=2049, ny=513, ttot=0.005, Pr=0.01, tol=1e-7, niters=50)
    exp, semi = NSConfig(beta=0.0, **ns_kw), NSConfig(beta=0.5, **ns_kw)
    window("NS explicit 53 steps",
           lambda: simulate_fast(exp, seed=0, max_steps=53, device="cuda"))
    window("NS semi 8 steps", lambda: simulate_fast(semi, seed=0, max_steps=8, device="cuda"))
    n = 4097
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                   post_smooth=5)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    b = torch.tensor(b, device="cuda")
    window("MG 4097^2", lambda: mg_solve_ds(None, b, 1.0 / (n - 1), 0.0, 1e-6, 30, cfg=cfg,
                                            return_pair=True))
    host = NSConfig(beta=0.5, mg_solver="mixed", **ns_kw)
    window("NS host loop mixed beta=0.5, 8 steps",
           lambda: simulate(host, seed=0, max_steps=8, device="cuda"))
    b64 = b.double()
    window("MG mixed 4097^2", lambda: mg_solve_mixed(torch.zeros_like(b64), b64, 1.0 / (n - 1),
                                                     0.0, 1e-6, 30))
    pallas, ds = ExecutionPolicy.PALLAS, ExecutionPolicy.PALLAS_DS
    for label, dcfg, calls in (
        ("diffusion 512^3 K=3, 100 calls", DiffusionConfig(
            nx=512, ny=512, nz=512, policy=pallas, check_every=3), 100),
        ("diffusion 128^3 K=1, 2000 calls", DiffusionConfig(policy=pallas), 2000),
        ("diffusion 128^3 ds, 2000 calls", DiffusionConfig(policy=ds), 2000),
    ):
        window(label, diffusion_loop(dcfg, calls))
    for label, dcfg in (
        ("diffusion 128^3 K=1 solve, ttot 0.4, tol 1e-6",
         DiffusionConfig(policy=pallas, ttot=0.4, tol=1e-6)),
        ("diffusion 128^3 ds solve, ttot 0.4, tol 1e-10",
         DiffusionConfig(policy=ds, ttot=0.4, tol=1e-10)),
    ):
        window(label, lambda dcfg=dcfg: diffusion3d.solve(dcfg, device="cuda"))
    sharded_windows(b)


def dist_diffusion_step(cfg, mesh):
    """One physical step of the sharded diffusion tier from its initial
    field (the blocks are built outside the window)."""
    step, grid = dist_diffusion.build_step(cfg, mesh)
    H = bc.dirichlet_faces_3d(stencil3d.init_gaussian(grid, torch.float32, device="cpu"))
    Ht = dist_diffusion.shard_field(H, mesh)
    return lambda: step(Ht, Ht)


def sharded_windows(b):
    """The sharded tiers on a virtual mesh: every shard on the one card."""
    pallas = ExecutionPolicy.PALLAS
    z4 = make_mesh((4,), ("z",))
    window("dist diffusion 512^3 on 4 z-shards K=3, one step of 300 iterations",
           dist_diffusion_step(DiffusionConfig(nx=512, ny=512, nz=128, tol=1e-6, iter_max=300,
                                               policy=pallas, check_every=3), z4))
    window("dist diffusion 128^3 on 2x2x2 shards K=1, one step to tol 1e-6",
           dist_diffusion_step(DiffusionConfig(nx=64, ny=64, nz=64, tol=1e-6, policy=pallas),
                               make_mesh((2, 2, 2))))
    y4 = make_mesh((4,), ("y",))
    n = 4097
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                   post_smooth=5)
    window("dist MG 4097^2 on 4 row shards",
           lambda: mg_solve_ds_sharded(b, 1.0 / (n - 1), 0.0, 1e-6, 30, y4, cfg=cfg))
    window("dist MG 4097^2 on a 2x2 (y, x) mesh",
           lambda: mg_solve_ds_sharded_2d(b, 1.0 / (n - 1), 0.0, 1e-6, 30,
                                          make_mesh((2, 2), ("y", "x")), cfg=cfg))
    ns_kw = dict(nx=2049, ny=513, ttot=0.005, Pr=0.01, tol=1e-7, niters=50)
    window("dist NS explicit on 4 row shards, 20 steps",
           lambda: simulate_fast_sharded(NSConfig(beta=0.0, **ns_kw), y4, max_steps=20))
    window("dist NS semi on 4 row shards, 8 steps",
           lambda: simulate_fast_sharded(NSConfig(beta=0.5, **ns_kw), y4, max_steps=8))
    m = 2049
    b64 = b[:m, :m].double().clone()
    b64[-1] = 0.0
    b64[:, -1] = 0.0
    window("GSPMD mg_solve 2049^2 float64 on 4 row shards",
           lambda: mg_solve_sharded(torch.zeros_like(b64), b64, 1.0 / (m - 1), 0.0, 1e-6, 30, y4))
    host = NSConfig(beta=0.5, mg_solver="direct", **dict(ns_kw, ttot=1.0))
    window("GSPMD simulate(mesh=) direct float64 beta=0.5 on 4 row shards, 3 steps",
           lambda: simulate(host, seed=0, max_steps=3, mesh=y4))


if __name__ == "__main__":
    main()
