"""The port's headline benchmark: one JSON line with the rows of the
repository's ``bench.py`` (the JAX package's benchmark on a TPU), measured
on the card.

    python -m fpr_tpu_torch bench [--quick] [--skip-mg] [--skip-ns] [--device cuda|cpu]

Rows, each a function of its size:

- ``bench_diffusion``: 3D dual-time diffusion, 512^3 float32, K=3
  iterations a call of the fused K-sweep kernel, 300 iterations timed from
  the state after 5 warm-up calls; ms per iteration, the counted T_eff of
  the reference's shared-memory model (6+1 words a cell and iteration) and
  GFLOP/s.  T_eff is the headline ``value``.
- ``bench_mg``: ``mg_solve_ds`` at 4097^2, DST coarse 513, V(5,5), tol
  1e-6: the median of 5 single solves, the outer count, the true float64
  relative residual of hi + lo (after the timed region), and the card
  time of one more solve's graph launch (its ``graph:mg_solve_ds`` span,
  ``core.trace``).
- ``bench_ns_row``: ``simulate_fast`` at 2049x513, Pr 0.01, tol 1e-7, ttot
  0.005, seed 0: explicit at s_tol_factor 1 and 100 (the relaxed row is
  withheld unless its timed steps equal the first row's), semi-implicit
  (beta 0.5) and implicit (beta 1); each the median of 3 runs' timed
  windows (steps 1-3 are warm-up).

Each component runs in a process of its own (``_run_component``: ``python
-m fpr_tpu_torch bench --component NAME``, whose last line is
``{"component": NAME, "payload": {...}}``), under its own time limit
(``_TIMEOUTS``), and once more in a fresh process when it hangs or exits
without a payload: a sticky CUDA error, a hung launch or a graph cache
left by one row cannot reach another.  The order is bench.py's:

1. ``canary``: ``bench_canary``, the 512^3 K=3 kernel of known cost.  A
   reading above ``CANARY_HEALTHY_MS`` is run once more in a fresh
   process; a second breach prints the line with ``value`` null,
   ``env_degraded`` true and the canary in ``extras``, no row's numbers,
   and exits non-zero.
2. ``aliased``: ``check_aliased_kernels``, the kernels' seams and halos
   held bitwise against another route and the plain versions; a mismatch
   sets ``aliased_kernel_check`` false (the rows still run).
3. the rows: ``diffusion``, ``mg``, ``ns_explicit``, ``ns_relaxed_s``,
   ``ns_semi``, ``ns_implicit``; a row that fails leaves
   ``<row>_error`` (the child's error and the end of its output).
4. ``canary_post`` (not with ``--quick``): a breach sets
   ``env_degraded_after``.

``--quick`` runs diffusion at 128^3 for 99 iterations and MG at 1025^2,
without NS.  ``--device cpu`` runs the kernels' plain PyTorch versions,
labels every row ``cpu`` and skips the canaries and the check (null
``aliased_kernel_check``); with the default ``--device cuda`` and no card
the bench exits non-zero.  The bench exits non-zero on any line it cannot
vouch for: a failed row or check, or a breached canary.

The ``vs_`` ratios are against the Julia reference's GPU figures
(BASELINE.md): T_eff 63.5 GB/s (Titan X, float64), MG 0.154 s (V100), NS
explicit 1314 s (Titan X class) and semi-implicit 25.5 s (V100).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from fpr_tpu_torch.core import bc, trace
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig, NSConfig
from fpr_tpu_torch.core.grid import Grid3D, pseudo_timestep
from fpr_tpu_torch.models.navier_stokes import simulate_fast
from fpr_tpu_torch.ops import dual_time, stencil3d, transfer, vcycle_legs
from fpr_tpu_torch.solvers.multigrid import mg_solve_ds
from fpr_tpu_torch.solvers.poisson import poisson_rhs, true_rel_residual
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.timing import diffusion_bench_results, stats_of, timed_stats

REF_TEFF_GBS = 63.5
REF_MG_S = 0.154
REF_NS_EXPLICIT_S = 1314.0
REF_NS_SEMI_S = 25.5
K = 3  # iterations a call of the fused K-sweep kernel
RELAXED_S_TOL = 100.0
TIMING = ("median of 3 reps, 5 for MG; host clock around work that ends in "
          "torch.cuda.synchronize() or a scalar read (NS: each run's timed window, after "
          "its 3 warm-up steps); iqr_s is the spread; each component in a fresh process")
NS_ROWS = {"ns_explicit": (0.0, 1.0), "ns_relaxed_s": (0.0, RELAXED_S_TOL),
           "ns_semi": (0.5, 1.0), "ns_implicit": (1.0, 1.0)}  # (beta, s_tol_factor)
COMPONENTS = ("canary", "aliased", "diffusion", "mg", *NS_ROWS, "canary_post")
# the canary's breach threshold, ms an iteration: about 1.33 times the
# slowest healthy reading (bench.py's margin, 2.0 over 1.5); the envelope is
# [below the fastest healthy reading, the threshold]
CANARY_HEALTHY_MS = 0.5
CANARY_ENVELOPE_MS = (0.35, CANARY_HEALTHY_MS)
# seconds a component's process may take: about 10 times its whole run on
# the card from a fresh process (at least 5), so that a card below its
# full power or a busy host stays inside; the canary's covers the cold
# nvcc build of the kernel library, which the first component of a fresh
# checkout does
_TIMEOUTS = {"canary": 180, "aliased": 120, "diffusion": 120, "mg": 180, "ns_explicit": 300,
             "ns_relaxed_s": 240, "ns_semi": 120, "ns_implicit": 120, "canary_post": 120}
REL_NORM = 1e-5  # norms summed in another order: a few float32 ulps of ~1e6 terms


def bench_diffusion(n: int, iters_cap: int, reps: int = 3, device="cuda") -> dict:
    """K(iters_cap // K) iterations of the K=3 kernel at n^3 float32 (the
    reference's Gaussian, dt 0.2), from the state after 5 warm-up calls; one
    scalar read at the end of each rep."""
    dev = torch.device(device)
    grid = Grid3D(n, n, n)
    kw = dict(dt=0.2, dtau=pseudo_timestep(grid.dx, grid.dy, grid.dz, 1.0), dx=grid.dx,
              dy=grid.dy, dz=grid.dz, D=1.0)
    Ht = bc.dirichlet_faces_3d(stencil3d.init_gaussian(grid, torch.float32, device=dev))
    start, *pair = Ht.clone(), torch.empty_like(Ht), torch.empty_like(Ht)
    partials = dual_time.fused_partials(Ht, n, K)

    def iterate(calls):
        """calls K-sweep calls from start, each writing the buffer of the
        pair that it does not read; (last iterate, summed sumsq)."""
        src, acc = start, Ht.new_zeros(())
        for i in range(calls):
            src, ss = dual_time.dual_time_stepk(Ht, src, K, **kw, scratch=pair[i % 2],
                                                partials=partials)
            acc = acc + ss
        return src, acc

    warm, acc = iterate(5)
    float(acc)
    start.copy_(warm)
    calls = iters_cap // K

    def run():
        float(iterate(calls)[1])

    stats = timed_stats(run, reps)
    iters = K * calls
    res = diffusion_bench_results(stats.median_s, iters, n, n, n, word_bytes=4, model="shmem")
    return dict(grid=f"{n}^3", iterations=iters, teff_gbs=res.throughput / 1e9,
                ms_per_iter=res.delta_t / iters * 1e3, gflops=res.performance / 1e9,
                median_s=stats.median_s, iqr_s=stats.iqr_s, reps=stats.reps)


def bench_mg(n: int, tol: float = 1e-6, reps: int = 5, device="cuda") -> dict:
    """``mg_solve_ds`` at n^2, DST coarse min(513, n), V(5,5): the median of
    reps single solves after one warm-up solve, the outer count and the true
    float64 residual of the warm-up's iterate (outside the timed region);
    on the card also the card time of one more solve's graph launch, read
    from its span after the timed reps."""
    dev = torch.device(device)
    cfg = MGConfig(coarse_size=min(513, n), coarse_solver=CoarseSolver.DST, pre_smooth=5,
                   post_smooth=5)
    h = 1.0 / (n - 1)
    b = poisson_rhs(n, dev)

    def solve():
        return mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=cfg, return_pair=True)

    (uh, ul), r, it = solve()
    float(r)

    def run():
        float(solve()[1])

    stats = timed_stats(run, reps)
    dev_s = None
    if dev.type == "cuda":
        trace.enable(dev)
        try:
            run()
            dev_s = trace.read()["spans"][trace.GRAPH + "mg_solve_ds"]["total_s"]
        finally:
            trace.disable()
    return dict(grid=f"{n}^2", seconds_to_tol=stats.median_s, iqr_s=stats.iqr_s,
                reps=stats.reps, outer_iterations=int(it),
                true_f64_rel_residual=true_rel_residual(uh, ul, b, h),
                device_seconds_one_solve=dev_s)


def bench_ns_row(beta: float, s_tol_factor: float = 1.0, reps: int = 3, nx: int = 2049,
                 ny: int = 513, ttot: float = 0.005, max_steps=None, device="cuda") -> dict:
    """``simulate_fast`` runs at Pr 0.01, tol 1e-7, seed 0: the median of
    their timed windows; every run must take the same steps."""
    cfg = NSConfig(nx=nx, ny=ny, ttot=ttot, beta=beta, Pr=0.01, tol=1e-7, niters=50,
                   s_tol_factor=s_tol_factor)
    outs = [simulate_fast(cfg, seed=0, max_steps=max_steps, device=device)
            for _ in range(max(1, reps))]
    steps = {(o.steps, o.timed_iters) for o in outs}
    if len(steps) != 1:
        raise RuntimeError(f"beta={beta}: runs took different (steps, timed) counts {steps}")
    ts = [o.t_elapsed for o in outs]
    st = stats_of(ts)
    return dict(seconds=st.median_s, rep_seconds=ts, iqr_s=st.iqr_s, reps=st.reps,
                timed_steps=outs[0].timed_iters, steps=outs[0].steps)


def bench_canary(iters: int = 150, device="cuda") -> dict:
    """The card's health probe of known cost (bench.py's ``bench_canary``):
    ``bench_diffusion``'s 512^3 float32 K=3 fused kernel (#10) for iters
    iterations, ms an iteration as the median of 3 reps and their iqr.  No
    tunnel to subtract: each rep's host clock stops at a scalar read of the
    card's result."""
    row = bench_diffusion(512, iters, reps=3, device=device)
    return {"ms_per_iter": row["ms_per_iter"], "iqr_ms_per_iter":
            row["iqr_s"] / row["iterations"] * 1e3, "iterations": row["iterations"],
            "reps": row["reps"]}


def check_aliased_kernels(device="cuda", n: int = 128, iters: int = 4, ny: int = 1025,
                          nx: int = 513, seed: int = 7) -> dict:
    """The kernel-agreement check (bench.py's ``check_aliased_kernels``), run
    on the card before any row is timed.

    On the TPU the fused kernels alias their output onto their input, and
    only a run on the chip shows a race with a neighbouring block's input.
    The port's kernels never alias (``ops/dual_time.py``), but the races
    that the card can have lie inside the hand-written kernels: the tile
    seams and halos of the leg kernel, the K-sweep kernel's halos and its z
    chunks, which no CPU test runs.  So this makes bench.py's comparisons at
    its shapes (the defaults), the inputs drawn from ``seed``:

    (a) the 3D routes, ``iters`` calls of K sweeps on n^3 float32 at K=3 and
        at K=4, the z-chunked launch's seams: ``dual_time_stepk`` (#10)
        against ``dual_time_stepk_padded`` (#9) over the whole grid, the
        field and the last call's norm;
    (b) the 2D legs on ny x nx float32 at V(2,2), V(5,5) and V(3,3) with
        elim: ``smooth2r_split`` twice, then ``corr_smooth2_raw``, against
        ``smooth_down`` twice, then ``corr_up``: u, the residual and the
        norm;
    (c) each route against the same chain of plain versions
        (``dual_time_stepk_plain``; ``smooth_down_plain``,
        ``corr_up_plain``).  On the card the two routes of (a), and of (b),
        launch the same kernel, so a comparison between them alone would
        prove nothing of it.

    Fields and residuals must agree bitwise.  Norms agree bitwise between
    the 2D routes (the same code on either device), and within ``REL_NORM``
    elsewhere (sums in another order: per block on the card, per plane or
    at once in the plain versions).  A CPU device runs the plain versions
    throughout.  Returns {"passed", "checks": the comparisons made,
    "mismatches": [{"what", "cells", "max_abs_diff"}, ...]}.
    """
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    checks, mismatches = 0, []

    def rand(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)

    def same(what, got, want, rel=None):
        """Bitwise fields (rel None), or norms within rel of want."""
        nonlocal checks
        checks += 1
        if rel is None:
            differ = got != want
            if bool(differ.any()):
                mismatches.append({"what": what, "cells": int(differ.sum()), "max_abs_diff":
                                   float((got.double() - want.double()).abs().max())})
        elif not abs(float(got) - float(want)) <= rel * abs(float(want)):
            mismatches.append({"what": what, "cells": 1,
                               "max_abs_diff": abs(float(got) - float(want))})

    kw = dict(dt=0.2, dtau=1e-4, dx=0.05, dy=0.05, dz=0.05, D=1.0)
    cf = dual_time.coeffs(**kw)
    Ht, Htau = rand(n, n, n), rand(n, n, n)
    for K in (3, 4):
        fused, padded, plain = Htau, dual_time.pad3dk(Htau, K), Htau
        Ht_k = dual_time.pad_htk(Ht, K)
        for _ in range(iters):
            fused, ss_fused = dual_time.dual_time_stepk(Ht, fused, K, **kw)
            out, ss_padded = dual_time.dual_time_stepk_padded(Ht_k, padded, K, **kw)
            padded = dual_time.pad3dk(out[K:K + n], K)
            plain, ss_plain = dual_time.dual_time_stepk_plain(Ht, plain, K, cf)
        same(f"3D K={K}: #10 vs #9, field", fused, padded[K:K + n])
        same(f"3D K={K}: #10 vs #9, norm", ss_fused, ss_padded, REL_NORM)
        same(f"3D K={K}: #10 vs plain, field", fused, plain)
        same(f"3D K={K}: #10 vs plain, norm", ss_fused, ss_plain, REL_NORM)

    h, c = 1.0 / (ny - 1), 0.3
    f = rand(ny, nx)
    corrx = transfer.x_interleave_coarse(rand((ny - 1) // 2 + 1, (nx - 1) // 2 + 1))
    for depth, elim in ((2, False), (5, False), (3, True)):
        leg = dict(ns=depth, elim=elim)
        u, _ = vcycle_legs.smooth2r_split(None, f, h, c, zero_u=True, **leg)
        u, r_split = vcycle_legs.smooth2r_split(u, f, h, c, **leg)
        u_split, n_split = vcycle_legs.corr_smooth2_raw(u, f, corrx, h, c, with_norm=True, **leg)
        u, _ = vcycle_legs.smooth_down(None, f, h, c, **leg)
        u, r_stk = vcycle_legs.smooth_down(u, f, h, c, **leg)
        u_stk, n_stk = vcycle_legs.corr_up(u, f, corrx, h, c, with_norm=True, **leg)
        u, _ = vcycle_legs.smooth_down_plain(None, f, h, c, 0.8, depth, elim)
        u, r_plain = vcycle_legs.smooth_down_plain(u, f, h, c, 0.8, depth, elim)
        u_plain, n_plain = vcycle_legs.corr_up_plain(u, f, corrx, h, c, 0.8, depth, elim, True)
        legs = f"2D V({depth},{depth}) elim={elim}"
        same(f"{legs}: split vs stacked, u", u_split, u_stk)
        same(f"{legs}: split vs stacked, residual", r_split, r_stk)
        same(f"{legs}: split vs stacked, norm", n_split, n_stk, 0.0)
        same(f"{legs}: stacked vs plain, u", u_stk, u_plain)
        same(f"{legs}: stacked vs plain, residual", r_stk, r_plain)
        same(f"{legs}: stacked vs plain, norm", n_stk, n_plain, REL_NORM)
    return {"passed": not mismatches, "checks": checks, "mismatches": mismatches}


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--quick", action="store_true",
                   help="diffusion 128^3 for 99 iterations and MG 1025^2, no NS")
    p.add_argument("--skip-mg", action="store_true")
    p.add_argument("--skip-ns", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu (the plain versions)")
    p.add_argument("--component", choices=COMPONENTS, help=argparse.SUPPRESS)


def _ns_extras(prefix: str, row: dict) -> dict:
    return {f"{prefix}rep_seconds": row["rep_seconds"], f"{prefix}iqr_s": row["iqr_s"],
            f"{prefix}reps": row["reps"], f"{prefix}timed_steps": row["timed_steps"]}


def _component_payload(name: str, quick: bool, device) -> dict:
    """Run one component in this process and return its payload."""
    dev = devinfo.resolve(device)
    if name in ("canary", "canary_post", "aliased"):
        if dev.type != "cuda":
            return {"skipped": "not cuda"}
        return bench_canary(device=dev) if name != "aliased" else check_aliased_kernels(dev)
    if name == "diffusion":
        n, cap = (128, 99) if quick else (512, 300)
        return bench_diffusion(n, cap, device=dev)
    if name == "mg":
        return bench_mg(1025 if quick else 4097, device=dev)
    beta, s_tol = NS_ROWS[name]
    return bench_ns_row(beta, s_tol_factor=s_tol, device=dev)


def _command(name: str, quick: bool, device) -> list[str]:
    """The child process of one component."""
    cmd = [sys.executable, "-m", "fpr_tpu_torch", "bench", "--component", name, "--device",
           str(device)]
    return cmd + ["--quick"] if quick else cmd


def _payload_of(stdout: str, name: str):
    """The payload of the last stdout line that is name's tagged line (the
    child prints logs and warnings too), or None."""
    for line in reversed(stdout.strip().splitlines()):
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("component") == name:
            return obj.get("payload")
    return None


def _kill_group(proc: subprocess.Popen) -> None:
    """Kill a child started in a session of its own, with its own children
    (nvcc during a cold build)."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)


def _run_component(name: str, quick: bool, device, tries: int = 2) -> dict:
    """Run a component in a fresh process under its time limit, and once more
    in another when it hangs or exits without a payload (bench.py's
    ``_run_component``).  Returns its payload, else {"error", "tail"}: the
    last attempt's failure and the end of its output.  A child that outlives
    its limit is killed with every process it started."""
    limit = _TIMEOUTS[name]
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    last = {}
    for attempt in range(1, tries + 1):
        proc = subprocess.Popen(_command(name, quick, device), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=limit)
            failure = f"exit {proc.returncode} with no payload"
        except subprocess.TimeoutExpired:
            _kill_group(proc)
            out, err = proc.communicate()
            failure = f"timeout after {limit} s"
        finally:
            if proc.poll() is None:  # interrupted: take the child down with the bench
                _kill_group(proc)
                proc.wait()
        payload = None if failure.startswith("timeout") else _payload_of(out, name)
        if payload is not None:
            return payload
        last = {"error": failure, "tail": (out + "\n" + err)[-2000:]}
        print(f"bench component {name!r}: {failure} (attempt {attempt}/{tries})\n"
              f"{last['tail']}", file=sys.stderr, flush=True)
    return last


def _canary_gate(name: str, quick: bool, device):
    """The canary in a fresh process, once more in another after a breach
    (bench.py's ``_canary_gate``).  Returns (healthy, payload): True, False,
    or None when the canary was skipped (no card)."""
    for attempt in (1, 2):
        payload = _run_component(name, quick, device, tries=1)
        if "skipped" in payload:
            return None, payload
        ms = payload.get("ms_per_iter")
        if ms is not None and ms <= CANARY_HEALTHY_MS:
            return True, payload
        print(f"bench {name} BREACH (attempt {attempt}/2, threshold {CANARY_HEALTHY_MS} ms): "
              f"{payload}", file=sys.stderr, flush=True)
    return False, payload


def _error_text(payload: dict) -> str:
    tail = payload.get("tail")
    return payload["error"] + (f"\n{tail}" if tail else "")


def run(args) -> int:
    """Print the component's tagged line (child mode, ``--component``), or
    run the components and print the JSON line: 0, or 1 if a row or the
    check failed or a canary breached."""
    dev = devinfo.resolve(args.device)
    if args.component:
        payload = _component_payload(args.component, args.quick, dev)
        print(json.dumps({"component": args.component, "payload": payload}), flush=True)
        return 0
    info = devinfo.card_info(dev)
    n_diff = 128 if args.quick else 512
    extras = {"backend": dev.type, **info, "timing": TIMING, "dtype": "float32",
              "counting_model": "shmem (6+1 words/cell/iter), reference parity",
              "vs_baselines": "the Julia reference's GPUs (BASELINE.md): T_eff 63.5 GB/s "
                              "Titan X float64, MG 0.154 s V100, NS explicit 1314 s Titan X "
                              "class, NS semi-implicit 25.5 s V100"}
    metric = (f"3D dual-time diffusion T_eff (counted 6+1 model) at {n_diff}^3, f32, "
              f"{info['device']}")
    healthy, extras["canary"] = _canary_gate("canary", args.quick, args.device)
    extras["canary_healthy_envelope_ms"] = list(CANARY_ENVELOPE_MS)
    if healthy is False:
        # a degraded card: the canary's evidence, not plausible-looking numbers
        print(json.dumps({"metric": metric, "value": None, "unit": "GB/s", "vs_baseline": None,
                          "env_degraded": True, "extras": extras}), flush=True)
        print("bench: the canary breached twice; no row was run", file=sys.stderr)
        return 1
    failed = []

    def component(name):
        payload = _run_component(name, args.quick, args.device)
        if "error" in payload:
            failed.append(name)
            extras[f"{name}_error"] = _error_text(payload)
            return None
        return payload

    aliased = _run_component("aliased", args.quick, args.device)
    if "skipped" in aliased:
        extras["aliased_kernel_check"] = None  # no card: unknown, not failed
    elif "error" in aliased:
        failed.append("aliased")
        extras["aliased_kernel_check"] = False
        extras["aliased_kernel_check_error"] = _error_text(aliased)
    else:
        extras["aliased_kernel_check"] = bool(aliased["passed"])
        if not aliased["passed"]:
            failed.append("aliased")
            extras["aliased_kernel_check_mismatches"] = aliased["mismatches"]
    diff = component("diffusion")
    if diff is not None:
        extras.update({"diffusion_grid": diff["grid"], "diffusion_iterations": diff["iterations"],
                       "diffusion_ms_per_iter": diff["ms_per_iter"],
                       "diffusion_gflops": diff["gflops"], "diffusion_iqr_s": diff["iqr_s"],
                       "diffusion_reps": diff["reps"]})
    if not args.skip_mg:
        n_mg = 1025 if args.quick else 4097
        mg = component("mg")
        if mg is not None:
            extras.update({
                "mg_grid": mg["grid"],
                "mg_solver": "ds defect correction + DST-513 ladder, V(5,5) deep smoothing "
                             "(mg_solve_ds)",
                "mg_seconds_to_tol1e-6": mg["seconds_to_tol"], "mg_iqr_s": mg["iqr_s"],
                "mg_reps": mg["reps"], "mg_outer_iterations": mg["outer_iterations"],
                "mg_true_f64_rel_residual": mg["true_f64_rel_residual"],
                "mg_device_seconds_one_solve": mg["device_seconds_one_solve"],
                "mg_vs_v100_0.154s": REF_MG_S / mg["seconds_to_tol"] if n_mg == 4097 else None,
            })
    if not (args.skip_ns or args.quick):
        ex, relaxed, semi, implicit = (component(name) for name in NS_ROWS)
        if ex is not None:
            extras.update({"ns_explicit_2049x513_Pr0.01_seconds": ex["seconds"],
                           "ns_rep_seconds": ex["rep_seconds"], "ns_iqr_s": ex["iqr_s"],
                           "ns_reps": ex["reps"], "ns_timed_steps": ex["timed_steps"],
                           "ns_vs_reference_1314s": REF_NS_EXPLICIT_S / ex["seconds"]})
        if relaxed is not None:
            if ex is not None and relaxed["timed_steps"] == ex["timed_steps"]:
                extras.update({"ns_explicit_relaxed_s_seconds": relaxed["seconds"],
                               **_ns_extras("ns_relaxed_s_", relaxed),
                               "ns_relaxed_s_tol_factor": RELAXED_S_TOL,
                               "ns_relaxed_vs_reference_1314s":
                                   REF_NS_EXPLICIT_S / relaxed["seconds"]})
            else:
                print(f"relaxed-S step parity broke: {relaxed['timed_steps']} != "
                      f"{ex and ex['timed_steps']}; withholding the relaxed row", flush=True)
                extras["ns_relaxed_s_parity_broken"] = True
        if semi is not None:
            extras.update({"ns_semi_implicit_seconds": semi["seconds"],
                           **_ns_extras("ns_semi_", semi),
                           "ns_semi_vs_reference_25.5s": REF_NS_SEMI_S / semi["seconds"]})
        if implicit is not None:
            extras.update({"ns_implicit_seconds": implicit["seconds"],
                           **_ns_extras("ns_implicit_", implicit)})
    if not args.quick:
        # a healthy canary before the rows does not vouch for the card after them
        post_ok, extras["canary_post"] = _canary_gate("canary_post", False, args.device)
        if post_ok is False:
            failed.append("canary_post")
            extras["env_degraded_after"] = True
    teff = diff["teff_gbs"] if diff is not None else None
    print(json.dumps({"metric": metric, "value": teff, "unit": "GB/s",
                      "vs_baseline": teff / REF_TEFF_GBS if teff is not None else None,
                      "extras": extras}), flush=True)
    if failed:
        print(f"bench: failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fpr_tpu_torch bench", description=__doc__.splitlines()[0])
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
