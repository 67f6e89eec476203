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
  relative residual of hi + lo (after the timed region), and the summed
  device time of one solve from torch.profiler.
- ``bench_ns_row``: ``simulate_fast`` at 2049x513, Pr 0.01, tol 1e-7, ttot
  0.005, seed 0: explicit at s_tol_factor 1 and 100 (the relaxed row is
  withheld unless its timed steps equal the first row's), semi-implicit
  (beta 0.5) and implicit (beta 1); each the median of 3 runs' timed
  windows (steps 1-3 are warm-up).

``--quick`` runs diffusion at 128^3 for 99 iterations and MG at 1025^2,
without NS.  ``--device cpu`` runs the kernels' plain PyTorch versions and
labels every row ``cpu``; with the default ``--device cuda`` and no card
the bench exits non-zero.  A row that raises makes the bench exit non-zero
after it has printed the line with what it has.

The ``vs_`` ratios are against the Julia reference's GPU figures
(BASELINE.md): T_eff 63.5 GB/s (Titan X, float64), MG 0.154 s (V100), NS
explicit 1314 s (Titan X class) and semi-implicit 25.5 s (V100).
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from fpr_tpu_torch.core import bc
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig, NSConfig
from fpr_tpu_torch.core.grid import Grid3D, pseudo_timestep
from fpr_tpu_torch.models.navier_stokes import simulate_fast
from fpr_tpu_torch.ops import dual_time, stencil3d
from fpr_tpu_torch.solvers.multigrid import mg_solve_ds
from fpr_tpu_torch.solvers.poisson import poisson_rhs, true_rel_residual
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils import profiling
from fpr_tpu_torch.utils.timing import diffusion_bench_results, stats_of, timed_stats

REF_TEFF_GBS = 63.5
REF_MG_S = 0.154
REF_NS_EXPLICIT_S = 1314.0
REF_NS_SEMI_S = 25.5
K = 3  # iterations a call of the fused K-sweep kernel
RELAXED_S_TOL = 100.0
TIMING = ("median of 3 reps, 5 for MG; host clock around work that ends in "
          "torch.cuda.synchronize() or a scalar read (NS: each run's timed window, after "
          "its 3 warm-up steps); iqr_s is the spread")


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
    on the card also the device time of one solve."""
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
    dev_s = profiling.device_seconds(run, dev) if dev.type == "cuda" else None
    return dict(grid=f"{n}^2", seconds_to_tol=stats.median_s, iqr_s=stats.iqr_s,
                reps=stats.reps, outer_iterations=int(it),
                true_f64_rel_residual=true_rel_residual(uh, ul, b, h),
                profiler_device_seconds_one_solve=dev_s)


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


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--quick", action="store_true",
                   help="diffusion 128^3 for 99 iterations and MG 1025^2, no NS")
    p.add_argument("--skip-mg", action="store_true")
    p.add_argument("--skip-ns", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu (the plain versions)")


def _ns_extras(prefix: str, row: dict) -> dict:
    return {f"{prefix}rep_seconds": row["rep_seconds"], f"{prefix}iqr_s": row["iqr_s"],
            f"{prefix}reps": row["reps"], f"{prefix}timed_steps": row["timed_steps"]}


def run(args) -> int:
    """Run the rows and print the JSON line; 0, or 1 if a row raised."""
    dev = devinfo.resolve(args.device)
    info = devinfo.card_info(dev)
    n_diff, cap = (128, 99) if args.quick else (512, 300)
    extras = {"backend": dev.type, **info, "timing": TIMING, "dtype": "float32",
              "counting_model": "shmem (6+1 words/cell/iter), reference parity",
              "vs_baselines": "the Julia reference's GPUs (BASELINE.md): T_eff 63.5 GB/s "
                              "Titan X float64, MG 0.154 s V100, NS explicit 1314 s Titan X "
                              "class, NS semi-implicit 25.5 s V100"}
    failed = []

    def row(name, fn):
        try:
            return fn()
        except Exception as exc:  # the line is printed with the other rows
            traceback.print_exc()
            failed.append(name)
            extras[f"{name}_error"] = f"{type(exc).__name__}: {exc}"
            return None

    diff = row("diffusion", lambda: bench_diffusion(n_diff, cap, device=dev))
    if diff is not None:
        extras.update({"diffusion_grid": diff["grid"], "diffusion_iterations": diff["iterations"],
                       "diffusion_ms_per_iter": diff["ms_per_iter"],
                       "diffusion_gflops": diff["gflops"], "diffusion_iqr_s": diff["iqr_s"],
                       "diffusion_reps": diff["reps"]})
    if not args.skip_mg:
        n_mg = 1025 if args.quick else 4097
        mg = row("mg", lambda: bench_mg(n_mg, device=dev))
        if mg is not None:
            extras.update({
                "mg_grid": mg["grid"],
                "mg_solver": "ds defect correction + DST-513 ladder, V(5,5) deep smoothing "
                             "(mg_solve_ds)",
                "mg_seconds_to_tol1e-6": mg["seconds_to_tol"], "mg_iqr_s": mg["iqr_s"],
                "mg_reps": mg["reps"], "mg_outer_iterations": mg["outer_iterations"],
                "mg_true_f64_rel_residual": mg["true_f64_rel_residual"],
                "mg_profiler_device_seconds_one_solve": mg["profiler_device_seconds_one_solve"],
                "mg_vs_v100_0.154s": REF_MG_S / mg["seconds_to_tol"] if n_mg == 4097 else None,
            })
    if not (args.skip_ns or args.quick):
        ex = row("ns_explicit", lambda: bench_ns_row(0.0, device=dev))
        relaxed = row("ns_relaxed_s",
                      lambda: bench_ns_row(0.0, s_tol_factor=RELAXED_S_TOL, device=dev))
        semi = row("ns_semi", lambda: bench_ns_row(0.5, device=dev))
        implicit = row("ns_implicit", lambda: bench_ns_row(1.0, device=dev))
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
    teff = diff["teff_gbs"] if diff is not None else None
    print(json.dumps({
        "metric": f"3D dual-time diffusion T_eff (counted 6+1 model) at {n_diff}^3, f32, "
                  f"{info['device']}",
        "value": teff, "unit": "GB/s",
        "vs_baseline": teff / REF_TEFF_GBS if teff is not None else None,
        "extras": extras,
    }), flush=True)
    if failed:
        print(f"bench: rows failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fpr_tpu_torch bench", description=__doc__.splitlines()[0])
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
