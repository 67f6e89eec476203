"""Multigrid sweep (fpr_tpu/experiments/multigrid_bench.py, the analog of
multigrid_bench.jl): the time to tol 1e-6 over k x l x coarse solver x
solver tier, resumed by key, a failed configuration printed and skipped
(multigrid_bench.jl:41-62), and so is a solve that stopped at its iteration
cap above tolerance: no row is a time to tolerance that was not reached.
The exit code is 1 when a configuration was skipped so.  ``--workprec`` compares instead MG as the
solver, unpreconditioned CG and MG-preconditioned CG: mg, mixed, ds, cg,
mg_pcg and mg_pcg_ds, the ds tiers at DST-513 V(5,5).

Tiers: ``direct`` is ``mg_solve`` in float64 (plain PyTorch), ``mixed``
``mg_solve_mixed`` (float64 defect correction around float32 V-cycles on
the legs #6/#7), ``ds`` ``mg_solve_ds`` (the double-single defect pass K1
and the legs K2/K3), ``mg_pcg_ds`` ``krylov.mg_pcg_ds``.  The right-hand
side is the bench's (``solvers.poisson.poisson_rhs``: numpy's uniform draw
from seed 0; the JAX sweep draws from jax.random), so compare counts, not
fields.  Each row is the median of 3 solves after a warm-up solve, on the
host clock up to a scalar read of the residual; ``device_s``, which the JAX
rows fill with a TPU time amortized over chained solves, stays empty.

    python -m fpr_tpu_torch.experiments.multigrid_bench --max-k 12
    python -m fpr_tpu_torch.experiments.multigrid_bench --workprec --max-k 10
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from fpr_tpu_torch.solvers.poisson import poisson_rhs
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.experiments import RESULTS
from fpr_tpu_torch.solvers import krylov, multigrid
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.io import append_csv_row, csv_has_row
from fpr_tpu_torch.utils.timing import timed_stats


def timed(fn, reps: int = 3):
    """(TimingStats of reps calls after one warm-up call, the warm-up's
    result (u, r, iterations)); each call ends in a scalar read of r."""
    r = fn()
    float(r[1])
    return timed_stats(lambda: float(fn()[1]), reps=reps), r


def converged(b, tol: float, r_rms, it: int, niters: int) -> bool:
    """Whether a solve reached r_rms < tol * rms(b): it stopped before its
    cap, or at the cap below tolerance (the test of _warn_unconverged)."""
    if it < niters:
        return True
    rms_b = float(torch.linalg.vector_norm(b, dtype=torch.float64)) / math.sqrt(b.numel())
    return float(r_rms) < tol * rms_b


def workprec(args, dev, backend, name) -> int:
    failed = 0
    for k in range(args.min_k, args.max_k + 1):
        n = 2**k + 1
        h = 1.0 / (n - 1)
        tol = args.tol
        # the ds tiers run the production ladder (DST-513, V(5,5)); mg, mixed
        # and cg keep the reference's V(2,2)
        ds_cfg = MGConfig(coarse_size=min(513, n), coarse_solver=CoarseSolver.DST,
                          pre_smooth=5, post_smooth=5)
        # solver: (iteration cap, solve)
        configs = {
            "mg": (30, lambda b: multigrid.mg_solve(torch.zeros_like(b), b, h, 0.0, tol, 30)),
            "mixed": (30, lambda b: multigrid.mg_solve_mixed(torch.zeros_like(b), b, h, 0.0,
                                                             tol, 30)),
            "ds": (30, lambda b: multigrid.mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=ds_cfg,
                                                       return_pair=True)),
            "cg": (40000, lambda b: krylov.cg(b, h, h, 0.0, tol, 40000)),
            "mg_pcg": (100, lambda b: krylov.mg_preconditioned_cg(b, h, 0.0, tol, 100)),
            "mg_pcg_ds": (60, lambda b: krylov.mg_pcg_ds(b, h, 0.0, tol, 60, return_pair=True,
                                                         cfg=ds_cfg)),
        }
        for solver, (niters, solve) in configs.items():
            if args.wp_solvers and solver not in args.wp_solvers.split(","):
                continue
            if solver == "mg" and k > args.mg64_max_k:
                continue
            if solver in ("mg", "cg") and k > args.f64_iter_max_k:
                continue
            if csv_has_row(args.out, dict(k=k, solver=solver, backend=backend)):
                continue
            try:
                # only the rhs this solver reads: float32 for the ds tiers
                ds_tier = solver in ("ds", "mg_pcg_ds")
                b = poisson_rhs(n, dev, np.float32 if ds_tier else np.float64)
                st, (_, r, it) = timed(lambda: solve(b))
                ok = converged(b, tol, r, int(it), niters)
            except Exception as exc:
                msg = str(exc).splitlines()[0][:200] if str(exc) else ""
                print(f"k={k} {solver}: FAILED {type(exc).__name__}: {msg}")
                failed += 1
                continue
            finally:
                b = r = None
            if not ok:
                print(f"k={k} {solver}: NOT converged in {niters} iterations, no row")
                failed += 1
                continue
            row = dict(k=k, solver=solver, backend=backend, device=name,
                       seconds=st.median_s, iters=int(it), iqr_s=st.iqr_s, reps=st.reps,
                       device_s="")
            append_csv_row(args.out, row, key_fields=("k", "solver", "backend"))
            print(row)
    return failed


def sweep(args, dev, backend, name) -> int:
    failed = 0
    for k in range(args.min_k, args.max_k + 1):
        n = 2**k + 1
        h = 1.0 / (n - 1)
        combos = [(l, coarse) for l in range(2, min(k - 2, args.max_l + 1))
                  for coarse in (CoarseSolver.JACOBI, CoarseSolver.CG)]
        if args.dst:
            # truncated ladders: the subtree at 2^l+1 solved exactly by the
            # sine transform; l = min(k, 9) is pure defect-corrected DST
            combos += [(l, CoarseSolver.DST) for l in sorted({6, min(k, 9)}) if l <= k]
        for l, coarse in combos:
            for solver in args.solvers.split(","):
                ns = args.smooths
                label = f"ds_v{ns}{ns}" if solver == "ds" and ns != 2 else solver
                key = dict(k=k, l=l, coarse=coarse.value, solver=label, backend=backend)
                if csv_has_row(args.out, key):
                    continue
                # deep smoothing rides the ds tier's fused legs only
                cfg = MGConfig(coarse_size=2**l + 1, coarse_solver=coarse,
                               **(dict(pre_smooth=ns, post_smooth=ns) if solver == "ds"
                                  else {}))
                try:
                    if solver == "ds":
                        b = poisson_rhs(n, dev, np.float32)
                        fn = lambda: multigrid.mg_solve_ds(  # noqa: E731
                            None, b, h, 0.0, args.tol, 30, cfg=cfg, return_pair=True)
                    elif solver == "mixed":
                        b = poisson_rhs(n, dev, np.float64)
                        fn = lambda: multigrid.mg_solve_mixed(  # noqa: E731
                            torch.zeros_like(b), b, h, 0.0, args.tol, 30, cfg=cfg)
                    elif solver == "direct":
                        b = poisson_rhs(n, dev, np.float64)
                        fn = lambda: multigrid.mg_solve(  # noqa: E731
                            torch.zeros_like(b), b, h, 0.0, args.tol, 30, cfg=cfg)
                    else:
                        raise ValueError(f"unknown solver {solver!r}")
                    st, (_, r, it) = timed(fn)
                    ok = converged(b, args.tol, r, int(it), 30)
                except Exception as exc:
                    print(f"k={k} l={l} {coarse.value} {solver}: FAILED "
                          f"{type(exc).__name__}: {exc}")
                    failed += 1
                    continue
                finally:
                    b = fn = r = None
                if not ok:
                    print(f"k={k} l={l} {coarse.value} {solver}: NOT converged in 30 "
                          "cycles, no row")
                    failed += 1
                    continue
                row = dict(**key, device=name, seconds=st.median_s, iters=int(it),
                           iqr_s=st.iqr_s, reps=st.reps, device_s="")
                append_csv_row(args.out, row,
                               key_fields=("k", "l", "coarse", "solver", "backend"))
                print(row)
    return failed


def main(argv=None) -> int:
    """Run the sweep; the number of configurations that failed or did not
    converge (their rows are not written)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-k", type=int, default=4)
    ap.add_argument("--max-k", type=int, default=12)
    ap.add_argument("--max-l", type=int, default=3)
    ap.add_argument("--solvers", default="direct,mixed,ds")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workprec", action="store_true",
                    help="MG vs CG vs MG-PCG comparison instead of the k/l sweep")
    ap.add_argument("--f64-iter-max-k", type=int, default=12,
                    help="largest k for the solvers that iterate in float64 (mg, cg) in "
                         "workprec mode: cg takes O(n) iterations and plain float64 MG about "
                         "ten full cycles, hours at k=14")
    ap.add_argument("--wp-solvers", default=None,
                    help="comma list restricting the workprec solver set")
    ap.add_argument("--mg64-max-k", type=int, default=11,
                    help="largest k for the plain float64 mg solver in workprec mode, whose "
                         "plain-PyTorch V-cycles cost the most time a solve")
    ap.add_argument("--dst", action="store_true",
                    help="add truncated-ladder DST coarse-solver configs (coarse='dst' rows) "
                         "to the k/l sweep")
    ap.add_argument("--smooths", type=int, default=2,
                    help="pre/post smooth count of the ds tier's fused legs (rows labelled "
                         "ds_vNN when != 2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.out is None:  # the two modes have different schemas
        args.out = (f"{RESULTS}/mg_workprecision.csv" if args.workprec
                    else f"{RESULTS}/bench_multigrid.csv")
    dev = devinfo.resolve(args.device)
    return (workprec if args.workprec else sweep)(args, dev, dev.type, devinfo.name(dev))


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
