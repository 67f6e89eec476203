"""Semi-implicit against explicit NS time stepping
(fpr_tpu/experiments/ns_timestepping.py, the analog of
part2_semi_implicit_vs_explicit_experiments.jl): Pr in 10^(-3..1) x beta in
{0, 0.5, 1} at 2049x513 (``--small``: 513x129), ttot 0.005, tol 1e-7; the
steps, timed steps and the median of --reps runs' timed windows (steps
1-3 are warm-up), resumed by (Pr, beta, nx, backend, solver); a failed
run is printed and skipped, and the exit code is then 1.

Solvers: ``fast`` is ``simulate_fast`` (float32 state, the fused operator
K4 and the double-single multigrid K1-K3), ``direct`` and ``mixed`` the
host loop ``simulate`` with ``mg_solve`` (plain PyTorch) or
``mg_solve_mixed`` (float64 defect correction around the legs #6/#7).
W starts from numpy's draw of seed 0, so semi- and fully implicit step
counts sit in the seed band of the JAX sweep's, not on its values.

    python -m fpr_tpu_torch.experiments.ns_timestepping --solver fast
    python -m fpr_tpu_torch.experiments.ns_timestepping --small
"""

from __future__ import annotations

import argparse
import sys

import torch

from fpr_tpu_torch.core.config import CoarseSolver, MGConfig, NSConfig
from fpr_tpu_torch.experiments import RESULTS
from fpr_tpu_torch.models import navier_stokes as ns
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.io import append_csv_row, csv_has_row
from fpr_tpu_torch.utils.timing import stats_of

PR_VALUES = (1e-3, 1e-2, 1e-1, 1.0, 10.0)


def main(argv=None) -> int:
    """Run the sweep; the number of configurations that failed (no row)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=f"{RESULTS}/ns_semi_implicit_vs_explicit.csv")
    ap.add_argument("--ttot", type=float, default=0.005)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--solver", choices=["direct", "mixed", "fast"], default="direct",
                    help="'fast' = simulate_fast (the fused operator kernel and the "
                         "double-single multigrid)")
    ap.add_argument("--Pr", type=float, default=None, help="single-Pr run")
    ap.add_argument("--betas", type=str, default=None, metavar="B0,B1",
                    help="comma list restricting the beta sweep (e.g. '0.5,1.0')")
    ap.add_argument("--mg-dst", type=int, default=None, metavar="COARSE",
                    help="fast tier: truncate the MG ladder at COARSE (= 2^l+1) with the DST "
                         "coarse solve, overriding fast_mg_default's DST-257")
    ap.add_argument("--s-tol-factor", type=float, default=None,
                    help="fast tier only: solve the streamfunction to FACTOR*tol*rms(W) "
                         "(NSConfig.s_tol_factor), FACTOR > 0")
    ap.add_argument("--label", type=str, default=None,
                    help="the CSV solver label (the resume key's tier name)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed repetitions (median + iqr recorded); default 3 for the fast "
                         "tier, 1 for the host loop")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.solver == "fast" and args.f64:
        raise SystemExit("--solver fast is the float32 path (no --f64)")
    mg_kw = {}
    if args.mg_dst is not None:
        if args.solver != "fast":
            raise SystemExit("--mg-dst applies to the fast tier only")
        mg_kw["mg"] = MGConfig(coarse_size=args.mg_dst, coarse_solver=CoarseSolver.DST)
    if args.s_tol_factor is not None:
        if args.solver != "fast":
            raise SystemExit("--s-tol-factor applies to the fast tier")
        if not args.s_tol_factor > 0:
            raise SystemExit(f"--s-tol-factor must be > 0, got {args.s_tol_factor}")
        mg_kw["s_tol_factor"] = args.s_tol_factor
    dev = devinfo.resolve(args.device)
    backend, name = dev.type, devinfo.name(dev)

    nx, ny = (513, 129) if args.small else (2049, 513)
    dtype = torch.float64 if (args.solver == "mixed" or args.f64) else torch.float32
    pr_values = [args.Pr] if args.Pr is not None else PR_VALUES
    # --mg-dst and relaxed-tolerance rows are tiers of their own in the CSV
    solver_label = args.label or (f"fast_dst{args.mg_dst}" if args.mg_dst else args.solver)
    if args.s_tol_factor is not None and not args.label:
        solver_label = f"{solver_label}_stol{args.s_tol_factor:g}"
    betas = (tuple(float(b) for b in args.betas.split(",")) if args.betas
             else (0.0, 0.5, 1.0))
    reps = args.reps if args.reps else (3 if args.solver == "fast" else 1)

    failed = 0
    for Pr in pr_values:
        for beta in betas:
            key = dict(Pr=Pr, beta=beta, nx=nx, backend=backend, solver=solver_label)
            if csv_has_row(args.out, key):
                print(f"skip (cached): {key}")
                continue
            cfg = NSConfig(nx=nx, ny=ny, Pr=Pr, beta=beta, ttot=args.ttot, tol=args.tol,
                           niters=50, mg_solver=args.solver, **mg_kw)
            try:
                if args.solver == "fast":
                    outs = [ns.simulate_fast(cfg, max_steps=args.max_steps, device=dev)
                            for _ in range(max(1, reps))]
                else:
                    outs = [ns.simulate(cfg, dtype=dtype, max_steps=args.max_steps, device=dev)
                            for _ in range(max(1, reps))]
            except Exception as exc:
                print(f"Pr={Pr} beta={beta}: FAILED {type(exc).__name__}: {exc}")
                failed += 1
                continue
            st = stats_of([o.t_elapsed for o in outs])
            out = outs[-1]
            row = dict(Pr=Pr, beta=beta, nx=nx, ny=ny, backend=backend, device=name,
                       solver=solver_label, steps=out.steps, timed_steps=out.timed_iters,
                       seconds=st.median_s, iqr_s=st.iqr_s, reps=st.reps)
            append_csv_row(args.out, row, key_fields=("Pr", "beta", "nx", "backend", "solver"))
            print(row)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
