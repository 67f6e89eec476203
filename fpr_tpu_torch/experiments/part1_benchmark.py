"""Diffusion sweep over grid sizes 2^e, e in 4:0.5:max-e, in three tiers
(fpr_tpu/experiments/part1_benchmark.py, the analog of
part1_benchmark.jl): plain PyTorch ("jnp"), the one-sweep kernel #8
("pallas") and the fused K-sweep kernel #10 at K=3 ("pallas_k3"); the
median of --reps solves, resumed by (n, policy, backend); a failed
configuration is printed and skipped, and the exit code is then 1.

    python -m fpr_tpu_torch.experiments.part1_benchmark [--out ...] [--max-e 7]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.experiments import RESULTS
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.io import append_csv_row, csv_has_row
from fpr_tpu_torch.utils.timing import stats_of

# the reference's array / kernel columns, plus the fusion depth K = 3
VARIANTS = ((ExecutionPolicy.JNP, 1, "jnp"), (ExecutionPolicy.PALLAS, 1, "pallas"),
            (ExecutionPolicy.PALLAS, 3, "pallas_k3"))


def main(argv=None) -> int:
    """Run the sweep; the number of configurations that failed (no row)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=f"{RESULTS}/bench_diffusion.csv")
    ap.add_argument("--ttot", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-e", type=float, default=7.0)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions per config (median + iqr recorded)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = devinfo.resolve(args.device)
    backend, name = dev.type, devinfo.name(dev)

    failed = 0
    for e in np.arange(4.0, args.max_e + 0.25, 0.5):
        n = int(round(2**e))
        for policy, check_every, label in VARIANTS:
            cfg = DiffusionConfig(nx=n, ny=n, nz=n, ttot=args.ttot, tol=args.tol,
                                  policy=policy, check_every=check_every)
            key = dict(n=n, policy=label, backend=backend)
            if csv_has_row(args.out, key):
                print(f"skip (cached): {key}")
                continue
            try:
                # the first solve builds the kernels; the median hides it
                outs = [diffusion3d.solve(cfg, dtype=torch.float32, device=dev)
                        for _ in range(max(1, args.reps))]
            except Exception as exc:  # keep sweeping (multigrid_bench.jl:41-62)
                print(f"n={n} policy={label}: FAILED {type(exc).__name__}: {exc}")
                failed += 1
                continue
            st = stats_of([o.bench.delta_t for o in outs])
            med = st.median_s
            out = min(outs, key=lambda o: abs(o.bench.delta_t - med))
            scale = out.bench.delta_t / med  # the rates at the median time
            row = {
                **key, "device": name,
                "iters": out.timed_iters,
                "seconds": med,
                "throughput_gbs": out.bench.throughput * scale / 1e9,
                "performance_gflops": out.bench.performance * scale / 1e9,
                "intensity": out.bench.intensity,
                "iqr_s": st.iqr_s,
                "reps": st.reps,
            }
            written = append_csv_row(args.out, row, key_fields=("n", "policy", "backend"))
            print(("wrote " if written else "skipped ") + str(row))
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
