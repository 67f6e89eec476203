"""Work-precision experiments of the 3D diffusion solver
(fpr_tpu/experiments/part1_error_experiments.py, the analogs of
part1_error_vs_grid_size_experiments.jl and
part1_error_vs_tolerance_experiments.jl), with the probe H(4.5, 4.5, 4.5):

- ``--mode grid``: grids 2^(4:0.5:max-e), ttot 2, tol 1e-6 (the float32
  kernel #8; with --f64 plain PyTorch in float64);
- ``--mode tol``: tol 1e-3 .. 1e-10 at --n, ttot 2, in the double-single
  tier (kernel #11), since the sweep goes below the float32 floor (with
  --f64 plain PyTorch in float64).

    python -m fpr_tpu_torch.experiments.part1_error_experiments --mode grid
    python -m fpr_tpu_torch.experiments.part1_error_experiments --mode tol --n 128
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.core.grid import Grid3D
from fpr_tpu_torch.experiments import RESULTS
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.io import append_csv_row, csv_has_row

TOLS = [10.0**-p for p in range(3, 11)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["grid", "tol"], required=True)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--max-e", type=float, default=7.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = devinfo.resolve(args.device)
    backend, name = dev.type, devinfo.name(dev)

    dtype = torch.float64 if args.f64 else torch.float32
    policy = ExecutionPolicy.JNP if args.f64 else ExecutionPolicy.PALLAS
    if args.mode == "tol" and not args.f64:
        policy = ExecutionPolicy.PALLAS_DS  # tol reaches 1e-10

    def solve(n, tol):
        cfg = DiffusionConfig(nx=n, ny=n, nz=n, ttot=2.0, tol=tol, policy=policy)
        res = diffusion3d.solve(cfg, dtype=dtype, device=dev)
        g = Grid3D(n, n, n)
        return dict(val=diffusion3d.probe_nearest(res.H, g),
                    interp_val=diffusion3d.probe_trilinear(res.H, g))

    if args.mode == "grid":
        out_csv = args.out or f"{RESULTS}/error_vs_grid_size.csv"
        runs = [dict(nx=int(round(2**e))) for e in np.arange(4.0, args.max_e + 0.25, 0.5)]
    else:
        out_csv = args.out or f"{RESULTS}/error_vs_tolerance.csv"
        runs = [dict(nx=args.n, tol=tol) for tol in TOLS]
    for key in runs:
        key["backend"] = backend
        if csv_has_row(out_csv, key):
            print(f"skip (cached): {key}")
            continue
        row = dict(**key, device=name, **solve(key["nx"], key.get("tol", 1e-6)))
        append_csv_row(out_csv, row, key_fields=tuple(key))
        print(row)


if __name__ == "__main__":
    main()
