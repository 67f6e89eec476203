"""A grid beyond one TPU's memory, solved by the sharded ds multigrid
(fpr_tpu/experiments/dist_mg_large.py): ``mg_solve_ds_sharded`` over
--devices row shards, or ``mg_solve_ds_sharded_2d`` over a --mesh YxX
(y, x) mesh, every shard on the one device (a virtual mesh, the
``cuda-virtual`` backend).  At k = 15 the 32769^2 float32 solver state is
about 21 GB, more than a 16 GB TPU v5e holds and within an 80 GB card.

One row a run: the outer count, the solver's claimed rms, the true float64
relative residual of hi + lo (computed on the device in row blocks after
the solve), the wall time, the per-shard state size and the device's peak
memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``; empty on the CPU).

    python -m fpr_tpu_torch.experiments.dist_mg_large --k 15 --devices 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fpr_tpu_torch.solvers.poisson import true_rel_residual
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.experiments import RESULTS
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.solvers import dist_mg_ds
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.io import append_csv_row

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=15)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--mesh", type=str, default=None, metavar="YxX",
                    help="a 2D (y, x) mesh instead of row shards, e.g. --devices 8 --mesh 4x2")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--coarse", type=int, default=513)
    ap.add_argument("--out", default=f"{RESULTS}/dist_mg_large.csv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = devinfo.resolve(args.device)
    if args.mesh:
        ndy, ndx = (int(v) for v in args.mesh.lower().split("x"))
        if ndy * ndx != args.devices:
            raise SystemExit(f"--mesh {args.mesh} needs {ndy * ndx} devices, --devices says "
                             f"{args.devices}")

    n = 2**args.k + 1
    h = 1.0 / (n - 1)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2), np.float32)
    b = torch.from_numpy(b).to(dev)
    cfg = MGConfig(coarse_size=args.coarse, coarse_solver=CoarseSolver.DST)

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if args.mesh:
        mesh = make_mesh((ndy, ndx), ("y", "x"), device=dev)
        (hi, lo), r_rms, iters = dist_mg_ds.mg_solve_ds_sharded_2d(b, h, 0.0, args.tol, 20,
                                                                   mesh, cfg=cfg)
    else:
        mesh = make_mesh((args.devices,), ("y",), device=dev)
        (hi, lo), r_rms, iters = dist_mg_ds.mg_solve_ds_sharded(b, h, 0.0, args.tol, 20, mesh,
                                                                axis="y", cfg=cfg)
    r_rms = float(r_rms)  # ends the solve's device work
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else ""

    rel = true_rel_residual(hi, lo, b, h)
    row = dict(
        k=args.k, n=n, devices=args.devices, mesh=args.mesh or f"{args.devices}x1",
        iters=int(iters), claimed_rms=r_rms, true_rel_residual=rel, wall_s=wall,
        # the fine level's per-shard solver state (u_ds, f, E/r temporaries)
        shard_state_gb=n * n * 4 * 5 / args.devices / 2**30,
        device_peak_gb=peak, backend="cuda-virtual" if on_card else "cpu-virtual",
        device=devinfo.name(dev),
    )
    print(row, flush=True)
    if not rel < 2 * args.tol:
        raise SystemExit(f"not converged: true relative residual {rel}")
    append_csv_row(args.out, row)


if __name__ == "__main__":
    main()
