"""The sharded 3D diffusion solver over a virtual z-mesh on one device
(fpr_tpu/experiments/part1_scaling.py, the analog of
part1_scaling_experiments.jl): strong mode splits a fixed n^3 global grid
over the shards, weak mode gives each shard n^3 cells and scales the
domain with the shard grid (``scale_physical_size``); tol 1e-6.

Every shard lives on the one device, so a row measures what the sharded
program costs there (its halo copies and launches), not scaling: each row
says ``virtual=True``, the JAX rows' mark of a virtual mesh.  On a
card the shards run the PALLAS tier (#8 with its update boxes), on the CPU
plain PyTorch, as the JAX module runs PALLAS only on a TPU.

    python -m fpr_tpu_torch.experiments.part1_scaling --mode weak --devices 4
"""

from __future__ import annotations

import argparse

import torch

from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.experiments import RESULTS
from fpr_tpu_torch.parallel import dist_diffusion
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.utils import device as devinfo
from fpr_tpu_torch.utils.io import append_csv_row, csv_has_row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["strong", "weak"], default="weak")
    ap.add_argument("--n", type=int, default=128, help="base edge length")
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the virtual z-mesh, all on --device")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--ttot", type=float, default=1.0)
    ap.add_argument("--out", default=f"{RESULTS}/diffusion_scaling.csv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = devinfo.resolve(args.device)
    backend = dev.type

    n_dev = args.devices
    policy = ExecutionPolicy.PALLAS if backend == "cuda" else ExecutionPolicy.JNP
    if args.mode == "strong":
        if args.n % n_dev:
            ap.error(f"strong mode: --n {args.n} must be divisible by the shard count "
                     f"{n_dev} (the global grid would shrink)")
        nz_local, scale = args.n // n_dev, False
    else:
        nz_local, scale = args.n, True
    key = dict(mode=args.mode, n=args.n, devices=n_dev, backend=backend)
    if csv_has_row(args.out, key):
        print(f"skip (cached): {key}")
        return
    cfg = DiffusionConfig(nx=args.n, ny=args.n, nz=nz_local, ttot=args.ttot, tol=args.tol,
                          scale_physical_size=scale, policy=policy)
    mesh = make_mesh((n_dev,), ("z",), device=dev)
    out = dist_diffusion.solve_distributed(cfg, mesh, dtype=torch.float32)
    row = dict(
        **key, device=devinfo.name(dev), virtual=True, policy=policy.value,
        iters=out.timed_iters, seconds=out.bench.delta_t,
        throughput_gbs=out.bench.throughput / 1e9,
        performance_gflops=out.bench.performance / 1e9,
    )
    append_csv_row(args.out, row, key_fields=("mode", "n", "devices", "backend"))
    print(row)


if __name__ == "__main__":
    main()
