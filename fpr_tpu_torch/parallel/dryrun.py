"""A dry run of the sharded tiers on small shapes (__graft_entry__.py::
dryrun_multichip, its parts that exist in the port).

    python -m fpr_tpu_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def dryrun_multichip(n_shards: int, device="cuda") -> None:
    """One step of each sharded workload on a virtual mesh of ``n_shards``
    shards on ``device``: (a) part 1's diffusion over a (z, y) mesh with the
    PALLAS tier (ghost refresh, the dual-time kernel with update boxes, the
    summed norm); (b) ``mg_solve_ds_sharded`` at 1025^2 over row shards,
    and for an even shard count above 2 ``mg_solve_ds_sharded_2d`` over an
    (n/2, 2) (y, x) mesh; (c) one semi-implicit NS step over row shards
    (the rhs-mode operator and three sharded ds solves, T under the
    BCs)."""
    from fpr_tpu_torch.core import bc
    from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy,
                                           MGConfig, NSConfig)
    from fpr_tpu_torch.models import dist_ns
    from fpr_tpu_torch.ops import stencil3d
    from fpr_tpu_torch.parallel import dist_diffusion
    from fpr_tpu_torch.parallel.mesh import make_mesh
    from fpr_tpu_torch.solvers import dist_mg_ds

    if n_shards % 2 == 0 and n_shards > 2:
        shape, axes = (n_shards // 2, 2), ("z", "y")
    else:
        shape, axes = (n_shards,), ("z",)
    mesh = make_mesh(shape, axes, device=device)
    cfg = DiffusionConfig(nx=16, ny=16 // (2 if len(axes) == 2 else 1), nz=4, ttot=0.2,
                          tol=0.0, iter_max=3, policy=ExecutionPolicy.PALLAS)
    step, grid = dist_diffusion.build_step(cfg, mesh)
    H = bc.dirichlet_faces_3d(stencil3d.init_gaussian(grid, torch.float32, device="cpu"))
    Ht = dist_diffusion.shard_field(H, mesh)
    Ht2, _, err, iters = step(Ht, Ht)
    if iters != 3 or not np.isfinite(dist_diffusion.gather_field(Ht2, mesh)).all():
        raise RuntimeError(f"dryrun diffusion: {iters} iterations or a non-finite field")
    print(f"dryrun_multichip: {n_shards}-shard {'x'.join(map(str, shape))} {'-'.join(axes)} "
          f"mesh on {device}, PALLAS tier, one physical step, {iters} pseudo-time "
          f"iterations, err={float(err):.3e}")

    n = 1025
    h = 1.0 / (n - 1)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    b = torch.tensor(b, device=device)
    mg_mesh = make_mesh((n_shards,), ("y",), device=device)
    (hi, _), r_rms, iters = dist_mg_ds.mg_solve_ds_sharded(
        b, h, 0.0, 1e-3, 10, mg_mesh, axis="y",
        cfg=MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST), replicate_below=513)
    if not torch.isfinite(hi).all() or not float(r_rms) < 1e-3 * float(torch.sqrt(torch.mean(b * b))):
        raise RuntimeError(f"dryrun mg_solve_ds_sharded: r_rms {float(r_rms):.3e}")
    print(f"dryrun_multichip: mg_solve_ds_sharded {n}^2 over {n_shards} row shards, "
          f"{iters} outer iterations, r_rms={float(r_rms):.3e}")
    if n_shards % 2 == 0 and n_shards > 2:
        mesh2 = make_mesh((n_shards // 2, 2), ("y", "x"), device=device)
        (hi2, _), r2, it2 = dist_mg_ds.mg_solve_ds_sharded_2d(
            b, h, 0.0, 1e-3, 10, mesh2,
            cfg=MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST), replicate_below=513)
        if not torch.isfinite(hi2).all() or not float(r2) < 1e-3 * float(
                torch.sqrt(torch.mean(b * b))):
            raise RuntimeError(f"dryrun mg_solve_ds_sharded_2d: r_rms {float(r2):.3e}")
        print(f"dryrun_multichip: mg_solve_ds_sharded_2d {n}^2 over a {n_shards // 2}x2 "
              f"(y, x) mesh, {it2} outer iterations, r_rms={float(r2):.3e}")

    ns_cfg = NSConfig(nx=129, ny=65, ttot=0.1, beta=0.5, Pr=0.01, tol=1e-7, niters=50)
    out = dist_ns.simulate_fast_sharded(ns_cfg, mg_mesh, max_steps=1, replicate_below=33)
    if out.steps != 1 or not np.isfinite(out.T).all() or not np.allclose(out.T[0], 1.0,
                                                                         atol=1e-6):
        raise RuntimeError("dryrun NS: the step failed or the Dirichlet plate moved")
    print(f"dryrun_multichip: semi-implicit NS step {ns_cfg.nx}x{ns_cfg.ny} over {n_shards} "
          f"row shards (beta=0.5, sharded Helmholtz+BC solves), sim_time={out.sim_time:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fpr_tpu_torch.parallel.dryrun")
    ap.add_argument("n_shards", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_shards, device=args.device)


if __name__ == "__main__":
    main()
