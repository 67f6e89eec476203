"""Command-line interface of the port (fpr_tpu/cli.py: the ``diffusion3d``,
``ns`` and ``mg`` subcommands):

    python -m fpr_tpu_torch diffusion3d --n 512 --policy pallas --check-every 3 --ttot 0.8 --bench
    python -m fpr_tpu_torch ns --nx 2049 --ny 513 --Pr 0.01 --tol 1e-7 --ttot 0.005 --fast
    python -m fpr_tpu_torch ns --nx 1025 --ny 257 --beta 0.5 --Pr 0.1 --tol 1e-7 --f64
    python -m fpr_tpu_torch mg --k 12 --l 9 --coarse dst --smooths 5 --solver ds
    python -m fpr_tpu_torch mg --k 12 --l 2 --coarse jacobi --solver mixed
    python -m fpr_tpu_torch mg --k 12 --l 9 --coarse dst --smooths 5 --solver ds --devices 4 --mesh 2x2

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels.  ``--devices N`` runs the sharded tier over a
virtual mesh of N shards, all on ``--device`` (``diffusion3d``: N z-shards
of n^3 cells each; ``ns --fast`` and ``mg --solver ds``: N row shards, or
with ``mg --mesh YxX`` a Y x X (y, x) mesh).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def cmd_diffusion3d(args):
    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu_torch.core.grid import Grid3D
    from fpr_tpu_torch.models import diffusion3d

    policy = ExecutionPolicy(args.policy)
    cfg = DiffusionConfig(nx=args.n, ny=args.n, nz=args.n, ttot=args.ttot, tol=args.tol,
                          policy=policy, check_every=args.check_every)
    dtype = torch.float64 if args.f64 else torch.float32
    if args.devices > 1:
        from fpr_tpu_torch.parallel import dist_diffusion
        from fpr_tpu_torch.parallel.mesh import make_mesh

        if policy is ExecutionPolicy.PALLAS_DS:
            raise SystemExit("--devices > 1 supports --policy jnp/pallas (the ds tier is a "
                             "single-device path)")
        if args.check_every > 1 and policy is not ExecutionPolicy.PALLAS:
            raise SystemExit("--check-every > 1 over a mesh needs --policy pallas")
        mesh = make_mesh((args.devices,), ("z",), device=args.device)
        out = dist_diffusion.solve_distributed(cfg, mesh, dtype=dtype, verbose=args.verbose)
    else:
        out = diffusion3d.solve(cfg, dtype=dtype, verbose=args.verbose, device=args.device)
    print(f"iterations: {out.iters_total} (converged: {out.converged})")
    if out.H.shape[0] == args.n:
        g = Grid3D(args.n, args.n, args.n)
        print(f"probe H(4.5,4.5,4.5): {diffusion3d.probe_nearest(out.H, g):.7f}")
    if args.bench:
        print(json.dumps(out.bench.row()))


def cmd_ns(args):
    from fpr_tpu_torch.core.config import NSConfig
    from fpr_tpu_torch.models import navier_stokes as ns

    from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig

    # --fast ignores --policy and keeps the default MGConfig, which
    # fast_mg_default may upgrade to the DST-257 V(3,3) ladder
    mg = MGConfig() if args.fast else MGConfig(policy=ExecutionPolicy(args.policy))
    cfg = NSConfig(
        nx=args.nx, ny=args.ny, Ra=args.Ra, Pr=args.Pr, beta=args.beta,
        ttot=args.ttot, tol=args.tol, niters=args.niters, mg=mg,
        mg_auto=not args.no_mg_auto,
    )
    if args.devices > 1 and not args.fast:
        raise SystemExit("--devices > 1 runs the sharded fast loop: add --fast")
    if args.fast:
        if args.f64:
            raise SystemExit("--fast is float32-only; drop --f64 or drop --fast")
        if args.devices > 1:
            from fpr_tpu_torch.models import dist_ns
            from fpr_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh((args.devices,), ("y",), device=args.device)
            out = dist_ns.simulate_fast_sharded(cfg, mesh, verbose=args.verbose,
                                                max_steps=args.max_steps)
        else:
            out = ns.simulate_fast(cfg, verbose=args.verbose, max_steps=args.max_steps,
                                   device=args.device)
    else:
        out = ns.simulate(cfg, verbose=args.verbose, max_steps=args.max_steps,
                          dtype=torch.float64 if args.f64 else torch.float32,
                          device=args.device)
    print(
        f"steps: {out.steps}  sim_time: {out.sim_time:.6f}  "
        f"timed: {out.t_elapsed:.3f}s  T in [{out.T.min():.3f}, {out.T.max():.3f}]"
    )


def cmd_mg(args):
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.ops import stencil2d
    from fpr_tpu_torch.solvers import multigrid

    if args.devices > 1 and args.solver != "ds":
        raise SystemExit("--devices > 1 requires --solver ds (the sharded tier)")
    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(v) for v in args.mesh.lower().split("x"))
        if len(mesh_shape) != 2 or mesh_shape[0] * mesh_shape[1] != args.devices:
            raise SystemExit(f"--mesh {args.mesh} needs {mesh_shape[0] * mesh_shape[-1]} "
                             f"devices, --devices says {args.devices}")
    if args.smooths < 1:
        raise SystemExit("--smooths must be >= 1 (the convergence check reads the "
                         "final post-smooth's residual norm)")
    if args.solver == "ds" and args.smooths > 6:
        raise SystemExit("--solver ds takes --smooths 1..6 (the fused legs"
                         + (", and the sharded tier's one halo exchange per leg)"
                            if args.devices > 1 else ")"))
    n = 2**args.k + 1
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=2**args.l + 1, coarse_solver=CoarseSolver(args.coarse),
                   pre_smooth=args.smooths, post_smooth=args.smooths)
    dtype = np.float64 if (args.f64 or args.solver == "mixed") else np.float32
    b = np.zeros((n, n), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    b = torch.as_tensor(b).to(args.device)
    if args.solver == "ds":
        b = b.to(torch.float32)

    def solve():
        """(the solution as a tuple of parts to add in float64, r_rms, count)"""
        if args.devices > 1:
            from fpr_tpu_torch.parallel.mesh import make_mesh
            from fpr_tpu_torch.solvers import dist_mg_ds

            if mesh_shape is not None:
                mesh = make_mesh(mesh_shape, ("y", "x"), device=args.device)
                return dist_mg_ds.mg_solve_ds_sharded_2d(b, h, 0.0, args.tol, 30, mesh,
                                                         cfg=cfg)
            mesh = make_mesh((args.devices,), ("y",), device=args.device)
            return dist_mg_ds.mg_solve_ds_sharded(b, h, 0.0, args.tol, 30, mesh, cfg=cfg)
        if args.solver == "ds":
            return multigrid.mg_solve_ds(None, b, h, 0.0, args.tol, 30, cfg=cfg,
                                         return_pair=True)
        fn = multigrid.mg_solve_mixed if args.solver == "mixed" else multigrid.mg_solve
        u, r, it = fn(torch.zeros_like(b), b, h, 0.0, args.tol, 30, cfg=cfg)
        return (u,), r, it

    _, r, _ = solve()
    float(r)  # build the kernels, converge once
    t0 = time.perf_counter()
    parts, r, it = solve()
    float(r)
    dt = time.perf_counter() - t0
    u64 = sum(p.double() for p in parts)
    b64 = b.double()
    rel = float(stencil2d.rms(stencil2d.residual(u64, b64, h, 0.0)) / stencil2d.rms(b64))
    print(f"{n}^2 -> coarse {cfg.coarse_size}^2 [{args.solver}]: {dt * 1e3:.1f} ms, "
          f"{it} iterations, r_rms/f_rms = {float(r) / float(stencil2d.rms(b64)):.2e}, "
          f"true f64 r_rms/f_rms = {rel:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fpr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("diffusion3d", help="3D pseudo-transient diffusion (part 1)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--ttot", type=float, default=1.0)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--policy", choices=["jnp", "pallas", "pallas_ds"], default="pallas",
                   help="jnp: plain PyTorch; pallas: the float32 kernel; pallas_ds: the "
                        "double-single kernel, for tolerances below the float32 floor")
    p.add_argument("--check-every", type=int, default=1,
                   help="pallas only: K iterations per call between convergence checks")
    p.add_argument("--f64", action="store_true", help="float64 (the jnp tier, or the CPU)")
    p.add_argument("--devices", type=int, default=1,
                   help="shards of a virtual z mesh on --device, each n^3 cells")
    p.add_argument("--bench", action="store_true",
                   help="print the counted performance model as one JSON line")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_diffusion3d)

    p = sub.add_parser("ns", help="2D Navier-Stokes thermal convection")
    p.add_argument("--device", default="cuda")
    p.add_argument("--nx", type=int, default=257)
    p.add_argument("--ny", type=int, default=65)
    p.add_argument("--Ra", type=float, default=1e6)
    p.add_argument("--Pr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--ttot", type=float, default=0.1)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--niters", type=int, default=50)
    p.add_argument("--policy", choices=["jnp", "pallas"], default="jnp",
                   help="host loop: plain PyTorch or the stencil-pass kernel in mg_solve")
    p.add_argument("--f64", action="store_true", help="host loop: float64 state")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--fast", action="store_true",
                   help="the fused fast loop (float32 state, double-single multigrid)")
    p.add_argument("--no-mg-auto", action="store_true",
                   help="keep the default MG ladder instead of DST-257, V(3,3)")
    p.add_argument("--devices", type=int, default=1,
                   help="--fast: row shards of a virtual mesh on --device")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_ns)

    p = sub.add_parser("mg", help="2D Poisson multigrid solve")
    p.add_argument("--device", default="cuda")
    p.add_argument("--k", type=int, default=10, help="grid is (2^k+1)^2")
    p.add_argument("--l", type=int, default=2, help="coarse grid is (2^l+1)^2")
    p.add_argument("--coarse", choices=["jacobi", "cg", "dst"], default="jacobi")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--solver", choices=["direct", "mixed", "ds"], default="direct",
                   help="direct: mg_solve; mixed: float64 defect correction around "
                        "float32 V-cycles; ds: double-single defect correction")
    p.add_argument("--smooths", type=int, default=2)
    p.add_argument("--f64", action="store_true", help="direct: a float64 solve")
    p.add_argument("--devices", type=int, default=1,
                   help="--solver ds: row shards of a virtual mesh on --device")
    p.add_argument("--mesh", default=None,
                   help="--solver ds: a YxX (y, x) mesh of the --devices shards instead")
    p.set_defaults(fn=cmd_mg)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
