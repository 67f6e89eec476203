"""Command-line interface of the port (fpr_tpu/cli.py: the single-device
``diffusion3d``, ``ns --fast`` and ``mg --solver ds`` subcommands):

    python -m fpr_tpu_torch diffusion3d --n 512 --policy pallas --check-every 3 --ttot 0.8 --bench
    python -m fpr_tpu_torch ns --nx 2049 --ny 513 --Pr 0.01 --tol 1e-7 --ttot 0.005 --fast
    python -m fpr_tpu_torch mg --k 12 --l 9 --coarse dst --smooths 5

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels.
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

    cfg = DiffusionConfig(nx=args.n, ny=args.n, nz=args.n, ttot=args.ttot, tol=args.tol,
                          policy=ExecutionPolicy(args.policy), check_every=args.check_every)
    out = diffusion3d.solve(cfg, dtype=torch.float64 if args.f64 else torch.float32,
                            verbose=args.verbose, device=args.device)
    print(f"iterations: {out.iters_total} (converged: {out.converged})")
    g = Grid3D(args.n, args.n, args.n)
    print(f"probe H(4.5,4.5,4.5): {diffusion3d.probe_nearest(out.H, g):.7f}")
    if args.bench:
        print(json.dumps(out.bench.row()))


def cmd_ns(args):
    from fpr_tpu_torch.core.config import NSConfig
    from fpr_tpu_torch.models import navier_stokes as ns

    if not args.fast:
        raise SystemExit("only the fused fast path is ported: pass --fast")
    cfg = NSConfig(
        nx=args.nx, ny=args.ny, Ra=args.Ra, Pr=args.Pr, beta=args.beta,
        ttot=args.ttot, tol=args.tol, niters=args.niters, mg_auto=not args.no_mg_auto,
    )
    out = ns.simulate_fast(cfg, verbose=args.verbose, max_steps=args.max_steps,
                           device=args.device)
    print(
        f"steps: {out.steps}  sim_time: {out.sim_time:.6f}  "
        f"timed: {out.t_elapsed:.3f}s  T in [{out.T.min():.3f}, {out.T.max():.3f}]"
    )


def cmd_mg(args):
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.ops import stencil2d
    from fpr_tpu_torch.solvers import multigrid

    if not 1 <= args.smooths <= 6:
        raise SystemExit("--smooths must be in 1..6 (the fused legs)")
    n = 2**args.k + 1
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=2**args.l + 1, coarse_solver=CoarseSolver(args.coarse),
                   pre_smooth=args.smooths, post_smooth=args.smooths)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    b = torch.as_tensor(b).to(args.device)

    def solve():
        return multigrid.mg_solve_ds(None, b, h, 0.0, args.tol, 30, cfg=cfg,
                                     return_pair=True)

    _, r, _ = solve()
    float(r)  # build the kernels, converge once
    t0 = time.perf_counter()
    (uh, ul), r, it = solve()
    float(r)
    dt = time.perf_counter() - t0
    u64 = uh.double() + ul.double()
    b64 = b.double()
    rel = float(stencil2d.rms(stencil2d.residual(u64, b64, h, 0.0)) / stencil2d.rms(b64))
    print(f"{n}^2 -> coarse {cfg.coarse_size}^2 [ds]: {dt * 1e3:.1f} ms, "
          f"{it} iterations, true f64 r_rms/f_rms = {rel:.2e}")


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
    p.add_argument("--bench", action="store_true",
                   help="print the counted performance model as one JSON line")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_diffusion3d)

    p = sub.add_parser("ns",help="2D Navier-Stokes thermal convection, fast path")
    p.add_argument("--device", default="cuda")
    p.add_argument("--nx", type=int, default=257)
    p.add_argument("--ny", type=int, default=65)
    p.add_argument("--Ra", type=float, default=1e6)
    p.add_argument("--Pr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--ttot", type=float, default=0.1)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--niters", type=int, default=50)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--fast", action="store_true", help="the fused fast path (required)")
    p.add_argument("--no-mg-auto", action="store_true",
                   help="keep the default MG ladder instead of DST-257, V(3,3)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_ns)

    p = sub.add_parser("mg", help="2D Poisson multigrid solve, double-single")
    p.add_argument("--device", default="cuda")
    p.add_argument("--k", type=int, default=10, help="grid is (2^k+1)^2")
    p.add_argument("--l", type=int, default=2, help="coarse grid is (2^l+1)^2")
    p.add_argument("--coarse", choices=["jacobi", "dst"], default="jacobi")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--solver", choices=["ds"], default="ds")
    p.add_argument("--smooths", type=int, default=2)
    p.set_defaults(fn=cmd_mg)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
