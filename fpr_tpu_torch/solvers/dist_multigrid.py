"""The GSPMD tier: ``mg_solve`` on row-sharded fields (fpr_tpu/solvers/
dist_multigrid.py: _make_constrain, mg_solve_sharded).

JAX shards the global arrays of every level with at least
``replicate_below`` rows by rows, replicates the smaller ones, and lets
XLA's partitioner insert the one-row halo exchanges and the norms' sums
(a ``constrain`` hook in ``multigrid.vcycle``).  PyTorch has no
partitioner, so on the port's single-controller mesh the counterpart is
the plain (JNP-policy) V-cycle on per-shard row blocks: no new kernel.

A sharded level's field is a list of per-shard blocks (GR + ny_l + GR, nx)
(``RowShards``), each shard owning ``ny_l >> m`` rows at level m.  Every
plain operator of ``ops.stencil2d`` and ``ops.transfer`` runs per shard
after ``halo.refresh_rows``, with the row hooks (``ops.rows.Rows``) doing
what the global ring did: residuals are zero on the global boundary rows
and past the grid, red-black colours follow the global row, and norms are
shard-order sums over the owned rows.  GR = 2 ghost rows: an even count, so
local row parity is global parity at every level (the transfers), and
enough for red-black's second half-sweep, which reads rows the first one
updated.  Per-cell arithmetic is that of the single-device operators, so
the fields come out bitwise equal and the norms equal up to the order of
the sums.  The first level with fewer than ``replicate_below`` rows (or
the coarse-solve level) is gathered to shard 0, where the rest of the
recursion runs with the port's plain ``vcycle``, and its correction is
sliced back onto the shards with ghost rows.

The iterate loop is a ``core.loops.while_loop``, JAX's ``lax.while_loop``,
and a solve one device call in ``mesh.route()``: on a mesh whose shards
share one CUDA device one launch of a cached CUDA graph (or WHILE nodes
in the sharded NS step's graph), the host reading (r_rms, tolf, cycles)
once at the end; on a mesh over several devices the plain host loops.
The global-row masks of ``zero_boundary_rows`` are built once a solve,
before its loop (``row_masks``).
"""

from __future__ import annotations

import dataclasses

import torch

from fpr_tpu_torch.core import bc, loops
from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig, Restriction, Smoother
from fpr_tpu_torch.core.grid import mg_levels
from fpr_tpu_torch.ops import reductions, stencil2d, transfer
from fpr_tpu_torch.ops.rows import Rows
from fpr_tpu_torch.parallel.halo import refresh_rows
from fpr_tpu_torch.solvers.multigrid import (_c_arg, _c_key, _inf, _int0, _outcome,
                                             _warn_unconverged, mg_solve, vcycle)

GR = 2  # ghost rows on each side of a block


@dataclasses.dataclass(frozen=True)
class RowPlan:
    ny: int
    nx: int
    ndev: int
    s: int      # sharded levels (0: nothing is sharded)
    ny_l: int   # local rows at the fine level

    def level(self, m: int):
        """(ny_l_m, ny_g_m, nx_g_m) of level m."""
        return (self.ny_l >> m, ((self.ny - 1) >> m) + 1, ((self.nx - 1) >> m) + 1)

    def rows(self, m: int, d: int) -> Rows:
        """The row hooks of shard d's block at level m."""
        ny_lm, ny_gm, _ = self.level(m)
        return Rows(d * ny_lm - GR, ny_gm, (GR, GR + ny_lm))


def plan_rows(ny: int, nx: int, ndev: int, cfg: MGConfig, replicate_below: int = 257) -> RowPlan:
    """The levels JAX shards (at least ``replicate_below`` rows; here all but
    the coarse-solve level) and a local row count that keeps every sharded
    level's shard offsets even."""
    levels = mg_levels(nx, ny, cfg.coarse_size)
    s = 0
    for m, (_, nym) in enumerate(levels):
        if nym >= replicate_below and m < len(levels) - 1:
            s += 1
        else:
            break
    align = 1 << max(s, 1)
    return RowPlan(ny, nx, ndev, s, -(-ny // (ndev * align)) * align)


@dataclasses.dataclass
class RowShards:
    """A global (ny, nx) field as per-shard blocks (GR + ny_l + GR, nx) at the
    fine level of ``plan``: ghost rows stale until a refresh, zero rows past
    the grid."""
    blocks: list
    plan: RowPlan

    @classmethod
    def of(cls, a: torch.Tensor, plan: RowPlan, mesh) -> "RowShards":
        return cls(_slice_rows(a, plan.ny_l, plan.ndev, mesh), plan)

    def gather(self, device=None) -> torch.Tensor:
        """The global field on ``device`` (default shard 0's)."""
        device = self.blocks[0].device if device is None else device
        return torch.cat([b[GR:GR + self.plan.ny_l].to(device) for b in self.blocks])[
            :self.plan.ny]


def _slice_rows(a: torch.Tensor, n_l: int, ndev: int, mesh) -> list:
    """Per-shard blocks (GR + n_l + GR, nx) of a global field, ghost rows
    included (zeros past the grid)."""
    ap = torch.nn.functional.pad(a, (0, 0, GR, ndev * n_l + GR - a.shape[0]))
    return [ap[d * n_l:(d + 1) * n_l + 2 * GR].to(mesh.devices[d]).contiguous()
            for d in range(ndev)]


def row_masks(plan: RowPlan, mesh) -> dict:
    """The masks of ``zero_boundary_rows`` that a solve and the NS step
    use, keyed (rows, off, n_g): the level-0 blocks, and per sharded level
    the coarse owned rows of the restriction and the coarse window of the
    prolongation.  Built once before a loop, so that a graph holds them
    rather than rebuilding them every pass."""
    out = {}
    for d in range(plan.ndev):
        n_l, n_g, _ = plan.level(0)
        keys = [(n_l + 2 * GR, d * n_l - GR, n_g)]
        for m in range(plan.s):
            nc_l, nyc_g, _ = plan.level(m + 1)
            keys += [(nc_l, d * nc_l, nyc_g), (nc_l + 2 * GR, d * nc_l - GR, nyc_g)]
        for rows, off, n_g in keys:
            g = off + torch.arange(rows, device=mesh.devices[d])[:, None]
            out[(rows, off, n_g)] = (g > 0) & (g < n_g - 1)
    return out


def zero_boundary_rows(a: torch.Tensor, off: int, n_g: int, masks: dict) -> torch.Tensor:
    """a, whose row i is global row off + i of an n_g-row grid, with the
    global boundary rows and the rows past the grid zeroed: the row part of
    ``bc.zero_boundary_2d``, its mask from ``row_masks``."""
    return torch.where(masks[(a.shape[0], off, n_g)], a, a.new_zeros(()))


def _vcycle_sharded(u, f, h, c, tol, cfg: MGConfig, plan: RowPlan, mesh, axis: str,
                    apply_bcs: bool, masks: dict):
    """One V-cycle (multigrid.vcycle) on the level-0 blocks u and f (f's
    ghost rows fresh); masks: ``row_masks(plan, mesh)``.  Returns (u', the
    global rms of the residual fed to the last fine post-smooth)."""
    rb = cfg.smoother is Smoother.RED_BLACK_GS
    restrict = (transfer.restrict_full_weighting
                if cfg.resolved_restriction() is Restriction.FULL_WEIGHTING
                else transfer.restrict)
    ndev = plan.ndev

    def smooth(u, f, h, m, with_norm):
        n_l = plan.ny_l >> m
        refresh_rows(u, mesh, axis, n_l, GR)
        outs = []
        for d in range(ndev):
            rows = plan.rows(m, d)
            if rb:
                outs.append(stencil2d.red_black_gs_step(u[d], f[d], h, c, with_norm, rows))
            else:
                outs.append(stencil2d.jacobi_step(u[d], f[d], h, c, cfg.jacobi_damping,
                                                  with_norm, rows))
        return [o[0] for o in outs], [o[1] for o in outs]

    def descend(u, f, h, m):
        n_l, _, nx_m = plan.level(m)
        nc_l, nyc_g, _ = plan.level(m + 1)
        for _ in range(cfg.pre_smooth):
            u, _ = smooth(u, f, h, m, False)
        refresh_rows(u, mesh, axis, n_l, GR)
        # the coarse owned rows: block row GR (global row d n_l, even) is
        # row GR/2 of the block's restriction; then the global boundary rows
        # of the coarse grid zeroed, as the global restriction does
        res_c = [zero_boundary_rows(
            restrict(stencil2d.residual(u[d], f[d], h, c, plan.rows(m, d)), apply_bcs)
            [GR // 2:GR // 2 + nc_l], d * nc_l, nyc_g, masks) for d in range(ndev)]
        if m + 1 < plan.s:
            fc = [torch.nn.functional.pad(r, (0, 0, GR, GR)) for r in res_c]
            refresh_rows(fc, mesh, axis, nc_l, GR)
            corr, _ = descend([torch.zeros_like(b) for b in fc], fc, h * 2.0, m + 1)
            refresh_rows(corr, mesh, axis, nc_l, GR)
        else:
            # the replicated subtree, once, on shard 0's device
            dev0 = mesh.devices[0]
            res_glob = torch.cat([r.to(dev0) for r in res_c])[:nyc_g]
            sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
            corr_glob, _ = vcycle(torch.zeros_like(res_glob), res_glob, h * 2.0, c, tol,
                                  sub_cfg, apply_bcs=apply_bcs)
            corr = _slice_rows(corr_glob, nc_l, ndev, mesh)
        # prolongation of the coarse block's rows from GR/2 on: fine block
        # row 0 is global row d n_l - GR, coarse row d nc_l - GR/2; the
        # window's first and last rows, which prolongate zeroes as a ring,
        # feed ghost rows only
        P = [transfer.prolongate(
            zero_boundary_rows(corr[d], d * nc_l - GR, nyc_g, masks)[GR // 2:],
            (n_l + 2 * GR + 1, nx_m), apply_bcs=apply_bcs) for d in range(ndev)]
        u = [u[d] - P[d][:n_l + 2 * GR] for d in range(ndev)]
        r_rms = None
        for s in range(cfg.post_smooth):
            want = m == 0 and s == cfg.post_smooth - 1
            u, r = smooth(u, f, h, m, want)
            if want:
                total = reductions.dist_sumsq(r)
                r_rms = torch.sqrt(total / total.new_full((), float(plan.ny * plan.nx)))
        return u, r_rms

    return descend(u, f, h, 0)


def mg_solve_sharded(u0, f, h: float, c, tol: float, niters: int, mesh, axis: str = "y",
                     apply_bcs: bool = False, cfg: MGConfig = MGConfig(),
                     replicate_below: int = 257):
    """``mg_solve`` on row-sharded fields (dist_multigrid.mg_solve_sharded):
    the same V-cycle and convergence test, the levels of at least
    ``replicate_below`` rows sharded over ``mesh``'s ``axis``.

    u0, f: global (ny, nx) tensors, placed onto the mesh here, or
    ``RowShards`` of this solve's plan (``plan_rows``), as the sharded NS
    step holds its fields.  One device call (``mesh.route()``); the host
    reads (r_rms, tolf, cycles) once, for the count and the
    non-convergence warning.  Returns (u, r_rms, iterations), u global on
    shard 0's device or ``RowShards``, as f was given.  When no level is
    sharded (fewer than ``replicate_below`` rows), JAX replicates every
    level: the solve runs on shard 0's device.
    """
    if cfg.policy is not ExecutionPolicy.JNP:
        raise ValueError("the GSPMD tier runs the plain (JNP-policy) V-cycle")
    sharded_in = isinstance(f, RowShards)
    f_glob = None
    if sharded_in:
        plan = f.plan
        u0 = u0 if isinstance(u0, RowShards) else RowShards.of(u0, plan, mesh)
    else:
        dev0 = mesh.devices[0]
        f, u0 = torch.as_tensor(f).to(dev0), torch.as_tensor(u0).to(dev0)
        ny, nx = f.shape
        plan = plan_rows(ny, nx, mesh.shape[axis], cfg, replicate_below)
        if plan.s == 0:
            return mg_solve(u0, f, h, c, tol, niters, apply_bcs=apply_bcs, cfg=cfg)
        f_glob = f
        f, u0 = RowShards.of(f, plan, mesh), RowShards.of(u0, plan, mesh)
    if plan != plan_rows(plan.ny, plan.nx, mesh.shape[axis], cfg, replicate_below) or \
            plan.s == 0:
        raise ValueError(f"fields sharded as {plan} do not fit this solve's plan")
    with mesh.route():
        out = _mg_solve_sharded(u0.blocks, f.blocks, f_glob, h, c, tol, niters, mesh, axis,
                                apply_bcs, cfg, plan)
    r, t, it = _outcome(out)
    _warn_unconverged("mg_solve_sharded", r, t, it, niters, apply_bcs)
    u = RowShards(out["u"], plan)
    return (u if sharded_in else u.gather()), out["r_rms"], it


def _mg_solve_sharded(u_blocks, f_blocks, f_glob, h: float, c, tol: float, niters: int, mesh,
                      axis: str, apply_bcs: bool, cfg: MGConfig, plan: RowPlan) -> dict:
    """mg_solve_sharded's device call on the fields' blocks (f_glob: the
    global rhs whose rms the tolerance takes, or None to sum it over the
    blocks' owned rows): dict(u blocks, r_rms, it, tolf), no host read,
    for a caller that reads them itself."""

    def solve(a):
        fb, cc = a["f"], c if a["c"] is None else a["c"]
        refresh_rows(fb, mesh, axis, plan.ny_l, GR)
        if a["fg"] is None:
            parts = [torch.sum(b[GR:GR + plan.ny_l] ** 2) for b in fb]
            total = reductions.dist_sumsq(parts)
            f_rms = torch.sqrt(total / total.new_full((), float(plan.ny * plan.nx)))
        else:
            f_rms = stencil2d.rms(a["fg"])
        tolf = tol * f_rms
        masks = row_masks(plan, mesh)

        def cond(s):
            return (s[2] < niters) & (s[1] >= tolf)

        def body(s):
            u = s[0]
            if apply_bcs:
                u = [bc.ns_temperature_bcs(u[d], plan.rows(0, d)) for d in range(plan.ndev)]
            u, r_rms = _vcycle_sharded(u, fb, h, cc, tol, cfg, plan, mesh, axis, apply_bcs,
                                       masks)
            return u, r_rms, s[2] + 1

        u, r_rms, it = loops.while_loop(cond, body, (list(a["u"]), _inf(fb[0]), _int0(fb[0])),
                                        donate=True)
        return dict(u=u, r_rms=r_rms, it=it, tolf=tolf)

    return loops.device_call(solve, dict(u=list(u_blocks), f=list(f_blocks), fg=f_glob,
                                         c=_c_arg(c)),
                             key=("mg_solve_sharded", plan, cfg, float(h), _c_key(c), float(tol),
                                  niters, apply_bcs, f_glob is None, axis, mesh.dims,
                                  mesh.axis_names))
