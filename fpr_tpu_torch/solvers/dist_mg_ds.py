"""The double-single defect-correction multigrid over row shards and over a
2D (y, x) mesh (fpr_tpu/solvers/dist_mg_ds.py: ShardPlan, plan_shards,
_refresh, _vcycle_dist, mg_solve_ds_sharded; ShardPlan2D, plan_shards_2d,
_refresh2d, _vcycle_dist_2d, mg_solve_ds_sharded_2d).

Rows are decomposed.  Each shard owns ``ny_l`` contiguous global rows at
the fine level, ``ny_l`` a multiple of ``16 * 2**(s-1)`` so that each of
the ``s`` sharded levels keeps an even local row count of at least 16 and
shard offsets keep the fine/coarse row parity (the JAX plan, whose ghost
counts and offsets this tier shares).  A shard's local tensor at a sharded
level is (G + ny_l + G, nx) with G = 8 ghost rows on each side and the
physical columns (the TPU's 128-lane column padding is not copied).  One
refresh per array per leg (``halo.refresh_rows``) feeds up to ns = 6
sweeps: each launch of #6/#7/K1 updates every row whose global index is
interior, ghost rows included, so the owned rows equal the single-device
rows bitwise while the stale outer ghost rows are never read (G >= ns+1).
The last shard's rows past the global grid are dead: the kernels' masks
keep them at zero, the exchange never reads them, and the gather drops
them.

Per sharded level the V-cycle runs #6 (``smooth2r_split``) and #7
(``corr_smooth2_raw``) with the row hooks.  The port's #6 residual is
plain, not parity-split, so restriction takes the even owned rows (shard
offsets are even at every level) and every other column.  Below
``replicate_below`` global rows the residual is gathered and the coarse
subtree runs once, with the plain V-cycle (policy JNP), on shard 0's
device; each shard then takes its window of the x-interleaved correction
with 4 coarse halo rows on each side.  JAX runs that subtree identically on
every device; the numbers are the same.  The outer loop is K1
(``defect_pass``) with the row hooks and the sums of the shards added in
shard order.  As in ``solvers.multigrid``, the outer loop is a
``core.loops.while_loop``, JAX's ``lax.while_loop``, and a solve one
device call in ``mesh.route()``: on a mesh whose shards share one CUDA
device one launch of a cached CUDA graph, the host reading (r_rms, tolf,
outer count) once at the end; on a mesh over several devices the plain
host loops, one read a test.

The 2D mesh shards the columns as well: each shard owns ``nx_l`` columns,
``nx_l`` and the levels that may be column-sharded planned exactly as JAX
plans them (``CPAD``-column alignment, at least 2 CPAD columns a column
shard at every sharded level), so both packages shard the same levels.
The local layout is the port's own, (G + ny_l + G, GX + nx_l + GX) with
GX = 8 ghost columns in physical columns: JAX's 128-lane ghost slabs are
the TPU's lane tile, and 8 ghost columns feed ns <= 6 sweeps as 8 ghost
rows do.  Every kernel takes the row and column hooks; one refresh
(``halo.refresh_2d``: columns, then full-width rows, so the corners hold
the diagonal neighbour's cells) per array per leg.  Restriction takes the
even owned rows and columns (both offsets are even at every level); below
the deepest sharded level the correction window takes G/2 coarse halo rows
and GX/2 coarse halo columns plus the interpolation midpoint (JAX's GC =
4).  The coarse subtree is gathered, columns then rows, and runs once on
shard 0's device; the 2D tier takes no apply_bcs, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig, Smoother
from fpr_tpu_torch.core.grid import mg_levels
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import reductions, stencil2d, transfer
from fpr_tpu_torch.ops.rows import Cols, Rows
from fpr_tpu_torch.ops.vcycle_legs import corr_smooth2_raw, smooth2r_split
from fpr_tpu_torch.parallel.halo import refresh_2d, refresh_rows
from fpr_tpu_torch.solvers.multigrid import (_auto_inner_cycles, _int0, _outcome,
                                             _warn_unconverged, vcycle)

G = 8  # ghost rows on each side of a shard: one exchange feeds up to G-2 sweeps
GX = 8  # ghost columns on each side of a 2D-mesh shard, likewise
CPAD = 128  # JAX's column-shard alignment (the TPU lane tile): the 2D plans match it


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    ny: int                   # global rows (2^k + 1)
    nx: int                   # global columns
    ndev: int                 # shards
    s: int                    # sharded levels (>= 1)
    ny_l: int                 # local rows at the fine level

    def level(self, m: int):
        """(ny_l_m, ny_g_m, nx_g_m) of sharded level m."""
        return (self.ny_l >> m, ((self.ny - 1) >> m) + 1, ((self.nx - 1) >> m) + 1)

    def rows(self, m: int, d: int) -> Rows:
        """The row hooks of shard d's local tensor at level m."""
        ny_lm, ny_gm, _ = self.level(m)
        return Rows(d * ny_lm - G, ny_gm, (G, G + ny_lm))


def plan_shards(ny: int, nx: int, ndev: int, cfg: MGConfig,
                replicate_below: int = 1025) -> ShardPlan:
    """The levels to shard (those of at least ``replicate_below`` rows, all
    but the coarsest) and the local row count (dist_mg_ds.plan_shards)."""
    levels = mg_levels(nx, ny, cfg.coarse_size)
    s = 0
    for m, (_, nym) in enumerate(levels):
        if nym >= replicate_below and m < len(levels) - 1:
            s += 1
        else:
            break
    if s < 1:
        raise ValueError(f"grid {ny}x{nx} too small to shard (replicate_below="
                         f"{replicate_below}); use the single-device solver")
    align = 16 * (1 << (s - 1))
    ny_l = -(-ny // (ndev * align)) * align
    return ShardPlan(ny=ny, nx=nx, ndev=ndev, s=s, ny_l=ny_l)


def _pack(phys: torch.Tensor) -> torch.Tensor:
    """Physical local rows (ny_l, nx) -> (G + ny_l + G, nx), zero ghosts."""
    return torch.nn.functional.pad(phys, (0, 0, G, G))


def _restrict_cols(res: torch.Tensor, ny_l: int, apply_bcs: bool) -> torch.Tensor:
    """Injection of a shard's residual: its even owned rows (local parity
    is global parity) and every other column, columns 0 and nxc-1 zeroed,
    then the Neumann side copies when apply_bcs (dist_mg_ds.
    _restrict_ps_cols).  Global boundary rows are zero from the kernel's
    mask already."""
    coarse = res[G:G + ny_l:2, ::2].clone()
    coarse[:, 0] = 0.0
    coarse[:, -1] = 0.0
    if apply_bcs:
        coarse[:, 0] = coarse[:, 1]
        coarse[:, -1] = coarse[:, -2]
    return coarse


def _x_interleave_cols(slab: torch.Tensor, apply_bcs: bool) -> torch.Tensor:
    """``transfer.x_interleave_coarse`` without the boundary-row zeroing, for
    a window of rows in mid-grid (dist_mg_ds._x_interleave_cols)."""
    c0 = slab.clone()
    c0[:, 0] = 0.0
    c0[:, -1] = 0.0
    rows, nxc = c0.shape
    out = c0.new_empty((rows, 2 * nxc - 1))
    out[:, 0::2] = c0
    out[:, 1::2] = (c0[:, :-1] + c0[:, 1:]) * 0.5
    if apply_bcs:
        out[:, 0] = out[:, 1]
        out[:, -1] = out[:, -2]
    return out


def _vcycle_dist(e, r, plan: ShardPlan, h: float, c, tol: float, cfg: MGConfig, mesh,
                 axis: str, assume_zero_u: bool, apply_bcs: bool = False):
    """One V-cycle on the shards' level-0 local tensors (dist_mg_ds.
    _vcycle_dist).  e, r: per-shard corrections and right-hand sides; with
    assume_zero_u e is never read.  Returns the per-shard new corrections
    (their ghost rows stale)."""
    alpha = cfg.jacobi_damping
    if cfg.smoother is not Smoother.JACOBI or not (1 <= cfg.pre_smooth <= G - 2
                                                   and 1 <= cfg.post_smooth <= G - 2):
        raise ValueError("the sharded V-cycle runs the Jacobi smoother with 1-6 sweeps a "
                         "leg (one 8-row halo exchange per leg)")
    ndev = plan.ndev
    down = []
    u, f = e, r
    zero_u = assume_zero_u
    for m in range(plan.s):
        ny_lm, _, _ = plan.level(m)
        h_m = h * (2.0 ** m)
        refresh_rows(f, mesh, axis, ny_lm, G)
        if not zero_u:
            refresh_rows(u, mesh, axis, ny_lm, G)
        legs = [smooth2r_split(None if zero_u else u[d], f[d], h_m, c, alpha, zero_u=zero_u,
                               ns=cfg.pre_smooth, elim=apply_bcs, rows=plan.rows(m, d))
                for d in range(ndev)]
        u = [leg[0] for leg in legs]
        down.append((u, f))
        res_c = [_restrict_cols(leg[1], ny_lm, apply_bcs) for leg in legs]
        if m + 1 < plan.s:
            f = [_pack(rc) for rc in res_c]
            u, zero_u = None, True
        else:
            # the replicated coarse subtree, once, on shard 0's device
            dev0 = mesh.devices[0]
            ny_gs = ((plan.ny - 1) >> (m + 1)) + 1
            res_glob = torch.cat([rc.to(dev0) for rc in res_c])[:ny_gs]
            sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
            corr_glob, _ = vcycle(torch.zeros_like(res_glob), res_glob, h_m * 2.0, c, tol,
                                  sub_cfg, apply_bcs=apply_bcs, elim=apply_bcs)

    corr_next = None
    for m in reversed(range(plan.s)):
        u, f = down[m]
        ny_lm, _, _ = plan.level(m)
        h_m = h * (2.0 ** m)
        nyc_l = ny_lm // 2
        span = G + nyc_l + 1  # coarse rows of a window: the local rows' // 2 + 1
        if m == plan.s - 1:
            # every shard slices its window, G/2 coarse halo rows each side,
            # out of the replicated x-interleaved correction
            corrx_g = transfer.x_interleave_coarse(corr_glob, apply_bcs=apply_bcs)
            padded = torch.nn.functional.pad(
                corrx_g, (0, 0, G // 2, ndev * nyc_l + G + 1 - G // 2 - corrx_g.shape[0]))
            corrx = [padded[d * nyc_l:d * nyc_l + span].to(mesh.devices[d])
                     for d in range(ndev)]
        else:
            refresh_rows(corr_next, mesh, axis, nyc_l, G)
            corrx = [_x_interleave_cols(cn[G // 2:G // 2 + span], apply_bcs)
                     for cn in corr_next]
        refresh_rows(u, mesh, axis, ny_lm, G)
        u = [corr_smooth2_raw(u[d], f[d], corrx[d], h_m, c, alpha, ns=cfg.post_smooth,
                              elim=apply_bcs, rows=plan.rows(m, d))[0]
             for d in range(ndev)]
        corr_next = u
    return u


def shard_rows(a: torch.Tensor, plan: ShardPlan, mesh) -> list:
    """A global (..., ny, nx) field as per-shard local tensors (..., G + ny_l
    + G, nx), zero ghost and dead rows, each on its shard's device."""
    ny_l = plan.ny_l
    pad_rows = plan.ndev * ny_l - plan.ny
    ap = torch.nn.functional.pad(a, (0, 0, 0, pad_rows))
    return [_pack(ap[..., d * ny_l:(d + 1) * ny_l, :]).to(mesh.devices[d]).contiguous()
            for d in range(plan.ndev)]


def gather_rows(blocks, plan: ShardPlan, device=None) -> torch.Tensor:
    """The owned rows of per-shard local tensors as the global (..., ny, nx)
    field, on ``device`` (default shard 0's)."""
    device = blocks[0].device if device is None else device
    return torch.cat([b[..., G:G + plan.ny_l, :].to(device) for b in blocks],
                     dim=-2)[..., :plan.ny, :]


def solve_sharded(u_ds, f_l, tolf, plan: ShardPlan, h: float, c, cfg: MGConfig, mesh,
                  axis: str, niters: int, tol: float, inner_cycles: int = 1,
                  apply_bcs: bool = False, velocity_max: bool = False, r0=None):
    """The ds defect-correction loop on per-shard local tensors
    (dist_ns._solve_sharded and the loop of dist_mg_ds._build_sharded): a
    ``loops.while_loop`` over (u_ds, r32, r_rms, curl maxima, it), as JAX's.

    u_ds: per-shard (2, G + ny_l + G, nx) hi/lo iterates, which the loop may
    overwrite (``donate``); f_l: per-shard float32 right-hand sides.  c: a
    Python number (0 takes K1's exact x4 path) or a float32 device scalar.
    r0: the initial (per-shard defects, r_rms), for a zero iterate without
    BCs; None runs the first defect pass (the warm start).  velocity_max:
    K1's curl maxima of the returned iterate, the maximum over the shards.
    Returns (u_ds', r_rms, outer_iterations, (max|du/dy|, max|du/dx|) or
    None), the count a 0-dim int32 device tensor: no host read, so that a
    caller's device call holds the loop as a WHILE node.
    """
    ndev = plan.ndev
    nx, ny = plan.nx, plan.ny
    C = [dsm.defect_scalars(c, h, b.device) for b in f_l]
    n_cells = tolf.new_full((), float(nx * ny))

    def defect(u_ds, e, scale):
        refresh_rows(u_ds, mesh, axis, plan.ny_l, G)
        if e is not None:
            refresh_rows(e, mesh, axis, plan.ny_l, G)
        outs = [dsm.defect_pass(u_ds[d], f_l[d][None], None if e is None else e[d], scale, h,
                                c, C=C[d], apply_bcs=apply_bcs, velocity_max=velocity_max,
                                rows=plan.rows(0, d), raw_sumsq=True)
                for d in range(ndev)]
        r_rms = torch.sqrt(reductions.dist_sumsq([o[2] for o in outs]) / n_cells)
        ext = ()
        if velocity_max:
            ext = (reductions.dist_max([o[3][0] for o in outs]),
                   reductions.dist_max([o[3][1] for o in outs]))
        return [o[0] for o in outs], [o[1] for o in outs], r_rms, ext

    if r0 is None:
        u_ds, r32, r_rms, ext = defect(u_ds, None, 0.0)
    else:
        (r32, r_rms), ext = r0, (tolf.new_zeros(()),) * 2 if velocity_max else ()

    def cond(s):
        return (s["it"] < niters) & (s["r_rms"] >= tolf)

    def body(s):
        e = None
        for cyc in range(inner_cycles):
            e = _vcycle_dist(e, s["r"], plan, h, c, tol, cfg, mesh, axis,
                             assume_zero_u=(cyc == 0), apply_bcs=apply_bcs)
        u_ds, r32, r_rms, ext = defect(s["u"], e, 1.0)
        return dict(u=u_ds, r=r32, r_rms=r_rms, ext=ext, it=s["it"] + 1)

    s = loops.while_loop(cond, body, dict(u=list(u_ds), r=list(r32), r_rms=r_rms, ext=ext,
                                          it=_int0(tolf)), donate=True)
    return s["u"], s["r_rms"], s["it"], s["ext"] or None


def mg_solve_ds_sharded(f, h: float, c, tol: float, niters: int, mesh, axis: str = "y",
                        cfg: MGConfig = MGConfig(), inner_cycles: int | None = None,
                        replicate_below: int = 1025, gather_result: bool = True,
                        apply_bcs: bool = False):
    """The double-single defect-correction MG over ``mesh``'s ``axis``, zero
    initial guess (dist_mg_ds.mg_solve_ds_sharded).

    f: the global (ny, nx) float32 rhs (a zero boundary ring, as every caller
    here gives).  c: the Helmholtz shift, taken as a float32 device scalar.
    apply_bcs: the NS temperature BCs, their Dirichlet rows applied by K1
    against global rows, with eliminated-BC smoothing in the cycles.  The
    solve is one device call (``mesh.route()``: on a one-device CUDA mesh
    one launch of a cached CUDA graph); the host reads (r_rms, tolf, outer
    count) once, at the end, for the count and the non-convergence warning.
    Returns ((hi, lo), r_rms, outer_iterations), hi/lo global on shard 0's
    device, or with gather_result=False the per-shard (2, G + ny_l + G, nx)
    local pairs in place of (hi, lo).
    """
    f = torch.as_tensor(f).to(mesh.devices[0])
    if f.dtype != torch.float32:
        raise ValueError("sharded ds solver takes an exactly-f32 rhs")
    ny, nx = f.shape
    if inner_cycles is None:
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    plan = plan_shards(ny, nx, mesh.shape[axis], cfg, replicate_below)
    c = torch.as_tensor(c, dtype=torch.float32, device=mesh.devices[0])

    def solve(a):
        f_rms = stencil2d.rms(a["f"])
        tolf = tol * f_rms
        f_l = shard_rows(a["f"], plan, mesh)
        u_ds = [torch.zeros((2,) + tuple(b.shape), dtype=torch.float32, device=b.device)
                for b in f_l]
        # with the BCs u != 0: the first defect goes through the kernel
        r0 = None if apply_bcs else ([-b for b in f_l], f_rms)
        u_ds, r_rms, it, _ = solve_sharded(u_ds, f_l, tolf, plan, h, a["c"], cfg, mesh, axis,
                                           niters, tol, inner_cycles, apply_bcs=apply_bcs,
                                           r0=r0)
        return dict(u=u_ds, r_rms=r_rms, it=it, tolf=tolf)

    with mesh.route():
        out = loops.device_call(solve, dict(f=f, c=c), key=(
            "mg_solve_ds_sharded", plan, cfg, float(h), float(tol), niters, inner_cycles,
            apply_bcs, axis, mesh.dims, mesh.axis_names))
    r, t, it = _outcome(out)
    _warn_unconverged("mg_solve_ds_sharded", r, t, it, niters, apply_bcs)
    u_ds, r_rms = out["u"], out["r_rms"]
    if not gather_result:
        return u_ds, r_rms, it
    u = gather_rows(u_ds, plan)
    return (u[0], u[1]), r_rms, it


# ---------------------------------------------------------------------------
# the 2D (y, x) mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan2D:
    ny: int
    nx: int
    ndev_y: int
    ndev_x: int
    s: int                    # sharded levels (>= 1)
    ny_l: int                 # local rows at the fine level
    nx_l: int                 # local columns at the fine level

    def level(self, m: int):
        """(ny_l_m, nx_l_m, ny_g_m, nx_g_m) of sharded level m."""
        return (self.ny_l >> m, self.nx_l >> m, ((self.ny - 1) >> m) + 1,
                ((self.nx - 1) >> m) + 1)

    def hooks(self, m: int, dy: int, dx: int) -> dict:
        """The row and column hooks of shard (dy, dx)'s local tensor at
        level m."""
        ny_lm, nx_lm, ny_gm, nx_gm = self.level(m)
        return dict(rows=Rows(dy * ny_lm - G, ny_gm, (G, G + ny_lm)),
                    cols=Cols(dx * nx_lm - GX, nx_gm, (GX, GX + nx_lm)))


def plan_shards_2d(ny: int, nx: int, ndev_y: int, ndev_x: int, cfg: MGConfig,
                   replicate_below: int = 1025) -> ShardPlan2D:
    """The levels to shard (at least ``replicate_below`` rows, at least
    ``max(replicate_below, 2 CPAD ndev_x)`` columns, all but the coarsest)
    and the local sizes (dist_mg_ds.plan_shards_2d)."""
    levels = mg_levels(nx, ny, cfg.coarse_size)
    s = 0
    for m, (nxm, nym) in enumerate(levels):
        if (nym >= replicate_below and nxm >= max(replicate_below, 2 * CPAD * ndev_x)
                and m < len(levels) - 1):
            s += 1
        else:
            break
    if s < 1:
        raise ValueError(
            f"grid {ny}x{nx} too small to 2D-shard over {ndev_y}x{ndev_x} "
            f"(replicate_below={replicate_below}, column shards need "
            f">= {2 * CPAD} cols each at every sharded level); use the "
            "1D row solver or fewer column shards")
    align_y = 16 * (1 << (s - 1))
    ny_l = -(-ny // (ndev_y * align_y)) * align_y
    align_x = CPAD * (1 << (s - 1))
    nx_l = -(-nx // (ndev_x * align_x)) * align_x
    return ShardPlan2D(ny=ny, nx=nx, ndev_y=ndev_y, ndev_x=ndev_x, s=s, ny_l=ny_l, nx_l=nx_l)


def _yx(mesh, axes, i: int):
    """Shard i's (dy, dx) on the mesh axes (ay, ax)."""
    cc = mesh.coords(i)
    return cc[axes[0]], cc[axes[1]]


def _pack_2d(phys: torch.Tensor) -> torch.Tensor:
    """Physical local cells (..., ny_l, nx_l) -> (..., G + ny_l + G, GX + nx_l + GX),
    zero ghosts."""
    return torch.nn.functional.pad(phys, (GX, GX, G, G))


def shard_2d(a: torch.Tensor, plan: ShardPlan2D, mesh, axes=("y", "x")) -> list:
    """A global (..., ny, nx) field as per-shard local tensors (..., G + ny_l
    + G, GX + nx_l + GX), zero ghost and dead cells, each on its shard's
    device."""
    ap = torch.nn.functional.pad(a, (0, plan.ndev_x * plan.nx_l - plan.nx,
                                     0, plan.ndev_y * plan.ny_l - plan.ny))
    out = []
    for i in range(mesh.size):
        dy, dx = _yx(mesh, axes, i)
        blk = ap[..., dy * plan.ny_l:(dy + 1) * plan.ny_l, dx * plan.nx_l:(dx + 1) * plan.nx_l]
        out.append(_pack_2d(blk).to(mesh.devices[i]).contiguous())
    return out


def _assemble(parts, mesh, axes, ndev_y, ndev_x, device):
    """Per-shard (..., a, b) tiles as one (..., ndev_y a, ndev_x b) tensor on
    device: each y-row of shards joined along the columns, then the rows."""
    tile = {_yx(mesh, axes, i): p for i, p in enumerate(parts)}
    return torch.cat([torch.cat([tile[(dy, dx)].to(device) for dx in range(ndev_x)], dim=-1)
                      for dy in range(ndev_y)], dim=-2)


def gather_2d(blocks, plan: ShardPlan2D, mesh, axes=("y", "x"), device=None) -> torch.Tensor:
    """The owned cells of per-shard local tensors as the global (..., ny,
    nx) field, on ``device`` (default shard 0's)."""
    device = blocks[0].device if device is None else device
    owned = [b[..., G:G + plan.ny_l, GX:GX + plan.nx_l] for b in blocks]
    return _assemble(owned, mesh, axes, plan.ndev_y, plan.ndev_x,
                     device)[..., :plan.ny, :plan.nx]


def _interleave_cols(ext: torch.Tensor) -> torch.Tensor:
    """The x interpolation of a window of coarse cells in mid-grid, without
    any boundary zeroing, dropping the last coarse column: (rows, n) ->
    (rows, 2 (n - 1)) (dist_mg_ds.py:569-573)."""
    rows, n = ext.shape
    out = ext.new_empty((rows, 2 * (n - 1)))
    out[:, 0::2] = ext[:, :-1]
    out[:, 1::2] = (ext[:, :-1] + ext[:, 1:]) * 0.5
    return out


def _vcycle_dist_2d(e, r, plan: ShardPlan2D, h: float, c, tol: float, cfg: MGConfig, mesh,
                    axes, assume_zero_u: bool):
    """One V-cycle on the 2D shards' level-0 local tensors
    (dist_mg_ds._vcycle_dist_2d).  e, r: per-shard corrections and
    right-hand sides; with assume_zero_u e is never read.  Returns the
    per-shard new corrections (their ghost cells stale)."""
    alpha = cfg.jacobi_damping
    if cfg.smoother is not Smoother.JACOBI or not (1 <= cfg.pre_smooth <= G - 2
                                                   and 1 <= cfg.post_smooth <= G - 2):
        raise ValueError("the sharded V-cycle runs the Jacobi smoother with 1-6 sweeps a "
                         "leg (one 8-cell halo exchange per leg)")
    yx = [_yx(mesh, axes, i) for i in range(mesh.size)]
    down = []
    u, f = e, r
    zero_u = assume_zero_u
    for m in range(plan.s):
        ny_lm, nx_lm, _, _ = plan.level(m)
        h_m = h * (2.0 ** m)
        refresh_2d(f, mesh, axes, ny_lm, nx_lm, G, GX)
        if not zero_u:
            refresh_2d(u, mesh, axes, ny_lm, nx_lm, G, GX)
        legs = [smooth2r_split(None if zero_u else u[i], f[i], h_m, c, alpha, zero_u=zero_u,
                               ns=cfg.pre_smooth, **plan.hooks(m, dy, dx))
                for i, (dy, dx) in enumerate(yx)]
        u = [leg[0] for leg in legs]
        down.append((u, f))
        # injection: the even owned rows and columns (even offsets: local
        # parity is global parity); the kernels zeroed the global boundary
        # and the dead cells
        res_c = [leg[1][G:G + ny_lm:2, GX:GX + nx_lm:2] for leg in legs]
        if m + 1 < plan.s:
            f = [_pack_2d(rc) for rc in res_c]
            u, zero_u = None, True
        else:
            # the replicated coarse subtree, once, on shard 0's device
            dev0 = mesh.devices[0]
            ny_gs, nx_gs = ((plan.ny - 1) >> (m + 1)) + 1, ((plan.nx - 1) >> (m + 1)) + 1
            res_glob = _assemble(res_c, mesh, axes, plan.ndev_y, plan.ndev_x,
                                 dev0)[:ny_gs, :nx_gs]
            sub_cfg = dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)
            corr_glob, _ = vcycle(torch.zeros_like(res_glob), res_glob, h_m * 2.0, c, tol,
                                  sub_cfg)

    corr_next = None
    for m in reversed(range(plan.s)):
        u, f = down[m]
        ny_lm, nx_lm, _, _ = plan.level(m)
        h_m = h * (2.0 ** m)
        nyc_l, nxc_l = ny_lm // 2, nx_lm // 2
        span = G + nyc_l + 1  # coarse rows of a window: the local rows' // 2 + 1
        if m == plan.s - 1:
            # every shard slices its window, G/2 coarse halo rows and GX fine
            # halo columns each side, out of the replicated x-interleaved
            # correction
            corrx_g = transfer.x_interleave_coarse(corr_glob)
            nyc_g, nx_gm = corrx_g.shape
            padded = torch.nn.functional.pad(
                corrx_g, (GX, plan.ndev_x * nx_lm + GX - nx_gm,
                          G // 2, plan.ndev_y * nyc_l + G + 1 - G // 2 - nyc_g))
            corrx = [padded[dy * nyc_l:dy * nyc_l + span,
                            dx * nx_lm:dx * nx_lm + nx_lm + 2 * GX].to(mesh.devices[i])
                     .contiguous() for i, (dy, dx) in enumerate(yx)]
        else:
            # G/2 coarse halo rows and GX/2 coarse halo columns (+1 for the
            # interpolation midpoint) of the refreshed coarse correction
            refresh_2d(corr_next, mesh, axes, nyc_l, nxc_l, G, GX)
            corrx = [_interleave_cols(cn[G // 2:G // 2 + span, GX // 2:GX // 2 + nxc_l + GX + 1])
                     for cn in corr_next]
        refresh_2d(u, mesh, axes, ny_lm, nx_lm, G, GX)
        u = [corr_smooth2_raw(u[i], f[i], corrx[i], h_m, c, alpha, ns=cfg.post_smooth,
                              **plan.hooks(m, dy, dx))[0]
             for i, (dy, dx) in enumerate(yx)]
        corr_next = u
    return u


def mg_solve_ds_sharded_2d(f, h: float, c, tol: float, niters: int, mesh, axes=("y", "x"),
                           cfg: MGConfig = MGConfig(), inner_cycles: int | None = None,
                           replicate_below: int = 1025, gather_result: bool = True):
    """The double-single defect-correction MG over a 2D (y, x) mesh, zero
    initial guess (dist_mg_ds.mg_solve_ds_sharded_2d).

    f: the global (ny, nx) float32 rhs (a zero boundary ring).  c: the
    Helmholtz shift, taken as a float32 device scalar.  No apply_bcs, as in
    JAX (the NS tiers shard rows only).  One device call a solve with the
    outer loop a ``loops.while_loop``, as ``mg_solve_ds_sharded``.  Returns
    ((hi, lo), r_rms, outer_iterations), hi/lo global on shard 0's device,
    or with gather_result=False the per-shard (2, G + ny_l + G, GX + nx_l +
    GX) local pairs in place of (hi, lo).
    """
    ay, ax = axes
    f = torch.as_tensor(f).to(mesh.devices[0])
    if f.dtype != torch.float32:
        raise ValueError("sharded ds solver takes an exactly-f32 rhs")
    ny, nx = f.shape
    if inner_cycles is None:
        inner_cycles = _auto_inner_cycles(ny, nx, cfg)
    plan = plan_shards_2d(ny, nx, mesh.shape[ay], mesh.shape[ax], cfg, replicate_below)
    c = torch.as_tensor(c, dtype=torch.float32, device=mesh.devices[0])
    hooks = [plan.hooks(0, *_yx(mesh, axes, i)) for i in range(mesh.size)]

    def solve(a):
        c = a["c"]
        f_rms = stencil2d.rms(a["f"])
        tolf = tol * f_rms
        f_l = shard_2d(a["f"], plan, mesh, axes)
        C = [dsm.defect_scalars(c, h, b.device) for b in f_l]
        n_cells = tolf.new_full((), float(nx * ny))
        u_ds = [torch.zeros((2,) + tuple(b.shape), dtype=torch.float32, device=b.device)
                for b in f_l]

        def cond(s):
            return (s["it"] < niters) & (s["r_rms"] >= tolf)

        def body(s):
            e = None
            for cyc in range(inner_cycles):
                e = _vcycle_dist_2d(e, s["r"], plan, h, c, tol, cfg, mesh, axes,
                                    assume_zero_u=(cyc == 0))
            u_ds = s["u"]
            refresh_2d(u_ds, mesh, axes, plan.ny_l, plan.nx_l, G, GX)
            refresh_2d(e, mesh, axes, plan.ny_l, plan.nx_l, G, GX)
            outs = [dsm.defect_pass(u_ds[i], f_l[i][None], e[i], 1.0, h, c, C=C[i],
                                    raw_sumsq=True, **hooks[i])
                    for i in range(mesh.size)]
            r_rms = torch.sqrt(reductions.dist_sumsq([o[2] for o in outs]) / n_cells)
            return dict(u=[o[0] for o in outs], r=[o[1] for o in outs], r_rms=r_rms,
                        it=s["it"] + 1)

        s = loops.while_loop(cond, body, dict(u=u_ds, r=[-b for b in f_l], r_rms=f_rms,
                                              it=_int0(tolf)), donate=True)
        return dict(u=s["u"], r_rms=s["r_rms"], it=s["it"], tolf=tolf)

    with mesh.route():
        out = loops.device_call(solve, dict(f=f, c=c), key=(
            "mg_solve_ds_sharded_2d", plan, cfg, float(h), float(tol), niters, inner_cycles,
            tuple(axes), mesh.dims, mesh.axis_names))
    r, t, it = _outcome(out)
    _warn_unconverged("mg_solve_ds_sharded_2d", r, t, it, niters)
    u_ds, r_rms = out["u"], out["r_rms"]
    if not gather_result:
        return u_ds, r_rms, it
    u = gather_2d(u_ds, plan, mesh, axes)
    return (u[0], u[1]), r_rms, it
