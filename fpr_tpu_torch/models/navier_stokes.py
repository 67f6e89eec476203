"""2D streamfunction-vorticity Navier-Stokes: the host loop and the fused
fast loop (fpr_tpu/models/navier_stokes.py: NSResult, init_field,
compute_dt, ns_step, ns_step_jit, simulate, fast_mg_default, _fast_step,
_fast_loop, simulate_fast).

    dT/dt = lap T - (v . grad) T
    dW/dt = Pr lap W - (v . grad) W + Pr Ra dT/dx
    lap S = W,   (vx, vy) = (dS/dy, -dS/dx)

The host loop (``ns_step``, ``simulate``) keeps T, W and S in the state's
dtype (float64 by default) and runs the reference's operator chain in
plain PyTorch; its three linear solves per step go through ``mg_solve``
(``mg_solver="direct"``, in the state's dtype, with the ``MGConfig``
policy) or ``mg_solve_mixed`` (``"mixed"``: the float64 defect around
float32 V-cycles on the legs #6/#7).  Semi-implicit steps solve
(nabla^2 - c) T' = -c (T + dt ((1 - beta) lap T - adv)) with
c = 1/(beta dt), a device scalar, and the analogous W solve.  A step is
one ``core.loops.device_call``, as JAX's ``ns_step_jit`` is one launch: on
CUDA one launch of a cached CUDA graph, each solve's outer loop a WHILE
node in it.  The loop over steps stays on the host, as in JAX: each step
reads one small tensor, dt with each solve's (r_rms, tolf, outer count),
to advance the simulated time and to warn of a solve that did not
converge.

``simulate(mesh=)`` is the GSPMD tier of the host loop: with at least
``SHARD_ROWS`` rows, T, W and S live on the mesh's row shards
(``solvers.dist_multigrid.RowShards``), every solve is
``mg_solve_sharded``, the NS operators run per shard after a refresh of
the ghost rows with their global boundary rows zeroed, and dt's maxima are
maxima over the shards (exact).  It takes ``mg_solver="direct"`` only, as
in JAX.  Its step is one device call too (``_ns_step_sharded``), on a
mesh over several devices run as host loops (``Mesh.route``), with the
same one read a step.

The fast loop's state: T and W as a stacked (2, ny, nx) float32 tensor, S as a
double-single hi/lo (2, ny, nx) pair; every linear solve is
``mg_solve_ds_rp`` warm-started from the previous field.  A step is one
fused operator pass (K4) plus the multigrid solves (K1-K3 and the DST
coarse solve).  Simulated time accumulates in double-single float32, so
thousands of float32 dt additions cannot drift the step count.

The loop over steps is a ``core.loops.while_loop``, as JAX's
``lax.while_loop``: on CUDA one launch of a cached CUDA graph runs a chunk
of steps, each step's solves nested in it as loops of their own, with no
host read.  ``chunk_steps`` bounds a chunk exactly as in JAX: the host
reads the clock once after the 3 warm-up steps, once at the end of each
chunk, once more for each snapshot and once for the final fields, and
nowhere else.  Chunking changes no result.  ``max_steps``,
``snapshot_steps`` and ``state0`` keep their meaning, and
``state_from_jax`` / ``state_to_jax`` convert the exact-resume payload
between the two packages.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from fpr_tpu_torch.core import bc, loops
from fpr_tpu_torch.core.config import CoarseSolver, InitScheme, MGConfig, NSConfig
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import stencil2d as ops
from fpr_tpu_torch.ops import reductions
from fpr_tpu_torch.ops.ns_fused import ns_fused_rp
from fpr_tpu_torch.parallel.halo import refresh_rows
from fpr_tpu_torch.solvers import dist_multigrid as dmg
from fpr_tpu_torch.solvers.multigrid import (_mg_solve, _mg_solve_mixed, _warn_unconverged,
                                             mg_solve_ds_rp)

F32 = torch.float32
SHARD_ROWS = 257  # simulate(mesh=)'s replicate_below (navier_stokes.py:205-208)


@dataclasses.dataclass
class NSResult:
    """Output fields (navier_stokes.NSResult); T, W, S are float64 numpy."""

    T: np.ndarray
    W: np.ndarray
    S: np.ndarray
    t_elapsed: float
    timed_iters: int
    steps: int
    sim_time: float
    snapshots: Optional[list] = None
    # the exact-resume payload: feed back as simulate_fast(state0=...)
    state: Optional[dict] = None


def init_field(cfg: NSConfig, scheme: InitScheme, seed: int = 0, array=None, dtype=F32, *,
               device) -> torch.Tensor:
    """Initial (ny, nx) field of the given dtype (navier_stokes.init_field).
    RANDOM draws from numpy.random.default_rng(seed): it cannot reproduce
    jax.random, so cross-package runs pass the field as an array."""
    ny, nx = cfg.ny, cfg.nx
    if scheme is InitScheme.COSINE:
        row = 0.5 * (1.0 + np.cos(3.0 * np.pi * np.arange(nx) * cfg.h / cfg.width))
        a = np.broadcast_to(row, (ny, nx))
    elif scheme is InitScheme.RANDOM:
        a = np.random.default_rng(seed).random((ny, nx))
    elif scheme is InitScheme.FROM_ARRAY:
        if array is None:
            raise ValueError("InitScheme.FROM_ARRAY requires an array")
        a = array
    else:
        raise ValueError(scheme)
    return torch.tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)


def _semi_implicit(beta: float) -> bool:
    # the reference tests beta != 1 with isapprox (part2.jl:205)
    return beta > 0.0


def _needs_diffusion_term(beta: float) -> bool:
    return abs(beta - 1.0) > 1e-8


def compute_dt(vx, vy, cfg: NSConfig) -> torch.Tensor:
    """The adaptive timestep on the device (navier_stokes.compute_dt,
    part2.jl:76-87)."""
    return _dt_of(torch.amax(vx * vx + vy * vy), torch.amax(torch.abs(vx)),
                  torch.amax(torch.abs(vy)), cfg)


def _dt_of(vmax2, ax, ay, cfg: NSConfig) -> torch.Tensor:
    """compute_dt from max(vx^2 + vy^2), max|vx| and max|vy|."""
    h = _full(ax, cfg.h)
    dt_adv = cfg.a_adv * torch.minimum(h / ax, h / ay)  # inf when v = 0
    dt_dif = _full(ax, cfg.dt_dif)
    dt = dt_adv if cfg.beta >= 0.5 else torch.minimum(dt_dif, dt_adv)
    return torch.where(vmax2 == 0.0, dt_dif, dt)


# ns_step's solvers: (the name its warnings give, the device results' function)
_STEP_SOLVERS = {"direct": ("mg_solve", _mg_solve),
                 "mixed": ("mg_solve_mixed", _mg_solve_mixed)}


def _step_solver(cfg: NSConfig):
    if cfg.mg_solver not in _STEP_SOLVERS:
        raise ValueError(f"unknown mg_solver {cfg.mg_solver!r} for ns_step (expected "
                         "'direct' or 'mixed'; use simulate_fast for the fused "
                         "double-single path)")
    return _STEP_SOLVERS[cfg.mg_solver]


def ns_step(T, W, S, cfg: NSConfig):
    """One step of the host loop (navier_stokes.ns_step); returns
    (T, W, S, dt) with dt a 0-dim device tensor.  One device call and one
    host read (for the solves' warnings)."""
    T, W, S, dt, _ = _ns_step(T, W, S, cfg)
    return T, W, S, dt


# JAX's jitted step (navier_stokes.ns_step_jit): ns_step is already one
# launch of its cached CUDA graph
ns_step_jit = ns_step


def _ns_step(T, W, S, cfg: NSConfig):
    """ns_step as one device call (on CUDA one graph launch, as JAX's
    ns_step_jit), then the host's one read of the step: (T, W, S, dt, dt
    as a Python float).  Warns of each solve that stopped at niters above
    tolerance, as JAX's solves do."""
    name, _ = _step_solver(cfg)
    out = loops.device_call(functools.partial(_ns_step_body, cfg=cfg), dict(T=T, W=W, S=S),
                            key=("ns_step", cfg))
    info = out["info"].tolist()  # the one host read a step
    for k, apply_bcs in zip(range(1, len(info), 3), (False, True, False)):
        r, t, it = info[k:k + 3]
        _warn_unconverged(name, r, t, int(it), cfg.niters, apply_bcs)
    return out["T"], out["W"], out["S"], out["dt"], info[0]


def _ns_step_body(a: dict, cfg: NSConfig) -> dict:
    """The step on its device call's inputs: dict(T, W, S, dt, info), info
    = [dt, then (r_rms, tolf, outer count) of each solve in the order S, T,
    W] in the state's dtype."""
    _, solve = _step_solver(cfg)
    T, W, S = a["T"], a["W"], a["S"]
    h = cfg.h
    outcomes = []

    def solved(out):
        outcomes.append((out["r_rms"], out["tolf"], out["it"]))
        return out["u"]

    # 1. the streamfunction, nabla^2 S = W, Dirichlet 0 (part2.jl:187)
    S = solved(solve(S, W, h, 0.0, cfg.tol, cfg.niters, apply_bcs=False, cfg=cfg.mg))
    # 2-3. the velocity and the adaptive dt (part2.jl:190-196)
    vx, vy = ops.velocity(S, h, h)
    dt = compute_dt(vx, vy, cfg)
    # 4-7. the T BCs, buoyancy, diffusion and upwind advection (part2.jl:199-214)
    T = bc.ns_temperature_bcs(T)
    Ra_dTdx = ops.buoyancy(T, cfg.Ra, h)
    if _needs_diffusion_term(cfg.beta):
        dT2 = ops.diffusion(T, cfg.k, h, h)
        dW2 = ops.diffusion(W, cfg.Pr, h, h)
    else:
        dT2, dW2 = torch.zeros_like(T), torch.zeros_like(W)
    dTx, dTy = ops.advection_x(T, vx, h), ops.advection_y(T, vy, h)
    dWx, dWy = ops.advection_x(W, vx, h), ops.advection_y(W, vy, h)
    # 8. the Euler or Helmholtz update (part2.jl:216-231)
    if _semi_implicit(cfg.beta):
        c = _full(dt, 1.0) / (cfg.beta * dt)
        T_rhs = -c * (T + dt * ((1.0 - cfg.beta) * dT2 - dTx - dTy))
        T = solved(solve(T, T_rhs, h, c, cfg.tol, cfg.niters, apply_bcs=True, cfg=cfg.mg))
        cW = c / _full(c, cfg.Pr)
        W_rhs = -cW * (W + dt * ((1.0 - cfg.beta) * dW2 - dWx - dWy - cfg.Pr * Ra_dTdx))
        W = solved(solve(W, W_rhs, h, cW, cfg.tol, cfg.niters, apply_bcs=False, cfg=cfg.mg))
    else:
        T = T + dt * (dT2 - dTx - dTy)
        W = W + dt * (dW2 - dWx - dWy - cfg.Pr * Ra_dTdx)
    info = torch.stack([dt] + [v.to(dt.dtype) for o in outcomes for v in o])
    return dict(T=T, W=W, S=S, dt=dt, info=info)


def _ns_step_sharded(T, W, S, cfg: NSConfig, mesh, axis: str):
    """ns_step on ``RowShards`` T, W, S (navier_stokes.ns_step with the
    constrain hook) as one device call in ``mesh.route()`` (on a one-device
    CUDA mesh one graph launch, each ``mg_solve_sharded`` a WHILE node in
    it), then the host's one read of the step, from which it warns as the
    solves do: (T, W, S, dt, dt as a Python float)."""
    plan = T.plan
    with mesh.route():
        out = loops.device_call(
            functools.partial(_ns_step_sharded_body, cfg=cfg, plan=plan, mesh=mesh, axis=axis),
            dict(T=T.blocks, W=W.blocks, S=S.blocks),
            key=("ns_step_sharded", cfg, plan, axis, mesh.dims, mesh.axis_names))
    info = out["info"].tolist()  # the one host read a step
    for k, apply_bcs in zip(range(1, len(info), 3), (False, True, False)):
        r, t, it = info[k:k + 3]
        _warn_unconverged("mg_solve_sharded", r, t, int(it), cfg.niters, apply_bcs)
    T, W, S = (dmg.RowShards(out[k], plan) for k in "TWS")
    return T, W, S, out["dt"], info[0]


def _ns_step_sharded_body(a: dict, cfg: NSConfig, plan, mesh, axis: str) -> dict:
    """The sharded step on its device call's inputs (the fields' blocks):
    dict(T, W, S blocks, dt, info), info as ``_ns_step_body``'s."""
    h = cfg.h
    rows = [plan.rows(0, d) for d in range(plan.ndev)]
    own = slice(dmg.GR, dmg.GR + plan.ny_l)
    masks = dmg.row_masks(plan, mesh)
    outcomes = []

    def solve(u, f, c, apply_bcs):
        out = dmg._mg_solve_sharded(u, f, None, h, c, cfg.tol, cfg.niters, mesh, axis,
                                    apply_bcs, cfg.mg, plan)
        outcomes.append((out["r_rms"], out["tolf"], out["it"]))
        return out["u"]

    def zero_rows(a, r):
        return dmg.zero_boundary_rows(a, r.off, r.ny, masks)

    def per_shard(op, *fields):
        """op per shard, its result's global boundary rows zeroed (the
        operators' zero ring); the fields' ghost rows are fresh."""
        return [zero_rows(op(*(f[d] for f in fields)), r) for d, r in enumerate(rows)]

    Wb = list(a["W"])
    Sb = solve(a["S"], Wb, 0.0, False)
    refresh_rows(Sb, mesh, axis, plan.ny_l, dmg.GR)
    refresh_rows(Wb, mesh, axis, plan.ny_l, dmg.GR)
    vel = [ops.velocity(s, h, h) for s in Sb]
    vx, vy = ([zero_rows(v[k], r) for v, r in zip(vel, rows)] for k in (0, 1))
    dt = _dt_of(reductions.dist_max([torch.amax((x * x + y * y)[own]) for x, y in zip(vx, vy)]),
                reductions.dist_max([torch.amax(torch.abs(x[own])) for x in vx]),
                reductions.dist_max([torch.amax(torch.abs(y[own])) for y in vy]), cfg)
    Tb = list(a["T"])
    refresh_rows(Tb, mesh, axis, plan.ny_l, dmg.GR)
    Tb = [bc.ns_temperature_bcs(t, r) for t, r in zip(Tb, rows)]
    Ra_dTdx = per_shard(lambda t: ops.buoyancy(t, cfg.Ra, h), Tb)
    if _needs_diffusion_term(cfg.beta):
        dT2 = per_shard(lambda t: ops.diffusion(t, cfg.k, h, h), Tb)
        dW2 = per_shard(lambda w: ops.diffusion(w, cfg.Pr, h, h), Wb)
    else:
        dT2, dW2 = [torch.zeros_like(t) for t in Tb], [torch.zeros_like(w) for w in Wb]
    dTx, dTy = per_shard(lambda t, v: ops.advection_x(t, v, h), Tb, vx), \
        per_shard(lambda t, v: ops.advection_y(t, v, h), Tb, vy)
    dWx, dWy = per_shard(lambda w, v: ops.advection_x(w, v, h), Wb, vx), \
        per_shard(lambda w, v: ops.advection_y(w, v, h), Wb, vy)
    n = range(plan.ndev)
    if _semi_implicit(cfg.beta):
        c = _full(dt, 1.0) / (cfg.beta * dt)
        T_rhs = [-c * (Tb[d] + dt * ((1.0 - cfg.beta) * dT2[d] - dTx[d] - dTy[d])) for d in n]
        Tb = solve(Tb, T_rhs, c, True)
        cW = c / _full(c, cfg.Pr)
        W_rhs = [-cW * (Wb[d] + dt * ((1.0 - cfg.beta) * dW2[d] - dWx[d] - dWy[d]
                                      - cfg.Pr * Ra_dTdx[d])) for d in n]
        Wb = solve(Wb, W_rhs, cW, False)
    else:
        Tb, Wb = ([Tb[d] + dt * (dT2[d] - dTx[d] - dTy[d]) for d in n],
                  [Wb[d] + dt * (dW2[d] - dWx[d] - dWy[d] - cfg.Pr * Ra_dTdx[d]) for d in n])
    info = torch.stack([dt] + [v.to(dt.dtype) for o in outcomes for v in o])
    return dict(T=Tb, W=Wb, S=Sb, dt=dt, info=info)


def simulate(cfg: NSConfig = NSConfig(), W0=None, T0=None, max_steps: Optional[int] = None,
             verbose: bool = False, snapshot_every: int = 0, dtype=torch.float64,
             seed: int = 0, mesh=None, shard_axis: str = "y", *, device="cuda") -> NSResult:
    """Run the host loop until sim_time >= ttot (navier_stokes.simulate,
    part2.jl:181-250).  Steps 1-3 are warm-up, excluded from t_elapsed and
    timed_iters.  max_steps=1 is the reference's test mode;
    snapshot_every > 0 keeps (T, W, S) every that many steps.

    mesh: a ``parallel.mesh.Mesh``: the GSPMD tier, T, W and S row-sharded
    over ``shard_axis`` with ``mg_solve_sharded`` for every solve (the
    fields start on shard 0's device; ``device`` is not used).  It needs
    ``mg_solver="direct"``.  With fewer than SHARD_ROWS rows nothing is
    sharded, as in JAX, and the steps run on shard 0's device."""
    dev = torch.device(device)
    plan = None
    if mesh is not None:
        if cfg.mg_solver != "direct":
            raise ValueError("sharded ns_step requires mg_solver='direct'")
        dev = mesh.devices[0]
        plan = dmg.plan_rows(cfg.ny, cfg.nx, mesh.shape[shard_axis], cfg.mg, SHARD_ROWS)
        if plan.s == 0:
            plan = None

    def field(scheme, array):
        if array is not None:
            return init_field(cfg, InitScheme.FROM_ARRAY, array=array, device=dev, dtype=dtype)
        return init_field(cfg, scheme, seed, device=dev, dtype=dtype)

    T, W = field(cfg.T_init, T0), field(cfg.W_init, W0)
    S = torch.zeros((cfg.ny, cfg.nx), dtype=dtype, device=dev)
    if plan is not None:
        T, W, S = (dmg.RowShards.of(a, plan, mesh) for a in (T, W, S))

    def sync():
        if mesh is not None:
            mesh.synchronize()
        else:
            _sync(dev)

    def host(a):  # in the state's dtype, as JAX returns them
        if isinstance(a, dmg.RowShards):
            a = a.gather()
        return a.cpu().numpy()

    snapshots = [] if snapshot_every else None
    step_fn = _ns_step if plan is None else functools.partial(_ns_step_sharded, mesh=mesh,
                                                              axis=shard_axis)
    sim_time, step = 0.0, 0
    tic = time.perf_counter()
    while sim_time < cfg.ttot:
        if step == 3:  # warm-up exclusion (part2.jl:182-184)
            sync()
            tic = time.perf_counter()
        T, W, S, _, dt = step_fn(T, W, S, cfg)
        sim_time += dt  # the one host read per step
        step += 1
        if snapshot_every and (step - 1) % snapshot_every == 0:
            snapshots.append((host(T), host(W), host(S)))
        if verbose and (step - 1) % 20 == 0:
            print(f"time, step: {sim_time} {step}")
        if max_steps is not None and step >= max_steps:
            break
    sync()
    t_elapsed = time.perf_counter() - tic
    return NSResult(T=host(T), W=host(W), S=host(S), t_elapsed=t_elapsed,
                    timed_iters=max(step - 3, 0), steps=step, sim_time=sim_time,
                    snapshots=snapshots)


def fast_mg_default(cfg: NSConfig) -> NSConfig:
    """The production ladder of the fast path (navier_stokes.fast_mg_default):
    a default ``mg`` becomes DST with coarse size 257 (clamped below
    min(ny, nx)) and V(3,3), unless cfg.mg_auto is off, cfg.mg was given,
    or min(ny, nx) <= 129."""
    if not cfg.mg_auto or cfg.mg != MGConfig() or min(cfg.ny, cfg.nx) <= 129:
        return cfg
    coarse = 257
    while coarse >= min(cfg.ny, cfg.nx):
        coarse = (coarse - 1) // 2 + 1
    return dataclasses.replace(
        cfg, mg=MGConfig(coarse_size=coarse, coarse_solver=CoarseSolver.DST,
                         pre_smooth=3, post_smooth=3)
    )


def _full(like, v):
    return like.new_full((), float(v))


def _fast_step(TW, S_ds, w_sumsq, cfg: NSConfig, defect=None):
    """One step (navier_stokes._fast_step).

    defect (explicit): (r, r_rms, (ax, ay, 0)), the S-solve's initial
    defect and curl maxima from the previous operator pass.  Returns
    (TW', S_ds', w_sumsq', dt), plus the next defect on the explicit path.
    """
    h = cfg.h
    n_cells = _full(w_sumsq, cfg.nx * cfg.ny)
    tolf = (cfg.tol * cfg.s_tol_factor) * torch.sqrt(w_sumsq / n_cells)
    solve_kw = {}
    if defect is not None:
        r32, r_rms, ex0 = defect
        solve_kw = dict(r0=(r32, r_rms), extras0=ex0)
    S_ds, _, _, (ax, ay, _) = mg_solve_ds_rp(
        S_ds, TW[1:2], tolf, h, 0.0, cfg.niters, cfg=cfg.mg, inner_cycles=1,
        tol=cfg.tol, velocity_max=True, **solve_kw,
    )

    # adaptive dt (part2.jl:76-87)
    h_t = _full(ax, h)
    dt_adv = _full(ax, cfg.a_adv) * torch.minimum(h_t / ax, h_t / ay)
    dt_dif = _full(ax, cfg.dt_dif)
    dt = dt_adv if cfg.beta >= 0.5 else torch.minimum(dt_dif, dt_adv)
    dt = torch.where((ax == 0.0) & (ay == 0.0), dt_dif, dt)

    if _semi_implicit(cfg.beta):
        cT = _full(dt, 1.0) / (_full(dt, cfg.beta) * dt)
        cW = cT / _full(dt, cfg.Pr)
        rhs, (trhs_ss, wrhs_ss) = ns_fused_rp(
            TW, S_ds[0], dt, h, cfg.Pr, cfg.Ra, k=cfg.k, beta=cfg.beta,
            mode="rhs", cT=cT, cW=cW, with_sumsq=True,
        )
        zeros = torch.zeros_like(TW[0])
        tolT = cfg.tol * torch.sqrt(trhs_ss / n_cells)
        T_ds, _, _ = mg_solve_ds_rp(
            torch.stack([TW[0], zeros]), rhs[0:1], tolT, h, cT, cfg.niters,
            cfg=cfg.mg, inner_cycles=1, apply_bcs=True, tol=cfg.tol,
        )
        tolW = cfg.tol * torch.sqrt(wrhs_ss / n_cells)
        W_ds, _, _ = mg_solve_ds_rp(
            torch.stack([TW[1], zeros]), rhs[1:2], tolW, h, cW, cfg.niters,
            cfg=cfg.mg, inner_cycles=1, tol=cfg.tol,
        )
        TW = torch.stack([T_ds[0], W_ds[0]])
        return TW, S_ds, torch.sum(TW[1] * TW[1]), dt
    # the operator pass also gives the next step's initial S defect
    TW, (_, w_sumsq), r0n, ex0n = ns_fused_rp(
        TW, S_ds, dt, h, cfg.Pr, cfg.Ra, k=cfg.k, beta=cfg.beta,
        mode="explicit", with_defect=True,
    )
    return TW, S_ds, w_sumsq, dt, (r0n[0], r0n[1], ex0n)


def _fast_loop(st: dict, cfg: NSConfig) -> dict:
    """Steps while sim_time < ttot and step < limit (navier_stokes._fast_loop):
    one device call, on CUDA one launch of a cached CUDA graph.

    st: TW, S_ds, w_ss, th, tl, step and limit, tensors (step and limit
    int32); returns st after the steps."""
    return loops.device_call(functools.partial(_fast_chunk, cfg=cfg), st, key=("ns_fast", cfg))


def _fast_chunk(st: dict, cfg: NSConfig) -> dict:
    """_fast_loop's body: JAX's while_loop, its cond the ds time against
    -ttot and step < limit."""
    tt_hi, tt_lo = dsm.f32_pair(cfg.ttot)
    th = st["th"]
    neg_hi, neg_lo, zero = _full(th, -tt_hi), _full(th, -tt_lo), _full(th, 0.0)
    limit = st["limit"]

    def cond(c):
        return (dsm.ds_add(c["th"], c["tl"], neg_hi, neg_lo)[0] < 0.0) & (c["step"] < limit)

    def advance(c, TW, S_ds, w_ss, dt, **dfc):
        th, tl = dsm.ds_add(c["th"], c["tl"], dt, zero)
        return dict(TW=TW, S_ds=S_ds, w_ss=w_ss, th=th, tl=tl, step=c["step"] + 1, **dfc)

    carry = {k: st[k] for k in ("TW", "S_ds", "w_ss", "th", "tl", "step")}
    if _semi_implicit(cfg.beta):
        def body(c):
            return advance(c, *_fast_step(c["TW"], c["S_ds"], c["w_ss"], cfg))
    else:
        # the entry pass, once a chunk: the initial S defect the first step's
        # warm solve needs; every step's operator pass makes the next one
        # (the same arithmetic, so chunking changes no bit)
        S_ds, r32, r_rms, ex = dsm.defect_pass(
            carry["S_ds"], carry["TW"][1:2], None, 0.0, cfg.h, 0.0, velocity_max=True)
        carry.update(S_ds=S_ds, dfc=(r32, r_rms, ex))

        def body(c):
            TW, S_ds, w_ss, dt, dfc = _fast_step(c["TW"], c["S_ds"], c["w_ss"], cfg,
                                                 defect=c["dfc"])
            return advance(c, TW, S_ds, w_ss, dt, dfc=dfc)

    out = loops.while_loop(cond, body, carry, donate=True)
    out.pop("dfc", None)
    return dict(out, limit=limit)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def state_from_jax(state: dict) -> dict:
    """The JAX package's exact-resume payload (navier_stokes.simulate_fast's
    result.state: numpy T, W, S_hi, S_lo, w_sumsq, t_hi, t_lo, step) as the
    port's state0 (float32 CPU tensors, step an int)."""
    out = {k: torch.tensor(np.asarray(state[k], dtype=np.float32))
           for k in ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo")}
    out["step"] = int(state["step"])
    return out


def state_to_jax(state: dict) -> dict:
    """The port's result.state as the JAX package's state0 payload."""
    out = {k: np.asarray(torch.as_tensor(state[k]).cpu().numpy(), dtype=np.float32)
           for k in ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo")}
    out["step"] = np.asarray(int(state["step"]))
    return out


def check_chunk_steps(chunk_steps) -> None:
    """JAX's ``chunk_steps`` must be an int >= 1."""
    if isinstance(chunk_steps, bool) or not isinstance(chunk_steps, (int, np.integer)) \
            or chunk_steps < 1:
        raise ValueError(f"chunk_steps must be an int >= 1, got {chunk_steps!r}")


def _clock(st: dict):
    """(sim_time, step, limit) of st: one transfer, the host's read at a
    chunk's end."""
    v = torch.stack([st["th"].view(torch.int32), st["tl"].view(torch.int32), st["step"],
                     st["limit"]]).cpu()
    th, tl = v[:2].view(torch.float32).tolist()
    return th + tl, int(v[2]), int(v[3])


def _host_state(st: dict) -> dict:
    """T, W, S_hi, S_lo, w_sumsq, t_hi, t_lo of st as float32 CPU tensors:
    one transfer."""
    TW, S = st["TW"], st["S_ds"]
    n = TW.numel()
    flat = torch.cat([TW.reshape(-1), S.reshape(-1),
                      torch.stack([st["w_ss"], st["th"], st["tl"]])]).cpu()
    TWh, Sh = flat[:n].view(TW.shape), flat[n:2 * n].view(S.shape)
    return dict(T=TWh[0], W=TWh[1], S_hi=Sh[0], S_lo=Sh[1], w_sumsq=flat[2 * n],
                t_hi=flat[2 * n + 1], t_lo=flat[2 * n + 2])


def _fields(h: dict):
    """(T, W, S) float64 numpy of a ``_host_state``, S = S_hi + S_lo."""
    return (h["T"].double().numpy(), h["W"].double().numpy(),
            h["S_hi"].double().numpy() + h["S_lo"].double().numpy())


def simulate_fast(cfg: NSConfig = NSConfig(), W0=None, T0=None,
                  max_steps: Optional[int] = None, verbose: bool = False,
                  seed: int = 0, chunk_steps: int = 20_000, snapshot_steps: int = 0,
                  state0: Optional[dict] = None, *, device="cuda") -> NSResult:
    """Run the fused fast loop until sim_time >= ttot
    (navier_stokes.simulate_fast, with its positional order).

    device: where to run ("cuda", "cuda:0", "cpu", a torch.device).
    W0, T0: initial fields (FROM_ARRAY), else cfg's init schemes.
    Steps 1-3 are warm-up, excluded from t_elapsed and timed_iters
    (part2.jl:182-184).  chunk_steps (an int >= 1): the most steps of one
    device call, as in JAX; the host reads the clock at each chunk's end,
    and the result does not depend on it.  snapshot_steps > 0 stores (T, W,
    S, sim_time, step) every that many steps and at the end (chunks end on
    its multiples).  state0: a previous result.state (or state_from_jax of
    a JAX one); the run continues it exactly, with max_steps the total step
    budget.
    """
    check_chunk_steps(chunk_steps)
    cfg = fast_mg_default(cfg)
    ny, nx = cfg.ny, cfg.nx
    dev = torch.device(device)

    def int32(v):
        return torch.full((), int(v), dtype=torch.int32, device=dev)

    if state0 is not None:
        if "S_hi" not in state0:
            raise ValueError("state0 is not a fast-path payload (no S_hi)")
        on = lambda k: torch.as_tensor(state0[k], dtype=F32).to(dev)  # noqa: E731
        st = dict(TW=torch.stack([on("T"), on("W")]),
                  S_ds=torch.stack([on("S_hi"), on("S_lo")]),
                  w_ss=on("w_sumsq").reshape(()), th=on("t_hi").reshape(()),
                  tl=on("t_lo").reshape(()), step=int32(state0["step"]))
        start_step = int(state0["step"])
    else:
        T, W = (init_field(cfg, scheme, seed, device=dev) if a is None else
                init_field(cfg, InitScheme.FROM_ARRAY, array=a, device=dev)
                for scheme, a in ((cfg.T_init, T0), (cfg.W_init, W0)))
        st = dict(TW=torch.stack([T, W]),
                  S_ds=torch.zeros((2, ny, nx), dtype=F32, device=dev),
                  w_ss=torch.sum(W * W), th=torch.zeros((), dtype=F32, device=dev),
                  tl=torch.zeros((), dtype=F32, device=dev), step=int32(0))
        start_step = 0
    hard_cap = max_steps if max_steps is not None else 1_000_000
    snapshots = [] if snapshot_steps else None

    if start_step == 0:
        st = _fast_loop(dict(st, limit=int32(min(3, hard_cap))), cfg)
        _sync(dev)
    tic = time.perf_counter()
    while True:
        step = st["step"]
        limit = torch.clamp_max(step + chunk_steps, hard_cap)
        if snapshot_steps:
            # chunks end on snapshot multiples, so the cadence holds even
            # when snapshot_steps > chunk_steps
            limit = torch.minimum(limit, (step // snapshot_steps + 1) * snapshot_steps)
        st = _fast_loop(dict(st, limit=limit.to(torch.int32)), cfg)
        sim_time, step, limit = _clock(st)  # the sync that stops the clock
        # the loop stopped short of its limit only when its ds time test
        # said done, even if the float64 sum disagrees in the last bits
        done = sim_time >= cfg.ttot or step >= hard_cap or step < limit
        if done:
            break
        if snapshots is not None and step % snapshot_steps == 0:
            snapshots.append((*_fields(_host_state(st)), sim_time, step))
        if verbose:
            print(f"time, steps: {sim_time} {step}")
    t_elapsed = time.perf_counter() - tic

    if verbose:
        print(f"time, steps: {sim_time} {step}")
    state = _host_state(st)
    T, W, S = _fields(state)
    if snapshots is not None:
        snapshots.append((T, W, S, sim_time, step))
    state["step"] = step
    return NSResult(
        T=T, W=W, S=S, t_elapsed=t_elapsed,
        timed_iters=max(step - start_step - (3 if start_step == 0 else 0), 0),
        steps=step, sim_time=sim_time, snapshots=snapshots, state=state,
    )
