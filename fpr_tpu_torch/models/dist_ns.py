"""The Navier-Stokes fast loop over row shards (fpr_tpu/models/dist_ns.py:
_solve_sharded, _solve_s_sharded, simulate_fast_sharded).

The step of ``navier_stokes.simulate_fast`` with every field held as
per-shard local tensors (G + ny_l + G, nx) of the row plan of
``solvers.dist_mg_ds``: warm-started sharded ds solves for the stream
function (with K1's curl maxima, their maximum over the shards) and, for
beta >= 0.5, the two Helmholtz solves (T under the temperature BCs); the
fused operator K4 with the row hooks; the adaptive dt and the ds
sim-time on shard 0's device.  Every beta tier: explicit (beta = 0) runs
K4's ``explicit`` mode and sums W^2 over the owned rows; semi-implicit
and implicit run K4's ``rhs`` mode and the two solves.

Per-cell arithmetic equals the single-device fast loop's; only the
reductions add per-shard partials in shard order, so dt can differ in the
last bit and long runs drift apart at the float32 rounding level.  The
state payload (``result.state``) has the single-device global-field schema,
so a single-device or a sharded run of either package (through
``navier_stokes.state_from_jax``) resumes here, and back.

The loop over steps is a ``core.loops.while_loop``, as JAX's: a chunk of
at most ``chunk_steps`` steps is one device call in ``mesh.route()``, on
a mesh whose shards share one CUDA device one launch of a cached CUDA
graph, each step's solves WHILE nodes inside the step loop's.  The host
reads the clock once a chunk, as ``navier_stokes.simulate_fast`` does; a
mesh over several devices runs the plain host loops, one read a test.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import InitScheme, NSConfig
from fpr_tpu_torch.models.navier_stokes import (NSResult, _clock, _fields, _host_state,
                                                _semi_implicit, check_chunk_steps,
                                                fast_mg_default, init_field)
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import reductions
from fpr_tpu_torch.ops.ns_fused import ns_fused_rp
from fpr_tpu_torch.parallel.halo import refresh_rows
from fpr_tpu_torch.solvers.dist_mg_ds import G, gather_rows, plan_shards, shard_rows, solve_sharded

F32 = torch.float32


def _step(st: dict, plan, mesh, axis: str, cfg: NSConfig) -> dict:
    """One step on the carry st (TW, S_ds per-shard lists; w_ss, th, tl and
    the int32 step on shard 0's device): the next carry (dist_ns.
    _build_ns_loop's body)."""
    TW, S_ds, w_ss = st["TW"], st["S_ds"], st["w_ss"]
    ndev, ny_l = plan.ndev, plan.ny_l
    h = cfg.h

    def full(v):
        return w_ss.new_full((), float(v))

    n_cells = full(cfg.nx * cfg.ny)
    tolf = full(cfg.tol) * torch.sqrt(w_ss / n_cells)
    solve_kw = dict(plan=plan, h=h, cfg=cfg.mg, mesh=mesh, axis=axis, niters=cfg.niters,
                    tol=cfg.tol, inner_cycles=1)
    S_ds, _, _, (ax, ay) = solve_sharded(S_ds, [tw[1] for tw in TW], tolf, c=0.0,
                                         velocity_max=True, **solve_kw)
    dt_adv = full(cfg.a_adv) * torch.minimum(full(h) / ax, full(h) / ay)
    dt_dif = full(cfg.dt_dif)
    dt = dt_adv if cfg.beta >= 0.5 else torch.minimum(dt_dif, dt_adv)
    dt = torch.where((ax == 0.0) & (ay == 0.0), dt_dif, dt)
    refresh_rows(TW, mesh, axis, ny_l, G)
    S = [s[0] for s in S_ds]
    refresh_rows(S, mesh, axis, ny_l, G)

    def on(v, d):
        return v.to(mesh.devices[d], non_blocking=True)

    op_kw = dict(h=h, Pr=cfg.Pr, Ra=cfg.Ra, k=cfg.k, beta=cfg.beta, with_sumsq=True)
    if _semi_implicit(cfg.beta):
        cT = full(1.0) / (full(cfg.beta) * dt)
        cW = cT / full(cfg.Pr)
        ops = [ns_fused_rp(TW[d], S[d], on(dt, d), mode="rhs", cT=on(cT, d), cW=on(cW, d),
                           rows=plan.rows(0, d), **op_kw) for d in range(ndev)]
        tolT = full(cfg.tol) * torch.sqrt(reductions.dist_sumsq([o[1][0] for o in ops])
                                          / n_cells)
        tolW = full(cfg.tol) * torch.sqrt(reductions.dist_sumsq([o[1][1] for o in ops])
                                          / n_cells)
        T_ds, _, _, _ = solve_sharded(
            [torch.stack([tw[0], torch.zeros_like(tw[0])]) for tw in TW],
            [o[0][0] for o in ops], tolT, c=cT, apply_bcs=True, **solve_kw)
        W_ds, _, _, _ = solve_sharded(
            [torch.stack([tw[1], torch.zeros_like(tw[1])]) for tw in TW],
            [o[0][1] for o in ops], tolW, c=cW, **solve_kw)
        TW = [torch.stack([T_ds[d][0], W_ds[d][0]]) for d in range(ndev)]
        # W^2 over the owned rows inside the grid (the last shard's tail is dead)
        w_ss = reductions.dist_sumsq([
            torch.sum(tw[1][plan.rows(0, d).owned_physical(tw.shape[1])] ** 2)
            for d, tw in enumerate(TW)])
    else:
        ops = [ns_fused_rp(TW[d], S[d], on(dt, d), mode="explicit", rows=plan.rows(0, d),
                           **op_kw) for d in range(ndev)]
        TW = [o[0] for o in ops]
        w_ss = reductions.dist_sumsq([o[1][1] for o in ops])
    th, tl = dsm.ds_add(st["th"], st["tl"], dt, full(0.0))
    return dict(TW=TW, S_ds=S_ds, w_ss=w_ss, th=th, tl=tl, step=st["step"] + 1)


def _chunk(st: dict, plan, mesh, axis: str, cfg: NSConfig) -> dict:
    """Steps while sim_time < ttot and step < limit (the JAX chunk loop):
    a ``while_loop`` on st (TW, S_ds, w_ss, th, tl, step, limit); returns
    st after the steps."""
    tt_hi, tt_lo = dsm.f32_pair(cfg.ttot)
    th, limit = st["th"], st["limit"]
    neg_hi, neg_lo = th.new_full((), -tt_hi), th.new_full((), -tt_lo)

    def cond(c):
        return (dsm.ds_add(c["th"], c["tl"], neg_hi, neg_lo)[0] < 0.0) & (c["step"] < limit)

    carry = {k: st[k] for k in ("TW", "S_ds", "w_ss", "th", "tl", "step")}
    out = loops.while_loop(cond, lambda c: _step(c, plan, mesh, axis, cfg), carry, donate=True)
    return dict(out, limit=limit)


def simulate_fast_sharded(cfg: NSConfig, mesh, axis: str = "y", W0=None, T0=None,
                          max_steps: Optional[int] = None, seed: int = 0,
                          chunk_steps: int = 20_000, replicate_below: int = 257,
                          verbose: bool = False, snapshot_steps: int = 0,
                          state0: Optional[dict] = None) -> NSResult:
    """``navier_stokes.simulate_fast`` over ``mesh``'s ``axis``, every beta
    tier (dist_ns.simulate_fast_sharded, with its positional order).

    W0, T0: initial fields (FROM_ARRAY), else cfg's init schemes.  Steps
    1-3 are warm-up, excluded from t_elapsed and timed_iters.  chunk_steps
    (an int >= 1): the most steps of one device call, as in JAX; the host
    reads the clock at each chunk's end, and the result does not depend on
    it.  snapshot_steps > 0 stores (T, W, S, sim_time, step) every that
    many steps and at the end (chunks end on its multiples).  state0: a
    previous result.state of either loop (or ``navier_stokes.state_from_jax``
    of a JAX one); the run continues it exactly, with max_steps the total
    step budget.
    """
    check_chunk_steps(chunk_steps)
    cfg = fast_mg_default(cfg)
    ny, nx = cfg.ny, cfg.nx
    plan = plan_shards(ny, nx, mesh.shape[axis], cfg.mg, replicate_below)
    dev0 = mesh.devices[0]

    def on0(a):
        return torch.as_tensor(a, dtype=F32).to(dev0)

    def int32(v):
        return torch.full((), int(v), dtype=torch.int32, device=dev0)

    if state0 is not None:
        if "S_hi" not in state0:
            raise ValueError("state0 is not a fast-path payload (no S_hi)")
        T, W = on0(state0["T"]), on0(state0["W"])
        S_ds = shard_rows(torch.stack([on0(state0["S_hi"]), on0(state0["S_lo"])]), plan, mesh)
        st = dict(w_ss=on0(state0["w_sumsq"]).reshape(()), th=on0(state0["t_hi"]).reshape(()),
                  tl=on0(state0["t_lo"]).reshape(()), step=int32(state0["step"]))
        start_step = int(state0["step"])
    else:
        T, W = (init_field(cfg, scheme, seed, device=dev0) if a is None else
                init_field(cfg, InitScheme.FROM_ARRAY, array=a, device=dev0)
                for scheme, a in ((cfg.T_init, T0), (cfg.W_init, W0)))
        S_ds = [torch.zeros((2, G + plan.ny_l + G, nx), dtype=F32, device=dev)
                for dev in mesh.devices]
        st = dict(w_ss=torch.sum(W * W), th=torch.zeros((), dtype=F32, device=dev0),
                  tl=torch.zeros((), dtype=F32, device=dev0), step=int32(0))
        start_step = 0
    st.update(TW=shard_rows(torch.stack([T, W]), plan, mesh), S_ds=S_ds)
    del T, W, S_ds
    hard_cap = max_steps if max_steps is not None else 1_000_000
    snapshots = [] if snapshot_steps else None
    chunk = functools.partial(_chunk, plan=plan, mesh=mesh, axis=axis, cfg=cfg)

    def run(limit):
        with mesh.route():
            return loops.device_call(chunk, dict(st, limit=limit), key=(
                "ns_fast_sharded", cfg, plan, axis, mesh.dims, mesh.axis_names))

    def host_state():
        """The global payload on the host: one transfer."""
        return _host_state(dict(st, TW=gather_rows(st["TW"], plan),
                                S_ds=gather_rows(st["S_ds"], plan)))

    if start_step == 0:
        st = run(int32(min(3, hard_cap)))
        mesh.synchronize()
    tic = time.perf_counter()
    while True:
        step = st["step"]
        limit = torch.clamp_max(step + chunk_steps, hard_cap)
        if snapshot_steps:
            # chunks end on snapshot multiples, so the cadence holds even
            # when snapshot_steps > chunk_steps
            limit = torch.minimum(limit, (step // snapshot_steps + 1) * snapshot_steps)
        st = run(limit.to(torch.int32))
        sim_time, step, limit = _clock(st)  # the sync that stops the clock
        # the loop stopped short of its limit only when its ds time test
        # said done, even if the float64 sum disagrees in the last bits
        done = sim_time >= cfg.ttot or step >= hard_cap or step < limit
        if snapshots is not None and (done or step % snapshot_steps == 0):
            snapshots.append((*_fields(host_state()), sim_time, step))
        if done:
            break
        if verbose:
            print(f"time, steps: {sim_time} {step}")
    t_elapsed = time.perf_counter() - tic

    if verbose:
        print(f"time, steps: {sim_time} {step}")
    state = host_state()
    T, W, S = _fields(state)
    state["step"] = step
    return NSResult(
        T=T, W=W, S=S, t_elapsed=t_elapsed,
        timed_iters=max(step - start_step - (3 if start_step == 0 else 0), 0),
        steps=step, sim_time=sim_time, snapshots=snapshots, state=state,
    )
