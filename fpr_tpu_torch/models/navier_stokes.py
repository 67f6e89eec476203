"""2D streamfunction-vorticity Navier-Stokes, the fused fast loop
(fpr_tpu/models/navier_stokes.py: NSResult, init_field, fast_mg_default,
_fast_step, _fast_loop, simulate_fast).

    dT/dt = lap T - (v . grad) T
    dW/dt = Pr lap W - (v . grad) W + Pr Ra dT/dx
    lap S = W,   (vx, vy) = (dS/dy, -dS/dx)

State: T and W as a stacked (2, ny, nx) float32 tensor, S as a
double-single hi/lo (2, ny, nx) pair; every linear solve is
``mg_solve_ds_rp`` warm-started from the previous field.  A step is one
fused operator pass (K4) plus the multigrid solves (K1-K3 and the DST
coarse solve).  Simulated time accumulates in double-single float32, so
thousands of float32 dt additions cannot drift the step count.

The JAX ``lax.while_loop`` over steps is a host loop here: each step reads
one scalar (is the time reached?) from the device.  The JAX function's
``chunk_steps`` exists only to bound one device call under its TPU
transport's RPC deadline; it has no counterpart.  ``max_steps``,
``snapshot_steps`` and ``state0`` keep their meaning, and
``state_from_jax`` / ``state_to_jax`` convert the exact-resume payload
between the two packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from fpr_tpu_torch.core.config import CoarseSolver, InitScheme, MGConfig, NSConfig
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops.ns_fused import ns_fused_rp
from fpr_tpu_torch.solvers.multigrid import mg_solve_ds_rp

F32 = torch.float32


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


def init_field(cfg: NSConfig, scheme: InitScheme, seed: int = 0, array=None, *,
               device) -> torch.Tensor:
    """Initial (ny, nx) float32 field (navier_stokes.init_field).  RANDOM
    draws from numpy.random.default_rng(seed): it cannot reproduce
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
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _semi_implicit(beta: float) -> bool:
    return beta > 0.0


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

    defect (explicit): (r, r_rms, ax, ay), the S-solve's initial defect and
    curl maxima from the previous operator pass.  Returns
    (TW', S_ds', w_sumsq', dt), plus the next defect on the explicit path.
    """
    h = cfg.h
    n_cells = _full(w_sumsq, cfg.nx * cfg.ny)
    tolf = (cfg.tol * cfg.s_tol_factor) * torch.sqrt(w_sumsq / n_cells)
    solve_kw = {}
    if defect is not None:
        r32, r_rms, ax0, ay0 = defect
        solve_kw = dict(r0=(r32, r_rms), extras0=(ax0, ay0))
    S_ds, _, _, (ax, ay) = mg_solve_ds_rp(
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
    return TW, S_ds, w_sumsq, dt, (r0n[0], r0n[1], ex0n[0], ex0n[1])


def _fast_loop(st: dict, limit: int, cfg: NSConfig) -> dict:
    """Steps while sim_time < ttot and step < limit (navier_stokes._fast_loop).

    st: TW, S_ds, w_ss, th, tl (tensors) and step (int)."""
    TW, S_ds, w_ss, th, tl, step = (st[k] for k in ("TW", "S_ds", "w_ss", "th", "tl", "step"))
    tt_hi, tt_lo = dsm.f32_pair(cfg.ttot)
    neg_hi, neg_lo, zero = _full(th, -tt_hi), _full(th, -tt_lo), _full(th, 0.0)

    def running():
        return step < limit and bool(dsm.ds_add(th, tl, neg_hi, neg_lo)[0] < 0.0)

    if _semi_implicit(cfg.beta):
        while running():
            TW, S_ds, w_ss, dt = _fast_step(TW, S_ds, w_ss, cfg)
            th, tl = dsm.ds_add(th, tl, dt, zero)
            step += 1
    else:
        # the entry pass: the initial S defect the first step's warm solve
        # needs; every step's operator pass makes the next one
        S_ds, r32, r_rms, ex = dsm.defect_pass(
            S_ds, TW[1:2], None, 0.0, cfg.h, 0.0, velocity_max=True)
        dfc = (r32, r_rms, ex[0], ex[1])
        while running():
            TW, S_ds, w_ss, dt, dfc = _fast_step(TW, S_ds, w_ss, cfg, defect=dfc)
            th, tl = dsm.ds_add(th, tl, dt, zero)
            step += 1
    return dict(TW=TW, S_ds=S_ds, w_ss=w_ss, th=th, tl=tl, step=step)


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


def simulate_fast(cfg: NSConfig = NSConfig(), W0=None,
                  max_steps: Optional[int] = None, verbose: bool = False,
                  seed: int = 0, snapshot_steps: int = 0,
                  state0: Optional[dict] = None, *, device) -> NSResult:
    """Run the fused fast loop until sim_time >= ttot
    (navier_stokes.simulate_fast).

    device: where to run ("cuda", "cuda:0", "cpu", a torch.device); no
    default.  Steps 1-3 are warm-up, excluded from t_elapsed and
    timed_iters (part2.jl:182-184).  snapshot_steps > 0 stores
    (T, W, S, sim_time, step) every that many steps and at the end.
    state0: a previous result.state (or state_from_jax of a JAX one); the
    run continues it exactly, with max_steps the total step budget.
    """
    cfg = fast_mg_default(cfg)
    ny, nx = cfg.ny, cfg.nx
    dev = torch.device(device)
    if state0 is not None:
        if "S_hi" not in state0:
            raise ValueError("state0 is not a fast-path payload (no S_hi)")
        on = lambda k: torch.as_tensor(state0[k], dtype=F32).to(dev)  # noqa: E731
        st = dict(TW=torch.stack([on("T"), on("W")]),
                  S_ds=torch.stack([on("S_hi"), on("S_lo")]),
                  w_ss=on("w_sumsq").reshape(()), th=on("t_hi").reshape(()),
                  tl=on("t_lo").reshape(()), step=int(state0["step"]))
    else:
        T = init_field(cfg, cfg.T_init, seed, device=dev)
        W = init_field(cfg, cfg.W_init, seed, device=dev) if W0 is None else \
            init_field(cfg, InitScheme.FROM_ARRAY, array=W0, device=dev)
        st = dict(TW=torch.stack([T, W]),
                  S_ds=torch.zeros((2, ny, nx), dtype=F32, device=dev),
                  w_ss=torch.sum(W * W), th=torch.zeros((), dtype=F32, device=dev),
                  tl=torch.zeros((), dtype=F32, device=dev), step=0)
    start_step = st["step"]
    hard_cap = max_steps if max_steps is not None else 1_000_000
    snapshots = [] if snapshot_steps else None

    def host_fields():
        TW, S_ds = st["TW"].cpu().double().numpy(), st["S_ds"].cpu().double().numpy()
        return TW[0], TW[1], S_ds[0] + S_ds[1]

    if start_step == 0:
        st = _fast_loop(st, min(3, hard_cap), cfg)
        _sync(dev)
    tic = time.perf_counter()
    while True:
        limit = hard_cap
        if snapshot_steps:
            limit = min(limit, (st["step"] // snapshot_steps + 1) * snapshot_steps)
        st = _fast_loop(st, limit, cfg)
        _sync(dev)
        sim_time = float(st["th"]) + float(st["tl"])
        step = st["step"]
        # the loop stopped short of its limit only when its ds time test
        # said done, even if the float64 sum disagrees in the last bits
        done = sim_time >= cfg.ttot or step >= hard_cap or step < limit
        if snapshots is not None and (done or step % snapshot_steps == 0):
            snapshots.append((*host_fields(), sim_time, step))
        if done:
            break
        if verbose:
            print(f"time, steps: {sim_time} {step}")
    t_elapsed = time.perf_counter() - tic

    steps = st["step"]
    if verbose:
        print(f"time, steps: {sim_time} {steps}")
    T, W, S = host_fields()
    state = dict(T=st["TW"][0].cpu(), W=st["TW"][1].cpu(), S_hi=st["S_ds"][0].cpu(),
                 S_lo=st["S_ds"][1].cpu(), w_sumsq=st["w_ss"].cpu(),
                 t_hi=st["th"].cpu(), t_lo=st["tl"].cpu(), step=steps)
    return NSResult(
        T=T, W=W, S=S, t_elapsed=t_elapsed,
        timed_iters=max(steps - start_step - (3 if start_step == 0 else 0), 0),
        steps=steps, sim_time=sim_time, snapshots=snapshots, state=state,
    )
