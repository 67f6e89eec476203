"""The sharded tiers' loops as device calls (fpr_tpu_torch.solvers.dist_mg_ds,
solvers.dist_multigrid, models.dist_ns, parallel.dist_diffusion and
``navier_stokes.simulate(mesh=)``) on the CPU, on a virtual mesh of CPU
shards.

- Every solve, NS chunk and physical step is one top-level device call (on
  a one-device CUDA mesh one graph launch), and no loop body, cond or
  device function reads the host: they run under the guard of
  tests/test_torch_device_loop.py, which makes host reads raise.
- ``simulate_fast_sharded``'s chunk and snapshot boundaries change no bit
  against a run in one chunk, at beta 0, 0.5 and 1.
- ``simulate(mesh=)`` reads the host once a step (the packed dt and solve
  outcomes), then the final fields.
- A stagnating cold solve with the temperature BCs prints the
  NOT-converged warning once, in ``_warn_unconverged``'s words.
- A mesh over several devices takes the host loops (``Mesh.route``).

The counts and fields of these functions are held against fpr_tpu's
sharded functions by tests/test_torch_dist_*.py.
"""

import collections

import numpy as np
import pytest
import torch

from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy, InitScheme,
                                       MGConfig, NSConfig)
from fpr_tpu_torch.core.grid import outer_steps
from fpr_tpu_torch.models import dist_ns
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.ops import ds as dsm
from fpr_tpu_torch.ops import stencil2d
from fpr_tpu_torch.parallel import dist_diffusion
from fpr_tpu_torch.parallel.mesh import Mesh, make_mesh
from fpr_tpu_torch.solvers import dist_mg_ds, dist_multigrid
from test_torch_device_loop import _READS, _top_level_device_calls, no_host_reads  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the per-shard tensors are small, and more
    threads only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rhs(n, dtype=np.float32, seed=0, nx=None):
    nx = n if nx is None else nx
    b = np.zeros((n, nx), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(seed).random((n - 2, nx - 2))
    return torch.tensor(b)


DS_CFG = MGConfig(coarse_size=17, coarse_solver=CoarseSolver.DST)


# ---------------------------------------------------------------------------
# the sharded solvers: one device call a solve, no host read in a body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("apply_bcs, c", [(False, 0.0), (False, 30.0), (True, 8192.0)])
def test_mg_solve_ds_sharded_is_one_device_call(no_host_reads, apply_bcs, c):
    mesh = make_mesh((4,), ("y",), device="cpu")
    with _top_level_device_calls() as calls:
        (hi, lo), r, it = dist_mg_ds.mg_solve_ds_sharded(
            _rhs(129), 1 / 128, c, 1e-6, 20, mesh, cfg=DS_CFG, replicate_below=33,
            apply_bcs=apply_bcs)
    assert calls[0] == 1 and isinstance(it, int) and 1 <= it < 20
    assert no_host_reads["body"] >= it and float(r) < 1e-6 * float(stencil2d.rms(_rhs(129)))


def test_solve_sharded_velocity_max_is_k1s_maxima_of_the_result(no_host_reads):
    """The NS streamfunction solve's form (a warm start, K1's curl maxima):
    one device call, and maxima equal to those of a single-device K1 pass
    over the gathered result."""
    n = 129
    h = 1 / (n - 1)
    f = _rhs(n, seed=3)
    tolf = torch.tensor(1e-6, dtype=torch.float32) * stencil2d.rms(f)
    mesh = make_mesh((4,), ("y",), device="cpu")
    plan = dist_mg_ds.plan_shards(n, n, 4, DS_CFG, 33)
    f_l = dist_mg_ds.shard_rows(f, plan, mesh)
    u_ds = [torch.zeros((2,) + tuple(b.shape)) for b in f_l]

    def solve(a):
        u, r, it, (ax, ay) = dist_mg_ds.solve_sharded(
            a["u"], a["f"], a["tolf"], plan, h, 0.0, DS_CFG, mesh, "y", 20, 1e-6,
            velocity_max=True)
        return dict(u=u, r=r, it=it, ax=ax, ay=ay)

    with _top_level_device_calls() as calls:
        out = loops.device_call(solve, dict(u=u_ds, f=f_l, tolf=tolf))
    it = int(out["it"])
    assert calls[0] == 1 and 1 <= it < 20 and no_host_reads["body"] >= it
    u = dist_mg_ds.gather_rows(out["u"], plan)
    ext = dsm.defect_pass(u, f[None], None, 0.0, h, 0.0, velocity_max=True)[3]
    assert float(out["ax"]) == float(ext[0]) and float(out["ay"]) == float(ext[1])


def test_mg_solve_ds_sharded_2d_is_one_device_call(no_host_reads):
    mesh = make_mesh((2, 2), ("y", "x"), device="cpu")
    b = _rhs(129, nx=513)
    with _top_level_device_calls() as calls:
        (hi, lo), r, it = dist_mg_ds.mg_solve_ds_sharded_2d(b, 1 / 128, 0.0, 1e-6, 20, mesh,
                                                            cfg=DS_CFG, replicate_below=33)
    assert calls[0] == 1 and isinstance(it, int) and 1 <= it < 20
    assert no_host_reads["body"] >= it and float(r) < 1e-6 * float(stencil2d.rms(b))


@pytest.mark.parametrize("row_shards", [False, True])
def test_mg_solve_sharded_is_one_device_call(no_host_reads, row_shards):
    mesh = make_mesh((4,), ("y",), device="cpu")
    b = _rhs(129, np.float64)
    u0, f = torch.zeros_like(b), b
    if row_shards:
        plan = dist_multigrid.plan_rows(129, 129, 4, MGConfig(), 33)
        u0, f = (dist_multigrid.RowShards.of(a, plan, mesh) for a in (u0, f))
    with _top_level_device_calls() as calls:
        u, r, it = dist_multigrid.mg_solve_sharded(u0, f, 1 / 128, 0.0, 1e-8, 20, mesh,
                                                   replicate_below=33)
    assert calls[0] == 1 and isinstance(it, int) and 1 <= it < 20
    assert no_host_reads["body"] >= it and isinstance(u, dist_multigrid.RowShards) == row_shards


# ---------------------------------------------------------------------------
# part 1's sharded pseudo-time loop: one device call a physical step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy, K, overlap, shape, axes", [
    (ExecutionPolicy.JNP, 1, False, (2, 2), ("z", "y")),
    (ExecutionPolicy.JNP, 1, True, (4,), ("z",)),
    (ExecutionPolicy.PALLAS, 1, False, (2, 2, 2), ("z", "y", "x")),
    (ExecutionPolicy.PALLAS, 1, True, (4,), ("z",)),
    (ExecutionPolicy.PALLAS, 2, False, (4,), ("z",)),
])
def test_solve_distributed_is_one_device_call_a_step(no_host_reads, policy, K, overlap, shape,
                                                     axes):
    cfg = DiffusionConfig(nx=8, ny=8, nz=4, ttot=0.4, tol=1e-5, policy=policy, check_every=K,
                          overlap_comm=overlap)
    with _top_level_device_calls() as calls:
        out = dist_diffusion.solve_distributed(cfg, make_mesh(shape, axes, device="cpu"))
    nt = outer_steps(cfg.ttot, cfg.dt)
    assert out.converged and calls[0] == no_host_reads["device_call"] == nt
    assert out.iters_total % K == 0 and no_host_reads["body"] == out.iters_total // K


def test_step_returns_a_numpy_err_of_the_field_dtype():
    mesh = make_mesh((2,), ("z",), device="cpu")
    for dtype in (torch.float32, torch.float64):
        cfg = DiffusionConfig(nx=8, ny=8, nz=4, tol=1e-5, iter_max=20,
                              policy=ExecutionPolicy.JNP)
        step, grid = dist_diffusion.build_step(cfg, mesh, dtype=dtype)
        Ht = [torch.rand(4, 8, 8, dtype=dtype, generator=torch.Generator().manual_seed(d))
              for d in range(2)]
        H, H2, err, it = step(Ht, Ht)
        assert H is H2 and isinstance(it, int) and it >= 1
        assert type(err) is {torch.float32: np.float32, torch.float64: np.float64}[dtype]


# ---------------------------------------------------------------------------
# the sharded NS fast loop: one device call a chunk
# ---------------------------------------------------------------------------

KW = dict(nx=65, ny=33, Pr=0.01, tol=1e-7, niters=50, W_init=InitScheme.FROM_ARRAY)
W0 = np.random.default_rng(42).standard_normal((33, 65)) * 10.0


def _sharded_run(beta, **kw):
    cfg = NSConfig(ttot=10.0, beta=beta, **KW)
    return dist_ns.simulate_fast_sharded(cfg, make_mesh((4,), ("y",), device="cpu"), W0=W0,
                                         max_steps=5, replicate_below=17, **kw)


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_simulate_fast_sharded_one_device_call_a_chunk(no_host_reads, beta):
    """The warm-up chunk (3 steps), then with chunk_steps=1 and
    snapshot_steps=2 the chunks 3-4 and 4-5, a snapshot at each end: the
    same bits as one chunk."""
    whole = _sharded_run(beta)
    with _top_level_device_calls() as calls:
        got = _sharded_run(beta, chunk_steps=1, snapshot_steps=2)
    assert calls[0] == 3 and got.steps == whole.steps == 5
    assert [s[4] for s in got.snapshots] == [4, 5]
    assert got.sim_time == whole.sim_time and got.timed_iters == whole.timed_iters == 2
    for k in "TWS":
        np.testing.assert_array_equal(getattr(got, k), getattr(whole, k))
    for k in ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo", "step"):
        assert torch.equal(torch.as_tensor(got.state[k]), torch.as_tensor(whole.state[k])), k
    assert no_host_reads["body"] >= 2 * 5


# ---------------------------------------------------------------------------
# simulate(mesh=): one device call and one host read a step
# ---------------------------------------------------------------------------


def test_simulate_mesh_reads_the_host_once_a_step(no_host_reads, monkeypatch):
    """Outside its device calls, the GSPMD tier's simulate reads one value a
    step (the packed dt and solve outcomes) and the final T, W, S once
    each; every step is one device call."""
    reads, depth = collections.Counter(), [0]
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name, **k):
            reads[_name] += depth[0] == 0
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, read)
    call = loops.device_call

    def device_call(fn, carry, key=None):
        depth[0] += 1
        try:
            return call(fn, carry, key)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(loops, "device_call", device_call)
    steps = 2
    cfg = NSConfig(nx=33, ny=257, ttot=1.0, beta=0.5, Pr=0.1, tol=1e-7, niters=30,
                   mg_solver="direct")
    assert dist_multigrid.plan_rows(257, 33, 4, cfg.mg, tns.SHARD_ROWS).s >= 1
    with _top_level_device_calls() as calls:
        out = tns.simulate(cfg, max_steps=steps, mesh=make_mesh((4,), ("y",), device="cpu"))
    assert out.steps == steps == calls[0]
    assert {k: v for k, v in reads.items() if v} == {"tolist": steps, "cpu": 3, "numpy": 3}


# ---------------------------------------------------------------------------
# the non-convergence warning of a stagnating cold solve with the BCs
# ---------------------------------------------------------------------------

HINT = (" (known cold-BC stagnation: the jnp-tier iterate cycle smooths the Neumann side "
        "columns as Dirichlet-0 — reference-parity behavior; the ds/rp correction cycles "
        "avoid it via eliminated-BC smoothing (_ELIM_BC_SMOOTH), see mg_solve_ds_rp's "
        "docstring)")


@pytest.mark.parametrize("solver", ["mg_solve_ds_sharded", "mg_solve_sharded"])
def test_stagnating_cold_sharded_solve_warns(capfd, solver):
    n, niters, tol = 129, 6, 1e-10
    mesh = make_mesh((4,), ("y",), device="cpu")
    if solver == "mg_solve_ds_sharded":
        b = _rhs(n, seed=17)
        _, r, it = dist_mg_ds.mg_solve_ds_sharded(b, 1 / (n - 1), 0.0, tol, niters, mesh,
                                                  cfg=DS_CFG, replicate_below=33,
                                                  apply_bcs=True)
        tolf = tol * stencil2d.rms(b)
    else:
        b = _rhs(n, np.float64, seed=17)
        _, r, it = dist_multigrid.mg_solve_sharded(torch.zeros_like(b), b, 1 / (n - 1), 0.0,
                                                   tol, niters, mesh, apply_bcs=True,
                                                   replicate_below=33)
        tolf = tol * stencil2d.rms(b)
    lines = capfd.readouterr().out.splitlines()
    assert it == niters
    r32, t32 = (float(np.float32(float(v))) for v in (r, tolf))
    assert lines == [f"WARNING: {solver} exited at niters={niters} with r_rms {r32:.3e} >= "
                     f"tol*rms(f) {t32:.3e} — NOT converged{HINT}"]


# ---------------------------------------------------------------------------
# the route: graphs on one device, host loops over several
# ---------------------------------------------------------------------------


def test_a_mesh_over_several_devices_takes_the_host_loops():
    one = make_mesh((4,), ("y",), device="cpu")
    several = Mesh((2,), ("y",), [torch.device("cpu", 0), torch.device("cpu", 1)])
    assert one.one_device and not several.one_device
    with one.route():
        assert loops._state.mode is None
    with several.route():
        assert loops._state.mode == "host"
