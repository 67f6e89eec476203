"""The single-device host tiers as device calls (fpr_tpu_torch.solvers.multigrid:
mg_solve, mg_solve_rp, mg_solve_mixed, mg_solve_ds with fmg, mg_solve_ds_rp
with field_sumsq; fpr_tpu_torch.models.navier_stokes: ns_step, simulate)
against fpr_tpu on the CPU, in float64 where the solver allows it.

- Every solve is one device call (on CUDA one graph launch) whose loop
  bodies read nothing on the host: they run under the guard of
  tests/test_torch_device_loop.py, which makes host reads raise.  Outer
  and step counts equal JAX's; fields within the bounds of the tests of
  each solver (tests/test_torch_mg_solve.py: 1e-10 of max|u|;
  tests/test_torch_vcycle_rp.py: 1e-12 for mg_solve_rp, 1e-6 for the
  mixed solver; tests/test_torch_ns_host.py: fields within 1e-8 of their
  maxima, sim_time within 1e-12 relative (direct) and 1e-8 (mixed)).
- ``simulate(max_steps=N)`` reads the host once a step: N scalar reads,
  then the final fields' transfer.
- A stagnating cold ``mg_solve(apply_bcs=True)`` prints JAX's warning.
- ``mg_solve_ds(fmg=True)`` as tests/test_ds.py drives JAX's (257^2, the
  legs on every level from 65^2): JAX's outer count, u within 1e-6 of
  max|u|, r_rms below tol rms(f), no more outers than without FMG; a cfg
  that is not stk-eligible ignores fmg, bit for bit.
- ``mg_solve_ds_rp(field_sumsq=True)``: JAX's extras within tests/test_ds.py's
  bounds (maxima 1e-6 relative, the sum 1e-5).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import InitScheme as JInit
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu.ops import pallas2d
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import InitScheme, MGConfig, NSConfig, Restriction
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.ops import stencil2d
from fpr_tpu_torch.solvers import multigrid as tmg
from test_torch_device_loop import _READS, _top_level_device_calls, no_host_reads  # noqa: F401
from test_torch_mg_solve import compare_mg_solve


@pytest.fixture
def legs_on(monkeypatch):
    """The fused legs on every level from 65^2 on both sides."""
    monkeypatch.setattr(jmg, "PALLAS_MIN_AREA", 65 * 65)
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 65 * 65)


def _rhs(ny, nx, seed, dtype=np.float64):
    b = np.zeros((ny, nx), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(seed).standard_normal((ny - 2, nx - 2))
    return b


# ---------------------------------------------------------------------------
# the host tiers' solvers: one device call, no host read in a body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coarse, policy", [("jacobi", "jnp"), ("cg", "jnp"),
                                            ("jacobi", "pallas")])
def test_mg_solve_is_one_device_call(no_host_reads, coarse, policy):
    with _top_level_device_calls() as calls:
        it = compare_mg_solve(7, 2, coarse, policy)
    assert calls[0] == 1 and no_host_reads["body"] >= it


def test_mg_solve_rp_is_one_device_call(no_host_reads, legs_on):
    for (ny, nx), c, apply_bcs, niters in (((129, 129), 0.0, False, 30),
                                           ((65, 257), 50.0, True, 12)):
        h = 1.0 / (ny - 1)
        b = _rhs(ny, nx, 11)
        uj, _, ij = jmg.mg_solve_rp(jnp.zeros((ny, nx)), jnp.asarray(b), h, c, 1e-8, niters,
                                    apply_bcs=apply_bcs)
        with _top_level_device_calls() as calls:
            ut, _, it = tmg.mg_solve_rp(torch.zeros((ny, nx), dtype=torch.float64),
                                        torch.tensor(b), h, c, 1e-8, niters, apply_bcs=apply_bcs)
        assert calls[0] == 1 and it == int(ij) and isinstance(it, int)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                                   atol=1e-12 * np.abs(uj).max())


@pytest.mark.parametrize("apply_bcs", [False, True])
def test_mg_solve_mixed_is_one_device_call(no_host_reads, legs_on, apply_bcs):
    rng = np.random.default_rng(13)
    if apply_bcs:  # the NS temperature solve: c h^2 = 0.5, a warm start
        ny, nx = 65, 257
        h = 1.0 / (ny - 1)
        c, b, u0 = 0.5 / (h * h), rng.random((ny, nx)) * 0.5 / (h * h), rng.random((ny, nx))
    else:
        ny = nx = 129
        h = 1.0 / (ny - 1)
        c, b, u0 = 0.0, _rhs(ny, nx, 13), np.zeros((ny, nx))
    uj, _, ij = jmg.mg_solve_mixed(jnp.asarray(u0), jnp.asarray(b), h, c, 1e-8, 40,
                                   apply_bcs=apply_bcs)
    with _top_level_device_calls() as calls:
        ut, rt, it = tmg.mg_solve_mixed(torch.tensor(u0), torch.tensor(b), h, c, 1e-8, 40,
                                        apply_bcs=apply_bcs)
    assert calls[0] == 1 and it == int(ij) < 40 and no_host_reads["body"] >= it
    assert rt.dtype == torch.float64
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-6 * np.abs(uj).max())


# ---------------------------------------------------------------------------
# the NS host loop: one device call a step, one host read a step
# ---------------------------------------------------------------------------

NS = dict(nx=65, ny=33, Pr=0.1, tol=1e-7, ttot=1.0, W_init=None)


def _ns_pair(beta, mg_solver):
    common = dict(NS, beta=beta, mg_solver=mg_solver)
    return (JNS(**dict(common, W_init=JInit.FROM_ARRAY)),
            NSConfig(**dict(common, W_init=InitScheme.FROM_ARRAY)))


W0 = np.random.default_rng(5).standard_normal((33, 65)) * 10.0


@pytest.mark.parametrize("beta, mg_solver", [(0.0, "direct"), (0.5, "mixed"), (1.0, "mixed"),
                                             (0.5, "direct")])
def test_ns_step_is_one_device_call(no_host_reads, legs_on, beta, mg_solver):
    jcfg, tcfg = _ns_pair(beta, mg_solver)
    steps = 4
    ref = jns.simulate(jcfg, W0=W0, max_steps=steps, dtype=jnp.float64)
    with _top_level_device_calls() as calls:
        got = tns.simulate(tcfg, W0=W0, max_steps=steps, device="cpu")
    assert got.steps == ref.steps == steps == calls[0]
    # the S solve, and the T and W solves when semi-implicit
    assert no_host_reads["device_call"] >= steps * (3 if beta > 0 else 1) + steps
    rel = 1e-12 if mg_solver == "direct" else 1e-8
    assert abs(got.sim_time - ref.sim_time) <= rel * ref.sim_time
    for name in ("T", "W", "S"):
        want = getattr(ref, name)
        assert np.abs(getattr(got, name) - want).max() <= 1e-8 * np.abs(want).max(), name


def test_ns_step_returns_a_device_dt():
    _, tcfg = _ns_pair(0.5, "mixed")
    T = tns.init_field(tcfg, InitScheme.COSINE, device="cpu", dtype=torch.float64)
    W = torch.tensor(W0)
    T1, W1, S1, dt = tns.ns_step(T, W, torch.zeros_like(W), tcfg)
    assert isinstance(dt, torch.Tensor) and dt.shape == () and dt.dtype == torch.float64
    T2, W2, S2, _, dt2 = tns._ns_step(T, W, torch.zeros_like(W), tcfg)
    assert dt2 == float(dt) and all(torch.equal(a, b) for a, b in
                                    ((T1, T2), (W1, W2), (S1, S2)))


@pytest.mark.parametrize("steps", [1, 5])
def test_simulate_reads_the_host_once_a_step(no_host_reads, monkeypatch, steps):
    """Outside its device calls, simulate reads one value a step (the
    packed dt and solve outcomes) and the final T, W, S once each."""
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
    _, tcfg = _ns_pair(0.5, "mixed")
    out = tns.simulate(tcfg, W0=W0, max_steps=steps, device="cpu")
    assert out.steps == steps
    assert {k: v for k, v in reads.items() if v} == {"tolist": steps, "cpu": 3, "numpy": 3}


# ---------------------------------------------------------------------------
# the non-convergence warning
# ---------------------------------------------------------------------------


def test_stagnating_cold_solve_warns_as_jax(capfd):
    """The known cold-BC stagnation (apply_bcs, c = 0, from zero): both
    packages stop at niters and print the same warning."""
    ny, nx = 33, 65
    h = 1.0 / (ny - 1)
    b = np.random.default_rng(17).random((ny, nx))
    niters = 6
    uj, rj, ij = jmg.mg_solve(jnp.zeros((ny, nx)), jnp.asarray(b), h, 0.0, 1e-10, niters,
                              apply_bcs=True)
    jax.block_until_ready(uj)
    jax.effects_barrier()
    want = capfd.readouterr().out
    ut, rt, it = tmg.mg_solve(torch.zeros((ny, nx), dtype=torch.float64), torch.tensor(b), h,
                              0.0, 1e-10, niters, apply_bcs=True)
    got = capfd.readouterr().out
    assert it == int(ij) == niters
    line = [s for s in want.splitlines() if "NOT converged" in s]
    assert len(line) == 1 and "known cold-BC stagnation" in line[0]
    assert got.splitlines() == line


# ---------------------------------------------------------------------------
# mg_solve_ds(fmg=True) and mg_solve_ds_rp(field_sumsq=True)
# ---------------------------------------------------------------------------


def test_mg_solve_ds_fmg_matches_jax(no_host_reads, legs_on):
    n, tol = 257, 1e-6
    h = 1.0 / (n - 1)
    b = _rhs(n, n, 23, np.float32)
    uj, _, ij = jmg.mg_solve_ds(None, jnp.asarray(b), h, 0.0, tol, 30, JMG(coarse_size=17),
                                fmg=True)
    cfg = MGConfig(coarse_size=17)
    bt = torch.tensor(b)
    u1, r1, i1 = tmg.mg_solve_ds(None, bt, h, 0.0, tol, 30, cfg, fmg=True)
    _, _, i0 = tmg.mg_solve_ds(None, bt, h, 0.0, tol, 30, cfg)
    uj = np.asarray(uj)
    assert i1 == int(ij) and i1 <= i0
    assert np.abs(u1.numpy() - uj).max() <= 1e-6 * np.abs(uj).max()
    assert float(r1) < tol * float(stencil2d.rms(bt.double()))
    # a cfg the stacked V-cycle does not take ignores fmg
    fw = MGConfig(coarse_size=17, restriction=Restriction.FULL_WEIGHTING)
    plain = tmg.mg_solve_ds(None, bt, h, 0.0, tol, 30, fw)
    fmg = tmg.mg_solve_ds(None, bt, h, 0.0, tol, 30, fw, fmg=True)
    assert plain[2] == fmg[2] and torch.equal(plain[0], fmg[0]) and torch.equal(plain[1], fmg[1])


@pytest.mark.parametrize("flags", [dict(field_sumsq=True),
                                   dict(field_sumsq=True, velocity_max=True)])
def test_mg_solve_ds_rp_field_sumsq_matches_jax(flags):
    ny, nx = 65, 129
    h = 1.0 / 64
    f = np.random.default_rng(29).standard_normal((ny, nx)).astype(np.float32)
    br = pallas2d._pick_br(ny, nx, 4)
    tolf = 1e-6 * float(np.sqrt(np.mean(f.astype(np.float64) ** 2)))
    uj, rj, ij, exj = jmg.mg_solve_ds_rp(None, pallas2d.pad2d(jnp.asarray(f), br)[None], tolf,
                                         ny, nx, h, 0.0, 20, JMG(), tol=1e-6, **flags)
    ut, rt, it, ext = tmg.mg_solve_ds_rp(None, torch.tensor(f)[None], tolf, h, 0.0, 20, MGConfig(),
                                         tol=1e-6, **flags)
    assert int(it) == int(ij)
    # JAX's extras tuple (max_vx, max_vy, sumsq) whichever flag is set
    assert len(ext) == len(exj) == 3
    for got, w, rel in zip(ext, exj, [1e-6, 1e-6, 1e-5]):
        assert float(got) == pytest.approx(float(w), rel=rel)
    u_hi = pallas2d.unpad2d(uj[0], ny, nx)
    assert float(ext[-1]) == pytest.approx(float(jnp.sum(u_hi.astype(jnp.float64) ** 2)),
                                           rel=1e-5)
