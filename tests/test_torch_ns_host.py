"""The port's Navier-Stokes host loop (fpr_tpu_torch.models.navier_stokes:
init_field, compute_dt, ns_step, simulate; the NS operators of
fpr_tpu_torch.ops.stencil2d) against the Fortran fixtures and against
fpr_tpu on the CPU, in float64.

The reference's bar for one explicit step at 257x65 is an interior atol of
1e-8 against the Fortran dumps (tests/test_navier_stokes.py).  Against the
JAX host loop on the same W0: equal step counts, sim_time within 1e-12
relative with the direct solver and 1e-8 with the mixed one (one dt read
per step, summed on the host; the mixed solver's float32 cycles round
differently), fields within 1e-8 of their maxima (the solves stop at tol
1e-7 on sums taken in another order).  The JAX operators and the port's agree to float64 rounding
(1e-12 of the field's scale).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import InitScheme as JInit
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.core.config import ExecutionPolicy as JPolicy
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu.ops import stencil2d as jops
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu.utils.io import load_fortran
from fpr_tpu_torch.core.config import ExecutionPolicy, InitScheme, MGConfig, NSConfig
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.ops import stencil2d as tops
from fpr_tpu_torch.solvers import multigrid as tmg

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fix(name):
    return load_fortran(os.path.join(FIX, f"{name}.bin"))


def _interior_err(got, ref):
    return np.abs(got[1:-1, 1:-1] - ref[1:-1, 1:-1]).max()


@pytest.fixture(scope="module")
def fortran_step():
    cfg = NSConfig(nx=257, ny=65, Pr=1.0e-3, Ra=1.0e6, beta=0.0, tol=1.0e-12, ttot=0.1,
                   W_init=InitScheme.FROM_ARRAY)
    return tns.simulate(cfg, W0=_fix("Winit"), max_steps=1, device="cpu")


@pytest.mark.parametrize("name", ["T", "W", "S"])
def test_one_step_matches_fortran(fortran_step, name):
    assert fortran_step.steps == 1
    assert _interior_err(getattr(fortran_step, name), _fix(name)) < 1e-8


def test_intermediates_match_fortran():
    """The operator chain piecewise against the fixture dumps, at the JAX
    test's bars (tests/test_navier_stokes.py::test_intermediates_vs_fortran)."""
    cfg = NSConfig(nx=257, ny=65, Pr=1.0e-3)
    h = cfg.h
    W0 = torch.tensor(_fix("Winit"))
    T0 = tns.init_field(cfg, InitScheme.COSINE, device="cpu", dtype=torch.float64)
    assert _interior_err(T0.numpy(), _fix("Tinit")) < 1e-12
    S, _, _ = tmg.mg_solve(torch.zeros_like(W0), W0, h, 0.0, 1e-12, 50)
    vx, vy = tops.velocity(S, h, h)
    assert _interior_err(vx.numpy(), _fix("vx")) < 1e-8
    assert _interior_err(vy.numpy(), _fix("vy")) < 1e-8
    from fpr_tpu_torch.core import bc

    T = bc.ns_temperature_bcs(T0)
    assert _interior_err(tops.diffusion(T, cfg.k, h, h).numpy(), _fix("dT2")) < 1e-6
    assert _interior_err(tops.diffusion(W0, cfg.Pr, h, h).numpy(), _fix("dW2")) < 1e-8
    assert _interior_err(tops.buoyancy(T, cfg.Ra, h).numpy(), _fix("Ra_dTdx")) < 1e-4


OPS = {
    "laplacian_interior": lambda m, a, b, h: m.laplacian_interior(a, h, 0.5 * h),
    "matvec": lambda m, a, b, h: m.matvec(a, h, h, 3.14),
    "red_black_gs_step": lambda m, a, b, h: m.red_black_gs_step(a, b, h, 3.14)[0],
    "red_black_gs_norm": lambda m, a, b, h: m.red_black_gs_step(a, b, h, 0.0)[1],
    "velocity_x": lambda m, a, b, h: m.velocity(a, h, h)[0],
    "velocity_y": lambda m, a, b, h: m.velocity(a, h, h)[1],
    "buoyancy": lambda m, a, b, h: m.buoyancy(a, 1e6, h),
    "diffusion": lambda m, a, b, h: m.diffusion(a, 0.01, h, h),
    "advection_x": lambda m, a, b, h: m.advection_x(a, b, h),
    "advection_y": lambda m, a, b, h: m.advection_y(a, b, h),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_ns_operators_match_jax(rng, op):
    a, b = rng.standard_normal((33, 129)), rng.standard_normal((33, 129))
    h = 1.0 / 32
    want = np.asarray(OPS[op](jops, jnp.asarray(a), jnp.asarray(b), h))
    got = OPS[op](tops, torch.tensor(a), torch.tensor(b), h).numpy()
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0) if want.ndim else abs(float(want))
    assert np.abs(got - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_compute_dt_matches_jax(rng, beta):
    cfg, jcfg = NSConfig(nx=65, ny=17, beta=beta, Pr=0.01), JNS(nx=65, ny=17, beta=beta, Pr=0.01)
    vx, vy = rng.standard_normal((17, 65)), rng.standard_normal((17, 65))
    got = float(tns.compute_dt(torch.tensor(vx), torch.tensor(vy), cfg))
    assert got == float(jns.compute_dt(jnp.asarray(vx), jnp.asarray(vy), jcfg))
    zero = torch.zeros((17, 65), dtype=torch.float64)
    assert float(tns.compute_dt(zero, zero, cfg)) == cfg.dt_dif


def _pair(beta, mg_solver, policy="jnp"):
    # a few steps: the diffusive dt (explicit) is ~6e-4; the advective one
    # is 0.0283 in the first semi-implicit step and ~3e-5 after it
    common = dict(nx=65, ny=17, Pr=0.1, tol=1e-7, ttot=4e-3 if beta == 0 else 0.0284,
                  beta=beta,
                  mg_solver=mg_solver,
                  W_init=JInit.FROM_ARRAY)
    jcfg = JNS(**common, mg=JMG(policy=JPolicy(policy)))
    common["W_init"] = InitScheme.FROM_ARRAY
    tcfg = NSConfig(**common, mg=MGConfig(policy=ExecutionPolicy(policy)))
    return jcfg, tcfg


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("mg_solver", ["direct", "mixed"])
def test_simulate_matches_jax(monkeypatch, beta, mg_solver):
    """Whole runs on the same W0: the step count (dt is data-dependent
    through the velocity), the simulated time and the fields.  The mixed
    solver runs its legs on the 65x17 level (PALLAS_MIN_AREA lowered); its
    float32 cycles round differently on the two sides (FMA contraction), so
    S and with it dt agree to 1e-8 there, to 1e-12 with the direct solver."""
    monkeypatch.setattr(jmg, "PALLAS_MIN_AREA", 17 * 65)
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 17 * 65)
    jcfg, tcfg = _pair(beta, mg_solver)
    W0 = np.random.default_rng(5).standard_normal((17, 65)) * 10.0
    ref = jns.simulate(jcfg, W0=W0, max_steps=400, dtype=jnp.float64)
    got = tns.simulate(tcfg, W0=W0, max_steps=400, device="cpu")
    assert 3 <= got.steps == ref.steps < 400
    assert got.timed_iters == ref.timed_iters
    rel = 1e-12 if mg_solver == "direct" else 1e-8
    assert abs(got.sim_time - ref.sim_time) <= rel * ref.sim_time
    for name in ("T", "W", "S"):
        want = getattr(ref, name)
        assert np.abs(getattr(got, name) - want).max() <= 1e-8 * np.abs(want).max(), name


def test_simulate_pallas_policy_matches_jax():
    """The direct solver with policy PALLAS: the stencil-pass kernel's
    smoother and residual at every level (#5 on the NS path)."""
    jcfg, tcfg = _pair(0.5, "direct", policy="pallas")
    W0 = np.random.default_rng(5).standard_normal((17, 65)) * 10.0
    ref = jns.simulate(jcfg, W0=W0, max_steps=3, dtype=jnp.float64)
    got = tns.simulate(tcfg, W0=W0, max_steps=3, device="cpu")
    assert got.steps == ref.steps == 3
    assert abs(got.sim_time - ref.sim_time) <= 1e-12 * ref.sim_time
    for name in ("T", "W", "S"):
        want = getattr(ref, name)
        assert np.abs(getattr(got, name) - want).max() <= 1e-8 * np.abs(want).max(), name


@pytest.mark.parametrize("beta,mg_solver,steps,seed", [(0.0, "direct", 6, 7),
                                                       (0.5, "mixed", 3, 11)])
def test_host_loop_matches_fast_loop(beta, mg_solver, steps, seed):
    """The port's float64 host loop against its float32 fused fast loop on
    the same W0, as the JAX tests compare them (test_navier_stokes.py:
    test_simulate_fast_matches_host_loop_*; the semi-implicit run reaches
    ttot in its first step)."""
    cfg = NSConfig(nx=65, ny=65, ttot=1e-3, beta=beta, Pr=0.01 if beta == 0 else 0.1,
                   tol=1e-7, niters=50, mg_solver=mg_solver)
    W0 = np.random.default_rng(seed).standard_normal((65, 65)) * 10.0
    ref = tns.simulate(cfg, W0=W0, max_steps=steps, device="cpu")
    got = tns.simulate_fast(cfg, W0=W0, max_steps=steps, device="cpu")
    assert got.steps == ref.steps
    rtol = 2e-4 if beta == 0 else 1e-3
    if beta == 0:
        assert abs(got.sim_time - ref.sim_time) < 1e-6 * ref.sim_time
    np.testing.assert_allclose(got.T, ref.T, rtol=rtol, atol=rtol / 10)
    np.testing.assert_allclose(got.W, ref.W, rtol=rtol, atol=rtol * np.abs(ref.W).max())


def test_init_field_dtype_and_schemes():
    cfg = NSConfig(nx=65, ny=17)
    for dtype in (torch.float32, torch.float64):
        T = tns.init_field(cfg, InitScheme.COSINE, device="cpu", dtype=dtype)
        assert T.dtype == dtype and T.shape == (17, 65)
        want = np.asarray(jns.init_field(JNS(nx=65, ny=17), JInit.COSINE))
        np.testing.assert_allclose(T.double().numpy(), want,
                                   atol=0 if dtype == torch.float64 else 1e-7)
    assert tns.init_field(cfg, InitScheme.COSINE, device="cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="mg_solver"):
        tns.ns_step(*[torch.zeros((17, 65), dtype=torch.float64)] * 3,
                    NSConfig(nx=65, ny=17, mg_solver="ds"))


def test_simulate_snapshots_and_warmup():
    cfg = NSConfig(nx=65, ny=17, Pr=0.1, tol=1e-7, ttot=1.0, beta=0.5)
    out = tns.simulate(cfg, max_steps=5, snapshot_every=2, device="cpu")
    assert out.steps == 5 and out.timed_iters == 2
    assert len(out.snapshots) == 3
    np.testing.assert_array_equal(out.snapshots[-1][0], out.T)


@pytest.mark.parametrize("argv,expect", [
    (["ns", "--device", "cpu", "--nx", "65", "--ny", "17", "--Pr", "0.1", "--beta", "0.5",
      "--tol", "1e-7", "--ttot", "1", "--max-steps", "3", "--f64", "--policy", "pallas"],
     "steps: 3"),
    (["mg", "--device", "cpu", "--k", "6", "--l", "2", "--solver", "mixed"], "[mixed]"),
    (["mg", "--device", "cpu", "--k", "6", "--l", "2", "--solver", "direct", "--coarse", "cg",
      "--f64"], "[direct]"),
])
def test_cli_smoke(argv, expect):
    out = subprocess.run([sys.executable, "-m", "fpr_tpu_torch", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
