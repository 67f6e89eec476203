"""The port's multigrid (fpr_tpu_torch.solvers.multigrid: vcycle_stk,
mg_solve_ds) against fpr_tpu.solvers.multigrid on the CPU.

PALLAS_MIN_AREA is lowered to 65*65 on both sides (as
tests/test_pallas2d.py does) so that the fused legs run on the fine
levels of these small grids.

Outer-iteration counts must be equal.  Fields: the two sides round
differently (XLA:CPU contracts FMAs, the DST matmuls sum in other orders),
so one V-cycle agrees to 1e-5 of max|u|; converged solutions, both below
the same defect tolerance, to 1e-6 of max|u|.  Residual norms may differ by
the operator applied to that field difference (8/h^2 max|du|), plus, for
the float32 cycle's estimate, its rounding floor (64 ulps of the largest
stencil term).  The port's true float64 residual must meet the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import CoarseSolver as JCoarse
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.ops import pallas2d
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.ops import stencil2d
from fpr_tpu_torch.solvers import multigrid as tmg

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def legs_on(monkeypatch):
    monkeypatch.setattr(jmg, "PALLAS_MIN_AREA", 65 * 65)
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 65 * 65)


def _cfgs(coarse, sm, dst=True):
    kw = dict(coarse_size=coarse, pre_smooth=sm, post_smooth=sm)
    return (JMG(coarse_solver=JCoarse.DST if dst else JCoarse.JACOBI, **kw),
            MGConfig(coarse_solver=CoarseSolver.DST if dst else CoarseSolver.JACOBI, **kw))


@pytest.mark.parametrize("sm", [3, 5])
def test_vcycle_stk_matches_jax(rng, legs_on, sm):
    n = 129
    h = 1.0 / (n - 1)
    jcfg, tcfg = _cfgs(33, sm)
    f = rng.standard_normal((n, n)).astype(np.float32)
    br = pallas2d._pick_br(n, n, 4)
    total, nxp = pallas2d.padded_rows(n, br), pallas2d.padded_cols(n)
    L = jnp.zeros((2, total, nxp), jnp.float32).at[1].set(pallas2d.pad2d(jnp.asarray(f), br))
    Lt = torch.stack([torch.full((n, n), 1e6), torch.tensor(f)])
    for cyc in range(2):
        L, r = jmg.vcycle_stk(L, n, n, h, 0.0, 1e-7, jcfg, assume_zero_u=(cyc == 0))
        Lt, rt = tmg.vcycle_stk(Lt, h, 0.0, 1e-7, tcfg, assume_zero_u=(cyc == 0))
        u = np.asarray(pallas2d.unpad2d(L[0], n, n))
        du = np.abs(Lt[0].numpy() - u).max()
        assert du <= 1e-5 * np.abs(u).max()
        # |d rms(res)| <= max|d res|: the operator on du plus the float32
        # rounding floor of the residual, 64 ulps of its largest term
        floor = 64 * EPS32 * (np.abs(u).max() * 4 / h**2 + np.abs(f).max())
        assert abs(float(rt) - float(r)) <= 8 / h**2 * du + floor
    np.testing.assert_array_equal(Lt[1].numpy(), f)


def test_vcycle_stk_handoff_ignores_stale_plane0(rng):
    """With assume_zero_u, L[0] is unspecified (the defect pass leaves the
    old correction there); a poisoned plane must not change the cycle."""
    n = 65
    f = torch.tensor(rng.standard_normal((n, n)))
    cfg = MGConfig(coarse_size=17)
    clean = torch.stack([torch.zeros_like(f), f])
    stale = torch.stack([torch.full_like(f, 1e6), f])
    a, ra = tmg.vcycle_stk(clean, 1.0 / 64, 0.0, 1e-8, cfg, assume_zero_u=True)
    b, rb = tmg.vcycle_stk(stale, 1.0 / 64, 0.0, 1e-8, cfg, assume_zero_u=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(ra) == float(rb)


def _true_rel(u, b, h, c):
    u64, b64 = torch.as_tensor(u).double(), torch.as_tensor(b).double()
    return float(stencil2d.rms(stencil2d.residual(u64, b64, h, c)) / stencil2d.rms(b64))


@pytest.mark.parametrize("n", [129, 257])
@pytest.mark.parametrize("sm", [3, 5])
def test_mg_solve_ds_outer_counts_match(rng, legs_on, n, sm):
    h = 1.0 / (n - 1)
    tol = 1e-6
    jcfg, tcfg = _cfgs(33, sm)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    (jh, jl), rj, itj = jmg.mg_solve_ds(None, jnp.asarray(b), h, 0.0, tol, 30,
                                        cfg=jcfg, return_pair=True)
    (th, tl), rt, itt = tmg.mg_solve_ds(None, torch.tensor(b), h, 0.0, tol, 30,
                                        cfg=tcfg, return_pair=True)
    assert itt == int(itj)
    uj = np.asarray(jh, np.float64) + np.asarray(jl)
    ut = th.double() + tl.double()
    du = np.abs(ut.numpy() - uj).max()
    assert du <= 1e-6 * np.abs(uj).max()
    # both are true ds defects: they differ by at most |A du|
    assert abs(float(rt) - float(rj)) <= 8 / h**2 * du + 1e-5 * float(rj)
    assert _true_rel(ut, b, h, 0.0) <= tol


def test_mg_solve_ds_helmholtz_apply_bcs_matches(rng, legs_on):
    """The NS temperature solve's contract: a Helmholtz shift, apply_bcs
    (eliminated-BC smoothing in the correction cycles) and a warm start."""
    n = 129
    h = 1.0 / (n - 1)
    c = 0.5 / (h * h)
    jcfg, tcfg = _cfgs(33, 3)
    b = rng.random((n, n)) * c
    u0 = rng.random((n, n))
    uj, rj, itj = jmg.mg_solve_ds(jnp.asarray(u0), jnp.asarray(b), h, c, 1e-8, 50,
                                  cfg=jcfg, apply_bcs=True)
    ut, rt, itt = tmg.mg_solve_ds(torch.tensor(u0), torch.tensor(b), h, c, 1e-8, 50,
                                  cfg=tcfg, apply_bcs=True)
    assert itt == int(itj)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-9 * np.abs(uj).max())
    got = ut.numpy()
    np.testing.assert_array_equal(got[0, 1:-1], 1.0)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def test_mg_solve_ds_default_jacobi_ladder_matches(rng):
    """The small-grid ladder of the NS fast loop: coarse 5, Jacobi coarse
    solve, V(2,2), two cycles per outer, all on the plain subtree."""
    n = 65
    h = 1.0 / (n - 1)
    b = rng.standard_normal((n, n)).astype(np.float32)
    uj, rj, itj = jmg.mg_solve_ds(None, jnp.asarray(b), h, 0.0, 1e-6, 30, cfg=JMG())
    ut, rt, itt = tmg.mg_solve_ds(None, torch.tensor(b), h, 0.0, 1e-6, 30, cfg=MGConfig())
    assert itt == int(itj)
    uj = np.asarray(uj)
    assert np.abs(ut.numpy() - uj).max() <= 1e-6 * np.abs(uj).max()


def test_mg_solve_ds_needs_an_explicit_device_for_arrays():
    with pytest.raises(ValueError, match="device"):
        tmg.mg_solve_ds(None, np.zeros((9, 9), np.float32), 0.125, 0.0, 1e-6, 5)
