"""The port's reference-semantics multigrid (fpr_tpu_torch.solvers.multigrid:
mg_solve, vcycle with its smoothers, restrictions and coarse solvers)
against fpr_tpu.solvers.multigrid on the CPU in float64, with policy JNP
(plain PyTorch on both sides); tests/test_torch_mg_solve_pallas.py holds
the PALLAS policy.

The sweep is the reference's (test/multigrid.jl:30-58): grid k 7..9 x
coarse l 2..3 x {Jacobi, CG} coarse solve, tol 1e-6.  Cycle counts must be
equal; the iterates agree to 1e-10 of max|u| (sums in another order over
a handful of cycles); the port's true residual meets the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import CoarseSolver as JCoarse
from fpr_tpu.core.config import ExecutionPolicy as JPolicy
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.core.config import Restriction as JRestriction
from fpr_tpu.core.config import Smoother as JSmoother
from fpr_tpu.ops import reductions as jred
from fpr_tpu.ops import transfer as jtransfer
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import (CoarseSolver, ExecutionPolicy, MGConfig, Restriction,
                                       Smoother)
from fpr_tpu_torch.ops import reductions, stencil2d, transfer
from fpr_tpu_torch.solvers import multigrid as tmg


def rhs(n, seed):
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = np.random.default_rng(seed).random((n - 2, n - 2))
    return b


def compare_mg_solve(k, l, coarse, policy, **kw):
    """mg_solve on both sides from zero; returns the cycle count."""
    n = 2**k + 1
    h = 1.0 / (n - 1)
    b = rhs(n, 100 * k + l)
    jcfg = JMG(coarse_size=2**l + 1, coarse_solver=JCoarse(coarse), policy=JPolicy(policy),
               **{k_: v[0] for k_, v in kw.items()})
    tcfg = MGConfig(coarse_size=2**l + 1, coarse_solver=CoarseSolver(coarse),
                    policy=ExecutionPolicy(policy), **{k_: v[1] for k_, v in kw.items()})
    uj, rj, ij = jmg.mg_solve(jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, 1e-6, 20, cfg=jcfg)
    ut, rt, it = tmg.mg_solve(torch.zeros((n, n), dtype=torch.float64), torch.tensor(b), h,
                              0.0, 1e-6, 20, cfg=tcfg)
    assert it == int(ij) < 20
    uj = np.asarray(uj)
    du = np.abs(ut.numpy() - uj).max()
    assert du <= 1e-10 * np.abs(uj).max()
    # the residual moves by at most 8/h^2 times the iterate's difference,
    # plus float64 rounding of its stencil terms
    floor = 64 * np.finfo(np.float64).eps * (np.abs(uj).max() * 4 / h**2 + np.abs(b).max())
    assert abs(float(rt) - float(rj)) <= 8 / h**2 * du + floor
    b64 = torch.tensor(b)
    assert float(stencil2d.rms(stencil2d.residual(ut, b64, h, 0.0))) < \
        1e-6 * float(stencil2d.rms(b64))
    return it


@pytest.mark.parametrize("coarse", ["jacobi", "cg"])
@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("k", [7, 8, 9])
def test_mg_solve_jnp_matches(k, l, coarse):
    compare_mg_solve(k, l, coarse, "jnp")


def test_mg_solve_red_black_gs_full_weighting_matches():
    """Red-black GS (full weighting by AUTO), and Jacobi with explicit full
    weighting."""
    compare_mg_solve(7, 2, "jacobi", "jnp",
                     smoother=(JSmoother.RED_BLACK_GS, Smoother.RED_BLACK_GS))
    compare_mg_solve(7, 2, "jacobi", "jnp",
                     restriction=(JRestriction.FULL_WEIGHTING, Restriction.FULL_WEIGHTING))


def test_mg_solve_helmholtz_bcs_matches(rng):
    """The reference's BC'd Helmholtz iterate path (BCs applied before
    every cycle and in the transfers), on a rectangle."""
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    c = 0.5 / (h * h)
    b, u0 = rng.random((ny, nx)) * c, rng.random((ny, nx))
    uj, rj, ij = jmg.mg_solve(jnp.asarray(u0), jnp.asarray(b), h, c, 1e-8, 40, apply_bcs=True)
    ut, rt, it = tmg.mg_solve(torch.tensor(u0), torch.tensor(b), h, c, 1e-8, 40,
                              apply_bcs=True)
    assert it == int(ij) < 40
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-10 * np.abs(uj).max())


def test_mg_solve_warns_when_unconverged(capfd):
    n = 65
    b = torch.tensor(rhs(n, 3))
    _, _, it = tmg.mg_solve(torch.zeros_like(b), b, 1.0 / 64, 0.0, 1e-12, 2)
    assert it == 2
    assert "WARNING: mg_solve exited at niters=2" in capfd.readouterr().out
    tmg.mg_solve(torch.zeros_like(b), b, 1.0 / 64, 0.0, 1e-3, 20)
    assert "WARNING" not in capfd.readouterr().out


@pytest.mark.parametrize("apply_bcs", [False, True])
def test_restrict_full_weighting_matches(rng, apply_bcs):
    a = rng.standard_normal((33, 129))
    want = np.asarray(jtransfer.restrict_full_weighting(jnp.asarray(a), apply_bcs=apply_bcs))
    got = transfer.restrict_full_weighting(torch.tensor(a), apply_bcs=apply_bcs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_reductions_match(rng):
    a = rng.standard_normal((33, 65))
    for name in ("sumsq", "rms"):
        want = float(getattr(jred, name)(jnp.asarray(a)))
        assert abs(float(getattr(reductions, name)(torch.tensor(a))) - want) <= 1e-13 * want


def test_mg_config_matches_jax():
    for sm in Smoother:
        for rs in Restriction:
            got = MGConfig(smoother=sm, restriction=rs).resolved_restriction()
            want = JMG(smoother=JSmoother(sm.value),
                       restriction=JRestriction(rs.value)).resolved_restriction()
            assert got.value == want.value
    assert [e.value for e in CoarseSolver] == [e.value for e in JCoarse]
    assert MGConfig().policy is ExecutionPolicy.JNP
