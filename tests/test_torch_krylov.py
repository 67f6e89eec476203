"""The port's Krylov solvers (fpr_tpu_torch.solvers.krylov: cg,
mg_preconditioned_cg, mg_pcg_ds) against fpr_tpu.solvers.krylov on the CPU
on the same numpy-seeded right-hand sides.

The PALLAS policy runs the stencil-pass kernel #5's matvec (its plain
version here; the Pallas kernel in interpret mode on the JAX side).
Bars: equal iteration counts everywhere.  cg and mg_preconditioned_cg run
in float64; their iterates agree to 1e-9 of max|x| (the recurrences
amplify sums taken in another order, but stay far inside the tolerance).
mg_pcg_ds runs its float32 preconditioner on both sides (XLA:CPU contracts
FMAs in jit, eager PyTorch does not), so its iterates agree to the
solve's own tolerance, 1e-6 of max|u|, and the port's true float64
residual must meet it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import CoarseSolver as JCoarse
from fpr_tpu.core.config import ExecutionPolicy as JPolicy
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.core.config import Restriction as JRestriction
from fpr_tpu.solvers import krylov as jkry
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import CoarseSolver, ExecutionPolicy, MGConfig, Restriction
from fpr_tpu_torch.ops import stencil2d
from fpr_tpu_torch.solvers import krylov as tkry
from fpr_tpu_torch.solvers import multigrid as tmg


def rhs(n, seed, dtype=np.float64):
    b = np.zeros((n, n), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(seed).random((n - 2, n - 2))
    return b


@pytest.mark.parametrize("policy", ["jnp", "pallas"])
@pytest.mark.parametrize("c", [0.0, 50.0])
def test_cg_matches(policy, c):
    n = 33
    h = 1.0 / (n - 1)
    b = rhs(n, 3)
    xj, rj, ij = jkry.cg(jnp.asarray(b), h, h, c, 1e-8, 500, policy=JPolicy(policy))
    xt, rt, it = tkry.cg(torch.tensor(b), h, h, c, 1e-8, 500, policy=ExecutionPolicy(policy))
    assert it == int(ij) < 500
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-9 * np.abs(xj).max()
    assert abs(float(rt) - float(rj)) <= 1e-3 * float(rj)


@pytest.mark.parametrize("policy,coarse", [("jnp", "jacobi"), ("pallas", "jacobi"),
                                           ("pallas", "cg")])
def test_mg_preconditioned_cg_matches(policy, coarse):
    n = 65
    h = 1.0 / (n - 1)
    b = rhs(n, 5)
    jcfg = JMG(coarse_size=5, coarse_solver=JCoarse(coarse), policy=JPolicy(policy))
    tcfg = MGConfig(coarse_size=5, coarse_solver=CoarseSolver(coarse),
                    policy=ExecutionPolicy(policy))
    xj, rj, ij = jkry.mg_preconditioned_cg(jnp.asarray(b), h, 0.0, 1e-8, 30, mg_cfg=jcfg)
    xt, rt, it = tkry.mg_preconditioned_cg(torch.tensor(b), h, 0.0, 1e-8, 30, mg_cfg=tcfg)
    assert it == int(ij) < 30
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-9 * np.abs(xj).max()


@pytest.fixture
def legs_on(monkeypatch):
    """The fused legs on the fine levels of these small grids."""
    monkeypatch.setattr(jmg, "PALLAS_MIN_AREA", 65 * 65)
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 65 * 65)


@pytest.mark.parametrize("dots", ["rowsum64", "kernel"])
@pytest.mark.parametrize("case", ["stk_f32", "stk_f64_helmholtz", "rp_full_weighting"])
def test_mg_pcg_ds_matches(legs_on, dots, case):
    """The stacked preconditioner (fused legs K2/K3) on a float32 and a
    float64 rhs, and the vcycle_rp preconditioner outside their
    configuration (full weighting: #5 sweeps around the residual)."""
    n = 129
    h = 1.0 / (n - 1)
    dtype = np.float32 if case == "stk_f32" else np.float64
    c = 20.0 if case == "stk_f64_helmholtz" else 0.0
    b = rhs(n, 11, dtype)
    kw = dict(coarse_size=17)
    jcfg, tcfg = JMG(**kw), MGConfig(**kw)
    if case == "rp_full_weighting":
        jcfg = JMG(**kw, restriction=JRestriction.FULL_WEIGHTING)
        tcfg = MGConfig(**kw, restriction=Restriction.FULL_WEIGHTING)
        assert not tmg._stk_eligible(tcfg)
    (jh, jl), rj, ij = jkry.mg_pcg_ds(jnp.asarray(b), h, c, 1e-6, 30, cfg=jcfg, dots=dots,
                                      return_pair=True)
    (th, tl), rt, it = tkry.mg_pcg_ds(torch.tensor(b), h, c, 1e-6, 30, cfg=tcfg, dots=dots,
                                      return_pair=True)
    assert it == int(ij) < 30
    uj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    ut = th.double() + tl.double()
    assert np.abs(ut.numpy() - uj).max() <= 1e-6 * np.abs(uj).max()
    b64 = torch.tensor(b).double()
    true = float(stencil2d.rms(stencil2d.residual(ut, b64, h, c)))
    assert true <= 1e-6 * float(stencil2d.rms(b64))


def test_mg_pcg_ds_pair_and_arguments():
    n = 33
    b = torch.tensor(rhs(n, 2, np.float32))
    (hi, lo), r, it = tkry.mg_pcg_ds(b, 1.0 / 32, 0.0, 1e-5, 20, return_pair=True)
    assert hi.dtype == lo.dtype == torch.float32 and 0 < it < 20
    u, r2, it2 = tkry.mg_pcg_ds(b.double(), 1.0 / 32, 0.0, 1e-5, 20)
    assert u.dtype == r2.dtype == torch.float64 and it2 == it
    with pytest.raises(ValueError, match="dots"):
        tkry.mg_pcg_ds(b, 1.0 / 32, 0.0, 1e-5, 20, dots="flat")


EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("n", [129, 257])
def test_mg_pcg_ds_iterations_keep_their_invariants(legs_on, n):
    """Every iteration of mg_pcg_ds (``_mg_pcg_ds_history``, the solve's own
    step one at a time): z = M r is zero on the boundary ring, which the
    gradient form of the curvature assumes; that curvature equals the
    float64 sum p.(A p) of the same float32 p within n EPS32 (each row
    summed in float32: n same-sign terms); s1 = z.r and p.Ap are negative
    (A and the V-cycle are negative definite in this sign convention), so
    the step length is positive.  The last iterate is the solve's, bitwise,
    and JAX's mg_pcg_ds on the same seed takes as many iterations to the
    same u within the solve's tolerance."""
    h = 1.0 / (n - 1)
    b = rhs(n, 11, np.float32)
    cfg = MGConfig(coarse_size=17)
    history = list(tkry._mg_pcg_ds_history(torch.tensor(b), h, 0.0, 1e-6, 30, cfg))
    for s, d in history:
        z, p = d["z"], s["p"].double()
        assert not torch.cat([z[0], z[-1], z[:, 0], z[:, -1]]).any()
        want = float(torch.sum(p * stencil2d.matvec(p, h, h, 0.0)))
        assert abs(float(d["pAp"]) - want) <= n * EPS32 * abs(want)
        assert float(d["s1"]) < 0 and float(d["pAp"]) < 0 and float(d["alpha"]) > 0
    (th, tl), rt, it = tkry.mg_pcg_ds(torch.tensor(b), h, 0.0, 1e-6, 30, cfg=cfg,
                                      return_pair=True)
    last = history[-1][0]
    assert len(history) == it < 30
    assert torch.equal(last["u"][0], th) and torch.equal(last["u"][1], tl)
    assert torch.equal(last["r_rms"], rt)
    (jh, jl), _, ij = jkry.mg_pcg_ds(jnp.asarray(b), h, 0.0, 1e-6, 30, cfg=JMG(coarse_size=17),
                                     return_pair=True)
    assert int(ij) == it
    uj = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    ut = th.double() + tl.double()
    assert np.abs(ut.numpy() - uj).max() <= 1e-6 * np.abs(uj).max()
