"""The port's row-padded V-cycle tier against fpr_tpu on the CPU: the legs
#6 ``smooth2r_split`` and #7 ``corr_smooth2`` (fpr_tpu_torch.ops.vcycle_legs)
against pallas2d.smooth2r_split_rp / corr_smooth2_rp in interpret mode,
and ``vcycle_rp``, ``mg_solve_rp``, ``mg_solve_mixed`` and the
non-stacked branch of ``mg_solve_ds_rp`` against fpr_tpu.solvers.multigrid.

PALLAS_MIN_AREA is lowered to 65*65 on both sides so that the legs run on
the fine levels of these small grids.

Tolerances: the legs as in tests/test_torch_vcycle_legs.py (XLA:CPU
contracts FMAs, eager PyTorch does not): the iterate to 64 ulps of max|u|,
the residual to 64 ulps of its largest stencil term, the norm 1e-5
relative in float32, 1e-12 in float64.  Solvers: outer counts equal;
float64 iterates within 1e-12 of max|u| (the iterate path) and converged
solutions within the tolerance's reach (1e-6 of max|u|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.core.config import Restriction as JRestriction
from fpr_tpu.core.config import Smoother as JSmoother
from fpr_tpu.ops import pallas2d
from fpr_tpu.ops import transfer as jtransfer
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import MGConfig, Restriction, Smoother
from fpr_tpu_torch.ops import stencil2d, transfer
from fpr_tpu_torch.ops import vcycle_legs as legs
from fpr_tpu_torch.solvers import multigrid as tmg


@pytest.fixture
def legs_on(monkeypatch):
    monkeypatch.setattr(jmg, "PALLAS_MIN_AREA", 65 * 65)
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 65 * 65)


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _layout(rng, shape, dtype):
    ny, nx = shape
    br = pallas2d._pick_br(ny, nx, np.dtype(dtype).itemsize)
    u = rng.standard_normal(shape).astype(dtype)
    f = rng.standard_normal(shape).astype(dtype)
    return br, u, f, pallas2d.pad2d(jnp.asarray(u), br), pallas2d.pad2d(jnp.asarray(f), br)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ns", [1, 3, 6])
@pytest.mark.parametrize("zero_u,elim,c", [(True, False, 0.0), (False, False, 0.7),
                                           (False, True, 900.0), (True, True, 0.0)])
def test_smooth2r_split_matches(rng, dtype, ns, zero_u, elim, c):
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    br, u, f, u_rp, f_rp = _layout(rng, (ny, nx), dtype)
    uj, res_ps = pallas2d.smooth2r_split_rp(u_rp, f_rp, ny, nx, br, h, c, zero_u=zero_u,
                                            ns=ns, elim=elim)
    uj = np.asarray(pallas2d.unpad2d(uj, ny, nx))
    rcj = np.asarray(jtransfer.restrict_ps(res_ps, ny, nx, br))
    ut, rt = legs.smooth2r_split(torch.tensor(u), torch.tensor(f), h, c, zero_u=zero_u,
                                 ns=ns, elim=elim)
    scale = np.abs(uj).max() * (4.0 + c * h * h) / (h * h) + np.abs(f).max()
    assert np.abs(ut.numpy() - uj).max() <= 64 * _eps(dtype) * max(np.abs(uj).max(),
                                                                   np.abs(u).max())
    assert np.abs(transfer.restrict(rt).numpy() - rcj).max() <= 64 * _eps(dtype) * scale
    if elim:
        np.testing.assert_array_equal(ut.numpy()[:, 0], ut.numpy()[:, 1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ns", [1, 3, 6])
@pytest.mark.parametrize("elim,apply_bcs,c", [(False, False, 0.7), (True, True, 900.0),
                                              (False, True, 0.0)])
def test_corr_smooth2_matches(rng, dtype, ns, elim, apply_bcs, c):
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    br, u, f, u_rp, f_rp = _layout(rng, (ny, nx), dtype)
    corr = (rng.standard_normal(((ny - 1) // 2 + 1, (nx - 1) // 2 + 1)) * 1e-2).astype(dtype)
    uj, rj = pallas2d.corr_smooth2_rp(u_rp, f_rp, jnp.asarray(corr), ny, nx, br, h, c,
                                      apply_bcs=apply_bcs, with_norm=True, ns=ns, elim=elim)
    uj = np.asarray(pallas2d.unpad2d(uj, ny, nx))
    ut, rt = legs.corr_smooth2(torch.tensor(u), torch.tensor(f), torch.tensor(corr), h, c,
                               apply_bcs=apply_bcs, with_norm=True, ns=ns, elim=elim)
    assert np.abs(ut.numpy() - uj).max() <= 64 * _eps(dtype) * np.abs(uj).max()
    rel = 1e-5 if dtype == np.float32 else 1e-12
    assert abs(float(rt) - float(rj)) <= rel * float(rj)
    _, none = legs.corr_smooth2(torch.tensor(u), torch.tensor(f), torch.tensor(corr), h, c,
                                ns=ns)
    assert none is None


def test_legs_check_their_arguments():
    f = torch.zeros((9, 9))
    with pytest.raises(ValueError, match="ns must be"):
        legs.smooth2r_split(None, f, 0.125, 0.0, zero_u=True, ns=7)
    with pytest.raises(ValueError, match="does not fit"):
        legs.corr_smooth2(f, f, torch.zeros((4, 5)), 0.125, 0.0)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        legs._smooth2r_split_cuda(None, f, 0.125, 0.0)


def _cfgs(**kw):
    jkw = {k: v for k, v in kw.items() if k not in ("smoother", "restriction")}
    tkw = dict(jkw)
    if "smoother" in kw:
        jkw["smoother"], tkw["smoother"] = JSmoother(kw["smoother"]), Smoother(kw["smoother"])
    if "restriction" in kw:
        jkw["restriction"] = JRestriction(kw["restriction"])
        tkw["restriction"] = Restriction(kw["restriction"])
    return JMG(**jkw), MGConfig(**tkw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cfg_kw", [
    dict(coarse_size=17),  # the fused legs
    dict(coarse_size=17, restriction="full_weighting"),  # #5 sweeps, full weighting
    dict(coarse_size=17, pre_smooth=0, post_smooth=7),  # #5 sweeps, injection
    dict(coarse_size=17, smoother="red_black_gs"),  # the plain subtree at every level
], ids=["legs", "fw", "unfused", "rbgs"])
def test_vcycle_rp_matches_jax(rng, legs_on, cfg_kw, dtype):
    """Two cycles in float64 to 1e-12 of max|u|; in float32 the first cycle
    to 1e-5 (the coarse Jacobi solve's early exit at the float32 floor
    amplifies rounding differences in later cycles)."""
    n = 129
    h = 1.0 / (n - 1)
    jcfg, tcfg = _cfgs(**cfg_kw)
    f = rng.standard_normal((n, n)).astype(dtype)
    br = pallas2d._pick_br(n, n, np.dtype(dtype).itemsize)
    f_rp = pallas2d.pad2d(jnp.asarray(f), br)
    u_rp = jnp.zeros_like(f_rp)
    ut = None
    f64 = dtype == np.float64
    for cyc in range(2 if f64 else 1):
        u_rp, rj = jmg.vcycle_rp(u_rp, f_rp, n, n, h, 0.0, 1e-7, jcfg,
                                 assume_zero_u=(cyc == 0))
        ut, rt = tmg.vcycle_rp(ut, torch.tensor(f), h, 0.0, 1e-7, tcfg,
                               assume_zero_u=(cyc == 0))
        u = np.asarray(pallas2d.unpad2d(u_rp, n, n))
        du = np.abs(ut.numpy() - u).max()
        assert du <= (1e-12 if f64 else 1e-5) * np.abs(u).max()
        floor = 64 * _eps(dtype) * (np.abs(u).max() * 4 / h**2 + np.abs(f).max())
        assert abs(float(rt) - float(rj)) <= 8 / h**2 * du + floor


def _manufactured(n, h, rng):
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    return b


def test_mg_solve_rp_matches(rng, legs_on):
    """The iterate path, Poisson and the reference's BC'd Helmholtz solve
    (no eliminated BCs), in float64."""
    n = 129
    h = 1.0 / (n - 1)
    b = _manufactured(n, h, rng)
    uj, rj, ij = jmg.mg_solve_rp(jnp.zeros((n, n)), jnp.asarray(b), h, 0.0, 1e-8, 30)
    ut, rt, it = tmg.mg_solve_rp(torch.zeros((n, n), dtype=torch.float64), torch.tensor(b),
                                 h, 0.0, 1e-8, 30)
    assert it == int(ij)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-12 * np.abs(uj).max())
    ny, nx = 65, 257
    h = 1.0 / (ny - 1)
    b = rng.random((ny, nx))
    uj, _, ij = jmg.mg_solve_rp(jnp.zeros((ny, nx)), jnp.asarray(b), h, 50.0, 1e-8, 12,
                                apply_bcs=True)
    ut, _, it = tmg.mg_solve_rp(torch.zeros((ny, nx), dtype=torch.float64),
                                torch.tensor(b), h, 50.0, 1e-8, 12, apply_bcs=True)
    assert it == int(ij)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-12 * np.abs(uj).max())


@pytest.mark.parametrize("case", ["poisson", "helmholtz_bcs", "inner2"])
def test_mg_solve_mixed_outer_counts_match(rng, legs_on, case):
    """float64 defect around float32 V-cycles: equal outer counts.  The
    Helmholtz case is the NS temperature solve (c h^2 = 0.5, apply_bcs,
    warm start; eliminated BCs in the correction cycles)."""
    if case == "helmholtz_bcs":
        ny, nx = 65, 257
        h = 1.0 / (ny - 1)
        c, tol, apply_bcs = 0.5 / (h * h), 1e-8, True
        b = rng.random((ny, nx)) * c
        u0 = rng.random((ny, nx))
    else:
        ny = nx = 129
        h = 1.0 / (ny - 1)
        c, tol, apply_bcs = 0.0, 1e-8, False
        b = _manufactured(ny, h, rng)
        u0 = np.zeros((ny, nx))
    ic = 2 if case == "inner2" else 1
    uj, rj, ij = jmg.mg_solve_mixed(jnp.asarray(u0), jnp.asarray(b), h, c, tol, 40,
                                    apply_bcs=apply_bcs, inner_cycles=ic)
    ut, rt, it = tmg.mg_solve_mixed(torch.tensor(u0), torch.tensor(b), h, c, tol, 40,
                                    apply_bcs=apply_bcs, inner_cycles=ic)
    assert it == int(ij) < 40
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-6 * np.abs(uj).max())
    if not apply_bcs:
        # the exit tests an estimate; the true defect stays near it
        b64 = torch.tensor(b)
        true = float(stencil2d.rms(stencil2d.residual(ut, b64, h, c)))
        assert true <= 2 * tol * float(stencil2d.rms(b64))


@pytest.mark.parametrize("cfg_kw", [
    dict(coarse_size=17, restriction="full_weighting"),
    dict(coarse_size=17, pre_smooth=7, post_smooth=7),
    dict(coarse_size=17, smoother="red_black_gs"),
], ids=["fw", "deep", "rbgs"])
def test_mg_solve_ds_non_stacked_branch_matches(rng, legs_on, cfg_kw):
    """Configurations outside the fused legs run vcycle_rp around the ds
    defect pass (multigrid.py:883-897)."""
    n = 129
    h = 1.0 / (n - 1)
    jcfg, tcfg = _cfgs(**cfg_kw)
    assert not tmg._stk_eligible(tcfg)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    (jh, jl), rj, ij = jmg.mg_solve_ds(None, jnp.asarray(b), h, 0.0, 1e-6, 30, cfg=jcfg,
                                       return_pair=True)
    (th, tl), rt, it = tmg.mg_solve_ds(None, torch.tensor(b), h, 0.0, 1e-6, 30, cfg=tcfg,
                                       return_pair=True)
    assert it == int(ij)
    uj = np.asarray(jh, np.float64) + np.asarray(jl)
    ut = th.double() + tl.double()
    assert np.abs(ut.numpy() - uj).max() <= 1e-6 * np.abs(uj).max()
    b64 = torch.tensor(b).double()
    assert float(stencil2d.rms(stencil2d.residual(ut, b64, h, 0.0))) <= \
        1e-6 * float(stencil2d.rms(b64))


def test_mg_solve_ds_non_stacked_helmholtz_bcs(rng, legs_on):
    """The non-stacked branch with apply_bcs (eliminated BCs in the
    correction cycles) and a warm start."""
    n = 129
    h = 1.0 / (n - 1)
    c = 0.5 / (h * h)
    jcfg, tcfg = _cfgs(coarse_size=17, restriction="full_weighting")
    b = rng.random((n, n)) * c
    u0 = rng.random((n, n))
    uj, rj, ij = jmg.mg_solve_ds(jnp.asarray(u0), jnp.asarray(b), h, c, 1e-8, 50,
                                 cfg=jcfg, apply_bcs=True)
    ut, rt, it = tmg.mg_solve_ds(torch.tensor(u0), torch.tensor(b), h, c, 1e-8, 50,
                                 cfg=tcfg, apply_bcs=True)
    assert it == int(ij) < 50
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                               atol=1e-9 * np.abs(uj).max())
