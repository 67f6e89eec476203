"""The GSPMD tier of the port (fpr_tpu_torch.solvers.dist_multigrid.
mg_solve_sharded, models.navier_stokes.simulate(mesh=)) on the CPU, against
the port's single device and fpr_tpu's GSPMD tier on the conftest's
8-virtual-device mesh, in float64.

The port runs the single-device operators per row shard, so its fields are
those of its own single-device solve; the norms are sums in another order.
Bounds: equal iteration and step counts; solver fields within 1e-12 of
both, NS fields within the JAX package's own bounds for its sharded NS
case (tests/test_distributed.py:209-214).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu.solvers import dist_multigrid as jdmg
from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig, NSConfig, Smoother
from fpr_tpu_torch.models.navier_stokes import simulate
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.solvers import dist_multigrid as dmg
from fpr_tpu_torch.solvers.multigrid import mg_solve


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: more threads only contend with the other test
    workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return make_mesh((n,), ("y",), device="cpu")


def _rhs(rng, ny, nx, c, bcs):
    b = rng.random((ny, nx)) * (c if c else 1.0)
    if not bcs:
        b[0] = b[-1] = 0.0
        b[:, 0] = b[:, -1] = 0.0
    return b


@pytest.mark.parametrize("ny,nx,ndev,c,bcs,tol,niters", [
    (1025, 1025, 4, 0.0, False, 1e-6, 20),   # three sharded levels
    (513, 1025, 8, 1e4, True, 1e-8, 30),     # the NS T-solve's operator
])
def test_mg_solve_sharded_matches(ny, nx, ndev, c, bcs, tol, niters):
    rng = np.random.default_rng(ny + ndev)
    h = 1.0 / (ny - 1)
    b = _rhs(rng, ny, nx, c, bcs)
    u0 = rng.random((ny, nx)) if bcs else np.zeros((ny, nx))
    uj, _, it_j = jdmg.mg_solve_sharded(jnp.asarray(u0), jnp.asarray(b), h, c, tol, niters,
                                        jmesh((ndev,), ("y",)), apply_bcs=bcs)
    bt, u0t = torch.tensor(b), torch.tensor(u0)
    ud, rd, it_d = dmg.mg_solve_sharded(u0t, bt, h, c, tol, niters, _mesh(ndev), apply_bcs=bcs)
    us, rs, it_s = mg_solve(u0t, bt, h, c, tol, niters, apply_bcs=bcs)
    assert dmg.plan_rows(ny, nx, ndev, MGConfig()).s == (3 if ny == 1025 else 2)
    assert it_d == it_s == int(it_j)
    assert ud.shape == (ny, nx)
    np.testing.assert_allclose(ud.numpy(), us.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ud.numpy(), np.asarray(uj), rtol=0, atol=1e-12)
    assert abs(float(rd) - float(rs)) <= 1e-12 * float(rs)


@pytest.mark.parametrize("ndev,smoother,bcs", [(3, Smoother.JACOBI, True),
                                               (4, Smoother.RED_BLACK_GS, False),
                                               (3, Smoother.RED_BLACK_GS, True)])
def test_mg_solve_sharded_other_smoothers_and_shards(ndev, smoother, bcs):
    """Red-black GS with full weighting, and an odd shard count, against the
    single device: the colours follow the global row."""
    rng = np.random.default_rng(ndev)
    n = 257
    h = 1.0 / (n - 1)
    b = torch.tensor(_rhs(rng, n, n, 5.0 if bcs else 0.0, bcs))
    u0 = torch.tensor(rng.random((n, n))) if bcs else torch.zeros((n, n), dtype=torch.float64)
    cfg = MGConfig(smoother=smoother)
    kw = dict(apply_bcs=bcs, cfg=cfg)
    ud, _, it_d = dmg.mg_solve_sharded(u0, b, h, 5.0, 1e-8, 6, _mesh(ndev), replicate_below=129,
                                       **kw)
    us, _, it_s = mg_solve(u0, b, h, 5.0, 1e-8, 6, **kw)
    assert it_d == it_s
    np.testing.assert_allclose(ud.numpy(), us.numpy(), rtol=0, atol=1e-12)


def test_mg_solve_sharded_below_replicate_is_the_single_device():
    """129 rows: no level reaches replicate_below, JAX replicates them all,
    and the port solves on shard 0's device."""
    rng = np.random.default_rng(7)
    b = torch.tensor(_rhs(rng, 129, 257, 0.0, False))
    z = torch.zeros_like(b)
    assert dmg.plan_rows(129, 257, 4, MGConfig()).s == 0
    ud, rd, it_d = dmg.mg_solve_sharded(z, b, 1 / 128, 0.0, 1e-6, 20, _mesh(4))
    us, rs, it_s = mg_solve(z, b, 1 / 128, 0.0, 1e-6, 20)
    assert it_d == it_s and torch.equal(ud, us) and float(rd) == float(rs)


def test_mg_solve_sharded_takes_row_shards():
    """RowShards in, RowShards out: the sharded NS step's form of the call."""
    rng = np.random.default_rng(9)
    n = 513
    b = torch.tensor(_rhs(rng, n, n, 0.0, False))
    mesh = _mesh(4)
    plan = dmg.plan_rows(n, n, 4, MGConfig())
    z = torch.zeros_like(b)
    out, _, it = dmg.mg_solve_sharded(dmg.RowShards.of(z, plan, mesh),
                                      dmg.RowShards.of(b, plan, mesh), 1 / 512, 0.0, 1e-6, 20,
                                      mesh)
    us, _, it_s = mg_solve(z, b, 1 / 512, 0.0, 1e-6, 20)
    assert isinstance(out, dmg.RowShards) and it == it_s
    np.testing.assert_allclose(out.gather().numpy(), us.numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="do not fit"):
        dmg.mg_solve_sharded(z, dmg.RowShards.of(b, plan, mesh), 1 / 512, 0.0, 1e-6, 20, mesh,
                             replicate_below=129)
    with pytest.raises(ValueError, match="JNP"):
        dmg.mg_solve_sharded(z, b, 1 / 512, 0.0, 1e-6, 20, mesh,
                             cfg=MGConfig(policy=ExecutionPolicy.PALLAS))


NS = dict(ttot=1.0, beta=0.5, Pr=0.1, tol=1e-7, niters=50, mg_solver="direct")


def _close_ns(got, want):
    """tests/test_distributed.py:209-214's bounds."""
    assert got.steps == want.steps
    assert got.sim_time == pytest.approx(want.sim_time, rel=1e-12)
    np.testing.assert_allclose(got.T, want.T, atol=1e-11)
    np.testing.assert_allclose(got.W, want.W, atol=1e-9 * np.abs(want.W).max())
    np.testing.assert_allclose(got.S, want.S, atol=1e-11)


@pytest.mark.parametrize("nx,ny", [(513, 257), (513, 129)])
def test_simulate_mesh_matches(nx, ny):
    """3 semi-implicit steps, W0 given, against the port's single device and
    fpr_tpu's single-device simulate, with fpr_tpu's bounds.  At 513x129
    (fpr_tpu's own case) nothing is sharded, and fpr_tpu's simulate(mesh=)
    is held to the same bounds over the 3 steps.  At 513x257 T, W and S
    are row-sharded; there fpr_tpu's simulate(mesh=) is held to them over
    its first step only: on XLA:CPU its temperature BCs under the sharding
    constraint come out wrong on the rows next to the shard edges (257 rows
    split unevenly over 4 devices), so from the second step on it departs
    from its own single device by O(1) in T."""
    W0 = np.random.default_rng(42).standard_normal((ny, nx)) * 10.0
    cfg, jcfg = NSConfig(nx=nx, ny=ny, **NS), JNS(nx=nx, ny=ny, **NS)
    got = simulate(cfg, W0=W0, max_steps=3, mesh=_mesh(4))
    assert got.steps == 3
    _close_ns(got, simulate(cfg, W0=W0, max_steps=3, device="cpu"))
    _close_ns(got, jns.simulate(jcfg, W0=W0, max_steps=3))
    jsteps = 3 if dmg.plan_rows(ny, nx, 4, MGConfig()).s == 0 else 1
    first = got if jsteps == 3 else simulate(cfg, W0=W0, max_steps=1, mesh=_mesh(4))
    _close_ns(first, jns.simulate(jcfg, W0=W0, max_steps=jsteps, mesh=jmesh((4,), ("y",))))


def test_simulate_mesh_rejects_other_solvers():
    with pytest.raises(ValueError, match="requires mg_solver='direct'"):
        simulate(NSConfig(nx=65, ny=33, mg_solver="mixed"), max_steps=1, mesh=_mesh(2))
