"""The row-sharded ds multigrid (fpr_tpu_torch.solvers.dist_mg_ds) and the
row hooks of K1, #6, #7 and K4 on the CPU, where the kernels' plain
versions run.

- The hooks: each kernel on hand-built shard windows (G ghost rows of the
  neighbours on each side, zeros past the grid, a dead tail on the last
  shard) reproduces the owned rows of its call on the whole grid bitwise,
  the port's form of tests/test_dist_mg.py:17-59.  Sums over the owned
  rows add up to the global sum within float32 reordering (1e-5
  relative), maxima exactly.
- The solver against fpr_tpu's sharded solver on the conftest's
  8-virtual-device mesh, equal shard counts: outer counts equal, u within
  1e-6 of max|u| (tests/test_dist_mg.py's bound against the single device).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import CoarseSolver as JCoarse
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu.solvers import dist_mg_ds as jdist
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.ops import ds, transfer
from fpr_tpu_torch.ops.ns_fused import ns_fused_rp
from fpr_tpu_torch.ops.rows import Rows
from fpr_tpu_torch.ops.vcycle_legs import corr_smooth2, corr_smooth2_raw, smooth2r_split
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.solvers import dist_mg_ds

NY, NX, NY_L, NDEV = 97, 129, 64, 2
G = dist_mg_ds.G
H = 1.0 / 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the per-shard tensors are small, and more
    threads only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _window(a, d):
    """Shard d's local rows of a global (..., NY, NX) tensor."""
    ap = torch.nn.functional.pad(a, (0, 0, G, NDEV * NY_L + G - NY))
    return ap[..., d * NY_L:d * NY_L + NY_L + 2 * G, :].contiguous()


def _rows(d):
    return Rows(d * NY_L - G, NY, (G, G + NY_L))


def _owned_equal(local, glob, d):
    n = min(NY_L, NY - d * NY_L)
    torch.testing.assert_close(local[..., G:G + n, :], glob[..., d * NY_L:d * NY_L + n, :],
                               rtol=0, atol=0)


def _close(parts, want, rel=1e-5):
    got = sum(float(p) for p in parts)
    assert abs(got - float(want)) <= rel * max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("flags", [dict(), dict(apply_bcs=True), dict(velocity_max=True),
                                   dict(field_sumsq=True, velocity_max=True)])
@pytest.mark.parametrize("c", [0.0, "tensor"])
def test_defect_row_hooks(rng, flags, c):
    c = torch.tensor(64.0) if c == "tensor" else c
    u64 = rng.standard_normal((NY, NX))
    u = torch.stack([_t(u64), _t(u64 - np.float32(u64))])
    f, e = _t(rng.standard_normal((1, NY, NX))), _t(rng.standard_normal((NY, NX)) * 1e-3)
    want = ds.defect_pass(u, f, e, 1.0, H, c, raw_sumsq=True, **flags)
    parts = []
    for d in range(NDEV):
        got = ds.defect_pass(_window(u, d), _window(f, d), _window(e, d), 1.0, H, c,
                             rows=_rows(d), raw_sumsq=True, **flags)
        _owned_equal(got[0], want[0], d)
        _owned_equal(got[1], want[1], d)
        parts.append(got)
    _close([p[2] for p in parts], want[2])
    if flags.get("velocity_max"):
        for k in (0, 1):
            assert max(float(p[3][k]) for p in parts) == float(want[3][k])
    if flags.get("field_sumsq"):
        _close([p[3][2] for p in parts], want[3][2])


@pytest.mark.parametrize("ns,elim,zero_u", [(1, False, True), (3, True, False), (6, False, False),
                                            (2, True, True)])
def test_smooth2r_split_row_hooks(rng, ns, elim, zero_u):
    u, f = _t(rng.standard_normal((NY, NX))), _t(rng.standard_normal((NY, NX)))
    c = torch.tensor(41.25)
    want = smooth2r_split(u, f, H, c, zero_u=zero_u, ns=ns, elim=elim)
    for d in range(NDEV):
        got = smooth2r_split(_window(u, d), _window(f, d), H, c, zero_u=zero_u, ns=ns,
                             elim=elim, rows=_rows(d))
        _owned_equal(got[0], want[0], d)
        _owned_equal(got[1], want[1], d)


@pytest.mark.parametrize("ns,elim", [(2, False), (5, True)])
def test_corr_smooth2_raw_row_hooks(rng, ns, elim):
    u, f = _t(rng.standard_normal((NY, NX))), _t(rng.standard_normal((NY, NX)))
    coarse = _t(rng.standard_normal(((NY - 1) // 2 + 1, (NX - 1) // 2 + 1)) * 1e-2)
    c = torch.tensor(0.0)
    want, _ = corr_smooth2(u, f, coarse, H, c, apply_bcs=elim, ns=ns, elim=elim)
    corrx = transfer.x_interleave_coarse(coarse, apply_bcs=elim)
    padded = torch.nn.functional.pad(corrx, (0, 0, G // 2, NDEV * NY_L // 2 + G))
    for d in range(NDEV):
        start = d * NY_L // 2
        win = padded[start:start + (NY_L + 2 * G) // 2 + 1]
        got, _ = corr_smooth2_raw(_window(u, d), _window(f, d), win, H, c, ns=ns, elim=elim,
                                  rows=_rows(d))
        _owned_equal(got, want, d)
    with pytest.raises(ValueError, match="must be even"):
        corr_smooth2_raw(u, f, corrx, H, c, rows=Rows(-7, NY, (0, NY)))


@pytest.mark.parametrize("mode,beta", [("explicit", 0.0), ("rhs", 0.5), ("rhs", 1.0)])
def test_ns_fused_row_hooks(rng, mode, beta):
    TW = torch.stack([_t(rng.standard_normal((NY, NX)) * 0.3 + 0.5),
                      _t(rng.standard_normal((NY, NX)) * 10.0)])
    S = _t(rng.standard_normal((NY, NX)) * 0.1)
    dt, cT = torch.tensor(1.9e-6), torch.tensor(41.25)
    kw = dict(k=1.0, beta=beta, mode=mode, with_sumsq=True)
    if mode == "rhs":
        kw.update(cT=cT, cW=cT * 100.0)
    want, (t2, w2) = ns_fused_rp(TW, S, dt, H, 0.01, 1e6, **kw)
    parts = []
    for d in range(NDEV):
        got, sums = ns_fused_rp(_window(TW, d), _window(S, d), dt, H, 0.01, 1e6,
                                rows=_rows(d), **kw)
        _owned_equal(got, want, d)
        # the global grid's Dirichlet rows and the dead tail
        assert not got[:, :G][:, :max(0, -_rows(d).off)].any()
        parts.append(sums)
    _close([p[0] for p in parts], t2)
    _close([p[1] for p in parts], w2)


@pytest.mark.parametrize("ny,ndev,rep", [(257, 4, 129), (1025, 8, 513), (2049, 4, 1025),
                                         (2049, 8, 513)])
def test_plan_matches_jax(ny, ndev, rep):
    cfg = dict(coarse_size=65, coarse_solver=JCoarse.DST)
    want = jdist.plan_shards(ny, ny, ndev, JMG(**cfg), rep)
    got = dist_mg_ds.plan_shards(ny, ny, ndev, MGConfig(coarse_size=65,
                                                        coarse_solver=CoarseSolver.DST), rep)
    assert (got.s, got.ny_l, got.ndev) == (want.s, want.ny_l, want.ndev)


@pytest.mark.parametrize("n,ndev,rep,c,bcs", [
    (257, 4, 129, 0.0, False),
    (257, 8, 129, 64.0, True),
    (1025, 8, 513, 64.0, False),
])
def test_mg_solve_ds_sharded_matches_jax(n, ndev, rep, c, bcs):
    """257^2 and 1025^2, 4 and 8 shards, c 0 and 64, with and without the
    NS temperature BCs (each case compiles JAX's solver anew, which is most
    of the time).  The apply_bcs solve runs 3 outers: at tol 1e-6 both
    packages stop at niters on this rhs, the known cold-BC case; the others
    converge."""
    rng = np.random.default_rng(n + ndev)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    h, tol, niters = 1.0 / (n - 1), 1e-6, (3 if bcs else 20)
    coarse = min(129, (n - 1) // 4 + 1)
    (hj, lj), _, it_j = jdist.mg_solve_ds_sharded(
        jnp.asarray(b), h, c, tol, niters, jmesh((ndev,), ("y",)),
        cfg=JMG(coarse_size=coarse, coarse_solver=JCoarse.DST), replicate_below=rep,
        apply_bcs=bcs)
    (ht, lt), r_t, it_t = dist_mg_ds.mg_solve_ds_sharded(
        torch.tensor(b), h, c, tol, niters, make_mesh((ndev,), ("y",), device="cpu"),
        cfg=MGConfig(coarse_size=coarse, coarse_solver=CoarseSolver.DST),
        replicate_below=rep, apply_bcs=bcs)
    assert it_t == int(it_j)
    u_j = np.asarray(hj, np.float64) + np.asarray(lj, np.float64)
    u_t = ht.double().numpy() + lt.double().numpy()
    assert u_t.shape == (n, n)
    assert np.abs(u_t - u_j).max() / np.abs(u_j).max() < 1e-6
    if bcs:
        np.testing.assert_allclose(u_t[0], 1.0, atol=1e-6)
        np.testing.assert_allclose(u_t[-1], 0.0, atol=1e-6)
        np.testing.assert_allclose(u_t[:, 0], u_t[:, 1], atol=1e-6)
    else:
        assert it_t < niters


def test_sharded_solver_rejects_small_grids():
    mesh = make_mesh((8,), ("y",), device="cpu")
    with pytest.raises(ValueError, match="too small"):
        dist_mg_ds.mg_solve_ds_sharded(torch.zeros((129, 129)), 1 / 128.0, 0.0, 1e-6, 20, mesh)
    with pytest.raises(ValueError, match="exactly-f32"):
        dist_mg_ds.mg_solve_ds_sharded(torch.zeros((1025, 1025), dtype=torch.float64),
                                       1 / 1024.0, 0.0, 1e-6, 20, mesh)


def test_gather_result_off_returns_the_shard_pairs():
    n = 257
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(5).random((n - 2, n - 2))
    mesh = make_mesh((4,), ("y",), device="cpu")
    kw = dict(cfg=MGConfig(coarse_size=65, coarse_solver=CoarseSolver.DST), replicate_below=129)
    (hi, lo), r, it = dist_mg_ds.mg_solve_ds_sharded(torch.tensor(b), 1 / 256, 0.0, 1e-6, 20,
                                                     mesh, **kw)
    pairs, r2, it2 = dist_mg_ds.mg_solve_ds_sharded(torch.tensor(b), 1 / 256, 0.0, 1e-6, 20,
                                                    mesh, gather_result=False, **kw)
    plan = dist_mg_ds.plan_shards(n, n, 4, kw["cfg"], 129)
    assert it2 == it and float(r2) == float(r) and len(pairs) == 4
    assert pairs[0].shape == (2, plan.ny_l + 2 * G, n)
    u = dist_mg_ds.gather_rows(pairs, plan)
    torch.testing.assert_close(u[0], hi, rtol=0, atol=0)
    torch.testing.assert_close(u[1], lo, rtol=0, atol=0)
