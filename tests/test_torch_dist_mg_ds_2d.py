"""The 2D (y, x) mesh ds multigrid (fpr_tpu_torch.solvers.dist_mg_ds:
plan_shards_2d, mg_solve_ds_sharded_2d) and the column hooks of K1, #6 and
#7 on the CPU, where the kernels' plain versions run.

- The plan equals fpr_tpu's plan_shards_2d (s, ny_l, nx_l), rejections
  included.
- The hooks: each kernel on the four windows of a 2x2 split (G ghost rows
  and GX ghost columns filled from the whole grid, zeros past it, a dead
  tail on the last row and column of shards) reproduces the owned cells of
  its call on the whole grid bitwise.  Sums over the owned cells add up to
  the whole grid's within float32 reordering (1e-6 relative), maxima
  exactly.  The whole grid's K1 is held against fpr_tpu's defect_pass in
  interpret mode on the physical cells.
- The solver against fpr_tpu's mg_solve_ds_sharded_2d on the conftest's
  8-virtual-device mesh and against the port's single-device mg_solve_ds:
  outer counts equal, u within 1e-6 of max|u| and the true float64
  residual below 2 tol (tests/test_dist_mg.py's bounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import CoarseSolver as JCoarse
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.ops import ds as jds
from fpr_tpu.ops import pallas2d
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu.solvers import dist_mg_ds as jdist
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.ops import ds, stencil2d, transfer
from fpr_tpu_torch.ops.rows import Cols, Rows
from fpr_tpu_torch.ops.vcycle_legs import corr_smooth2, corr_smooth2_raw, smooth2r_split
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.solvers import dist_mg_ds
from fpr_tpu_torch.solvers.multigrid import mg_solve_ds

NY, NX, NY_L, NX_L = 97, 129, 64, 80   # a 2x2 split with a dead tail on both axes
G, GX = dist_mg_ds.G, dist_mg_ds.GX
H = 1.0 / 64
SPLIT = [(dy, dx) for dy in range(2) for dx in range(2)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _window(a, dy, dx):
    """Shard (dy, dx)'s local cells of a global (..., NY, NX) tensor."""
    ap = torch.nn.functional.pad(a, (GX, 2 * NX_L + GX - NX, G, 2 * NY_L + G - NY))
    return ap[..., dy * NY_L:dy * NY_L + NY_L + 2 * G,
              dx * NX_L:dx * NX_L + NX_L + 2 * GX].contiguous()


def _hooks(dy, dx):
    return dict(rows=Rows(dy * NY_L - G, NY, (G, G + NY_L)),
                cols=Cols(dx * NX_L - GX, NX, (GX, GX + NX_L)))


def _owned_equal(local, glob, dy, dx):
    ny, nx = min(NY_L, NY - dy * NY_L), min(NX_L, NX - dx * NX_L)
    torch.testing.assert_close(
        local[..., G:G + ny, GX:GX + nx],
        glob[..., dy * NY_L:dy * NY_L + ny, dx * NX_L:dx * NX_L + nx], rtol=0, atol=0)


def _close(parts, want, rel=1e-6):
    got = sum(float(p) for p in parts)
    assert abs(got - float(want)) <= rel * max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("ny,nx,shape,rep", [
    (513, 513, (2, 2), 257), (1025, 1025, (4, 2), 257), (1025, 1025, (2, 4), 513),
    (2049, 2049, (2, 2), 513), (4097, 4097, (2, 2), 1025), (4097, 4097, (1, 4), 1025),
    (1025, 2049, (2, 4), 257), (2049, 1025, (8, 1), 513),
])
def test_plan_2d_matches_jax(ny, nx, shape, rep):
    kw = dict(coarse_size=129)
    want = jdist.plan_shards_2d(ny, nx, *shape, JMG(coarse_solver=JCoarse.DST, **kw), rep)
    got = dist_mg_ds.plan_shards_2d(ny, nx, *shape,
                                    MGConfig(coarse_solver=CoarseSolver.DST, **kw), rep)
    assert (got.s, got.ny_l, got.nx_l) == (want.s, want.ny_l, want.nx_l)
    for m in range(got.s):
        for dy in range(shape[0]):
            for dx in range(shape[1]):
                hk = got.hooks(m, dy, dx)
                assert hk["rows"].off % 2 == 0 and hk["cols"].off % 2 == 0


def test_plan_2d_rejects_narrow_columns():
    """8 column shards of a 1025-wide grid leave < 256 columns a shard
    (tests/test_dist_mg.py:154-161), in both packages."""
    with pytest.raises(ValueError, match="too small to 2D-shard"):
        jdist.plan_shards_2d(1025, 1025, 1, 8, JMG(), 513)
    with pytest.raises(ValueError, match="too small to 2D-shard"):
        dist_mg_ds.plan_shards_2d(1025, 1025, 1, 8, MGConfig(), 513)
    mesh = make_mesh((1, 8), ("y", "x"), device="cpu")
    with pytest.raises(ValueError, match="too small to 2D-shard"):
        dist_mg_ds.mg_solve_ds_sharded_2d(torch.zeros((1025, 1025)), 1 / 1024.0, 0.0, 1e-6,
                                          20, mesh, replicate_below=513)


def _ds_inputs(rng):
    u64 = rng.standard_normal((NY, NX))
    u = torch.stack([_t(u64), _t(u64 - np.float32(u64))])
    return u, _t(rng.standard_normal((1, NY, NX))), _t(rng.standard_normal((NY, NX)) * 1e-3)


@pytest.mark.parametrize("flags", [dict(), dict(velocity_max=True),
                                   dict(field_sumsq=True, velocity_max=True)])
@pytest.mark.parametrize("c", [0.0, "tensor"])
def test_defect_col_hooks(rng, flags, c):
    c = torch.tensor(64.0) if c == "tensor" else c
    u, f, e = _ds_inputs(rng)
    want = ds.defect_pass(u, f, e, 1.0, H, c, raw_sumsq=True, **flags)
    parts = []
    for dy, dx in SPLIT:
        got = ds.defect_pass(_window(u, dy, dx), _window(f, dy, dx), _window(e, dy, dx), 1.0,
                             H, c, raw_sumsq=True, **_hooks(dy, dx), **flags)
        _owned_equal(got[0], want[0], dy, dx)
        _owned_equal(got[1], want[1], dy, dx)
        parts.append(got)
    _close([p[2] for p in parts], want[2])
    if flags.get("velocity_max"):
        for k in (0, 1):
            assert max(float(p[3][k]) for p in parts) == float(want[3][k])
    if flags.get("field_sumsq"):
        _close([p[3][2] for p in parts], want[3][2])


@pytest.mark.parametrize("c", [0.0, 41.25])
def test_defect_whole_grid_matches_jax(rng, c):
    """The whole grid's K1 (the reference of the windows above) against
    fpr_tpu's defect_pass in interpret mode: u' and r bitwise on the
    physical cells, the sum within 1e-6."""
    u, f, e = _ds_inputs(rng)
    c_t = c if c == 0.0 else torch.tensor(np.float32(c))
    u2, r2, rr2 = ds.defect_pass(u, f, e, 1.0, H, c_t, raw_sumsq=True)
    br = pallas2d._pick_br(NY, NX, 4)
    pad = lambda a: pallas2d.pad2d(jnp.asarray(a.numpy()), br)  # noqa: E731
    unp = lambda a: np.asarray(pallas2d.unpad2d(a, NY, NX))  # noqa: E731
    c_j = c if c == 0.0 else jnp.float32(c)
    uj, rj, rrj = jds.defect_pass(jnp.stack([pad(u[0]), pad(u[1])]), pad(f[0])[None], pad(e),
                                  1.0, NY, NX, br, H, c_j, raw_sumsq=True)
    np.testing.assert_array_equal(u2[0].numpy(), unp(uj[0]))
    np.testing.assert_array_equal(u2[1].numpy(), unp(uj[1]))
    np.testing.assert_array_equal(r2.numpy(), unp(rj))
    _close([rr2], float(rrj))


@pytest.mark.parametrize("ns", [1, 3, 6])
@pytest.mark.parametrize("zero_u", [True, False])
def test_smooth2r_split_col_hooks(rng, ns, zero_u):
    u, f = _t(rng.standard_normal((NY, NX))), _t(rng.standard_normal((NY, NX)))
    c = torch.tensor(41.25)
    want = smooth2r_split(u, f, H, c, zero_u=zero_u, ns=ns)
    for dy, dx in SPLIT:
        got = smooth2r_split(_window(u, dy, dx), _window(f, dy, dx), H, c, zero_u=zero_u,
                             ns=ns, **_hooks(dy, dx))
        _owned_equal(got[0], want[0], dy, dx)
        _owned_equal(got[1], want[1], dy, dx)


@pytest.mark.parametrize("ns", [2, 5])
def test_corr_smooth2_raw_col_hooks(rng, ns):
    u, f = _t(rng.standard_normal((NY, NX))), _t(rng.standard_normal((NY, NX)))
    coarse = _t(rng.standard_normal(((NY - 1) // 2 + 1, (NX - 1) // 2 + 1)) * 1e-2)
    c = torch.tensor(0.0)
    want, rr = corr_smooth2(u, f, coarse, H, c, ns=ns, with_norm=True)
    corrx = transfer.x_interleave_coarse(coarse)
    padded = torch.nn.functional.pad(corrx, (GX, 2 * NX_L + GX - NX, G // 2, NY_L + G))
    parts = []
    for dy, dx in SPLIT:
        r0 = dy * NY_L // 2
        win = padded[r0:r0 + (NY_L + 2 * G) // 2 + 1, dx * NX_L:dx * NX_L + NX_L + 2 * GX]
        got, rr_d = corr_smooth2_raw(_window(u, dy, dx), _window(f, dy, dx), win, H, c, ns=ns,
                                     with_norm=True, **_hooks(dy, dx))
        _owned_equal(got, want, dy, dx)
        parts.append(float(rr_d) ** 2)
    _close(parts, float(rr) ** 2)


def test_col_hooks_reject_odd_offsets_and_local_side_columns(rng):
    u, f = _t(rng.standard_normal((NY, NX))), _t(rng.standard_normal((NY, NX)))
    c = torch.tensor(0.0)
    with pytest.raises(ValueError, match="must be even"):
        smooth2r_split(u, f, H, c, cols=Cols(-7, NX, (0, NX)))
    with pytest.raises(ValueError, match="elim is not defined"):
        smooth2r_split(_window(u, 0, 0), _window(f, 0, 0), H, c, elim=True, **_hooks(0, 0))
    uds, ff, e = _ds_inputs(rng)
    with pytest.raises(ValueError, match="apply_bcs is not defined"):
        ds.defect_pass(_window(uds, 0, 1), _window(ff, 0, 1), None, 0.0, H, 0.0,
                       apply_bcs=True, **_hooks(0, 1))
    # whole column hooks are the single device: elim and apply_bcs stay allowed
    whole = smooth2r_split(u, f, H, c, elim=True)
    got = smooth2r_split(u, f, H, c, elim=True, cols=Cols.whole(NX))
    torch.testing.assert_close(got[0], whole[0], rtol=0, atol=0)


CFG = dict(coarse_size=129, pre_smooth=3, post_smooth=3)


@pytest.mark.parametrize("n,shape,rep", [(513, (2, 2), 257), (1025, (4, 2), 257),
                                         (1025, (2, 4), 513)])
def test_mg_solve_ds_sharded_2d_matches(n, shape, rep):
    """DST-129, V(3,3), tol 1e-6.  (1025, 4x2, 257) shards two levels, so
    the up leg's window from a sharded coarse correction runs."""
    rng = np.random.default_rng(n + shape[1])
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = rng.random((n - 2, n - 2))
    h, tol = 1.0 / (n - 1), 1e-6
    (hj, lj), _, it_j = jdist.mg_solve_ds_sharded_2d(
        jnp.asarray(b), h, 0.0, tol, 20, jmesh(shape, ("y", "x")),
        cfg=JMG(coarse_solver=JCoarse.DST, **CFG), replicate_below=rep)
    cfg = MGConfig(coarse_solver=CoarseSolver.DST, **CFG)
    (ht, lt), _, it_t = dist_mg_ds.mg_solve_ds_sharded_2d(
        torch.tensor(b), h, 0.0, tol, 20, make_mesh(shape, ("y", "x"), device="cpu"),
        cfg=cfg, replicate_below=rep)
    (hs, ls), _, it_s = mg_solve_ds(None, torch.tensor(b), h, 0.0, tol, 20, cfg=cfg,
                                    return_pair=True)
    assert it_t == int(it_j) == it_s < 20
    u_t = ht.double() + lt.double()
    assert u_t.shape == (n, n)
    u_j = torch.tensor(np.asarray(hj, np.float64) + np.asarray(lj, np.float64))
    u_s = hs.double() + ls.double()
    for ref in (u_j, u_s):
        assert float((u_t - ref).abs().max() / ref.abs().max()) < 1e-6
    b64 = torch.tensor(b, dtype=torch.float64)
    rel = stencil2d.rms(stencil2d.residual(u_t, b64, h, 0.0)) / stencil2d.rms(b64)
    assert float(rel) < 2 * tol


def test_gather_result_off_returns_the_shard_pairs():
    n, shape, rep = 513, (2, 2), 257
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(5).random((n - 2, n - 2))
    mesh = make_mesh(shape, ("y", "x"), device="cpu")
    cfg = MGConfig(coarse_solver=CoarseSolver.DST, **CFG)
    kw = dict(cfg=cfg, replicate_below=rep)
    (hi, lo), r, it = dist_mg_ds.mg_solve_ds_sharded_2d(torch.tensor(b), 1 / 512, 0.0, 1e-6,
                                                        20, mesh, **kw)
    pairs, r2, it2 = dist_mg_ds.mg_solve_ds_sharded_2d(torch.tensor(b), 1 / 512, 0.0, 1e-6,
                                                       20, mesh, gather_result=False, **kw)
    plan = dist_mg_ds.plan_shards_2d(n, n, *shape, cfg, rep)
    assert it2 == it and float(r2) == float(r) and len(pairs) == 4
    assert pairs[0].shape == (2, plan.ny_l + 2 * G, plan.nx_l + 2 * GX)
    u = dist_mg_ds.gather_2d(pairs, plan, mesh)
    torch.testing.assert_close(u[0], hi, rtol=0, atol=0)
    torch.testing.assert_close(u[1], lo, rtol=0, atol=0)


def test_cli_mesh(capsys):
    """``mg --devices N --mesh YxX`` runs the 2D solver on a virtual CPU mesh
    and refuses a mesh of another size with fpr_tpu/cli.py:206-211's
    message."""
    from fpr_tpu_torch import cli

    argv = ["mg", "--device", "cpu", "--k", "10", "--l", "7", "--coarse", "dst", "--solver",
            "ds", "--devices", "4"]
    cli.main([*argv, "--mesh", "2x2"])
    out = capsys.readouterr().out
    assert "1025^2 -> coarse 129^2 [ds]" in out
    rel = float(out.split("true f64 r_rms/f_rms = ")[1].split()[0])
    assert rel < 1e-6
    with pytest.raises(SystemExit, match="--mesh 2x3 needs 6 devices, --devices says 4"):
        cli.main([*argv, "--mesh", "2x3"])


def test_2d_solver_hands_the_kernels_contiguous_tensors(monkeypatch):
    """The CUDA wrappers refuse non-contiguous tensors, which the plain
    versions run here would take: every tensor the 2D solver passes to K1,
    #6 and #7 must be contiguous (a correction window sliced in columns is
    not)."""
    seen = []

    def checked(fn):
        def wrapper(*args, **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), fn.__name__
                    seen.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper

    for name in ("smooth2r_split", "corr_smooth2_raw"):
        monkeypatch.setattr(dist_mg_ds, name, checked(getattr(dist_mg_ds, name)))
    monkeypatch.setattr(dist_mg_ds.dsm, "defect_pass", checked(ds.defect_pass))
    n = 1025
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(6).random((n - 2, n - 2))
    dist_mg_ds.mg_solve_ds_sharded_2d(torch.tensor(b), 1 / 1024, 0.0, 1e-6, 2,
                                      make_mesh((4, 2), ("y", "x"), device="cpu"),
                                      cfg=MGConfig(coarse_solver=CoarseSolver.DST, **CFG),
                                      replicate_below=257)
    assert {"smooth2r_split", "corr_smooth2_raw", "defect_pass"} <= set(seen)
