"""Part 1's sharded tier (fpr_tpu_torch.parallel.dist_diffusion, the boxed
dual-time kernel #8 and the K-fused #9 of ops.dual_time, the sharded JNP
steps of ops.stencil3d) against fpr_tpu.parallel.dist_diffusion on the
conftest's 8-virtual-device CPU mesh, with equal shard counts; the port's
virtual mesh runs on the CPU, where the kernels' plain versions run and the
Pallas kernels run in interpret mode.

Tolerances: float64 iteration counts equal and fields within 1e-13, as
tests/test_distributed.py holds JAX's sharded tier to its single device;
the kernels alone as test_torch_dual_time.py holds them (float64 1e-14,
float32 16 ulps of max|H|: XLA:CPU contracts FMAs inside jit, eager
PyTorch does not).  Within the port, overlap against plain and the K=3 /
K=1 / single-device check are bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import DiffusionConfig as JConfig
from fpr_tpu.core.config import ExecutionPolicy as JPolicy
from fpr_tpu.ops import pallas3d
from fpr_tpu.ops import stencil3d as jst
from fpr_tpu.parallel import dist_diffusion as jdd
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.ops import dual_time, stencil3d
from fpr_tpu_torch.parallel import dist_diffusion
from fpr_tpu_torch.parallel.mesh import make_mesh

ARGS = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
F32_ULPS = 16 * np.finfo(np.float32).eps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the per-shard tensors are small, and more
    threads only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local(n, axes, shape):
    ext = dict(zip(axes, shape))
    return dict(nx=n // ext.get("x", 1), ny=n // ext.get("y", 1), nz=n // ext.get("z", 1))


@pytest.mark.parametrize("policy", ["jnp", "pallas"])
@pytest.mark.parametrize("shape,axes", [((2,), ("z",)), ((8,), ("z",)), ((2, 4), ("z", "y")),
                                        ((2, 2, 2), ("z", "y", "x"))])
def test_sharded_matches_jax(shape, axes, policy):
    """32^3 (JNP) and 16^3 (PALLAS) global grids, as tests/test_distributed.py;
    PALLAS on 8 z-shards at 32^3, since JAX's counted model needs interior
    planes in every shard."""
    n = 32 if policy == "jnp" or shape == (8,) else 16
    kw = dict(_local(n, axes, shape), ttot=0.4, tol=1e-7)
    want = jdd.solve_distributed(JConfig(**kw, policy=JPolicy(policy)), jmesh(shape, axes),
                                 dtype=jnp.float64)
    got = dist_diffusion.solve_distributed(
        DiffusionConfig(**kw, policy=ExecutionPolicy(policy)),
        make_mesh(shape, axes, device="cpu"), dtype=torch.float64)
    assert got.n_devices == want.n_devices == int(np.prod(shape))
    assert got.iters_total == want.iters_total
    assert got.converged == want.converged
    np.testing.assert_allclose(got.H, want.H, rtol=0, atol=1e-13)


@pytest.mark.parametrize("policy", [ExecutionPolicy.JNP, ExecutionPolicy.PALLAS])
def test_overlap_equals_plain(policy):
    """The face copies beside the interior update change no bit."""
    mesh = make_mesh((4,), device="cpu")
    base = dict(nx=16, ny=16, nz=8, ttot=0.4, tol=1e-7, policy=policy)
    plain = dist_diffusion.solve_distributed(DiffusionConfig(**base), mesh,
                                             dtype=torch.float64)
    over = dist_diffusion.solve_distributed(DiffusionConfig(overlap_comm=True, **base), mesh,
                                            dtype=torch.float64)
    assert over.iters_total == plain.iters_total > 0
    np.testing.assert_array_equal(over.H, plain.H)


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("shape,axes", [((4,), ("z",)), ((2, 2, 2), ("z", "y", "x"))])
def test_global_grid_matches_jax(shape, axes, scale):
    kw = dict(nx=16, ny=12, nz=8, scale_physical_size=scale)
    g = dist_diffusion._global_grid(DiffusionConfig(**kw), make_mesh(shape, axes, device="cpu"))
    w = jdd._global_grid(JConfig(**kw), jmesh(shape, axes))
    assert (g.nx, g.ny, g.nz, g.lx, g.ly, g.lz) == (w.nx, w.ny, w.nz, w.lx, w.ly, w.lz)


def test_weak_scaling_converges():
    mesh = make_mesh((4,), device="cpu")
    cfg = DiffusionConfig(nx=16, ny=16, nz=8, ttot=0.2, tol=1e-6, scale_physical_size=True,
                          policy=ExecutionPolicy.JNP)
    out = dist_diffusion.solve_distributed(cfg, mesh, dtype=torch.float64)
    assert out.converged and np.isfinite(out.H).all() and out.H.shape == (32, 16, 16)


def test_k_fused_equals_unfused_and_single():
    """check_every=K over a z mesh (#9): K=3 sharded == K=1 sharded == the
    single-device K=3 run, bitwise in float32, at a fixed iteration budget
    (tol 0: every path runs iter_max iterations)."""
    mesh = make_mesh((4,), device="cpu")
    base = dict(nx=16, ny=16, nz=6, ttot=0.2, tol=0.0, iter_max=6,
                policy=ExecutionPolicy.PALLAS)
    out1 = dist_diffusion.solve_distributed(DiffusionConfig(**base, check_every=1), mesh)
    out3 = dist_diffusion.solve_distributed(DiffusionConfig(**base, check_every=3), mesh)
    assert out1.iters_total == out3.iters_total == 6
    np.testing.assert_array_equal(out3.H, out1.H)
    ref = diffusion3d.solve(DiffusionConfig(**dict(base, nz=24), check_every=3), device="cpu")
    assert ref.iters_total == 6
    np.testing.assert_array_equal(out3.H, ref.H)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("K,zb", [(2, None), (2, (-2, 7)), (3, (1, 8)), (3, (-3, 4))])
def test_stepk_padded_matches_pallas(rng, K, zb, dtype):
    """#9's plain version against _dual_timek_kernel on the same K-padded
    block (random ghosts), with the z-bounds of a first, interior and last
    shard."""
    nzl, ny, nx = 6, 10, 12
    Ht = rng.random((nzl + 2 * K - 2, ny, nx)).astype(dtype)
    Hp = rng.random((nzl + 2 * K, ny, nx)).astype(dtype)
    ny8, nx128 = pallas3d._pad_yx(ny, nx)
    tile = ((0, 0), (0, ny8 - ny), (0, nx128 - nx))
    out_j, s_j = pallas3d.dual_time_stepk_padded(
        jnp.asarray(np.pad(Ht, tile)), jnp.asarray(np.pad(Hp, tile)), (nzl, ny, nx), K=K,
        z_bounds=zb, **ARGS)
    out_t, s_t = dual_time.dual_time_stepk_padded(torch.tensor(Ht), torch.tensor(Hp), K,
                                                  **ARGS, z_bounds=zb)
    want = np.asarray(out_j)[K:K + nzl, :ny, :nx]
    atol = 1e-14 if dtype == np.float64 else F32_ULPS * np.abs(want).max()
    np.testing.assert_allclose(out_t.numpy()[K:K + nzl], want, rtol=0, atol=atol)
    rel = 1e-12 if dtype == np.float64 else 1e-5
    assert abs(float(s_t) - float(s_j)) <= rel * abs(float(s_j))


def test_stepk_padded_owned_planes_equal_global_stepk(rng):
    """An interior shard's owned planes after #9 equal those planes of the
    global K-step (#10's function), bitwise."""
    K, nz, ny, nx = 3, 16, 9, 11
    Ht = torch.tensor(rng.random((nz, ny, nx)))
    H = torch.tensor(rng.random((nz, ny, nx)))
    glob, _ = dual_time.dual_time_stepk(Ht, H.clone(), K, **ARGS)
    z0, nzl = 5, 6  # owned planes [5, 11)
    Hp = H[z0 - K:z0 + nzl + K].clone()
    Ht_k = Ht[z0 - K + 1:z0 + nzl + K - 1].clone()
    out, _ = dual_time.dual_time_stepk_padded(Ht_k, Hp, K, **ARGS, z_bounds=(-K, nzl - 1 + K))
    torch.testing.assert_close(out[K:K + nzl], glob[z0:z0 + nzl], rtol=0, atol=0)


def test_box_matches_pallas_bounds(rng):
    """#8 with an update box on a fully ghost-padded block against
    dual_time_step_padded's ``bounds`` on the same cells."""
    nz, ny, nx = 6, 9, 10
    H = rng.random((nz + 2, ny, nx))
    Ht = rng.random((nz, ny, nx))
    bounds = (0, nz - 1, 2, ny - 3, 1, nx - 4)
    out_j, s_j = pallas3d.dual_time_step_padded(
        jnp.asarray(pallas3d.pad_ht(jnp.asarray(Ht))),
        jnp.asarray(np.pad(H, ((0, 0), (0, 16 - ny), (0, 128 - nx)))), (nz, ny, nx),
        bounds=bounds, **ARGS)
    Hp = torch.tensor(np.pad(H, ((0, 0), (1, 1), (1, 1))))
    Ht_p = torch.nn.functional.pad(torch.tensor(Ht), (1, 1, 1, 1, 1, 1))
    box = tuple(b + 1 for b in bounds)
    out_t, part = dual_time.dual_time_box(Ht_p, Hp, box, **ARGS, window=(1, nz))
    np.testing.assert_allclose(out_t.numpy()[1:-1, 1:-1, 1:-1],
                               np.asarray(out_j)[1:1 + nz, :ny, :nx], rtol=0, atol=1e-14)
    assert part.shape == (nz,)
    assert abs(float(part.sum()) - float(s_j)) <= 1e-12 * abs(float(s_j))


def test_interior_box_is_the_single_device_step(rng):
    Ht, H = (torch.tensor(rng.random((7, 9, 11))) for _ in range(2))
    a, s = dual_time.dual_time_step(Ht, H, **ARGS)
    b, part = dual_time.dual_time_box(Ht, H, dual_time.interior_box(H.shape), **ARGS)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert abs(float(part.sum()) - float(s)) <= 1e-12 * float(s)
    with pytest.raises(ValueError, match="outside the interior"):
        dual_time.dual_time_box(Ht, H, (0, 5, 1, 7, 1, 9), **ARGS)
    with pytest.raises(ValueError, match="must not be Htau"):
        dual_time.dual_time_box(Ht, H, dual_time.interior_box(H.shape), **ARGS, out=H)


def test_jnp_shard_steps_match_jax(rng):
    """dual_time_step_ext3 and dual_time_step_overlap_z on one shard's block
    with random ghosts and faces."""
    nz, ny, nx = 6, 7, 8
    Ht = rng.random((nz, ny, nx))
    ext = rng.random((nz + 2, ny + 2, nx + 2))
    b = dict(zlo=0, zhi=nz - 1, ylo=1, yhi=ny - 1, xlo=0, xhi=nx - 2)
    want, s_j = jst.dual_time_step_ext3(jnp.asarray(Ht), jnp.asarray(ext), **ARGS, **b)
    got, s_t = stencil3d.dual_time_step_ext3(torch.tensor(Ht), torch.tensor(ext), **ARGS, **b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-14)
    assert abs(float(s_t) - float(s_j)) <= 1e-12 * float(s_j)
    H, lo, hi = rng.random((nz, ny, nx)), rng.random((1, ny, nx)), rng.random((1, ny, nx))
    want, s_j = jst.dual_time_step_overlap_z(*(jnp.asarray(a) for a in (Ht, H, lo, hi)),
                                             **ARGS, zlo=0, zhi=nz - 2)
    got, s_t = stencil3d.dual_time_step_overlap_z(*(torch.tensor(a) for a in (Ht, H, lo, hi)),
                                                  **ARGS, zlo=0, zhi=nz - 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-14)
    assert abs(float(s_t) - float(s_j)) <= 1e-12 * float(s_j)


def test_refusals():
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="z-only decomposition"):
        dist_diffusion.build_step(DiffusionConfig(nz=8, check_every=3),
                                  make_mesh((2, 2), ("z", "y"), **cpu))
    with pytest.raises(ValueError, match="must be >= check_every"):
        dist_diffusion.build_step(DiffusionConfig(nz=2, check_every=3), make_mesh((2,), **cpu))
    with pytest.raises(ValueError, match="single-device path"):
        dist_diffusion.build_step(DiffusionConfig(policy=ExecutionPolicy.PALLAS_DS),
                                  make_mesh((2,), **cpu))
    with pytest.raises(ValueError, match="CUDA tensor"):
        H = torch.zeros((8, 5, 5))
        dual_time._dual_time_stepk_padded_cuda(H[:6], H, 2, dual_time.coeffs(**ARGS), (1, 2))


@pytest.mark.parametrize("K", [2, 3, 5])
@pytest.mark.parametrize("edge", ["whole", "first", "last"])
def test_stepk_padded_ignores_unread_ghosts(rng, K, edge):
    """#9's ghost planes on a global face are never read (its box starts K+1
    planes in), and scratch's ghost planes are not part of the result: with
    both set to NaN, the owned planes and the norm are bitwise those of
    finite ghosts."""
    nzl, ny, nx = 7, 8, 9
    zb = {"whole": (1, nzl - 2), "first": (1, nzl - 1 + K), "last": (-K, nzl - 2)}[edge]
    Ht_k = torch.tensor(rng.random((nzl + 2 * K - 2, ny, nx)))
    Hp = torch.tensor(rng.random((nzl + 2 * K, ny, nx)))
    want, s_want = dual_time.dual_time_stepk_padded(Ht_k, Hp.clone(), K, **ARGS, z_bounds=zb)
    Hp_nan, scratch = Hp.clone(), torch.zeros_like(Hp)
    scratch[:K] = scratch[-K:] = float("nan")
    if zb[0] == 1:  # a global face below: its ghosts are unread
        Hp_nan[:K] = float("nan")
    if zb[1] == nzl - 2:
        Hp_nan[-K:] = float("nan")
    got, s_got = dual_time.dual_time_stepk_padded(Ht_k, Hp_nan, K, **ARGS, z_bounds=zb,
                                                  scratch=scratch)
    torch.testing.assert_close(got[K:K + nzl], want[K:K + nzl], rtol=0, atol=0)
    assert float(s_got) == float(s_want)
