"""The port's part-1 solver (fpr_tpu_torch.models.diffusion3d.solve) against
fpr_tpu.models.diffusion3d.solve on the CPU, tier by tier, and against the
reference's golden 32^3 snapshot.

Iteration counts must be equal.  Fields: float64 tiers within 1e-12 (the
two sides round the same formulas apart from FMA contraction inside
XLA:CPU's jit, ulps of 1e-16 that a converged solve does not amplify);
the double-single tier within 2e-10, its ~48-bit state against JAX's own
ds tier and against the float64 JNP solve (tests/test_ds.py holds JAX's ds
tier to the same 2e-10).  The golden snapshot at the reference's atol
1e-5 (tests/test_diffusion3d.py).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core import bc as jbc
from fpr_tpu.core import config as jcfg
from fpr_tpu.core import grid as jgrid
from fpr_tpu.models import diffusion3d as jd
from fpr_tpu.ops import stencil3d as jst
from fpr_tpu.utils import timing as jtiming
from fpr_tpu_torch.core import bc, grid
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.models import diffusion3d as td
from fpr_tpu_torch.ops import stencil3d
from fpr_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BASE16 = dict(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7)


def _both(policy, check_every=1, **kw):
    return (jcfg.DiffusionConfig(policy=jcfg.ExecutionPolicy(policy), check_every=check_every,
                                 **kw),
            DiffusionConfig(policy=ExecutionPolicy(policy), check_every=check_every, **kw))


@pytest.mark.parametrize("policy,K,atol", [
    ("jnp", 1, 1e-12), ("pallas", 1, 1e-12), ("pallas", 3, 1e-12), ("pallas_ds", 1, 2e-10),
], ids=["jnp", "pallas-k1", "pallas-k3", "pallas_ds"])
def test_solve_matches_jax(policy, K, atol):
    jc, tc = _both(policy, K, **BASE16)
    ds_tier = policy == "pallas_ds"
    want = jd.solve(jc) if ds_tier else jd.solve(jc, dtype=jnp.float64)
    got = td.solve(tc, device="cpu") if ds_tier else \
        td.solve(tc, dtype=torch.float64, device="cpu")
    assert (got.iters_total, got.timed_iters, got.converged) == \
        (want.iters_total, want.timed_iters, want.converged)
    assert got.H.dtype == want.H.dtype == np.float64
    np.testing.assert_allclose(got.H, want.H, rtol=0, atol=atol)
    np.testing.assert_array_equal(got.x, want.x)
    for key in ("work", "memory", "intensity"):  # the same counted model
        assert got.bench.row()[key] == want.bench.row()[key]


def test_solve_f32_kernel_tier_matches_jax():
    """float32 PALLAS with a check every 3 iterations: equal counts; fields
    within 1e-6 (sub-tolerance float32 differences of the two roundings)."""
    jc, tc = _both("pallas", 3, **BASE16)
    want = jd.solve(jc, dtype=jnp.float32)
    got = td.solve(tc, device="cpu")
    assert (got.iters_total, got.timed_iters) == (want.iters_total, want.timed_iters)
    assert got.H.dtype == np.float32
    np.testing.assert_allclose(got.H, want.H, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def golden_32():
    return np.load(os.path.join(FIXTURES, "golden_part1_32.npz"))


@pytest.mark.parametrize("policy,tol,dtype", [
    ("jnp", 1e-8, torch.float64),
    # f32 at tol 1e-7 sits ~1.6e-6 off the f64 field at 32^3 (test_diffusion3d.py)
    ("pallas", 1e-7, torch.float32),
    ("pallas_ds", 1e-8, torch.float32),
], ids=["jnp", "pallas", "pallas_ds"])
def test_golden_field_snapshot(golden_32, policy, tol, dtype):
    cfg = DiffusionConfig(nx=32, ny=32, nz=32, ttot=1.0, tol=tol,
                          policy=ExecutionPolicy(policy))
    res = td.solve(cfg, dtype=dtype, device="cpu")
    assert res.converged
    inds = golden_32["indices"]
    sample = res.H[int(golden_32["z_index"])][np.ix_(inds, inds)]
    np.testing.assert_allclose(sample, golden_32["H"], atol=1e-5)
    np.testing.assert_allclose(res.x[inds], golden_32["X"], atol=1e-12)


def test_ds_tier_matches_f64():
    """The ds tier tracks the float64 JNP solve (of JAX) far below the
    float32 floor (tests/test_ds.py::test_ds3d_dual_time_matches_f64)."""
    base = dict(nx=32, ny=32, nz=32, ttot=0.4, tol=1e-9)
    want = jd.solve(_both("jnp", **base)[0], dtype=jnp.float64)
    got = td.solve(_both("pallas_ds", **base)[1], device="cpu")
    assert got.converged
    assert got.iters_total == want.iters_total
    np.testing.assert_allclose(got.H, want.H, rtol=0, atol=2e-10)


@pytest.mark.parametrize("shape", [(16, 16, 16), (20, 24, 28), (128, 128, 128)])
def test_grid_and_probes_match_jax(rng, shape):
    nz, ny, nx = shape
    g, gj = grid.Grid3D(nx, ny, nz), jgrid.Grid3D(nx, ny, nz)
    assert (g.shape, g.dx, g.dy, g.dz, g.n) == (gj.shape, gj.dx, gj.dy, gj.dz, gj.n)
    for axis in "xyz":
        np.testing.assert_array_equal(g.coords1d(axis), gj.coords1d(axis))
    assert grid.pseudo_timestep(g.dx, g.dy, g.dz, 1.3) == \
        jgrid.pseudo_timestep(gj.dx, gj.dy, gj.dz, 1.3)
    for ttot, dt in ((1.0, 0.2), (2.0, 0.2), (0.5, 0.2), (0.8, 0.2), (0.1, 0.2)):
        assert grid.outer_steps(ttot, dt) == jgrid.outer_steps(ttot, dt)
    H = rng.random(shape)
    for point in ((4.5, 4.5, 4.5), (0.3, 9.5, 5.0), (2.0, 3.0, 7.7)):
        assert td.probe_nearest(H, g, point) == jd.probe_nearest(H, gj, point)
        assert td.probe_trilinear(H, g, point) == jd.probe_trilinear(H, gj, point)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_initial_field_matches_jax(dtype):
    g = grid.Grid3D(12, 10, 9)
    got = bc.dirichlet_faces_3d(stencil3d.init_gaussian(g, dtype, device="cpu"))
    want = jbc.dirichlet_faces_3d(jst.init_gaussian(
        jgrid.Grid3D(12, 10, 9), dtype=jnp.float32 if dtype == torch.float32 else jnp.float64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offsets", [(None, None, None), (2.5, -1.25, 7.0)])
def test_initial_field_offsets_match_jax(offsets):
    """init_gaussian's x0, y0, z0: a shard's global origin."""
    got = stencil3d.init_gaussian(grid.Grid3D(12, 10, 9), torch.float64, *offsets, device="cpu")
    want = jst.init_gaussian(jgrid.Grid3D(12, 10, 9), jnp.float64, *offsets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid2d_and_mg_grid_match_jax():
    from fpr_tpu import core as jcore
    from fpr_tpu_torch import core

    for nx, ny, h in ((257, 65, 1 / 64), (9, 9, 0.125)):
        g, gj = core.Grid2D(nx, ny, h), jcore.Grid2D(nx, ny, h)
        assert (g.nx, g.ny, g.h, g.shape, g.n) == (gj.nx, gj.ny, gj.h, gj.shape, gj.n)
    assert [core.is_mg_grid(n) for n in range(12)] == [jcore.is_mg_grid(n) for n in range(12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_interior_mask_matches_jax(dtype):
    got = bc.interior_mask_2d((6, 9), dtype)
    want = jbc.interior_mask_2d((6, 9), jnp.float32 if dtype == torch.float32 else jnp.float64)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dual_time_steps_with_norm_match_jax(rng):
    """with_norm=False: the same field, no sum (None), for the three steps."""
    kw = dict(dt=0.2, dtau=0.01, dx=0.5, dy=0.4, dz=0.3, D=1.0)
    Ht, H = rng.random((6, 7, 8)), rng.random((6, 7, 8))
    Hx = np.pad(rng.random((6, 7, 8)), 1)
    lo, hi = rng.random((1, 7, 8)), rng.random((1, 7, 8))
    bounds = dict(zlo=0, zhi=5, ylo=1, yhi=5, xlo=1, xhi=6)
    calls = (
        (stencil3d.dual_time_step, jst.dual_time_step, (Ht, H), {}),
        (stencil3d.dual_time_step_ext3, jst.dual_time_step_ext3, (Ht, Hx), bounds),
        (stencil3d.dual_time_step_overlap_z, jst.dual_time_step_overlap_z, (Ht, H, lo, hi),
         dict(zlo=1, zhi=4)))
    for port, ref, args, extra in calls:
        for with_norm in (True, False):
            got, gs = port(*map(torch.tensor, args), **kw, **extra, with_norm=with_norm)
            want, ws = ref(*map(jnp.asarray, args), **kw, **extra, with_norm=with_norm)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
            if with_norm:
                assert float(gs) == pytest.approx(float(ws), rel=1e-12)
            else:
                assert gs is None and ws is None


def test_config_and_bench_model_match_jax():
    port, ref = DiffusionConfig(), jcfg.DiffusionConfig()
    for f in dataclasses.fields(port):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        assert (got.value if f.name == "policy" else got) == \
            (want.value if f.name == "policy" else want), f.name
    assert [p.value for p in ExecutionPolicy] == [p.value for p in jcfg.ExecutionPolicy]
    assert timing.MEMORY_MODEL_WORDS == jtiming.MEMORY_MODEL_WORDS
    assert timing.FLOPS_PER_CELL == jtiming.FLOPS_PER_CELL
    for model, wb in (("fused", 4), ("plain", 8)):
        assert timing.diffusion_bench_results(0.5, 1234, 64, 32, 16, wb, model).row() == \
            jtiming.diffusion_bench_results(0.5, 1234, 64, 32, 16, wb, model).row()


def test_solve_refuses_f64_kernels_on_cuda():
    """The CUDA kernels take float32: PALLAS and PALLAS_DS with float64 on a
    CUDA device raise before any device work (no fallback to JNP)."""
    for policy in (ExecutionPolicy.PALLAS, ExecutionPolicy.PALLAS_DS):
        with pytest.raises(ValueError, match="float32 CUDA kernels"):
            td.solve(DiffusionConfig(nx=8, ny=8, nz=8, policy=policy), dtype=torch.float64,
                     device="cuda")
    with pytest.raises(ValueError, match="check_every"):
        td.solve(DiffusionConfig(nx=8, ny=8, nz=8, check_every=0), device="cpu")


def test_ping_pong_buffers_follow_the_result():
    """check_every = 2 (the result lands in the input's buffer) and 3 (in the
    other one) both give the plain K=1 fields on the CPU, whatever buffer
    each call leaves the state in."""
    base = dict(nx=12, ny=12, nz=12, ttot=0.4, tol=1e-6, iter_max=12)
    ref = td.solve(DiffusionConfig(policy=ExecutionPolicy.PALLAS, **base), device="cpu")
    for K in (2, 3):
        got = td.solve(DiffusionConfig(policy=ExecutionPolicy.PALLAS, check_every=K, **base),
                       device="cpu")
        assert got.iters_total == ref.iters_total == 24
        np.testing.assert_array_equal(got.H, ref.H)


@pytest.mark.parametrize("policy", ["pallas", "pallas_ds"])
def test_cli_smoke(policy):
    argv = ["diffusion3d", "--device", "cpu", "--n", "16", "--ttot", "0.4",
            "--policy", policy, "--check-every", "3", "--bench"]
    out = subprocess.run([sys.executable, "-m", "fpr_tpu_torch", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    want = td.solve(DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.4,
                                    policy=ExecutionPolicy(policy), check_every=3),
                    device="cpu")
    assert lines[0] == f"iterations: {want.iters_total} (converged: True)"
    assert lines[1].startswith("probe H(4.5,4.5,4.5): 0.")
    import json

    row = json.loads(lines[2])
    assert row["work"] == want.bench.work and row["memory"] == want.bench.memory
