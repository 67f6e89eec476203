"""The port's public entry points take the JAX package's positional order
and return its dtypes: ``simulate_fast``, ``simulate_fast_sharded``,
``solve_distributed``, ``mg_solve_ds`` and ``build_step`` called with the
same positional arguments on both sides, their positional parameters
compared by ``inspect.signature``, and the float32 host loop
(``simulate``), whose fields and snapshots come back in the state's dtype.

Bounds are the existing tests': the fast loop as
tests/test_torch_navier_stokes.py (explicit fields within 1e-5 of their
maximum, sim_time to float32 resolution), the sharded loop as
tests/test_torch_dist_ns.py (W and T within 1e-4), the sharded diffusion
tier as tests/test_torch_dist_diffusion.py (float64 counts equal, fields
within 1e-13).  The float32 host loop: equal step counts, and fields within
2e-4 of their maximum, tests/test_torch_ns_host.py's bound for a float32
loop against a float64 one (the two sides round each float32 operation
differently: XLA:CPU contracts multiply-adds into FMAs).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import DiffusionConfig as JConfig
from fpr_tpu.core.config import ExecutionPolicy as JPolicy
from fpr_tpu.core.config import InitScheme as JInit
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.models import dist_ns as jdn
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu.parallel import dist_diffusion as jdd
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import (DiffusionConfig, ExecutionPolicy, InitScheme, MGConfig,
                                       NSConfig)
from fpr_tpu_torch.models import dist_ns, navier_stokes
from fpr_tpu_torch.parallel import dist_diffusion
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.solvers import multigrid as tmg

EPS32 = float(np.finfo(np.float32).eps)
PAIRS = [(jns.simulate_fast, navier_stokes.simulate_fast),
         (jdn.simulate_fast_sharded, dist_ns.simulate_fast_sharded),
         (jdd.solve_distributed, dist_diffusion.solve_distributed),
         (jns.simulate, navier_stokes.simulate),
         (jmg.mg_solve_ds, tmg.mg_solve_ds),
         (jdd.build_step, dist_diffusion.build_step)]


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _fields(rng, ny, nx):
    """W0 and T0 for a run: T0 in [0, 1] with the reference's BC rows."""
    T0 = rng.random((ny, nx))
    T0[0], T0[-1] = 1.0, 0.0
    return rng.standard_normal((ny, nx)) * 10.0, T0


def _agree(got, want, rel, t_abs=None):
    assert got.steps == want.steps
    assert abs(got.sim_time - want.sim_time) <= 1e-6
    for name in ("T", "W", "S"):
        g, w = getattr(got, name), getattr(want, name)
        bound = rel * max(np.abs(w).max(), 1e-30) if t_abs is None or name != "T" else t_abs
        assert np.abs(g - w).max() <= bound, name


@pytest.mark.parametrize("jax_fn,port_fn", PAIRS, ids=lambda f: f.__name__)
def test_positional_parameters_match_jax(jax_fn, port_fn):
    assert _positional(port_fn) == _positional(jax_fn)


@pytest.mark.parametrize("pkg", ["core", "ops", "solvers"])
def test_package_exports_match_jax(pkg):
    """Each package exports JAX's names: core's grid names, ops' modules,
    solvers' entry points."""
    import importlib

    port = importlib.import_module(f"fpr_tpu_torch.{pkg}")
    ref = importlib.import_module(f"fpr_tpu.{pkg}")
    assert set(ref.__all__) <= set(port.__all__)
    assert all(callable(getattr(port, n)) or inspect.ismodule(getattr(port, n))
               for n in ref.__all__)


@pytest.mark.parametrize("bad", [0, -3, 2.5, "5", True])
def test_chunk_steps_is_checked(bad):
    cfg = NSConfig(nx=17, ny=17, ttot=1e-3, beta=0.0)
    with pytest.raises(ValueError, match="chunk_steps"):
        navier_stokes.simulate_fast(cfg, max_steps=1, chunk_steps=bad, device="cpu")
    with pytest.raises(ValueError, match="chunk_steps"):
        dist_ns.simulate_fast_sharded(cfg, make_mesh((2,), ("y",), device="cpu"),
                                      max_steps=1, chunk_steps=bad)


def test_simulate_fast_positional_w0_t0():
    """simulate_fast(cfg, W0, T0, max_steps): T0 replaces the cosine init
    on both sides, and chunk_steps (in its place) changes nothing."""
    kw = dict(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01, tol=1e-7, niters=50)
    W0, T0 = _fields(np.random.default_rng(7), 65, 65)
    want = jns.simulate_fast(JNS(**kw), W0, T0, 5)
    got = navier_stokes.simulate_fast(NSConfig(**kw), W0, T0, 5, device="cpu")
    assert got.steps == 5
    assert abs(got.sim_time - want.sim_time) <= EPS32 * want.sim_time
    _agree(got, want, 1e-5)
    # T0 was used: the cosine start gives another T
    cos = navier_stokes.simulate_fast(NSConfig(**kw), W0, None, 5, device="cpu")
    assert np.abs(cos.T - got.T).max() > 1e-2
    again = navier_stokes.simulate_fast(NSConfig(**kw), W0, T0, 5, False, 0, 2, device="cpu")
    for name in ("T", "W", "S"):
        np.testing.assert_array_equal(getattr(again, name), getattr(got, name))


def test_simulate_fast_sharded_positional_w0_t0():
    """simulate_fast_sharded(cfg, mesh, "y", W0, T0, max_steps) on 8 row
    shards (tests/test_torch_dist_ns.py's mesh and size)."""
    kw = dict(nx=129, ny=65, Pr=0.01, tol=1e-7, niters=50, ttot=10.0, beta=0.0)
    W0, T0 = _fields(np.random.default_rng(42), 65, 129)
    want = jdn.simulate_fast_sharded(JNS(**kw), jmesh((8,), ("y",)), "y", W0, T0, 5,
                                     replicate_below=33)
    got = dist_ns.simulate_fast_sharded(NSConfig(**kw), make_mesh((8,), ("y",), device="cpu"),
                                        "y", W0, T0, 5, replicate_below=33)
    assert got.steps == 5
    _agree(got, want, 1e-4, t_abs=1e-4)


def test_solve_distributed_positional_axis_dtype():
    """solve_distributed(cfg, mesh, "z", dtype): float64 reaches the fourth
    slot on both sides (a float32 run would miss the 1e-13 bound)."""
    kw = dict(nx=16, ny=16, nz=8, ttot=0.4, tol=1e-7)
    want = jdd.solve_distributed(JConfig(**kw, policy=JPolicy.JNP), jmesh((2,), ("z",)), "z",
                                 jnp.float64)
    got = dist_diffusion.solve_distributed(DiffusionConfig(**kw, policy=ExecutionPolicy.JNP),
                                           make_mesh((2,), ("z",), device="cpu"), "z",
                                           torch.float64)
    assert got.H.dtype == np.float64
    assert got.iters_total == want.iters_total
    np.testing.assert_allclose(got.H, want.H, rtol=0, atol=1e-13)


def test_build_step_positional_axis():
    """build_step(cfg, mesh, "z"): the axis is taken and ignored on both
    sides, which build the same global grid; dtype is keyword-only."""
    kw = dict(nx=8, ny=8, nz=8, ttot=0.4, tol=1e-7)
    jstep, jgrid = jdd.build_step(JConfig(**kw, policy=JPolicy.JNP), jmesh((2,), ("z",)), "z")
    step, grid = dist_diffusion.build_step(DiffusionConfig(**kw, policy=ExecutionPolicy.JNP),
                                           make_mesh((2,), ("z",), device="cpu"), "z")
    assert (grid.nx, grid.ny, grid.nz) == (jgrid.nx, jgrid.ny, jgrid.nz) == (8, 8, 16)
    assert inspect.signature(dist_diffusion.build_step).parameters["dtype"].kind == \
        inspect.Parameter.KEYWORD_ONLY


def test_mg_solve_ds_positional_fmg(monkeypatch):
    """mg_solve_ds(u0, f, h, c, tol, niters, cfg, inner_cycles, return_pair,
    apply_bcs, fmg): a positional fmg is fmg (bitwise the keyword call, and
    another run than fmg=False); device stays keyword-only.  FMG against
    JAX's: tests/test_torch_host_tiers.py."""
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 65 * 65)
    n = 129
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(3).standard_normal((n - 2, n - 2))
    b = torch.tensor(b)
    cfg = MGConfig(coarse_size=17)
    up, rp, ip = tmg.mg_solve_ds(None, b, 1 / 128, 0.0, 1e-6, 30, cfg, None, False, False, True)
    uk, rk, ik = tmg.mg_solve_ds(None, b, 1 / 128, 0.0, 1e-6, 30, cfg=cfg, fmg=True)
    u0, _, i0 = tmg.mg_solve_ds(None, b, 1 / 128, 0.0, 1e-6, 30, cfg=cfg)
    assert ip == ik < i0 and torch.equal(up, uk) and torch.equal(rp, rk)
    assert not torch.equal(up, u0)
    assert inspect.signature(tmg.mg_solve_ds).parameters["device"].kind == \
        inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_loop_keeps_the_state_dtype(dtype):
    """simulate's T, W, S and snapshots come back in the state's dtype, as
    JAX's do, and the float32 run stays with JAX's float32 host loop."""
    kw = dict(nx=65, ny=17, Pr=0.1, tol=1e-7, ttot=1.0, beta=0.5)
    W0 = np.random.default_rng(5).standard_normal((17, 65)) * 10.0
    want = jns.simulate(JNS(**kw, W_init=JInit.FROM_ARRAY), W0, None, 4, False, 2,
                        getattr(jnp, dtype))
    got = navier_stokes.simulate(NSConfig(**kw, W_init=InitScheme.FROM_ARRAY), W0, None, 4,
                                 False, 2, getattr(torch, dtype), device="cpu")
    assert got.steps == want.steps == 4
    arrays = [got.T, got.W, got.S, *(a for snap in got.snapshots for a in snap)]
    assert [a.dtype for a in arrays] == [np.dtype(dtype)] * len(arrays)
    assert len(got.snapshots) == len(want.snapshots) == 2
    rel = 2e-4 if dtype == "float32" else 1e-8
    for name in ("T", "W", "S"):
        w = np.asarray(getattr(want, name))
        assert getattr(want, name).dtype == np.dtype(dtype)
        assert np.abs(getattr(got, name) - w).max() <= rel * np.abs(w).max(), name
