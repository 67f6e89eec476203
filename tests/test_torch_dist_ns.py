"""The row-sharded NS fast loop (fpr_tpu_torch.models.dist_ns) against
fpr_tpu.models.dist_ns.simulate_fast_sharded on the conftest's
8-virtual-device mesh, 8 shards each, at 129x65 with replicate_below=33,
the same W0 passed to both (torch cannot reproduce jax.random).

Bounds are tests/test_dist_mg.py's for JAX's sharded loop against its
single device: equal step counts, sim_time within 1e-6, explicit W within
1e-4 of max|W| and T within 1e-4, semi-implicit W 1e-3 and T 1e-3 (the
Helmholtz solves amplify sub-tolerance float32 differences), S 1e-3.
Resume within the port is bitwise; the JAX package's sharded state
payload resumes in the port.  Also the multi-part dry run on the CPU.
"""

import numpy as np
import pytest
import torch

from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.models import dist_ns as jdn
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu_torch.core.config import NSConfig
from fpr_tpu_torch.models import dist_ns, navier_stokes
from fpr_tpu_torch.parallel.dryrun import dryrun_multichip
from fpr_tpu_torch.parallel.mesh import make_mesh

KW = dict(nx=129, ny=65, Pr=0.01, tol=1e-7, niters=50)
REP = dict(replicate_below=33)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the per-shard tensors are small, and more
    threads only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w0():
    return np.random.default_rng(42).standard_normal((65, 129)) * 10.0


def _mesh():
    return make_mesh((8,), ("y",), device="cpu")


def _agree(got, want, rel_w, abs_t, rel_s=1e-3):
    assert got.steps == want.steps
    assert abs(got.sim_time - want.sim_time) < 1e-6
    assert np.abs(got.W - want.W).max() / np.abs(want.W).max() < rel_w
    assert np.abs(got.T - want.T).max() < abs_t
    assert np.abs(got.S - want.S).max() / max(np.abs(want.S).max(), 1e-30) < rel_s


@pytest.fixture(scope="module")
def jax_explicit():
    """JAX's sharded explicit loop: 6 steps, and 4 steps for the payload."""
    cfg, mesh = JNS(ttot=10.0, beta=0.0, **KW), jmesh((8,), ("y",))
    full = jdn.simulate_fast_sharded(cfg, mesh, W0=_w0(), max_steps=6, **REP)
    part = jdn.simulate_fast_sharded(cfg, mesh, W0=_w0(), max_steps=4, **REP)
    return full, part


def test_explicit_matches_jax(jax_explicit):
    want, _ = jax_explicit
    got = dist_ns.simulate_fast_sharded(NSConfig(ttot=10.0, beta=0.0, **KW), _mesh(),
                                        W0=_w0(), max_steps=6, **REP)
    assert got.steps == 6
    _agree(got, want, 1e-4, 1e-4)


def test_semi_implicit_matches_jax():
    kw = dict(ttot=0.1, beta=0.5, **KW)
    want = jdn.simulate_fast_sharded(JNS(**kw), jmesh((8,), ("y",)), W0=_w0(), max_steps=5,
                                     **REP)
    got = dist_ns.simulate_fast_sharded(NSConfig(**kw), _mesh(), W0=_w0(), max_steps=5, **REP)
    _agree(got, want, 1e-3, 1e-3)
    np.testing.assert_allclose(got.T[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(got.T[-1], 0.0, atol=1e-6)
    np.testing.assert_allclose(got.T[:, 0], got.T[:, 1], atol=1e-6)


def test_jax_payload_resumes(jax_explicit):
    """JAX's sharded 4-step payload continued by the port to step 6, against
    JAX's own 6 steps (its resume is bitwise, tests/test_dist_mg.py)."""
    full, part = jax_explicit
    got = dist_ns.simulate_fast_sharded(NSConfig(ttot=10.0, beta=0.0, **KW), _mesh(),
                                        max_steps=6, state0=navier_stokes.state_from_jax(
                                            part.state), **REP)
    _agree(got, full, 1e-4, 1e-4)


def test_resume_bitwise():
    cfg = NSConfig(ttot=10.0, beta=0.0, **KW)
    full = dist_ns.simulate_fast_sharded(cfg, _mesh(), W0=_w0(), max_steps=6, **REP)
    part = dist_ns.simulate_fast_sharded(cfg, _mesh(), W0=_w0(), max_steps=4, **REP)
    resumed = dist_ns.simulate_fast_sharded(cfg, _mesh(), max_steps=6, state0=part.state, **REP)
    assert resumed.steps == full.steps == 6 and resumed.sim_time == full.sim_time
    for name in ("T", "W", "S"):
        np.testing.assert_array_equal(getattr(resumed, name), getattr(full, name))
    # the payload is the single-device loop's: it resumes there too
    single = navier_stokes.simulate_fast(cfg, max_steps=6, state0=part.state, device="cpu")
    assert single.steps == 6
    np.testing.assert_allclose(single.W, full.W, rtol=0, atol=1e-4 * np.abs(full.W).max())


def test_snapshots():
    out = dist_ns.simulate_fast_sharded(NSConfig(ttot=10.0, beta=0.0, **KW), _mesh(),
                                        max_steps=6, snapshot_steps=2, **REP)
    # the three warm-up steps run first, then every second step
    assert [s[4] for s in out.snapshots] == [4, 6]
    T, W, S, t, s = out.snapshots[-1]
    assert T.shape == (65, 129) and s == out.steps and t == out.sim_time
    np.testing.assert_array_equal(W, out.W)


def test_dryrun_multichip_cpu(capsys):
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip:") == 4 and "2x2 z-y mesh" in out
    assert "mg_solve_ds_sharded_2d 1025^2 over a 2x2 (y, x) mesh" in out


def test_cli_devices(capsys):
    """``--devices N`` runs each sharded tier on a virtual CPU mesh and
    refuses what the JAX CLI refuses."""
    from fpr_tpu_torch import cli

    cpu = ["--device", "cpu"]
    cli.main(["diffusion3d", *cpu, "--n", "8", "--ttot", "0.4", "--policy", "pallas",
              "--check-every", "2", "--devices", "2"])
    cli.main(["ns", *cpu, "--nx", "513", "--ny", "257", "--Pr", "0.01", "--tol", "1e-7",
              "--ttot", "1e-3", "--fast", "--devices", "4", "--max-steps", "4"])
    cli.main(["mg", *cpu, "--k", "10", "--l", "7", "--coarse", "dst", "--solver", "ds",
              "--devices", "4"])
    out = capsys.readouterr().out
    assert "converged: True" in out and "steps: 4" in out and "[ds]" in out
    for argv, msg in ((["diffusion3d", "--policy", "pallas_ds", "--devices", "2"], "ds tier"),
                      (["diffusion3d", "--policy", "jnp", "--check-every", "3", "--devices",
                        "2"], "needs --policy pallas"),
                      (["ns", "--devices", "2"], "add --fast"),
                      (["mg", "--solver", "mixed", "--devices", "2"], "requires --solver ds"),
                      (["mg", "--solver", "ds", "--smooths", "7", "--devices", "2"],
                       "halo exchange per leg")):
        with pytest.raises(SystemExit, match=msg):
            cli.main([*argv, *cpu])
