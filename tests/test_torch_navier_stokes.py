"""The port's NS fast loop (fpr_tpu_torch.models.navier_stokes.simulate_fast)
against fpr_tpu.models.navier_stokes.simulate_fast on the CPU, with the
same initial W passed to both (torch cannot reproduce jax.random).

Step counts must be equal and sim_time equal to float32 resolution.
Fields: the two sides round differently inside every solve (FMA
contraction in XLA:CPU, matmul and sum orders), and each solve stops
anywhere below its tolerance (tol 1e-7 of the rhs rms), so explicit-run
fields agree to 1e-5 of their maximum, semi-implicit ones, where the
Helmholtz solves amplify the difference, to 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpr_tpu.core.config import InitScheme as JInit
from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import InitScheme, MGConfig, NSConfig
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.solvers import multigrid as tmg

EPS32 = float(np.finfo(np.float32).eps)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(**kw):
    return (JNS(W_init=JInit.FROM_ARRAY, **kw), NSConfig(W_init=InitScheme.FROM_ARRAY, **kw))


def _agree(got, want, rel):
    assert got.steps == want.steps
    assert abs(got.sim_time - want.sim_time) <= EPS32 * want.sim_time
    for name in ("T", "W", "S"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30), name


EXPLICIT = dict(nx=65, ny=65, ttot=1e-3, beta=0.0, Pr=0.01, tol=1e-7, niters=50)


def test_explicit_matches_jax():
    jc, tc = _cfgs(**EXPLICIT)
    W0 = np.random.default_rng(7).standard_normal((65, 65)) * 10.0
    want = jns.simulate_fast(jc, W0=W0, max_steps=6)
    got = tns.simulate_fast(tc, W0=W0, max_steps=6, device="cpu")
    assert got.steps == 6 and got.timed_iters == want.timed_iters == 3
    _agree(got, want, 1e-5)


def test_semi_implicit_matches_jax():
    jc, tc = _cfgs(nx=65, ny=65, ttot=0.1, beta=0.5, Pr=0.1, tol=1e-7, niters=50)
    W0 = np.random.default_rng(11).standard_normal((65, 65)) * 10.0
    want = jns.simulate_fast(jc, W0=W0, max_steps=3)
    got = tns.simulate_fast(tc, W0=W0, max_steps=3, device="cpu")
    assert got.steps == 3
    _agree(got, want, 1e-4)


def test_explicit_with_fused_legs_matches_jax(monkeypatch):
    """PALLAS_MIN_AREA lowered on both sides: the 65x129 finest level runs
    the fused legs (smooth_down / corr_up) inside every solve."""
    monkeypatch.setattr(jmg, "PALLAS_MIN_AREA", 65 * 65)
    monkeypatch.setattr(tmg, "PALLAS_MIN_AREA", 65 * 65)
    kw = dict(EXPLICIT, nx=129)
    jc, tc = _cfgs(**kw)
    W0 = np.random.default_rng(3).standard_normal((65, 129)) * 10.0
    want = jns.simulate_fast(jc, W0=W0, max_steps=4)
    got = tns.simulate_fast(tc, W0=W0, max_steps=4, device="cpu")
    _agree(got, want, 1e-5)


def test_cross_framework_resume_both_ways():
    """JAX 5 steps -> state_from_jax -> the port to step 9, and the port 5
    steps -> state_to_jax -> JAX to step 9, both against JAX's own 9."""
    jc, tc = _cfgs(**EXPLICIT)
    W0 = np.random.default_rng(5).standard_normal((65, 65)) * 10.0
    full = jns.simulate_fast(jc, W0=W0, max_steps=9)
    part_j = jns.simulate_fast(jc, W0=W0, max_steps=5)
    on_port = tns.simulate_fast(tc, max_steps=9, state0=tns.state_from_jax(part_j.state),
                                device="cpu")
    assert on_port.timed_iters == 4
    _agree(on_port, full, 1e-5)

    part_t = tns.simulate_fast(tc, W0=W0, max_steps=5, device="cpu")
    payload = tns.state_to_jax(part_t.state)
    assert {k: (v.dtype, v.shape) for k, v in payload.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape) for k, v in part_j.state.items()}
    on_jax = jns.simulate_fast(jc, max_steps=9, state0=payload)
    _agree(on_jax, full, 1e-5)


def test_resume_is_bitwise_within_the_port():
    _, tc = _cfgs(**EXPLICIT)
    W0 = np.random.default_rng(9).standard_normal((65, 65)) * 10.0
    full = tns.simulate_fast(tc, W0=W0, max_steps=9, device="cpu")
    part = tns.simulate_fast(tc, W0=W0, max_steps=5, device="cpu")
    resumed = tns.simulate_fast(tc, max_steps=9, state0=part.state, device="cpu")
    assert resumed.steps == full.steps and resumed.sim_time == full.sim_time
    for k in ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo"):
        torch.testing.assert_close(resumed.state[k], full.state[k], rtol=0, atol=0)


def test_snapshots_keep_their_cadence():
    _, tc = _cfgs(**EXPLICIT)
    W0 = np.random.default_rng(6).standard_normal((65, 65)) * 10.0
    out = tns.simulate_fast(tc, W0=W0, max_steps=13, snapshot_steps=4, device="cpu")
    steps = [s[4] for s in out.snapshots]
    assert steps == [4, 8, 12, 13]
    np.testing.assert_array_equal(out.snapshots[-1][0], out.T)


def test_fast_mg_default_matches_jax():
    for ny, nx in [(513, 2049), (257, 1025), (193, 769), (65, 257)]:
        got = tns.fast_mg_default(NSConfig(nx=nx, ny=ny)).mg
        want = jns.fast_mg_default(JNS(nx=nx, ny=ny)).mg
        assert (got.coarse_size, got.coarse_solver.value, got.pre_smooth,
                got.post_smooth) == (want.coarse_size, want.coarse_solver.value,
                                     want.pre_smooth, want.post_smooth)
    explicit = NSConfig(nx=2049, ny=513, mg=MGConfig(coarse_size=17))
    assert tns.fast_mg_default(explicit) is explicit


def test_port_imports_no_jax():
    """Every module of the port imports, and neither jax nor the JAX package
    gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fpr_tpu_torch\n"
        "for m in pkgutil.walk_packages(fpr_tpu_torch.__path__, 'fpr_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'fpr_tpu' or k.startswith('fpr_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('fpr_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 27


@pytest.mark.parametrize("argv", [
    ["ns", "--fast", "--device", "cpu", "--nx", "65", "--ny", "17", "--Pr", "0.01",
     "--tol", "1e-6", "--ttot", "1e-2", "--max-steps", "4"],
    ["mg", "--device", "cpu", "--k", "6", "--l", "2", "--smooths", "3", "--solver", "ds"],
])
def test_cli_smoke(argv):
    out = subprocess.run([sys.executable, "-m", "fpr_tpu_torch", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert ("steps: 4" if argv[0] == "ns" else "iterations") in out.stdout
