"""The plain references against the port's CPU path at tiny sizes, and the
references import nothing of the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from fpr_tpu_torch.core.config import DiffusionConfig, InitScheme, NSConfig
from fpr_tpu_torch.models import diffusion3d as d3
from fpr_tpu_torch.models import navier_stokes as ns

from portbench import run
from portbench.reference.diffusion3d import DualTime, field_error
from portbench.reference.ns2d import Convection, cosine_init

DIFF = dict(nx=14, ny=12, nz=10, lx=10.0, ly=10.0, lz=10.0, D=1.0, dt=0.2, tol=1e-6,
            iter_max=100000)


@pytest.mark.parametrize("K,ttot,iter_max", [(1, 0.6, 100000), (3, 0.4, 60), (2, 0.4, 100000)])
def test_diffusion_reference_against_the_port(K, ttot, iter_max):
    p = dict(DIFF, check_every=K, ttot=ttot, iter_max=iter_max)
    want = DualTime(p).solve()
    got = d3.solve(DiffusionConfig(**{k: p[k] for k in ("nx", "ny", "nz", "lx", "ly", "lz",
                                                         "D", "dt", "tol", "iter_max", "ttot")},
                                   check_every=K), device="cpu")
    assert got.iters_total == want["iters"]
    assert got.converged == want["converged"]
    assert field_error(got.H, want["H"]) < 1e-5


def test_diffusion_exact_reference_against_its_iteration():
    p = dict(DIFF, check_every=1, ttot=0.4)
    exact = DualTime(p).solve()
    it = DualTime(p).iterate_solve(torch.float64, None)
    assert it["steps"] == exact["steps"]
    assert field_error(it["H"], exact["H"]) < 1e-10


@pytest.mark.parametrize("beta,ttot", [(0.0, 0.0012), (0.5, 0.01)])
def test_ns_reference_against_the_port(beta, ttot):
    p = dict(nx=65, ny=33, Ra=1e6, Pr=0.01, k=1.0, beta=beta, tol=1e-9, ttot=ttot, niters=50,
             a_dif=0.15, a_adv=0.4)
    W0 = np.random.default_rng(3).random((p["ny"], p["nx"]))
    T0 = cosine_init(p)
    want = Convection(p).run(W0, T0)
    cfg = NSConfig(**p, T_init=InitScheme.FROM_ARRAY, W_init=InitScheme.FROM_ARRAY)
    got = ns.simulate_fast(cfg, W0=W0, T0=T0, device="cpu")
    assert got.steps == want["steps"]
    for a, b in ((got.T, want["T"]), (got.W, want["W"]), (got.S, want["S"])):
        assert np.max(np.abs(a - b)[1:-1, 1:-1]) <= 1e-4 * np.max(np.abs(b)[1:-1, 1:-1])


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import portbench.reference.ns2d, portbench.reference.diffusion3d; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'fpr_tpu_torch', 'fpr_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
