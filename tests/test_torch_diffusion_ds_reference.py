"""Part 1's double-single route (``ExecutionPolicy.PALLAS_DS``) against the
benchmark's plain float64 reference (``portbench/reference/diffusion3d.py``),
and the cell ``diffusion_128_ds`` end to end, cut to a CPU's size.

- On the CPU, kernel #11's plain version at tol 1e-10 takes the reference's
  iterations, converges as it does, and lands on its field; the float32
  route at the same tol fails the cell's limits.
- The cell through ``portbench/run.py``'s ``run_cell``: correct; not
  correct with the ds iterate rounded to float32 or with a step that
  returns its state; the entry module's float32 control fails the limits.
- Marked ``card``, at the cell's own size: the graph launches' spans cover
  busy.py's busy time, and a solve's pseudo-time passes and #11 launches
  are its iterations.

The file imports no JAX, so its card tests run on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_diffusion_ds_reference.py
"""

import pytest
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.models import diffusion3d as d3
from fpr_tpu_torch.ops import ds3d

from portbench import control, run
from portbench.common import judge, load_json
from portbench.reference.diffusion3d import DualTime, field_error
from portbench.tests.tiny import Event

CELL = "diffusion_128_ds"
BENCH = load_json(run.ROOT / "BENCHMARK.json")
P = dict(lx=10.0, ly=10.0, lz=10.0, D=1.0, dt=0.2, tol=1e-10, iter_max=100000,
         check_every=1)
CFG_KEYS = ("nx", "ny", "nz", "lx", "ly", "lz", "D", "dt", "tol", "iter_max", "ttot")
# the cell at 16^3 for 2 steps; the cap keeps a broken program's unconverged
# steps short (the reference takes 58 iterations a step)
TINY = dict(params=dict(nx=16, ny=16, nz=16, ttot=0.4, iter_max=300),
            traffic=dict(burn_in_s=0.0))
# ~48-bit state: each iteration rounds at ~2^-48 (3.6e-15) of the field, and
# a few hundred of them read ~1.5e-15 at these sizes; float32 reads 4e-8
DS_FIELD_BOUND = 1e-12


def _solve(p, policy):
    cfg = DiffusionConfig(**{k: p[k] for k in CFG_KEYS}, policy=policy)
    return d3.solve(cfg, device="cpu")


def _limits():
    return run.find_cell(BENCH, CELL)[2]["limits"]


@pytest.mark.parametrize("shape,ttot", [((14, 12, 10), 0.6), ((16, 16, 16), 0.4)])
def test_ds_route_against_the_float64_reference(shape, ttot):
    p = dict(P, nx=shape[0], ny=shape[1], nz=shape[2], ttot=ttot)
    want = DualTime(p).solve()
    got = _solve(p, ExecutionPolicy.PALLAS_DS)
    assert got.iters_total == want["iters"]
    assert got.converged is want["converged"] is True
    assert field_error(got.H, want["H"]) < DS_FIELD_BOUND


@pytest.mark.parametrize("shape,ttot", [((14, 12, 10), 0.6), ((16, 16, 16), 0.4)])
def test_float32_route_fails_the_cell(shape, ttot):
    """The float32 kernel tier at tol 1e-10, each step capped at 3x the
    reference's largest count, reads over the cell's limits."""
    p = dict(P, nx=shape[0], ny=shape[1], nz=shape[2], ttot=ttot)
    want = DualTime(p).solve()
    got = _solve(dict(p, iter_max=3 * max(want["steps"])), ExecutionPolicy.PALLAS)
    limits = _limits()
    iters_off = abs(got.iters_total - want["iters"])
    converged_off = float(got.converged != want["converged"])
    assert converged_off > limits["converged_off"] or iters_off > limits["iters_off"]


def _run_tiny():
    return run.run_cell(BENCH, CELL, 2**31 + 7, 0.05, False, device="cpu",
                        log=lambda m: None, overrides=TINY, event=Event)


def test_cell_is_correct():
    r = _run_tiny()
    assert r["correct"] is True and r["failed"] == 0
    assert {"diffusion_step_ms", "setup_s"} <= set(r["metrics"])
    assert set(r["checks"]) == set(_limits())


def test_cell_with_the_iterate_rounded_to_float32(monkeypatch):
    real = ds3d.dual_time_step_ds

    def rounded(*args, **kw):
        out, s = real(*args, **kw)
        out[1].zero_()  # the lo part dropped: hi alone is float32
        return out, s
    monkeypatch.setattr(ds3d, "dual_time_step_ds", rounded)
    assert _run_tiny()["correct"] is False


def test_cell_with_a_step_that_returns_its_state(monkeypatch):
    real = ds3d.dual_time_step_ds

    def stuck(Ht, Htau, *args, **kw):
        out, s = real(Ht, Htau, *args, **kw)
        out.copy_(Htau)
        return out, s
    monkeypatch.setattr(ds3d, "dual_time_step_ds", stuck)
    assert _run_tiny()["correct"] is False


def test_control_reads_above_the_limits():
    out = control.readings(CELL, [], [2**31 + 3], torch.device("cpu"), overrides=TINY,
                           log=lambda m: None, bench=BENCH)
    checks, failed = judge(out["control"], out["limits"])
    assert failed == 1, checks
    assert out["control"][0]["converged_off"] > out["limits"]["converged_off"]


# -- on the card, at the cell's own size -------------------------------------


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: kernel #11 and the graphs run only there")
    return torch.device("cuda")


@pytest.mark.card
def test_graph_spans_cover_busy_time_on_the_card(card):
    from portbench import traced

    r = traced.run_window(BENCH, CELL, 2**31 + 9, 3.0, True, True, device=card,
                          log=lambda m: None, overrides={"traffic": {"burn_in_s": 0.0}})
    c = r["checks"]
    assert c["graph_vs_busy_rel"] <= 0.005 and c["closure_rel"] <= 0.01
    assert r["passes"]["diffusion.pseudo_time"] == r["iters"] > 0
    spans = r["spans"]
    assert spans["diffusion.to_ds"]["parents"] == ["diffusion.init_fields"]
    assert spans["diffusion.from_ds"]["parents"] == ["diffusion.copy_out"]
    assert spans["diffusion.to_ds"]["count"] == spans["diffusion.from_ds"]["count"] == r["units"]


@pytest.mark.card
def test_passes_and_launches_are_the_iterations_on_the_card(card):
    _, config, traffic = run.find_cell(BENCH, CELL)
    p = {**config["model"], **traffic["params"]}
    cfg = DiffusionConfig(**{k: p[k] for k in CFG_KEYS}, policy=ExecutionPolicy.PALLAS_DS)
    d3.solve(cfg, device=card)  # builds the graph (its warm-up pass launches too)
    passes, launches = loops.counters()["passes"], kernels.sync_launches()
    r = d3.solve(cfg, device=card)
    passes1, launches1 = loops.counters()["passes"], kernels.sync_launches()
    loop = "diffusion.pseudo_time"
    assert passes1[loop] - passes.get(loop, 0) == r.iters_total == \
        launches1["ds3d"] - launches["ds3d"] > 0
    assert r.converged
