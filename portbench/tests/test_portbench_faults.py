"""A run with the timed path broken underneath (the look for the card left
out: the CPU runs the program's plain versions) comes out not correct, once
for each fault the cells can have: a step that returns its state unchanged,
and an answer altered where it is produced.  No cell has a batch or an
exchange between chips to leave out."""

import pytest

import fpr_tpu_torch.models.diffusion3d as d3
import fpr_tpu_torch.models.navier_stokes as ns
import fpr_tpu_torch.ops.dual_time as dt
from portbench.tests.tiny import run_tiny

NS_CELLS = ("ns_explicit", "ns_semi")
DIFFUSION_CELLS = ("diffusion_512_k3", "diffusion_128_tol")


@pytest.mark.parametrize("name", NS_CELLS)
def test_ns_step_that_returns_its_state(monkeypatch, name):
    real = ns._fast_step

    def stuck(TW, S_ds, w_sumsq, cfg, defect=None):
        out = real(TW, S_ds, w_sumsq, cfg, defect)
        return (TW, S_ds, w_sumsq) + tuple(out[3:])
    monkeypatch.setattr(ns, "_fast_step", stuck)
    assert run_tiny(name)["correct"] is False


@pytest.mark.parametrize("name", NS_CELLS)
def test_ns_answer_altered(monkeypatch, name):
    real = ns._host_state

    def altered(st):
        h = real(st)
        h["W"][5, 7] += 0.05 * float(h["W"].abs().max())
        return h
    monkeypatch.setattr(ns, "_host_state", altered)
    assert run_tiny(name)["correct"] is False


@pytest.mark.parametrize("name", DIFFUSION_CELLS)
def test_diffusion_iteration_that_returns_its_state(monkeypatch, name):
    one, many = dt.dual_time_step_plain, dt.dual_time_stepk_plain

    def stuck_one(Ht, Htau, cf, out=None):
        o, s = one(Ht, Htau, cf, out)
        o.copy_(Htau)
        return o, s

    def stuck_many(Ht, Htau, K, cf, scratch=None):
        o, s = many(Ht, Htau, K, cf, scratch)
        o.copy_(Htau)
        return o, s
    monkeypatch.setattr(dt, "dual_time_step_plain", stuck_one)
    monkeypatch.setattr(dt, "dual_time_stepk_plain", stuck_many)
    assert run_tiny(name)["correct"] is False


@pytest.mark.parametrize("name", DIFFUSION_CELLS)
def test_diffusion_answer_altered(monkeypatch, name):
    real = d3._physical_step

    def altered(a, **kw):
        out = real(a, **kw)
        out["Ht"][5, 5, 5] += 0.01
        return out
    monkeypatch.setattr(d3, "_physical_step", altered)
    assert run_tiny(name)["correct"] is False
