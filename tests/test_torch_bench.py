"""The port's bench (fpr_tpu_torch.bench) on the CPU at tiny sizes:
diffusion 16^3, MG 65^2, NS 129x33.  Each row function's keys, its counts
against direct calls of the same solver (and the MG outer count against
``fpr_tpu``'s ``mg_solve_ds`` on the same right-hand side), the MG true
float64 residual at or below tol; the JSON line through ``run`` with the
row functions held small: bench.py's ``extras`` names, the relaxed row's
parity rule, a failing row's exit code; no card and ``--device cuda``
exits non-zero.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from fpr_tpu.core.config import CoarseSolver as JCoarse
from fpr_tpu.core.config import MGConfig as JMG
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch import bench
from fpr_tpu_torch.core.config import NSConfig
from fpr_tpu_torch.models.navier_stokes import simulate_fast
from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
from fpr_tpu_torch.solvers import poisson
from fpr_tpu_torch.solvers.multigrid import mg_solve_ds

NS_TINY = dict(nx=129, ny=33, ttot=0.2, max_steps=5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and more threads only
    contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_diffusion_row():
    row = bench.bench_diffusion(16, 9, reps=2, device="cpu")
    assert set(row) == {"grid", "iterations", "teff_gbs", "ms_per_iter", "gflops", "median_s",
                        "iqr_s", "reps"}
    assert row["grid"] == "16^3" and row["iterations"] == 9 and row["reps"] == 2
    # the counted 6+1 model at float32: 28 bytes and 27 flops a cell and iteration
    cells_iters = 14**3 * 9
    assert row["teff_gbs"] * 1e9 * row["median_s"] == pytest.approx(28 * cells_iters, rel=1e-9)
    assert row["gflops"] * 1e9 * row["median_s"] == pytest.approx(27 * cells_iters, rel=1e-9)
    assert row["ms_per_iter"] == pytest.approx(row["median_s"] / 9 * 1e3, rel=1e-12)
    assert bench.bench_diffusion(16, 10, reps=1, device="cpu")["iterations"] == 9


def test_mg_row_counts_and_residual():
    row = bench.bench_mg(65, tol=1e-6, reps=3, device="cpu")
    assert set(row) == {"grid", "seconds_to_tol", "iqr_s", "reps", "outer_iterations",
                        "true_f64_rel_residual", "profiler_device_seconds_one_solve"}
    assert row["reps"] == 3 and row["profiler_device_seconds_one_solve"] is None
    assert row["true_f64_rel_residual"] <= 1e-6
    b = poisson.poisson_rhs(65, "cpu")
    cfg = MGConfig(coarse_size=65, coarse_solver=CoarseSolver.DST, pre_smooth=5, post_smooth=5)
    _, _, it = mg_solve_ds(None, b, 1 / 64, 0.0, 1e-6, 30, cfg=cfg, return_pair=True)
    jcfg = JMG(coarse_size=65, coarse_solver=JCoarse.DST, pre_smooth=5, post_smooth=5)
    _, _, jit_ = jmg.mg_solve_ds(None, b.numpy(), 1 / 64, 0.0, 1e-6, 30, cfg=jcfg,
                                 return_pair=True)
    assert row["outer_iterations"] == it == int(jit_)


def test_mg_row_above_the_dst_size():
    """At 1025^2 the ladder has levels above the DST-513 coarse solve."""
    row = bench.bench_mg(1025, reps=1, device="cpu")
    assert row["grid"] == "1025^2" and 2 <= row["outer_iterations"] <= 30
    assert row["true_f64_rel_residual"] <= 1e-6


@pytest.mark.parametrize("beta,s_tol", [(0.0, 1.0), (0.0, 100.0), (0.5, 1.0), (1.0, 1.0)])
def test_ns_row_counts(beta, s_tol):
    row = bench.bench_ns_row(beta, s_tol_factor=s_tol, reps=2, device="cpu", **NS_TINY)
    assert set(row) == {"seconds", "rep_seconds", "iqr_s", "reps", "timed_steps", "steps"}
    assert row["reps"] == len(row["rep_seconds"]) == 2
    assert row["seconds"] == pytest.approx(float(np.median(row["rep_seconds"])), rel=1e-12)
    cfg = NSConfig(nx=129, ny=33, ttot=0.2, beta=beta, Pr=0.01, tol=1e-7, niters=50,
                   s_tol_factor=s_tol)
    out = simulate_fast(cfg, seed=0, max_steps=5, device="cpu")
    assert (row["steps"], row["timed_steps"]) == (out.steps, out.timed_iters)
    assert out.steps >= 4


def _tiny(monkeypatch, relaxed_steps=None, fail=None):
    """Hold the row functions at tiny sizes; optionally change the relaxed
    row's timed steps or make a row raise."""
    real_d, real_mg, real_ns = bench.bench_diffusion, bench.bench_mg, bench.bench_ns_row

    def ns_row(beta, s_tol_factor=1.0, reps=3, **kw):
        if fail == "ns_semi" and beta == 0.5:
            raise RuntimeError("row failed")
        row = real_ns(beta, s_tol_factor, reps=1, device="cpu", **NS_TINY)
        if relaxed_steps is not None and s_tol_factor != 1.0:
            row["timed_steps"] = relaxed_steps
        return row

    monkeypatch.setattr(bench, "bench_diffusion", lambda n, cap, **kw: real_d(16, 9, reps=1,
                                                                               device="cpu"))
    monkeypatch.setattr(bench, "bench_mg", lambda n, **kw: real_mg(65, reps=1, device="cpu"))
    monkeypatch.setattr(bench, "bench_ns_row", ns_row)


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# bench.py's extras names of the rows both benches have
JAX_EXTRAS = {"timing", "dtype", "counting_model", "diffusion_grid", "diffusion_ms_per_iter",
              "diffusion_gflops", "diffusion_iqr_s", "mg_grid", "mg_solver",
              "mg_seconds_to_tol1e-6", "mg_iqr_s", "mg_outer_iterations",
              "mg_true_f64_rel_residual", "mg_vs_v100_0.154s",
              "ns_explicit_2049x513_Pr0.01_seconds", "ns_rep_seconds", "ns_timed_steps",
              "ns_vs_reference_1314s", "ns_semi_implicit_seconds", "ns_semi_timed_steps",
              "ns_semi_vs_reference_25.5s", "ns_explicit_relaxed_s_seconds",
              "ns_relaxed_s_rep_seconds", "ns_relaxed_s_tol_factor",
              "ns_relaxed_vs_reference_1314s"}


def test_run_line(monkeypatch, capsys):
    _tiny(monkeypatch)
    assert bench.main(["--device", "cpu"]) == 0
    line = _line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extras"}
    ex = line["extras"]
    assert JAX_EXTRAS <= set(ex), JAX_EXTRAS - set(ex)
    assert line["metric"].endswith(", f32, cpu") and "512^3" in line["metric"]
    assert ex["backend"] == ex["device"] == "cpu" and line["unit"] == "GB/s"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 63.5)
    for p in ("ns_", "ns_semi_", "ns_implicit_", "ns_relaxed_s_"):
        assert {f"{p}rep_seconds", f"{p}iqr_s", f"{p}reps", f"{p}timed_steps"} <= set(ex)
    assert ex["ns_implicit_seconds"] > 0 and "ns_relaxed_s_parity_broken" not in ex


def test_run_quick_skips_ns(monkeypatch, capsys):
    _tiny(monkeypatch)
    assert bench.main(["--device", "cpu", "--quick", "--skip-mg"]) == 0
    line = _line(capsys)
    assert "at 128^3" in line["metric"]
    assert not any(k.startswith(("ns_", "mg_")) for k in line["extras"])


def test_relaxed_row_withheld_without_parity(monkeypatch, capsys):
    _tiny(monkeypatch, relaxed_steps=-1)
    assert bench.main(["--device", "cpu", "--skip-mg"]) == 0
    ex = _line(capsys)["extras"]
    assert ex["ns_relaxed_s_parity_broken"] is True
    assert not any(k.startswith("ns_relaxed_s_") and k != "ns_relaxed_s_parity_broken"
                   for k in ex) and "ns_explicit_relaxed_s_seconds" not in ex
    assert "ns_semi_implicit_seconds" in ex


def test_failed_row_exits_nonzero(monkeypatch, capsys):
    _tiny(monkeypatch, fail="ns_semi")
    assert bench.main(["--device", "cpu", "--skip-mg"]) == 1
    ex = _line(capsys)["extras"]
    assert ex["ns_semi_error"] == "RuntimeError: row failed"
    assert "ns_implicit_seconds" in ex and "ns_semi_implicit_seconds" not in ex


def test_no_card_no_fallback(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.run(argparse.Namespace(device="cuda", quick=True, skip_mg=True, skip_ns=True))
    assert capsys.readouterr().out == ""
