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
import sys

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
                        "true_f64_rel_residual", "device_seconds_one_solve"}
    assert row["reps"] == 3 and row["device_seconds_one_solve"] is None
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
    return _in_process(monkeypatch)


def _in_process(monkeypatch, payloads=None):
    """Run the bench's components in this process (``_component_payload``),
    where the patched row functions reach them; a raising component gives
    the error payload of a child that failed.  payloads: name -> the
    payloads that its runs return in turn instead.  Returns the names run,
    in order."""
    runs = []

    def run_component(name, quick, device, tries=2):
        runs.append(name)
        if payloads and payloads.get(name):
            return payloads[name].pop(0)
        try:
            return bench._component_payload(name, quick, device)
        except Exception as exc:
            return {"error": f"{type(exc).__name__}: {exc}"}

    monkeypatch.setattr(bench, "_run_component", run_component)
    return runs


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


# ---------------------------------------------------------------------------
# the orchestration: a process and a time limit a component, the canary gate,
# the kernel-agreement check
# ---------------------------------------------------------------------------

RUN_COMPONENT = bench._run_component  # the real one, which _tiny replaces
HEALTHY = {"ms_per_iter": bench.CANARY_ENVELOPE_MS[0]}
BREACH = {"ms_per_iter": 10 * bench.CANARY_HEALTHY_MS}


def _stand_in(monkeypatch, code, limit=60):
    """Every component's child runs ``python -c code`` under ``limit`` s."""
    monkeypatch.setattr(bench, "_command", lambda name, quick, device: [sys.executable, "-c",
                                                                         code])
    monkeypatch.setattr(bench, "_TIMEOUTS", dict.fromkeys(bench.COMPONENTS, limit))


@pytest.mark.parametrize("code,error", [("import time; time.sleep(60)", "timeout after 2 s"),
                                        ("print('a log line'); raise SystemExit(3)",
                                         "exit 3 with no payload")])
def test_a_failed_child_is_retried_then_recorded(monkeypatch, capsys, tmp_path, code, error):
    """The MG row's child hangs past its limit, or exits with no payload:
    it runs twice, each time in a fresh process, and the line carries
    mg_error (the failure and the end of the child's output); the other
    components run in this process."""
    _tiny(monkeypatch)
    in_process = bench._run_component
    runs = tmp_path / "runs"
    _stand_in(monkeypatch, f"open({str(runs)!r}, 'a').write('x'); {code}", limit=2)
    monkeypatch.setattr(bench, "_run_component", lambda name, *a, **kw: (
        RUN_COMPONENT if name == "mg" else in_process)(name, *a, **kw))
    assert bench.main(["--device", "cpu", "--quick"]) == 1
    ex = _line(capsys)["extras"]
    assert ex["mg_error"].startswith(error) and runs.read_text() == "xx"
    assert "mg_grid" not in ex and "diffusion_grid" in ex
    if "exit" in error:
        assert "a log line" in ex["mg_error"]


def test_a_payload_after_other_lines_is_taken(monkeypatch):
    line = json.dumps({"component": "mg", "payload": {"grid": "65^2"}})
    _stand_in(monkeypatch, f"print('warning'); print({json.dumps({'component': 'x'})!r}); "
                           f"print({line!r}); print('trailing log')")
    assert bench._run_component("mg", False, "cpu") == {"grid": "65^2"}


def test_canary_breaches_twice_no_numbers(monkeypatch, capsys):
    _tiny(monkeypatch)
    runs = _in_process(monkeypatch, {"canary": [BREACH, BREACH]})
    assert bench.main(["--device", "cpu", "--skip-ns"]) == 1
    line = _line(capsys)
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["env_degraded"] is True and runs == ["canary", "canary"]
    ex = line["extras"]
    assert ex["canary"] == BREACH and ex["canary_healthy_envelope_ms"] == list(
        bench.CANARY_ENVELOPE_MS)
    assert not any(k.startswith(("diffusion_", "mg_", "ns_", "aliased")) for k in ex)


def test_canary_breaches_once_then_rows_run(monkeypatch, capsys):
    _tiny(monkeypatch)
    runs = _in_process(monkeypatch, {"canary": [BREACH, HEALTHY]})
    assert bench.main(["--device", "cpu", "--quick"]) == 0
    line = _line(capsys)
    assert runs == ["canary", "canary", "aliased", "diffusion", "mg"]
    assert "env_degraded" not in line and line["value"] > 0
    assert line["extras"]["canary"] == HEALTHY and "mg_grid" in line["extras"]


def test_canary_post_breach_fails_the_bench(monkeypatch, capsys):
    _tiny(monkeypatch)
    runs = _in_process(monkeypatch, {"canary": [HEALTHY], "canary_post": [BREACH, BREACH]})
    assert bench.main(["--device", "cpu", "--skip-ns", "--skip-mg"]) == 1
    ex = _line(capsys)["extras"]
    assert ex["env_degraded_after"] is True and ex["canary_post"] == BREACH
    assert runs[-2:] == ["canary_post", "canary_post"] and "diffusion_grid" in ex


def test_kernel_mismatch_fails_the_bench_rows_still_run(monkeypatch, capsys):
    _tiny(monkeypatch)
    bad = {"passed": False, "checks": 26,
           "mismatches": [{"what": "3D K=4: #10 vs #9, field", "cells": 3, "max_abs_diff": 1.0}]}
    _in_process(monkeypatch, {"aliased": [bad]})
    assert bench.main(["--device", "cpu", "--quick"]) == 1
    ex = _line(capsys)["extras"]
    assert ex["aliased_kernel_check"] is False
    assert ex["aliased_kernel_check_mismatches"] == bad["mismatches"]
    assert {"diffusion_grid", "mg_grid"} <= set(ex)


def test_cpu_skips_the_canaries_and_the_check(monkeypatch, capsys):
    runs = _tiny(monkeypatch)
    assert bench.main(["--device", "cpu", "--skip-ns"]) == 0
    ex = _line(capsys)["extras"]
    assert ex["canary"] == ex["canary_post"] == {"skipped": "not cuda"}
    assert ex["aliased_kernel_check"] is None and "env_degraded_after" not in ex
    assert runs == ["canary", "aliased", "diffusion", "mg", "canary_post"]


def test_one_real_child_process():
    assert bench._run_component("canary", False, "cpu") == {"skipped": "not cuda"}


def test_canary_is_the_diffusion_row(monkeypatch):
    """bench_canary: bench_diffusion's 512^3 K=3 row, ms an iteration."""
    sizes, real = [], bench.bench_diffusion
    monkeypatch.setattr(bench, "bench_diffusion", lambda n, cap, reps=3, device="cuda": (
        sizes.append((n, cap, reps)) or real(16, cap, reps, device="cpu")))
    got = bench.bench_canary(9, device="cpu")
    assert sizes == [(512, 9, 3)]
    assert set(got) == {"ms_per_iter", "iqr_ms_per_iter", "iterations", "reps"}
    assert got["iterations"] == 9 and got["reps"] == 3 and got["ms_per_iter"] > 0


def test_aliased_check_tiny():
    got = bench.check_aliased_kernels("cpu", n=16, iters=2, ny=65, nx=33)
    assert got == {"passed": True, "checks": 26, "mismatches": []}


@pytest.mark.parametrize("route", ["dual_time_stepk_padded", "corr_smooth2_raw"])
def test_aliased_check_made_to_fail(monkeypatch, route):
    """One route's result with one cell changed: the check names the
    comparisons that see it, with the cell count and the difference."""
    from fpr_tpu_torch.ops import dual_time, vcycle_legs

    mod = dual_time if route.startswith("dual") else vcycle_legs
    real = getattr(mod, route)

    def off_by_one_cell(*a, **kw):
        out, norm = real(*a, **kw)
        out = out.clone()
        out.view(-1)[out.numel() // 2] += 1.0
        return out, norm

    monkeypatch.setattr(mod, route, off_by_one_cell)
    got = bench.check_aliased_kernels("cpu", n=16, iters=2, ny=65, nx=33)
    assert got["passed"] is False and got["checks"] == 26
    what = {m["what"] for m in got["mismatches"]}
    if route.startswith("dual"):
        assert {"3D K=3: #10 vs #9, field", "3D K=4: #10 vs #9, field"} <= what
    else:
        assert {f"2D V({d},{d}) elim={e}: split vs stacked, u"
                for d, e in ((2, False), (5, False), (3, True))} == what
    assert all(m["cells"] >= 1 and m["max_abs_diff"] > 0 for m in got["mismatches"])
