"""Every cell, cut to a tiny size on the CPU, ends in the contract's last
line; the command refuses a machine without the card; the look for JAX
compares whole top-level names."""

import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.tiny import BENCH, CELLS, run_tiny


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_ends_in_the_result_line(name, trace):
    r = run_tiny(name, bool(trace))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(r))
    want = {m["name"] for m in run.metrics_of(BENCH, name, bool(trace))}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


def test_every_cell_and_metric_has_its_files():
    assert {w["name"] for w in BENCH["workloads"]} == set(CELLS)
    for w in BENCH["workloads"]:
        cell, config, traffic = run.find_cell(BENCH, w["name"])
        assert config["name"] == w["config"]
        assert (run.ROOT / "portbench" / "drivers" / f"{traffic['entry']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(run.reader(m["name"]), "read")


def test_command_refuses_a_machine_without_the_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "diffusion_128_tol",
                          "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_a_tree_without_the_program(tmp_path):
    import shutil

    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ns_explicit",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert run.forbidden_modules(["fpr_tpu_torch", "fpr_tpu_torch.core", "jaxtyping"]) == []
    assert run.forbidden_modules(["fpr_tpu.core", "fpr_tpu_torch"]) == ["fpr_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                                           "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench.tests.tiny import run_tiny; from portbench import run; "
            "r = run_tiny('diffusion_128_tol'); assert r['correct']; "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(w["name"] for w in BENCH["workloads"]))
def test_cell_on_the_card(card, name):
    """One short run of each cell at its own size through the command."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                          "--seed", str(2**31 + 4242), "--seconds", "2", "--trace", "1"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
