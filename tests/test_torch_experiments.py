"""The port's experiment sweeps (fpr_tpu_torch.experiments) on the CPU at
their smallest sizes, into ``tmp_path``.

For each of the six: the CSV's columns are the JAX module's row dict's
(read from its source), with ``backend`` ("cpu" here) and ``device`` (the
card's name) the two that differ, and dist_mg_large's ``device_peak_gb``
in place of ``host_peak_gb``; the counts in the rows equal the port's
direct solver calls and, where the inputs can be made equal, the JAX
solver's (the same numpy right-hand side, float64 where the port's rows
are float64); a second run skips every cached key (no solver call).  The
JAX experiments' ``main()`` changes JAX's configuration, so the JAX side
is its solver calls.  Also: ``ns_timestepping --s-tol-factor 0`` exits
with an error, every experiment refuses a missing card, and
``scripts/run_all_torch.sh`` runs only the port's modules.
"""

import ast
import csv
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fpr_tpu.core.config import DiffusionConfig as JDiff
from fpr_tpu.core.config import ExecutionPolicy as JPolicy
from fpr_tpu.core.grid import Grid3D as JGrid
from fpr_tpu.models import diffusion3d as jdiff
from fpr_tpu.solvers import krylov as jkrylov
from fpr_tpu.solvers import multigrid as jmg
from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy, MGConfig,
                                       NSConfig)
from fpr_tpu_torch.core.grid import Grid3D
from fpr_tpu_torch.experiments import (dist_mg_large, multigrid_bench, ns_timestepping,
                                       part1_benchmark, part1_error_experiments, part1_scaling)
from fpr_tpu_torch.models import diffusion3d, navier_stokes
from fpr_tpu_torch.parallel import dist_diffusion
from fpr_tpu_torch.parallel.mesh import make_mesh
from fpr_tpu_torch.solvers import dist_mg_ds, krylov, multigrid, poisson

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and more threads only
    contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_row_keys(module: str) -> list:
    """The keys of every dict assigned to ``row`` in fpr_tpu/experiments/
    <module>.py, in order (``**key`` spread from its own assignment)."""
    tree = ast.parse((REPO / "fpr_tpu" / "experiments" / f"{module}.py").read_text())
    dicts = {}

    def keys(node):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict":
            out = []
            for kw in node.keywords:
                out += [kw.arg] if kw.arg else dicts.get(getattr(kw.value, "id", ""), [])
            return out
        if isinstance(node, ast.Dict):
            out = []
            for k, v in zip(node.keys, node.values):
                out += [k.value] if k is not None else dicts.get(getattr(v, "id", ""), [])
            return out
        return None

    rows = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            found = keys(node.value)
            if found is not None:
                dicts[node.targets[0].id] = found
                if node.targets[0].id == "row":
                    rows.append(found)
    assert rows, module
    return rows


def read(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    with open(path) as f:
        header = next(csv.reader(f))
    return header, rows


def check_columns(module, header):
    assert header.count("backend") == 1 and header.count("device") == 1
    strip = [c for c in header if c not in ("backend", "device")]
    wants = [[{"host_peak_gb": "device_peak_gb"}.get(c, c) for c in keys if c != "backend"]
             for keys in jax_row_keys(module)]
    assert strip in wants, (strip, wants)


def count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_part1_benchmark(tmp_path, monkeypatch):
    out = tmp_path / "bench_diffusion.csv"
    argv = [*CPU, "--max-e", "4", "--ttot", "0.4", "--reps", "2", "--out", str(out)]
    part1_benchmark.main(argv)
    header, rows = read(out)
    check_columns("part1_benchmark", header)
    assert [(r["n"], r["policy"], r["backend"], r["reps"]) for r in rows] == \
        [("16", p, "cpu", "2") for p in ("jnp", "pallas", "pallas_k3")]
    for r, (policy, k) in zip(rows, ((ExecutionPolicy.JNP, 1), (ExecutionPolicy.PALLAS, 1),
                                     (ExecutionPolicy.PALLAS, 3))):
        cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-6, policy=policy,
                              check_every=k)
        assert int(r["iters"]) == diffusion3d.solve(cfg, device="cpu").timed_iters
    # the JAX jnp tier on the same configuration, float32
    jout = jdiff.solve(JDiff(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-6, policy=JPolicy.JNP),
                       dtype=np.float32)
    assert int(rows[0]["iters"]) == jout.timed_iters
    calls = count_calls(monkeypatch, diffusion3d, "solve")
    part1_benchmark.main(argv)
    assert not calls and read(out)[1] == rows


@pytest.mark.parametrize("mode", ["grid", "tol"])
def test_part1_error_experiments(tmp_path, monkeypatch, mode):
    out = tmp_path / f"{mode}.csv"
    argv = [*CPU, "--mode", mode, "--n", "16", "--max-e", "4", "--f64", "--out", str(out)]
    part1_error_experiments.main(argv)
    header, rows = read(out)
    check_columns("part1_error_experiments", header)
    tols = [1e-6] if mode == "grid" else part1_error_experiments.TOLS
    assert [(int(r["nx"]), r["backend"]) for r in rows] == [(16, "cpu")] * len(tols)
    g, jg = Grid3D(16, 16, 16), JGrid(16, 16, 16)
    for r, tol in zip(rows, tols):
        if mode == "tol":
            assert float(r["tol"]) == tol
        # the port's solve and the JAX jnp tier in float64 (two tolerances
        # for JAX: one build each)
        res = diffusion3d.solve(DiffusionConfig(nx=16, ny=16, nz=16, ttot=2.0, tol=tol,
                                                policy=ExecutionPolicy.JNP),
                                dtype=torch.float64, device="cpu")
        assert float(r["val"]) == diffusion3d.probe_nearest(res.H, g)
        assert float(r["interp_val"]) == diffusion3d.probe_trilinear(res.H, g)
        if tol in (1e-6, 1e-10):
            jres = jdiff.solve(JDiff(nx=16, ny=16, nz=16, ttot=2.0, tol=tol, policy=JPolicy.JNP),
                               dtype=np.float64)
            assert jres.iters_total == res.iters_total
            assert float(r["val"]) == pytest.approx(jdiff.probe_nearest(jres.H, jg), abs=1e-12)
    calls = count_calls(monkeypatch, diffusion3d, "solve")
    part1_error_experiments.main(argv)
    assert not calls and read(out)[1] == rows


def test_part1_error_experiments_ds_tier(tmp_path):
    """Without --f64 the tol sweep runs the double-single tier."""
    out = tmp_path / "ds.csv"
    part1_error_experiments.main([*CPU, "--mode", "tol", "--n", "16", "--out", str(out)])
    rows = read(out)[1]
    res = diffusion3d.solve(DiffusionConfig(nx=16, ny=16, nz=16, ttot=2.0, tol=1e-10,
                                            policy=ExecutionPolicy.PALLAS_DS), device="cpu")
    assert float(rows[-1]["val"]) == diffusion3d.probe_nearest(res.H, Grid3D(16, 16, 16))


@pytest.mark.parametrize("mode", ["strong", "weak"])
def test_part1_scaling(tmp_path, monkeypatch, mode):
    out = tmp_path / "scaling.csv"
    argv = [*CPU, "--mode", mode, "--n", "8", "--devices", "2", "--ttot", "0.4", "--out",
            str(out)]
    part1_scaling.main(argv)
    header, rows = read(out)
    check_columns("part1_scaling", header)
    (r,) = rows
    assert (r["mode"], r["devices"], r["virtual"], r["policy"]) == (mode, "2", "True", "jnp")
    cfg = DiffusionConfig(nx=8, ny=8, nz=8 if mode == "weak" else 4, ttot=0.4, tol=1e-6,
                          scale_physical_size=mode == "weak", policy=ExecutionPolicy.JNP)
    direct = dist_diffusion.solve_distributed(cfg, make_mesh((2,), ("z",), device="cpu"))
    assert int(r["iters"]) == direct.timed_iters
    calls = count_calls(monkeypatch, dist_diffusion, "solve_distributed")
    part1_scaling.main(argv)
    assert not calls and read(out)[1] == rows


def test_part1_scaling_strong_needs_divisible(tmp_path):
    with pytest.raises(SystemExit):
        part1_scaling.main([*CPU, "--mode", "strong", "--n", "9", "--devices", "2", "--out",
                            str(tmp_path / "x.csv")])


def _rhs64(n):
    return poisson.poisson_rhs(n, "cpu", np.float64)


def test_multigrid_bench_sweep(tmp_path, monkeypatch):
    out = tmp_path / "mg.csv"
    argv = [*CPU, "--min-k", "5", "--max-k", "5", "--dst", "--out", str(out)]
    multigrid_bench.main(argv)
    header, rows = read(out)
    check_columns("multigrid_bench", header)
    got = {(r["l"], r["coarse"], r["solver"]): int(r["iters"]) for r in rows}
    assert sorted(got) == sorted((l, c, s) for l, c in (("2", "jacobi"), ("2", "cg"),
                                                        ("5", "dst"))
                                 for s in ("direct", "mixed", "ds"))
    n, h = 33, 1 / 32
    b64 = _rhs64(n)
    for (l, coarse, solver), it in got.items():
        cfg = MGConfig(coarse_size=2**int(l) + 1, coarse_solver=CoarseSolver(coarse))
        if solver == "ds":
            want = multigrid.mg_solve_ds(None, b64.float(), h, 0.0, 1e-6, 30, cfg=cfg)[2]
        elif solver == "mixed":
            want = multigrid.mg_solve_mixed(torch.zeros_like(b64), b64, h, 0.0, 1e-6, 30,
                                            cfg=cfg)[2]
        else:
            want = multigrid.mg_solve(torch.zeros_like(b64), b64, h, 0.0, 1e-6, 30, cfg=cfg)[2]
        assert it == want, (l, coarse, solver)
    # the JAX direct tier on the same float64 rhs
    from fpr_tpu.core.config import CoarseSolver as JCoarse
    from fpr_tpu.core.config import MGConfig as JMG

    for coarse in ("jacobi", "cg"):
        jcfg = JMG(coarse_size=5, coarse_solver=JCoarse(coarse))
        _, _, jit_ = jmg.mg_solve(np.zeros((n, n)), b64.numpy(), h, 0.0, 1e-6, 30, cfg=jcfg)
        assert got[("2", coarse, "direct")] == int(jit_)
    calls = count_calls(monkeypatch, multigrid, "mg_solve")
    multigrid_bench.main(argv)
    assert not calls and read(out)[1] == rows


def test_multigrid_bench_workprec(tmp_path, monkeypatch):
    out = tmp_path / "wp.csv"
    argv = [*CPU, "--workprec", "--min-k", "5", "--max-k", "5", "--out", str(out)]
    multigrid_bench.main(argv)
    header, rows = read(out)
    check_columns("multigrid_bench", header)
    got = {r["solver"]: int(r["iters"]) for r in rows}
    assert list(got) == ["mg", "mixed", "ds", "cg", "mg_pcg", "mg_pcg_ds"]
    n, h = 33, 1 / 32
    b64 = _rhs64(n)
    ds_cfg = MGConfig(coarse_size=33, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                      post_smooth=5)
    assert got["mg"] == multigrid.mg_solve(torch.zeros_like(b64), b64, h, 0.0, 1e-6, 30)[2]
    assert got["cg"] == krylov.cg(b64, h, h, 0.0, 1e-6, 40000)[2]
    assert got["mg_pcg"] == krylov.mg_preconditioned_cg(b64, h, 0.0, 1e-6, 100)[2]
    assert got["mg_pcg_ds"] == krylov.mg_pcg_ds(b64.float(), h, 0.0, 1e-6, 60, cfg=ds_cfg)[2]
    assert got["ds"] == multigrid.mg_solve_ds(None, b64.float(), h, 0.0, 1e-6, 30,
                                              cfg=ds_cfg)[2]
    # the JAX float64 solvers on the same rhs
    assert got["mg"] == int(jmg.mg_solve(np.zeros((n, n)), b64.numpy(), h, 0.0, 1e-6, 30)[2])
    assert got["cg"] == int(jkrylov.cg(b64.numpy(), h, h, 0.0, 1e-6, 40000)[2])
    calls = count_calls(monkeypatch, krylov, "cg")
    multigrid_bench.main(argv)
    assert not calls and read(out)[1] == rows


def test_multigrid_bench_max_k_bounds(tmp_path):
    out = tmp_path / "wp.csv"
    multigrid_bench.main([*CPU, "--workprec", "--min-k", "5", "--max-k", "5", "--mg64-max-k",
                          "4", "--f64-iter-max-k", "4", "--wp-solvers", "mg,cg,ds", "--out",
                          str(out)])
    assert [r["solver"] for r in read(out)[1]] == ["ds"]


def test_converged_is_the_solvers_own_test():
    """A solve converged when it stopped before its cap, or at its cap with
    r_rms < tol * rms(b) (rms(b) = 2 here; exact in float64)."""
    b = torch.full((4, 4), 2.0, dtype=torch.float64)
    r = functools.partial(torch.tensor, dtype=torch.float64)
    assert multigrid_bench.converged(b, 1e-6, r(5.0), 29, 30)
    assert multigrid_bench.converged(b, 1e-6, r(1.9e-6), 30, 30)
    assert not multigrid_bench.converged(b, 1e-6, r(2e-6), 30, 30)
    assert not multigrid_bench.converged(b.float(), 1e-6, r(0.92), 60, 60)


def _stalled(niters):
    """A solver that stops at its cap far above tolerance."""
    def solve(*a, **kw):
        f = a[1] if torch.is_tensor(a[1]) else a[0]
        return torch.zeros_like(f), f.new_tensor(1.0), niters
    return solve


@pytest.mark.parametrize("mode", ["sweep", "workprec"])
def test_multigrid_bench_writes_no_unconverged_row(mode, tmp_path, monkeypatch, capsys):
    """A configuration that stops at its iteration cap above tolerance is
    printed, writes no row and makes main() return 1, as a failed one does;
    the other configurations' rows are written."""
    out = tmp_path / "mg.csv"
    if mode == "sweep":
        monkeypatch.setattr(multigrid, "mg_solve_mixed", _stalled(30))
        argv = [*CPU, "--min-k", "5", "--max-k", "5", "--solvers", "mixed,ds"]
        want = {"ds"}
    else:
        monkeypatch.setattr(krylov, "mg_pcg_ds", _stalled(60))
        argv = [*CPU, "--workprec", "--min-k", "5", "--max-k", "5", "--wp-solvers",
                "ds,mg_pcg_ds"]
        want = {"ds"}
    assert multigrid_bench.main(argv + ["--out", str(out)]) == (2 if mode == "sweep" else 1)
    assert "NOT converged" in capsys.readouterr().out
    assert {r["solver"] for r in read(out)[1]} == want


@pytest.mark.parametrize("module, target, argv", [
    ("multigrid_bench", (multigrid, "mg_solve_ds"),
     ["--min-k", "5", "--max-k", "5", "--max-l", "2", "--solvers", "ds"]),
    ("part1_benchmark", (diffusion3d, "solve"), ["--max-e", "4", "--reps", "1"]),
    ("ns_timestepping", (navier_stokes, "simulate_fast"),
     ["--small", "--solver", "fast", "--Pr", "0.01", "--betas", "0.0"]),
], ids=lambda v: v if isinstance(v, str) else None)
@pytest.mark.filterwarnings("ignore:'fpr_tpu_torch.experiments.*found in sys.modules")
def test_failed_configuration_exits_1(module, target, argv, tmp_path, monkeypatch, capsys):
    """A sweep prints a configuration that raised, writes no row for it and
    exits 1 when run as a script, so run_all_torch.sh sees the lost row."""
    import runpy
    import sys

    def fail(*a, **kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(*target, fail)
    out = tmp_path / "x.csv"
    monkeypatch.setattr(sys, "argv", [module, *CPU, *argv, "--out", str(out)])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"fpr_tpu_torch.experiments.{module}", run_name="__main__")
    assert e.value.code == 1
    assert "FAILED RuntimeError: out of memory" in capsys.readouterr().out
    assert not out.exists()


def test_ns_timestepping(tmp_path, monkeypatch):
    out = tmp_path / "ns.csv"
    argv = [*CPU, "--small", "--solver", "fast", "--Pr", "0.01", "--betas", "0.0,0.5",
            "--max-steps", "4", "--reps", "2", "--s-tol-factor", "100", "--out", str(out)]
    ns_timestepping.main(argv)
    header, rows = read(out)
    check_columns("ns_timestepping", header)
    assert [(r["beta"], r["solver"], r["nx"], r["ny"], r["reps"]) for r in rows] == \
        [(b, "fast_stol100", "513", "129", "2") for b in ("0.0", "0.5")]
    for r, beta in zip(rows, (0.0, 0.5)):
        cfg = NSConfig(nx=513, ny=129, Pr=0.01, beta=beta, ttot=0.005, tol=1e-7,
                       s_tol_factor=100.0)
        direct = navier_stokes.simulate_fast(cfg, max_steps=4, device="cpu")
        assert (int(r["steps"]), int(r["timed_steps"])) == (direct.steps, direct.timed_iters)
    calls = count_calls(monkeypatch, navier_stokes, "simulate_fast")
    ns_timestepping.main(argv)
    assert not calls and read(out)[1] == rows


def test_ns_timestepping_host_loop(tmp_path):
    out = tmp_path / "ns.csv"
    ns_timestepping.main([*CPU, "--small", "--solver", "mixed", "--Pr", "0.1", "--betas", "0.5",
                          "--ttot", "1", "--max-steps", "2", "--out", str(out)])
    (r,) = read(out)[1]
    assert (r["solver"], r["steps"], r["reps"]) == ("mixed", "2", "1")


@pytest.mark.parametrize("argv,msg", [
    (["--solver", "fast", "--s-tol-factor", "0"], "must be > 0"),
    (["--solver", "fast", "--s-tol-factor", "-1"], "must be > 0"),
    (["--solver", "direct", "--s-tol-factor", "10"], "fast tier"),
    (["--solver", "fast", "--f64"], "float32"),
    (["--solver", "mixed", "--mg-dst", "257"], "fast tier only"),
])
def test_ns_timestepping_refuses(tmp_path, argv, msg):
    with pytest.raises(SystemExit, match=msg):
        ns_timestepping.main([*CPU, *argv, "--out", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()


def _dist_rhs(n=2049):
    """dist_mg_large's right-hand side: numpy's float32 draw from seed 0."""
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2), np.float32)
    return b


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """dist_mg_large at k=11 on 2 row shards and on a 2x2 mesh, into one CSV,
    and the direct sharded solve of the same rhs."""
    out = tmp_path_factory.mktemp("dist") / "dist.csv"
    for argv in (["--devices", "2"], ["--devices", "4", "--mesh", "2x2"]):
        dist_mg_large.main([*CPU, "--k", "11", "--out", str(out), *argv])
    direct = dist_mg_ds.mg_solve_ds_sharded(
        torch.from_numpy(_dist_rhs()), 1 / 2048, 0.0, 1e-6, 20,
        make_mesh((2,), ("y",), device="cpu"),
        cfg=MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST))
    return read(out), direct


def test_dist_mg_large(dist_runs):
    (header, rows), (_, _, it) = dist_runs
    check_columns("dist_mg_large", header)
    assert [(r["mesh"], r["devices"]) for r in rows] == [("2x1", "2"), ("2x2", "4")]
    for r in rows:
        assert (r["backend"], r["device"], r["device_peak_gb"]) == ("cpu-virtual", "cpu", "")
        assert float(r["true_rel_residual"]) < 2e-6 and int(r["iters"]) == it


def test_dist_mg_large_residual_matches_numpy(dist_runs):
    """The row-blocked true residual against a whole-grid float64 numpy one."""
    _, ((hi, lo), _, _) = dist_runs
    b, h = _dist_rhs(), 1 / 2048
    u = hi.double().numpy() + lo.double().numpy()
    res = np.zeros_like(u)
    res[1:-1, 1:-1] = (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
                       - 4 * u[1:-1, 1:-1]) / h**2 - b[1:-1, 1:-1]
    want = np.sqrt((res**2).mean()) / np.sqrt((b.astype(np.float64) ** 2).mean())
    assert poisson.true_rel_residual(hi, lo, torch.from_numpy(b), h) == \
        pytest.approx(want, rel=1e-12)


def test_dist_mg_large_outer_count_matches_jax(dist_runs):
    """JAX's single-device ds solve on the same rhs: the sharded tiers keep
    its outer count (tests/test_dist_mg.py)."""
    from fpr_tpu.core.config import CoarseSolver as JCoarse
    from fpr_tpu.core.config import MGConfig as JMG

    (_, rows), _ = dist_runs
    _, _, jit_ = jmg.mg_solve_ds(None, _dist_rhs(), 1 / 2048, 0.0, 1e-6, 20,
                                 cfg=JMG(coarse_size=513, coarse_solver=JCoarse.DST),
                                 return_pair=True)
    assert [int(r["iters"]) for r in rows] == [int(jit_)] * 2


@pytest.mark.parametrize("module", [part1_benchmark, part1_error_experiments, part1_scaling,
                                    multigrid_bench, ns_timestepping, dist_mg_large],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_no_card_no_fallback(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--mode", "grid"] if module is part1_error_experiments else []
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv + ["--out", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()


def test_default_out_is_the_ports_directory():
    for module in (part1_benchmark, part1_scaling, ns_timestepping, dist_mg_large):
        text = Path(module.__file__).read_text()
        assert "benchmark-results/" not in text.replace("benchmark-results-torch", "")


def test_run_all_torch_invokes_no_jax_module():
    text = (REPO / "scripts" / "run_all_torch.sh").read_text()
    code = "\n".join(ln for ln in text.splitlines() if not ln.lstrip().startswith("#"))
    assert not re.search(r"\bfpr_tpu\.", code) and "fpr_tpu.plotting" not in code
    modules = set(re.findall(r"\$EX\.(\w+)", code))
    assert modules == {"part1_benchmark", "part1_scaling", "part1_error_experiments",
                       "multigrid_bench", "ns_timestepping"}
    assert "EX=fpr_tpu_torch.experiments" in code and "benchmark-results-torch" in code


def test_run_all_torch_reports_lost_rows():
    """The multigrid rows run k = 14 (16385^2) in the process of the smaller
    grids, as a user's script would (the graph cache gives its memory back),
    and the script's exit code is 1 when any row's was not 0."""
    text = (REPO / "scripts" / "run_all_torch.sh").read_text()
    code = re.sub(r"\\\n\s*", "", text)
    calls = [ln for ln in code.splitlines() if "$EX.multigrid_bench" in ln]
    assert calls and all("--min-k 14" not in ln for ln in calls)
    assert sum("--max-k 14" in ln for ln in calls) == 3  # ds, ds_v55, workprec
    assert "[[ $rc -eq 0 ]] || failed=1" in code and code.rstrip().endswith("exit $failed")
