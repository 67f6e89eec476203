"""A later change adds a configuration, a traffic mix and a per-layer metric
as new files only, and the harness finds each by its name."""

import copy
import json
import shutil

from portbench import run
from portbench.tests.tiny import BENCH, Event


def test_new_config_traffic_and_metric_found_by_name(tmp_path):
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    config = json.loads((pb / "configs" / "diffusion3d_part1.json").read_text())
    config["name"] = "diffusion3d_standin"
    (pb / "configs" / "diffusion3d_standin.json").write_text(json.dumps(config))
    traffic = {"entry": "diffusion_solve", "about": "a stand-in",
               "params": {"nx": 12, "ny": 12, "nz": 12, "ttot": 0.4, "check_every": 2},
               "check_units": 2, "burn_in_s": 0.0,
               "limits": {"H_err": 1e-4, "iters_off": 2, "converged_off": 0}}
    (pb / "traffic" / "standin_tiny.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "iters_per_solve.py").write_text(
        "def read(ctx, part):\n"
        "    return sum(u['iters'] for u in ctx['units']) / len(ctx['units'])\n")
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "diffusion3d_standin", "source": "a stand-in",
                             "file": "portbench/configs/diffusion3d_standin.json",
                             "reduced": [], "why": "a stand-in"})
    bench["workloads"].append({"name": "standin_cell", "config": "diffusion3d_standin",
                               "traffic": "standin_tiny", "chips": 1, "why": "a stand-in"})
    metric = next(m for m in bench["end_to_end"] if m["name"] == "diffusion_step_ms")
    metric["workloads"].append("standin_cell")
    bench["per_layer"].append({"name": "iters_per_solve", "unit": "iters", "better": "lower",
                               "source": "program_counter", "layer": "solver",
                               "moves": "diffusion_step_ms", "workloads": ["standin_cell"]})
    for trace in (False, True):
        r = run.run_cell(bench, "standin_cell", 2**31 + 5, 0.05, trace, device="cpu",
                         log=lambda m: None, root=tmp_path, event=Event)
        assert r["correct"] is True
        if trace:
            assert r["metrics"]["iters_per_solve"]["value"] > 0
        else:
            assert set(r["metrics"]) == {"diffusion_step_ms", "setup_s"}
