"""The readings that a cell's limits are set from, on the card at the cell's
own size: the program's (one unit of the cell's work for each seed, against
the plain float64 reference) and the control's (the plain reference put in
the program's place, computed in float32 with its state rounded to bfloat16,
the precision below the configurations' float32, after every step or
iteration).  The benchmark's own runs do not run it.

    python3 portbench/control.py --workload CELL --seeds 1 2 ... \
        --control-seeds 101 102 103

prints one JSON line a reading and, last, each number's largest program
reading and smallest control reading beside the cell's limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402
from portbench.common import load_json, load_module  # noqa: E402


def job_of(name: str, seed: int, device, root=run.ROOT, overrides=None, bench=None):
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    _, config, traffic = run.find_cell(bench, name, root)
    overrides = overrides or {}
    traffic.update(overrides.get("traffic", {}))
    params = {**config["model"], **traffic["params"], **overrides.get("params", {})}
    driver = load_module(root / "portbench" / "drivers" / f"{traffic['entry']}.py",
                         f"portbench_control_{traffic['entry']}")
    return driver.Job(params, traffic, seed, device), traffic


def readings(name: str, seeds, control_seeds, device, overrides=None, log=print,
             bench=None) -> dict:
    """{"program": [...], "control": [...], "limits": {...}} of a cell."""
    import torch

    from fpr_tpu_torch.core import loops

    prog, ctrl, limits = [], [], None
    for seed in seeds:
        job, traffic = job_of(name, seed, device, overrides=overrides, bench=bench)
        limits = traffic["limits"]
        u = job.unit()
        loops.clear_cache()
        r = job.check([u])[0]
        prog.append(r)
        log(json.dumps({"side": "program", "seed": seed, "wall_s": u["wall"], **r}))
        del job, u
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for seed in control_seeds:
        job, traffic = job_of(name, seed, device, overrides=overrides, bench=bench)
        limits = traffic["limits"]
        loops.clear_cache()
        r = job.control()
        ctrl.append(r)
        log(json.dumps({"side": "control", "seed": seed, **r}))
        del job
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return {"program": prog, "control": ctrl, "limits": limits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    out = readings(args.workload, args.seeds, args.control_seeds, torch.device("cuda"),
                   log=lambda m: print(m, flush=True))
    names = list(out["limits"])
    print(json.dumps({
        "workload": args.workload,
        "program_max": {n: max(r[n] for r in out["program"]) for n in names}
        if out["program"] else None,
        "control_min": {n: min(r[n] for r in out["control"]) for n in names}
        if out["control"] else None,
        "limits": out["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
