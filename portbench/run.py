"""The benchmark of fpr_tpu_torch on an NVIDIA H100: one cell, one run.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  Everything is found by name from
``BENCHMARK.json``: the cell's configuration (the file its ``configs`` entry
names), its traffic (``portbench/traffic/<traffic>.json``: the entry it
drives, the parameters it sets over the configuration's, the check's
limits), the traffic's entry (``portbench/drivers/<entry>.py``: makes the
inputs from the seed and warms up every graph the window launches, runs one
unit of work a call, compares units with the plain reference under
``portbench/reference``) and each metric's reader
(``portbench/metrics/<name>.py``, else ``<name up to its first dot>.py``).

Set-up runs from the start of this process to the start of the window, and
ends with the traffic's burn-in: units run back to back for ``burn_in_s``
seconds and are not counted.  The window starts after a sync, runs whole
units back to back until ``--seconds`` have passed, and ends after a sync.
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, with the card's busy time taken from CUDA events around
each graph launch (``portbench/busy.py``) and a breakdown.  After the window
a sample of the units, drawn from the seed, is compared with the plain
reference; every run does so.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error are the same comparisons.  A run exits
non-zero and prints no result where ``BENCHMARK.json`` or the program is
missing, where there are fewer CUDA devices than the cell asks for, where
the busy time cannot be read, and where ``jax``, ``jaxlib``, ``flax`` or
``fpr_tpu`` was loaded by the end of the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.common import PB, Reservoir, judge, load_json, load_module  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fpr_tpu")
PROGRAM = "fpr_tpu_torch"


def cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout.  The program's nvcc
    build lands in the checkout's build/fpr_tpu_torch (fpr_tpu_torch.kernels)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")


def find_cell(bench: dict, name: str, root: Path = ROOT) -> tuple:
    """(cell, configuration, traffic) of a workload of BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def reader(metric: str, root: Path = ROOT):
    """The reader of a metric: metrics/<name>.py, else metrics/<name up to
    its first dot>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = root / "portbench" / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path, f"portbench_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {metric} under {root / 'portbench'}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics BENCHMARK.json has this cell report in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the run must not load, each
    compared whole (fpr_tpu_torch is not fpr_tpu)."""
    names = {m.split(".")[0] for m in list(sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card_line(device) -> str | None:
    """nvidia-smi's name, power limit, SM clock and power draw of the card."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    index = device.index or 0
    return lines[index] if index < len(lines) else None


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", log=print, root: Path = ROOT, overrides=None,
             event=None) -> dict:
    """One run of a cell; returns the result object (without printing it).
    log: where the run's earlier lines go; root: the checkout whose
    portbench/ holds the cell's files; overrides: {"params": {...},
    "traffic": {...}} set over the cell's (tests cut a cell to a CPU's
    size); event: a stand-in for the card's timing events (tests)."""
    import torch

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.core import loops

    from portbench.breakdown import host_loop_ops
    from portbench.busy import Busy, idle_summary

    dev = torch.device(device)
    cell, config, traffic = find_cell(bench, name, root)
    overrides = overrides or {}
    traffic.update(overrides.get("traffic", {}))
    params = {**config["model"], **traffic["params"], **overrides.get("params", {})}
    driver = load_module(root / "portbench" / "drivers" / f"{traffic['entry']}.py",
                         f"portbench_driver_{traffic['entry']}")
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    captures0 = loops.stats["captures"]
    job = driver.Job(params, traffic, seed, dev)
    burn, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < float(traffic.get("burn_in_s", 0)):
        u = job.unit()
        burn.append(round(u["wall"], 4))
        del u
    sync()
    busy = None
    if trace:
        busy = Busy(loops, event=event,
                    capturing=None if on_card else (lambda: False))
        busy.install()
    launches0 = kernels.sync_launches()
    captures1 = loops.stats["captures"]
    setup_s = time.perf_counter() - T_START
    log(f"setup {setup_s:.4f} s, graphs built {captures1 - captures0}; burn-in units' walls s "
        f"{json.dumps(burn)}; card {card_line(dev)}")

    sample = Reservoir(int(traffic["check_units"]), seed)
    units = []
    sync()
    t0 = time.perf_counter()
    if busy:
        busy.start()
    while True:
        if busy:
            busy.unit = len(units)
        u = job.unit()
        answer = u.pop("answer")
        sample.offer((u, answer))
        units.append(u)
        if time.perf_counter() - t0 >= seconds:
            break
    if busy:
        busy.stop()
    sync()
    window_s = time.perf_counter() - t0
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    launches1 = kernels.sync_launches()
    in_window = loops.stats["captures"] - captures1
    log(f"window {window_s:.6f} s, {len(units)} units, graphs built inside it {in_window}; "
        f"units' walls s {json.dumps([round(u['wall'], 4) for u in units])}; "
        f"card {card_line(dev)}")

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": int(cell.get("chips", 1)), "memory_peak_bytes": memory_peak}
    breakdown = busy_s = None
    if busy:
        busy.uninstall()
        sync()
        busy_s, span = busy.seconds(), busy.span_seconds()
        if not 0.0 < busy_s <= window_s or span > window_s:
            raise RuntimeError(f"busy_s {busy_s!r} is not above 0 and within the window "
                               f"{window_s!r} (events' span {span!r})")
        gaps = busy.gaps()
        log(f"busy {busy_s:.6f} s in {len(busy.pairs)} bracketed launches; the events' span "
            f"{span:.6f} s")
        device_info.update(busy_s=busy_s, window_s=window_s)
        ops, how = (host_loop_ops(job.stretch(), dev) if on_card
                    else (None, "no profiler trace off the card"))
        log(f"breakdown: {how}")
        breakdown = {"device_ops": ops or [], "idle_gaps": idle_summary(gaps)}

    loops.clear_cache()  # the program's graphs and their pools go before the reference
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checked = sample.items
    readings = job.check([dict(u, answer=a) for u, a in checked])
    checks, failed = judge(readings, traffic["limits"])
    correct = bool(units) and failed == 0 and all(c["value"] <= c["limit"]
                                                  for c in checks.values())
    log(f"checked {len(checked)} of {len(units)} units")

    ctx = dict(cell=cell, config=config, traffic=traffic, params=params,
               kind=device_info["kind"], seed=seed, setup_s=setup_s, window_s=window_s,
               units=units, busy_s=busy_s,
               launches={k: launches1[k] - launches0.get(k, 0) for k in launches1},
               peaks=load_json(PB / "peaks.json"))
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = reader(m["name"], root).read(ctx, m["name"].partition(".")[2] or None)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    result = {"correct": correct, "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell of fpr_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def fail(msg, code=2):
        print(f"portbench: {msg}; no result", file=sys.stderr, flush=True)
        return code

    if not (ROOT / "BENCHMARK.json").is_file():
        return fail(f"no BENCHMARK.json at {ROOT}")
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        return fail(f"no {PROGRAM} package beside the benchmark at {ROOT}")
    cache_env()
    bench = load_json(ROOT / "BENCHMARK.json")
    try:
        cell, _, _ = find_cell(bench, args.workload)
    except (KeyError, OSError) as e:
        return fail(str(e))

    import torch

    chips = int(cell.get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        return fail(f"the cell needs {chips} CUDA device(s), this machine has {have}")
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          log=log)
    except RuntimeError as e:
        return fail(str(e), 3)
    bad = forbidden_modules()
    if bad:
        return fail(f"the run loaded {', '.join(bad)}", 3)
    for n, c in result["checks"].items():
        log(f"check {n} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
