"""One window of a benchmark cell with the program's own tracer on.

    python3 portbench/traced.py --workload CELL --seed N --seconds S \\
        [--tracer 0|1] [--busy 0|1]

from the root of a checkout.  The window is ``portbench/run.py``'s: the
cell's entry module makes its inputs from the seed and builds its graphs, the
traffic's burn-in runs, then whole units run back to back from a sync
until ``--seconds`` have passed, to a sync.  With ``--tracer 1`` the
program's tracer (``fpr_tpu_torch.core.trace``) is on over the window and
read at its end, with the change over the window of the named counters of
``fpr_tpu_torch.core.loops`` (``passes``, ``nodes_run``, ``graphs``); with
``--busy 1`` ``portbench/busy.py`` brackets the graph launches too, and the
checks hold the program's spans to it.  No reference runs: this reads what
the program did, ``run.py`` decides ``correct``.

``run.py`` does not turn the tracer on, and ``BENCHMARK.json`` has none of
the metrics below: this is where they are read until a ``benchmark`` change
wires the tracer into ``run.py``'s traced window (``ctx["trace"]`` as built
here) and adds them.

The last line of standard output is one JSON object: the window
(``window_s``, ``steps``, ``ms_per_step``, ``units``), the card, the
metrics of ``METRICS`` that the cell reports, read by
``portbench/metrics/<name>.py`` from ``ctx["trace"]``, the idle of the
window by span (``idle_rows``), the graphs' table, and ``checks``: the
graph launches' span seconds against busy.py's, and the window's
accounting (graph launches, idle by span, idle outside every span).
Graphs built inside the window are logged by name on standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.common import load_json, load_module  # noqa: E402

# the per-layer metrics read from the program's spans and counters, with the
# cells that report each
METRICS = {
    "graph_nodes_per_step.ns": ["ns_explicit"],
    "graph_nodes_per_step.ns_semi": ["ns_semi"],
    "s_outers_per_step.ns": ["ns_explicit"],
    "s_outers_per_step.ns_semi": ["ns_semi"],
    "helm_outers_per_step.ns_semi": ["ns_semi"],
    "entry_host_ms_per_step.diffusion_512": ["diffusion_512_k3"],
    "entry_host_ms_per_step.ns_semi": ["ns_semi"],
    "entry_host_ms_per_step.diffusion": ["diffusion_128_tol"],
}


def delta(after: dict, before: dict) -> dict:
    """The change of loops.counters() between two reads: counts that moved,
    and of each graph name that launched or was built its builds and
    launches, with its newest build's nodes, seconds and pool bytes."""
    out = {}
    for k in ("passes", "nodes_run"):
        b = before[k]
        out[k] = {n: v - b.get(n, 0) for n, v in after[k].items() if v != b.get(n, 0)}
    graphs = {}
    for n, g in after["graphs"].items():
        b = before["graphs"].get(n, dict(builds=0, launches=0))
        moved = dict(g, builds=g["builds"] - b["builds"], launches=g["launches"] - b["launches"])
        if moved["builds"] or moved["launches"]:
            graphs[n] = moved
    out["graphs"] = graphs
    return out


def idle_rows(record: dict) -> list:
    """The window's idle by the program's spans, largest first:
    ``span <name>: idle sum of k`` and ``span <name>: idle longest`` for each
    span name with idle, and the idle that no span covers."""
    rows = []
    for name, r in record["spans"].items():
        if r["idle_s"] > 0.0:
            rows.append([f"span {name}: idle sum of {r['count']}", r["idle_s"]])
            rows.append([f"span {name}: idle longest", r["idle_longest_s"]])
    rows.append(["idle covered by no span", record["outside_s"]])
    return sorted(rows, key=lambda r: -r[1])


def checks(record: dict, busy_s) -> dict:
    """The graph launches' span seconds against busy.py's busy_s (relative
    difference), and the window's accounting: graph launches + idle by
    span + idle outside every span against the window, both on the card's
    clock (relative difference)."""
    graph = sum(r["total_s"] for n, r in record["spans"].items() if n.startswith("graph:"))
    idle = sum(r["idle_s"] for r in record["spans"].values())
    out = {"graph_s": graph, "idle_in_spans_s": idle, "outside_s": record["outside_s"],
           "card_window_s": record["window_s"],
           "closure_rel": abs(graph + idle + record["outside_s"] - record["window_s"])
           / record["window_s"]}
    if busy_s:
        out.update(busy_s=busy_s, graph_vs_busy_rel=abs(graph - busy_s) / busy_s)
    return out


def run_window(bench: dict, name: str, seed: int, seconds: float, tracer: bool, busy: bool,
               *, device="cuda", log=print, root: Path = run.ROOT, overrides=None,
               event=None) -> dict:
    """One window of a cell (see the module docstring); returns the result
    object.  overrides and event as ``run.run_cell``'s."""
    import torch

    from fpr_tpu_torch.core import loops, trace

    from portbench.busy import Busy

    dev = torch.device(device)
    cell, config, traffic = run.find_cell(bench, name, root)
    overrides = overrides or {}
    traffic.update(overrides.get("traffic", {}))
    params = {**config["model"], **traffic["params"], **overrides.get("params", {})}
    entry = load_module(root / "portbench" / "drivers" / f"{traffic['entry']}.py",
                        f"portbench_entry_{traffic['entry']}")
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    job = entry.Job(params, traffic, seed, dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < float(traffic.get("burn_in_s", 0)):
        job.unit()
    bracket = None
    if busy:
        bracket = Busy(loops, event=event, capturing=None if on_card else (lambda: False))
        bracket.install()
    before = loops.counters()
    units = []
    sync()
    if tracer:
        trace.enable(dev, event=event)
    if bracket:
        bracket.start()
    t0 = time.perf_counter()
    while True:
        if bracket:
            bracket.unit = len(units)
        u = job.unit()
        u.pop("answer")
        units.append(u)
        if time.perf_counter() - t0 >= seconds:
            break
    if bracket:
        bracket.stop()
    sync()
    window_s = time.perf_counter() - t0
    record = trace.read() if tracer else None
    trace.disable()
    moved = delta(loops.counters(), before)
    busy_s = None
    if bracket:
        bracket.uninstall()
        busy_s = bracket.seconds()
    built = {n: g["builds"] for n, g in moved["graphs"].items() if g["builds"]}
    steps = sum(u["steps"] for u in units)
    log(f"window {window_s:.6f} s, {len(units)} units, {steps} steps; graphs built inside it "
        f"{json.dumps(built)}; card {run.card_line(dev)}")

    result = {"workload": name, "seed": seed, "tracer": tracer, "window_s": window_s,
              "units": len(units), "steps": steps, "ms_per_step": 1e3 * window_s / steps,
              "iters": sum(u.get("iters", 0) for u in units),
              "device": torch.cuda.get_device_name(dev) if on_card else dev.type,
              "card": run.card_line(dev), "graphs": moved["graphs"], "busy_s": busy_s}
    if record is not None:
        ctx = dict(cell=cell, params=params, window_s=window_s, units=units, busy_s=busy_s,
                   trace=dict(record, **moved))
        metrics = {}
        for m, cells in METRICS.items():
            if name in cells:
                value = run.reader(m, root).read(ctx, m.partition(".")[2] or None)
                if value is not None:
                    metrics[m] = value
        result.update(metrics=metrics, idle_rows=idle_rows(record),
                      checks=checks(record, busy_s), passes=moved["passes"],
                      nodes_run=moved["nodes_run"], spans=record["spans"])
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One window of a cell with the program's "
                                             "tracer on.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--busy", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench/traced.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = load_json(ROOT / "BENCHMARK.json")
    result = run_window(bench, args.workload, args.seed, args.seconds, bool(args.tracer),
                        bool(args.busy), log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
