"""Each component of ``python -m fpr_tpu_torch bench`` in a fresh process
and the rows in one process, on the card, with the card's clocks beside:
the numbers behind the bench's time limits (``bench._TIMEOUTS``), its canary
envelope (``bench.CANARY_ENVELOPE_MS``) and whether a row's median from a
process of its own agrees with the same row run in one process after the
others (as the bench ran its rows before each had a process).

    python scripts/bench_components.py [--passes fresh,one,one,fresh,probe]
                                       [--canaries 5] [--quick] [--device cuda]

Passes, in the order given:

- ``fresh``: every component in the bench's order through
  ``bench._run_component`` (a fresh process each, as the bench runs them),
  its whole run in wall seconds beside its limit.  On a fresh checkout the
  first one (the canary) includes the nvcc build of the kernel library.
  ``fresh:a+b`` runs the components a and b so.
- ``one``: the rows in the bench's order, one after another in one fresh
  process (``bench._component_payload``); ``a+b+...``: those rows so, in
  that order.
- ``probe``: ``ns_explicit+ns_relaxed_s+diffusion+mg+ns_explicit+
  ns_relaxed_s``: whether the rows before them (MG's profiler window
  among them) change the NS rows.

Then the canary in ``--canaries`` more fresh processes.  nvidia-smi samples
the SM clock, power and temperature every 100 ms throughout; each run gets
their median and range over its window, and the NS runs the SM clock
second by second.

Prints a line a run, then one JSON object as its last line: the card's name
and power limit; per component the fresh runs' seconds, its limit and the
limit over the longest run; every canary reading; per row each pass's
median and iqr (seconds), and the gap between the mean of the ``one``
medians and the mean of the ``fresh`` medians beside the largest iqr.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fpr_tpu_torch import bench  # noqa: E402
from fpr_tpu_torch.utils import device as devinfo  # noqa: E402

ROWS = ("diffusion", "mg", *bench.NS_ROWS)
PROBE = ("ns_explicit", "ns_relaxed_s", "diffusion", "mg", "ns_explicit", "ns_relaxed_s")
SMI = ("nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,temperature.gpu",
       "--format=csv,noheader,nounits", "-i", "0", "-lms", "100")


def now() -> str:
    return dt.datetime.now().isoformat()


class Clocks:
    """nvidia-smi sampled in the background (no samples without it)."""

    def __init__(self):
        self.file = tempfile.TemporaryFile("w+")
        try:
            self.proc = subprocess.Popen(SMI, stdout=self.file, stderr=subprocess.DEVNULL)
        except OSError:
            self.proc = None
        self.samples = []

    def close(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait()
        self.file.seek(0)
        for line in self.file:
            parts = [p.strip() for p in line.split(",")]
            try:
                t = dt.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
                self.samples.append((t, float(parts[1]), float(parts[2]), float(parts[3])))
            except (ValueError, IndexError):
                continue
        self.file.close()

    def over(self, t0: str, t1: str, by_second=False):
        """The SM clock's median and range, median power and top temperature
        over [t0, t1]; with by_second the SM clock's median each second."""
        a, b = dt.datetime.fromisoformat(t0), dt.datetime.fromisoformat(t1)
        win = [s for s in self.samples if a <= s[0] <= b]
        if not win:
            return None
        sm = [s[1] for s in win]
        out = {"sm_mhz": [min(sm), statistics.median(sm), max(sm)],
               "power_w": statistics.median(s[2] for s in win),
               "temp_c_max": max(s[3] for s in win)}
        if by_second:
            secs = {}
            for s in win:
                secs.setdefault(int((s[0] - a).total_seconds()), []).append(s[1])
            out["sm_mhz_by_second"] = [statistics.median(v) for _, v in sorted(secs.items())]
        return out


def median_iqr(name: str, payload: dict):
    """A row payload's median seconds and iqr."""
    key = {"diffusion": "median_s", "mg": "seconds_to_tol"}.get(name, "seconds")
    return payload[key], payload["iqr_s"]


def one_process(rows, quick: bool, device) -> None:
    """The rows one after another in this process, a line each."""
    dev = devinfo.resolve(device)
    for name in rows:
        t0 = now()
        payload = bench._component_payload(name, quick, dev)
        print(json.dumps({"row": name, "t0": t0, "t1": now(), "payload": payload}), flush=True)


def run_one(rows, args) -> list[dict]:
    """``one_process`` in a fresh process: its lines."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one-process", ",".join(rows),
           "--device", args.device] + (["--quick"] if args.quick else [])
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    out = []
    for line in p.stdout.splitlines():
        if line.startswith('{"row"'):
            out.append(json.loads(line))
    if p.returncode != 0 or len(out) != len(rows):
        raise SystemExit(f"one-process pass failed ({p.returncode}):\n{p.stderr[-3000:]}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--passes", default="fresh,one,one,fresh,probe")
    p.add_argument("--canaries", type=int, default=5)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--one-process", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one_process:
        one_process(args.one_process.split(","), args.quick, args.device)
        return 0
    dev = devinfo.resolve(args.device)
    card = devinfo.card_info(dev)["nvidia_smi"]
    rows = [n for n in ROWS if not (args.quick and n.startswith("ns_"))]
    comps = [n for n in bench.COMPONENTS if not (args.quick and n.startswith("ns_"))]
    clocks = Clocks()
    runs, seconds, canaries = [], {}, []   # runs: (pass label, row, t0, t1, payload)
    try:
        for i, kind in enumerate(args.passes.split(",")):
            label = ("fresh" if kind.startswith("fresh") else
                     kind if kind in ("one", "probe") else "order") + str(i)
            if kind.startswith("fresh"):
                for name in (kind.split(":")[1].split("+") if ":" in kind else comps):
                    t0, s0 = now(), time.perf_counter()
                    payload = bench._run_component(name, args.quick, args.device)
                    seconds.setdefault(name, []).append(time.perf_counter() - s0)
                    runs.append((label, name, t0, now(), payload))
                    if name.startswith("canary"):
                        canaries.append(payload.get("ms_per_iter"))
            else:
                order = {"probe": PROBE, "one": rows}.get(kind) or kind.split("+")
                for line in run_one([n for n in order if n in rows], args):
                    runs.append((label, line["row"], line["t0"], line["t1"], line["payload"]))
            for run in runs:
                if run[0] == label:
                    print(json.dumps({"pass": label, "component": run[1], "payload": run[4]}),
                          flush=True)
        for i in range(args.canaries):
            t0 = now()
            payload = bench._run_component("canary", args.quick, args.device)
            canaries.append(payload.get("ms_per_iter"))
            runs.append(("canary", "canary", t0, now(), payload))
    finally:
        clocks.close()
    by_row = {}
    for label, name, t0, t1, payload in runs:
        if name not in rows or "error" in payload:
            continue
        med, iqr = median_iqr(name, payload)
        by_row.setdefault(name, []).append({
            "pass": label, "median_s": med, "iqr_s": iqr,
            "rep_seconds": payload.get("rep_seconds"),
            "clocks": clocks.over(t0, t1, by_second=name.startswith("ns_"))})
    gaps = {}
    for name, got in by_row.items():
        fresh = [g["median_s"] for g in got if g["pass"].startswith("fresh")]
        one = [g["median_s"] for g in got if g["pass"].startswith("one")]
        if fresh and one:
            gap = statistics.mean(one) - statistics.mean(fresh)
            widest = max(g["iqr_s"] for g in got)
            gaps[name] = {"one_minus_fresh_s": gap, "largest_iqr_s": widest,
                          "within_iqr": abs(gap) <= widest}
    print(json.dumps({
        "card": card,
        "components": {n: {"fresh_seconds": s, "limit_s": bench._TIMEOUTS[n],
                           "limit_over_longest": bench._TIMEOUTS[n] / max(s)}
                       for n, s in seconds.items()},
        "canary_ms_per_iter": canaries, "threshold_ms": bench.CANARY_HEALTHY_MS,
        "envelope_ms": list(bench.CANARY_ENVELOPE_MS), "rows": by_row, "gaps": gaps,
        "all_ran": all("error" not in r[4] for r in runs)}))
    return 0 if all("error" not in r[4] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
