"""Profiling helpers (fpr_tpu/utils/profiling.py): ``trace`` is a
``torch.profiler`` window that writes a chrome trace, ``annotate`` a named
range in it, and ``WallClock`` the reference's warm-up-excluding wall
clock (part1_kernel_programming.jl:170-176); ``device_seconds`` sums the
card's time in one call.

On a card the window records CUDA activity, and a window that saw no
device event raises: the profiler is this package's only source of device
time, so a silent empty trace would read as an idle card.  View a trace
at ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(dir=None, device="cuda"):
    """Profile the block; on exit write ``dir/trace.json`` (default: under
    the temporary directory).  Yields the ``torch.profiler.profile``.  With
    a CUDA device the window records the card's kernels and copies, and
    raises RuntimeError if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    dir = Path(dir if dir is not None else os.path.join(tempfile.gettempdir(),
                                                         "fpr_tpu_torch_trace"))
    dir.mkdir(parents=True, exist_ok=True)
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(dir / "trace.json"))
    if on_card and device_events(prof) == 0:
        raise RuntimeError(f"trace: the profiler recorded no device event on {device}")


def device_events(prof) -> int:
    """Kernels and copies on the card in a finished profiler window."""
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


@contextlib.contextmanager
def annotate(name: str):
    """Named range in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


class WallClock:
    """Warm-up-excluding wall clock (part1_kernel_programming.jl:170-176)."""

    def __init__(self, warmup_steps: int = 3):
        self.warmup_steps = warmup_steps
        self._tic = time.time()
        self._step = 0

    def step(self):
        self._step += 1
        if self._step == self.warmup_steps:
            self._tic = time.time()

    @property
    def elapsed(self) -> float:
        return time.time() - self._tic


def device_seconds(fn, device="cuda") -> float:
    """Summed device time (kernels and copies) of one call of fn on the
    card, from torch.profiler; RuntimeError if the window saw no device
    event.  Work queued before the call is finished first.  The profiler
    does not see the kernels inside a CUDA graph's conditional nodes, so
    fn's loops run as host loops here (``core.loops.host_loops``): the
    same kernels on the same data, launched one by one."""
    from torch.profiler import ProfilerActivity, profile

    from fpr_tpu_torch.core import loops

    torch.cuda.synchronize(device)
    with loops.host_loops(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not evs:
        raise RuntimeError(f"device_seconds: the profiler recorded no device event on {device}")
    return sum(e.device_time_total for e in evs) / 1e6
