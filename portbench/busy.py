"""The card's busy time in a window: CUDA events around each graph launch.

Both entries the cells drive launch their CUDA graphs through
``fpr_tpu_torch.core.loops.device_call``.  ``Busy.install`` puts a wrapper in
its place on the module (every caller looks it up there, the loops' own
``while_loop`` included) that records a pair of timing events on the current
stream around each outermost call made while the window is open: the copy of
the carry into the graph's buffers, the launch and the copies of its outputs.
A call made while a stream captures, or from inside another call, is not
bracketed.  The pairs follow each other on one stream, so their summed
``elapsed_time`` lies above 0 and within the window; the eager work between
them (the fields' set-up, the host's reads, the copies of results to the
host) counts as idle.  The profiler plays no part.

Each pair carries the unit of work it ran in, so the idle gaps between pairs
can be named: ``host_read`` between two launches of one unit,
``copy_out+init_fields`` between two units, ``init_fields`` before the first
launch and ``copy_out`` after the last.
"""

from __future__ import annotations


class Busy:
    """Brackets of ``loops.device_call`` during a window.  event(): a new
    timing event (``torch.cuda.Event(enable_timing=True)`` on the card);
    capturing(): whether the current stream captures a graph."""

    def __init__(self, loops, event=None, capturing=None):
        self.loops = loops
        self.orig = getattr(loops, "device_call", None)
        if not callable(self.orig):
            raise RuntimeError(f"{getattr(loops, '__name__', loops)!r} has no device_call to "
                               "bracket: the busy time of the window cannot be read")
        if event is None or capturing is None:
            import torch

            event = event or (lambda: torch.cuda.Event(enable_timing=True))
            capturing = capturing or torch.cuda.is_current_stream_capturing
        self.event, self.capturing = event, capturing
        self.pairs = []          # (start, end, unit)
        self.depth = 0
        self.unit = None         # the unit of work running now
        self.open = False
        self.marks = None        # events at the window's start and end

    def install(self) -> None:
        self.loops.device_call = self.call

    def uninstall(self) -> None:
        self.loops.device_call = self.orig

    def call(self, fn, carry, key=None):
        if not self.open or self.depth or self.capturing():
            return self.orig(fn, carry, key)
        start, end = self.event(), self.event()
        self.depth += 1
        start.record()
        try:
            return self.orig(fn, carry, key)
        finally:
            end.record()
            self.depth -= 1
            self.pairs.append((start, end, self.unit))

    def start(self) -> None:
        """Open the window (after the host has synchronised with the card)."""
        self.pairs, self.marks = [], [self.event()]
        self.marks[0].record()
        self.open = True

    def stop(self) -> None:
        """Close the window (before the host synchronises with the card)."""
        self.open = False
        self.marks.append(self.event())
        self.marks[1].record()

    def seconds(self) -> float:
        """The summed seconds of the bracketed calls (after a sync)."""
        if not self.pairs:
            raise RuntimeError("no call of loops.device_call was bracketed in the window: "
                               "the busy time of the window cannot be read")
        return sum(s.elapsed_time(e) for s, e, _ in self.pairs) / 1e3

    def span_seconds(self) -> float:
        """The card's seconds from the window's first event to its last."""
        return self.marks[0].elapsed_time(self.marks[1]) / 1e3

    def gaps(self) -> list:
        """[[name, seconds], ...] of every idle gap of the window, in order."""
        out, prev, prev_unit = [], self.marks[0], None
        for i, (s, e, unit) in enumerate(self.pairs):
            if i == 0:
                name = "init_fields"
            else:
                name = "host_read" if unit == prev_unit else "copy_out+init_fields"
            out.append([name, prev.elapsed_time(s) / 1e3])
            prev, prev_unit = e, unit
        out.append(["copy_out", prev.elapsed_time(self.marks[1]) / 1e3])
        return out


def idle_summary(gaps: list, most: int = 10) -> list:
    """The gaps by name, each as its sum and its longest, largest first, at
    most ``most`` entries."""
    by = {}
    for name, s in gaps:
        n, total, top = by.get(name, (0, 0.0, 0.0))
        by[name] = (n + 1, total + s, max(top, s))
    rows = []
    for name, (n, total, top) in by.items():
        rows.append([f"{name}: sum of {n}", total])
        rows.append([f"{name}: longest", top])
    return sorted(rows, key=lambda r: -r[1])[:most]
