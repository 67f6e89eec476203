"""Spans on the card's clock, off by default.

``span(name)`` marks a stretch of the program's host work, ``enable(device)``
starts recording, ``read()`` folds what was recorded by name and
``disable()`` stops:

    trace.enable("cuda")
    solve(cfg)
    record = trace.read()       # {"window_s": ..., "outside_s": ..., "spans": {...}}
    trace.disable()

- Off, ``span`` returns one shared context: no event, no record.  A span
  with ``scope=True`` still keeps its name as a scope (a list push and
  pop), which names the loops run or captured inside it
  (``core/loops.py``): ``span("ns.S", scope=True)`` around a solve whose
  loop is named ``outer`` makes that loop ``ns.S.outer``.
- On, a span records its name, the span open around it (its parent), the
  host's ``perf_counter_ns`` and a timing event on the current stream at
  its entry and exit.  ``enable`` records an anchor event right after a
  sync, so every span lies on the card's clock, the clock of the graph
  launches' own events.  On the CPU the events are host-clock stand-ins.
- During a graph's warm-up pass and its capture (``quiet()``, which
  ``core/loops.py`` holds around both) a span records nothing and only
  keeps its scope, on or off, so a graph captured with tracing on is the
  graph captured with it off.
- ``launch(name)`` is the span of one graph launch (``core/loops.py``'s
  outermost ``device_call``, named ``graph:<name>``): no scope, and the
  card time it covers is the program's busy time.

``read()`` syncs once, resolves the events and gives, for each name, the
count, the total, the self time (the total less the spans directly inside),
the longest, the card time inside that no graph launch covered
(``uncovered_s``) and the part of that no span inside covers (``idle_s``,
with its longest, ``idle_longest_s``), the host's seconds, and the names
of the spans it lay in (``parents``).  It then
drops the events, so a long run keeps no growing list.  ``window_s`` runs
from the anchor (``enable`` or the last ``read``) to the read's sync;
``outside_s`` is the card time of the window that no span covers.
"""

from __future__ import annotations

import functools
import threading
import time

GRAPH = "graph:"


class HostEvent:
    """The CPU's stand-in for ``torch.cuda.Event(enable_timing=True)``:
    ``record`` stamps the host clock, ``elapsed_time`` is in milliseconds."""

    __slots__ = ("t",)

    def record(self):
        self.t = time.perf_counter_ns()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) / 1e6


class _Local(threading.local):
    def __init__(self):
        self.scope = []   # the names of the spans open, outermost first
        self.open = []    # the recording spans open
        self.quiet = 0    # > 0 during a warm-up pass or a capture


_local = _Local()


class _Tracer:
    """What ``enable`` set up: the device, its event maker, the anchor and
    the spans closed since."""

    def __init__(self, device, event):
        import torch

        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        if event is None:
            event = (lambda: torch.cuda.Event(enable_timing=True)) if on_card else HostEvent
        self.event = event
        self.sync = (lambda: torch.cuda.synchronize(self.device)) if on_card else (lambda: None)
        self.closed = []
        self.anchor = self.mark()

    def mark(self):
        """An event recorded after a sync: the origin of the spans after it."""
        self.sync()
        e = self.event()
        e.record()
        return e


_tracer = None


class _Scope:
    """The shared context of a span that records nothing: it pops the name
    that ``span`` pushed."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        _local.scope.pop()
        return False


class _Null:
    """The shared context of a span that records nothing and is no scope."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_SCOPE, _NULL = _Scope(), _Null()


class _Span:
    __slots__ = ("name", "scoped", "tracer", "parent", "h0", "h1", "e0", "e1")

    def __init__(self, name, scoped):
        self.name, self.scoped, self.tracer = name, scoped, _tracer

    def __enter__(self):
        opened = _local.open
        self.parent = opened[-1] if opened else None
        opened.append(self)
        self.e0 = self.tracer.event()
        self.h0 = time.perf_counter_ns()
        self.e0.record()
        return self

    def __exit__(self, *exc):
        self.e1 = self.tracer.event()
        self.e1.record()
        self.h1 = time.perf_counter_ns()
        _local.open.pop()
        if self.scoped:
            _local.scope.pop()
        self.tracer.closed.append(self)
        return False


def enable(device="cuda", event=None) -> None:
    """Start recording spans on device's clock (a sync, then the anchor).
    event: a maker of timing events (tests pass stand-ins)."""
    global _tracer
    _tracer = _Tracer(device, event)


def disable() -> None:
    """Stop recording and drop what was recorded."""
    global _tracer
    _tracer = None


def span(name: str, scope: bool = False):
    """A named stretch of host work; with scope, also a scope for the names
    of the loops run or captured inside it."""
    if scope:
        _local.scope.append(name)
    if _tracer is None or _local.quiet:
        return _SCOPE if scope else _NULL
    return _Span(name, scope)


def spanned(name: str):
    """A decorator: each call of the function is the span name."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def launch(name: str):
    """The span ``graph:<name>`` of one graph launch: no scope."""
    if _tracer is None or _local.quiet:
        return _NULL
    return _Span(GRAPH + name, False)


def scoped(name: str) -> str:
    """name under the open spans' names: ``ns.S`` + ``outer`` is ``ns.S.outer``."""
    scope = _local.scope
    return ".".join((*scope, name)) if scope else name


class quiet:
    """Spans record nothing inside (a graph's warm-up pass and capture)."""

    def __enter__(self):
        _local.quiet += 1

    def __exit__(self, *exc):
        _local.quiet -= 1
        return False


def read() -> dict | None:
    """The spans closed since ``enable`` or the last read, folded by name
    (see the module docstring), or None when tracing is off.  One sync;
    the events are dropped and a new window starts at the sync."""
    if _tracer is None:
        return None
    t = _tracer
    end = t.mark()
    spans, t.closed = t.closed, []
    anchor, t.anchor = t.anchor, end
    return _fold(spans, anchor, end)


def _fold(spans: list, anchor, end) -> dict:
    """read()'s record of the closed spans between the events anchor and end."""
    ids = {id(s) for s in spans}
    dur = {id(s): s.e0.elapsed_time(s.e1) / 1e3 for s in spans}
    busy = {}                        # graph launch seconds inside each span
    for s in spans:
        if s.name.startswith(GRAPH):
            p = s.parent
            while p is not None:
                busy[id(p)] = busy.get(id(p), 0.0) + dur[id(s)]
                p = p.parent
    uncovered = {id(s): 0.0 if s.name.startswith(GRAPH) else
                 max(dur[id(s)] - busy.get(id(s), 0.0), 0.0) for s in spans}
    inner, inner_uncovered, top = {}, {}, 0.0
    for s in spans:
        p = s.parent
        if p is None or id(p) not in ids:
            top += dur[id(s)]
        else:
            inner[id(p)] = inner.get(id(p), 0.0) + dur[id(s)]
            inner_uncovered[id(p)] = inner_uncovered.get(id(p), 0.0) + uncovered[id(s)]
    out = {}
    for s in spans:
        k = id(s)
        idle = max(uncovered[k] - inner_uncovered.get(k, 0.0), 0.0)
        r = out.setdefault(s.name, dict(count=0, total_s=0.0, self_s=0.0, longest_s=0.0,
                                        uncovered_s=0.0, idle_s=0.0, idle_longest_s=0.0,
                                        host_s=0.0, parents=[]))
        r["count"] += 1
        r["total_s"] += dur[k]
        r["self_s"] += dur[k] - inner.get(k, 0.0)
        r["longest_s"] = max(r["longest_s"], dur[k])
        r["uncovered_s"] += uncovered[k]
        r["idle_s"] += idle
        r["idle_longest_s"] = max(r["idle_longest_s"], idle)
        r["host_s"] += (s.h1 - s.h0) / 1e9
        if s.parent is not None and s.parent.name not in r["parents"]:
            r["parents"].append(s.parent.name)
    window = anchor.elapsed_time(end) / 1e3
    return {"window_s": window, "outside_s": window - top, "spans": out}
