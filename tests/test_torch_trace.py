"""The port's spans and named loop counters (fpr_tpu_torch/core/trace.py and
the counters of fpr_tpu_torch/core/loops.py) on the CPU.

- Off, the entries make no timing event and keep no record.
- The named passes equal what the entries and solvers return: the
  pseudo-time loop's passes times K are a solve's iterations, the MG outer
  loop's passes its outer count, the NS step loop's passes the steps.  On
  the ds route kernel #11's launches are the iterations too, and its hi/lo
  split and join are spans of their own.
- A captured ``unroll=2`` loop counts its WHILE and its IF passes, not the
  odd-pass fix; a warm-up pass and a capture count nothing.
- On a fake timeline (stand-in events on a clock the test moves): totals,
  self times and nesting; idle between two graph launches goes to the span
  around it; the accounting of a window closes.
- ``loops.graphs`` records each graph name's builds and launches.
"""

import collections
import types

import numpy as np
import pytest
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import loops, trace
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy, MGConfig, NSConfig
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.ops import ds3d
from fpr_tpu_torch.solvers import multigrid

NS_TINY = dict(nx=129, ny=33, Pr=0.01, ttot=0.0015)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    trace.disable()
    yield
    trace.disable()


class Tick:
    """A stand-in timing event on a clock the test moves (milliseconds)."""

    clock = [0.0]
    made = 0

    def __init__(self):
        Tick.made += 1

    def record(self):
        self.t = Tick.clock[0]

    def elapsed_time(self, end):
        return end.t - self.t


def tick(ms):
    Tick.clock[0] += ms


def passes_of(run):
    """The change in loops.passes over run()."""
    before = collections.Counter(loops.passes)
    out = run()
    return out, {k: v - before[k] for k, v in loops.passes.items() if v - before[k]}


def _ns(beta=0.0):
    return tns.simulate_fast(NSConfig(**NS_TINY, beta=beta), device="cpu")


def _diffusion(policy=ExecutionPolicy.PALLAS, k=3):
    cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.4, policy=policy, check_every=k)
    return diffusion3d.solve(cfg, device="cpu")


@pytest.mark.parametrize("entry", [_ns, _diffusion], ids=["simulate_fast", "solve"])
def test_tracing_off_makes_no_event_and_keeps_no_record(entry, monkeypatch):
    """Off, an entry makes no event (a counting stand-in for both kinds),
    keeps no span and leaves no scope open; on, the same stand-in counts."""
    monkeypatch.setattr(Tick, "made", 0)
    monkeypatch.setattr(trace, "HostEvent", Tick)
    monkeypatch.setattr(torch.cuda, "Event", Tick)
    entry()
    assert Tick.made == 0 and trace.read() is None
    assert trace._local.open == [] and trace._local.scope == []
    assert trace.span("a") is trace.span("b")  # one shared null context
    trace.enable("cpu", event=Tick)
    entry()
    record = trace.read()
    assert Tick.made > 0 and record["spans"]
    assert trace._tracer.closed == []  # read() dropped the events


@pytest.mark.parametrize("policy,k", [(ExecutionPolicy.PALLAS, 1), (ExecutionPolicy.PALLAS, 3),
                                      (ExecutionPolicy.PALLAS_DS, 1)])
def test_pseudo_time_passes_times_k_are_the_iterations(policy, k):
    r, d = passes_of(lambda: _diffusion(policy, k))
    kk = k if policy is ExecutionPolicy.PALLAS else 1
    assert d["diffusion.pseudo_time"] * kk == r.iters_total > 0


@pytest.mark.parametrize("policy,k", [(ExecutionPolicy.PALLAS, 1), (ExecutionPolicy.PALLAS, 3),
                                      (ExecutionPolicy.PALLAS_DS, 1)])
def test_ds_conversions_have_spans_of_their_own(policy, k):
    """The ds route's hi/lo split and float64 join are spans inside the
    entry's field set-up and copy-out; the float32 routes keep their spans."""
    trace.enable("cpu", event=Tick)
    _diffusion(policy, k)
    s = trace.read()["spans"]
    entry = {"diffusion.solve", "diffusion.init_fields", "diffusion.host_read",
             "diffusion.copy_out"}
    if policy is ExecutionPolicy.PALLAS_DS:
        assert set(s) == entry | {"diffusion.to_ds", "diffusion.from_ds"}
        assert s["diffusion.to_ds"]["parents"] == ["diffusion.init_fields"]
        assert s["diffusion.from_ds"]["parents"] == ["diffusion.copy_out"]
        assert s["diffusion.to_ds"]["count"] == s["diffusion.from_ds"]["count"] == 1
    else:
        assert set(s) == entry


def test_ds_launches_are_the_iterations(monkeypatch):
    """The ds route through kernel #11's CUDA wrapper, its launch replaced
    by the plain version on CPU tensors: one ``kernels.launches["ds3d"]`` and
    one pseudo-time pass an iteration, and the plain route's result."""
    plain, tensors = ds3d.ds3d_step_plain, {}

    def via_wrapper(Ht, Htau, cp, out=None):
        out = torch.empty_like(Htau) if out is None else out
        partials = torch.zeros(4)
        tensors.update((t.data_ptr(), t) for t in (Ht, Htau, out, partials))
        return ds3d._ds3d_cuda(Ht, Htau, cp, out, partials)

    def launch(ht, htau, out, partials, n, *rest):
        _, s = plain(tensors[ht], tensors[htau], rest[:10], tensors[out])
        tensors[partials].zero_()[0] = s
        return 0

    want = _diffusion(ExecutionPolicy.PALLAS_DS, 1)
    monkeypatch.setattr(ds3d, "ds3d_step_plain", via_wrapper)
    monkeypatch.setattr(kernels, "lib", lambda: types.SimpleNamespace(fpr_ds3d=launch))
    monkeypatch.setattr(kernels, "require_cuda_f32", lambda *tensors: None)
    monkeypatch.setattr(kernels, "stream", lambda t: 0)
    before = kernels.sync_launches()["ds3d"]
    r, d = passes_of(lambda: _diffusion(ExecutionPolicy.PALLAS_DS, 1))
    assert kernels.sync_launches()["ds3d"] - before == d["diffusion.pseudo_time"] == \
        r.iters_total == want.iters_total > 0
    np.testing.assert_array_equal(r.H, want.H)


def test_mg_outer_passes_equal_the_returned_count():
    ny, nx, h = 65, 129, 1.0 / 64
    f = np.random.default_rng(3).standard_normal((ny, nx)).astype(np.float32)
    tolf = 1e-6 * float(np.sqrt(np.mean(f.astype(np.float64) ** 2)))
    (u, r_rms, it), d = passes_of(lambda: multigrid.mg_solve_ds_rp(
        None, torch.tensor(f)[None], tolf, h, 0.0, 20, MGConfig(), tol=1e-6))
    assert d["outer"] == int(it) > 1


@pytest.mark.parametrize("beta", [0.0, 0.5], ids=["explicit", "semi"])
def test_ns_passes_are_named_by_their_solves(beta):
    r, d = passes_of(lambda: _ns(beta))
    assert d["ns.step"] == r.steps > 0
    assert d["ns.S.outer"] >= 1
    solves = {"ns.S.outer", "ns.T.outer", "ns.W.outer"}
    assert solves <= set(d) if beta else not ({"ns.T.outer", "ns.W.outer"} & set(d))


@pytest.fixture
def capture(monkeypatch):
    """A _Capture on the CPU whose segments capture nothing (begin and end
    do no work): the structure of a captured loop without a card."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(loops._Capture, "begin", lambda self: None)
    monkeypatch.setattr(loops._Capture, "end", lambda self: None)
    return loops._Capture(torch.device("cpu"))


def _toy(capture_or_mode, unroll=1):
    """A toy loop of 5 passes, captured or run in a loop mode; its body's
    calls."""
    calls = []

    def body(c):
        calls.append(1)
        return (c[0] + 1,)
    cond = (lambda c: c[0] < 5)
    ctx = (loops._use(capture=capture_or_mode) if isinstance(capture_or_mode, loops._Capture)
           else loops._use(mode=capture_or_mode))
    with ctx, trace.span("toys", scope=True):
        loops.while_loop(cond, body, (torch.zeros((), dtype=torch.int32),), unroll=unroll,
                         name="toy")
    return calls


def test_unroll2_counts_both_passes(capture):
    """The WHILE's and the IF's counters are the body's passes, the fix
    after an odd last pass is not; nodes run are each body's own nodes
    times its passes."""
    _, d = passes_of(lambda: _toy(capture, unroll=2))
    assert d == {}  # the capture counts nothing
    assert capture.names == ["toys.toy"] * 3 and capture.body_passes == [True, True, False]
    capture.own = [4, 3, 2]
    graph = types.SimpleNamespace(seen=[0, 0, 0], exe=object(), cap=capture,
                                  passes=torch.tensor([3, 2, 1]))
    nodes = loops.nodes_run["toys.toy"]
    _, d = passes_of(lambda: loops._Graph.fold(graph))
    assert d == {"toys.toy": 5}  # 3 WHILE passes + 2 IF passes: 5 body passes
    assert loops.nodes_run["toys.toy"] - nodes == 3 * 4 + 2 * 3 + 1 * 2
    _, d = passes_of(lambda: loops._Graph.fold(graph))
    assert d == {}  # folded once


def test_warm_up_pass_and_capture_count_nothing(capture):
    (calls, d) = passes_of(lambda: _toy("warm"))
    assert calls == [1] and d == {}
    (calls, d) = passes_of(lambda: _toy(capture))
    assert calls == [1] and d == {}
    (calls, d) = passes_of(lambda: _toy("host"))
    assert calls == [1] * 5 and d == {"toys.toy": 5}


def test_spans_record_nothing_while_quiet():
    trace.enable("cpu", event=Tick)
    with trace.quiet():
        with trace.span("ns.S", scope=True):
            assert trace.scoped("outer") == "ns.S.outer"
        with trace.span("entry"), trace.launch("g"):
            pass
    assert trace.read()["spans"] == {}


def test_self_time_and_nesting_on_a_fake_timeline():
    Tick.clock[0] = 0.0
    trace.enable("cpu", event=Tick)
    with trace.span("a"):
        tick(1)
        with trace.span("b"):
            tick(2)
            with trace.span("c"):
                tick(4)
        with trace.span("b"):
            tick(8)
        tick(16)
    tick(32)
    r = trace.read()
    s = r["spans"]
    assert s["a"]["count"] == 1 and s["a"]["total_s"] == pytest.approx(0.031)
    assert s["a"]["self_s"] == pytest.approx(0.017)  # 1 + 16
    assert s["b"]["count"] == 2 and s["b"]["total_s"] == pytest.approx(0.014)
    assert s["b"]["self_s"] == pytest.approx(0.010) and s["b"]["longest_s"] == pytest.approx(0.008)
    assert s["c"]["self_s"] == pytest.approx(0.004) == s["c"]["total_s"]
    assert r["window_s"] == pytest.approx(0.063) and r["outside_s"] == pytest.approx(0.032)
    # no graph launch: every span's time is uncovered, each ms of idle
    # counted once, on the innermost span
    assert s["a"]["uncovered_s"] == pytest.approx(0.031)
    assert sum(v["idle_s"] for v in s.values()) == pytest.approx(0.031)
    assert all(v["host_s"] >= 0.0 for v in s.values())


class _TickGraph:
    """A stand-in for loops._Graph whose launch takes 10 ms of the fake
    clock."""

    nodes, build_s, pool_bytes = 7, 0.25, 64

    def __init__(self, fn, leaves, spec, dev, name="graph"):
        self.fn = fn

    def run(self, leaves):
        tick(10)
        return self.fn(leaves)

    def close(self):
        pass


@pytest.fixture
def tick_graphs(monkeypatch):
    monkeypatch.setattr(loops, "_mode", lambda leaves: "graph")
    monkeypatch.setattr(loops, "_Graph", _TickGraph)
    monkeypatch.setattr(loops, "_cache", collections.OrderedDict())
    monkeypatch.setattr(loops, "graphs", {})
    monkeypatch.setattr(loops, "stats", dict(loops.stats))


def test_idle_between_graph_launches_goes_to_the_span_around_it(tick_graphs):
    """Two graph launches with a host span between them: the gap is the
    host span's idle, the entry keeps its own, the rest of the window is
    outside every span, and graph + idle + outside is the window."""
    Tick.clock[0] = 0.0
    trace.enable("cpu", event=Tick)
    x = [torch.ones(2)]
    with trace.span("entry"):
        tick(1)
        loops.device_call(lambda c: c, x, key=("g",))
        with trace.span("host_read"):
            tick(3)
        loops.device_call(lambda c: c, x, key=("g",))
        tick(2)
    tick(4)
    r = trace.read()
    s = r["spans"]
    assert s["graph:g"]["count"] == 2 and s["graph:g"]["total_s"] == pytest.approx(0.020)
    assert s["graph:g"]["uncovered_s"] == 0.0
    assert s["host_read"]["idle_s"] == pytest.approx(0.003)
    assert s["entry"]["uncovered_s"] == pytest.approx(0.006)
    assert s["entry"]["idle_s"] == pytest.approx(0.003)
    assert s["entry"]["self_s"] == pytest.approx(0.003)
    assert r["outside_s"] == pytest.approx(0.004)
    idle = sum(v["idle_s"] for v in s.values())
    assert s["graph:g"]["total_s"] + idle + r["outside_s"] == pytest.approx(r["window_s"])


def test_graphs_table_records_builds_and_launches(tick_graphs):
    x = [torch.ones(2)]

    def fn(c):
        return c
    loops.device_call(fn, x, key=("a", 1))
    loops.device_call(fn, x, key=("a", 1))
    loops.device_call(fn, x, key=("b",))
    fn.graph_name = "toy"  # a bare while_loop's graph: its loop's name
    loops.device_call(fn, x)
    assert loops.graphs == {
        "a": dict(builds=1, launches=2, nodes=7, build_s=0.25, pool_bytes=64),
        "b": dict(builds=1, launches=1, nodes=7, build_s=0.25, pool_bytes=64),
        "toy": dict(builds=1, launches=1, nodes=7, build_s=0.25, pool_bytes=64)}
    loops.device_call(fn, x, key=("a", 2))  # another graph of the name a
    assert loops.graphs["a"]["builds"] == 2 and loops.graphs["a"]["launches"] == 3
    assert list(loops.graphs)[-1] == "a"  # the newest build last
