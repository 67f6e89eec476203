"""The window of portbench/traced.py: the program's spans and named counters
read over a cell's window.

On the CPU each cell, cut to a tiny size, reports every metric of
``traced.METRICS`` that needs no graph with the tracer on and none with it
off (no graph runs on the CPU, so ``graph_nodes_per_step`` reads nothing
there).  Marked ``card``, at the cells' own size:

- over one stretch of each NS traffic, the named passes of the graph run
  equal those of ``loops.host_loops()``;
- in one window of each cell, the graph launches' spans lie within 0.5 % of
  busy.py's ``busy_s``, graph launches + idle by span + idle outside every
  span add up to the window within 1 %, every metric is reported, and the
  pseudo-time loop's passes times K are the diffusion units' iterations;
- a graph built with tracing on has the nodes of one built with it off.
"""

import pytest

from portbench import traced
from portbench.tests.tiny import BENCH, CELLS, TINY, Event


def tiny_window(name, tracer):
    return traced.run_window(BENCH, name, 2**31 + 11, 0.05, tracer, False, device="cpu",
                             log=lambda m: None, overrides=TINY[name], event=Event)


@pytest.mark.parametrize("name", CELLS)
def test_the_tracer_on_reports_every_metric_and_off_none(name):
    want = {m for m, cells in traced.METRICS.items()
            if name in cells and not m.startswith("graph_nodes_per_step")}
    on = tiny_window(name, True)
    assert want and set(on["metrics"]) == want
    assert all(v > 0 for v in on["metrics"].values())
    assert on["checks"]["closure_rel"] < 1e-9 and on["checks"]["graph_s"] == 0.0
    assert on["idle_rows"][0][1] >= on["idle_rows"][-1][1]
    off = tiny_window(name, False)
    assert "metrics" not in off and off["units"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_readers_read_nothing_without_the_tracer(name):
    """A window of the parent, whose program has no tracer, gives the
    readers no ctx["trace"]: each reads None and raises nothing."""
    from portbench import run

    ctx = dict(units=[{"steps": 3, "iters": 9}], window_s=1.0, busy_s=0.5)
    for m, cells in traced.METRICS.items():
        if name in cells:
            assert run.reader(m).read(ctx, m.partition(".")[2]) is None


NS_CELLS = ["ns_explicit", "ns_semi"]


@pytest.mark.card
@pytest.mark.parametrize("name", NS_CELLS)
def test_named_passes_of_the_graph_equal_the_host_loops(name, card):
    from fpr_tpu_torch.core import loops

    from portbench import run
    from portbench.common import load_module

    _, config, traffic = run.find_cell(BENCH, name)
    entry = load_module(run.ROOT / "portbench" / "drivers" / "ns_fast.py", "pb_ns_fast")
    job = entry.Job({**config["model"], **traffic["params"]}, traffic, 2**31 + 5, card)
    stretch = job.stretch()
    before = loops.counters()
    stretch()
    graph = traced.delta(loops.counters(), before)
    with loops.host_loops():
        before = loops.counters()
        stretch()
        host = traced.delta(loops.counters(), before)
    assert graph["passes"] == host["passes"]
    assert graph["passes"]["ns.step"] == int(traffic["stretch"]["steps"])
    assert graph["passes"]["ns.S.outer"] >= graph["passes"]["ns.step"]
    assert graph["nodes_run"] and not host["nodes_run"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_graph_spans_match_busy_and_the_window_closes(name, card):
    r = traced.run_window(BENCH, name, 2**31 + 9, 3.0, True, True, device=card,
                          log=lambda m: None, overrides={"traffic": {"burn_in_s": 0.0}})
    c = r["checks"]
    assert c["graph_vs_busy_rel"] <= 0.005 and c["closure_rel"] <= 0.01
    assert set(r["metrics"]) == {m for m, cells in traced.METRICS.items() if name in cells}
    if name.startswith("diffusion"):
        k = int(traced.run.find_cell(BENCH, name)[2]["params"]["check_every"])
        assert r["passes"]["diffusion.pseudo_time"] * k == r["iters"]


@pytest.mark.card
def test_a_graph_built_with_tracing_on_has_the_nodes_of_one_built_off(card):
    import numpy as np

    from fpr_tpu_torch.core import loops, trace
    from fpr_tpu_torch.core.config import NSConfig
    from fpr_tpu_torch.models import navier_stokes as ns

    cfg = NSConfig(nx=2049, ny=513, Pr=0.01, beta=0.5, ttot=0.005)
    W0 = np.random.default_rng(1).random((513, 2049))
    nodes = []
    for on in (False, True, False):
        loops.clear_cache()
        if on:
            trace.enable(card)
        ns.simulate_fast(cfg, W0=W0, max_steps=5, device=card)
        trace.disable()
        nodes.append(loops.graphs["ns_fast"]["nodes"])
    assert nodes[0] == nodes[1] == nodes[2] > 0
