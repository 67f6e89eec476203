"""The busy accounting of portbench/busy.py against stand-in events."""

import types

import pytest

from portbench.busy import Busy, idle_summary
from portbench.tests.tiny import CELLS, Event, run_tiny


def fake_loops(work):
    """A stand-in for core.loops whose device_call runs fn (which may call
    device_call again, as a graph's build does)."""
    mod = types.SimpleNamespace(__name__="fake_loops")

    def device_call(fn, carry, key=None):
        work.append(key)
        return fn(carry)
    mod.device_call = device_call
    return mod


def test_busy_above_zero_and_within_the_span():
    work = []
    loops = fake_loops(work)
    busy = Busy(loops, event=Event, capturing=lambda: False)
    busy.install()
    busy.start()
    for unit in range(3):
        busy.unit = unit
        loops.device_call(lambda c: c, 1, "a")
        loops.device_call(lambda c: c, 1, "b")
    busy.stop()
    busy.uninstall()
    assert loops.device_call is busy.orig
    assert len(busy.pairs) == 6 and work == ["a", "b"] * 3
    assert 0 < busy.seconds() <= busy.span_seconds()
    gaps = busy.gaps()
    assert [g[0] for g in gaps] == ["init_fields", "host_read", "copy_out+init_fields",
                                    "host_read", "copy_out+init_fields", "host_read",
                                    "copy_out"]
    assert busy.seconds() + sum(s for _, s in gaps) == pytest.approx(busy.span_seconds())
    assert len(idle_summary(gaps)) <= 10


def test_no_bracket_for_nested_calls_or_while_capturing():
    work = []
    loops = fake_loops(work)
    capturing = [False]
    busy = Busy(loops, event=Event, capturing=lambda: capturing[0])
    busy.install()
    busy.start()
    loops.device_call(lambda c: loops.device_call(lambda d: d, c, "inner"), 1, "outer")
    assert len(busy.pairs) == 1 and work == ["outer", "inner"]
    capturing[0] = True
    loops.device_call(lambda c: c, 1, "captured")
    assert len(busy.pairs) == 1
    busy.stop()
    loops.device_call(lambda c: c, 1, "after")
    assert len(busy.pairs) == 1


def test_no_bracket_fails_loudly():
    busy = Busy(fake_loops([]), event=Event, capturing=lambda: False)
    busy.start()
    busy.stop()
    with pytest.raises(RuntimeError, match="no call of loops.device_call"):
        busy.seconds()


def test_missing_hook_fails_loudly():
    with pytest.raises(RuntimeError, match="no device_call"):
        Busy(types.SimpleNamespace(__name__="empty"), event=Event, capturing=lambda: False)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_busy_within_the_window(name):
    r = run_tiny(name, trace=True)
    d = r["device"]
    assert 0 < d["busy_s"] <= d["window_s"]
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps and len(gaps) <= 10 and len(r["breakdown"]["device_ops"]) <= 10
