"""The port's on-device loops (fpr_tpu_torch/core/loops.py) on the CPU.

- ``while_loop`` against ``jax.lax.while_loop`` on toy carries: a loop
  that never runs, counters, a nested loop, a dict carry, dtypes kept;
  ``unroll`` and ``donate`` change no result.
- ``simulate_fast`` with chunk_steps 1, 4 and 20000, with and without
  snapshot_steps: bitwise equal to each other within the port, within
  test_torch_navier_stokes.py's bounds of JAX's ``simulate_fast`` with the
  same arguments, and with as many device calls (``_fast_loop``, one graph
  launch each on CUDA) as JAX makes ``_fast_loop`` calls.
- Every loop body, cond and device function of the ported loops runs under
  a guard that makes host reads raise (Tensor.__bool__, __float__,
  __int__, item, cpu, numpy, tolist): on the card such a read would stop
  the body's capture, so it fails here first.
"""

import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.core.config import InitScheme as JInit
from fpr_tpu.core.config import NSConfig as JNS
from fpr_tpu.models import navier_stokes as jns
from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy,
                                       InitScheme, MGConfig, NSConfig, Restriction, Smoother)
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.models import navier_stokes as tns
from fpr_tpu_torch.solvers import krylov, multigrid

EPS32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# while_loop against jax.lax.while_loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n0, limit", [(0, 7), (9, 7), (0, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_while_loop_counts_like_jax(n0, limit, dtype):
    x0 = np.linspace(-1.0, 1.0, 5).astype(dtype)

    def jbody(c):
        return c[0] + 1, c[1] * dtype(1.5) + c[0].astype(c[1].dtype)

    want = jax.lax.while_loop(lambda c: c[0] < limit, jbody,
                              (jnp.asarray(n0, jnp.int32), jnp.asarray(x0)))

    def tbody(c):
        return c[0] + 1, c[1] * 1.5 + c[0].to(c[1].dtype)

    got = loops.while_loop(lambda c: c[0] < limit, tbody,
                           (torch.tensor(n0, dtype=torch.int32), torch.tensor(x0)))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.from_numpy(x0).dtype
    assert int(got[0]) == int(want[0]) == max(n0, limit)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=4 * np.finfo(dtype).eps)
    if n0 >= limit:  # no pass: the carry comes back as it went in
        assert np.array_equal(got[1].numpy(), x0)


def test_nested_while_loop_matches_jax():
    def run(lib, while_loop, asarray, i32):
        def body(c):
            def ibody(d):
                return d[0] + 1, d[1] * 0.5 + 1.0

            inner = while_loop(lambda d: d[0] < c[0] + 1, ibody, (c[0] * 0, c[1]))
            return c[0] + 1, inner[1] + c[2], c[2] * 2.0

        return while_loop(lambda c: c[0] < 4, body,
                          (asarray(np.int32(0), dtype=i32), asarray(np.arange(3.0)),
                           asarray(np.float64(0.25))))

    want = run(jnp, jax.lax.while_loop, jnp.asarray, jnp.int32)
    got = run(torch, loops.while_loop, torch.as_tensor, torch.int32)
    assert int(got[0]) == int(want[0]) == 4 and got[0].dtype == torch.int32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-15)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-15)


def test_dict_carry_and_options_change_nothing():
    def body(c):
        return dict(k=c["k"] + 1, v=(c["v"][0] * 2.0, c["v"][1] - 1.0), none=None)

    carry = dict(k=torch.tensor(0, dtype=torch.int32),
                 v=(torch.ones(2, dtype=torch.float32), torch.zeros(3, dtype=torch.float64)),
                 none=None)
    plain = loops.while_loop(lambda c: c["k"] < 5, body, carry)
    for kw in (dict(unroll=2), dict(donate=True), dict(unroll=2, donate=True)):
        got = loops.while_loop(lambda c: c["k"] < 5, body, carry, **kw)
        assert int(got["k"]) == 5 and got["none"] is None
        assert all(torch.equal(a, b) for a, b in zip(got["v"], plain["v"]))
    assert torch.equal(carry["v"][0], torch.ones(2))  # the input carry is not written
    assert plain["v"][1].dtype == torch.float64


def test_clear_cache_closes_every_cached_graph(monkeypatch):
    """clear_cache closes the cached graphs, least recently used first, and
    leaves the cache empty (a sweep calls it between grid sizes)."""
    closed = []

    class Graph:
        def __init__(self, name):
            self.name = name

        def close(self):
            closed.append(self.name)

    cache = loops._cache.__class__((k, Graph(k)) for k in ("a", "b", "c"))
    monkeypatch.setattr(loops, "_cache", cache)
    loops.clear_cache()
    assert closed == ["a", "b", "c"] and not loops._cache


class _FakeGraph:
    """A stand-in for loops._Graph: building one runs out of card memory
    while more than ``room`` graphs are open, and closing one is recorded."""

    room, open, closed = 3, [], []
    nodes, build_s, pool_bytes = 0, 0.0, 0

    def __init__(self, fn, leaves, spec, dev, name="new"):
        if len(_FakeGraph.open) > _FakeGraph.room:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (a stand-in)")
        self.fn, self.name = fn, name
        _FakeGraph.open.append(name)

    def run(self, leaves):
        return self.fn(leaves)

    def close(self):
        _FakeGraph.open.remove(self.name)
        _FakeGraph.closed.append(self.name)


@pytest.fixture
def fake_graphs(monkeypatch):
    """device_call on the CPU as on the card, with _FakeGraph for _Graph and
    the cache holding the graphs a, b and c, a the least recently used."""
    monkeypatch.setattr(_FakeGraph, "open", [])
    monkeypatch.setattr(_FakeGraph, "closed", [])
    monkeypatch.setattr(_FakeGraph, "room", 3)
    monkeypatch.setattr(loops, "_mode", lambda leaves: "graph")
    monkeypatch.setattr(loops, "_Graph", _FakeGraph)
    monkeypatch.setattr(loops, "stats", dict(loops.stats, reclaimed=0))
    cache = loops._cache.__class__((k, _FakeGraph(None, None, None, None, k)) for k in "abc")
    monkeypatch.setattr(loops, "_cache", cache)
    return cache


def test_device_call_closes_old_graphs_when_the_card_is_full(fake_graphs):
    """Out of card memory, a build closes the least recently used cached
    graphs one at a time, frees their pools and builds again."""
    _FakeGraph.room = 1
    out = loops.device_call(lambda leaves: leaves[0] + 1, [torch.ones(2)], key=("k",))
    assert torch.equal(out, torch.full((2,), 2.0))
    assert _FakeGraph.closed == ["a", "b"] and loops.stats["reclaimed"] == 2
    assert list(fake_graphs)[0] == "c" and len(fake_graphs) == 2  # c and the new graph


def test_device_call_raises_once_nothing_is_cached(fake_graphs):
    """A graph that does not fit on an empty card raises the card's error
    after every cached graph is closed; nothing runs elsewhere."""
    _FakeGraph.room = -1
    with pytest.raises(torch.cuda.OutOfMemoryError):
        loops.device_call(lambda leaves: leaves[0] + 1, [torch.ones(2)], key=("k",))
    assert _FakeGraph.closed == ["a", "b", "c"] and not fake_graphs


def test_reclaiming_never_closes_the_graph_it_launches(fake_graphs):
    """Out of memory in a launch or its output copies, the launched graph
    stays cached while the others close."""
    calls = []

    def launch():
        calls.append(len(fake_graphs))
        if len(fake_graphs) > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (a stand-in)")
        return "ran"

    assert loops._reclaiming(launch, keep=fake_graphs["b"]) == "ran"
    assert _FakeGraph.closed == ["a", "c"] and list(fake_graphs) == ["b"] and calls == [3, 2, 1]
    calls.clear()

    def full():
        calls.append(len(fake_graphs))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (a stand-in)")

    # once the kept graph is the only one, memory is freed once, then the
    # error is raised
    with pytest.raises(torch.cuda.OutOfMemoryError):
        loops._reclaiming(full, keep=fake_graphs["b"])
    assert list(fake_graphs) == ["b"] and calls == [1, 1]


def test_a_build_that_runs_out_of_memory_counts_no_launch(fake_graphs, monkeypatch):
    """The launches of a build's warm-up pass are taken back when the build
    runs out of card memory: only the build that fits counts its own."""

    class WarmGraph(_FakeGraph):
        def __init__(self, fn, leaves, spec, dev, name="new"):
            kernels.launches["defect"] += 1  # the warm-up pass's launch
            super().__init__(fn, leaves, spec, dev, name)

    monkeypatch.setattr(loops, "_Graph", WarmGraph)
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.KERNELS, 0))
    _FakeGraph.room = 1
    loops.device_call(lambda leaves: leaves[0] + 1, [torch.ones(2)], key=("k",))
    assert _FakeGraph.closed == ["a", "b"]  # two builds ran out, the third fit
    assert kernels.launches == dict(dict.fromkeys(kernels.KERNELS, 0), defect=1)


def test_host_loops_close_the_cache(fake_graphs):
    """Entering host_loops() closes every cached graph, so the reference
    runs have the card's memory; the host mode of a mesh's route does not."""
    with loops.host_mode():
        assert len(fake_graphs) == 3 and loops._state.mode == "host"
    with loops.host_loops():
        assert not fake_graphs and _FakeGraph.closed == ["a", "b", "c"]
        assert loops._state.mode == "host"
    assert loops._state.mode is None


@contextlib.contextmanager
def _no_collector():
    """The cyclic garbage collector off: what a cycle holds stays held."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def test_host_loop_frees_each_carry_without_the_collector():
    """A host loop's passes leave no reference cycle behind: each carry is
    freed when the next replaces it, not when the collector runs (mg_pcg_ds
    at 16385^2 on the card held 4 GiB more a pass, 78 GiB in all)."""
    seen = []

    def body(c):
        new = dict(k=c["k"] + 1, v=(c["v"][0] * 2.0, [c["v"][1][0] + 1.0]))
        seen.extend(weakref.ref(t) for t in (new["v"][0], new["v"][1][0]))
        return new

    with _no_collector():
        out = loops.while_loop(lambda c: c["k"] < 6, body,
                               dict(k=torch.tensor(0, dtype=torch.int32),
                                    v=(torch.ones(3), [torch.zeros(2)])))
        assert int(out["k"]) == 6
        assert [r() is None for r in seen[:-2]] == [True] * 10  # all but the result's
        del out
        assert all(r() is None for r in seen)


def test_flatten_and_unflatten_hold_nothing():
    """A carry through _flatten and _unflatten (each graph launch's
    outputs) is freed with its last reference, without the collector."""
    with _no_collector():
        carry = dict(a=torch.ones(2), b=(torch.zeros(3), None, [torch.ones(1)]))
        leaves, spec = loops._flatten(carry, "test")
        back = loops._unflatten([t.clone() for t in leaves], spec)
        refs = [weakref.ref(t) for t in leaves + loops._flatten(back, "test")[0]]
        assert torch.equal(back["b"][2][0], torch.ones(1)) and back["b"][1] is None
        del carry, leaves, back
        assert all(r() is None for r in refs)


def test_device_call_runs_fn_on_the_cpu():
    out = loops.device_call(lambda c: dict(s=c["a"].sum()), dict(a=torch.arange(4.0)),
                            key=("sum",))
    assert float(out["s"]) == 6.0


@pytest.mark.parametrize("bad", ["shape", "dtype", "structure"])
def test_body_must_keep_the_carry(bad):
    def body(c):
        if bad == "shape":
            return c[0] + 1, torch.zeros(3)
        if bad == "dtype":
            return c[0] + 1, c[1].double()
        return (c[0] + 1,)

    with pytest.raises(TypeError):
        loops.while_loop(lambda c: c[0] < 2, body, (torch.tensor(0, dtype=torch.int32),
                                                    torch.zeros(2)))


def test_cond_must_give_one_bool():
    with pytest.raises(TypeError):
        loops._pred(torch.zeros(2, dtype=torch.bool))
    with pytest.raises(TypeError):
        loops._pred(torch.tensor(1.0))


def test_carry_holds_tensors_only():
    with pytest.raises(TypeError):
        loops.while_loop(lambda c: c[0] < 2, lambda c: c, (torch.tensor(0), 3))


def test_donated_buffers_copy_views_and_shared_storage():
    base = torch.arange(6.0)
    own = loops._own([base, base[:3], base])
    assert own[0] is base
    assert own[1].data_ptr() != base.data_ptr() and torch.equal(own[1], base[:3])
    assert own[2] is not base and torch.equal(own[2], base)


def test_store_reads_every_new_value_before_writing():
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    loops._store([a, b], [b, a])  # a swap through the buffers themselves
    assert float(a) == 2.0 and float(b) == 1.0


# ---------------------------------------------------------------------------
# simulate_fast: chunking, snapshots, device calls against JAX's
# ---------------------------------------------------------------------------

RUNS = {
    0.0: (dict(nx=65, ny=33, ttot=1e-2, beta=0.0, Pr=0.01, tol=1e-7, niters=50), 9, 1e-5),
    0.5: (dict(nx=65, ny=33, ttot=0.1, beta=0.5, Pr=0.1, tol=1e-7, niters=50), 5, 1e-4),
}
W0 = {beta: np.random.default_rng(5).standard_normal((33, 65)) * 10.0 for beta in RUNS}


@contextlib.contextmanager
def _counted(module):
    """Count the calls of module._fast_loop."""
    calls = [0]
    orig = module._fast_loop

    def counting(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    module._fast_loop = counting
    try:
        yield calls
    finally:
        module._fast_loop = orig


@contextlib.contextmanager
def _top_level_device_calls():
    """Count the device_calls that are not inside another: graph launches."""
    calls, depth = [0], [0]
    orig = loops.device_call

    def counting(fn, carry, key=None):
        calls[0] += depth[0] == 0
        depth[0] += 1
        try:
            return orig(fn, carry, key)
        finally:
            depth[0] -= 1

    loops.device_call = counting
    try:
        yield calls
    finally:
        loops.device_call = orig


_REFERENCE = {}


def _port_run(beta, **kw):
    cfg, steps, _ = RUNS[beta]
    tc = NSConfig(W_init=InitScheme.FROM_ARRAY, **cfg)
    return tns.simulate_fast(tc, W0=W0[beta], max_steps=steps, device="cpu", **kw)


def _reference(beta):
    if beta not in _REFERENCE:
        _REFERENCE[beta] = _port_run(beta)
    return _REFERENCE[beta]


def _same(a, b):
    assert (a.steps, a.sim_time, a.timed_iters) == (b.steps, b.sim_time, b.timed_iters)
    for k in ("T", "W", "S"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo"):
        assert torch.equal(a.state[k], b.state[k]), k
    assert a.state["step"] == b.state["step"]


@pytest.mark.parametrize("snapshot_steps", [0, 4])
@pytest.mark.parametrize("chunk_steps", [1, 4, 20000])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_simulate_fast_chunks_match_jax(beta, chunk_steps, snapshot_steps):
    cfg, steps, rel = RUNS[beta]
    with _counted(tns) as port_calls, _top_level_device_calls() as launches:
        got = _port_run(beta, chunk_steps=chunk_steps, snapshot_steps=snapshot_steps)
    jc = JNS(W_init=JInit.FROM_ARRAY, **cfg)
    with _counted(jns) as jax_calls:
        want = jns.simulate_fast(jc, W0=W0[beta], max_steps=steps, chunk_steps=chunk_steps,
                                 snapshot_steps=snapshot_steps)
    assert port_calls[0] == jax_calls[0] == launches[0]
    if chunk_steps == 1:  # the warm-up's call, then one a step
        assert port_calls[0] == 1 + steps - 3
    _same(got, _reference(beta))  # bitwise whatever the chunks
    assert got.steps == want.steps == steps
    assert abs(got.sim_time - want.sim_time) <= EPS32 * want.sim_time
    for name in ("T", "W", "S"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-30), name
    if snapshot_steps:
        assert [s[4] for s in got.snapshots] == [s[4] for s in want.snapshots]
        ref = _port_run(beta, snapshot_steps=snapshot_steps).snapshots
        for s, r in zip(got.snapshots, ref):
            assert s[3] == r[3] and all(np.array_equal(a, b) for a, b in zip(s[:3], r[:3]))


# ---------------------------------------------------------------------------
# no host read in any loop body
# ---------------------------------------------------------------------------


class HostRead(AssertionError):
    pass


_GUARD = [0]
_READS = ("__bool__", "__float__", "__int__", "item", "cpu", "numpy", "tolist")


@contextlib.contextmanager
def _guarded():
    _GUARD[0] += 1
    try:
        yield
    finally:
        _GUARD[0] -= 1


@contextlib.contextmanager
def _unguarded():
    saved, _GUARD[0] = _GUARD[0], 0
    try:
        yield
    finally:
        _GUARD[0] = saved


@pytest.fixture
def no_host_reads(monkeypatch):
    """Host reads raise inside every cond, body and device function; the
    loop's own test of cond (the graph's set kernel) is allowed.  Yields the
    number of bodies and device functions that ran."""
    ran = {"cond": 0, "body": 0, "device_call": 0}
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name, **k):
            if _GUARD[0]:
                raise HostRead(f"a host read ({_name}) inside a loop body")
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, read)
    orig_loop, orig_call = loops.while_loop, loops.device_call

    def guard(fn, what):
        def run(c):
            ran[what] += 1
            with _guarded():
                return fn(c)
        return run

    def while_loop(cond, body, carry, **kw):
        with _unguarded():
            return orig_loop(guard(cond, "cond"), guard(body, "body"), carry, **kw)

    def device_call(fn, carry, key=None):
        return orig_call(guard(fn, "device_call"), carry, key)

    monkeypatch.setattr(loops, "while_loop", while_loop)
    monkeypatch.setattr(loops, "device_call", device_call)
    yield ran
    assert _GUARD[0] == 0


def _poisson(n, dtype=torch.float32, seed=3):
    b = np.zeros((n, n))
    b[1:-1, 1:-1] = np.random.default_rng(seed).random((n - 2, n - 2))
    return torch.tensor(b, dtype=dtype)


MG_CFGS = {
    "dst_stk": MGConfig(coarse_size=17, coarse_solver=CoarseSolver.DST, pre_smooth=3,
                        post_smooth=3),
    "jacobi_coarse": MGConfig(),
    "cg_coarse": MGConfig(coarse_solver=CoarseSolver.CG, coarse_size=9),
    "rbgs_rp": MGConfig(smoother=Smoother.RED_BLACK_GS),
    "full_weighting_rp": MGConfig(restriction=Restriction.FULL_WEIGHTING),
}


@pytest.mark.parametrize("name", sorted(MG_CFGS))
def test_mg_solve_ds_bodies_read_nothing(no_host_reads, name):
    u, r_rms, it = multigrid.mg_solve_ds(None, _poisson(65), 1 / 64, 0.0, 1e-6, 30,
                                         cfg=MG_CFGS[name])
    assert 1 <= it <= 30 and no_host_reads["body"] >= it


@pytest.mark.parametrize("c", [0.0, 37.0, "tensor"])
def test_mg_solve_ds_warm_bcs_read_nothing(no_host_reads, c):
    c = torch.tensor(37.0) if c == "tensor" else c
    u0 = torch.rand(33, 65, generator=torch.Generator().manual_seed(1))
    u, r_rms, it = multigrid.mg_solve_ds(u0, _poisson(65)[:33], 1 / 32, c, 1e-7, 20,
                                         apply_bcs=True)
    assert it >= 1 and no_host_reads["device_call"] >= 1


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_simulate_fast_bodies_read_nothing(no_host_reads, beta):
    cfg = NSConfig(nx=65, ny=33, ttot=0.1, beta=beta, Pr=0.1, tol=1e-7, niters=20,
                   W_init=InitScheme.FROM_ARRAY)
    out = tns.simulate_fast(cfg, W0=W0[0.0], max_steps=4, chunk_steps=2, device="cpu")
    assert out.steps == 4 and no_host_reads["body"] > 4


@pytest.mark.parametrize("policy, K", [(ExecutionPolicy.JNP, 1), (ExecutionPolicy.PALLAS, 1),
                                       (ExecutionPolicy.PALLAS, 3),
                                       (ExecutionPolicy.PALLAS_DS, 1)])
def test_diffusion_bodies_read_nothing(no_host_reads, policy, K):
    cfg = DiffusionConfig(nx=12, ny=10, nz=9, ttot=0.4, tol=1e-5, policy=policy,
                          check_every=K)
    out = diffusion3d.solve(cfg, device="cpu")
    assert out.converged and no_host_reads["device_call"] == 2


@pytest.mark.parametrize("solver", ["cg", "cg_pallas", "mg_pcg", "mg_pcg_ds",
                                    "mg_pcg_ds_kernel_dots"])
def test_krylov_bodies_read_nothing(no_host_reads, solver):
    b = _poisson(33, torch.float64)
    h = 1 / 32
    if solver == "cg":
        out = krylov.cg(b, h, h, 0.0, 1e-8, 500)
    elif solver == "cg_pallas":
        out = krylov.cg(b, h, h, 5.0, 1e-8, 500, policy=ExecutionPolicy.PALLAS)
    elif solver == "mg_pcg":
        out = krylov.mg_preconditioned_cg(b, h, 0.0, 1e-8, 50)
    else:
        dots = "kernel" if solver.endswith("kernel_dots") else "rowsum64"
        out = krylov.mg_pcg_ds(b, h, 0.0, 1e-8, 50, dots=dots)
    assert isinstance(out[2], int) and out[2] >= 1
    assert no_host_reads["body"] >= out[2]


def test_the_guard_catches_a_host_read(no_host_reads):
    with pytest.raises(HostRead):
        loops.while_loop(lambda c: c < 3, lambda c: c + int(c), torch.tensor(0))
