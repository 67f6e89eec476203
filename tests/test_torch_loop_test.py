"""Part 1's pseudo-time loop test (``dual_time.LoopTest``): every tier's
body of ``models/diffusion3d.py`` writes it into the loop's carry, finished
in the update kernel's launch on the card for the K=1 kernel tiers (the
tested forms of #8 and #11) and by ``dual_time.loop_test_plain`` otherwise.

- On the CPU: each tier's step gives err, it and the loop's predicate
  bitwise equal to the loop body as it was before the test moved into the
  carry (the untested step, then sqrt(sumsq) dt / sqrt_n, it + K, cond),
  through the iteration where err crosses tol and through a run stopped by
  iter_max; whole solves keep that loop's per-step counts and fields; only
  the K=1 kernel tiers hand the test to their kernel's wrapper; the CUDA
  wrappers' Python side, its launch replaced by a plain emulation, counts
  one launch a pass, each carrying the test.  ``_stepper``'s routes: the
  K=1 kernel tiers carry the ping-pong pair in a loop that is not unrolled
  (the parity route), #10 keeps its loop unrolled twice and JNP its own;
  the parity route keeps the old loop's counts, err and fields whichever
  side its last pass writes, its commit the side the count picks.
- Marked ``card``: the tested kernels' fields are bitwise the untested
  ones', on the side of the pair that the count picks, their sum within
  the kernel tests' bound of ``partials.sum()``, err, it and go torch's
  formula of that sum; solves at 64^3 and 128^3 keep the counts and fields
  of the untested launch followed by the plain test; the parity route's
  counts, err and fields bitwise those of the host loops, whichever side
  its last pass writes; 2 graph nodes a pass and one launch a pass; the
  K=3 route's nodes a pass.

The file imports no JAX, so its card tests run on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m card -s tests/test_torch_loop_test.py
"""

import collections
import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import bc, loops
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.core.grid import Grid3D, outer_steps, pseudo_timestep
from fpr_tpu_torch.models import diffusion3d as d3
from fpr_tpu_torch.ops import ds3d, dual_time, stencil3d

PALLAS, PALLAS_DS, JNP = ExecutionPolicy.PALLAS, ExecutionPolicy.PALLAS_DS, ExecutionPolicy.JNP
# the kernel tests' bound on a sum folded in another order (chip_smoke.REL_SUM)
REL_SUM = 1e-5
LOOP = "diffusion.pseudo_time"


def _setup(policy, n, tol=1e-6, iter_max=100000, device="cpu", check_every=1):
    """(cfg, kw, Ht) of a solve's first physical step, as ``d3.solve``
    makes them."""
    cfg = DiffusionConfig(nx=n, ny=n, nz=n, tol=tol, iter_max=iter_max, policy=policy,
                          check_every=check_every)
    g = Grid3D(n, n, n, cfg.lx, cfg.ly, cfg.lz)
    kw = dict(dt=cfg.dt, dtau=pseudo_timestep(g.dx, g.dy, g.dz, cfg.D), dx=g.dx, dy=g.dy,
              dz=g.dz, D=cfg.D)
    ds = policy is PALLAS_DS
    Ht = bc.dirichlet_faces_3d(stencil3d.init_gaussian(
        g, torch.float64 if ds else torch.float32, device=device))
    return cfg, kw, ds3d.to_ds(Ht) if ds else Ht


# the tiers' routes: the K=1 kernel tiers, JNP and the fused K-sweep (#10)
ROUTES = {"pallas": dict(policy=PALLAS), "pallas_ds": dict(policy=PALLAS_DS),
          "jnp": dict(policy=JNP), "pallas_k3": dict(policy=PALLAS, check_every=3)}


def _sqrt_n(cfg):
    return float(np.sqrt(cfg.nx * cfg.ny * cfg.nz))


def _test(cfg, like, it0=0):
    """A LoopTest of cfg on fresh buffers: err inf, it it0, go 1."""
    return dual_time.loop_test(like, cfg.dt, _sqrt_n(cfg), cfg.tol, cfg.iter_max)(
        like.new_full((), float("inf")), torch.full((), it0, dtype=torch.int32, device=like.device),
        torch.ones((), dtype=torch.int32, device=like.device))


def _untested(cfg, kw):
    """(step(Ht, Htau) -> (Htau', sumsq), K): cfg's tier without a loop test,
    and the iterations a call makes."""
    if cfg.policy is PALLAS_DS:
        return lambda Ht, H: ds3d.dual_time_step_ds(Ht, H, **kw), 1
    if cfg.policy is JNP:
        return lambda Ht, H: stencil3d.dual_time_step(Ht, H, **kw), 1
    if cfg.check_every > 1:
        return lambda Ht, H: dual_time.dual_time_stepk(Ht, H, cfg.check_every, **kw), \
            cfg.check_every
    return lambda Ht, H: dual_time.dual_time_step(Ht, H, **kw), 1


def _three_slot_step(a, cfg, kw):
    """``d3._physical_step`` as the loop was before the test moved into the
    carry: (Htau, err, it), the untested step, err and it + K formed in the
    body, and a cond that forms the predicate."""
    Ht = a["Ht"]
    step, K = _untested(cfg, kw)
    tol, dt, sqrt_n = (Ht.new_full((), v) for v in (cfg.tol, cfg.dt, _sqrt_n(cfg)))

    def body(s):
        Htau, sumsq = step(Ht, s[0])
        return Htau, torch.sqrt(sumsq) * dt / sqrt_n, s[2] + K

    Htau, err, it = loops.while_loop(
        lambda s: (s[1] > tol) & (s[2] < cfg.iter_max), body,
        (Ht.clone(), Ht.new_full((), float("inf")),
         torch.zeros((), dtype=torch.int32, device=Ht.device)))
    return dict(Ht=Htau, err=err, it=it)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("stop", ["tol", "iter_max"])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("route", list(ROUTES))
def test_plain_tested_form_is_the_untested_body(route, n, stop):
    """Iteration by iteration from a solve's first state, the tier's step
    with its test against the untested step and the old body's err, it
    and cond."""
    cfg, kw, Ht = _setup(**ROUTES[route], n=n, iter_max=100000 if stop == "tol" else 7)
    step_a, K = _untested(cfg, kw)
    Hb, step_b, _, commit = d3._stepper(cfg, kw, Ht)
    Ha = Ht.clone()
    tol, dt, sqrt_n = (Ht.new_full((), v) for v in (cfg.tol, cfg.dt, _sqrt_n(cfg)))
    err, it = Ht.new_full((), float("inf")), torch.zeros((), dtype=torch.int32)
    test = _test(cfg, Ht)
    errs = []
    while bool(test.go):
        Ha, sumsq = step_a(Ht, Ha)
        err, it = torch.sqrt(sumsq) * dt / sqrt_n, it + K
        go = (err > tol) & (it < cfg.iter_max)
        Hb, sumsq_b = step_b(Ht, Hb, test)
        assert _same(sumsq_b, sumsq) and _same(commit(torch.empty_like(Ht), Hb, test.it), Ha)
        assert _same(test.err, err) and _same(test.it, it) and _same(test.go, go.to(torch.int32))
        errs.append(float(err))
    if stop == "tol":  # the last iteration is the one where err crosses tol
        assert len(errs) > 2 and errs[-2] > cfg.tol >= errs[-1]
    else:
        assert int(test.it) == K * len(errs) and errs[-1] > cfg.tol
        assert K * (len(errs) - 1) < cfg.iter_max <= int(test.it)


def _solve_steps(cfg, capsys, device="cpu"):
    """(per-step iterations, result) of a verbose solve."""
    capsys.readouterr()
    r = d3.solve(cfg, verbose=True, device=device)
    its = [int(m) for m in re.findall(r"^step \d+: (\d+) iters", capsys.readouterr().out, re.M)]
    return its, r


def _untested_then_plain(untested):
    """A stand-in for a tested CUDA wrapper: the untested launch on the
    side of the pair that the count picks, then the plain loop test."""
    def tested(Ht, pair, cf, test, partials=None):
        return dual_time.pair_step_plain(lambda src: untested(Ht, src, cf), pair, test)
    return tested


def _both_routes(cfg, capsys, monkeypatch, device="cpu"):
    """The per-step counts and results of cfg's solve, and of its witness:
    on the CPU the loop as it was before the test moved into the carry
    (``_three_slot_step``); on the card the tested wrappers swapped for the
    untested launch and the plain test (a ``_*_cuda`` attribute, so the
    graph is keyed apart)."""
    loops.clear_cache()
    got = _solve_steps(cfg, capsys, device)
    with monkeypatch.context() as m:
        if torch.device(device).type == "cpu":
            m.setattr(d3, "_physical_step", _three_slot_step)
        else:
            m.setattr(dual_time, "_dual_time_pair_cuda",
                      _untested_then_plain(dual_time._dual_time_cuda))
            m.setattr(ds3d, "_ds3d_pair_cuda", _untested_then_plain(ds3d._ds3d_cuda))
        loops.clear_cache()
        witness = _solve_steps(cfg, capsys, device)
    loops.clear_cache()
    return got, witness


@pytest.mark.parametrize("iter_max", [100000, 20])
@pytest.mark.parametrize("route", list(ROUTES))
def test_solve_keeps_counts_and_field(route, iter_max, capsys, monkeypatch):
    cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.6, tol=1e-7, iter_max=iter_max,
                          **ROUTES[route])
    (its, r), (its_u, r_u) = _both_routes(cfg, capsys, monkeypatch)
    assert its == its_u and len(its) == 3 and sum(its) == r.iters_total
    assert r.converged is r_u.converged is (iter_max > 20)
    np.testing.assert_array_equal(r.H, r_u.H)


def test_routing_rule(monkeypatch):
    """Every tier's body finishes a LoopTest a pass; only the K=1 kernel
    tiers (PALLAS with check_every 1, PALLAS_DS) hand it to their kernel's
    wrapper, which runs the tested form on the card."""
    made, handed = collections.Counter(), collections.Counter()
    real_test = dual_time.LoopTest

    def making(*a, **kw):
        made["tests"] += 1
        return real_test(*a, **kw)
    monkeypatch.setattr(dual_time, "LoopTest", making)
    for mod, entry in ((dual_time, "dual_time_step_pair"), (ds3d, "dual_time_step_ds_pair")):
        def counting(*a, _real=getattr(mod, entry), **kw):
            handed["tests"] += kw.get("test") is not None
            return _real(*a, **kw)
        monkeypatch.setattr(mod, entry, counting)
    small = dict(nx=12, ny=12, nz=12, ttot=0.4, tol=1e-6)
    for policy, K, kernel_test in ((PALLAS, 1, True), (PALLAS_DS, 1, True), (PALLAS, 3, False),
                                   (PALLAS, 2, False), (JNP, 1, False)):
        made.clear()
        handed.clear()
        cfg = DiffusionConfig(**small, policy=policy, check_every=K)
        p0 = loops.passes[LOOP]
        r = d3.solve(cfg, device="cpu")
        passes = loops.passes[LOOP] - p0
        assert r.converged and passes * K >= r.iters_total > 0
        # each pass's test, and each physical step's first
        assert made["tests"] == passes + outer_steps(cfg.ttot, cfg.dt)
        assert handed["tests"] == (passes if kernel_test else 0)


def _emulated_lib(tensors, tested):
    """Stand-ins of fpr_dual_time and fpr_ds3d on CPU tensors (pointers
    looked up in tensors): the plain iteration, and in the tested form the
    side of the pair (htau, out) that the count picks and the loop test of
    csrc/fpr_common.cuh's finish_test in float32, written through the
    LoopTestArgs' pointers; tested counts the launches that carried a
    LoopTest."""
    def sides(addr, htau, out):
        if addr is None:
            return tensors[htau], tensors[out]
        tested["launches"] += 1
        odd = ctypes.c_int.from_address(kernels.LoopTestArgs.from_address(addr).it).value & 1
        return (tensors[out], tensors[htau]) if odd else (tensors[htau], tensors[out])

    def finish(addr, s):
        if addr is None:
            return
        a = kernels.LoopTestArgs.from_address(addr)
        f32 = np.float32
        err = np.sqrt(f32(s)) * f32(a.dt) / f32(a.sqrt_n)
        it = ctypes.c_int.from_address(a.it).value + 1
        ctypes.c_float.from_address(a.sumsq).value = float(s)
        ctypes.c_float.from_address(a.err).value = float(err)
        ctypes.c_int.from_address(a.it).value = it
        ctypes.c_int.from_address(a.go).value = int(bool(err > f32(a.tol) and it < a.iter_max))

    def dual(ht, htau, out, partials, n, *rest):
        src, dst = sides(rest[-2], htau, out)
        _, s = dual_time.dual_time_step_plain(tensors[ht], src, rest[:6], dst)
        finish(rest[-2], s)
        return 0

    def ds(ht, htau, out, partials, n, *rest):
        src, dst = sides(rest[-2], htau, out)
        _, s = ds3d.ds3d_step_plain(tensors[ht], src, rest[:10], dst)
        finish(rest[-2], s)
        return 0
    return types.SimpleNamespace(fpr_dual_time=dual, fpr_ds3d=ds)


@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_tested_wrappers_count_a_launch_a_pass(policy, monkeypatch):
    """A solve through the tested CUDA wrapper (launches emulated on CPU
    tensors): one launch of its kernel a pseudo-time pass, each carrying
    the LoopTest, and the plain route's counts and field."""
    cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7, policy=policy)
    want = d3.solve(cfg, device="cpu")
    tensors, tested = {}, collections.Counter()
    name = "ds3d" if policy is PALLAS_DS else "dual_time"
    mod, entry = ((ds3d, "dual_time_step_ds_pair") if name == "ds3d"
                  else (dual_time, "dual_time_step_pair"))
    tested_cuda = getattr(mod, f"_{name}_pair_cuda")
    coeffs = ds3d.ds_coeffs if name == "ds3d" else dual_time.coeffs

    def via_wrapper(Ht, pair, dt, dtau, dx, dy, dz, D, *, test, partials):
        partials = torch.zeros(4)
        tensors.update((t.data_ptr(), t) for t in (Ht, pair[0], pair[1]))
        return tested_cuda(Ht, pair, coeffs(dt, dtau, dx, dy, dz, D), test, partials)
    monkeypatch.setattr(mod, entry, via_wrapper)
    monkeypatch.setattr(kernels, "lib", lambda: _emulated_lib(tensors, tested))
    for f in ("require_cuda_f32", "require_cuda"):
        monkeypatch.setattr(kernels, f, lambda *a: None)
    monkeypatch.setattr(kernels, "stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_counters", {})
    before = kernels.sync_launches()[name], loops.passes[LOOP]
    r = d3.solve(cfg, device="cpu")
    after = kernels.sync_launches()[name], loops.passes[LOOP]
    launched, passes = (b - a for a, b in zip(before, after))
    assert launched == tested["launches"] == passes == r.iters_total == want.iters_total > 0
    np.testing.assert_array_equal(r.H, want.H)


# the stop of each physical step: by tol, or by an odd or an even iter_max,
# so that the pair's last side is side 1 or side 0 (the commit's two
# branches)
STOPS = {"tol": 100000, "odd": 9, "even": 8}


def _step_results(cfg, device, monkeypatch):
    """(per-step (err, it), result) of a solve of cfg, each physical step's
    err and count as the entry reads them."""
    seen = []
    real = loops.device_call

    def recording(fn, carry, key=None):
        out = real(fn, carry, key)
        seen.append((out["err"].clone(), out["it"].clone()))
        return out
    with monkeypatch.context() as m:
        m.setattr(loops, "device_call", recording)
        r = d3.solve(cfg, device=device)
    return seen, r


def _same_steps(a, b):
    (sa, ra), (sb, rb) = a, b
    assert len(sa) == len(sb) > 0
    for (ea, ia), (eb, ib) in zip(sa, sb):
        assert _same(ea, eb) and _same(ia, ib)
    assert (ra.iters_total, ra.timed_iters, ra.converged) == \
        (rb.iters_total, rb.timed_iters, rb.converged)
    np.testing.assert_array_equal(ra.H, rb.H)


def test_stepper_routes():
    """The K=1 kernel tiers get the pair and no unroll; JNP and the fused
    K-sweep keep their routes; the commit copies the side that the count
    picks."""
    for route, unroll in (("pallas", 1), ("pallas_ds", 1), ("jnp", 1), ("pallas_k3", 2)):
        cfg, kw, Ht = _setup(**ROUTES[route], n=8)
        Htau, step, got, commit = d3._stepper(cfg, kw, Ht)
        assert got == unroll and Htau is not Ht
        if route in ("pallas", "pallas_ds"):
            assert commit is d3._commit_pair
            assert Htau.shape == (2, *Ht.shape) and _same(Htau[0], Ht)
            test = _test(cfg, Ht)
            pair, _ = step(Ht, Htau, test)
            assert pair is Htau and int(test.it) == 1 and _same(pair[0], Ht)
            assert not _same(pair[1], Ht)
        else:
            assert Htau.shape == Ht.shape and _same(Htau, Ht)
    side = torch.stack([torch.full((2, 3), 1.5), torch.full((2, 3), -2.5)])
    for it in (6, 7):
        Ht = torch.zeros(2, 3)
        out = d3._commit_pair(Ht, side, torch.tensor(it, dtype=torch.int32))
        assert out is Ht and _same(Ht, side[it & 1])


@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("route", ["pallas", "pallas_ds"])
def test_parity_route_keeps_counts_and_field(route, stop, monkeypatch):
    """Each physical step stopped by tol or by an odd or an even iter_max
    (its last pass writing side 1 or side 0 of the pair): each step's err
    and count, and the solve's counts and field, bitwise those of the loop
    as it was before the test moved into the carry (``_three_slot_step``,
    which carries the field itself)."""
    cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.6, iter_max=STOPS[stop],
                          tol=1e-10 if route == "pallas_ds" else 1e-7, **ROUTES[route])
    got = _step_results(cfg, "cpu", monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(d3, "_physical_step", _three_slot_step)
        want = _step_results(cfg, "cpu", monkeypatch)
    _same_steps(got, want)
    its = [int(it) for _, it in got[0]]
    if stop != "tol":
        assert its == [STOPS[stop]] * 3
    assert got[1].converged is (stop == "tol")


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the tested kernels and the graphs run only there")
    return torch.device("cuda")


def _pair(shape, kernel, rng, dev):
    """(Ht, Htau, coefficients, untested launch, tested launch) of a kernel
    on random fields of shape."""
    cfg, kw, _ = _setup(PALLAS, 16)
    if kernel == "dual_time":
        Ht, Hs = (torch.tensor(rng.random(shape, dtype=np.float32), device=dev) for _ in range(2))
        return (Ht, Hs, dual_time.coeffs(**kw), dual_time._dual_time_cuda,
                dual_time._dual_time_pair_cuda, dual_time.dual_time_step_plain)
    H = torch.tensor(rng.random(shape), device=dev)
    Ht = ds3d.to_ds(H)
    Hs = ds3d.to_ds(H + 1e-3 * torch.tensor(rng.standard_normal(shape), device=dev))
    return (Ht, Hs, ds3d.ds_coeffs(**kw), ds3d._ds3d_cuda, ds3d._ds3d_pair_cuda,
            ds3d.ds3d_step_plain)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(128, 128, 128), (67, 45, 130)])
@pytest.mark.parametrize("kernel", ["dual_time", "ds3d"])
def test_tested_kernel_against_untested_on_card(card, kernel, shape):
    Ht, Hs, cf, untested, tested, plain = _pair(shape, kernel, np.random.default_rng(5), card)
    out0, s0 = untested(Ht, Hs, cf)
    _, s_plain = plain(Ht, Hs, cf)
    cfg = DiffusionConfig(nx=shape[2], ny=shape[1], nz=shape[0])
    sums = []
    # go 1; go 0 by tol; go 0 by iter_max; from an odd count (side 1 read)
    # and an even one (side 0)
    for tol, iter_max in ((0.0, 10), (1e30, 10), (0.0, 6), (0.0, 7)):
        for it0 in (5, 6):
            c = dataclasses.replace(cfg, tol=tol, iter_max=iter_max)
            test = _test(c, Ht, it0=it0)
            pair = torch.full((2, *Hs.shape), float("nan"), device=card)
            pair[it0 & 1] = Hs
            got, s = tested(Ht, pair, cf, test, kernels.partials_3d(shape, card))
            assert got is pair and _same(pair[it0 & 1], Hs) and _same(pair[1 - (it0 & 1)], out0)
            for want in (s0, s_plain):
                assert abs(float(s) - float(want)) <= REL_SUM * float(want)
            want = _test(c, Ht, it0=it0)
            dual_time.loop_test_plain((None, s), want)
            assert _same(test.err, want.err) and _same(test.it, want.it)
            assert _same(test.go, want.go.to(torch.int32))
            assert int(test.it) == it0 + 1
            assert int(test.go) == (tol == 0.0 and iter_max > it0 + 1)
            sums.append(s)
    assert all(_same(s, sums[0]) for s in sums)  # reruns give the same bits
    print(f"\n{kernel} {shape}: tested sum {float(sums[0])!r}, partials.sum() {float(s0)!r}, "
          f"plain {float(s_plain)!r}")


CARD_SOLVES = {PALLAS: dict(tol=1e-6), PALLAS_DS: dict(tol=1e-10)}


@pytest.mark.card
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_solve_counts_equal_untested_route_on_card(card, policy, n, capsys, monkeypatch):
    cfg = DiffusionConfig(nx=n, ny=n, nz=n, ttot=2.0, policy=policy, **CARD_SOLVES[policy])
    (its, r), (its_u, r_u) = _both_routes(cfg, capsys, monkeypatch, device=card)
    assert its == its_u and len(its) == 10 and r.converged and r_u.converged
    np.testing.assert_array_equal(r.H, r_u.H)
    with capsys.disabled():
        print(f"\n{policy.value} {n}^3: {r.iters_total} iterations, steps {its}")


def _window(cfg, dev, name):
    """The change of the named counters over one solve of cfg, its graph
    built before: (result, passes, nodes run, launches of name)."""
    d3.solve(cfg, device=dev)
    c0, l0 = loops.counters(), kernels.sync_launches()[name]
    r = d3.solve(cfg, device=dev)
    c1, l1 = loops.counters(), kernels.sync_launches()[name]
    passes = c1["passes"][LOOP] - c0["passes"].get(LOOP, 0)
    nodes = c1["nodes_run"][LOOP] - c0["nodes_run"].get(LOOP, 0)
    return r, passes, nodes, l1 - l0


# the K=3 route's nodes a pass before its body finished a LoopTest (PERF.md,
# 512^3), and since (128^3 and 512^3): cond's four nodes gone from a pass
K3_NODES_A_PASS_BEFORE = 14.5
K3_NODES_A_PASS = 12.5
# the parity route's nodes a pass: the tested launch and the WHILE's set
# node
PARITY_NODES_A_PASS = 2


@pytest.mark.card
@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_nodes_and_tested_launches_a_pass_on_card(card, policy):
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=0.4, policy=policy,
                          **CARD_SOLVES[policy])
    name = "ds3d" if policy is PALLAS_DS else "dual_time"
    r, passes, nodes, launched = _window(cfg, card, name)
    assert passes == launched == r.iters_total > 0
    assert nodes == PARITY_NODES_A_PASS * passes
    # the fused K-sweep: one #10 call a pass, the plain test after it
    k3 = DiffusionConfig(nx=128, ny=128, nz=128, ttot=0.4, tol=1e-6, check_every=3)
    r3, passes3, nodes3, launched3 = _window(k3, card, "dual_timek")
    assert launched3 == passes3 and passes3 * 3 >= r3.iters_total > 0
    assert nodes3 / passes3 <= K3_NODES_A_PASS_BEFORE
    assert abs(nodes3 / passes3 - K3_NODES_A_PASS) < 0.05
    print(f"\n{policy.value} 128^3: {nodes / passes:.3f} nodes a pass, {launched / passes} "
          f"launches a pass; K=3 128^3: {nodes3 / passes3:.3f} nodes a pass")


@pytest.mark.card
@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_parity_route_against_host_loops_on_card(card, policy, stop, capsys, monkeypatch):
    """The parity route at 64^3, each physical step stopped by tol or by an
    odd or an even iter_max (its last pass writing side 1 or side 0): each
    step's err and count, and the solve's counts, convergence and field,
    bitwise those of the host loops; the counts, convergence and field
    those of the untested launch on the side ``pair_step_plain`` picks,
    then the plain test."""
    cfg = DiffusionConfig(nx=64, ny=64, nz=64, ttot=0.6 if stop != "tol" else 2.0,
                          policy=policy, **dict(CARD_SOLVES[policy], iter_max=STOPS[stop]))
    loops.clear_cache()
    got = _step_results(cfg, card, monkeypatch)
    loops.clear_cache()
    with loops.host_loops():
        host = _step_results(cfg, card, monkeypatch)
    _same_steps(got, host)
    _, (its_u, r_u) = _both_routes(cfg, capsys, monkeypatch, device=card)
    its = [int(it) for _, it in got[0]]
    assert its == its_u and (got[1].iters_total, got[1].converged) == (r_u.iters_total,
                                                                       r_u.converged)
    np.testing.assert_array_equal(got[1].H, r_u.H)
    if stop != "tol":
        assert its == [STOPS[stop]] * len(its)
    assert got[1].converged is (stop == "tol")
    with capsys.disabled():
        print(f"\n{policy.value} 64^3 stop {stop}: steps {its}")
