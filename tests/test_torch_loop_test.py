"""Part 1's pseudo-time loop test finished in the update kernel's launch:
the tested forms of #8 and #11 (``dual_time.LoopTest``) and the route of
``models/diffusion3d.py`` that runs them (``_tested``).

- On the CPU: the tested form's plain version gives err, it and the loop's
  predicate bitwise equal to the untested body (the step, then
  sqrt(sumsq) dt / sqrt_n, it + 1, cond), through the iteration where err
  crosses tol and through a run stopped by iter_max; whole solves keep
  their per-step counts and fields; PALLAS with check_every > 1 (the 512^3
  cell's tier) and JNP keep the untested body; the CUDA wrappers' Python
  side, its launch replaced by a plain emulation, counts one launch and one
  tested launch a pass.
- Marked ``card``: the tested kernels' fields are bitwise the untested
  ones', their sum within the kernel tests' bound of ``partials.sum()``,
  err, it and go torch's formula of that sum; solves at 64^3 and 128^3
  keep the untested route's per-step counts; at most 5 graph nodes a pass,
  and one tested launch a pass.

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
from fpr_tpu_torch.core.grid import Grid3D, pseudo_timestep
from fpr_tpu_torch.models import diffusion3d as d3
from fpr_tpu_torch.ops import ds3d, dual_time, stencil3d

PALLAS, PALLAS_DS, JNP = ExecutionPolicy.PALLAS, ExecutionPolicy.PALLAS_DS, ExecutionPolicy.JNP
# the kernel tests' bound on a sum folded in another order (chip_smoke.REL_SUM)
REL_SUM = 1e-5
LOOP = "diffusion.pseudo_time"


def _setup(policy, n, tol=1e-6, iter_max=100000, device="cpu"):
    """(cfg, kw, Ht) of a solve's first physical step, as ``d3.solve``
    makes them."""
    cfg = DiffusionConfig(nx=n, ny=n, nz=n, tol=tol, iter_max=iter_max, policy=policy)
    g = Grid3D(n, n, n, cfg.lx, cfg.ly, cfg.lz)
    kw = dict(dt=cfg.dt, dtau=pseudo_timestep(g.dx, g.dy, g.dz, cfg.D), dx=g.dx, dy=g.dy,
              dz=g.dz, D=cfg.D)
    ds = policy is PALLAS_DS
    Ht = bc.dirichlet_faces_3d(stencil3d.init_gaussian(
        g, torch.float64 if ds else torch.float32, device=device))
    return cfg, kw, ds3d.to_ds(Ht) if ds else Ht


def _test(cfg, like, it0=0):
    """A LoopTest of cfg on fresh buffers: err inf, it it0, go 1."""
    return dual_time.LoopTest(
        like.new_full((), float("inf")), torch.full((), it0, dtype=torch.int32, device=like.device),
        torch.ones((), dtype=torch.int32, device=like.device), dt=cfg.dt,
        sqrt_n=float(np.sqrt(cfg.nx * cfg.ny * cfg.nz)), tol=cfg.tol, iter_max=cfg.iter_max)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("stop", ["tol", "iter_max"])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_plain_tested_form_is_the_untested_body(policy, n, stop):
    """Iteration by iteration from a solve's first state, the tested step
    against the untested step and the untested loop's err, it and cond."""
    cfg, kw, Ht = _setup(policy, n, iter_max=100000 if stop == "tol" else 7)
    Ha, step_a, _ = d3._stepper(cfg, kw, Ht)
    Hb, step_b, _ = d3._stepper(cfg, kw, Ht)
    tol, dt, sqrt_n = (Ht.new_full((), v) for v in (
        cfg.tol, cfg.dt, float(np.sqrt(cfg.nx * cfg.ny * cfg.nz))))
    err, it = Ht.new_full((), float("inf")), torch.zeros((), dtype=torch.int32)
    test = _test(cfg, Ht)
    errs = []
    while bool(test.go):
        Ha, sumsq = step_a(Ht, Ha)
        err, it = torch.sqrt(sumsq) * dt / sqrt_n, it + 1
        go = (err > tol) & (it < cfg.iter_max)
        Hb, sumsq_b = step_b(Ht, Hb, test)
        assert _same(sumsq_b, sumsq) and _same(Hb, Ha)
        assert _same(test.err, err) and _same(test.it, it) and _same(test.go, go.to(torch.int32))
        errs.append(float(err))
    if stop == "tol":  # the last iteration is the one where err crosses tol
        assert len(errs) > 2 and errs[-2] > cfg.tol >= errs[-1]
    else:
        assert int(test.it) == cfg.iter_max == len(errs) and errs[-1] > cfg.tol


def _solve_steps(cfg, capsys, device="cpu"):
    """(per-step iterations, result) of a verbose solve."""
    capsys.readouterr()
    r = d3.solve(cfg, verbose=True, device=device)
    its = [int(m) for m in re.findall(r"^step \d+: (\d+) iters", capsys.readouterr().out, re.M)]
    return its, r


def _both_routes(cfg, capsys, monkeypatch, device="cpu"):
    """The per-step counts and results of cfg's solve on the tested route
    and on the untested body."""
    assert d3._tested(cfg)
    loops.clear_cache()
    tested = _solve_steps(cfg, capsys, device)
    with monkeypatch.context() as m:
        m.setattr(d3, "_tested", lambda cfg: False)
        loops.clear_cache()
        untested = _solve_steps(cfg, capsys, device)
    loops.clear_cache()
    return tested, untested


@pytest.mark.parametrize("iter_max", [100000, 20])
@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_solve_keeps_counts_and_field(policy, iter_max, capsys, monkeypatch):
    cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.6, tol=1e-7, iter_max=iter_max,
                          policy=policy)
    (its, r), (its_u, r_u) = _both_routes(cfg, capsys, monkeypatch)
    assert its == its_u and len(its) == 3 and sum(its) == r.iters_total
    assert r.converged is r_u.converged is (iter_max > 20)
    np.testing.assert_array_equal(r.H, r_u.H)


def test_routing_rule(monkeypatch):
    """The tested body on the K=1 kernel tiers only: PALLAS with
    check_every > 1 (the fused K-sweep of the 512^3 cell) and JNP never
    make a LoopTest."""
    big = dict(nx=512, ny=512, nz=512)
    assert d3._tested(DiffusionConfig(**big, policy=PALLAS, check_every=1))
    assert d3._tested(DiffusionConfig(**big, policy=PALLAS_DS))
    assert not d3._tested(DiffusionConfig(**big, policy=PALLAS, check_every=3))
    assert not d3._tested(DiffusionConfig(**big, policy=JNP))
    made = collections.Counter()
    real = dual_time.LoopTest

    def counting(*a, **kw):
        made["tests"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(dual_time, "LoopTest", counting)
    small = dict(nx=12, ny=12, nz=12, ttot=0.4, tol=1e-6)
    for policy, K in ((PALLAS, 3), (PALLAS, 2), (JNP, 1)):
        r = d3.solve(DiffusionConfig(**small, policy=policy, check_every=K), device="cpu")
        assert r.converged and made["tests"] == 0
    r = d3.solve(DiffusionConfig(**small, policy=PALLAS), device="cpu")
    assert made["tests"] == r.iters_total > 0


def _emulated_lib(tensors):
    """Stand-ins of fpr_dual_time and fpr_ds3d on CPU tensors (pointers
    looked up in tensors): the plain iteration, and in the tested form the
    loop test of csrc/fpr_common.cuh's finish_test in float32, written
    through the LoopTestArgs' pointers."""
    def finish(addr, s):
        a = kernels.LoopTestArgs.from_address(addr)
        f32 = np.float32
        err = np.sqrt(f32(s)) * f32(a.dt) / f32(a.sqrt_n)
        it = ctypes.c_int.from_address(a.it).value + 1
        ctypes.c_float.from_address(a.sumsq).value = float(s)
        ctypes.c_float.from_address(a.err).value = float(err)
        ctypes.c_int.from_address(a.it).value = it
        ctypes.c_int.from_address(a.go).value = int(bool(err > f32(a.tol) and it < a.iter_max))
        ctypes.c_uint64.from_address(a.tested).value += 1

    def dual(ht, htau, out, partials, n, *rest):
        _, s = dual_time.dual_time_step_plain(tensors[ht], tensors[htau], rest[:6], tensors[out])
        finish(rest[-2], s)
        return 0

    def ds(ht, htau, out, partials, n, *rest):
        _, s = ds3d.ds3d_step_plain(tensors[ht], tensors[htau], rest[:10], tensors[out])
        finish(rest[-2], s)
        return 0
    return types.SimpleNamespace(fpr_dual_time=dual, fpr_ds3d=ds)


@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_tested_wrappers_count_a_launch_a_pass(policy, monkeypatch):
    """A solve through the tested CUDA wrapper (launches emulated on CPU
    tensors): one launch and one tested launch of its kernel a pseudo-time
    pass, and the plain route's counts and field."""
    cfg = DiffusionConfig(nx=16, ny=16, nz=16, ttot=0.4, tol=1e-7, policy=policy)
    want = d3.solve(cfg, device="cpu")
    tensors = {}
    name = "ds3d" if policy is PALLAS_DS else "dual_time"
    mod, entry = (ds3d, "dual_time_step_ds") if name == "ds3d" else (dual_time, "dual_time_step")
    tested_cuda = getattr(mod, f"_{'ds3d' if name == 'ds3d' else 'dual_time'}_tested_cuda")
    coeffs = ds3d.ds_coeffs if name == "ds3d" else dual_time.coeffs

    def via_wrapper(Ht, Htau, dt, dtau, dx, dy, dz, D, *, out, partials, test):
        partials = torch.zeros(4)
        tensors.update((t.data_ptr(), t) for t in (Ht, Htau, out))
        return tested_cuda(Ht, Htau, coeffs(dt, dtau, dx, dy, dz, D), test, out, partials)
    monkeypatch.setattr(mod, entry, via_wrapper)
    monkeypatch.setattr(kernels, "lib", lambda: _emulated_lib(tensors))
    for f in ("require_cuda_f32", "require_cuda"):
        monkeypatch.setattr(kernels, f, lambda *a: None)
    monkeypatch.setattr(kernels, "stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_tested", {})
    monkeypatch.setattr(kernels, "_counters", {})
    before = kernels.sync_launches()[name], kernels.tested_launches[name], loops.passes[LOOP]
    r = d3.solve(cfg, device="cpu")
    after = kernels.sync_launches()[name], kernels.tested_launches[name], loops.passes[LOOP]
    launched, tested, passes = (b - a for a, b in zip(before, after))
    assert launched == tested == passes == r.iters_total == want.iters_total > 0
    np.testing.assert_array_equal(r.H, want.H)


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
                dual_time._dual_time_tested_cuda, dual_time.dual_time_step_plain)
    H = torch.tensor(rng.random(shape), device=dev)
    Ht = ds3d.to_ds(H)
    Hs = ds3d.to_ds(H + 1e-3 * torch.tensor(rng.standard_normal(shape), device=dev))
    return (Ht, Hs, ds3d.ds_coeffs(**kw), ds3d._ds3d_cuda, ds3d._ds3d_tested_cuda,
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
    # go 1; go 0 by tol; go 0 by iter_max
    for tol, iter_max in ((0.0, 10), (1e30, 10), (0.0, 6)):
        c = dataclasses.replace(cfg, tol=tol, iter_max=iter_max)
        test = _test(c, Ht, it0=5)
        out, partials = torch.full_like(Hs, float("nan")), kernels.partials_3d(shape, card)
        got, s = tested(Ht, Hs, cf, test, out, partials)
        assert got is out and _same(out, out0)
        for want in (s0, s_plain):
            assert abs(float(s) - float(want)) <= REL_SUM * float(want)
        want = _test(c, Ht, it0=5)
        dual_time.loop_test_plain((None, s), want)
        assert _same(test.err, want.err) and _same(test.it, want.it)
        assert _same(test.go, want.go.to(torch.int32))
        assert int(test.it) == 6 and int(test.go) == (tol == 0.0 and iter_max > 6)
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
    built before: (passes, nodes run, launches of name, tested launches)."""
    d3.solve(cfg, device=dev)
    c0, l0, t0 = loops.counters(), kernels.sync_launches()[name], kernels.tested_launches[name]
    r = d3.solve(cfg, device=dev)
    c1, l1, t1 = loops.counters(), kernels.sync_launches()[name], kernels.tested_launches[name]
    passes = c1["passes"][LOOP] - c0["passes"].get(LOOP, 0)
    nodes = c1["nodes_run"][LOOP] - c0["nodes_run"].get(LOOP, 0)
    return r, passes, nodes, l1 - l0, t1 - t0


@pytest.mark.card
@pytest.mark.parametrize("policy", [PALLAS, PALLAS_DS], ids=["pallas", "pallas_ds"])
def test_nodes_and_tested_launches_a_pass_on_card(card, policy):
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=0.4, policy=policy,
                          **CARD_SOLVES[policy])
    name = "ds3d" if policy is PALLAS_DS else "dual_time"
    r, passes, nodes, launched, tested = _window(cfg, card, name)
    assert passes == launched == tested == r.iters_total > 0
    assert nodes / passes <= 5
    # the fused K-sweep keeps the untested body
    k3 = DiffusionConfig(nx=64, ny=64, nz=64, ttot=0.4, tol=1e-6, check_every=3)
    r3, passes3, _, _, tested3 = _window(k3, card, "dual_time")
    assert tested3 == 0 and passes3 * 3 >= r3.iters_total > 0
    print(f"\n{policy.value} 128^3: {nodes / passes:.3f} nodes a pass, {tested / passes} tested "
          f"launches a pass; K=3 64^3: {tested3} tested launches")
