"""First checks of the on-device loops on one card (core/loops.py).

    python scripts/device_loops_probe.py

Builds the kernels, then: toy loops (zero passes, nested, unroll 2, int32
counters) as graphs against the host loops; the cost a pass of the two
designs, a WHILE node against IF nodes unrolled 50 times a launch, on a
toy body; mg_solve_ds at 4097^2 and the
NS fast loop at 2049x513 for 20 steps (chunks of 1 and of 20000) as graphs
against ``loops.host_loops()``, bitwise; a forced capture failure; the
device launches counted by ``kernels.sync_launches`` beside the
profiler's.  Prints one line a check and exits 1 at the first failure.
"""

from __future__ import annotations

import ctypes
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def check(ok, msg):
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main():
    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.core import loops

    t0 = time.perf_counter()
    kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)

    # toys
    def toy(n0, limit):
        i = torch.tensor(n0, dtype=torch.int32, device=dev)
        x = torch.ones(4, dtype=torch.float32, device=dev)

        def cond(c):
            return c[0] < limit

        def body(c):
            def icond(d):
                return d[0] < 3

            def ibody(d):
                return d[0] + 1, d[1] * 1.5

            _, y = loops.while_loop(icond, ibody, (torch.zeros_like(c[0]), c[1]))
            return c[0] + 1, y + 1.0

        return loops.while_loop(cond, body, (i, x))

    for n0, limit in ((0, 5), (7, 5), (0, 1)):
        g = toy(n0, limit)
        with loops.host_loops():
            h = toy(n0, limit)
        check(same(g, h) and g[0].dtype == torch.int32,
              f"toy nested loop from {n0} to {limit}: {g[0].item()} {g[1].tolist()}")

    def pingpong(n):
        a = torch.arange(8, dtype=torch.float32, device=dev)
        bufs = (a.clone(), torch.empty_like(a))

        def body(c):
            out = bufs[1] if c[0] is bufs[0] else bufs[0]
            torch.add(c[0], 1.0, out=out)
            return out, c[1] + 1

        def run(c):
            return loops.while_loop(lambda c: c[1] < n, body, (bufs[0], c), unroll=2,
                                    donate=True)

        return loops.device_call(run, torch.zeros((), dtype=torch.int32, device=dev))

    for n in (0, 1, 2, 5, 6):
        g = pingpong(n)
        with loops.host_loops():
            h = pingpong(n)
        check(same(g, h) and int(g[1]) == n, f"unroll 2 ping-pong, {n} passes: {g[0][:3].tolist()}")

    # the two designs' cost a pass: one WHILE node over a toy body (an add on
    # a counter and on a float) against 50 guarded copies of the body a
    # graph launch
    n_pass, guards = 10000, 50

    def while_design():
        return loops.device_call(
            lambda c: loops.while_loop(lambda c: c[0] < n_pass,
                                       lambda c: (c[0] + 1, c[1] + 1.0), c),
            (torch.zeros((), dtype=torch.int32, device=dev), torch.zeros(1, device=dev)),
            key=("probe: while design",))

    # the IF design: 50 guards a graph launch, each a captured test of the
    # counter and an IF node (csrc/graph_loop.cu) over the captured body
    i = torch.zeros((), dtype=torch.int32, device=dev)
    x = torch.zeros(1, device=dev)
    pred = torch.zeros((), dtype=torch.int32, device=dev)
    pool, side = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    segs = []
    with torch.cuda.stream(side):
        for work in (lambda: pred.copy_(i < n_pass), lambda: (i.add_(1), x.add_(1.0))):
            seg = torch.cuda.CUDAGraph(keep_graph=True)
            seg.capture_begin(pool=pool)
            work()
            seg.capture_end()
            segs.append(seg)
    torch.cuda.current_stream(dev).wait_stream(side)
    lib, ref = kernels.lib(), ctypes.byref
    top, last = ctypes.c_void_p(), None
    kernels.check(lib.fpr_graph_create(ref(top)), "fpr_graph_create")
    for _ in range(guards):
        node = ctypes.c_void_p()
        kernels.check(lib.fpr_graph_add_child(top, last, segs[0].raw_cuda_graph(), ref(node)),
                      "fpr_graph_add_child")
        cond, body, handle = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_ulonglong()
        kernels.check(lib.fpr_graph_add_cond(top, node, 0, pred.data_ptr(), ref(cond), ref(body),
                                             ref(handle)), "fpr_graph_add_cond")
        kernels.check(lib.fpr_graph_add_child(body, None, segs[1].raw_cuda_graph(),
                                              ref(ctypes.c_void_p())), "fpr_graph_add_child")
        last = cond
    exe = ctypes.c_void_p()
    kernels.check(lib.fpr_graph_instantiate(top, ref(exe)), "fpr_graph_instantiate")

    def if_design():
        i.zero_()
        x.zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(n_pass // guards):
            kernels.check(lib.fpr_graph_launch(exe, stream), "fpr_graph_launch")
        return i, x

    for name, fn in (("WHILE", while_design), ("IF x50", if_design)):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(int(out[0]) == n_pass and float(out[1][0]) == n_pass,
              f"{name} design: {n_pass} passes in {dt * 1e3:.3f} ms, "
              f"{dt / n_pass * 1e6:.3f} us a pass")

    # a forced capture failure raises
    try:
        loops.while_loop(lambda c: c < 3, lambda c: c + int(c.sum().item() > -1),
                         torch.zeros((), dtype=torch.int32, device=dev))
        check(False, "a host read in a body did not raise")
    except RuntimeError as exc:
        check(True, f"a host read in a body raises: {str(exc).splitlines()[0][:100]}")
    x = torch.ones(3, device=dev) * 2
    check(float(x.sum()) == 6.0, "the stream works after the failed capture")

    # MG 4097^2
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.solvers.multigrid import mg_solve_ds

    n = 4097
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5, post_smooth=5)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    b = torch.tensor(b, device=dev)

    def mg():
        return mg_solve_ds(None, b, h, 0.0, 1e-6, 30, cfg=cfg, return_pair=True)

    t0 = time.perf_counter()
    g = mg()
    torch.cuda.synchronize()
    print(f"MG first call (capture) {time.perf_counter() - t0:.3f} s", flush=True)
    with loops.host_loops():
        hh = mg()
    check(g[2] == hh[2] == 4 and same(g[0], hh[0]) and torch.equal(g[1], hh[1]),
          f"MG 4097^2 graph == host loop: {g[2]} outers, r_rms {float(g[1]):.4e}")
    for what, fn in (("graph", mg), ("host", None)):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fn is None:
                with loops.host_loops():
                    mg()
            else:
                fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        print(f"MG 4097^2 {what}: median {sorted(ts)[2] * 1e3:.3f} ms "
              f"{[round(t * 1e3, 3) for t in ts]}", flush=True)
    kernels.reset_launches()
    mg()
    counts = {k: v for k, v in kernels.sync_launches().items() if v}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mg()
        torch.cuda.synchronize()
    evs = [(e.key, e.count) for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.device_time_total for e in prof.key_averages() if e.device_type.name == "CUDA")
    print(f"MG launches by the accounting {counts}", flush=True)
    top = sorted(evs, key=lambda e: -e[1])[:12]
    print(f"MG profiler on the graph: {sum(c for _, c in evs)} kernels, device "
          f"{dev_us / 1e3:.3f} ms; " + ", ".join(f"{k[:40]} {c}" for k, c in top), flush=True)

    # NS 20 steps
    from fpr_tpu_torch.core.config import NSConfig
    from fpr_tpu_torch.models.navier_stokes import simulate_fast

    for beta in (0.0, 0.5):
        ns = NSConfig(nx=2049, ny=513, ttot=0.005, beta=beta, Pr=0.01, tol=1e-7, niters=50)
        t0 = time.perf_counter()
        g = simulate_fast(ns, seed=0, max_steps=20, device="cuda")
        print(f"NS beta {beta} 20 steps first call {time.perf_counter() - t0:.3f} s", flush=True)
        g1 = simulate_fast(ns, seed=0, max_steps=20, chunk_steps=1, device="cuda")
        with loops.host_loops():
            hh = simulate_fast(ns, seed=0, max_steps=20, device="cuda")
        eq = all(np.array_equal(getattr(g, k), getattr(o, k)) for o in (g1, hh) for k in "TWS")
        check(eq and g.steps == g1.steps == hh.steps == 20 and g.sim_time == hh.sim_time,
              f"NS beta {beta} 20 steps: graph == chunks of 1 == host loop")
        t0 = time.perf_counter()
        g = simulate_fast(ns, seed=0, max_steps=200, device="cuda")
        print(f"NS beta {beta} 200 steps: timed {g.t_elapsed:.4f} s ({g.timed_iters} steps)",
              flush=True)
        with loops.host_loops():
            hh = simulate_fast(ns, seed=0, max_steps=200, device="cuda")
        print(f"NS beta {beta} 200 steps host loop: timed {hh.t_elapsed:.4f} s", flush=True)
    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu_torch.models import diffusion3d

    for pol, K, tol in ((ExecutionPolicy.PALLAS, 1, 1e-6), (ExecutionPolicy.PALLAS, 3, 1e-6),
                        (ExecutionPolicy.PALLAS_DS, 1, 1e-10), (ExecutionPolicy.JNP, 1, 1e-6)):
        dc = DiffusionConfig(nx=128, ny=128, nz=128, ttot=2.0, tol=tol, policy=pol,
                             check_every=K)
        t0 = time.perf_counter()
        g = diffusion3d.solve(dc, device="cuda")
        tg = time.perf_counter() - t0
        t0 = time.perf_counter()
        with loops.host_loops():
            hh = diffusion3d.solve(dc, device="cuda")
        th = time.perf_counter() - t0
        check(g.iters_total == hh.iters_total and np.array_equal(g.H, hh.H),
              f"diffusion 128^3 {pol.value} K={K}: {g.iters_total} iterations, graph {tg:.3f} s "
              f"(window {g.bench.delta_t:.3f}), host {th:.3f} s (window {hh.bench.delta_t:.3f})")
    print(f"graph stats {loops.stats}", flush=True)


if __name__ == "__main__":
    main()
