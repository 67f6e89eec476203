"""The on-device loops (``core/loops.py``) as CUDA graphs against the host
loops (``loops.host_loops()``), bitwise, on the card: toy loops that run
no pass, one pass and a nested loop; an ``unroll=2`` ping-pong loop over
even and odd pass counts, zero included; the NS fast loop in chunks of one
step against one launch of 20 steps; part 1's solves on every tier (the
K=1 kernel tiers, the fused K-sweep and JNP).  ``chip_smoke.py`` phase 22
holds the full-size runs.

All marked ``card``.  The file imports no JAX, so its tests run on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_graphs_card.py
"""

import numpy as np
import pytest
import torch

from fpr_tpu_torch.core import loops
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy, NSConfig
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.models.navier_stokes import simulate_fast


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graphs run only there")
    return torch.device("cuda")


def _graph_and_host(run):
    """run() as graphs, then as host loops."""
    g = run()
    with loops.host_loops():
        h = run()
    return g, h


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.card
@pytest.mark.parametrize("n0, limit", [(0, 5), (7, 5), (0, 1)])
def test_nested_toy_loop_graph_against_host_on_card(card, n0, limit):
    def toy():
        def body(c):
            _, y = loops.while_loop(lambda d: d[0] < 3, lambda d: (d[0] + 1, d[1] * 1.5),
                                    (torch.zeros_like(c[0]), c[1]))
            return c[0] + 1, y + 1.0

        return loops.while_loop(lambda c: c[0] < limit, body,
                                (torch.tensor(n0, dtype=torch.int32, device=card),
                                 torch.ones(4, dtype=torch.float32, device=card)))

    g, h = _graph_and_host(toy)
    assert _same(g, h) and g[0].dtype == torch.int32 and int(g[0]) == max(n0, limit)


@pytest.mark.card
@pytest.mark.parametrize("n", [0, 1, 2, 5, 6])
def test_unroll2_ping_pong_graph_against_host_on_card(card, n):
    def pingpong():
        bufs = (torch.arange(8, dtype=torch.float32, device=card), torch.empty(8, device=card))

        def body(c):
            out = bufs[1] if c[0] is bufs[0] else bufs[0]
            torch.add(c[0], 1.0, out=out)
            return out, c[1] + 1

        def run(c):
            return loops.while_loop(lambda c: c[1] < n, body, (bufs[0], c), unroll=2,
                                    donate=True)

        return loops.device_call(run, torch.zeros((), dtype=torch.int32, device=card))

    g, h = _graph_and_host(pingpong)
    assert _same(g, h) and int(g[1]) == n and float(g[0][0]) == n


@pytest.mark.card
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_ns_chunks_of_one_graph_against_host_on_card(card, beta):
    cfg = NSConfig(nx=2049, ny=513, ttot=0.005, beta=beta, Pr=0.01, tol=1e-7, niters=50)
    g = simulate_fast(cfg, seed=0, max_steps=20, device=card)
    ones = simulate_fast(cfg, seed=0, max_steps=20, chunk_steps=1, device=card)
    with loops.host_loops():
        h = simulate_fast(cfg, seed=0, max_steps=20, device=card)
    assert g.steps == ones.steps == h.steps == 20 and g.sim_time == h.sim_time
    for o in (ones, h):
        for k in "TWS":
            np.testing.assert_array_equal(getattr(g, k), getattr(o, k))


@pytest.mark.card
@pytest.mark.parametrize("policy, K, tol", [
    (ExecutionPolicy.PALLAS, 1, 1e-6), (ExecutionPolicy.PALLAS, 3, 1e-6),
    (ExecutionPolicy.PALLAS_DS, 1, 1e-10), (ExecutionPolicy.JNP, 1, 1e-6)],
    ids=["pallas", "pallas_k3", "pallas_ds", "jnp"])
def test_diffusion_graph_against_host_on_card(card, policy, K, tol):
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=2.0, tol=tol, policy=policy,
                          check_every=K)
    g, h = _graph_and_host(lambda: diffusion3d.solve(cfg, device=card))
    assert g.converged and (g.iters_total, g.timed_iters) == (h.iters_total, h.timed_iters)
    np.testing.assert_array_equal(g.H, h.H)
    print(f"\n{policy.value} K={K} 128^3: {g.iters_total} iterations")
