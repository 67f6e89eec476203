#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (fpr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first failure stops the run with a non-zero exit:

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions; TF32 matmuls must be off.
2. build: the CUDA kernels from ``fpr_tpu_torch/csrc``, one nvcc per source.
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and flags: field outputs bitwise equal, sums within a
   relative 1e-5 (a different summation order), maxima equal; times of a
   wrapper call from CUDA events over 20 calls after a warm-up, and the
   device time of its CUDA kernels from torch.profiler.  Part 1's kernels
   run here too: dual_time at 512^3 and at a ragged 67x45x130, the fused
   K-sweep kernel (dual_timek, #10) at 512^3 K=3 and at the ragged shape
   for K = 1..5 (K = 5 as two passes), with its input unwritten, and ds3d
   at 128^3 and the ragged shape; #8 and #11 in their tested form (part
   1's loop test finished in the launch) against the untested launch.
4. the MG row: ``mg_solve_ds`` at 4097^2, DST coarse 513, V(5,5), tol 1e-6,
   with a true float64 residual checked on the card.
5. NS explicit at 2049x513, Pr=0.01, tol 1e-7, ttot 0.005 (the main path):
   8736 timed steps, launch counts of all four kernels, and its first 20
   steps against the plain versions.
6. NS semi-implicit (beta=0.5) at the same size, kernels against plain.
7. the diffusion bench row: ``diffusion3d.solve`` at 512^3 float32, PALLAS
   with check_every=3, ttot 0.8 (3 warm-up steps, 1 timed), each step
   capped at 300 iterations; then 30 iterations per step through the
   kernels and through the plain versions: equal counts, bitwise fields.
8. diffusion 128^3 float32, ttot 2, tol 1e-6, converged with check_every
   1 (the dual_time kernel) and 3 (the fused kernel; its count beside that
   of K launches of the one-sweep kernel): the probe within 1e-4 of the
   reference's 0.0799870; the check_every=1 solve again through the plain
   versions.
9. the double-single tier at 128^3, ttot 2, tol 1e-10: converged, the probe
   within 1e-6 of the reference's 0.0799604096; kernels against plain for
   200 iterations per step.
10. MG mixed (``mg_solve_mixed``) at 4097^2, default MGConfig (coarse 5,
    Jacobi, V(2,2)), tol 1e-6: at most 30 outers, the same count through
    the plain versions, a true float64 residual within tol; the solve's
    time as one graph launch beside its time as host loops.
11. the PALLAS policy in float64 at 2049^2: ``mg_solve`` with the Jacobi
    and the CG coarse solve against the JNP policy (equal cycle counts,
    fields within 1e-10), ``krylov.cg`` (equal iterations to the plain
    run) and ``mg_preconditioned_cg``.
12. Krylov ds: ``mg_pcg_ds`` at 4097^2, DST-513, V(5,5), tol 1e-6, true
    float64 residual within tol; ``dots="kernel"`` at 1025^2 with the same
    iteration count as the plain run.
13. the NS host loop (``simulate``) at 2049x513, Pr=0.01, tol 1e-7, ttot
    0.005, ``mg_solver="mixed"``, float64: beta 0.5 and 1 to their end,
    beta 0 for 50 steps, the first 10 beta=0.5 steps against the plain
    versions, and 3 beta=0.5 steps with the direct solver and the PALLAS
    policy; 10 steps at beta 0.5 and 1 as one graph launch a step and as
    host loops, their times a step side by side.
14-18 run the sharded tiers as graphs (one launch a solve, chunk or
    step), each wall printed beside the host loops' figure (HOST_LOOPS)
    and each new graph's nodes and build seconds.
14. the sharded diffusion tier on a virtual mesh (every shard on the one
    card): 512^3 float32 on 4 z-shards, PALLAS check_every=3 (#9), capped
    at 300 iterations a step as phase 7, H bitwise equal to phase 7's
    single-device H; 128^3 float32 tol 1e-6 on 2x2x2 shards (#8 with update
    boxes), converged, its count and probe beside phase 8's; overlap_comm
    against plain on 4 z-shards at 128^3, bitwise.
15. ``mg_solve_ds_sharded`` at 4097^2 on 4 row shards, DST-513, V(5,5), tol
    1e-6, replicate_below=1025: the outer count of phase 4, a true float64
    residual within tol, u within 1e-6 of phase 4's u; then apply_bcs at
    2049^2, c 0 and 64, against the single-device solve.
16. ``simulate_fast_sharded`` at 2049x513 on 4 row shards: explicit for 6
    steps against the single-device loop (equal steps, sim_time within 1e-6,
    W and T within 1e-4), 200 steps timed beside the single device with the
    drift reported; beta=0.5 to the end, its step count beside phase 6's;
    then ``dryrun_multichip(4)``, with its 2D-mesh part.
17. ``mg_solve_ds_sharded_2d`` at 4097^2, DST-513, V(5,5), tol 1e-6,
    replicate_below=1025, on a 2x2 and a 1x4 (y, x) mesh: phase 4's outer
    count, a true float64 residual within tol, u within 1e-6 of phase 4's
    (bitwise or not, logged), launches of K1, #6 and #7.
18. the GSPMD tier in float64: ``mg_solve_sharded`` at 2049^2 on 4 row
    shards against the single-device ``mg_solve`` (equal cycles, fields
    within 1e-12), and 3 steps of ``simulate(mesh=)`` at 2049x513, direct,
    beta=0.5, against the single device (tests/test_distributed.py's
    bounds).
19. the port's bench (``fpr_tpu_torch.bench``) rows in-process at full
    size: diffusion 512^3 K=3, 300 iterations (T_eff printed beside the
    card's name and power limit); MG 4097^2, 4 outers at a true float64
    residual within 1e-6, the card time of one more solve from its
    ``graph:mg_solve_ds`` span; NS semi-implicit (37 timed steps) and implicit
    (within IMPLICIT_BAND) at 2049x513 with one rep each; then ``python -m
    fpr_tpu_torch bench --quick`` in a subprocess (each component in a
    process of its own), its last line parsed and naming the card, with a
    canary inside the bench's healthy envelope and
    ``aliased_kernel_check`` true; then ``bench --component aliased`` (the
    kernel-agreement check at bench.py's shapes) and ``--component
    canary_post`` run directly, their payloads printed: the check passed,
    the canary inside the envelope.
20. checkpoints through ``fpr_tpu_torch.cli.main``: ``ns --fast`` at
    2049x513 saved at 200 steps and resumed to 400, bitwise equal to a
    straight 400 (T, W, S_hi, S_lo, w_sumsq, t_hi, t_lo, step); a host-loop
    (float64, PALLAS policy) save of 3 steps, resumed for 3 more and
    bitwise equal to ``simulate`` from the saved T and W;
    ``utils.profiling.trace`` around 5 fast steps, with device events.
21. the six sweeps of ``fpr_tpu_torch.experiments`` into a temporary
    directory at their smallest settings that launch their kernels
    (diffusion at 16^3 and 32^3 on 2 z-shards, ``multigrid_bench`` at
    1025^2 with and without ``--workprec``, ``ns_timestepping`` fast at
    2049x513 for at most 60 steps, ``dist_mg_large --k 13 --devices 4``):
    the rows' counts, backend and card name, and the kernels each ran;
    ``ns_timestepping --s-tol-factor 0`` refused.
22. device loops: every loop ported to a CUDA graph with WHILE nodes
    (``core/loops.py``) against the host loops (``loops.host_loops()``),
    bitwise with equal counts: NS explicit to its end (phase 5's run, 8736
    timed steps) and for 20 steps, again with chunk_steps=1000 (one graph
    launch a chunk, host syncs counted: warm-up + chunks + end), NS semi
    to its end (phase 6's run, 37), MG ds 4097^2 (4 outers, one graph
    launch a call) and ``mg_pcg_ds`` 4097^2, diffusion 128^3 K=1 (18980),
    K=3 and ds (41148); the same through the plain versions on both sides
    (NS 20 and 5 steps, diffusion 50 iterations a step); the device
    launches of K1, K4 and the legs in 20 NS steps as the graphs count
    them, equal to the host loops' and to the profiler's count on the host
    loops or one more, counted in a process of their own (``chip_smoke.py
    --launch-counts``; the profiler loses an event now and then in a long
    process, and sees no kernel inside a conditional node);
    a host read in a captured body raises; each row's wall time beside
    PR 9's.
    The host tiers, the graph against the host loops bitwise, the plain
    versions too: ``mg_solve`` at 2049^2 float64 with the JNP and the
    PALLAS policy (Jacobi coarse), ``mg_solve_rp`` at 2049^2 float32,
    phase 10's ``mg_solve_mixed`` 4097^2 (8 outers), phase 13's 10 NS
    host-loop steps at beta 0.5 and 1 (equal steps and the same
    NOT-converged warnings; one graph launch and one host read a step),
    ``mg_solve_ds(fmg=True)`` at 4097^2 (no more outers than without FMG,
    a true float64 residual within 1e-6, K1, K2 and K3 launched by the
    preamble); each new graph's build time and node count.
    The sharded tiers on 4 shards of the card, the graph against the host
    loops bitwise, one graph launch a solve, chunk or physical step and the
    host syncs of a run counted: ``mg_solve_ds_sharded`` over rows and 2x2
    at 4097^2 (4 outers; the row solve also through the plain versions), a
    cold apply_bcs solve at 2049^2 with the same NOT-converged warning,
    ``simulate_fast_sharded`` 23 explicit steps in chunks of 5 (plain
    versions too) and 5 semi-implicit, ``solve_distributed`` at 128^3 in
    4 physical steps of at most 100 iterations in each body (jnp, jnp
    overlap, pallas 2x2x2 and pallas overlap, K=3; pallas 2x2x2 and K=3
    through the plain versions too), ``mg_solve_sharded`` at 2049^2 float64
    and 2 steps of ``simulate(mesh=)``; the part's seconds.
23. the last slice's modules: ``transfer.prolongate_shifts`` at 513^2
    fine, float32 and float64, with and without the side copies, within 4
    ulps of the largest coarse value of ``prolongate`` and of the host's
    ``oracle.prolongate_scatter``; #5 in float64 at 257^2 (matvec against
    ``oracle.helmholtz_operator``, residual and smooth with its rms against
    the port's native ``oracle_residual2d`` and ``oracle_jacobi2d``, built
    by g++ from ``native/``), relative 1e-12; #8 in float32 at 64^3 against
    the float64 ``oracle_dual_time3d``, within 8 float32 ulps of max|Htau|
    and the sum of squares within REL_SUM; each of JAX's ``*_jit`` entry
    points bitwise against its base, with the same count and launching the
    base's kernels: ``mg_solve_ds_jit`` and ``mg_pcg_ds_jit`` at 4097^2
    (phase 4's and 12's configuration, 4 outers for the MG row),
    ``mg_solve_jit`` with the PALLAS policy and ``mg_solve_mixed_jit`` at
    2049^2 float64, ``ns_step_jit`` (phase 13's beta=0.5 step); the volume
    demo's solve (``plotting.volume_slices.demo_field``, 48^3 float32)
    bitwise against a direct ``diffusion3d.solve``, its iterations logged,
    and its H through ``utils.checkpoint`` and ``volume_slices.load_field``
    bitwise.  The plotting modules import; matplotlib is not used.
24. 16385^2, the sweep's largest grid, in the same process with no
    ``loops.clear_cache``: the cached graphs of phases 1-23 give their
    memory back when the card runs out (``loops.device_call``).
    ``mg_solve_ds`` (DST-513, V(5,5), tol 1e-6: 6 outers, a true float64
    residual within tol); ``mg_pcg_ds`` (60 iterations at most) as a graph;
    a ballast tensor that leaves 6 GiB free, then ``mg_solve_ds`` with
    another key: cached graphs closed for memory, the same bits; the
    ``mg_pcg_ds`` solve under ``loops.host_loops()``, bitwise equal to the
    graph in the u pair, r_rms and count; its first 10 iterations one at a time
    (``krylov._mg_pcg_ds_history``) through the plain versions and as host
    loops in lockstep, every field and scalar bitwise, r_rms within
    REL_SUM, and in each iteration z zero on the boundary ring, the
    curvature within n float32 eps of the float64 p.(A p) and negative;
    logged: s1 = z.r (and the first iteration where it is not negative, so
    alpha is not positive) and the preconditioner's contraction
    rms(A z - r) / rms(r) in float64; JAX's recurrence written again in
    float64 apart from the port (``pcg_witness``): at 8193^2 it converges
    within one iteration of ``mg_pcg_ds``, at 16385^2 the port's r_rms is
    within WITNESS_REL of it in each of the 10 iterations, and with z
    float32 it stays above rms(f) while a float64 z converges; one float32
    V-cycle against the float64 V-cycle on the rhs at 8193^2 and 16385^2.
    Each part's peak card memory and each graph's pool bytes are printed
    beside the card's name and power limit.

Phase 3 holds the legs K2/K3 (one launch of the leg kernel a call) bitwise
at the MG row's levels with ns=5, timed at 2049x513 ns=3 and at 4097^2
ns=5 (the rows smooth_down_4097, corr_up_4097), and with ns 1-6, elim and
c != 0, from u and from a zero iterate, at 2049x513 and at the ragged
67x45, 130x257 and 67x113. It also holds the host-loop tiers' kernels
against their plain versions: the stencil pass (#5) in every mode,
smooth2 included, with and without its sum, in float32 at 2049x513 and
4097^2 and in float64 at 2049^2 and on the ragged shapes (fields bitwise,
sums and rms within REL_SUM or REL_SUM_F64, a rerun bitwise, each public
entry point one launch, counted in the nodes of the call captured as a
CUDA graph; each mode's device time beside its bound, and
conv2d's for the matvec), and the legs #6/#7 at 2049x513 with ns 1-6,
with and without elim, each entry point launching the leg kernel once a
call. And the sharded tiers' shard windows: #9 against its plain version
and, on the owned planes, against the global #10 (first, interior and last
shard of 4, K 2 and 3, at phase 14's 512^3, the ghost planes of the result
buffer set to NaN before the call), #8 with the update boxes of phase 14's
shards, and K1, #6 (ns 1-6), #7 (ns 1-6) and K4 with the row hooks against
their plain versions and against the rows of their call on the whole
2049x513 grid, K1, #6 and #7 (ns 1-6) with the row and column hooks on the
four windows of a 2x2 split of 2049^2 against their plain versions and the
whole grid's cells, and K4's with_helm_defect mode (the ``ns_fused_helm``
row) against its plain version and against the rhs pass and two K1 passes,
all bitwise.
Launch counts are device launches: a kernel inside a CUDA graph counts
once for each time the graph runs it (``kernels.sync_launches``).
Each kernel's launches are counted over the one path run that uses it
(phase 5 for the NS kernels, 7 for dual_timek, 8 for dual_time, 9 for
ds3d, 11's PALLAS ``mg_solve`` for the stencil pass, 13's beta=0.5 run for
#6/#7, 14's 512^3 run for dual_timek_padded, and for ns_fused_helm the
Helmholtz warm start after phase 6: one semi-implicit step's T and W
solves fed through that mode, against the separate passes; no solver path
launches it, as none of the JAX package does), with the counts set to 0
just before it; phases 14-21 print and check their own counts as well.
The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  A failed check prints its message on
the standard output and on the standard error, and the exit code is 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REL_SUM = 1e-5  # sums in another order: a few float32 ulps of ~1e6 terms
REL_SUM_F64 = 1e-12  # the same in float64
# NVIDIA's H100 SXM data sheet: HBM3 bandwidth, float32 and float64 outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12
PEAK_F64_FLOPS_S = 34e12
# the device of phases 10-13 (a rehearsal on the CPU sets "cpu")
DEVICE = "cuda"
# ragged shapes of phase 3: tiles of a leg or of K1/K4 that begin at the last
# column (67x113), and a last tile of one column whose last strip has one row
# (65x97)
RAGGED = ((67, 45), (130, 257), (67, 113), (65, 97))


# the sharded phases' figures in the last run of this script whose sharded
# tiers ran host loops (an NVIDIA H100 80GB HBM3 at 700.00 W), printed
# beside the walls of the graphs that replaced those loops
HOST_LOOPS = {"512^3 K=3": "0.5318 ms an iteration", "2x2x2": "15.167 s timed",
             "overlap_comm=False": "0.4036 s timed", "overlap_comm=True": "1.0529 s timed",
             "MG 4097^2": "0.0200 s a solve", "apply_bcs c=0.0": "0.295 s",
             "apply_bcs c=64.0": "0.313 s", "NS explicit": "11.93 ms a step",
             "NS beta=0.5": "1.458 s timed", "2x2": "0.0217 s a solve",
             "1x4": "0.0227 s a solve", "mg_solve_sharded": "0.395 s",
             "simulate(mesh=)": "3.637 s"}

T0 = time.perf_counter()


def was(what: str, smi: str) -> str:
    """A sharded row's host-loop figure from HOST_LOOPS, beside this card."""
    return (f"[as host loops: {HOST_LOOPS[what]}, NVIDIA H100 80GB HBM3, 700.00 W; "
            f"this card: {smi}]")


def log(msg: str) -> None:
    """Print a line; a phase's heading gets the seconds since the start."""
    if msg.startswith("== phase"):
        msg = f"{msg}  [{time.perf_counter() - T0:.0f} s]"
    print(msg, flush=True)


class Failed(Exception):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_us(fn, names, reps: int = 20):
    """Device time per call of the CUDA kernels whose names contain one of
    names, from torch.profiler; None if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
                for ev in prof.key_averages() if any(n in ev.key for n in names))
    return total / reps if total > 0 else None


def captured(call):
    """One call of ``call``, after one outside it, captured in a CUDA graph:
    (the graph's node count, its nodes' DOT labels, the names of the kernels
    whose wrappers counted a launch in it).  The graph holds every kernel,
    copy and memset the call puts on the card.  torch.profiler's windows
    lose events now and then, whole windows too, so no launch check rests
    on them."""
    import ctypes
    import re
    import tempfile

    import torch

    from fpr_tpu_torch import kernels

    call()
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    counted = [k for k in kernels.KERNELS if kernels.launches[k] != before[k]]
    lib, raw, n = kernels.lib(), graph.raw_cuda_graph(), ctypes.c_size_t()
    kernels.check(lib.fpr_graph_nodes(raw, ctypes.byref(n)), "fpr_graph_nodes")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "call.dot")
        kernels.check(lib.fpr_graph_dot(raw, path.encode()), "fpr_graph_dot")
        with open(path) as fh:
            dot = fh.read()
    del graph
    # a node's attributes hold its label; an edge's ("a" -> "b"[...]) none
    labels = [x for x in re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)\];', dot, re.S)
              if 'label="' in x]
    return n.value, labels, counted


def kernel_launches(fn, name) -> int:
    """Launches of the CUDA kernels whose names contain name in one call of
    fn, from the call's captured graph."""
    return sum(name in label for label in captured(fn)[1])


def one_launch(name, what, call) -> None:
    """Fail unless one call puts exactly one node on the card, the kernel
    that its wrapper counted: no other kernel, copy or memset."""
    nodes, labels, counted = captured(call)
    require(nodes == 1 and len(labels) == 1 and counted,
            f"{name} {what}: {nodes} graph nodes in one call, launches counted of "
            f"{counted} ({[' '.join(x.split())[:160] for x in labels]})")


def same_bits(name, what, call) -> None:
    """Fail unless two identical calls give the same bits, sums included."""
    import torch

    a, b = tensors(call()), tensors(call())
    require(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
            f"{name} {what}: a rerun gives other bits")


def tensors(*xs):
    """The tensors in xs, with tuples and lists flattened."""
    import torch

    out = []
    for x in xs:
        if isinstance(x, (tuple, list)):
            out += tensors(*x)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def io_bytes(inputs, outputs) -> int:
    """Bytes a call must move: each input read once, each output written once."""
    return sum(t.numel() * t.element_size() for t in tensors(inputs, outputs))


@contextlib.contextmanager
def plain_kernels():
    """Route the CUDA wrappers to their plain PyTorch versions."""
    from fpr_tpu_torch.ops import ds, ds3d, dual_time, ns_fused, stencil_pass, vcycle_legs

    swaps = [(ds, "_defect_cuda", ds.defect_pass_plain),
             (vcycle_legs, "_smooth_down_cuda", vcycle_legs.smooth_down_plain),
             (vcycle_legs, "_corr_up_cuda", vcycle_legs.corr_up_plain),
             (vcycle_legs, "_smooth2r_split_cuda", vcycle_legs.smooth_down_plain),
             (vcycle_legs, "_corr_smooth2_cuda", vcycle_legs.corr_up_plain),
             (stencil_pass, "_stencil_cuda", stencil_pass.stencil_plain),
             (ns_fused, "_ns_fused_cuda", ns_fused.ns_fused_plain),
             (dual_time, "_dual_time_cuda",
              lambda Ht, Htau, cf, out=None, partials=None:
              dual_time.dual_time_step_plain(Ht, Htau, cf, out)),
             (dual_time, "_dual_timek_cuda",
              lambda Ht, Htau, K, cf, scratch=None, partials=None:
              dual_time.dual_time_stepk_plain(Ht, Htau, K, cf, scratch)),
             (dual_time, "_dual_time_tested_cuda",
              lambda Ht, Htau, cf, test, out=None, partials=None: dual_time.loop_test_plain(
                  dual_time.dual_time_step_plain(Ht, Htau, cf, out), test)),
             (ds3d, "_ds3d_tested_cuda",
              lambda Ht, Htau, cp, test, out=None, partials=None: dual_time.loop_test_plain(
                  ds3d.ds3d_step_plain(Ht, Htau, cp, out), test)),
             (dual_time, "_dual_time_box_cuda", dual_time.dual_time_box_plain),
             (dual_time, "_dual_time_stepk_padded_cuda", dual_time.dual_time_stepk_padded_plain),
             (ds3d, "_ds3d_cuda",
              lambda Ht, Htau, cp, out=None, partials=None:
              ds3d.ds3d_step_plain(Ht, Htau, cp, out))]
    saved = [getattr(m, n) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for (m, n, _), f in zip(swaps, saved):
            setattr(m, n, f)


class KernelCheck:
    """Kernel-vs-plain comparisons and times, one record per kernel."""

    def __init__(self):
        self.rows = {}

    def fields(self, name, got, want, what):
        import torch

        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            err = float((g.double() - w.double()).abs().max())
            row = self.rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            require(torch.equal(g, w), f"{name} {what}: field differs from plain "
                                       f"(max abs err {err:.3e})")

    def sums(self, name, got, want, what, exact=False, rel=REL_SUM):
        for g, w in zip(got, want):
            g, w = float(g), float(w)
            if exact:
                require(g == w, f"{name} {what}: maximum {g!r} != plain {w!r}")
            else:
                require(abs(g - w) <= rel * max(abs(w), 1e-30),
                        f"{name} {what}: sum {g!r} vs plain {w!r}")

    def timed(self, name, k_fn, p_fn, inputs, shape, kernel_names, flops,
              peak_flops=PEAK_F32_FLOPS_S, library=None, result=lambda out: out):
        """Times of a kernel call and of its plain version at the path's
        shape (and of one PyTorch call computing the same function, where
        there is one), and what its bound needs: the bytes of the inputs and
        of the function's result (``result`` of one call's outputs: the part
        that is the function's, where a buffer holds more), and the call's
        operations with the card's peak rate for their type."""
        row = self.rows.setdefault(name, {"max_abs_err": 0.0})
        row.update(io_bytes=io_bytes(inputs, result(k_fn())), flops=flops, peak_flops=peak_flops,
                   shape=list(shape), ms=time_ms(k_fn), plain_ms=time_ms(p_fn),
                   device_us=device_us(k_fn, kernel_names),
                   library_ms=None if library is None else time_ms(library))

    def bound(self, name):
        """(ms, "bytes" | "operations"): the least time the card could take
        for the timed call, at 3.35 TB/s and the peak rate of its type."""
        row = self.rows[name]
        return bound_of(row["io_bytes"], row["flops"], row.get("peak_flops", PEAK_F32_FLOPS_S))


def bound_of(nbytes, flops, peak_flops=PEAK_F32_FLOPS_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env():
    import torch

    from fpr_tpu_torch.utils import device

    log("== phase 1: environment")
    info = device.card_info(DEVICE)
    require(info["nvidia_smi"] and info["nvcc"], f"no nvidia-smi line or no nvcc: {info}")
    log(info["nvidia_smi"])
    log(f"torch {info['torch']}  cuda {info['torch_cuda']}  device {info['device']}")
    log(info["nvcc"])
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    return info["nvidia_smi"]


def phase_build():
    from fpr_tpu_torch import kernels

    log("== phase 2: build")
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    log(f"built and loaded {path.name} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(kc: KernelCheck):
    import numpy as np
    import torch

    from fpr_tpu_torch.ops import ds, ns_fused, stencil2d, transfer, vcycle_legs

    log("== phase 3: kernels against their plain versions")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                            device=dev)

    def ds_pair(ny, nx):
        u64 = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float64, device=dev)
        hi = u64.float()
        return torch.stack([hi, (u64 - hi.double()).float()])

    # K1, the defect pass: the flag sets of the S, T and W solves and the MG
    # row, at NS's 513x2049 and on ragged shapes (at 65x97 the last tile has
    # one column and the last strip one row), C given and derived in the
    # kernel, f one plane and two
    cT = torch.tensor(41.25, dtype=torch.float32, device=dev)
    cases = [
        ("S", 0.0, dict(velocity_max=True)),
        ("T", cT, dict(apply_bcs=True)),
        ("W", cT * 100.0, dict()),
        ("sumsq", 0.0, dict(field_sumsq=True, velocity_max=True)),
        ("c float", 3.5, dict(field_sumsq=True, velocity_max=True, apply_bcs=True)),
    ]
    for ny, nx in ((513, 2049),) + RAGGED:
        h = 1.0 / 512
        u, e = ds_pair(ny, nx), rand(ny, nx, scale=1e-3)
        f2 = torch.stack([rand(ny, nx), rand(ny, nx, scale=1e-8)])
        for tag, c, kw in cases:
            C = ds.defect_scalars(c, h, dev)
            c_zero = not isinstance(c, torch.Tensor) and c == 0.0
            for ff in (f2[:1], f2):
                for ee, scale in ((None, 0.0), (e, 1.0)):
                    args = (u, ff, ee, scale, h)
                    want = ds.defect_pass_plain(*args, C, c_zero, **kw)
                    what = f"{ny}x{nx} {tag} f{ff.shape[0]} scale={scale}"
                    for CC in (C, ds.c_source(c, h)):
                        uk, rk, sk = ds._defect_cuda(*args, CC, c_zero, **kw)
                        kc.fields("defect", (uk, rk), want[:2], what)
                        kc.sums("defect", (sk[0], sk[3], sk[4]), (want[2][0], want[2][3],
                                                                  want[2][4]), f"{what} sums")
                        kc.sums("defect", sk[1:3], want[2][1:3], f"{what} maxima", exact=True)
    ny, nx = 513, 2049
    h = 1.0 / 512
    u, f, e = ds_pair(ny, nx), rand(1, ny, nx), rand(ny, nx, scale=1e-3)
    n = 4097
    f4 = rand(1, n, n)
    u4 = torch.zeros((2, n, n), dtype=torch.float32, device=dev)
    e4 = rand(n, n, scale=1e-3)
    C0 = ds.defect_scalars(0.0, 1.0 / (n - 1), dev)
    args4 = (u4, f4, e4, 1.0, 1.0 / (n - 1), C0, True)
    kc.fields("defect", ds._defect_cuda(*args4)[:2], ds.defect_pass_plain(*args4)[:2],
              "4097^2")
    args = (u, f, e, 1.0, h, ds.defect_scalars(0.0, h, dev), True)
    kc.timed("defect", lambda: ds._defect_cuda(*args, velocity_max=True),
             lambda: ds.defect_pass_plain(*args, velocity_max=True), args, (ny, nx),
             ["defect_kernel"], flops=120 * ny * nx)
    # the MG row's defect pass (mg_solve_ds at 4097^2: c = 0, f one plane)
    kc.timed("defect_4097", lambda: ds._defect_cuda(*args4),
             lambda: ds.defect_pass_plain(*args4), args4, (n, n), ["defect_kernel"],
             flops=120 * n * n)
    # one launch a public call, and the same bits from a rerun
    for what, call in (
        ("S solve", lambda: ds.defect_pass(u, f, e, 1.0, h, 0.0, velocity_max=True)),
        ("MG row", lambda: ds.defect_pass(u4, f4, e4, 1.0, 1.0 / (n - 1), 0.0, C=C0)),
        ("T solve, raw", lambda: ds.defect_pass(u, f, None, 0.0, h, cT, apply_bcs=True,
                                                raw_sumsq=True)),
    ):
        one_launch("defect_pass", what, call)
        same_bits("defect_pass", what, call)
    del u4, f4, e4, args4

    # K2 and K3, the legs: the MG row (ns=5 on 4097^2, 2049^2, 1025^2), and
    # ns 1-6 with and without elim and c != 0 at NS's 513x2049 (ns=3 on the
    # path, elim for the T solve) and on ragged shapes (at 67x113 a tile of
    # the leg kernel begins at the last column), from u and from a zero
    # iterate
    leg_cases = [((4097, 4097), 5, False, 0.0), ((2049, 2049), 5, False, 0.0),
                 ((1025, 1025), 5, False, 0.0)]
    for shape in ((513, 2049), (67, 45), (130, 257), (67, 113)):
        for ns in range(1, 7):
            leg_cases += [(shape, ns, False, 0.0), (shape, ns, True, cT),
                          (shape, ns, False, cT * 100.0)]
    for (ny, nx), ns, elim, c in leg_cases:
        h = 1.0 / (min(ny, nx) - 1)
        f2, u2 = rand(ny, nx), rand(ny, nx)
        ct = stencil2d.as_scalar(c, f2)
        tag = f"{ny}x{nx} ns={ns} elim={elim} c={float(c)}"
        for uu in (None, u2):
            got = vcycle_legs._smooth_down_cuda(uu, f2, h, ct, 0.8, ns, elim)
            want = vcycle_legs.smooth_down_plain(uu, f2, h, ct, 0.8, ns, elim)
            kc.fields("smooth_down", got, want, f"{tag} zero_u={uu is None}")
        coarse = rand(ny // 2 + 1, (nx - 1) // 2 + 1, scale=1e-2)
        corrx = transfer.x_interleave_coarse(coarse, apply_bcs=elim)
        got = vcycle_legs._corr_up_cuda(u2, f2, corrx, h, ct, 0.8, ns, elim, True)
        want = vcycle_legs.corr_up_plain(u2, f2, corrx, h, ct, 0.8, ns, elim, True)
        kc.fields("corr_up", got[:1], want[:1], tag)
        kc.sums("corr_up", got[1:], want[1:], f"{tag} norm")
        timed = {(513, 2049, 3): "", (4097, 4097, 5): "_4097"}.get((ny, nx, ns))
        if timed is not None and not elim and c == 0.0:
            # about 10 flops a cell per sweep and per residual pass, 2 for the norm
            for name, k_fn, p_fn, a, flops in (
                ("smooth_down", vcycle_legs._smooth_down_cuda,
                 vcycle_legs.smooth_down_plain, (None, f2, h, ct, 0.8, ns, elim),
                 (ns + 1) * 10 * ny * nx),
                ("corr_up", vcycle_legs._corr_up_cuda, vcycle_legs.corr_up_plain,
                 (u2, f2, corrx, h, ct, 0.8, ns, elim, True), (ns * 10 + 2) * ny * nx),
            ):
                kc.timed(name + timed, lambda: k_fn(*a), lambda: p_fn(*a), a, (ny, nx),
                         ["leg_kernel"], flops)
                require(kernel_launches(lambda: k_fn(*a), "leg_kernel") == 1,
                        f"{name} {tag}: not one launch of the leg kernel a call")

    # the legs at 4097^2 by ns: the slope is the sweeps' cost, the rest the
    # pass that loads and stores
    n = 4097
    h = 1.0 / (n - 1)
    f2, u2 = rand(n, n), rand(n, n)
    corrx = transfer.x_interleave_coarse(rand(n // 2 + 1, n // 2 + 1, scale=1e-2))
    c0 = stencil2d.as_scalar(0.0, f2)
    by_ns = {}
    for ns in range(1, 7):
        by_ns[ns] = [device_us(fn, ["leg_kernel"]) for fn in (
            lambda: vcycle_legs._smooth_down_cuda(None, f2, h, c0, 0.8, ns, False),
            lambda: vcycle_legs._corr_up_cuda(u2, f2, corrx, h, c0, 0.8, ns, False, True))]
    log(f"legs at {n}^2, device us by ns (down from a zero iterate, up with its norm): "
        f"{by_ns}")
    del f2, u2, corrx

    # K4, the NS operator: explicit with and without the defect, rhs at beta
    # 0.5 and 1 and with the Helmholtz defects, at NS's 513x2049 and on the
    # ragged shapes
    dt = torch.tensor(1.9e-6, dtype=torch.float32, device=dev)
    cTs = torch.tensor(1.0, dtype=torch.float32, device=dev) / (0.5 * dt)
    cWs = cTs / torch.tensor(0.01, dtype=torch.float32, device=dev)
    ns_cases = [("explicit", 0.0, True, False), ("explicit", 0.0, False, False),
                ("rhs", 0.5, False, False), ("rhs", 1.0, False, False),
                ("rhs", 0.5, False, True)]
    for ny, nx in ((513, 2049),) + RAGGED:
        h = 1.0 / (ny - 1)
        TW = torch.stack([rand(ny, nx, scale=0.3) + 0.5, rand(ny, nx, scale=10.0)])
        S = torch.stack([rand(ny, nx, scale=0.1), rand(ny, nx, scale=1e-9)])
        for mode, beta, wd, helm in ns_cases:
            scal = (dt, cTs, cWs) if mode == "rhs" else (dt, None, None)
            a = (TW, S if wd else S[0], scal, h, 0.01, 1e6, 1.0, beta, mode, wd, None, helm)
            name = "ns_fused_helm" if helm else "ns_fused"
            what = f"{ny}x{nx} {mode} beta={beta} defect={wd}"
            ok, rk, sk = ns_fused._ns_fused_cuda(*a)
            op, rp, sp = ns_fused.ns_fused_plain(*a)
            kc.fields(name, (ok, rk), (op, rp), what)
            kc.sums(name, sk[[0, 1, 2, 5, 6, 7]], sp[[0, 1, 2, 5, 6, 7]], f"{what} sums")
            kc.sums(name, sk[3:5], sp[3:5], f"{what} maxima", exact=True)
    ny, nx = 513, 2049
    h = 1.0 / 512
    TW = torch.stack([rand(ny, nx, scale=0.3) + 0.5, rand(ny, nx, scale=10.0)])
    S = torch.stack([rand(ny, nx, scale=0.1), rand(ny, nx, scale=1e-9)])
    a = (TW, S, (dt, None, None), h, 0.01, 1e6, 1.0, 0.0, "explicit", True)
    kc.timed("ns_fused", lambda: ns_fused._ns_fused_cuda(*a),
             lambda: ns_fused.ns_fused_plain(*a), a, (ny, nx), ["ns_kernel"],
             flops=80 * ny * nx)
    # the semi-implicit path's pass: rhs at beta 0.5 with the sums of squares
    ar = (TW, S[0], (dt, cTs, cWs), h, 0.01, 1e6, 1.0, 0.5, "rhs", False)
    kc.timed("ns_fused_rhs", lambda: ns_fused._ns_fused_cuda(*ar),
             lambda: ns_fused.ns_fused_plain(*ar), ar, (ny, nx), ["ns_kernel"],
             flops=80 * ny * nx, result=lambda o: (o[0], o[2][:2]))
    for what, call in (
        ("explicit with_defect", lambda: ns_fused.ns_fused_rp(
            TW, S, dt, h, 0.01, 1e6, mode="explicit", with_defect=True)),
        ("rhs with_sumsq", lambda: ns_fused.ns_fused_rp(
            TW, S[0], dt, h, 0.01, 1e6, beta=0.5, mode="rhs", cT=cTs, cW=cWs,
            with_sumsq=True)),
        ("rhs with_helm_defect", lambda: ns_fused.ns_fused_rp(
            TW, S[0], dt, h, 0.01, 1e6, beta=0.5, mode="rhs", cT=cTs, cW=cWs,
            with_helm_defect=True)),
    ):
        one_launch("ns_fused_rp", what, call)
        same_bits("ns_fused_rp", what, call)
    phase_kernels_3d(kc)
    phase_kernels_host(kc)
    phase_kernels_shards(kc)
    phase_kernels_cols(kc)
    phase_kernels_helm(kc)
    for name, row in kc.rows.items():
        b_ms, b_by = kc.bound(name)
        log(f"{name:12s} {row['shape']}: call {row['ms'] * 1e3:9.1f} us  "
            f"plain {row['plain_ms'] * 1e3:9.1f} us  kernels on the device "
            f"{row['device_us']} us  bound {b_ms * 1e3:.1f} us ({b_by})  "
            f"max abs err {row['max_abs_err']}")


def phase_kernels_shards(kc: KernelCheck, dev=None, n=512):
    """The sharded tiers' kernels on shard windows (still phase 3): #9 against
    its plain version and against the global #10's planes, #8's update boxes,
    and the row hooks of K1, #6, #7 and K4 against their plain versions and
    against the rows of their call on the whole grid."""
    import numpy as np
    import torch

    from fpr_tpu_torch.core.config import NSConfig
    from fpr_tpu_torch.models.navier_stokes import fast_mg_default
    from fpr_tpu_torch.ops import ds, dual_time, ns_fused, transfer, vcycle_legs
    from fpr_tpu_torch.ops.rows import Rows
    from fpr_tpu_torch.solvers import dist_mg_ds

    log("== phase 3, sharded tiers: dual_timek_padded (#9), dual_time boxes (#8), row hooks "
        "of defect (K1), smooth2r_split (#6), corr_smooth2 (#7), ns_fused (K4)")
    dev = torch.device("cuda", 0) if dev is None else dev
    rng = np.random.default_rng(3)
    nsh = 4
    nzl = n // nsh
    cf = dual_time.coeffs(**diffusion_kw((n, n, n)))
    Ht = torch.tensor(rng.random((n, n, n), dtype=np.float32), device=dev)
    H = torch.tensor(rng.random((n, n, n), dtype=np.float32), device=dev)
    for K in (2, 3):
        glob, _ = dual_time._dual_timek_cuda(Ht, H.clone(), K, cf)
        for d in (0, 1, nsh - 1):
            z0 = d * nzl
            Hp = torch.nn.functional.pad(H, (0, 0, 0, 0, K, K))[z0:z0 + nzl + 2 * K].clone()
            Ht_k = torch.nn.functional.pad(Ht, (0, 0, 0, 0, K - 1, K - 1))[
                z0:z0 + nzl + 2 * K - 2].clone()
            zb = (1 if d == 0 else -K, nzl - 2 if d == nsh - 1 else nzl - 1 + K)
            # the result's ghost planes are unspecified: NaN before the call
            scratch = torch.empty_like(Hp)
            scratch[:K] = scratch[-K:] = float("nan")
            got = dual_time._dual_time_stepk_padded_cuda(Ht_k, Hp, K, cf, zb, scratch)
            want = dual_time.dual_time_stepk_padded_plain(Ht_k, Hp.clone(), K, cf, zb)
            tag = f"shard {d} of {nsh}, K={K}"
            # the owned planes
            kc.fields("dual_timek_padded", (got[0][K:K + nzl],), (want[0][K:K + nzl],), tag)
            kc.sums("dual_timek_padded", got[1:], want[1:], f"{tag} last sumsq")
            kc.fields("dual_timek_padded", (got[0][K:K + nzl],), (glob[z0:z0 + nzl],),
                      f"{tag} owned planes vs the global #10")
            del got, want, scratch
        del glob
    # the timed call: an interior shard of phase 14, K=3, buffers reused
    K = 3
    Hp = torch.nn.functional.pad(H, (0, 0, 0, 0, K, K))[nzl:2 * nzl + 2 * K].clone()
    Ht_k = torch.nn.functional.pad(Ht, (0, 0, 0, 0, K - 1, K - 1))[nzl:2 * nzl + 2 * K - 2]
    Ht_k = Ht_k.clone()
    scratch, part = torch.empty_like(Hp), dual_time.fused_partials(Hp, nzl, K)
    a = (Ht_k, Hp, K, cf, (-K, nzl - 1 + K))
    sweep_cells = sum(nzl + 2 * (K - j) for j in range(1, K + 1)) * n * n
    # the function's result is the owned planes and the norm: the ghost
    # planes of the returned buffer are unspecified
    kc.timed("dual_timek_padded",
             lambda: dual_time._dual_time_stepk_padded_cuda(*a, scratch, part),
             lambda: dual_time.dual_time_stepk_padded_plain(*a, scratch, part),
             (Ht_k, Hp), tuple(Hp.shape), ["dual_timek_kernel"], flops=27 * sweep_cells,
             result=lambda out: (out[0][K:K + nzl], out[1]))
    del Ht, H, Hp, Ht_k, scratch, part
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # #8's boxes: a 2x2x2 block of phase 14 (64^3 local, fully ghost-padded)
    # and the overlap's interior box with its one-plane edge launches
    m = 66
    cf = dual_time.coeffs(**diffusion_kw((128, 128, 128)))
    Ht = torch.tensor(rng.random((m, m, m), dtype=np.float32), device=dev)
    H = torch.tensor(rng.random((m, m, m), dtype=np.float32), device=dev)
    for box in ((2, 64, 2, 64, 2, 64), (1, 63, 2, 64, 1, 63), (1, 64, 1, 64, 1, 64)):
        for window in ((1, 64), (1, 1), (64, 64)):
            part_k = dual_time.box_partials(H, window[1] - window[0] + 1)
            part_p = H.new_zeros(window[1] - window[0] + 1)
            out_k = torch.full_like(H, float("nan"))
            out_p = torch.full_like(H, float("nan"))
            dual_time._dual_time_box_cuda(Ht, H, cf, box, window, out_k, part_k)
            dual_time.dual_time_box_plain(Ht, H, cf, box, window, out_p, part_p)
            tag = f"box {box} window {window}"
            sl = slice(window[0], window[1] + 1)
            kc.fields("dual_time", (out_k[sl],), (out_p[sl],), tag)
            kc.sums("dual_time", (part_k.sum(),), (part_p.sum(),), f"{tag} sumsq")
    del Ht, H

    # the row hooks at phase 16's plan: 2049x513 on 4 row shards
    ny, nx, nd = 513, 2049, 4
    G = dist_mg_ds.G
    ny_l = dist_mg_ds.plan_shards(ny, nx, nd, fast_mg_default(NSConfig(nx=nx, ny=ny)).mg,
                                  257).ny_l
    h = 1.0 / 512

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)

    def window(a, d):
        ap = torch.nn.functional.pad(a, (0, 0, G, nd * ny_l + G - ny))
        return ap[..., d * ny_l:d * ny_l + ny_l + 2 * G, :].contiguous()

    def rows(d):
        return Rows(d * ny_l - G, ny, (G, G + ny_l))

    def owned(name, local, glob, d, tag):
        k = min(ny_l, ny - d * ny_l)
        kc.fields(name, (local[..., G:G + k, :],), (glob[..., d * ny_l:d * ny_l + k, :],),
                  f"{tag} shard {d}: owned rows vs the whole grid's")

    u64 = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float64, device=dev)
    u = torch.stack([u64.float(), (u64 - u64.float().double()).float()])
    f, e = rand(1, ny, nx), rand(ny, nx, scale=1e-3)
    cT = torch.tensor(41.25, dtype=torch.float32, device=dev)
    for tag, c, kw in (("S", 0.0, dict(velocity_max=True)), ("T", cT, dict(apply_bcs=True))):
        C = ds.defect_scalars(c, h, dev)
        c_zero = not isinstance(c, torch.Tensor)
        whole = ds._defect_cuda(u, f, e, 1.0, h, C, c_zero, **kw)
        for d in range(nd):
            a = (window(u, d), window(f, d), window(e, d), 1.0, h, C, c_zero)
            got = ds._defect_cuda(*a, rows=rows(d), **kw)
            want = ds.defect_pass_plain(*a, rows=rows(d), **kw)
            kc.fields("defect", got[:2], want[:2], f"{tag} rows shard {d}")
            kc.sums("defect", got[2][:1], want[2][:1], f"{tag} rows shard {d} sumsq")
            kc.sums("defect", got[2][1:3], want[2][1:3], f"{tag} rows shard {d} maxima",
                    exact=True)
            owned("defect", got[0], whole[0], d, f"K1 {tag}")
            owned("defect", got[1], whole[1], d, f"K1 {tag} r")
    f2, u2 = rand(ny, nx), rand(ny, nx)
    coarse = rand((ny - 1) // 2 + 1, (nx - 1) // 2 + 1, scale=1e-2)
    leg_cases = [(ns, elim, c) for ns in range(1, 7)
                 for elim, c in ((False, torch.zeros((), device=dev)), (True, cT))]
    for ns, elim, c in leg_cases:
        whole_dn = vcycle_legs._smooth2r_split_cuda(u2, f2, h, c, 0.8, ns, elim)
        whole_dn0 = vcycle_legs._smooth2r_split_cuda(None, f2, h, c, 0.8, ns, elim)
        corrx = transfer.x_interleave_coarse(coarse, apply_bcs=elim)
        whole_up, _ = vcycle_legs._corr_smooth2_cuda(u2, f2, corrx, h, c, 0.8, ns, elim)
        padded = torch.nn.functional.pad(corrx, (0, 0, G // 2, nd * ny_l // 2 + G))
        tag = f"ns={ns} elim={elim}"
        for d in range(nd):
            for uu, whole in ((window(u2, d), whole_dn), (None, whole_dn0)):
                a = (uu, window(f2, d), h, c, 0.8, ns, elim, rows(d))
                got = vcycle_legs._smooth2r_split_cuda(*a)
                want = vcycle_legs.smooth_down_plain(*a)
                kc.fields("smooth2r_split", got, want, f"{tag} rows shard {d}")
                owned("smooth2r_split", got[0], whole[0], d, f"#6 {tag} u")
                owned("smooth2r_split", got[1], whole[1], d, f"#6 {tag} res")
            win = padded[d * ny_l // 2:d * ny_l // 2 + (ny_l + 2 * G) // 2 + 1]
            a = (window(u2, d), window(f2, d), win, h, c, 0.8, ns, elim, False, None, rows(d))
            got = vcycle_legs._corr_smooth2_cuda(*a)
            want = vcycle_legs.corr_up_plain(*a)
            kc.fields("corr_smooth2", got[:1], want[:1], f"{tag} rows shard {d}")
            owned("corr_smooth2", got[0], whole_up, d, f"#7 {tag}")
    TW = torch.stack([rand(ny, nx, scale=0.3) + 0.5, rand(ny, nx, scale=10.0)])
    S = rand(ny, nx, scale=0.1)
    dt = torch.tensor(1.9e-6, dtype=torch.float32, device=dev)
    for mode, beta in (("explicit", 0.0), ("rhs", 0.5)):
        scal = (dt, cT, cT * 100.0) if mode == "rhs" else (dt, None, None)
        whole, _, _ = ns_fused._ns_fused_cuda(TW, S, scal, h, 0.01, 1e6, 1.0, beta, mode, False)
        for d in range(nd):
            a = (window(TW, d), window(S, d), scal, h, 0.01, 1e6, 1.0, beta, mode, False,
                 rows(d))
            ok, _, sk = ns_fused._ns_fused_cuda(*a)
            op, _, sp = ns_fused.ns_fused_plain(*a)
            kc.fields("ns_fused", (ok,), (op,), f"{mode} rows shard {d}")
            kc.sums("ns_fused", sk[:2], sp[:2], f"{mode} rows shard {d} sums")
            owned("ns_fused", ok, whole, d, f"K4 {mode}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def phase_kernels_cols(kc: KernelCheck, dev=None, n=2049):
    """The column hooks of K1, #6 and #7 (still phase 3): the four windows of
    a 2x2 split of n^2 at phase 17's fine-level plan, against their plain
    versions and against the owned cells of the call on the whole grid,
    all bitwise."""
    import numpy as np
    import torch

    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.ops import ds, transfer, vcycle_legs
    from fpr_tpu_torch.solvers import dist_mg_ds

    log(f"== phase 3, 2D mesh: row and column hooks of defect (K1), smooth2r_split (#6), "
        f"corr_smooth2 (#7) on a 2x2 split of {n}^2")
    dev = torch.device("cuda", 0) if dev is None else dev
    rng = np.random.default_rng(4)
    G, GX = dist_mg_ds.G, dist_mg_ds.GX
    plan = dist_mg_ds.plan_shards_2d(n, n, 2, 2, MGConfig(coarse_size=513,
                                                          coarse_solver=CoarseSolver.DST), 513)
    ny_l, nx_l = plan.ny_l, plan.nx_l
    h = 1.0 / (n - 1)
    split = [(dy, dx) for dy in range(2) for dx in range(2)]

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)

    def window(a, dy, dx):
        ap = torch.nn.functional.pad(a, (GX, 2 * nx_l + GX - n, G, 2 * ny_l + G - n))
        return ap[..., dy * ny_l:dy * ny_l + ny_l + 2 * G,
                  dx * nx_l:dx * nx_l + nx_l + 2 * GX].contiguous()

    def owned(name, local, glob, dy, dx, tag):
        k, j = min(ny_l, n - dy * ny_l), min(nx_l, n - dx * nx_l)
        kc.fields(name, (local[..., G:G + k, GX:GX + j],),
                  (glob[..., dy * ny_l:dy * ny_l + k, dx * nx_l:dx * nx_l + j],),
                  f"{tag} shard ({dy},{dx}): owned cells vs the whole grid's")

    u64 = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float64, device=dev)
    u = torch.stack([u64.float(), (u64 - u64.float().double()).float()])
    f, e = rand(1, n, n), rand(n, n, scale=1e-3)
    del u64
    cT = torch.tensor(41.25, dtype=torch.float32, device=dev)
    for tag, c, kw in (("c=0", 0.0, dict(velocity_max=True, field_sumsq=True)),
                       ("c tensor", cT, dict())):
        C = ds.defect_scalars(c, h, dev)
        c_zero = not isinstance(c, torch.Tensor)
        whole = ds._defect_cuda(u, f, e, 1.0, h, C, c_zero, **kw)
        sums = []
        for dy, dx in split:
            hooks = plan.hooks(0, dy, dx)
            a = (window(u, dy, dx), window(f, dy, dx), window(e, dy, dx), 1.0, h, C, c_zero)
            got = ds._defect_cuda(*a, **hooks, **kw)
            want = ds.defect_pass_plain(*a, **hooks, **kw)
            kc.fields("defect", got[:2], want[:2], f"{tag} 2D shard ({dy},{dx})")
            kc.sums("defect", (got[2][0], got[2][3]), (want[2][0], want[2][3]),
                    f"{tag} 2D shard ({dy},{dx}) sums")
            kc.sums("defect", got[2][1:3], want[2][1:3], f"{tag} 2D shard ({dy},{dx}) maxima",
                    exact=True)
            owned("defect", got[0], whole[0], dy, dx, f"K1 {tag}")
            owned("defect", got[1], whole[1], dy, dx, f"K1 {tag} r")
            sums.append(got[2])
        kc.sums("defect", (sum(float(p[0]) for p in sums),), (whole[2][0],),
                f"{tag} 2D shards' sum(r^2) vs the whole grid's")
        del whole
    del u, f, e
    f2, u2 = rand(n, n), rand(n, n)
    c = torch.zeros((), device=dev)
    for ns in range(1, 7):
        for uu in (None, u2):
            whole = vcycle_legs._smooth2r_split_cuda(uu, f2, h, c, 0.8, ns, False)
            for dy, dx in split:
                a = (None if uu is None else window(uu, dy, dx), window(f2, dy, dx), h, c, 0.8,
                     ns, False)
                hooks = plan.hooks(0, dy, dx)
                got = vcycle_legs._smooth2r_split_cuda(*a, **hooks)
                want = vcycle_legs.smooth_down_plain(*a, **hooks)
                tag = f"ns={ns} zero_u={uu is None}"
                kc.fields("smooth2r_split", got, want, f"{tag} 2D shard ({dy},{dx})")
                owned("smooth2r_split", got[0], whole[0], dy, dx, f"#6 {tag} u")
                owned("smooth2r_split", got[1], whole[1], dy, dx, f"#6 {tag} res")
            del whole
    coarse = rand((n - 1) // 2 + 1, (n - 1) // 2 + 1, scale=1e-2)
    corrx = transfer.x_interleave_coarse(coarse)
    padded = torch.nn.functional.pad(corrx, (GX, 2 * nx_l + GX - n, G // 2, ny_l + G))
    for ns in range(1, 7):
        whole, rr = vcycle_legs._corr_smooth2_cuda(u2, f2, corrx, h, c, 0.8, ns, False, True)
        sums = []
        for dy, dx in split:
            win = padded[dy * ny_l // 2:dy * ny_l // 2 + (ny_l + 2 * G) // 2 + 1,
                         dx * nx_l:dx * nx_l + nx_l + 2 * GX].contiguous()
            a = (window(u2, dy, dx), window(f2, dy, dx), win, h, c, 0.8, ns, False, True, None)
            hooks = plan.hooks(0, dy, dx)
            got = vcycle_legs._corr_smooth2_cuda(*a, **hooks)
            want = vcycle_legs.corr_up_plain(*a, **hooks)
            kc.fields("corr_smooth2", got[:1], want[:1], f"ns={ns} 2D shard ({dy},{dx})")
            kc.sums("corr_smooth2", got[1:], want[1:], f"ns={ns} 2D shard ({dy},{dx}) norm")
            owned("corr_smooth2", got[0], whole, dy, dx, f"#7 ns={ns}")
            sums.append(float(got[1]) ** 2)
        kc.sums("corr_smooth2", (sum(sums),), (float(rr) ** 2,),
                f"ns={ns} 2D shards' norm^2 vs the whole grid's")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def phase_kernels_helm(kc: KernelCheck, dev=None, ny=513, nx=2049):
    """K4's with_helm_defect mode (still phase 3) at the NS shape: against
    its plain version and against the separate rhs pass and two K1 passes
    (T with the BCs), bitwise; timed as the ns_fused_helm row."""
    import numpy as np
    import torch

    from fpr_tpu_torch.ops import ds, ns_fused

    log(f"== phase 3, ns_fused with_helm_defect (K4) at {ny}x{nx}")
    dev = torch.device("cuda", 0) if dev is None else dev
    rng = np.random.default_rng(5)
    h = 1.0 / (ny - 1)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)

    TW = torch.stack([rand(ny, nx, scale=0.3) + 0.5, rand(ny, nx, scale=10.0)])
    S = rand(ny, nx, scale=0.1)
    dt = torch.tensor(1.9e-6, dtype=torch.float32, device=dev)
    cT = torch.tensor(1.0, dtype=torch.float32, device=dev) / (0.5 * dt)
    cW = cT / torch.tensor(0.01, dtype=torch.float32, device=dev)
    a = (TW, S, (dt, cT, cW), h, 0.01, 1e6, 1.0, 0.5, "rhs", False, None, True)
    ok, rk, sk = ns_fused._ns_fused_cuda(*a)
    op, rp, sp = ns_fused.ns_fused_plain(*a)
    kc.fields("ns_fused_helm", (ok, rk), (op, rp), "rhs beta=0.5")
    kc.sums("ns_fused_helm", sk[[0, 1, 2, 5, 6, 7]], sp[[0, 1, 2, 5, 6, 7]], "rhs beta=0.5 sums")
    # the separate passes: the rhs, then K1 on (T, 0) with the BCs and on (W, 0)
    out = ns_fused.ns_fused_rp(TW, S, dt, h, 0.01, 1e6, beta=0.5, mode="rhs", cT=cT, cW=cW)
    zl = torch.zeros_like(TW[0])
    _, rT, _ = ds.defect_pass(torch.stack([TW[0], zl]), out[0:1], None, 0.0, h, cT,
                              apply_bcs=True)
    _, rW, _ = ds.defect_pass(torch.stack([TW[1], zl]), out[1:2], None, 0.0, h, cW)
    kc.fields("ns_fused_helm", (ok, rk[0], rk[1]), (out, rT, rW),
              "against the rhs pass and two defect passes")
    # bytes: T, W, S read, T', W', rT, rW written; about 200 flops a cell
    kc.timed("ns_fused_helm", lambda: ns_fused._ns_fused_cuda(*a),
             lambda: ns_fused.ns_fused_plain(*a), (TW, S), (ny, nx), ["ns_kernel"],
             flops=200 * ny * nx, result=lambda o: (o[0], o[1]))
    if dev.type == "cuda":
        torch.cuda.synchronize()


def diffusion_kw(shape):
    """The step constants of part 1's grid of this shape, as the solve has them."""
    from fpr_tpu_torch.core.grid import Grid3D, pseudo_timestep

    nz, ny, nx = shape
    g = Grid3D(nx, ny, nz)
    return dict(dt=0.2, dtau=pseudo_timestep(g.dx, g.dy, g.dz, 1.0), dx=g.dx, dy=g.dy,
                dz=g.dz, D=1.0)


def phase_kernels_3d(kc: KernelCheck):
    """Part 1's kernels against their plain versions (still phase 3)."""
    import numpy as np
    import torch

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.ops import ds3d, dual_time

    log("== phase 3, part 1: dual_time, dual_timek (the fused K-sweep kernel) and ds3d "
        "against their plain versions")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    ragged = (67, 45, 130)
    for shape in ((512, 512, 512), ragged):
        cells = int(np.prod(shape))
        cf = dual_time.coeffs(**diffusion_kw(shape))
        Ht = torch.tensor(rng.random(shape, dtype=np.float32), device=dev)
        Hs = torch.tensor(rng.random(shape, dtype=np.float32), device=dev)
        got = dual_time._dual_time_cuda(Ht, Hs, cf)
        want = dual_time.dual_time_step_plain(Ht, Hs, cf)
        kc.fields("dual_time", got[:1], want[:1], f"{shape}")
        kc.sums("dual_time", got[1:], want[1:], f"{shape} sumsq")
        del got, want
        # the fused kernel: K = 5 runs as two passes; Hs is never written
        for K in ((3,) if shape != ragged else (1, 2, 3, 4, 5)):
            Hs0 = Hs.clone()
            got = dual_time._dual_timek_cuda(Ht, Hs, K, cf)
            want = dual_time.dual_time_stepk_plain(Ht, Hs.clone(), K, cf)
            kc.fields("dual_timek", got[:1], want[:1], f"{shape} K={K}")
            kc.sums("dual_timek", got[1:], want[1:], f"{shape} K={K} last sumsq")
            kc.fields("dual_timek", (Hs,), (Hs0,), f"{shape} K={K}: its input unwritten")
            del got, want, Hs0
        if shape != ragged:
            # the solve's steady state: ping-pong buffers and partials reused
            out, part = torch.empty_like(Hs), kernels.partials_3d(shape, dev)
            kc.timed("dual_time", lambda: dual_time._dual_time_cuda(Ht, Hs, cf, out, part),
                     lambda: dual_time.dual_time_step_plain(Ht, Hs, cf, out),
                     (Ht, Hs), shape, ["dual_time_kernel"], flops=27 * cells)
            part = dual_time.fused_partials(Hs, shape[0], 3)
            kc.timed("dual_timek",
                     lambda: dual_time._dual_timek_cuda(Ht, Hs, 3, cf, out, part),
                     lambda: dual_time.dual_time_stepk_plain(Ht, Hs, 3, cf, out),
                     (Ht, Hs), shape, ["dual_timek_kernel"], flops=3 * 27 * cells)
            del out, part
        del Ht, Hs
        torch.cuda.empty_cache()
    for shape in ((128, 128, 128), ragged):
        cells = int(np.prod(shape))
        cp = ds3d.ds_coeffs(**diffusion_kw(shape))
        H = torch.tensor(rng.random(shape), device=dev)
        Ht = ds3d.to_ds(H)
        Hs = ds3d.to_ds(H + 1e-3 * torch.tensor(rng.standard_normal(shape), device=dev))
        got = ds3d._ds3d_cuda(Ht, Hs, cp)
        want = ds3d.ds3d_step_plain(Ht, Hs, cp)
        kc.fields("ds3d", got[:1], want[:1], f"{shape} hi/lo")
        kc.sums("ds3d", got[1:], want[1:], f"{shape} sumsq")
        if shape != ragged:
            out, part = torch.empty_like(Hs), kernels.partials_3d(shape, dev)
            kc.timed("ds3d", lambda: ds3d._ds3d_cuda(Ht, Hs, cp, out, part),
                     lambda: ds3d.ds3d_step_plain(Ht, Hs, cp, out), (Ht, Hs), shape,
                     ["ds3d_kernel"], flops=190 * cells)
    torch.cuda.synchronize()
    phase_kernels_loop_test(kc, rng, ragged)


def phase_kernels_loop_test(kc: KernelCheck, rng, ragged):
    """#8 and #11 in their tested form (the loop test finished in the
    launch) against the untested launch: the field bitwise, the sum within
    REL_SUM, err, it and go torch's formula of that sum, reruns bitwise;
    at 128^3 both forms of #8 timed, and #11's tested one (still phase 3)."""
    import numpy as np
    import torch

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.ops import ds3d, dual_time

    dev = torch.device("cuda", 0)

    def test_of(like, tol):
        return dual_time.loop_test(like, 0.2, 1000.0, tol, 100000)(
            like.new_full((), float("inf")), torch.full((), 5, dtype=torch.int32, device=dev),
            torch.ones((), dtype=torch.int32, device=dev))

    for shape in ((128, 128, 128), ragged):
        cells = int(np.prod(shape))
        H = torch.tensor(rng.random(shape), device=dev)
        Hs64 = H + 1e-3 * torch.tensor(rng.standard_normal(shape), device=dev)
        for name, Ht, Hs, cf, untested, tested, plain, flops in (
                ("dual_time", H.float(), Hs64.float(), dual_time.coeffs(**diffusion_kw(shape)),
                 dual_time._dual_time_cuda, dual_time._dual_time_tested_cuda,
                 dual_time.dual_time_step_plain, 27 * cells),
                ("ds3d", ds3d.to_ds(H), ds3d.to_ds(Hs64), ds3d.ds_coeffs(**diffusion_kw(shape)),
                 ds3d._ds3d_cuda, ds3d._ds3d_tested_cuda, ds3d.ds3d_step_plain, 190 * cells)):
            want, s_want = untested(Ht, Hs, cf)
            for tol in (0.0, 1e30):
                test, ref = test_of(Ht, tol), test_of(Ht, tol)
                got, s = tested(Ht, Hs, cf, test)
                kc.fields(f"{name}_tested", (got,), (want,), f"{shape} tol {tol}")
                kc.sums(f"{name}_tested", (s,), (s_want,), f"{shape} sumsq")
                dual_time.loop_test_plain((None, s), ref)
                for a, b in ((test.err, ref.err), (test.it, ref.it), (test.go, ref.go)):
                    require(torch.equal(a, b), f"{name}_tested {shape} tol {tol}: loop test "
                            f"{[float(t) for t in (test.err, test.it, test.go)]} against torch's "
                            f"{[float(t) for t in (ref.err, ref.it, ref.go)]}")
            same_bits(f"{name}_tested", f"{shape}", lambda: tested(Ht, Hs, cf, test_of(Ht, 0.0)))
            if shape != ragged:
                out, part, test = torch.empty_like(Hs), kernels.partials_3d(shape, dev), \
                    test_of(Ht, 0.0)
                if name == "dual_time":
                    kc.timed("dual_time_128", lambda: untested(Ht, Hs, cf, out, part),
                             lambda: plain(Ht, Hs, cf, out), (Ht, Hs), shape,
                             ["dual_time_kernel"], flops=flops)
                kc.timed(f"{name}_tested", lambda: tested(Ht, Hs, cf, test, out, part),
                         lambda: dual_time.loop_test_plain(plain(Ht, Hs, cf, out), test),
                         (Ht, Hs), shape, [f"{name}_kernel"], flops=flops)
            del Ht, Hs
    torch.cuda.synchronize()


def conv_matvec(u, h, c):
    """(nabla^2 - c) u on the interior as one torch.nn.functional.conv2d
    call: the library yardstick of the stencil pass's matvec mode."""
    import torch

    s = 1.0 / (h * h)
    w = torch.tensor([[0.0, s, 0.0], [s, -4.0 * s - c, s], [0.0, s, 0.0]], dtype=u.dtype,
                     device=u.device)
    return torch.nn.functional.conv2d(u[None, None], w[None, None])


def phase_kernels_host(kc: KernelCheck):
    """The host-loop tiers' kernels against their plain versions (still
    phase 3): the stencil pass #5 in every mode, the legs #6 and #7."""
    import numpy as np
    import torch

    from fpr_tpu_torch.ops import stencil2d, transfer, vcycle_legs
    from fpr_tpu_torch.ops import stencil_pass as sp

    log("== phase 3, host-loop tiers: stencil (#5), smooth2r_split (#6), corr_smooth2 (#7)")
    torch.backends.cudnn.allow_tf32 = False  # the conv2d yardstick in full float32
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2)
    for (ny, nx), dtype in (((513, 2049), torch.float32), ((4097, 4097), torch.float32),
                            ((2049, 2049), torch.float64)):
        h = 1.0 / (min(ny, nx) - 1)
        u = torch.tensor(rng.standard_normal((ny, nx)), dtype=dtype, device=dev)
        f = torch.tensor(rng.standard_normal((ny, nx)), dtype=dtype, device=dev)
        f64 = dtype == torch.float64
        rel = REL_SUM_F64 if f64 else REL_SUM
        word = u.element_size()
        tag = f"{ny}x{nx} {str(dtype).removeprefix('torch.')}"
        for c in (0.0, 41.25):
            ct = stencil2d.as_scalar(c, u)
            for mode in sp.MODES:
                ff = None if mode.startswith("matvec") else f
                for with_acc in (True, False):
                    what = f"{mode} {tag} c={c} sum={with_acc}"

                    def k_call(mode=mode, ff=ff, with_acc=with_acc):
                        return sp._stencil_cuda(mode, u, ff, h, ct, 0.8, with_acc)
                    got = k_call()
                    want = sp.stencil_plain(mode, u, ff, h, ct, 0.8, with_acc)
                    kc.fields("stencil", got[:1], want[:1], what)
                    if with_acc or mode == "matvec_dot":
                        # the sum, and the rms of a sum of squares
                        k = 1 if mode.startswith("matvec") else 2
                        kc.sums("stencil", got[1][:k], want[1][:k], what, rel=rel)
                    same_bits("stencil", what, k_call)
            got = sp.smooth2_rp(u, f, h, ct)
            with plain_kernels():
                want = sp.smooth2_rp(u, f, h, ct)
            kc.fields("stencil", got[:1], want[:1], f"smooth2_rp {tag} c={c}")
            kc.sums("stencil", got[1:], want[1:], f"smooth2_rp {tag} norm c={c}", rel=rel)
            # every public entry point is one launch, smooth2 included
            for name, call in (
                    ("smooth_rp", lambda: sp.smooth_rp(u, f, h, ct)),
                    ("smooth_rp no norm", lambda: sp.smooth_rp(u, f, h, ct, with_norm=False)),
                    ("smooth2_rp", lambda: sp.smooth2_rp(u, f, h, ct)),
                    ("smooth2_rp no norm", lambda: sp.smooth2_rp(u, f, h, ct, with_norm=False)),
                    ("residual_rp", lambda: sp.residual_rp(u, f, h, ct)),
                    ("matvec_rp", lambda: sp.matvec_rp(u, h, ct)),
                    ("matvec_rp with_dot", lambda: sp.matvec_rp(u, h, ct, with_dot=True)),
                    ("matvec_dot_rp", lambda: sp.matvec_dot_rp(u, h, ct)),
                    ("jacobi_step", lambda: sp.jacobi_step(u, f, h, ct)),
                    ("matvec", lambda: sp.matvec(u, h, h, ct))):
                one_launch("stencil", f"{name} {tag} c={c}", call)
        # each mode's time at this shape; bytes: each input read once, each
        # output written once
        c0 = stencil2d.as_scalar(0.0, u)
        for mode, ff, acc, words, ops in (
                ("smooth", f, True, 3, 10), ("smooth2", f, True, 3, 20),
                ("residual", f, False, 3, 10), ("matvec", None, False, 2, 10),
                ("matvec_dot", None, True, 1, 10)):
            def k_fn(mode=mode, ff=ff, acc=acc):
                return sp._stencil_cuda(mode, u, ff, h, c0, 0.8, acc)
            b_ms, _ = bound_of(words * word * ny * nx, ops * ny * nx,
                               PEAK_F64_FLOPS_S if f64 else PEAK_F32_FLOPS_S)
            dev_us = device_us(k_fn, ["stencil_kernel"])
            log(f"  stencil {mode:10s} {tag}: call {time_ms(k_fn) * 1e3:8.1f} us  kernel on the "
                f"device {dev_us} us  bound {b_ms * 1e3:.1f} us"
                + ("" if dev_us is None else f" ({b_ms * 1e3 / dev_us:.0%})")
                + ("" if mode != "matvec" else
                   f"  conv2d {time_ms(lambda: conv_matvec(u, h, 0.0)) * 1e3:.1f} us"))
        if f64:
            # the row: the matvec of krylov.cg with the PALLAS policy (phase 11)
            kc.timed("stencil", lambda: sp._stencil_cuda("matvec", u, None, h, c0, 0.8, False),
                     lambda: sp.stencil_plain("matvec", u, None, h, c0, 0.8, False), (u,),
                     (ny, nx), ["stencil_kernel"], flops=10 * ny * nx,
                     peak_flops=PEAK_F64_FLOPS_S, library=lambda: conv_matvec(u, h, 0.0))
            ref = conv_matvec(u, h, 0.0)[0, 0]
            mine = sp._stencil_cuda("matvec", u, None, h, c0, 0.8, False)[0][1:-1, 1:-1]
            log(f"  conv2d matvec {tag}: max abs diff to the kernel "
                f"{float((ref - mine).abs().max()):.3e} (another order of the sums)")
        del u, f
        torch.cuda.empty_cache()
    # ragged tiles: the last tile column and row partly or one cell wide
    for (ny, nx), dtype in ((shape, dtype) for shape in RAGGED
                            for dtype in (torch.float32, torch.float64)):
        u, f = (torch.tensor(rng.standard_normal((ny, nx)), dtype=dtype, device=dev)
                for _ in range(2))
        ct = stencil2d.as_scalar(41.25, u)
        for mode in sp.MODES:
            ff = None if mode.startswith("matvec") else f
            what = f"{mode} {ny}x{nx} {str(dtype).removeprefix('torch.')}"
            got = sp._stencil_cuda(mode, u, ff, 1.0 / 64, ct, 0.8, True)
            want = sp.stencil_plain(mode, u, ff, 1.0 / 64, ct, 0.8, True)
            kc.fields("stencil", got[:1], want[:1], what)
            k = 1 if mode.startswith("matvec") else 2
            kc.sums("stencil", got[1][:k], want[1][:k], what,
                    rel=REL_SUM_F64 if dtype == torch.float64 else REL_SUM)

    # the legs of vcycle_rp at the NS host loop's fine level
    ny, nx = 513, 2049
    h = 1.0 / 512
    f2 = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float32, device=dev)
    u2 = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float32, device=dev)
    coarse = torch.tensor(rng.standard_normal(((ny - 1) // 2 + 1, (nx - 1) // 2 + 1)) * 1e-2,
                          dtype=torch.float32, device=dev)
    cT = torch.tensor(41.25, dtype=torch.float32, device=dev)
    for ns in range(1, 7):
        for elim, c in ((False, stencil2d.as_scalar(0.0, f2)), (True, cT)):
            tag = f"{ny}x{nx} ns={ns} elim={elim}"
            for uu in (None, u2):
                got = vcycle_legs._smooth2r_split_cuda(uu, f2, h, c, 0.8, ns, elim)
                want = vcycle_legs.smooth_down_plain(uu, f2, h, c, 0.8, ns, elim)
                kc.fields("smooth2r_split", got, want, f"{tag} zero_u={uu is None}")
            corrx = transfer.x_interleave_coarse(coarse, apply_bcs=elim)
            got = vcycle_legs._corr_smooth2_cuda(u2, f2, corrx, h, c, 0.8, ns, elim, True)
            want = vcycle_legs.corr_up_plain(u2, f2, corrx, h, c, 0.8, ns, elim, True)
            kc.fields("corr_smooth2", got[:1], want[:1], tag)
            kc.sums("corr_smooth2", got[1:], want[1:], f"{tag} norm")
    # V(2,2): the default MGConfig of the mixed solves
    ns, c = 2, stencil2d.as_scalar(0.0, f2)
    corrx = transfer.x_interleave_coarse(coarse)
    a_down = (u2, f2, h, c, 0.8, ns, False)
    kc.timed("smooth2r_split", lambda: vcycle_legs._smooth2r_split_cuda(*a_down),
             lambda: vcycle_legs.smooth_down_plain(*a_down), a_down, (ny, nx),
             ["leg_kernel"], flops=(ns + 1) * 10 * ny * nx)
    a_up = (u2, f2, corrx, h, c, 0.8, ns, False, True)
    kc.timed("corr_smooth2", lambda: vcycle_legs._corr_smooth2_cuda(*a_up),
             lambda: vcycle_legs.corr_up_plain(*a_up), a_up, (ny, nx),
             ["leg_kernel"], flops=(ns * 10 + 2) * ny * nx)
    # one launch of the leg kernel a call, the public entry points too
    for name, fn in (
            ("smooth2r_split", lambda: vcycle_legs.smooth2r_split(u2, f2, h, c, 0.8, ns=ns)),
            ("corr_smooth2", lambda: vcycle_legs.corr_smooth2(u2, f2, coarse, h, c, 0.8,
                                                              with_norm=True, ns=ns)),
            ("corr_smooth2_raw", lambda: vcycle_legs.corr_smooth2_raw(
                u2, f2, transfer.x_interleave_coarse(coarse), h, c, 0.8, with_norm=True,
                ns=ns)),
            ("smooth_down", lambda: vcycle_legs.smooth_down(None, f2, h, c, 0.8, ns=ns)),
            ("corr_up", lambda: vcycle_legs.corr_up(u2, f2, corrx, h, c, 0.8, ns=ns,
                                                    with_norm=True))):
        n = kernel_launches(fn, "leg_kernel")
        require(n == 1, f"{name}: {n} launches of the leg kernel in one call")
    torch.cuda.synchronize()


def phase_mg():
    import numpy as np
    import torch

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.ops import stencil2d
    from fpr_tpu_torch.solvers.multigrid import mg_solve_ds

    log("== phase 4: MG row, mg_solve_ds 4097^2, DST-513, V(5,5), tol 1e-6")
    n, tol = 4097, 1e-6
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST,
                   pre_smooth=5, post_smooth=5)
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    b = torch.tensor(b, device="cuda")
    mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=cfg, return_pair=True)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    (uh, ul), r, it = mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=cfg, return_pair=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.sync_launches()
    b64 = b.double()
    rel = float(stencil2d.rms(stencil2d.residual(uh.double() + ul.double(), b64, h, 0.0))
                / stencil2d.rms(b64))
    log(f"outers {it}  solve {secs:.4f} s  true f64 r_rms/f_rms {rel:.3e}  "
        f"launches {counts}")
    require(it <= 30, f"no convergence in 30 outers ({it})")
    require(rel <= tol, f"true f64 relative residual {rel:.3e} > {tol}")
    for k in ("defect", "smooth_down", "corr_up"):
        require(counts[k] > 0, f"MG row never launched {k}")
    return it, uh.double() + ul.double()


def ns_cfg(beta):
    from fpr_tpu_torch.core.config import NSConfig

    return NSConfig(nx=2049, ny=513, ttot=0.005, beta=beta, Pr=0.01, tol=1e-7,
                    niters=50)


def compare_runs(a, b, what, rel=1e-5):
    """Kernel run a against plain run b: equal counts and time, near fields."""
    import numpy as np

    require(a.steps == b.steps, f"{what}: steps {a.steps} vs plain {b.steps}")
    require(a.sim_time == b.sim_time, f"{what}: sim_time {a.sim_time!r} vs {b.sim_time!r}")
    for name in ("T", "W", "S"):
        x, y = getattr(a, name), getattr(b, name)
        err = float(np.abs(x - y).max())
        require(err <= rel * float(np.abs(y).max()),
                f"{what}: {name} differs from plain by {err:.3e}")
        log(f"  {what} {name}: max abs diff to plain {err:.3e}")


def phase_ns_explicit():
    import numpy as np
    import torch

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.models.navier_stokes import simulate_fast

    log("== phase 5: NS explicit 2049x513, Pr=0.01, tol 1e-7, ttot 0.005")
    cfg = ns_cfg(0.0)
    kernels.reset_launches()
    out = simulate_fast(cfg, seed=0, device="cuda")
    counts = kernels.sync_launches()
    log(f"timed_iters {out.timed_iters}  steps {out.steps}  sim_time {out.sim_time!r}  "
        f"timed {out.t_elapsed:.3f} s  launches {counts}")
    require(out.timed_iters == 8736, f"timed_iters {out.timed_iters} != 8736")
    for name in ("T", "W", "S"):
        require(np.isfinite(getattr(out, name)).all(), f"non-finite {name}")
    for k in NS_KERNELS:
        require(counts[k] > 0, f"the NS main path never launched {k}")
    k20 = simulate_fast(cfg, seed=0, max_steps=20, device="cuda")
    with plain_kernels():
        p20 = simulate_fast(cfg, seed=0, max_steps=20, device="cuda")
    compare_runs(k20, p20, "explicit 20 steps")
    torch.cuda.synchronize()
    return counts, out


def phase_ns_semi():
    import numpy as np

    from fpr_tpu_torch.models.navier_stokes import simulate_fast

    log("== phase 6: NS semi-implicit 2049x513, beta=0.5")
    cfg = ns_cfg(0.5)
    out = simulate_fast(cfg, seed=0, device="cuda")
    log(f"timed_iters {out.timed_iters}  steps {out.steps}  timed {out.t_elapsed:.3f} s")
    require(np.isfinite(out.T).all() and np.isfinite(out.W).all(), "non-finite fields")
    require(-0.5 <= out.T.min() and out.T.max() <= 1.5,
            f"T out of [-0.5, 1.5]: [{out.T.min()}, {out.T.max()}]")
    with plain_kernels():
        plain = simulate_fast(cfg, seed=0, device="cuda")
    log(f"plain: steps {plain.steps}  timed {plain.t_elapsed:.3f} s")
    compare_runs(out, plain, "semi", rel=1e-4)
    return out


def diffusion_run(cfg, what):
    """One diffusion3d.solve on the card with the launch counts of that run."""
    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.models import diffusion3d

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = diffusion3d.solve(cfg, device="cuda")
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.sync_launches().items() if v}
    log(f"{what}: iters_total {out.iters_total}  timed_iters {out.timed_iters}  "
        f"converged {out.converged}  solve {secs:.3f} s (timed window "
        f"{out.bench.delta_t:.4f} s)  launches {counts}")
    require(out.H.shape == (cfg.nz, cfg.ny, cfg.nx), f"{what}: H shape {out.H.shape}")
    return out, kernels.sync_launches()


def compare_diffusion(cfg, what, k=None):
    """cfg through the kernels (k, if that run was made already) and through
    their plain versions: equal iteration counts, bitwise-equal fields."""
    import numpy as np

    from fpr_tpu_torch.models import diffusion3d

    if k is None:
        k = diffusion3d.solve(cfg, device="cuda")
    with plain_kernels():
        p = diffusion3d.solve(cfg, device="cuda")
    require((k.iters_total, k.timed_iters) == (p.iters_total, p.timed_iters),
            f"{what}: iterations {k.iters_total}/{k.timed_iters} vs plain "
            f"{p.iters_total}/{p.timed_iters}")
    err = float(np.abs(k.H - p.H).max())
    require(np.array_equal(k.H, p.H), f"{what}: fields differ from plain by {err:.3e}")
    log(f"  {what}: {k.iters_total} iterations on both, fields bitwise equal")
    return k


def probe(out):
    """H(4.5, 4.5, 4.5) of a solve on the default 10^3 domain."""
    from fpr_tpu_torch.core.grid import Grid3D
    from fpr_tpu_torch.models import diffusion3d

    nz, ny, nx = out.H.shape
    return diffusion3d.probe_nearest(out.H, Grid3D(nx, ny, nz))


def phase_diffusion_bench():
    import dataclasses

    import numpy as np

    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy

    log("== phase 7: diffusion bench row, 512^3 float32, PALLAS check_every=3, "
        "ttot 0.8 (3 warm-up steps, 1 timed)")
    cap = 300
    cfg = DiffusionConfig(nx=512, ny=512, nz=512, ttot=0.8, dt=0.2, tol=1e-6,
                          iter_max=cap, policy=ExecutionPolicy.PALLAS, check_every=3)
    out, counts = diffusion_run(cfg, "512^3 K=3")
    log(f"capped: every physical step stops at iter_max={cap} iterations, as the bench "
        f"row caps it; converged {out.converged}")
    require(np.isfinite(out.H).all(), "non-finite H")
    require(out.timed_iters == cap and out.iters_total == 4 * cap,
            f"expected {cap} timed and {4 * cap} iterations in all, got "
            f"{out.timed_iters}/{out.iters_total}")
    require(counts["dual_timek"] > 0, "the 512^3 K=3 run never launched dual_timek")
    log(f"timed_iters {out.timed_iters}  seconds {out.bench.delta_t:.4f}  "
        f"ms per iteration {out.bench.delta_t / out.timed_iters * 1e3:.4f}  "
        f"T_eff {out.bench.throughput / 1e9:.1f} GB/s (counted, fused model)  "
        f"launches dual_timek {counts['dual_timek']}")
    compare_diffusion(dataclasses.replace(cfg, iter_max=30), "512^3 K=3, 30 iterations a step")
    return counts, out


REF_PROBE_F32 = 0.0799870          # 128^3, ttot 2, tol 1e-6 (the reference's val column)
# 128^3, ttot 2, tol 1e-6, check_every 3 through K launches of #8's one-sweep
# kernel on an H100 (iters_total): the fused kernel's norm adds its dH^2 in
# another order, so a stop may move by one check (3 iterations)
K3_ITERS_UNFUSED = 18984
REF_PROBE_DS = 0.07996040957329686  # 128^3, ttot 2, tol 1e-10 (error_vs_tolerance.csv)


def phase_diffusion_f32():
    import dataclasses

    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy

    log("== phase 8: diffusion 128^3 float32, ttot 2, tol 1e-6, converged")
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=2.0, tol=1e-6,
                          policy=ExecutionPolicy.PALLAS, check_every=1)
    out, counts = diffusion_run(cfg, "128^3 K=1")
    v = probe(out)
    log(f"probe H(4.5,4.5,4.5) {v:.7f} (reference {REF_PROBE_F32})")
    require(out.converged, "128^3 K=1 did not converge")
    require(abs(v - REF_PROBE_F32) <= 1e-4, f"probe {v} is not within 1e-4 of {REF_PROBE_F32}")
    require(counts["dual_time"] > 0, "the 128^3 K=1 run never launched dual_time")
    out3, counts3 = diffusion_run(dataclasses.replace(cfg, check_every=3), "128^3 K=3")
    v3 = probe(out3)
    log(f"probe H(4.5,4.5,4.5) {v3:.7f}; {out3.iters_total} iterations (K launches of the "
        f"one-sweep kernel, the norm summed per launch block: {K3_ITERS_UNFUSED})")
    require(counts3["dual_timek"] > 0, "the 128^3 K=3 run never launched dual_timek")
    require(out3.converged and abs(v3 - REF_PROBE_F32) <= 1e-4, "128^3 K=3 run failed")
    compare_diffusion(cfg, "128^3 K=1 converged", k=out)
    return counts, out


def phase_diffusion_ds():
    import dataclasses

    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy

    log("== phase 9: diffusion 128^3 double-single, ttot 2, tol 1e-10")
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=2.0, tol=1e-10,
                          policy=ExecutionPolicy.PALLAS_DS)
    out, counts = diffusion_run(cfg, "128^3 ds")
    v = probe(out)
    log(f"probe H(4.5,4.5,4.5) {v!r} (reference {REF_PROBE_DS!r}, diff {v - REF_PROBE_DS:.3e})")
    require(out.converged, "128^3 ds did not converge")
    require(abs(v - REF_PROBE_DS) <= 1e-6, f"probe {v} is not within 1e-6 of {REF_PROBE_DS}")
    require(counts["ds3d"] > 0, "the ds run never launched ds3d")
    # H = hi + lo is exact in float64, so equal H means equal hi/lo pairs
    compare_diffusion(dataclasses.replace(cfg, iter_max=200), "128^3 ds, 200 iterations a step")
    return counts


def sync():
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def poisson_rhs(n, dtype):
    """The MG rows' right-hand side: uniform random interior, zero ring."""
    import numpy as np
    import torch

    b = np.zeros((n, n), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    return torch.tensor(b, device=DEVICE)


def true_rel(u, b, h, c=0.0):
    """rms of the float64 residual of u over rms(b)."""
    from fpr_tpu_torch.ops import stencil2d

    b64 = b.double()
    return float(stencil2d.rms(stencil2d.residual(u.double(), b64, h, c)) / stencil2d.rms(b64))


def counted(fn):
    """fn() with the launch counts set to 0 just before it: (result,
    seconds to the end of its device work, counts)."""
    from fpr_tpu_torch import kernels

    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0, kernels.sync_launches()


def phase_mg_mixed(smi, n=4097):
    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.core.config import MGConfig
    from fpr_tpu_torch.solvers.multigrid import mg_solve_mixed

    log(f"== phase 10: MG mixed {n}^2, default MGConfig (coarse 5, Jacobi, V(2,2)), tol 1e-6")
    tol = 1e-6
    h = 1.0 / (n - 1)
    b = poisson_rhs(n, "float64")

    def solve():
        return mg_solve_mixed(b.new_zeros(b.shape), b, h, 0.0, tol, 30, cfg=MGConfig())

    solve()  # warm-up
    built(f"MG mixed {n}^2")
    (u, r, it), secs, counts = counted(solve)
    rel = true_rel(u, b, h)
    log(f"outers {it}  solve {secs:.4f} s  r_rms/f_rms (estimate) "
        f"{float(r) / float((b * b).mean().sqrt()):.3e}  true f64 r_rms/f_rms {rel:.3e}  "
        f"launches { {k: v for k, v in counts.items() if v} }")
    require(it <= 30, f"no convergence in 30 outers ({it})")
    require(rel <= tol, f"true f64 relative residual {rel:.3e} > {tol}")
    for k in ("smooth2r_split", "corr_smooth2"):
        require(counts[k] > 0, f"MG mixed never launched {k}")
    with loops.host_loops():
        host, hsecs, _ = counted(solve)
    log(f"solve as one graph launch {secs:.4f} s, as host loops {hsecs:.4f} s  [{smi}]")
    with plain_kernels():
        (up, _, itp), psecs, _ = counted(solve)
    err = float((u - up).abs().max() / up.abs().max())
    log(f"plain: outers {itp}  solve {psecs:.4f} s  max rel diff to the kernels' run {err:.3e}")
    require(it == itp, f"outers {it} vs plain {itp}")
    return counts, ((u, r, it), host)


def by_mode(counts) -> dict:
    """The stencil pass's launches by mode (``stencil_<mode>``), the nonzero ones."""
    return {k.removeprefix("stencil_"): v for k, v in counts.items()
            if k.startswith("stencil_") and v}


def phase_pallas_f64(n=2049):
    import dataclasses

    from fpr_tpu_torch.core.config import CoarseSolver, ExecutionPolicy, MGConfig
    from fpr_tpu_torch.solvers import krylov
    from fpr_tpu_torch.solvers.multigrid import mg_solve

    log(f"== phase 11: PALLAS policy, float64, {n}^2, coarse 5, tol 1e-6")
    tol = 1e-6
    h = 1.0 / (n - 1)
    b = poisson_rhs(n, "float64")
    main_counts = None
    for coarse in (CoarseSolver.JACOBI, CoarseSolver.CG):
        cfg = MGConfig(coarse_solver=coarse, policy=ExecutionPolicy.PALLAS)
        (u, r, it), secs, counts = counted(
            lambda: mg_solve(b.new_zeros(b.shape), b, h, 0.0, tol, 20, cfg=cfg))
        (uj, _, itj), jsecs, _ = counted(lambda: mg_solve(
            b.new_zeros(b.shape), b, h, 0.0, tol, 20,
            cfg=dataclasses.replace(cfg, policy=ExecutionPolicy.JNP)))
        err = float((u - uj).abs().max() / uj.abs().max())
        rel = true_rel(u, b, h)
        log(f"mg_solve coarse={coarse.value}: cycles {it} (JNP policy {itj})  "
            f"{secs:.4f} s (JNP {jsecs:.4f} s)  max rel diff to JNP {err:.3e}  "
            f"true f64 r_rms/f_rms {rel:.3e}  stencil launches {counts['stencil']} "
            f"{by_mode(counts)}")
        require(it == itj < 20, f"mg_solve {coarse.value}: cycles {it} vs JNP {itj}")
        require(err <= 1e-10, f"mg_solve {coarse.value}: fields differ from JNP by {err:.3e}")
        require(rel <= tol, f"mg_solve {coarse.value}: true residual {rel:.3e} > {tol}")
        require(counts["stencil"] > 0, "mg_solve with the PALLAS policy never launched stencil")
        if main_counts is None:
            main_counts = counts
    pallas = ExecutionPolicy.PALLAS
    (x, r, it), secs, counts = counted(lambda: krylov.cg(b, h, h, 0.0, tol, 20000, policy=pallas))
    with plain_kernels():
        (xp, _, itp), psecs, _ = counted(
            lambda: krylov.cg(b, h, h, 0.0, tol, 20000, policy=pallas))
    log(f"cg: iterations {it} (plain {itp})  {secs:.3f} s (plain {psecs:.3f} s)  "
        f"stencil launches {counts['stencil']} {by_mode(counts)}  max rel diff to plain "
        f"{float((x - xp).abs().max() / xp.abs().max()):.3e}")
    require(it == itp < 20000, f"cg: iterations {it} vs plain {itp}")
    (x, r, it), secs, counts = counted(lambda: krylov.mg_preconditioned_cg(
        b, h, 0.0, tol, 30, mg_cfg=MGConfig(policy=pallas)))
    rel = true_rel(x, b, h)
    log(f"mg_preconditioned_cg: iterations {it}  {secs:.4f} s  true f64 r_rms/f_rms "
        f"{rel:.3e}  stencil launches {counts['stencil']} {by_mode(counts)}")
    require(it < 30 and rel <= tol, f"mg_preconditioned_cg: {it} iterations, residual {rel:.3e}")
    return main_counts


def phase_krylov_ds(n=4097, n_kernel=1025):
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.solvers.krylov import mg_pcg_ds

    log(f"== phase 12: Krylov ds, mg_pcg_ds {n}^2, DST-513, V(5,5), tol 1e-6")
    tol = 1e-6
    cfg = MGConfig(coarse_size=min(513, (n_kernel - 1) // 2 + 1),
                   coarse_solver=CoarseSolver.DST, pre_smooth=5, post_smooth=5)
    h = 1.0 / (n - 1)
    b = poisson_rhs(n, "float32")

    def solve():
        return mg_pcg_ds(b, h, 0.0, tol, 30, cfg=cfg, return_pair=True)

    solve()  # warm-up
    ((uh, ul), r, it), secs, counts = counted(solve)
    rel = true_rel(uh.double() + ul.double(), b, h)
    log(f"rowsum64: iterations {it}  solve {secs:.4f} s  true f64 r_rms/f_rms {rel:.3e}  "
        f"launches { {k: v for k, v in counts.items() if v} }")
    require(it < 30 and rel <= tol, f"mg_pcg_ds: {it} iterations, residual {rel:.3e}")
    h = 1.0 / (n_kernel - 1)
    b = poisson_rhs(n_kernel, "float32")

    def solve_k():
        return mg_pcg_ds(b, h, 0.0, tol, 30, cfg=cfg, return_pair=True, dots="kernel")

    ((uh, ul), r, it), secs, counts = counted(solve_k)
    with plain_kernels():
        (_, _, itp), _, _ = counted(solve_k)
    rel = true_rel(uh.double() + ul.double(), b, h)
    log(f"dots=kernel {n_kernel}^2: iterations {it} (plain {itp})  solve {secs:.4f} s  true "
        f"f64 r_rms/f_rms {rel:.3e}  stencil launches {counts['stencil']} {by_mode(counts)}")
    require(it == itp < 30, f"mg_pcg_ds dots=kernel: iterations {it} vs plain {itp}")
    require(counts["stencil"] > 0, "mg_pcg_ds dots=kernel never launched stencil")


def host_cfg(beta, **kw):
    from fpr_tpu_torch.core.config import NSConfig

    kw = dict(dict(nx=2049, ny=513), **kw)
    return NSConfig(ttot=0.005, beta=beta, Pr=0.01, tol=1e-7, niters=50, mg_solver="mixed",
                    **kw)


def printed(fn):
    """(fn(), the lines it printed); the lines are printed again, also when
    fn raises."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        # a run that raises still shows its lines
        print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue().splitlines()


def phase_ns_host(smi, **size):
    import dataclasses

    import numpy as np

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig
    from fpr_tpu_torch.models.navier_stokes import simulate

    cfg5 = host_cfg(0.5, **size)
    log(f"== phase 13: NS host loop {cfg5.nx}x{cfg5.ny}, Pr=0.01, tol 1e-7, ttot 0.005, "
        f"mg_solver=mixed, float64")
    main_counts, results = None, {}
    for beta in (0.5, 1.0):
        out, secs, counts = counted(lambda: simulate(host_cfg(beta, **size), seed=0,
                                                     device=DEVICE))
        built(f"beta={beta}: the step")
        log(f"beta={beta}: steps {out.steps}  timed_iters {out.timed_iters}  sim_time "
            f"{out.sim_time!r}  timed {out.t_elapsed:.3f} s "
            f"({out.t_elapsed / max(out.timed_iters, 1) * 1e3:.1f} ms a step)  run {secs:.3f} s  "
            f"launches { {k: v for k, v in counts.items() if v} }")
        for name in ("T", "W", "S"):
            require(np.isfinite(getattr(out, name)).all(), f"beta={beta}: non-finite {name}")
        require(-0.5 <= out.T.min() and out.T.max() <= 1.5,
                f"beta={beta}: T out of [-0.5, 1.5]: [{out.T.min()}, {out.T.max()}]")
        require(out.sim_time >= 0.005, f"beta={beta}: stopped at sim_time {out.sim_time}")
        results[beta] = out
        if main_counts is None:
            main_counts = counts
    out, secs, _ = counted(lambda: simulate(host_cfg(0.0, **size), seed=0, max_steps=50,
                                            device=DEVICE))
    log(f"beta=0: 50 steps  timed_iters {out.timed_iters}  timed {out.t_elapsed:.3f} s "
        f"({out.t_elapsed / out.timed_iters * 1e3:.1f} ms a step)  sim_time {out.sim_time!r}")
    require(out.steps == 50 and np.isfinite(out.W).all(), "beta=0: 50 steps failed")
    # 10 steps as one graph launch a step and as host loops (phase 22 holds
    # them bitwise), each run's printed lines kept for its warnings
    ten = {}
    for beta in (0.5, 1.0):
        cfg = host_cfg(beta, **size)
        g = printed(lambda: simulate(cfg, seed=0, max_steps=10, device=DEVICE))
        with loops.host_loops():
            h = printed(lambda: simulate(cfg, seed=0, max_steps=10, device=DEVICE))
        ten[beta] = g, h
        log(f"beta={beta}: 10 steps, {g[0].timed_iters} timed: "
            f"{g[0].t_elapsed / max(g[0].timed_iters, 1) * 1e3:.1f} ms a step as one graph "
            f"launch, {h[0].t_elapsed / max(h[0].timed_iters, 1) * 1e3:.1f} ms as host loops  "
            f"[{smi}]")
    k10 = ten[0.5][0][0]
    with plain_kernels():
        p10 = simulate(cfg5, seed=0, max_steps=10, device=DEVICE)
    compare_runs(k10, p10, "host loop beta=0.5, 10 steps", rel=1e-10)
    direct = dataclasses.replace(cfg5, mg_solver="direct",
                                 mg=MGConfig(policy=ExecutionPolicy.PALLAS))
    out, secs, counts = counted(lambda: simulate(direct, seed=0, max_steps=3, device=DEVICE))
    log(f"direct, PALLAS policy: 3 steps  {secs:.3f} s  sim_time {out.sim_time!r}  "
        f"stencil launches {counts['stencil']}")
    require(out.steps == 3 and np.isfinite(out.S).all(), "direct PALLAS: 3 steps failed")
    require(counts["stencil"] > 0, "the direct PALLAS host loop never launched stencil")
    return main_counts, results, ten


def mesh_of(shape, axes):
    from fpr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, axes, device=DEVICE)


def phase_dist_diffusion(smi, single_512, single_128, n=512, n_small=128, cap=300):
    """Phase 14: the sharded diffusion tier against phases 7 and 8, one
    graph launch a physical step."""
    import dataclasses

    import numpy as np

    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu_torch.parallel import dist_diffusion

    log(f"== phase 14: sharded diffusion, {n}^3 float32 on 4 z-shards (K=3, #9), "
        f"{n_small}^3 on 2x2x2 shards (#8 boxes), overlap_comm against plain")
    cfg = DiffusionConfig(nx=n, ny=n, nz=n // 4, ttot=0.8, dt=0.2, tol=1e-6, iter_max=cap,
                          policy=ExecutionPolicy.PALLAS, check_every=3)
    out, secs, counts = counted(lambda: dist_diffusion.solve_distributed(
        cfg, mesh_of((4,), ("z",))))
    log(f"{n}^3 on 4 z-shards K=3: iters_total {out.iters_total}  timed_iters "
        f"{out.timed_iters}  run {secs:.3f} s  ms per iteration "
        f"{out.bench.delta_t / max(out.timed_iters, 1) * 1e3:.4f} (single device, phase 7: "
        f"{single_512.bench.delta_t / single_512.timed_iters * 1e3:.4f})  launches "
        f"{ {k: v for k, v in counts.items() if v} }  {was('512^3 K=3', smi)}")
    built(f"{n}^3 on 4 z-shards K=3: the physical step")
    require(out.iters_total == single_512.iters_total == 4 * cap,
            f"iterations {out.iters_total} vs single device {single_512.iters_total}")
    require(counts["dual_timek_padded"] > 0, "the sharded K=3 run never launched #9")
    err = float(np.abs(out.H - single_512.H).max())
    require(np.array_equal(out.H, single_512.H),
            f"{n}^3 sharded H differs from the single device by {err:.3e}")
    log("  H bitwise equal to the single-device run of the same steps")
    main_counts = counts
    del out

    cfg = DiffusionConfig(nx=n_small // 2, ny=n_small // 2, nz=n_small // 2, ttot=2.0,
                          tol=1e-6, policy=ExecutionPolicy.PALLAS, check_every=1)
    out, secs, counts = counted(lambda: dist_diffusion.solve_distributed(
        cfg, mesh_of((2, 2, 2), ("z", "y", "x"))))
    v, v1 = probe(out), probe(single_128)
    log(f"{n_small}^3 on 2x2x2 shards: converged {out.converged}  iterations "
        f"{out.iters_total} (single device {single_128.iters_total})  probe {v:.7f} (single "
        f"device {v1:.7f}, reference {REF_PROBE_F32})  timed {out.bench.delta_t:.3f} s "
        f"(single device {single_128.bench.delta_t:.3f} s)  run {secs:.3f} s  launches "
        f"{ {k: v for k, v in counts.items() if v} }  {was('2x2x2', smi)}")
    built(f"{n_small}^3 on 2x2x2 shards: the physical step")
    require(out.converged, f"{n_small}^3 on 2x2x2 shards did not converge")
    require(abs(v - REF_PROBE_F32) <= 1e-4, f"probe {v} is not within 1e-4 of {REF_PROBE_F32}")
    require(counts["dual_time"] > 0, "the 2x2x2 run never launched dual_time")

    base = DiffusionConfig(nx=n_small, ny=n_small, nz=n_small // 4, ttot=0.4, tol=1e-6,
                           iter_max=600, policy=ExecutionPolicy.PALLAS)
    runs = {}
    for overlap in (False, True):
        runs[overlap], secs, _ = counted(lambda: dist_diffusion.solve_distributed(
            dataclasses.replace(base, overlap_comm=overlap), mesh_of((4,), ("z",))))
        log(f"  overlap_comm={overlap}: {runs[overlap].iters_total} iterations, timed "
            f"{runs[overlap].bench.delta_t:.4f} s, run {secs:.3f} s  "
            f"{was(f'overlap_comm={overlap}', smi)}")
    require(runs[True].iters_total == runs[False].iters_total,
            f"overlap iterations {runs[True].iters_total} vs plain {runs[False].iters_total}")
    require(np.array_equal(runs[True].H, runs[False].H), "overlap H differs from plain")
    log("  overlap equals plain: same iterations, bitwise H")
    return main_counts


def phase_dist_mg(smi, single_it, single_u, n=4097, n_bcs=2049, shards=4):
    """Phase 15: the row-sharded ds MG against phase 4 and the single device,
    one graph launch a solve."""
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.solvers.dist_mg_ds import mg_solve_ds_sharded
    from fpr_tpu_torch.solvers.multigrid import mg_solve_ds

    log(f"== phase 15: mg_solve_ds_sharded {n}^2 on {shards} row shards, DST-513, V(5,5), "
        f"tol 1e-6, replicate_below=1025")
    tol = 1e-6
    mesh = mesh_of((shards,), ("y",))
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                   post_smooth=5)
    h = 1.0 / (n - 1)
    b = poisson_rhs(n, "float32")

    def solve():
        return mg_solve_ds_sharded(b, h, 0.0, tol, 30, mesh, cfg=cfg, replicate_below=1025)

    solve()  # warm-up: the graph is built here
    built(f"mg_solve_ds_sharded {n}^2")
    ((uh, ul), r, it), secs, counts = counted(solve)
    u = uh.double() + ul.double()
    rel = true_rel(u, b, h)
    diff = float((u - single_u).abs().max() / single_u.abs().max())
    log(f"outers {it} (single device {single_it})  solve {secs:.4f} s  true f64 r_rms/f_rms "
        f"{rel:.3e}  max rel diff to the single device {diff:.3e}  launches "
        f"{ {k: v for k, v in counts.items() if v} }  {was('MG 4097^2', smi)}")
    require(it == single_it, f"outers {it} vs single device {single_it}")
    require(rel <= tol, f"true f64 relative residual {rel:.3e} > {tol}")
    require(diff <= 1e-6, f"u differs from the single device by {diff:.3e}")
    for k in ("defect", "smooth2r_split", "corr_smooth2"):
        require(counts[k] > 0, f"the sharded MG never launched {k}")
    main_counts = counts
    del u, uh, ul, b

    h = 1.0 / (n_bcs - 1)
    b = poisson_rhs(n_bcs, "float32")
    cfg = MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST)
    for c in (0.0, 64.0):
        (ud, _, itd), secs, _ = counted(lambda: mg_solve_ds_sharded(
            b, h, c, tol, 20, mesh, cfg=cfg, replicate_below=513, apply_bcs=True))
        if c == 0.0:  # c rides in the graph's inputs: c=64 launches the same graph
            built(f"apply_bcs {n_bcs}^2")
        (us, _, its), ssecs, _ = counted(lambda: mg_solve_ds(
            None, b, h, c, tol, 20, cfg=cfg, return_pair=True, apply_bcs=True))
        ud, us = ud[0].double() + ud[1].double(), us[0].double() + us[1].double()
        diff = float((ud - us).abs().max() / us.abs().max())
        log(f"apply_bcs {n_bcs}^2 c={c}: outers {itd} (single device {its})  {secs:.3f} s"
            f"{' with the graph build' if c == 0.0 else ''} (single device {ssecs:.3f} s)  "
            f"max rel diff {diff:.3e}  "
            f"row 0 {float(ud[0].min())}..{float(ud[0].max())}  {was(f'apply_bcs c={c}', smi)}")
        require(itd == its, f"apply_bcs c={c}: outers {itd} vs single device {its}")
        require(diff <= 1e-6, f"apply_bcs c={c}: u differs by {diff:.3e}")
    return main_counts


def phase_dist_ns(smi, single_semi, nx=2049, ny=513, shards=4, timed_steps=200):
    """Phase 16: the row-sharded NS fast loop against the single device, one
    graph launch a chunk."""
    import dataclasses

    import numpy as np

    from fpr_tpu_torch.models.dist_ns import simulate_fast_sharded
    from fpr_tpu_torch.models.navier_stokes import simulate_fast
    from fpr_tpu_torch.parallel.dryrun import dryrun_multichip

    log(f"== phase 16: simulate_fast_sharded {nx}x{ny} on {shards} row shards")
    mesh = mesh_of((shards,), ("y",))
    cfg = dataclasses.replace(ns_cfg(0.0), nx=nx, ny=ny)
    got = simulate_fast_sharded(cfg, mesh, max_steps=6)
    built(f"NS explicit on {shards} row shards: the chunk")
    want = simulate_fast(cfg, max_steps=6, device=DEVICE)
    w = float(np.abs(got.W - want.W).max() / np.abs(want.W).max())
    t = float(np.abs(got.T - want.T).max())
    log(f"explicit 6 steps: steps {got.steps}/{want.steps}  sim_time {got.sim_time!r} vs "
        f"{want.sim_time!r}  W rel diff {w:.3e}  T diff {t:.3e}")
    require(got.steps == want.steps == 6, "explicit 6 steps: step counts differ")
    require(abs(got.sim_time - want.sim_time) < 1e-6, "explicit: sim_time differs")
    require(w < 1e-4 and t < 1e-4, f"explicit: W {w:.3e} or T {t:.3e} beyond 1e-4")
    out, secs, counts = counted(lambda: simulate_fast_sharded(cfg, mesh,
                                                              max_steps=timed_steps))
    ref, rsecs, _ = counted(lambda: simulate_fast(cfg, max_steps=timed_steps, device=DEVICE))
    drift = float(np.abs(out.W - ref.W).max() / np.abs(ref.W).max())
    log(f"explicit {timed_steps} steps: timed_iters {out.timed_iters}  timed "
        f"{out.t_elapsed:.3f} s ({out.t_elapsed / out.timed_iters * 1e3:.2f} ms a step; single "
        f"device {ref.t_elapsed:.3f} s, {ref.t_elapsed / ref.timed_iters * 1e3:.2f} ms)  W "
        f"drift {drift:.3e}  sim_time {out.sim_time!r} vs {ref.sim_time!r}  launches "
        f"{ {k: v for k, v in counts.items() if v} }  {was('NS explicit', smi)}")
    require(np.isfinite(out.W).all() and out.steps == timed_steps, "explicit run failed")
    for k in ("defect", "smooth2r_split", "corr_smooth2", "ns_fused"):
        require(counts[k] > 0, f"the sharded NS loop never launched {k}")
    semi = simulate_fast_sharded(dataclasses.replace(ns_cfg(0.5), nx=nx, ny=ny), mesh)
    w = float(np.abs(semi.W - single_semi.W).max() / np.abs(single_semi.W).max())
    t = float(np.abs(semi.T - single_semi.T).max())
    log(f"beta=0.5 to the end: steps {semi.steps} (single device, phase 6: "
        f"{single_semi.steps})  timed {semi.t_elapsed:.3f} s (single device "
        f"{single_semi.t_elapsed:.3f} s)  sim_time {semi.sim_time!r} vs "
        f"{single_semi.sim_time!r}  W rel diff {w:.3e}  T diff {t:.3e}  "
        f"{was('NS beta=0.5', smi)}")
    built(f"NS beta=0.5 on {shards} row shards: the chunk")
    # the bounds of the JAX package's sharded semi-implicit test against its
    # single device (tests/test_dist_mg.py)
    require(semi.steps == single_semi.steps,
            f"beta=0.5: steps {semi.steps} vs single device {single_semi.steps}")
    require(abs(semi.sim_time - single_semi.sim_time) < 1e-6, "beta=0.5: sim_time differs")
    require(w < 1e-3 and t < 1e-3, f"beta=0.5: W {w:.3e} or T {t:.3e} beyond 1e-3")
    require(np.allclose(semi.T[0], 1.0, atol=1e-6) and np.allclose(semi.T[-1], 0.0, atol=1e-6)
            and np.allclose(semi.T[:, 0], semi.T[:, 1], atol=1e-6),
            "beta=0.5: the temperature BCs do not hold")
    dryrun_multichip(4, device=DEVICE)
    return counts


def phase_dist_mg_2d(smi, single_it, single_u, n=4097):
    """Phase 17: the 2D (y, x) mesh ds MG against phase 4, one graph launch
    a solve."""
    import torch

    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.solvers.dist_mg_ds import mg_solve_ds_sharded_2d

    log(f"== phase 17: mg_solve_ds_sharded_2d {n}^2, DST-513, V(5,5), tol 1e-6, "
        f"replicate_below=1025, on 2x2 and 1x4 (y, x) meshes")
    tol = 1e-6
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                   post_smooth=5)
    h = 1.0 / (n - 1)
    b = poisson_rhs(n, "float32")
    main_counts = None
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape, ("y", "x"))

        def solve():
            return mg_solve_ds_sharded_2d(b, h, 0.0, tol, 30, mesh, cfg=cfg,
                                          replicate_below=1025)

        solve()  # warm-up: the graph is built here
        built(f"{shape[0]}x{shape[1]}")
        ((uh, ul), r, it), secs, counts = counted(solve)
        u = uh.double() + ul.double()
        rel = true_rel(u, b, h)
        diff = float((u - single_u).abs().max() / single_u.abs().max())
        log(f"{shape[0]}x{shape[1]}: outers {it} (single device {single_it})  solve {secs:.4f} s  "
            f"true f64 r_rms/f_rms {rel:.3e}  max rel diff to the single device {diff:.3e} "
            f"(bitwise: {torch.equal(u, single_u)})  launches "
            f"{ {k: v for k, v in counts.items() if v} }  {was(f'{shape[0]}x{shape[1]}', smi)}")
        require(it == single_it, f"{shape}: outers {it} vs single device {single_it}")
        require(rel <= tol, f"{shape}: true f64 relative residual {rel:.3e} > {tol}")
        require(diff <= 1e-6, f"{shape}: u differs from the single device by {diff:.3e}")
        for k in ("defect", "smooth2r_split", "corr_smooth2"):
            require(counts[k] > 0, f"the 2D-mesh MG never launched {k}")
        main_counts = main_counts or counts
        del u, uh, ul
    return main_counts


def phase_gspmd(smi, n=2049, shards=4, **size):
    """Phase 18: the GSPMD tier (row-sharded mg_solve and simulate(mesh=))
    against the single device, float64: one graph launch a solve and a
    step."""
    import dataclasses

    import numpy as np

    from fpr_tpu_torch.core.config import MGConfig
    from fpr_tpu_torch.models.navier_stokes import simulate
    from fpr_tpu_torch.solvers.dist_multigrid import mg_solve_sharded, plan_rows
    from fpr_tpu_torch.solvers.multigrid import mg_solve

    cfg = dataclasses.replace(host_cfg(0.5, **size), mg_solver="direct", ttot=1.0)
    log(f"== phase 18: GSPMD tier, mg_solve_sharded {n}^2 float64 on {shards} row shards, "
        f"simulate(mesh=) {cfg.nx}x{cfg.ny} direct float64, beta=0.5, 3 steps")
    tol = 1e-6
    h = 1.0 / (n - 1)
    mesh = mesh_of((shards,), ("y",))
    b = poisson_rhs(n, "float64")
    (ud, _, itd), secs, _ = counted(lambda: mg_solve_sharded(b.new_zeros(b.shape), b, h, 0.0,
                                                             tol, 30, mesh))
    built(f"mg_solve_sharded {n}^2")
    (us, _, its), ssecs, _ = counted(lambda: mg_solve(b.new_zeros(b.shape), b, h, 0.0, tol, 30))
    err = float((ud - us).abs().max())
    log(f"mg_solve_sharded: cycles {itd} (single device {its})  {secs:.3f} s with the graph's "
        f"build (single device {ssecs:.3f} s)  sharded levels "
        f"{plan_rows(n, n, shards, MGConfig()).s}  max abs diff {err:.3e}  true f64 "
        f"r_rms/f_rms {true_rel(ud, b, h):.3e}  {was('mg_solve_sharded', smi)}")
    require(itd == its < 30, f"mg_solve_sharded: cycles {itd} vs single device {its}")
    require(err <= 1e-12, f"mg_solve_sharded: fields differ by {err:.3e}")
    del ud, us, b
    got, secs, _ = counted(lambda: simulate(cfg, seed=0, max_steps=3, mesh=mesh))
    built("simulate(mesh=): the step")
    ref, rsecs, _ = counted(lambda: simulate(cfg, seed=0, max_steps=3, device=DEVICE))
    diffs = {k: float(np.abs(getattr(got, k) - getattr(ref, k)).max()) for k in "TWS"}
    log(f"simulate(mesh=) beta=0.5: steps {got.steps} (single device {ref.steps})  sim_time "
        f"{got.sim_time!r} vs {ref.sim_time!r}  {secs:.3f} s with the graph's build (single "
        f"device {rsecs:.3f} s)  max abs diffs {diffs}  {was('simulate(mesh=)', smi)}")
    require(got.steps == ref.steps == 3, f"simulate(mesh=): steps {got.steps} vs {ref.steps}")
    require(abs(got.sim_time - ref.sim_time) <= 1e-12 * ref.sim_time,
            "simulate(mesh=): sim_time differs")
    require(diffs["T"] <= 1e-11 and diffs["S"] <= 1e-11
            and diffs["W"] <= 1e-9 * float(np.abs(ref.W).max()),
            f"simulate(mesh=): fields beyond tests/test_distributed.py's bounds: {diffs}")


def phase_helm_warm_start(semi):
    """The Helmholtz warm start through K4's with_helm_defect (after phase
    6): one semi-implicit step's T and W solves at the state phase 6 ended
    in, fed by ns_fused_rp(with_helm_defect=True) and mg_solve_ds_rp(r0=...),
    against the same solves after the plain rhs pass (the path
    simulate_fast takes).  No solver path of the port launches this mode,
    as none of the JAX package does; this run is its counted path."""
    import dataclasses

    import numpy as np
    import torch

    from fpr_tpu_torch.models.navier_stokes import fast_mg_default
    from fpr_tpu_torch.ops.ns_fused import ns_fused_rp
    from fpr_tpu_torch.solvers.multigrid import mg_solve_ds_rp

    cfg = fast_mg_default(dataclasses.replace(ns_cfg(0.5), ny=semi.T.shape[0],
                                              nx=semi.T.shape[1]))
    log("== phase 6, the Helmholtz warm start of K4's with_helm_defect mode")
    dev = torch.device(DEVICE)
    TW = torch.tensor(np.stack([semi.T, semi.W]), dtype=torch.float32, device=dev)
    S = torch.tensor(semi.S, dtype=torch.float32, device=dev)
    dt = torch.tensor(semi.sim_time / semi.steps, dtype=torch.float32, device=dev)
    cT = torch.ones_like(dt) / (torch.full_like(dt, cfg.beta) * dt)
    cW = cT / torch.full_like(dt, cfg.Pr)
    h, n_cells = cfg.h, torch.full_like(dt, float(cfg.nx * cfg.ny))
    z = torch.zeros_like(TW[0])
    kw = dict(cfg=cfg.mg, inner_cycles=1, tol=cfg.tol)

    def solves(rhs, trhs_ss, wrhs_ss, r0T=None, r0W=None):
        T, _, itT = mg_solve_ds_rp(torch.stack([TW[0], z]), rhs[0:1],
                                   cfg.tol * torch.sqrt(trhs_ss / n_cells), h, cT, cfg.niters,
                                   apply_bcs=True, r0=r0T, **kw)
        W, _, itW = mg_solve_ds_rp(torch.stack([TW[1], z]), rhs[1:2],
                                   cfg.tol * torch.sqrt(wrhs_ss / n_cells), h, cW, cfg.niters,
                                   r0=r0W, **kw)
        return T, W, itT, itW

    args = (TW, S, dt, h, cfg.Pr, cfg.Ra)
    opts = dict(k=cfg.k, beta=cfg.beta, mode="rhs", cT=cT, cW=cW)

    def fused():
        rhs, (tss, wss), r0T, r0W = ns_fused_rp(*args, with_helm_defect=True, **opts)
        return solves(rhs, tss, wss, r0T, r0W)

    (Tf, Wf, itT, itW), secs, counts = counted(fused)
    rhs, (tss, wss) = ns_fused_rp(*args, with_sumsq=True, **opts)
    Tp, Wp, itTp, itWp = solves(rhs, tss, wss)
    log(f"outers T {itT} W {itW} (separate passes: {itTp} {itWp})  {secs:.4f} s  T and W "
        f"bitwise: {bool(torch.equal(Tf, Tp))} {bool(torch.equal(Wf, Wp))}  launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    require((itT, itW) == (itTp, itWp) and min(itT, itW) >= 1,
            f"outers {itT}/{itW} vs separate passes {itTp}/{itWp}")
    require(torch.equal(Tf, Tp) and torch.equal(Wf, Wp), "fields differ from the separate passes")
    require(counts["ns_fused_helm"] == 1, "the warm start did not launch ns_fused_helm once")
    return counts


NS_KERNELS = ("defect", "smooth_down", "corr_up", "ns_fused")
# kernel: (source, the TPU kernel it replaces)
SOURCES = {
    "defect": ("fpr_tpu_torch/csrc/defect.cu", "fpr_tpu/ops/ds.py:149"),
    "smooth_down": ("fpr_tpu_torch/csrc/vcycle_legs.cu", "fpr_tpu/ops/pallas2d.py:996"),
    "corr_up": ("fpr_tpu_torch/csrc/vcycle_legs.cu", "fpr_tpu/ops/pallas2d.py:1223"),
    "ns_fused": ("fpr_tpu_torch/csrc/ns_fused.cu", "fpr_tpu/ops/pallas_ns.py:58"),
    "dual_time": ("fpr_tpu_torch/csrc/dual_time.cu", "fpr_tpu/ops/pallas3d.py:168"),
    "dual_timek": ("fpr_tpu_torch/csrc/dual_timek.cu", "fpr_tpu/ops/pallas3d.py:516"),
    "ds3d": ("fpr_tpu_torch/csrc/ds3d.cu", "fpr_tpu/ops/ds3d.py:70"),
    "stencil": ("fpr_tpu_torch/csrc/stencil.cu", "fpr_tpu/ops/pallas2d.py:108"),
    "smooth2r_split": ("fpr_tpu_torch/csrc/vcycle_legs.cu", "fpr_tpu/ops/pallas2d.py:333"),
    "corr_smooth2": ("fpr_tpu_torch/csrc/vcycle_legs.cu", "fpr_tpu/ops/pallas2d.py:595"),
    "dual_timek_padded": ("fpr_tpu_torch/csrc/dual_timek.cu", "fpr_tpu/ops/pallas3d.py:270"),
    "ns_fused_helm": ("fpr_tpu_torch/csrc/ns_fused.cu", "fpr_tpu/ops/pallas_ns.py:58"),
}

# the implicit (beta=1) row's timed steps at 2049x513, Pr 0.01: every tier of
# the JAX sweep reads 37 (benchmark-results/ns_fullscale.csv); the W seed moves
# the semi- and fully implicit counts by about one step
# (benchmark-results/ns_step_seed_distribution.csv: 365-368 at Pr 0.1)
IMPLICIT_BAND = (36, 38)


def phase_bench(smi):
    """The port's bench rows in-process at their full sizes (semi and implicit
    with one rep), then ``python -m fpr_tpu_torch bench --quick`` in a
    subprocess, its last line parsed."""
    import math

    from fpr_tpu_torch import bench

    log("== phase 19: the bench rows (fpr_tpu_torch.bench) and bench --quick")
    n_diff, cap, n_mg = 512, 300, 4097
    diff, secs, counts = counted(lambda: bench.bench_diffusion(n_diff, cap, device=DEVICE))
    log(f"diffusion {diff['grid']} K=3: {diff['iterations']} iterations, "
        f"{diff['ms_per_iter']:.4f} ms/iter (iqr {diff['iqr_s']:.2e} s), T_eff "
        f"{diff['teff_gbs']:.1f} GB/s (counted 6+1 model), {diff['gflops']:.1f} GFLOP/s  "
        f"[{smi}]  launches dual_timek {counts['dual_timek']}")
    require(diff["iterations"] == cap and math.isfinite(diff["teff_gbs"]),
            f"diffusion row: {diff}")
    require(counts["dual_timek"] > 0, "the diffusion row never launched dual_timek")
    mg, secs, counts = counted(lambda: bench.bench_mg(n_mg, device=DEVICE))
    log(f"MG {mg['grid']}: {mg['outer_iterations']} outers, median {mg['seconds_to_tol']:.4f} s "
        f"of {mg['reps']} (iqr {mg['iqr_s']:.2e}), true f64 r_rms/f_rms "
        f"{mg['true_f64_rel_residual']:.3e}, device time of one solve "
        f"{mg['device_seconds_one_solve']} s (its graph:mg_solve_ds span)")
    require(mg["outer_iterations"] == 4, f"MG row: {mg['outer_iterations']} outers, not 4")
    require(mg["device_seconds_one_solve"] > 0,
            f"MG row: device time {mg['device_seconds_one_solve']}")
    require(mg["true_f64_rel_residual"] <= 1e-6,
            f"MG row: true f64 residual {mg['true_f64_rel_residual']:.3e} > 1e-6")
    for k in ("defect", "smooth_down", "corr_up"):
        require(counts[k] > 0, f"the MG row never launched {k}")
    for beta, what in ((0.5, "semi-implicit"), (1.0, "implicit")):
        row, secs, counts = counted(lambda: bench.bench_ns_row(beta, reps=1, device=DEVICE))
        log(f"NS {what} (beta={beta}): {row['timed_steps']} timed steps of {row['steps']} in "
            f"{row['seconds']:.3f} s  launches {({k: counts[k] for k in NS_KERNELS})}")
        require(math.isfinite(row["seconds"]), f"{what}: time {row['seconds']}")
        for k in NS_KERNELS:
            require(counts[k] > 0, f"the NS {what} row never launched {k}")
        if beta == 0.5:
            require(row["timed_steps"] == 37, f"semi-implicit: {row['timed_steps']} timed steps")
        else:
            lo, hi = IMPLICIT_BAND
            require(lo <= row["timed_steps"] <= hi,
                    f"implicit: {row['timed_steps']} timed steps outside {IMPLICIT_BAND}")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "fpr_tpu_torch", "bench", "--quick", "--device",
                        DEVICE], cwd=here, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    require(p.returncode == 0 and lines, f"bench --quick: exit {p.returncode}\n"
                                         f"{(p.stdout + p.stderr)[-2000:]}")
    line = json.loads(lines[-1])
    name = line["extras"]["device"]
    log(f"bench --quick in {time.perf_counter() - t0:.1f} s: {lines[-1]}")
    require(name == card_name() and name in line["metric"],
            f"bench --quick names {name!r}, not the card {card_name()!r}")
    require(line["extras"]["mg_outer_iterations"] >= 1 and line["value"] > 0,
            "bench --quick: no MG count or no T_eff")
    lo, hi = bench.CANARY_ENVELOPE_MS
    canary = line["extras"]["canary"].get("ms_per_iter")
    require(canary is not None and lo <= canary <= hi and "env_degraded" not in line,
            f"bench --quick: canary {line['extras']['canary']} outside [{lo}, {hi}] ms")
    require(line["extras"]["aliased_kernel_check"] is True,
            f"bench --quick: aliased_kernel_check {line['extras']['aliased_kernel_check']}")
    for name in ("aliased", "canary_post"):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "fpr_tpu_torch", "bench", "--component", name,
                            "--device", DEVICE], cwd=here, capture_output=True, text=True,
                           timeout=bench._TIMEOUTS[name])
        payload = bench._payload_of(p.stdout, name)
        log(f"bench --component {name} in {time.perf_counter() - t0:.1f} s: {payload}  [{smi}]")
        require(p.returncode == 0 and payload is not None,
                f"bench --component {name}: exit {p.returncode}\n{(p.stdout + p.stderr)[-2000:]}")
        if name == "aliased":
            require(payload["passed"] is True and not payload["mismatches"],
                    f"the kernel-agreement check failed: {payload['mismatches']}")
        else:
            require(lo <= payload["ms_per_iter"] <= hi,
                    f"canary_post {payload['ms_per_iter']} ms outside [{lo}, {hi}] ms")


def card_name():
    from fpr_tpu_torch.utils import device

    return device.name(DEVICE)


def phase_checkpoints():
    """``ns --save/--resume`` through fpr_tpu_torch.cli.main on the card: the
    fast loop saved at 200 steps and resumed to 400 against a straight 400
    (T, W, S_hi, S_lo, w_sumsq, t_hi, t_lo bitwise, the same step); a host-loop
    save of 3 steps, resumed for 3 more and held bitwise against ``simulate``
    from the saved T and W; profiling.trace around 5 fast steps."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from fpr_tpu_torch import cli
    from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig
    from fpr_tpu_torch.models.navier_stokes import simulate, simulate_fast
    from fpr_tpu_torch.utils import checkpoint, profiling

    log("== phase 20: checkpoints on the card (ns --save/--resume), profiling.trace")
    nx, ny, n_save = 2049, 513, 200
    ns = ["ns", "--device", DEVICE, "--nx", str(nx), "--ny", str(ny), "--Pr", "0.01", "--tol",
          "1e-7", "--ttot", "0.005"]
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        _, secs, counts = counted(lambda: cli.main(
            ns + ["--fast", "--max-steps", str(n_save), "--save", str(d / "s200.npz")]))
        for k in NS_KERNELS:
            require(counts[k] > 0, f"ns --fast never launched {k}")
        cli.main(ns + ["--fast", "--resume", str(d / "s200.npz"), "--max-steps",
                       str(2 * n_save), "--save", str(d / "r400.npz")])
        cli.main(ns + ["--fast", "--max-steps", str(2 * n_save), "--save",
                       str(d / "s400.npz")])
        a, b = checkpoint.load(d / "r400.npz"), checkpoint.load(d / "s400.npz")
        differ = [k for k in b if not np.array_equal(a[k], b[k])]
        log(f"{n_save} + {n_save} steps against {2 * n_save}: step {int(a['step'])}/"
            f"{int(b['step'])}, keys differing {differ or 'none'} (sim_time "
            f"{float(a['t_hi']) + float(a['t_lo'])!r})")
        require(sorted(a) == sorted(b) and int(b["step"]) == 2 * n_save and not differ,
                f"the resumed run is not bitwise the straight one: {differ}")
        host = ns + ["--f64", "--policy", "pallas", "--max-steps", "3"]
        _, secs, counts = counted(lambda: cli.main(host + ["--save", str(d / "h.npz")]))
        h = checkpoint.load(d / "h.npz")
        require(sorted(h) == ["S", "T", "W", "t"] and h["T"].shape == (ny, nx)
                and all(np.isfinite(h[k]).all() for k in h), "host-loop checkpoint")
        require(counts["stencil"] > 0, "the host loop with --policy pallas never launched "
                                       "the stencil pass")
        cli.main(host + ["--resume", str(d / "h.npz"), "--save", str(d / "h2.npz")])
        r = checkpoint.load(d / "h2.npz")
        cfg = dataclasses.replace(ns_cfg(0.0), nx=nx, ny=ny,
                                  mg=MGConfig(policy=ExecutionPolicy.PALLAS))
        want = simulate(cfg, T0=h["T"], W0=h["W"], max_steps=3, dtype=torch.float64,
                        device=DEVICE)
        differ = [k for k in ("T", "W", "S") if not np.array_equal(r[k], getattr(want, k))]
        log(f"host loop: 3 steps saved (t {float(h['t'])!r}, {secs:.2f} s), resumed for 3 more "
            f"(t {float(r['t'])!r}): against simulate from the saved T and W, fields "
            f"differing {differ or 'none'}")
        require(not differ and float(r["t"]) == want.sim_time,
                f"the resumed host loop is not simulate from the saved T and W: {differ}")
        require(not np.array_equal(r["T"], h["T"]), "the resumed host loop did not advance T")
        with profiling.trace(d / "trace", device=DEVICE) as prof:
            simulate_fast(dataclasses.replace(ns_cfg(0.0), nx=nx, ny=ny), seed=0, max_steps=5,
                          device=DEVICE)
        n_dev = profiling.device_events(prof)
        size = (d / "trace" / "trace.json").stat().st_size
        log(f"profiling.trace of 5 fast steps: {n_dev} device events, trace.json {size} bytes")
        require(n_dev > 0 and size > 0, "the trace recorded no device event")


def csv_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def phase_experiments():
    """Each experiment at its smallest setting that runs its kernels, into a
    temporary directory: rows checked, the kernels of each counted."""
    import tempfile
    from pathlib import Path

    from fpr_tpu_torch.experiments import (dist_mg_large, multigrid_bench, ns_timestepping,
                                           part1_benchmark, part1_error_experiments,
                                           part1_scaling)

    log("== phase 21: the experiments (fpr_tpu_torch.experiments) on the card")
    k_mg, k_dist = 10, 13
    name = card_name()
    dev = ["--device", DEVICE]
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)

        def run(what, main, argv, out, kernels_needed, n_rows):
            t0 = time.perf_counter()
            _, _, counts = counted(lambda: main(argv + dev + ["--out", str(d / out)]))
            rows = csv_rows(d / out)
            log(f"{what}: {len(rows)} rows in {time.perf_counter() - t0:.1f} s, launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            require(len(rows) == n_rows, f"{what}: {len(rows)} rows, expected {n_rows}")
            require(all(r["device"] == name and r["backend"].startswith(DEVICE) for r in rows),
                    f"{what}: a row without backend {DEVICE} and the card's name")
            for k in kernels_needed:
                require(counts[k] > 0, f"{what} never launched {k}")
            return rows

        rows = run("part1_benchmark n=16", part1_benchmark.main,
                   ["--max-e", "4", "--ttot", "0.4", "--reps", "1"], "bench_diffusion.csv",
                   ("dual_time", "dual_timek"), 3)
        require(all(int(r["iters"]) > 0 for r in rows), "part1_benchmark: no iterations")
        rows = run("part1_error_experiments grid n=16", part1_error_experiments.main,
                   ["--mode", "grid", "--max-e", "4"], "error_grid.csv", ("dual_time",), 1)
        rows = run("part1_error_experiments tol n=16", part1_error_experiments.main,
                   ["--mode", "tol", "--n", "16"], "error_tol.csv", ("ds3d",), 8)
        vals = [float(r["val"]) for r in rows]
        require(all(v == v for v in vals) and abs(vals[-1] - vals[-2]) < 1e-6,
                f"part1_error_experiments tol: probes {vals}")
        run("part1_scaling weak n=32 on 2 z-shards", part1_scaling.main,
            ["--mode", "weak", "--n", "32", "--devices", "2", "--ttot", "0.4"],
            "scaling.csv", ("dual_time",), 1)
        rows = run(f"multigrid_bench k={k_mg}", multigrid_bench.main,
                   ["--min-k", str(k_mg), "--max-k", str(k_mg), "--max-l", "2"], "mg.csv",
                   ("defect", "smooth_down", "corr_up", "smooth2r_split", "corr_smooth2"), 6)
        require(all(1 <= int(r["iters"]) <= 30 for r in rows), "multigrid_bench: counts")
        rows = run(f"multigrid_bench --workprec k={k_mg}", multigrid_bench.main,
                   ["--workprec", "--min-k", str(k_mg), "--max-k", str(k_mg)], "wp.csv",
                   ("defect", "smooth_down", "corr_up", "smooth2r_split", "corr_smooth2"), 6)
        rows = run("ns_timestepping fast, 60 steps at most", ns_timestepping.main,
                   ["--solver", "fast", "--Pr", "0.01", "--betas", "0.0,0.5", "--max-steps",
                    "60", "--reps", "1"], "ns.csv",
                   NS_KERNELS, 2)
        require([int(r["steps"]) for r in rows] == [60, 40],
                f"ns_timestepping steps {[r['steps'] for r in rows]}, expected [60, 40]")
        try:
            ns_timestepping.main(["--solver", "fast", "--s-tol-factor", "0"] + dev)
            require(False, "ns_timestepping --s-tol-factor 0 ran")
        except SystemExit as exc:
            require(exc.code not in (None, 0), "ns_timestepping --s-tol-factor 0 exited 0")
        rows = run(f"dist_mg_large k={k_dist} on 4 row shards", dist_mg_large.main,
                   ["--k", str(k_dist), "--devices", "4"], "dist.csv",
                   ("defect", "smooth2r_split", "corr_smooth2"), 1)
        r = rows[0]
        require(r["backend"] == f"{DEVICE}-virtual" and float(r["true_rel_residual"]) <= 2e-6
                and float(r["device_peak_gb"]) > 0, f"dist_mg_large: {r}")


# PR 9's rows (PERF.md §6, ``python -m fpr_tpu_torch bench`` on an NVIDIA
# H100 80GB HBM3 at 700.00 W, host loops), beside phase 22's wall times
PR9_SECONDS = {"NS explicit 8736 steps": 36.463, "NS semi 37 steps": 0.9614,
               "MG ds 4097^2": 0.010114}
# the profiler's names of the NS kernels (K2 and K3 are one leg kernel)
PROFILED = {"defect": "::defect_kernel", "ns_fused": "::ns_kernel", "legs": "::leg_kernel"}


@contextlib.contextmanager
def count_host_syncs():
    """Count what makes the host wait for the card: torch.cuda.synchronize
    and every read of a CUDA tensor's values (bool, float, int, item, cpu,
    numpy, tolist)."""
    import torch

    n = [0]
    names = ("__bool__", "__float__", "__int__", "item", "cpu", "numpy", "tolist")
    saved = {k: getattr(torch.Tensor, k) for k in names}
    sync = torch.cuda.synchronize

    def counting(orig):
        def read(self, *a, **k):
            n[0] += self.is_cuda
            return orig(self, *a, **k)
        return read

    def synchronize(*a, **k):
        n[0] += 1
        return sync(*a, **k)

    try:
        for k in names:
            setattr(torch.Tensor, k, counting(saved[k]))
        torch.cuda.synchronize = synchronize
        yield n
    finally:
        for k in names:
            setattr(torch.Tensor, k, saved[k])
        torch.cuda.synchronize = sync


def median_seconds(fn, reps=5):
    """fn's result and the median of reps host-clock times to a sync."""
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return out, sorted(ts)[reps // 2]


def last_graph():
    """(name, table row) of the graph built last (``loops.graphs``)."""
    from fpr_tpu_torch.core import loops

    return next(reversed(loops.graphs.items()))


def built(what):
    """Log the last graph's build (``loops.graphs``)."""
    name, g = last_graph()
    log(f"{what}: graph {name} built in {g['build_s']:.3f} s (warm-up pass, capture, "
        f"instantiation), {g['nodes']} nodes")


def phase_device_loops(smi, explicit, semi, mixed, ns_ten):
    """Phase 22: every ported loop as one graph launch a call against the
    host loops (``loops.host_loops()``), bitwise, through the kernels and
    through their plain versions.  mixed: phase 10's MG mixed solve as a
    graph and as host loops; ns_ten: phase 13's 10 NS host-loop steps,
    ((graph run, its lines), (host-loop run, its lines)) by beta."""
    import dataclasses

    import numpy as np
    import torch

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.core.config import CoarseSolver, DiffusionConfig, ExecutionPolicy, MGConfig
    from fpr_tpu_torch.models import diffusion3d
    from fpr_tpu_torch.models.navier_stokes import simulate_fast
    from fpr_tpu_torch.solvers.krylov import mg_pcg_ds
    from fpr_tpu_torch.solvers.multigrid import mg_solve_ds

    log("== phase 22: device loops (CUDA graphs, WHILE nodes) against the host loops")
    walls = []

    def same_ns(a, b, what):
        require((a.steps, a.timed_iters, a.sim_time) == (b.steps, b.timed_iters, b.sim_time),
                f"{what}: steps {a.steps}/{a.timed_iters} t {a.sim_time!r} vs host loop "
                f"{b.steps}/{b.timed_iters} t {b.sim_time!r}")
        for k in ("T", "W", "S"):
            require(np.array_equal(getattr(a, k), getattr(b, k)), f"{what}: {k} differs")
        for k in ("T", "W", "S_hi", "S_lo", "w_sumsq", "t_hi", "t_lo"):
            require(torch.equal(a.state[k], b.state[k]), f"{what}: state {k} differs")

    def both(run, what, compare, plain=False):
        """run() as graphs, then as host loops; compare(graph, host)."""
        with plain_kernels() if plain else contextlib.nullcontext():
            g = run()
            with loops.host_loops():
                h = run()
        compare(g, h, what + (" (plain versions)" if plain else ""))
        return g, h

    # NS explicit: phase 5's graph run against the host loop, the full run
    cfg = ns_cfg(0.0)
    with loops.host_loops():
        host = simulate_fast(cfg, seed=0, device="cuda")
    same_ns(explicit, host, "NS explicit, the full run")
    require(explicit.timed_iters == 8736, f"NS explicit timed_iters {explicit.timed_iters}")
    walls.append(("NS explicit 8736 steps", explicit.t_elapsed, host.t_elapsed))
    log(f"NS explicit: {explicit.timed_iters} timed steps, bitwise equal to the host loop")
    # chunks of 1000 steps: the same bits, one graph launch and one host read a chunk
    simulate_fast(cfg, seed=0, max_steps=4, device="cuda")  # the graph is built here
    launched = loops.stats["launches"]
    with count_host_syncs() as n:
        chunked = simulate_fast(cfg, seed=0, chunk_steps=1000, device="cuda")
    chunks = -(-(chunked.steps - 3) // 1000)
    launched = loops.stats["launches"] - launched
    same_ns(chunked, explicit, "NS explicit, chunk_steps=1000")
    log(f"chunk_steps=1000: {chunks} chunks, {launched} graph launches, {n[0]} host syncs "
        f"(warm-up + chunks + end = {1 + chunks + 1}), timed {chunked.t_elapsed:.3f} s")
    require(launched == 1 + chunks,
            f"{launched} graph launches for the warm-up and {chunks} chunks")
    require(n[0] == 1 + chunks + 1, f"{n[0]} host syncs, expected {1 + chunks + 1}")
    for plain in (False, True):
        both(lambda: simulate_fast(cfg, seed=0, max_steps=20, device="cuda"),
             "NS explicit, 20 steps", same_ns, plain)

    # NS semi-implicit to its end: phase 6's graph run against the host loop
    with loops.host_loops():
        host = simulate_fast(ns_cfg(0.5), seed=0, device="cuda")
    same_ns(semi, host, "NS semi-implicit, the full run")
    require(semi.timed_iters == 37, f"NS semi timed_iters {semi.timed_iters}")
    walls.append(("NS semi 37 steps", semi.t_elapsed, host.t_elapsed))
    both(lambda: simulate_fast(ns_cfg(0.5), seed=0, max_steps=5, device="cuda"),
         "NS semi-implicit, 5 steps", same_ns, plain=True)

    # MG 4097^2 and mg_pcg_ds 4097^2
    n, tol = 4097, 1e-6
    h = 1.0 / (n - 1)
    mg_cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                      post_smooth=5)
    b = poisson_rhs(n, "float32")

    def same_solve(want_it):
        def compare(g, hh, what):
            (gh, gl), gr, git = g
            (hh_, hl), hr, hit = hh
            rel = true_rel(gh.double() + gl.double(), b, h)
            require(git == hit == want_it and torch.equal(gh, hh_) and torch.equal(gl, hl)
                    and torch.equal(gr, hr),
                    f"{what}: {git} vs host loop {hit} (expected {want_it}), or fields differ")
            require(rel <= tol, f"{what}: true f64 residual {rel:.3e} > {tol}")
            log(f"{what}: {git} iterations, bitwise equal to the host loop, true f64 "
                f"r_rms/f_rms {rel:.4e}")
        return compare

    for name, solve, want_it in (
            ("MG ds 4097^2", lambda: mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=mg_cfg,
                                                return_pair=True), 4),
            ("mg_pcg_ds 4097^2", lambda: mg_pcg_ds(b, h, 0.0, tol, 30, cfg=mg_cfg,
                                                  return_pair=True), None)):
        solve()
        launched = loops.stats["launches"]
        g, tg = median_seconds(solve)
        require(loops.stats["launches"] - launched == 5, f"{name}: not one graph launch a call")
        with loops.host_loops():
            hh, th = median_seconds(solve)
        same_solve(want_it or hh[2])(g, hh, name)
        walls.append((name, tg, th))
        both(solve, name, same_solve(want_it or hh[2]), plain=True)

    phase_host_tiers(both, same_solve, walls, mixed, ns_ten, b, mg_cfg)
    phase_sharded_loops(smi, both, same_ns, same_solve, walls, b, mg_cfg)

    # diffusion 128^3: K=1 and K=3 to tol 1e-6, ds to 1e-10; plain at 50 a step
    def same_h(g, hh, what):
        require((g.iters_total, g.timed_iters, g.converged) ==
                (hh.iters_total, hh.timed_iters, hh.converged) and np.array_equal(g.H, hh.H),
                f"{what}: {g.iters_total} iterations vs host loop {hh.iters_total}, or H differs")
        log(f"{what}: {g.iters_total} iterations, H bitwise equal to the host loop")

    pallas = ExecutionPolicy.PALLAS
    for name, dcfg, want in (
            ("diffusion 128^3 K=1", DiffusionConfig(ttot=2.0, tol=1e-6, policy=pallas), 18980),
            ("diffusion 128^3 K=3", DiffusionConfig(ttot=2.0, tol=1e-6, policy=pallas,
                                                    check_every=3), K3_ITERS_UNFUSED),
            ("diffusion 128^3 ds", DiffusionConfig(ttot=2.0, tol=1e-10,
                                                   policy=ExecutionPolicy.PALLAS_DS), 41148)):
        g, hh = both(lambda: diffusion3d.solve(dcfg, device="cuda"), name, same_h)
        require(g.iters_total == want or name.endswith("K=3"),
                f"{name}: {g.iters_total} iterations, expected {want}")
        walls.append((name, g.bench.delta_t, hh.bench.delta_t))
        both(lambda: diffusion3d.solve(dataclasses.replace(dcfg, iter_max=50), device="cuda"),
             name + ", 50 a step", same_h, plain=True)

    # device launches: the graphs' counts against the host loops' and the
    # profiler's, in a process of their own (launch_counts)
    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, os.path.abspath(__file__), LAUNCH_COUNTS], cwd=here,
                       capture_output=True, text=True, timeout=300)
    lines = p.stdout.strip().splitlines()
    require(p.returncode == 0 and lines, f"{LAUNCH_COUNTS}: exit {p.returncode}\n"
                                         f"{(p.stdout + p.stderr)[-2000:]}")
    got = json.loads(lines[-1])
    graphs, host, seen = got["graphs"], got["host"], got["seen"]
    best = {k: max(w[k] for w in seen) for k in host}
    log(f"NS explicit 20 steps, device launches: graphs {graphs}, host loops {host}, the "
        f"profiler on the host loops {best} (windows {seen}); on the graphs it saw "
        f"{got['on_graphs']}")
    require(graphs == host, f"device launches {graphs} vs the host loops' {host}")
    require(all(host[k] - 1 <= best[k] <= host[k] for k in host),
            f"the profiler's counts {best} are not those of the host loops {host} or one fewer")

    # a body that reads the host fails its capture and raises
    try:
        loops.device_call(lambda c: c + float(c.sum()), torch.zeros(3, device="cuda"))
        require(False, "a host read in a captured body did not raise")
    except RuntimeError as exc:
        log(f"a host read in a captured body raises: {str(exc).splitlines()[0][:80]}")
    require(float(torch.ones(3, device="cuda").sum()) == 3.0, "the card fails after it")
    for what, tg, th in walls:
        pr9 = f"{PR9_SECONDS[what]:.4f} s" if what in PR9_SECONDS else "not measured"
        log(f"wall {what}: graphs {tg:.4f} s, host loops {th:.4f} s, PR 9 {pr9}")
    log(f"graph launches {loops.stats['launches']}, captures {loops.stats['captures']}")


def phase_oracles_and_entry_points(n_fine=513, n_f64=257, n_3d=64, n_ds=4097, n_pallas=2049,
                                   n_demo=48, ns_size=None, ds_outers=4):
    """Phase 23: the modules of the last slice.  ``prolongate_shifts``
    against ``prolongate`` and the host's ``prolongate_scatter``; #5 in
    float64 against the port's scipy and native oracles and #8 in float32
    against the native float64 oracle; each of JAX's ``*_jit`` entry
    points bitwise against its base (the two share one captured graph);
    the volume demo's solve bitwise against a direct solve, and a field
    through ``utils.checkpoint`` and ``volume_slices``' loader.  No
    matplotlib is used: the plotting modules must import without it."""
    import importlib.util
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from fpr_tpu_torch.core.config import (CoarseSolver, ExecutionPolicy, InitScheme,
                                           MGConfig)
    from fpr_tpu_torch.models import diffusion3d, navier_stokes
    from fpr_tpu_torch.ops import dual_time, oracle, stencil_pass, transfer
    from fpr_tpu_torch.plotting import plots, volume_slices, volume_viewer  # noqa: F401
    from fpr_tpu_torch.solvers import krylov, multigrid
    from fpr_tpu_torch.utils import checkpoint, native

    log("== phase 23: prolongate_shifts, #5 and #8 against the port's oracles, the *_jit "
        "entry points against their bases, the volume demo's solve and loader")
    on_card = torch.device(DEVICE).type == "cuda"
    lib = native.get_lib()
    require(lib is not None, "the native oracle library did not build (g++ and native/)")
    log(f"native oracles: {native.library_path().name}  matplotlib "
        f"{'present' if importlib.util.find_spec('matplotlib') else 'absent'} (not used here)")

    def launched(counts, *names):
        if on_card:
            for k in names:
                require(counts[k] > 0, f"phase 23 never launched {k}")
        return {k: v for k, v in counts.items() if v}

    # prolongate_shifts: the three forms add the same weighted coarse values
    # (weights 1, 1/2, 1/4) in other orders, so they agree to a few ulps of
    # the largest coarse value
    rng = np.random.default_rng(23)
    nc = (n_fine - 1) // 2 + 1
    for dtype in (np.float32, np.float64):
        c = rng.random((nc, nc)).astype(dtype)
        scatter = oracle.prolongate_scatter(c, (n_fine, n_fine))
        ct = torch.tensor(c, device=DEVICE)
        bound = 4 * float(np.finfo(dtype).eps) * float(np.abs(c).max())
        for apply_bcs in (False, True):
            got = transfer.prolongate_shifts(ct, (n_fine, n_fine), apply_bcs=apply_bcs)
            gather = transfer.prolongate(ct, (n_fine, n_fine), apply_bcs=apply_bcs)
            want = scatter.copy()
            if apply_bcs:
                want[:, 0], want[:, -1] = want[:, 1], want[:, -2]
            e_g = float((got - gather).abs().max())
            e_s = float(np.abs(got.cpu().numpy() - want).max())
            log(f"prolongate_shifts {n_fine}^2 {np.dtype(dtype).name} apply_bcs={apply_bcs}: "
                f"max |diff| to prolongate {e_g:.3e}, to prolongate_scatter {e_s:.3e} "
                f"(bound {bound:.3e})")
            require(got.dtype == ct.dtype and e_g <= bound and e_s <= bound,
                    f"prolongate_shifts {np.dtype(dtype).name} apply_bcs={apply_bcs}: "
                    f"{e_g:.3e}, {e_s:.3e} > {bound:.3e}")

    # #5 in float64 against the sparse Helmholtz matrix and the C++ oracles
    n, c = n_f64, 2.5
    h = 1.0 / (n - 1)
    u, f = rng.random((n, n)), rng.random((n, n))
    x = np.zeros((n, n))
    x[1:-1, 1:-1] = u[1:-1, 1:-1]
    ut, ft, xt = (torch.tensor(a, device=DEVICE) for a in (u, f, x))
    A = oracle.helmholtz_operator(n - 2, n - 2, h, c)

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    (mv, res, (us, rms)), _, counts = counted(lambda: (
        stencil_pass.matvec(xt, h, h, c), stencil_pass.residual_rp(ut, ft, h, c),
        stencil_pass.smooth_rp(ut, ft, h, c)))
    uo, ss = native.oracle_jacobi2d(u, f, h, c)
    errs = dict(matvec=rel(mv.cpu().numpy()[1:-1, 1:-1].ravel(), A @ x[1:-1, 1:-1].ravel()),
                residual=rel(res.cpu().numpy(), native.oracle_residual2d(u, f, h, c)),
                smooth=rel(us.cpu().numpy(), uo),
                smooth_rms=abs(float(rms) / float(np.sqrt(ss / u.size)) - 1.0))
    log(f"#5 float64 {n}^2, c={c}: relative errors {errs} (bound 1e-12; matvec against "
        f"helmholtz_operator, residual and smooth against the native oracles)  launches "
        f"{launched(counts, 'stencil')}")
    require(all(e <= 1e-12 for e in errs.values()), f"#5 against the oracles: {errs}")

    # #8 in float32 against the float64 oracle: the kernel rounds each of its
    # ~10 operations a cell to float32 (a few ulps of |Htau|), and sums the
    # squares in float32 in another order
    shape = (n_3d,) * 3
    kw = diffusion_kw(shape)
    Ht = rng.random(shape, dtype=np.float32)
    Hs = (Ht + 1e-3 * rng.standard_normal(shape)).astype(np.float32)
    (out, sumsq), _, counts = counted(lambda: dual_time.dual_time_step(
        torch.tensor(Ht, device=DEVICE), torch.tensor(Hs, device=DEVICE), **kw))
    want, want_ss = native.oracle_dual_time3d(Ht, Hs, **kw)
    eps32 = float(np.finfo(np.float32).eps)
    bound = 8 * eps32 * float(np.abs(Hs).max())
    err, err_ss = float(np.abs(out.cpu().numpy() - want).max()), abs(float(sumsq) / want_ss - 1)
    log(f"#8 float32 {n_3d}^3: max |diff| to oracle_dual_time3d {err:.3e} (bound {bound:.3e}), "
        f"sumsq relative {err_ss:.3e} (bound {REL_SUM})  launches "
        f"{launched(counts, 'dual_time')}")
    require(err <= bound and err_ss <= REL_SUM, f"#8 against the oracle: {err:.3e}, {err_ss:.3e}")

    def same(name, a, b, counts, *kernels_needed):
        ta, tb = tensors(a), tensors(b)
        equal = len(ta) == len(tb) and all(torch.equal(p, q) for p, q in zip(ta, tb))
        rest = [(p, q) for p, q in zip(a, b) if not isinstance(p, (torch.Tensor, tuple))]
        log(f"{name}: {'bitwise' if equal else 'DIFFERENT'}, counts {[p for p, _ in rest]} "
            f"(base {[q for _, q in rest]})  launches {launched(counts, *kernels_needed)}")
        require(equal and all(p == q for p, q in rest), f"{name} is not its base's result")

    # the ds MG row (phase 4) and Krylov ds (phase 12) from zero
    h = 1.0 / (n_ds - 1)
    cfg = MGConfig(coarse_size=min(513, (n_ds - 1) // 2 + 1), coarse_solver=CoarseSolver.DST,
                   pre_smooth=5, post_smooth=5)
    b = poisson_rhs(n_ds, "float32")
    got, _, counts = counted(lambda: multigrid.mg_solve_ds_jit(b, h, 0.0, 1e-6, 30, cfg, None,
                                                               True))
    base = multigrid.mg_solve_ds(None, b, h, 0.0, 1e-6, 30, cfg=cfg, return_pair=True)
    same(f"mg_solve_ds_jit {n_ds}^2", got, base, counts, "defect", "smooth_down", "corr_up")
    if ds_outers is not None:
        require(got[2] == ds_outers, f"mg_solve_ds_jit: {got[2]} outers, not {ds_outers}")
    got, _, counts = counted(lambda: krylov.mg_pcg_ds_jit(b, h, 0.0, 1e-6, 30, cfg, True))
    base = krylov.mg_pcg_ds(b, h, 0.0, 1e-6, 30, cfg=cfg, return_pair=True)
    same(f"mg_pcg_ds_jit {n_ds}^2", got, base, counts, "defect")
    del b, got, base
    # the host tiers in float64: PALLAS mg_solve (phase 11) and mg_solve_mixed
    h = 1.0 / (n_pallas - 1)
    b = poisson_rhs(n_pallas, "float64")
    pallas = MGConfig(policy=ExecutionPolicy.PALLAS)
    got, _, counts = counted(lambda: multigrid.mg_solve_jit(b.new_zeros(b.shape), b, h, 0.0,
                                                            1e-6, 20, False, pallas))
    base = multigrid.mg_solve(b.new_zeros(b.shape), b, h, 0.0, 1e-6, 20, cfg=pallas)
    same(f"mg_solve_jit PALLAS {n_pallas}^2 float64", got, base, counts, "stencil")
    got, _, counts = counted(lambda: multigrid.mg_solve_mixed_jit(b.new_zeros(b.shape), b, h,
                                                                  0.0, 1e-6, 30))
    base = multigrid.mg_solve_mixed(b.new_zeros(b.shape), b, h, 0.0, 1e-6, 30)
    same(f"mg_solve_mixed_jit {n_pallas}^2", got, base, counts, "smooth2r_split",
         "corr_smooth2")
    del b, got, base
    # one step of the NS host loop (phase 13's configuration)
    ns = host_cfg(0.5, **(ns_size or {}))
    T = navier_stokes.init_field(ns, InitScheme.COSINE, device=DEVICE, dtype=torch.float64)
    W = torch.tensor(rng.standard_normal((ns.ny, ns.nx)) * 10.0, device=DEVICE)
    got, _, counts = counted(lambda: navier_stokes.ns_step_jit(T, W, torch.zeros_like(W), ns))
    base = navier_stokes.ns_step(T, W, torch.zeros_like(W), ns)
    same(f"ns_step_jit {ns.nx}x{ns.ny} beta=0.5 mixed", got, base, counts, "smooth2r_split",
         "corr_smooth2")
    del T, W, got, base

    # the volume demo's solve, and a field through a checkpoint
    H, secs, _ = counted(lambda: volume_slices.demo_field(n_demo, device=DEVICE))
    direct = diffusion3d.solve(volume_slices.demo_config(n_demo), dtype=torch.float32,
                               device=DEVICE)
    log(f"volume demo {n_demo}^3 (JNP, float32, t=0.4): {direct.iters_total} iterations, "
        f"{secs:.3f} s; H {'bitwise' if np.array_equal(H, direct.H) else 'DIFFERENT'} to a "
        f"direct solve, max {float(H.max()):.6f}")
    require(H.shape == (n_demo,) * 3 and H.dtype == np.float32 and np.isfinite(H).all()
            and np.array_equal(H, direct.H), "the volume demo's solve is not the direct one")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "volume.npz"
        checkpoint.save(path, H=torch.tensor(H, device=DEVICE))
        back = volume_slices.load_field(path)
    require(back.dtype == H.dtype and np.array_equal(back, H),
            "H through checkpoint.save and volume_slices.load_field is not bitwise H")
    log("H through checkpoint.save and volume_slices.load_field: bitwise")


def gib(nbytes) -> str:
    return "none" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


def peak_of(fn):
    """(fn(), the most card memory its tensors held at once in bytes
    (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
    seconds to the end of its device work)."""
    import torch

    cuda = torch.device(DEVICE).type == "cuda"
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, torch.cuda.max_memory_allocated() if cuda else None, time.perf_counter() - t0


def rms64(a) -> float:
    import torch

    return float(torch.linalg.vector_norm(a, dtype=torch.float64)) / a.numel() ** 0.5


def phase_16385(smi, n=16385, n_hist=10, niters=60, tol=1e-6, ds_outers=6):
    """Phase 24: the sweep's largest grid (``mg_workprec_k14``) in one
    process, no ``clear_cache``: ``mg_solve_ds`` (6 outers), ``mg_pcg_ds``
    as a graph, the same under ``loops.host_loops()`` (bitwise: u pair,
    r_rms, count), the first n_hist iterations of its step as host loops
    and through the plain versions in lockstep, the same recurrence written
    again apart from the port (``phase_16385_witness``), and the float32
    preconditioner against the float64 V-cycle at 8193^2 and 16385^2.  Each
    part's peak card memory, each graph's pool."""
    import torch

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig
    from fpr_tpu_torch.solvers import krylov, multigrid
    from fpr_tpu_torch.solvers.poisson import true_rel_residual

    log(f"== phase 24: {n}^2 in one process, no clear_cache  [{smi}]")
    h = 1.0 / (n - 1)
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5, post_smooth=5)
    b = poisson_rhs(n, "float32")
    tolf = tol * rms64(b)

    def graph_call(what, fn):
        """fn() with its peak, its graph's pool if one was built, and the
        cached graphs closed to make room."""
        captures, reclaimed = loops.stats["captures"], loops.stats["reclaimed"]
        out, peak, secs = peak_of(fn)
        pool = last_graph()[1]["pool_bytes"] if loops.stats["captures"] > captures else None
        log(f"{what}: {secs:.3f} s (build and solve), peak {gib(peak)}, graph pool "
            f"{gib(pool)}, cached graphs closed for memory "
            f"{loops.stats['reclaimed'] - reclaimed}")
        return out

    def pcg():
        return krylov.mg_pcg_ds(b, h, 0.0, tol, niters, cfg=cfg, return_pair=True)

    (uh, ul), r, it = graph_call(f"mg_solve_ds {n}^2", lambda: multigrid.mg_solve_ds(
        None, b, h, 0.0, tol, 30, cfg=cfg, return_pair=True))
    rel = true_rel_residual(uh, ul, b, h)
    log(f"mg_solve_ds {n}^2: {it} outers, r_rms {float(r):.4e}, true f64 r_rms/f_rms "
        f"{rel:.4e}")
    require(it == ds_outers and rel <= tol,
            f"mg_solve_ds {n}^2: {it} outers (not {ds_outers}), residual {rel:.3e}")
    del r
    (gh, gl), gr, git = graph_call(f"mg_pcg_ds {n}^2 as a graph", pcg)
    log(f"mg_pcg_ds {n}^2 as a graph: {git} iterations, r_rms {float(gr):.4e} against tol "
        f"rms(f) {tolf:.4e} (r_rms at the start {rms64(b):.4e}), true f64 r_rms/f_rms "
        f"{true_rel_residual(gh, gl, b, h):.4e}")
    phase_16385_reclaim(b, h, cfg, tol, (uh, ul), ds_outers)
    del uh, ul
    with loops.host_loops():
        (hh, hl), hr, hit = graph_call(f"mg_pcg_ds {n}^2 as host loops", pcg)
    log(f"mg_pcg_ds {n}^2 as host loops: {hit} iterations, r_rms {float(hr):.4e}")
    same = torch.equal(gh, hh) and torch.equal(gl, hl) and torch.equal(gr, hr)
    log(f"graph against host loops: {'bitwise' if same else 'DIFFERENT'}, {git} and "
        f"{hit} iterations")
    require(same and git == hit, f"mg_pcg_ds {n}^2: the graph is not the host loops")
    del gh, gl, gr, hh, hl, hr
    port = phase_16385_history(b, h, cfg, tol, niters, n_hist)
    phase_16385_witness(b, h, cfg, tol, n_hist, port)
    del b
    for m in (n // 2 + 1, n):
        phase_16385_precond(m, cfg, tol)


def phase_16385_reclaim(b, h, cfg, tol, want_u, want_it, room=6 * 2**30):
    """Phase 24's reclaim: with the 16385^2 graphs cached, a ballast tensor
    takes the card's free memory down to ``room`` bytes, less than the
    pool of the ds solve's graph, and a new graph of that solve (an
    iteration cap of 31, not 30: another key) is built: ``device_call`` must close
    cached graphs, free their pools and build it, with the same bits as
    the cached one gave."""
    import torch

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.solvers import multigrid

    cached = len(loops._cache)
    sync()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    ballast = torch.empty(max(free - room, 0), dtype=torch.uint8, device=DEVICE)
    reclaimed = loops.stats["reclaimed"]
    (uh, ul), _, it = multigrid.mg_solve_ds(None, b, h, 0.0, tol, 31, cfg=cfg,
                                            return_pair=True)
    sync()
    closed = loops.stats["reclaimed"] - reclaimed
    same = torch.equal(uh, want_u[0]) and torch.equal(ul, want_u[1])
    log(f"reclaim: {cached} graphs cached, a ballast of {gib(ballast.numel())} left "
        f"{gib(room)} of the card's {gib(total)} free; mg_solve_ds with another key: "
        f"{closed} cached graphs closed for memory, {it} outers, "
        f"{'bitwise' if same else 'DIFFERENT'} to the cached graph's result; the last "
        f"graph's pool {gib(last_graph()[1]['pool_bytes'])}")
    del ballast
    require(closed >= 1 and same and it == want_it,
            f"reclaim: {closed} graphs closed, {it} outers, bitwise {same}")


def phase_16385_history(b, h, cfg, tol, niters, n_hist):
    """Phase 24's history: the first n_hist iterations of ``mg_pcg_ds``'s
    step (``krylov._mg_pcg_ds_history``) through the plain versions and as
    host loops in lockstep: every field and scalar bitwise, r_rms within
    REL_SUM (the kernels sum in another order).  Each
    iteration: z's boundary ring zero, the curvature within n EPS32 of the
    float64 sum p.(A p) of the same p, and p.Ap < 0; logged: s1 = z.r,
    negative while the float32 V-cycle is negative definite on r as M is in
    exact arithmetic (alpha > 0), the first iteration where it is not, and
    the preconditioner's contraction rms(A z - r) / rms(r) in float64.
    Returns each iteration's scalars and r_rms."""
    import numpy as np
    import torch

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.ops import stencil2d
    from fpr_tpu_torch.solvers import krylov

    n = b.shape[0]
    bound = n * float(np.finfo(np.float32).eps)
    scalars = ("s1", "s2", "beta", "pAp", "alpha")

    def history():
        return krylov._mg_pcg_ds_history(b, h, 0.0, tol, niters, cfg)

    def run():
        out = []
        with loops.host_loops():
            plain, kern = history(), history()
            prev, first_s1 = float("inf"), None
            for i in range(1, n_hist + 1):
                with plain_kernels():
                    step = next(plain, None)
                if step is None:  # converged
                    break
                sp, dp = step
                sk, dk = next(kern)
                same = (all(torch.equal(sk[k], sp[k]) for k in ("u", "r", "p"))
                        and torch.equal(dk["z"], dp["z"])
                        and all(torch.equal(dk[k], dp[k]) for k in scalars))
                rk, rp = float(sk["r_rms"]), float(sp["r_rms"])
                require(same and abs(rk - rp) <= REL_SUM * rp,
                        f"history {n}^2 iteration {i}: the host loops' fields or scalars "
                        f"differ from the plain versions' (r_rms {rk!r} vs {rp!r})")
                del sk, dk
                z, p, r_new = dp["z"], sp["p"], sp["r"]
                ring = float(torch.cat([z[0], z[-1], z[:, 0], z[:, -1]]).abs().max())
                p64 = p.double()
                pap64 = float(torch.sum(p64 * stencil2d.matvec(p64, h, h, 0.0)))
                del p64
                # the step's r is the carry's before it: z = M r_old of the new carry
                r_old = sp["r_old"].double()
                contr = rms64(stencil2d.residual(z.double(), r_old, h, 0.0)) / rms64(r_old)
                del r_old
                v = {k: float(dp[k]) for k in scalars}
                r_rms = float(sp["r_rms"])
                rel = abs(v["pAp"] - pap64) / abs(pap64)
                log(f"{n}^2 iteration {i}: r_rms {r_rms:.4e}{' (grew)' if r_rms > prev else ''}"
                    f"  s1 {v['s1']:.4e}  s2 {v['s2']:.4e}  beta {v['beta']:.4e}  pAp "
                    f"{v['pAp']:.4e} (f64 {pap64:.4e}, rel {rel:.1e})  alpha {v['alpha']:.4e}  "
                    f"max|z| on the ring {ring}  M: rms(A z - r)/rms(r) {contr:.4e}"
                    "  host loops = plain")
                require(ring == 0.0, f"history {n}^2 iteration {i}: z is {ring} on the ring")
                require(rel <= bound, f"history {n}^2 iteration {i}: curvature {v['pAp']!r} "
                                      f"vs float64 {pap64!r}")
                # p.Ap < 0 by its form; s1 = z.r < 0 only while the float32
                # V-cycle is negative definite on r, as M is in exact arithmetic
                require(v["pAp"] < 0, f"history {n}^2 iteration {i}: pAp {v['pAp']!r}")
                if v["s1"] >= 0 and first_s1 is None:
                    first_s1 = i
                out.append(dict(v, r_rms=r_rms))
                prev = r_rms
                del sp, dp, z, p, r_new, step
        return out, first_s1

    (rs, first_s1), peak, secs = peak_of(run)
    r_rms = ", ".join(f"{d['r_rms']:.4e}" for d in rs)
    log(f"history {n}^2: {len(rs)} iterations through the plain versions and as host "
        f"loops in {secs:.2f} s, peak {gib(peak)}; r_rms [{r_rms}]; the first iteration "
        f"with s1 >= 0 (alpha <= 0): {first_s1}")
    return rs


def lap64(v, h):
    """The 5-point Laplacian of v on the interior, 0 on the ring."""
    import torch

    out = torch.zeros_like(v)
    c = out[1:-1, 1:-1]
    c.copy_(v[1:-1, 2:]).add_(v[1:-1, :-2]).add_(v[2:, 1:-1]).add_(v[:-2, 1:-1])
    c.sub_(v[1:-1, 1:-1], alpha=4.0).mul_(1.0 / (h * h))
    return out


# the port's r_rms against pcg_witness's in the iterations they share: a
# float64 recurrence against the port's double-single one and float32
# scalars (1.5e-4 apart at 16385^2, an NVIDIA H100 80GB HBM3 at 700 W)
WITNESS_REL = 1e-3
# what pcg_witness keeps in float32, as mg_pcg_ds does, by variant
WITNESS = {"z, p": ("z", "p"), "z": ("z",), "none": ()}


def pcg_witness(b, h, cfg, tol, iters, variant):
    """JAX's ``mg_pcg_ds`` (``fpr_tpu/solvers/krylov.py:279-310``) written
    again from its source in plain float64 PyTorch, none of the port's step
    in it (no ``krylov`` code, defect pass, curvature form or row sums): u,
    r = A u - f (``lap64``), every dot and scalar in float64.  variant
    (``WITNESS``): what stays float32 as the method keeps it: "z, p" (z the
    float32 ``vcycle_stk`` of r rounded to float32, p rounded to float32
    once formed), "z" (p float64), "none" (z the float64 ``vcycle`` of r).
    Yields dict(r_rms, s1, s2, beta, pAp, alpha) an iteration, up to iters
    or r_rms < tol rms(f)."""
    import torch

    from fpr_tpu_torch.solvers import multigrid

    f32 = WITNESS[variant]
    f = b.double()
    tolf = tol * rms64(f)
    u = torch.zeros_like(f)
    r = -f
    r_old, p, rz_old = r, torch.zeros_like(f), 1.0
    for _ in range(iters):
        if "z" in f32:
            L = torch.empty((2,) + r.shape, dtype=torch.float32, device=r.device)
            L[1] = r
            z = multigrid.vcycle_stk(L, h, 0.0, tol, cfg, assume_zero_u=True)[0][0].double()
            del L
        else:
            z = multigrid.vcycle(torch.zeros_like(r), r, h, 0.0, tol, cfg)[0]
        s1, s2 = float(torch.sum(z * r)), float(torch.sum(z * r_old))
        beta = (s1 - s2) / rz_old
        p = z.add_(p, alpha=beta)
        del z
        if "p" in f32:
            p = p.float().double()
        pAp = float(torch.sum(p * lap64(p, h)))
        alpha = s1 / pAp
        u.sub_(p, alpha=alpha)
        r_old, r, rz_old = r, lap64(u, h).sub_(f), s1
        d = dict(r_rms=rms64(r), s1=s1, s2=s2, beta=beta, pAp=pAp, alpha=alpha)
        yield d
        if d["r_rms"] < tolf:
            return


def phase_16385_witness(b, h, cfg, tol, n_hist, port, cap=60):
    """Phase 24's witness of ``mg_pcg_ds``'s recurrence, apart from the
    port's: ``pcg_witness`` at 16385^2 for n_hist iterations in each
    variant beside the port's history (port), and, "z, p", at 8193^2 to
    convergence beside the port's ``mg_pcg_ds`` there.  Held: at 8193^2
    both converge, within one iteration of each other; at 16385^2 the
    port's r_rms within WITNESS_REL of the "z, p" witness's in every
    iteration, both float32-z variants still above rms(f) after n_hist
    iterations and the float64-z one below tol rms(f): the stagnation is
    the float32 z's, whoever runs the recurrence."""
    from fpr_tpu_torch.solvers import krylov

    n = b.shape[0]
    m = n // 2 + 1
    bm = poisson_rhs(m, "float32")
    hm = 1.0 / (m - 1)
    (_, _), rm, itm = krylov.mg_pcg_ds(bm, hm, 0.0, tol, cap, cfg=cfg, return_pair=True)
    wm = list(pcg_witness(bm, hm, cfg, tol, cap, "z, p"))
    tolm = tol * rms64(bm)
    log(f"witness {m}^2 (z, p float32): {len(wm)} iterations, r_rms {wm[-1]['r_rms']:.4e} "
        f"against tol rms(f) {tolm:.4e}; the port's mg_pcg_ds {itm} iterations, "
        f"r_rms {float(rm):.4e}")
    require(wm[-1]["r_rms"] < tolm and float(rm) < tolm and abs(len(wm) - itm) <= 1,
            f"witness {m}^2: {len(wm)} iterations to r_rms {wm[-1]['r_rms']!r}, the port's "
            f"{itm} to {float(rm)!r}")
    del bm, rm
    runs = {}
    for variant in WITNESS:
        t0 = time.perf_counter()
        runs[variant] = list(pcg_witness(b, h, cfg, tol, n_hist, variant))
        log(f"witness {n}^2 ({variant or 'nothing'} float32): {len(runs[variant])} "
            f"iterations in {time.perf_counter() - t0:.2f} s")
    for i, d in enumerate(port):
        row = [f"port r_rms {d['r_rms']:.4e} s1 {d['s1']:.3e} alpha {d['alpha']:.3e}"]
        for variant, ws in runs.items():
            if i < len(ws):
                w = ws[i]
                row.append(f"[{variant}] r_rms {w['r_rms']:.4e} s1 {w['s1']:.3e} "
                           f"beta {w['beta']:.3e} alpha {w['alpha']:.3e}")
        log(f"{n}^2 iteration {i + 1}: " + "; ".join(row))
    for i, (d, w) in enumerate(zip(port, runs["z, p"])):
        require(len(runs["z, p"]) == len(port)
                and abs(d["r_rms"] - w["r_rms"]) <= WITNESS_REL * w["r_rms"],
                f"witness {n}^2 iteration {i + 1}: r_rms {w['r_rms']!r}, the port's "
                f"{d['r_rms']!r}")
    f_rms, tolf = rms64(b), tol * rms64(b)
    last = {variant: ws[-1]["r_rms"] for variant, ws in runs.items()}
    require(last["z, p"] > f_rms and last["z"] > f_rms and last["none"] < tolf,
            f"witness {n}^2: r_rms after the last iteration {last}, rms(f) {f_rms!r}, "
            f"tol rms(f) {tolf!r}")
    log(f"witness {n}^2: the port within {WITNESS_REL} of the witness (z, p float32) in "
        f"{len(port)} iterations; r_rms after them {last} against rms(f) {f_rms:.4e}")


def phase_16385_precond(n, cfg, tol):
    """Phase 24's preconditioner: one float32 V-cycle from zero
    (``vcycle_stk``, the kernels) against the float64 ``vcycle`` on the same
    r (the rhs), and each one's contraction rms(r - A z) / rms(r) in
    float64, the float64 z's also once rounded to float32 (what a float32
    direction can hold at best)."""
    import torch

    from fpr_tpu_torch.ops import stencil2d
    from fpr_tpu_torch.solvers import multigrid

    def run():
        h = 1.0 / (n - 1)
        r = poisson_rhs(n, "float32")
        L = torch.empty((2, n, n), dtype=torch.float32, device=DEVICE)
        L[1] = r
        L, _ = multigrid.vcycle_stk(L, h, 0.0, tol, cfg, assume_zero_u=True)
        z32 = L[0].double()
        del L
        r64 = r.double()
        del r
        z64, _ = multigrid.vcycle(torch.zeros_like(r64), r64, h, 0.0, tol, cfg)
        out = dict(rel_z=rms64(z32 - z64) / rms64(z64),
                   contr32=rms64(stencil2d.residual(z32, r64, h, 0.0)) / rms64(r64),
                   contr64=rms64(stencil2d.residual(z64, r64, h, 0.0)) / rms64(r64))
        z64 = z64.float().double()
        out["contr64_32"] = rms64(stencil2d.residual(z64, r64, h, 0.0)) / rms64(r64)
        return out

    out, peak, secs = peak_of(run)
    log(f"preconditioner {n}^2, r = the rhs: float32 vcycle_stk against float64 vcycle: "
        f"rms(z32 - z64)/rms(z64) {out['rel_z']:.3e}; rms(A z - r)/rms(r) float32 "
        f"{out['contr32']:.4e}, float64 {out['contr64']:.4e}, float64 rounded to float32 "
        f"{out['contr64_32']:.4e}  ({secs:.2f} s, peak {gib(peak)})")


LAUNCH_COUNTS = "--launch-counts"


def launch_counts() -> dict:
    """The device launches of K1, K4 and the legs in 20 NS explicit steps
    (phase 22), run by ``chip_smoke.py --launch-counts`` in a process of its
    own: as the graphs count them (``kernels.sync_launches``), as the host
    loops' wrappers count them (each launches once a call), and as
    torch.profiler sees the host loops in up to 8 windows, stopping at the
    first that sees every launch, and once the graphs (it sees no kernel
    inside a conditional node).  In a process that has run phases 1-21 the
    profiler lost one K1 event of every window now and then; in a fresh one
    it lost none (an NVIDIA H100 80GB HBM3, 700.00 W)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.models.navier_stokes import simulate_fast

    kernels.build()

    def by_kernel(counts):
        return {"defect": counts["defect"], "ns_fused": counts["ns_fused"],
                "legs": counts["smooth_down"] + counts["corr_up"]}

    def profiled(host):
        if not host:
            run()  # host_loops() closed the cached graph: built again outside the window
        with loops.host_loops() if host else contextlib.nullcontext(), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return {k: sum(e.count for e in prof.key_averages() if name in e.key)
                for k, name in PROFILED.items()}

    cfg = ns_cfg(0.0)
    run = lambda: simulate_fast(cfg, seed=0, max_steps=20, device="cuda")  # noqa: E731
    run()  # the graph's build, with its warm-up pass
    kernels.reset_launches()
    run()
    graphs = by_kernel(kernels.sync_launches())
    with loops.host_loops():
        kernels.reset_launches()
        run()
        host = by_kernel(kernels.sync_launches())
    seen = []
    while len(seen) < 8:
        seen.append(profiled(True))
        if seen[-1] == host:
            break
    return dict(graphs=graphs, host=host, seen=seen, on_graphs=profiled(False))


def phase_host_tiers(both, same_solve, walls, mixed, ns_ten, b, mg_cfg):
    """Phase 22's host tiers and FMG, each one graph a solve or a step
    against the host loops, bitwise.  both, same_solve, walls: phase 22's;
    b: its MG rhs and mg_cfg its ladder; mixed: phase 10's MG mixed (graph,
    host loops) results; ns_ten: phase 13's 10-step runs."""
    import numpy as np
    import torch

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.core.config import ExecutionPolicy, MGConfig
    from fpr_tpu_torch.models.navier_stokes import simulate
    from fpr_tpu_torch.solvers.multigrid import mg_solve, mg_solve_ds, mg_solve_mixed, mg_solve_rp

    tol = 1e-6
    h = 1.0 / (b.shape[0] - 1)
    fname = f"MG ds FMG {b.shape[0]}^2"
    # mg_solve_ds(fmg=True): the FMG preamble in the solve's graph
    fmg = lambda: mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=mg_cfg,  # noqa: E731
                              return_pair=True, fmg=True)
    plain_ds = lambda: mg_solve_ds(None, b, h, 0.0, tol, 30, cfg=mg_cfg,  # noqa: E731
                                   return_pair=True)
    fmg()
    built(fname)
    plain_ds()
    (_, _, it0), secs0, c0 = counted(plain_ds)
    ((fh, fl), fr, it1), secs1, c1 = counted(fmg)
    rel = true_rel(fh.double() + fl.double(), b, h)
    pre = {k: c1[k] - it1 * (c0[k] // it0) for k in ("defect", "smooth_down", "corr_up")}
    log(f"{fname}: {it1} outers ({it0} without FMG), {secs1:.4f} s ({secs0:.4f} s), "
        f"true f64 r_rms/f_rms {rel:.4e}, launches {({k: c1[k] for k in pre})} of which the "
        f"preamble's {pre}")
    require(it1 <= it0, f"FMG: {it1} outers, more than the {it0} without it")
    require(rel <= tol, f"FMG: true f64 residual {rel:.3e} > {tol}")
    require(pre["defect"] == 1 and pre["smooth_down"] > 0 and pre["corr_up"] > 0,
            f"FMG: the preamble launched {pre}")
    for plain in (False, True):
        both(fmg, fname, same_solve(it1), plain)

    # the host tiers' solvers: one graph a solve against the host loops
    def same_u(g, hh, what):
        require(g[2] == hh[2] and torch.equal(g[0], hh[0]) and torch.equal(g[1], hh[1]),
                f"{what}: {g[2]} outers vs host loop {hh[2]}, or fields differ")
        log(f"{what}: {g[2]} outers, bitwise equal to the host loops")

    n2 = 2049
    h2 = 1.0 / (n2 - 1)
    b64, b32 = poisson_rhs(n2, "float64"), poisson_rhs(n2, "float32")
    for policy in (ExecutionPolicy.JNP, ExecutionPolicy.PALLAS):
        cfg_p = MGConfig(policy=policy)
        solve = lambda: mg_solve(b64.new_zeros(b64.shape), b64, h2, 0.0, tol, 20,  # noqa: E731
                                 cfg=cfg_p)
        name = f"mg_solve {policy.value} {n2}^2 float64"
        solve()
        built(name)
        g, tg = median_seconds(solve, reps=3)
        with loops.host_loops():
            hh, th = median_seconds(solve, reps=3)
        same_u(g, hh, name)
        walls.append((name, tg, th))
        if policy is ExecutionPolicy.PALLAS:
            both(solve, name, same_u, plain=True)
    solve = lambda: mg_solve_rp(b32.new_zeros(b32.shape), b32, h2, 0.0, 1e-5, 30)  # noqa: E731
    for plain in (False, True):
        both(solve, f"mg_solve_rp {n2}^2 float32", same_u, plain)
    g, hh = mixed
    n_mixed = g[0].shape[-1]
    same_u(g, hh, f"MG mixed {n_mixed}^2 (phase 10)")
    require(g[2] == 8, f"MG mixed {n_mixed}^2: {g[2]} outers, not 8")
    bm = poisson_rhs(n_mixed, "float64")
    both(lambda: mg_solve_mixed(bm.new_zeros(bm.shape), bm, 1.0 / (n_mixed - 1), 0.0, tol, 30),
         f"MG mixed {n_mixed}^2", same_u, plain=True)
    del bm, g, hh

    # the NS host loop: phase 13's 10 steps, and 3 through the plain versions
    def same_host(a, b_, what):
        require((a.steps, a.sim_time) == (b_.steps, b_.sim_time),
                f"{what}: {a.steps} steps, t {a.sim_time!r} vs host loops {b_.steps}, "
                f"{b_.sim_time!r}")
        for k in ("T", "W", "S"):
            require(np.array_equal(getattr(a, k), getattr(b_, k)), f"{what}: {k} differs")
        log(f"{what}: {a.steps} steps, bitwise equal to the host loops")

    for beta, ((g, glines), (hh, hlines)) in ns_ten.items():
        what = f"NS host loop beta={beta}, 10 steps"
        same_host(g, hh, what)
        gw, hw = ([s for s in lines if "NOT converged" in s] for lines in (glines, hlines))
        require(gw == hw, f"{what}: warnings {gw} vs the host loops' {hw}")
        log(f"{what}: {len(gw)} NOT-converged warnings, as the host loops print")
        walls.append((what, g.t_elapsed, hh.t_elapsed))
    cfg5 = host_cfg(0.5)
    simulate(cfg5, seed=0, max_steps=1, device=DEVICE)  # the step's graph, cached
    launched = loops.stats["launches"]
    with count_host_syncs() as n_syncs:
        simulate(cfg5, seed=0, max_steps=5, device=DEVICE)
    launched = loops.stats["launches"] - launched
    log(f"NS host loop 5 steps: {launched} graph launches, {n_syncs[0]} host syncs (a read "
        f"a step, the clock's 2, the fields' 3 = 10)")
    require(launched == 5 and n_syncs[0] == 10,
            f"NS host loop: {launched} graph launches and {n_syncs[0]} host syncs in 5 steps")
    with plain_kernels():
        g = simulate(cfg5, seed=0, max_steps=3, device=DEVICE)
        with loops.host_loops():
            hh = simulate(cfg5, seed=0, max_steps=3, device=DEVICE)
    same_host(g, hh, "NS host loop beta=0.5, 3 steps (plain versions)")


def phase_sharded_loops(smi, both, same_ns, same_solve, walls, b, mg_cfg):
    """Phase 22's sharded tiers on 4 shards of the one card: a solve, a chunk
    of NS steps or a physical step is one graph launch, held bitwise against
    the same work as host loops (``loops.host_loops()``); the graph
    launches and host syncs of one run are counted, a few runs go through
    the plain versions too.  The runs are short: the host loops take 4-18 %
    busy seconds.  both, same_ns, same_solve, walls: phase 22's; b: its MG
    rhs (4097^2) and mg_cfg its ladder."""
    import dataclasses

    import numpy as np
    import torch

    from fpr_tpu_torch.core import loops
    from fpr_tpu_torch.core.config import CoarseSolver, DiffusionConfig, ExecutionPolicy, MGConfig
    from fpr_tpu_torch.models.dist_ns import simulate_fast_sharded
    from fpr_tpu_torch.models.navier_stokes import simulate
    from fpr_tpu_torch.parallel import dist_diffusion
    from fpr_tpu_torch.solvers.dist_mg_ds import mg_solve_ds_sharded, mg_solve_ds_sharded_2d
    from fpr_tpu_torch.solvers.dist_multigrid import mg_solve_sharded

    t_phase = time.perf_counter()
    y4 = mesh_of((4,), ("y",))

    def check(what, run, same, launches, syncs, plain=False):
        """run() once (its graph built or cached), once with its graph launches
        and host syncs counted, then timed as a graph and as host loops
        and compared bitwise; with plain, again through the plain versions."""
        run()
        launched = loops.stats["launches"]
        with count_host_syncs() as n:
            run()
        launched = loops.stats["launches"] - launched
        g, tg = median_seconds(run, reps=1)
        with loops.host_loops():
            h, th = median_seconds(run, reps=1)
        same(g, h, what)
        walls.append((what, tg, th))
        log(f"{what}: {launched} graph launches and {n[0]} host syncs a run (expected "
            f"{launches} and {syncs}); graph {tg:.4f} s, host loops {th:.4f} s  [{smi}]")
        require(launched == launches and n[0] == syncs,
                f"{what}: {launched} graph launches and {n[0]} host syncs")
        if plain:
            both(run, what, same, plain=True)

    # 1. the ds MG over 4 row shards and over 2x2 (y, x), 4097^2; a cold
    # apply_bcs solve at 2049^2 with its NOT-converged warning
    h = 1.0 / (b.shape[0] - 1)
    sharded = lambda: mg_solve_ds_sharded(b, h, 0.0, 1e-6, 30, y4, cfg=mg_cfg)  # noqa: E731
    check("mg_solve_ds_sharded 4097^2, 4 row shards", sharded, same_solve(4), 1, 1, plain=True)
    check("mg_solve_ds_sharded_2d 4097^2, 2x2", lambda: mg_solve_ds_sharded_2d(
        b, h, 0.0, 1e-6, 30, mesh_of((2, 2), ("y", "x")), cfg=mg_cfg), same_solve(4), 1, 1)
    n2 = 2049
    b2 = poisson_rhs(n2, "float32")

    def same_warned(g, hh, what):
        ((gh, gl), gr, git), glines = g
        ((hh_, hl), hr, hit), hlines = hh
        require(git == hit and torch.equal(gh, hh_) and torch.equal(gl, hl)
                and torch.equal(gr, hr), f"{what}: {git} vs host loop {hit}, or fields differ")
        gw, hw = ([s for s in lines if "NOT converged" in s] for lines in (glines, hlines))
        require(len(gw) == 1 and gw == hw, f"{what}: warnings {gw} vs the host loops' {hw}")
        log(f"{what}: {git} outers, bitwise equal to the host loops, the same warning")

    check(f"mg_solve_ds_sharded {n2}^2 apply_bcs c=0", lambda: printed(
        lambda: mg_solve_ds_sharded(b2, 1.0 / (n2 - 1), 0.0, 1e-6, 20, y4,
                                    cfg=MGConfig(coarse_size=129, coarse_solver=CoarseSolver.DST),
                                    replicate_below=513, apply_bcs=True)), same_warned, 1, 1)
    del b2

    # 2. the NS fast loop on 4 row shards: 23 explicit steps in chunks of 5
    # (the warm-up, then 4 chunks: 1 + 4 + 1 host syncs), 5 semi-implicit
    ns = ns_cfg(0.0)
    check("NS explicit 4 row shards, 23 steps, chunk_steps=5", lambda: simulate_fast_sharded(
        ns, y4, max_steps=23, chunk_steps=5), same_ns, 5, 6, plain=True)
    check("NS semi 4 row shards, 5 steps", lambda: simulate_fast_sharded(
        ns_cfg(0.5), y4, max_steps=5), same_ns, 2, 3)

    # 3. part 1's physical step, each body, 128^3 in 4 physical steps capped
    # at 100 iterations each (K=3: 99): one launch and one read a step, the
    # clock's 2 syncs, a transfer a shard for the field
    def same_h(g, hh, what):
        require((g.iters_total, g.timed_iters, g.converged) ==
                (hh.iters_total, hh.timed_iters, hh.converged) and np.array_equal(g.H, hh.H),
                f"{what}: {g.iters_total} iterations vs host loop {hh.iters_total}, or H differs")
        log(f"{what}: {g.iters_total} iterations, H bitwise equal to the host loops")

    jnp_, pallas = ExecutionPolicy.JNP, ExecutionPolicy.PALLAS
    for what, dcfg, shape, axes, plain in (
            ("jnp 2x2 (z, y)", dict(nx=128, ny=64, nz=64, policy=jnp_), (2, 2), ("z", "y"),
             False),
            ("jnp overlap 4 z", dict(nx=128, ny=128, nz=32, policy=jnp_, overlap_comm=True),
             (4,), ("z",), False),
            ("pallas 2x2x2", dict(nx=64, ny=64, nz=64, policy=pallas), (2, 2, 2),
             ("z", "y", "x"), True),
            ("pallas overlap 4 z", dict(nx=128, ny=128, nz=32, policy=pallas, overlap_comm=True),
             (4,), ("z",), False),
            ("pallas K=3 4 z", dict(nx=128, ny=128, nz=32, policy=pallas, check_every=3,
                                    iter_max=99), (4,), ("z",), True)):
        dcfg = DiffusionConfig(**{"ttot": 0.8, "tol": 1e-6, "iter_max": 100, **dcfg})
        mesh = mesh_of(shape, axes)
        check(f"diffusion 128^3 {what}", lambda: dist_diffusion.solve_distributed(dcfg, mesh),
              same_h, 4, 4 + 2 + mesh.size, plain)

    # 4-5. the GSPMD tier, float64: one mg_solve_sharded solve, 2 steps of
    # simulate(mesh=) (a read a step, the end's sync, the fields' 3)
    b64 = poisson_rhs(n2, "float64")

    def same_u(g, hh, what):
        require(g[2] == hh[2] and torch.equal(g[0], hh[0]) and torch.equal(g[1], hh[1]),
                f"{what}: {g[2]} cycles vs host loops {hh[2]}, or fields differ")
        log(f"{what}: {g[2]} cycles, bitwise equal to the host loops")

    check(f"mg_solve_sharded {n2}^2 float64", lambda: mg_solve_sharded(
        b64.new_zeros(b64.shape), b64, 1.0 / (n2 - 1), 0.0, 1e-6, 30, y4), same_u, 1, 1)
    del b64

    def same_host(a, b_, what):
        (a, alines), (b_, blines) = a, b_
        require((a.steps, a.sim_time) == (b_.steps, b_.sim_time),
                f"{what}: {a.steps} steps, t {a.sim_time!r} vs host loops {b_.steps}, "
                f"{b_.sim_time!r}")
        for k in ("T", "W", "S"):
            require(np.array_equal(getattr(a, k), getattr(b_, k)), f"{what}: {k} differs")
        require(alines == blines, f"{what}: its lines {alines} vs the host loops' {blines}")
        log(f"{what}: {a.steps} steps, bitwise equal to the host loops, the same "
            f"{sum('NOT converged' in s for s in alines)} warnings")

    gspmd = dataclasses.replace(host_cfg(0.5), mg_solver="direct", ttot=1.0)
    check("simulate(mesh=) 2 steps", lambda: printed(lambda: simulate(
        gspmd, seed=0, max_steps=2, mesh=y4)), same_host, 2, 6)
    log(f"the sharded tiers: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    # the run uses one card: make it the only one visible, so that the device
    # count in the last line is the number of cards the run used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    try:
        import fpr_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"chip_smoke: the fpr_tpu_torch package is missing ({exc})")
        return 3
    if sys.argv[1:] == [LAUNCH_COUNTS]:
        print(json.dumps(launch_counts()))
        return 0
    try:
        smi = phase_env()
        phase_build()
        kc = KernelCheck()
        phase_kernels(kc)
        mg_it, mg_u = phase_mg()
        ns_counts, explicit = phase_ns_explicit()
        semi = phase_ns_semi()
        launches = {k: ns_counts[k] for k in NS_KERNELS}
        launches["ns_fused_helm"] = phase_helm_warm_start(semi)["ns_fused_helm"]
        bench_counts, out_512 = phase_diffusion_bench()
        launches["dual_timek"] = bench_counts["dual_timek"]
        f32_counts, out_128 = phase_diffusion_f32()
        launches["dual_time"] = f32_counts["dual_time"]
        launches["ds3d"] = phase_diffusion_ds()["ds3d"]
        _, mixed = phase_mg_mixed(smi)
        launches["stencil"] = phase_pallas_f64()["stencil"]
        phase_krylov_ds()
        host_counts, _, ns_ten = phase_ns_host(smi)
        for k in ("smooth2r_split", "corr_smooth2"):
            launches[k] = host_counts[k]
        launches["dual_timek_padded"] = phase_dist_diffusion(smi, out_512, out_128)[
            "dual_timek_padded"]
        del out_512
        phase_dist_mg(smi, mg_it, mg_u)
        phase_dist_ns(smi, semi)
        phase_dist_mg_2d(smi, mg_it, mg_u)
        phase_gspmd(smi)
        phase_bench(smi)
        phase_checkpoints()
        phase_experiments()
        phase_device_loops(smi, explicit, semi, mixed, ns_ten)
        phase_oracles_and_entry_points()
        phase_16385(smi)
    except Failed as exc:
        log(f"chip_smoke FAILED: {exc}")
        # the check that failed on the standard error too, where a caller
        # that keeps only that stream's end finds it
        print(f"chip_smoke FAILED after {time.perf_counter() - T0:.0f} s: {exc}",
              file=sys.stderr, flush=True)
        return 1
    log(f"chip_smoke: 24 phases passed in {time.perf_counter() - T0:.0f} s")
    table = []
    for k, (source, replaces) in SOURCES.items():
        row = kc.rows[k]
        bound_ms, bound_by = kc.bound(k)
        table.append(dict(name=k, route="cuda", source=source, replaces=replaces,
                          launches=launches[k], max_abs_err=row["max_abs_err"],
                          ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=row["library_ms"]))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
