"""The device operations of a traced run's breakdown.

The profiler sees almost no kernel inside a CUDA graph's conditional node,
so it takes no part in any metric.  For the breakdown alone, a short stretch
of the cell's own path is run again after the window under
``loops.host_loops()`` (the same kernels on the same data, launched one by
one) and the profiler, and its operations with the most device time are
listed as coming from that host-loop re-run.  The profiler's count of the
program's own kernels is held to the change in ``kernels.sync_launches()``
over the stretch; where they disagree, or the profiler saw no device time,
there is no list.
"""

from __future__ import annotations

# the __global__ functions of fpr_tpu_torch/csrc (graph_loop.cu's set
# kernel is no counted launch)
PORT_KERNELS = ("defect_kernel", "ds3d_kernel", "dual_time_kernel", "dual_timek_kernel",
                "leg_kernel", "ns_kernel", "stencil_kernel")
LABEL = "host-loop re-run: "


def counted(launches: dict) -> int:
    """The kernel launches in ``kernels.launches``: ``stencil_<mode>`` counts
    again the calls that ``stencil`` counts, so it is left out."""
    return sum(v for k, v in launches.items() if not k.startswith("stencil_"))


def host_loop_ops(stretch, device, most: int = 10):
    """([[name, seconds], ...] of the stretch's device operations, largest
    first, or None, and a line that says how they were read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fpr_tpu_torch import kernels
    from fpr_tpu_torch.core import loops

    torch.cuda.synchronize(device)
    with loops.host_loops():
        before = counted(kernels.sync_launches())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stretch()
            torch.cuda.synchronize(device)
        launched = counted(kernels.sync_launches()) - before
    seconds, port = {}, 0
    for e in prof.key_averages():
        if getattr(e.device_type, "name", "") != "CUDA":
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0:
            seconds[e.key] = seconds.get(e.key, 0.0) + t / 1e6
        if any(k in e.key for k in PORT_KERNELS):
            port += e.count
    if not seconds:
        return None, "the profiler saw no device time in the host-loop re-run"
    if port != launched:
        return None, (f"the profiler counted {port} of the program's kernels, "
                      f"kernels.sync_launches() {launched}: no device_ops")
    ops = sorted(([LABEL + k[:120], v] for k, v in seconds.items()), key=lambda r: -r[1])
    return ops[:most], f"host-loop re-run: {launched} kernels of the program, profiler agrees"
