"""kernel_launches_per_step.<part>: launches of the program's own kernels in
the window (the change in kernels.sync_launches(), every pass of a graph's
loops counted on the device; torch's own operations are not counted) over
the window's physical steps."""

from portbench.breakdown import counted


def read(ctx, part):
    steps, n = sum(u["steps"] for u in ctx["units"]), counted(ctx["launches"])
    return n / steps if steps and n else None
