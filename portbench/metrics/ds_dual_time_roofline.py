"""ds_dual_time_roofline: the least time the card's memory needs for the
window's double-single iterations (portbench/roofline/ds_dual_time_interval.py,
at the HBM bandwidth of portbench/peaks.json) over the card's busy time in
the window, in %.  The busy time holds every operation of the graph
launches (kernels, loop tests, copies), so this is at most the kernel's own
share."""

from portbench.roofline.ds_dual_time_interval import iteration_bytes


def read(ctx, part):
    busy = ctx.get("busy_s")
    card = ctx["peaks"]["cards"].get(ctx["kind"])
    if not busy or card is None:
        return None
    total = iteration_bytes(ctx["params"]) * sum(u["iters"] for u in ctx["units"])
    return 100.0 * total / float(card["hbm_bytes_per_s"]) / busy if total else None
