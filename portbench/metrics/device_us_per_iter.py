"""device_us_per_iter.<part>: the card's busy microseconds over the window's
pseudo-time iterations."""


def read(ctx, part):
    busy, iters = ctx.get("busy_s"), sum(u.get("iters", 0) for u in ctx["units"])
    return 1e6 * busy / iters if busy and iters else None
