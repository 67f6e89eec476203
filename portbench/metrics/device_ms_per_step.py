"""device_ms_per_step.<part>: the card's busy milliseconds over the window's
physical steps; it includes the gaps between a graph's nodes."""


def read(ctx, part):
    busy, steps = ctx.get("busy_s"), sum(u["steps"] for u in ctx["units"])
    return 1e3 * busy / steps if busy and steps else None
