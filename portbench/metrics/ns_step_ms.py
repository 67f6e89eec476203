"""ns_step_ms: the window's host-clock milliseconds over the physical steps of
the whole simulations in it, warm-up steps included (each simulation's field
set-up, steps and final copies lie inside the window)."""


def read(ctx, part):
    steps = sum(u["steps"] for u in ctx["units"])
    return 1e3 * ctx["window_s"] / steps if steps else None
