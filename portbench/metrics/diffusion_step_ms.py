"""diffusion_step_ms: the window's host-clock milliseconds over the physical
steps (solved or capped) of the whole solves in it."""


def read(ctx, part):
    steps = sum(u["steps"] for u in ctx["units"])
    return 1e3 * ctx["window_s"] / steps if steps else None
