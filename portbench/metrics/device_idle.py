"""device_idle.<part>: the share of the window in which no bracketed graph
launch ran on the card, 100 (1 - busy_s / window_s), busy_s from CUDA events
around each launch (portbench/busy.py)."""


def read(ctx, part):
    busy = ctx.get("busy_s")
    return 100.0 * (1.0 - busy / ctx["window_s"]) if busy else None
