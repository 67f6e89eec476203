"""s_outers_per_step.<part>: outer iterations of the stream-function solve
(``loops.passes["ns.S.outer"]``, counted on the card) over the window's
physical steps.  Reads ``ctx["trace"]``; None without it."""


def read(ctx, part):
    t, steps = ctx.get("trace"), sum(u["steps"] for u in ctx["units"])
    n = t["passes"].get("ns.S.outer", 0) if t else 0
    return n / steps if steps and n else None
