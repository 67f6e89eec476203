"""graph_nodes_per_step.<part>: the graph nodes the card ran in the window
(the change in ``loops.nodes_run``: each loop body's own nodes times its
passes, and each graph's top-level nodes times its launches) over the
window's physical steps.  Reads ``ctx["trace"]``, which a window with the
program's tracer on carries (``portbench/traced.py``); None without it."""


def read(ctx, part):
    t, steps = ctx.get("trace"), sum(u["steps"] for u in ctx["units"])
    if not t or not steps:
        return None
    n = sum(t["nodes_run"].values())
    return n / steps if n else None
