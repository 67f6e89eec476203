"""entry_host_ms_per_step.<part>: the card's milliseconds inside the entry's
own spans (those directly inside ``diffusion.solve`` or ``ns.simulate``:
the fields' set-up, the host's reads, the copies out) that no graph launch
covered, over the window's physical steps.  Reads ``ctx["trace"]``; None
without it."""

ENTRIES = ("diffusion.solve", "ns.simulate")


def read(ctx, part):
    t, steps = ctx.get("trace"), sum(u["steps"] for u in ctx["units"])
    if not t or not steps:
        return None
    spans = [r for name, r in t["spans"].items()
             if not name.startswith("graph:") and set(r["parents"]) & set(ENTRIES)]
    return 1e3 * sum(r["uncovered_s"] for r in spans) / steps if spans else None
