"""The entry of the Navier-Stokes traffic: ``simulate_fast`` runs back to back.

A unit is one whole simulation from (T0, W0) to ttot, as a user of part 2
runs it: the fields handed to the entry, its warm-up steps, its steps and the
copies of its final fields to the host.  W0 is one of ``fields`` fields
uniform in [0, 1), drawn from the seed on the card with a ``torch.Generator``
in set-up and handed to the entry as the host arrays it takes; T0 is the
cosine profile.  Set-up runs the entry for a few steps, which builds the one
graph that every simulation launches.

After the window the plain float64 reference runs once for each field that
the checked units used, and each checked unit's final T, W and S (interior,
max |difference| over max |reference|), its step count and its simulated
time are compared with it.
"""

from __future__ import annotations

import time

import torch

from fpr_tpu_torch.core.config import NSConfig
from fpr_tpu_torch.models import navier_stokes as ns

from portbench.common import finite, rel_max
from portbench.reference.ns2d import Convection, cosine_init

NS_KEYS = ("nx", "ny", "Ra", "Pr", "k", "beta", "tol", "ttot", "niters", "a_dif", "a_adv",
           "s_tol_factor")


class Job:
    def __init__(self, p: dict, traffic: dict, seed: int, device):
        self.p, self.traffic, self.device = p, traffic, torch.device(device)
        self.cfg = NSConfig(**{k: p[k] for k in NS_KEYS if k in p})
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.fields = torch.rand((int(traffic["fields"]), p["ny"], p["nx"]), generator=g,
                                 device=self.device, dtype=torch.float64).cpu().numpy()
        self.T0 = cosine_init(p)
        self.count = 0
        ns.simulate_fast(self.cfg, W0=self.fields[0], T0=self.T0, max_steps=5,
                         device=self.device)

    def unit(self) -> dict:
        field = self.count % len(self.fields)
        self.count += 1
        t0 = time.perf_counter()
        r = ns.simulate_fast(self.cfg, W0=self.fields[field], T0=self.T0, device=self.device)
        return {"field": field, "steps": r.steps, "wall": time.perf_counter() - t0,
                "answer": (r.T, r.W, r.S, r.steps, r.sim_time)}

    def stretch(self):
        """A short stretch of the cell's own path from a state a simulation
        reaches: steps ``from``+1 .. ``from``+``steps`` of field 0, as a
        function the caller runs (under host loops)."""
        n0, n = int(self.traffic["stretch"]["from"]), int(self.traffic["stretch"]["steps"])
        state = ns.simulate_fast(self.cfg, W0=self.fields[0], T0=self.T0, max_steps=n0,
                                 device=self.device).state

        def run():
            ns.simulate_fast(self.cfg, state0=state, max_steps=n0 + n, device=self.device)
        return run

    # -- the comparison -----------------------------------------------------

    def reference(self, field: int, dtype=torch.float64, store_dtype=None) -> dict:
        """The plain reference's answer from field ``field`` (the control: a
        lower dtype with store_dtype), with the states one step before and
        after its last."""
        ref = Convection(self.p, device=self.device, dtype=dtype, store_dtype=store_dtype)
        return ref.run(self.fields[field], self.T0, neighbours=True)

    def matched(self, steps: int, ref: dict) -> dict:
        """The reference state a run of ``steps`` steps is held to: the last,
        or its neighbour where the run stopped one step earlier or later and
        the reference's time at that boundary step lies within ``time_knife``
        of ttot (both stop rules are then right to the precision the
        ``time_knife`` allows)."""
        ttot = float(self.p["ttot"])
        knife = float(self.traffic["time_knife"]) * ttot
        prev, nxt = ref["prev"], ref["next"]
        if steps == prev["steps"] and ttot - prev["sim_time"] <= knife:
            return prev
        if steps == nxt["steps"] and ref["sim_time"] - ttot <= knife:
            return nxt
        return ref

    def readings(self, answer, ref: dict) -> dict:
        """The traffic's compared numbers of one answer."""
        T, W, S, steps, sim_time = answer
        r = {"T_err": rel_max(T, ref["T"]), "W_err": rel_max(W, ref["W"]),
             "S_err": rel_max(S, ref["S"]), "steps_off": float(abs(steps - ref["steps"])),
             "time_err": finite(abs(sim_time - ref["sim_time"]) / ref["sim_time"])}
        return {k: v for k, v in r.items() if k in self.traffic["limits"]}

    def check(self, units: list) -> list:
        """The readings of each unit in ``units`` against the reference."""
        refs, out = {}, []
        for u in units:
            if u["field"] not in refs:
                refs[u["field"]] = self.reference(u["field"])
            out.append(self.readings(u["answer"], self.matched(u["steps"], refs[u["field"]])))
        return out

    def control(self) -> dict:
        """The readings of the reference from the first field, computed in
        float32 with the state rounded to bfloat16 after every step, put in
        the program's place."""
        base = self.reference(0)
        c = self.reference(0, torch.float32, torch.bfloat16)
        answer = (c["T"], c["W"], c["S"], c["steps"], c["sim_time"])
        return self.readings(answer, self.matched(c["steps"], base))
