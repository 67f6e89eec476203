"""The entry of the diffusion traffic: ``diffusion3d.solve`` runs back to back.

A unit is one whole solve, as a user of part 1 runs it: the entry builds the
Gaussian field, runs every physical step (one graph launch and one host read
a step) and copies the final field to the host.  The inputs are the
configuration's (the reference's Gaussian), the same in every unit and for
every seed; the seed draws which units are checked.  Set-up runs one whole
solve, which builds the one graph that every physical step launches.

After the window the plain float64 reference (exact, in the sine basis) runs
once, and each checked unit's final field (interior, max |difference| over
max |reference|), its total count of pseudo-time iterations and whether
every step converged are compared with it.
"""

from __future__ import annotations

import time

import torch

from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.models import diffusion3d as d3

from portbench.reference.diffusion3d import DualTime, field_error, outer_steps

# the control's cap on a step, in multiples of the reference's largest count
CONTROL_CAP = 3
CFG_KEYS = ("nx", "ny", "nz", "D", "lx", "ly", "lz", "ttot", "dt", "tol", "iter_max",
            "check_every")


class Job:
    def __init__(self, p: dict, traffic: dict, seed: int, device):
        self.p, self.traffic, self.device = p, traffic, torch.device(device)
        self.cfg = DiffusionConfig(**{k: p[k] for k in CFG_KEYS if k in p},
                                   policy=ExecutionPolicy(p["policy"]))
        self.nt = outer_steps(self.cfg.ttot, self.cfg.dt)
        self.ref = None
        d3.solve(self.cfg, device=self.device)

    def unit(self) -> dict:
        t0 = time.perf_counter()
        r = d3.solve(self.cfg, device=self.device)
        return {"steps": self.nt, "iters": r.iters_total, "wall": time.perf_counter() - t0,
                "answer": (r.H, r.iters_total, r.converged)}

    def stretch(self):
        """A short stretch of the cell's own path: the first physical step
        of a solve (the entry with ttot = dt), as a function the caller runs
        (under host loops)."""
        import dataclasses

        cfg = dataclasses.replace(self.cfg, ttot=self.cfg.dt)

        def run():
            d3.solve(cfg, device=self.device)
        return run

    # -- the comparison -----------------------------------------------------

    def reference(self) -> dict:
        if self.ref is None:
            self.ref = DualTime(self.p, device=self.device).solve()
        return self.ref

    @staticmethod
    def readings(answer, ref: dict) -> dict:
        H, iters, converged = answer
        return {"H_err": field_error(H, ref["H"]), "iters_off": float(abs(iters - ref["iters"])),
                "converged_off": float(bool(converged) != bool(ref["converged"]))}

    def check(self, units: list) -> list:
        ref = self.reference()
        return [self.readings(u["answer"], ref) for u in units]

    def control(self) -> dict:
        """The readings of the iteration computed in float32 with the field
        rounded to bfloat16 after every iteration, put in the program's
        place.  Each of its steps stops at CONTROL_CAP times the reference's
        largest count of a step (or the configuration's cap): a control that
        has not converged by then reads its count there."""
        ref = self.reference()
        cap = min(self.cfg.iter_max, CONTROL_CAP * max(ref["steps"]))
        c = DualTime(self.p, device=self.device).iterate_solve(
            torch.float32, torch.bfloat16, iter_max=cap)
        return self.readings((c["H"], c["iters"], c["converged"]), ref)
