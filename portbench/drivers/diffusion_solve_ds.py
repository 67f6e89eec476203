"""The entry of the double-single diffusion traffic: ``diffusion3d.solve`` on
the ds tier (``ExecutionPolicy.PALLAS_DS``) runs back to back.

Units, set-up and the comparison are ``diffusion_solve``'s.  The control
sits one precision below the configuration's double-single: the plain
iteration in float32 with its state stored in float32, so a program that
silently ran its ds route in plain float32 reads as the control does.  Each
of its steps stops at ``CONTROL_CAP`` times the reference's largest count
of a step (or the configuration's cap).
"""

from __future__ import annotations

import torch

from portbench.drivers import diffusion_solve
from portbench.drivers.diffusion_solve import CONTROL_CAP
from portbench.reference.diffusion3d import DualTime


class Job(diffusion_solve.Job):
    def control(self) -> dict:
        ref = self.reference()
        cap = min(self.cfg.iter_max, CONTROL_CAP * max(ref["steps"]))
        c = DualTime(self.p, device=self.device).iterate_solve(
            torch.float32, torch.float32, iter_max=cap)
        return self.readings((c["H"], c["iters"], c["converged"]), ref)
