"""Phase 3 of a tree's ``chip_smoke.py`` alone: its kernels' device and call
times, to compare two trees of the repo on one card in one call.

    python scripts/kernel_times.py ROOT

ROOT is the root of a checkout (``.`` for this one, or an unpacked
``git archive`` of another commit).  The script imports ROOT's
``chip_smoke.py`` and, through it, ROOT's ``fpr_tpu_torch``, builds its
kernels into ROOT's build directory, runs the environment, build and
kernel-check phases, and prints as its last line one JSON object
``{"root": ROOT, "kernels": {name: {"device_us", "ms", "plain_ms",
"bound_ms"}}, "small": {...}, "legs_4097": {...}}``.  ``small`` holds
part 1's K-sweep call at 128^3, K=3, the call of phase 8's check_every=3
solve (device µs over every kernel whose name starts with ``dual_time``,
whichever kernel the tree runs it with, and call ms), and that solve's
timed window in seconds.  ``legs_4097`` holds the V-cycle legs at the MG
row's finest level, 4097^2 with ns=5: the down leg from a zero iterate
and the up leg with its norm, device µs over the legs' kernels of either
tree (the per-sweep kernels or the one-launch leg kernel), call ms and
the bound.  Run it once per tree in a fresh process, in turns (parent,
change, change, parent), since two packages of one name cannot share a
process.
"""

import json
import os
import sys


def main() -> int:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    chip_smoke.phase_env()
    chip_smoke.phase_build()
    kc = chip_smoke.KernelCheck()
    chip_smoke.phase_kernels(kc)
    out = {name: {"device_us": row["device_us"], "ms": row["ms"], "plain_ms": row["plain_ms"],
                  "bound_ms": kc.bound(name)[0]}
           for name, row in kc.rows.items()}
    print(json.dumps({"root": root, "kernels": out, "small": small_field(chip_smoke),
                      "legs_4097": legs_4097(chip_smoke)}))
    return 0


def small_field(chip_smoke) -> dict:
    """The K-sweep call at 128^3, K=3, through the public wrapper, and the
    128^3 check_every=3 solve of phase 8 (its timed window)."""
    import numpy as np
    import torch

    from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
    from fpr_tpu_torch.models import diffusion3d
    from fpr_tpu_torch.ops import dual_time

    shape, K = (128, 128, 128), 3
    cells = int(np.prod(shape))
    rng = np.random.default_rng(2)
    Ht, Hs = (torch.tensor(rng.random(shape, dtype=np.float32), device="cuda") for _ in range(2))
    kw = chip_smoke.diffusion_kw(shape)
    call = lambda: dual_time.dual_time_stepk(Ht, Hs, K, **kw)  # noqa: E731
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=2.0, tol=1e-6,
                          policy=ExecutionPolicy.PALLAS, check_every=K)
    diffusion3d.solve(cfg, device="cuda")  # warm-up
    run = diffusion3d.solve(cfg, device="cuda")
    return {"dual_timek_128": {"device_us": chip_smoke.device_us(call, ["dual_time"]),
                               "ms": chip_smoke.time_ms(call),
                               "bound_ms": chip_smoke.bound_of(12 * cells, K * 27 * cells)[0]},
            "solve_128_k3": {"iters_total": run.iters_total,
                             "timed_window_s": run.bench.delta_t}}


def legs_4097(chip_smoke, n=4097, ns=5) -> dict:
    """K2 from a zero iterate and K3 with its norm at n^2, ns sweeps, through
    the CUDA wrappers that both trees have."""
    import numpy as np
    import torch

    from fpr_tpu_torch.ops import transfer, vcycle_legs

    rng = np.random.default_rng(5)
    f, u = (torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32, device="cuda")
            for _ in range(2))
    coarse = torch.tensor(rng.standard_normal(((n + 1) // 2, (n + 1) // 2)) * 1e-2,
                          dtype=torch.float32, device="cuda")
    corrx = transfer.x_interleave_coarse(coarse)
    c = torch.zeros((), device="cuda")
    h = 1.0 / (n - 1)
    names = ["sweep_kernel", "residual_kernel", "leg_kernel"]
    calls = {"smooth_down": (lambda: vcycle_legs._smooth_down_cuda(None, f, h, c, 0.8, ns),
                             3 * 4 * n * n),
             "corr_up": (lambda: vcycle_legs._corr_up_cuda(u, f, corrx, h, c, 0.8, ns, False,
                                                           True),
                         3 * 4 * n * n + 4 * corrx.numel())}
    return {name: {"device_us": chip_smoke.device_us(fn, names), "ms": chip_smoke.time_ms(fn),
                   "bound_ms": chip_smoke.bound_of(nbytes, 0)[0]}
            for name, (fn, nbytes) in calls.items()}


if __name__ == "__main__":
    sys.exit(main())
