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
whichever kernel the tree runs it with, call ms and the plain version's
call ms), and that solve's
timed window in seconds.  ``legs_4097`` holds the V-cycle legs at the MG
row's finest level, 4097^2 with ns=5: the down leg from a zero iterate
and the up leg with its norm, device µs over the legs' kernels of either
tree (the per-sweep kernels or the one-launch leg kernel), call ms and
the bound.  ``calls`` holds one public call of K1 (``defect_pass``: the NS
S solve's flags at 513x2049, and the MG row's at 4097^2) and of K4
(``ns_fused_rp`` at 513x2049: explicit with_defect, rhs at beta 0.5 with
with_sumsq, rhs with_helm_defect): the device µs of every kernel the call
launches (``all_us``) and of the K1/K4 kernel alone (``kernel_us``), the
launches a call, and the call's µs from CUDA events.  Run it once per tree
in a fresh process, in turns (parent, change, change, parent), since two
packages of one name cannot share a process.
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
                      "legs_4097": legs_4097(chip_smoke), "calls": calls(chip_smoke)}))
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
    plain = lambda: dual_time.dual_time_stepk_plain(Ht, Hs, K, dual_time.coeffs(**kw))  # noqa
    cfg = DiffusionConfig(nx=128, ny=128, nz=128, ttot=2.0, tol=1e-6,
                          policy=ExecutionPolicy.PALLAS, check_every=K)
    diffusion3d.solve(cfg, device="cuda")  # warm-up
    run = diffusion3d.solve(cfg, device="cuda")
    return {"dual_timek_128": {"device_us": chip_smoke.device_us(call, ["dual_time"]),
                               "ms": chip_smoke.time_ms(call),
                               "plain_ms": chip_smoke.time_ms(plain),
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


def calls(chip_smoke, reps=20) -> dict:
    """Public K1 and K4 calls: every kernel of a call from torch.profiler,
    through the entry points that both trees have."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fpr_tpu_torch.ops import ds, ns_fused

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(6)

    def rand(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)

    def measure(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA"]
        mine = [ev for ev in evs if "defect_kernel" in ev.key or "ns_kernel" in ev.key]
        return {"all_us": sum(ev.device_time_total for ev in evs) / reps,
                "kernel_us": (sum(ev.device_time_total for ev in mine)
                              / max(sum(ev.count for ev in mine), 1)),
                "launches": sum(ev.count for ev in evs) / reps,
                "call_us": chip_smoke.time_ms(fn) * 1e3}

    ny, nx, n = 513, 2049, 4097
    h, h4 = 1.0 / (ny - 1), 1.0 / (n - 1)
    u64 = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float64, device=dev)
    u = torch.stack([u64.float(), (u64 - u64.float().double()).float()])
    f, e = rand(1, ny, nx), rand(ny, nx, scale=1e-3)
    C = ds.defect_scalars(0.0, h, dev)
    u4 = torch.zeros((2, n, n), dtype=torch.float32, device=dev)
    f4, e4 = rand(1, n, n), rand(n, n, scale=1e-3)
    C4 = ds.defect_scalars(0.0, h4, dev)
    TW = torch.stack([rand(ny, nx, scale=0.3) + 0.5, rand(ny, nx, scale=10.0)])
    S = torch.stack([rand(ny, nx, scale=0.1), rand(ny, nx, scale=1e-9)])
    dt = torch.tensor(1.9e-6, dtype=torch.float32, device=dev)
    cT = torch.tensor(1.0, dtype=torch.float32, device=dev) / (0.5 * dt)
    cW = cT / torch.tensor(0.01, dtype=torch.float32, device=dev)
    rhs = dict(beta=0.5, mode="rhs", cT=cT, cW=cW)
    return {
        "defect_pass": measure(lambda: ds.defect_pass(u, f, e, 1.0, h, 0.0, C=C,
                                                      velocity_max=True)),
        "defect_pass_4097": measure(lambda: ds.defect_pass(u4, f4, e4, 1.0, h4, 0.0, C=C4)),
        "ns_fused_rp_explicit": measure(lambda: ns_fused.ns_fused_rp(
            TW, S, dt, h, 0.01, 1e6, mode="explicit", with_defect=True)),
        "ns_fused_rp_rhs": measure(lambda: ns_fused.ns_fused_rp(
            TW, S[0], dt, h, 0.01, 1e6, with_sumsq=True, **rhs)),
        "ns_fused_rp_helm": measure(lambda: ns_fused.ns_fused_rp(
            TW, S[0], dt, h, 0.01, 1e6, with_helm_defect=True, **rhs)),
    }


if __name__ == "__main__":
    sys.exit(main())
