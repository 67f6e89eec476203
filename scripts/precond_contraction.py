"""The float32 V-cycle preconditioner of ``mg_pcg_ds`` against the float64
V-cycle, by grid size: ``chip_smoke.py`` phase 24's measurement.

    python scripts/precond_contraction.py [--device cpu|cuda] K [K ...]

For each 2^K + 1 grid, one V-cycle from zero on the MG rows' rhs (DST-513,
V(5,5)): ``vcycle_stk`` in float32 (the legs' kernels on CUDA, their plain
versions on the CPU) and ``vcycle`` in float64.  Prints rms(z32 - z64) /
rms(z64) and each one's contraction rms(A z - r) / rms(r) in float64.
On the CPU, K = 10-12 are the readings that PERF.md's prediction for
16385^2 was extrapolated from.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("k", type=int, nargs="+")
    args = ap.parse_args(argv)
    from fpr_tpu_torch.core.config import CoarseSolver, MGConfig

    chip_smoke.DEVICE = args.device
    cfg = MGConfig(coarse_size=513, coarse_solver=CoarseSolver.DST, pre_smooth=5,
                   post_smooth=5)
    for k in args.k:
        chip_smoke.phase_16385_precond(2**k + 1, cfg, 1e-6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
