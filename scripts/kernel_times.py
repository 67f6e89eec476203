"""Phase 3 of a tree's ``chip_smoke.py`` alone: its kernels' device and call
times, to compare two trees of the repo on one card in one call.

    python scripts/kernel_times.py ROOT

ROOT is the root of a checkout (``.`` for this one, or an unpacked
``git archive`` of another commit).  The script imports ROOT's
``chip_smoke.py`` and, through it, ROOT's ``fpr_tpu_torch``, builds its
kernels into ROOT's build directory, runs the environment, build and
kernel-check phases, and prints as its last line one JSON object
``{"root": ROOT, "kernels": {name: {"device_us", "ms", "plain_ms",
"bound_ms"}}}``.  Run it once per tree in a fresh process, in turns
(parent, change, change, parent), since two packages of one name cannot
share a process.
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
    print(json.dumps({"root": root, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
