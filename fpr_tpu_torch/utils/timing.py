"""The counted-operation performance model of part 1
(fpr_tpu/utils/timing.py: BenchResults, MEMORY_MODEL_WORDS, FLOPS_PER_CELL,
diffusion_bench_results).

Work and memory traffic are counted from the stencil, not measured, so
the effective throughput T_eff = memory / time compares across machines:
27 flops per interior cell and iteration (25 for the step, 2 for the
norm), and per cell and iteration (14+1) words for the reference's plain
kernel, (6+1) for its shared-memory kernel and (3+1) for a fused kernel
(read Ht and Htau, write Htau', plus one for the norm).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BenchResults:
    delta_t: float          # seconds of timed compute (warm-up excluded)
    work: float             # flops
    performance: float      # flop/s
    memory: float           # bytes
    intensity: float        # flop/byte
    throughput: float       # bytes/s (T_eff)

    def row(self) -> dict:
        return dataclasses.asdict(self)


# words moved per interior cell per iteration, by counting model
MEMORY_MODEL_WORDS = {
    "plain": 14 + 1,     # reference kernel without shared memory
    "shmem": 6 + 1,      # reference shared-memory kernel
    "fused": 3 + 1,      # fused kernel: read Ht, read Htau, write Htau'
}

FLOPS_PER_CELL = 25 + 2  # stencil + norm contribution


def diffusion_bench_results(delta_t: float, iters_total: int, nx: int, ny: int, nz: int,
                            word_bytes: int, model: str = "fused",
                            n_devices: int = 1) -> BenchResults:
    """Counted results over the interior cells of all devices
    (timing.diffusion_bench_results)."""
    cells = (nx - 2) * (ny - 2) * (nz - 2)
    work = n_devices * iters_total * FLOPS_PER_CELL * cells
    memory = n_devices * iters_total * MEMORY_MODEL_WORDS[model] * word_bytes * cells
    delta_t = max(delta_t, 1e-12)
    return BenchResults(delta_t=delta_t, work=work, performance=work / delta_t,
                        memory=memory, intensity=work / memory,
                        throughput=memory / delta_t)
