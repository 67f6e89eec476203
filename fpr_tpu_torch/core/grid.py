"""Multigrid level ladder (fpr_tpu/core/grid.py::mg_levels)."""

from __future__ import annotations


def mg_levels(nx: int, ny: int, coarse_size: int) -> list[tuple[int, int]]:
    """Level shapes (fine -> coarse) of a V-cycle (fpr_tpu.core.grid.mg_levels)."""
    if coarse_size < 2 or (coarse_size - 1) & (coarse_size - 2):
        raise ValueError(f"coarse_size must be 2^l + 1, got {coarse_size}")
    levels = [(nx, ny)]
    cx, cy = nx, ny
    while min(cx, cy) > coarse_size:
        if (cx - 1) % 2 or (cy - 1) % 2:
            raise ValueError(f"grid {cx}x{cy} not coarsenable: sides must be 2^k+1")
        cx, cy = (cx - 1) // 2 + 1, (cy - 1) // 2 + 1
        levels.append((cx, cy))
    return levels
