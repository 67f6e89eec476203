"""Multigrid level ladder and the 2D and 3D grids
(fpr_tpu/core/grid.py: is_mg_grid, mg_levels, Grid2D, Grid3D,
pseudo_timestep, outer_steps)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def is_mg_grid(n: int) -> bool:
    """True if n = lambda 2^k + 1 for integers lambda, k >= 1: n - 1 is
    even (grid.is_mg_grid)."""
    return n >= 3 and (n - 1) % 2 == 0


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


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Uniform cell-vertex 2D grid on [0, width] x [0, 1] with spacing h
    (fpr_tpu.core.grid.Grid2D); fields are (ny, nx), x last."""

    nx: int
    ny: int
    h: float

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def n(self) -> int:
        return self.nx * self.ny


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Uniform cell-centred 3D grid (fpr_tpu.core.grid.Grid3D): cell i sits
    at (i + 1/2) d; fields are (nz, ny, nx), x last."""

    nx: int
    ny: int
    nz: int
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def dz(self) -> float:
        return self.lz / self.nz

    @property
    def n(self) -> int:
        return self.nx * self.ny * self.nz

    def coords1d(self, axis: str) -> np.ndarray:
        """Cell-centre coordinates along 'x', 'y' or 'z'."""
        n = {"x": self.nx, "y": self.ny, "z": self.nz}[axis]
        length = {"x": self.lx, "y": self.ly, "z": self.lz}[axis]
        return (np.arange(n) + 0.5) * (length / n)


def pseudo_timestep(dx: float, dy: float, dz: float, D: float) -> float:
    """dtau = min(d)^2 / D / 8.1 (grid.pseudo_timestep)."""
    return min(dx, dy, dz) ** 2 / D / 8.1


def outer_steps(ttot: float, dt: float) -> int:
    """Physical steps of t in 0:dt:ttot-dt (grid.outer_steps)."""
    return max(0, math.floor((ttot - dt) / dt + 1e-12) + 1)
