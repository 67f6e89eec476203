"""Boundary conditions on (ny, nx) and (nz, ny, nx) tensors (fpr_tpu/core/bc.py).

Out of place, as in the JAX package: each function returns a new tensor.
Rows 0 / ny-1 are the bottom / top edges, columns 0 / nx-1 the sides.
"""

from __future__ import annotations

import torch


def dirichlet_top_bottom(T: torch.Tensor, bottom: float = 1.0, top: float = 0.0):
    """T = bottom on row 0, top on row ny-1 (bc.dirichlet_top_bottom).  By
    fills, which a CUDA graph's capture takes."""
    T = T.clone()
    T[0].fill_(bottom)
    T[-1].fill_(top)
    return T


def neumann_left_right(T: torch.Tensor):
    """Side columns copy their interior neighbours (bc.neumann_left_right)."""
    T = T.clone()
    T[:, 0] = T[:, 1]
    T[:, -1] = T[:, -2]
    return T


def ns_temperature_bcs(T: torch.Tensor, rows=None):
    """Dirichlet bottom/top, then Neumann sides, which win at the corners
    (bc.ns_temperature_bcs).  rows: on a row shard, the row hooks
    (``ops.rows.Rows``) that say which local rows are the global bottom
    and top."""
    if rows is None:
        return neumann_left_right(dirichlet_top_bottom(T))
    g = rows.global_rows(T.shape[0], T.device)[:, None]
    T = torch.where(g == 0, T.new_ones(()), torch.where(g == rows.ny - 1, T.new_zeros(()), T))
    return neumann_left_right(T)


def dirichlet_faces_3d(H: torch.Tensor, value: float = 0.0):
    """``value`` on all six faces of an (nz, ny, nx) field (bc.dirichlet_faces_3d)."""
    H = H.clone()
    for axis in range(3):
        H.select(axis, 0).fill_(value)
        H.select(axis, -1).fill_(value)
    return H


def zero_boundary_2d(a: torch.Tensor):
    """Zero the one-cell boundary ring (bc.zero_boundary_2d)."""
    z = torch.zeros_like(a)
    z[1:-1, 1:-1] = a[1:-1, 1:-1]
    return z


def interior_mask_2d(shape, dtype, *, device=None):
    """1 in the interior, 0 on the boundary ring (bc.interior_mask_2d)."""
    m = torch.zeros(shape, dtype=dtype, device=device)
    m[1:-1, 1:-1] = 1
    return m
