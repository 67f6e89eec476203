"""Multigrid transfers on physical (ny, nx) tensors (fpr_tpu/ops/transfer.py).

``restrict`` is injection at the coincident (even-index) fine points, and
``restrict_full_weighting`` the 9-point average that red-black smoothing
needs.  The JAX layout variants are the same functions on physical
arrays: the TPU down leg writes its residual parity-split so that
restriction is a column pass (``transfer.restrict_ps``), and
``restrict_rp`` / ``prolongate_rp`` work on row-padded arrays; the values
are those of ``restrict`` and ``prolongate`` here.
``prolongate`` is bilinear interpolation in gather form, y midpoints
before x midpoints of the cell centres, as in the JAX function.
"""

from __future__ import annotations

import torch

from fpr_tpu_torch.core import bc


def restrict(fine: torch.Tensor, apply_bcs: bool = False) -> torch.Tensor:
    """Injection (ny, nx) -> ((ny-1)//2+1, (nx-1)//2+1), zero boundary, then
    the Neumann side copies when apply_bcs (transfer.restrict)."""
    coarse = bc.zero_boundary_2d(fine[::2, ::2])
    if apply_bcs:
        coarse = bc.neumann_left_right(coarse)
    return coarse


def restrict_full_weighting(fine: torch.Tensor, apply_bcs: bool = False) -> torch.Tensor:
    """Full weighting (transfer.restrict_full_weighting): the separable
    (1/4, 1/2, 1/4) blur in x, then in y (edges replicated), sampled at the
    even points, zero boundary, then the Neumann side copies when
    apply_bcs."""

    def blur(a, dim):
        lo = torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, a.shape[dim] - 1)], dim)
        hi = torch.cat([a.narrow(dim, 1, a.shape[dim] - 1), a.narrow(dim, a.shape[dim] - 1, 1)],
                       dim)
        return 0.25 * lo + 0.5 * a + 0.25 * hi

    coarse = bc.zero_boundary_2d(blur(blur(fine, 1), 0)[::2, ::2])
    if apply_bcs:
        coarse = bc.neumann_left_right(coarse)
    return coarse


def prolongate(coarse: torch.Tensor, fine_shape, apply_bcs: bool = False):
    """Bilinear prolongation of the zero-boundary coarse array
    (transfer.prolongate)."""
    ny_f, nx_f = fine_shape
    c = bc.zero_boundary_2d(coarse)
    cx = (c[:, :-1] + c[:, 1:]) * 0.5
    cy = (c[:-1, :] + c[1:, :]) * 0.5
    cxy = (cy[:, :-1] + cy[:, 1:]) * 0.5
    fine = c.new_empty((ny_f, nx_f))
    fine[0::2, 0::2] = c
    fine[0::2, 1::2] = cx
    fine[1::2, 0::2] = cy
    fine[1::2, 1::2] = cxy
    if apply_bcs:
        fine = bc.neumann_left_right(fine)
    return fine


def x_interleave_coarse(coarse: torch.Tensor, apply_bcs: bool = False):
    """Bilinear interpolation of the zero-boundary coarse correction along x
    only: (nyc, nxc) -> (nyc, 2 nxc - 1), the input of the up leg, which
    interpolates in y (pallas2d.x_interleave_coarse)."""
    c0 = bc.zero_boundary_2d(coarse)
    nyc, nxc = c0.shape
    rows = c0.new_empty((nyc, 2 * nxc - 1))
    rows[:, 0::2] = c0
    rows[:, 1::2] = (c0[:, :-1] + c0[:, 1:]) * 0.5
    if apply_bcs:
        rows = bc.neumann_left_right(rows)
    return rows
