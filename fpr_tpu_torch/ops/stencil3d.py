"""3D dual-time diffusion step, the JNP tier in plain PyTorch
(fpr_tpu/ops/stencil3d.py: dual_time_step, dual_time_step_ext3,
dual_time_step_overlap_z, init_gaussian).

    dHdtau = (Htau - Ht)/dt - D nabla^2 Htau      (interior)
    Htau'  = Htau - dtau dHdtau                   (interior)

Boundary cells keep their values.  Fields are (nz, ny, nx), x last.  This
tier is the JAX package's XLA-fused jnp step, which has no Pallas kernel:
its port is plain PyTorch on every device and dtype.  It divides by dt,
as the JAX tier does; the kernels (``ops/dual_time.py``) multiply by a
precomputed 1/dt, which rounds differently.  The sharded tier's two steps
(``_ext3``, ``_overlap_z``) divide by dt, dx^2, dy^2 and dz^2 as their JAX
functions do, each divisor a tensor so that CUDA divides rather than
multiplying by a reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch


def dual_time_step(Ht, Htau, dt, dtau, dx, dy, dz, D, with_norm=True):
    """One pseudo-time iteration (stencil3d.dual_time_step).

    Returns (Htau', sumsq) with sumsq = sum(dHdtau^2) over the interior
    (None without with_norm); Htau is not written.
    """
    _dx2, _dy2, _dz2 = 1.0 / (dx * dx), 1.0 / (dy * dy), 1.0 / (dz * dz)
    I = (slice(1, -1),) * 3
    Hi = Htau[I]
    lap = ((Htau[1:-1, 1:-1, 2:] - 2.0 * Hi + Htau[1:-1, 1:-1, :-2]) * _dx2
           + (Htau[1:-1, 2:, 1:-1] - 2.0 * Hi + Htau[1:-1, :-2, 1:-1]) * _dy2
           + (Htau[2:, 1:-1, 1:-1] - 2.0 * Hi + Htau[:-2, 1:-1, 1:-1]) * _dz2)
    dHdtau = (Hi - Ht[I]) / dt - D * lap
    new = Htau.clone()
    new[I] = Hi - dtau * dHdtau
    return new, torch.sum(dHdtau * dHdtau) if with_norm else None


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    return a / a.new_full((), d)


def _in(idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return (idx >= lo) & (idx <= hi)


def _iota(shape, dim: int, device, start: int = 0) -> torch.Tensor:
    view = [1, 1, 1]
    view[dim] = shape[dim]
    return (start + torch.arange(shape[dim], device=device)).view(view)


def dual_time_step_ext3(Ht, H_ext, dt, dtau, dx, dy, dz, D, zlo, zhi, ylo, yhi, xlo, xhi,
                        with_norm=True):
    """One iteration on a fully ghost-padded local block (nz_l+2, ny_l+2,
    nx_l+2) with the ghosts refreshed (stencil3d.dual_time_step_ext3).

    Ht: the unpadded (nz_l, ny_l, nx_l) block.  (zlo..xhi): inclusive local
    ranges of updateable cells (``halo.mask_bounds``).  Returns (H_ext',
    sumsq) with ghosts copied, sumsq None without with_norm; H_ext is not
    written.
    """
    C = H_ext[1:-1, 1:-1, 1:-1]
    lap = (_div(H_ext[1:-1, 1:-1, 2:] - 2.0 * C + H_ext[1:-1, 1:-1, :-2], dx * dx)
           + _div(H_ext[1:-1, 2:, 1:-1] - 2.0 * C + H_ext[1:-1, :-2, 1:-1], dy * dy)
           + _div(H_ext[2:, 1:-1, 1:-1] - 2.0 * C + H_ext[:-2, 1:-1, 1:-1], dz * dz))
    dH = _div(C - Ht, dt) - D * lap
    dev = Ht.device
    interior = (_in(_iota(Ht.shape, 0, dev), zlo, zhi) & _in(_iota(Ht.shape, 1, dev), ylo, yhi)
                & _in(_iota(Ht.shape, 2, dev), xlo, xhi))
    dH = torch.where(interior, dH, dH.new_zeros(()))
    new = H_ext.clone()
    new[1:-1, 1:-1, 1:-1] = C - dtau * dH
    return new, torch.sum(dH * dH) if with_norm else None


def dual_time_step_overlap_z(Ht, H_local, ghost_lo, ghost_hi, dt, dtau, dx, dy, dz, D,
                             zlo, zhi, with_norm=True):
    """One iteration on an unpadded local block with its z neighbours'
    faces ghost_lo/ghost_hi (1, ny_l, nx_l) from an exchange
    (stencil3d.dual_time_step_overlap_z): the interior planes need no
    ghost, only the two edge planes read them.  Returns (H_local', sumsq),
    equal to the ghost-padded step's (sumsq None without with_norm)."""
    nzl, nyl, nxl = Ht.shape

    def lat_lap(block):
        """The y/x Laplacian terms of a z-range; the edge copies are masked."""
        ym = torch.cat([block[:, :1], block[:, :-1]], dim=1)
        yp = torch.cat([block[:, 1:], block[:, -1:]], dim=1)
        xm = torch.cat([block[:, :, :1], block[:, :, :-1]], dim=2)
        xp = torch.cat([block[:, :, 1:], block[:, :, -1:]], dim=2)
        return _div(xp - 2.0 * block + xm, dx * dx) + _div(yp - 2.0 * block + ym, dy * dy)

    def finish(rows, zm, zp, ht_rows, z_start):
        lap = lat_lap(rows) + _div(zp - 2.0 * rows + zm, dz * dz)
        dH = _div(rows - ht_rows, dt) - D * lap
        dev = rows.device
        m = (_in(_iota(rows.shape, 0, dev, z_start), zlo, zhi)
             & _in(_iota(rows.shape, 1, dev), 1, nyl - 2)
             & _in(_iota(rows.shape, 2, dev), 1, nxl - 2))
        dH = torch.where(m, dH, dH.new_zeros(()))
        return rows - dtau * dH, dH

    mid, dH_mid = finish(H_local[1:-1], H_local[:-2], H_local[2:], Ht[1:-1], 1)
    first, dH_first = finish(H_local[:1], ghost_lo, H_local[1:2], Ht[:1], 0)
    last, dH_last = finish(H_local[-1:], H_local[-2:-1], ghost_hi, Ht[-1:], nzl - 1)
    new = torch.cat([first, mid, last], dim=0)
    if not with_norm:
        return new, None
    sumsq = (torch.sum(dH_mid * dH_mid) + torch.sum(dH_first * dH_first)
             + torch.sum(dH_last * dH_last))
    return new, sumsq


def init_gaussian(grid, dtype=torch.float32, x0=None, y0=None, z0=None, *,
                  device) -> torch.Tensor:
    """H = 2 exp(-|x - centre|^2) at the cell centres (stencil3d.init_gaussian),
    built in float64 numpy and then cast, as the JAX function does.
    x0, y0, z0: offsets added to the coordinates (a shard's global origin)."""
    cx, cy, cz = grid.lx / 2, grid.ly / 2, grid.lz / 2
    X = (grid.coords1d("x") + (x0 or 0.0)).reshape(1, 1, -1)
    Y = (grid.coords1d("y") + (y0 or 0.0)).reshape(1, -1, 1)
    Z = (grid.coords1d("z") + (z0 or 0.0)).reshape(-1, 1, 1)
    H = 2.0 * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2))
    return torch.tensor(H, dtype=dtype, device=device)
