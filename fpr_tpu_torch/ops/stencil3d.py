"""3D dual-time diffusion step, the JNP tier in plain PyTorch
(fpr_tpu/ops/stencil3d.py: dual_time_step, init_gaussian).

    dHdtau = (Htau - Ht)/dt - D nabla^2 Htau      (interior)
    Htau'  = Htau - dtau dHdtau                   (interior)

Boundary cells keep their values.  Fields are (nz, ny, nx), x last.  This
tier is the JAX package's XLA-fused jnp step, which has no Pallas kernel:
its port is plain PyTorch on every device and dtype.  It divides by dt,
as the JAX tier does; the kernels (``ops/dual_time.py``) multiply by a
precomputed 1/dt, which rounds differently.
"""

from __future__ import annotations

import numpy as np
import torch


def dual_time_step(Ht, Htau, dt, dtau, dx, dy, dz, D):
    """One pseudo-time iteration (stencil3d.dual_time_step).

    Returns (Htau', sumsq) with sumsq = sum(dHdtau^2) over the interior;
    Htau is not written.
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
    return new, torch.sum(dHdtau * dHdtau)


def init_gaussian(grid, dtype=torch.float32, *, device) -> torch.Tensor:
    """H = 2 exp(-|x - centre|^2) at the cell centres (stencil3d.init_gaussian),
    built in float64 numpy and then cast, as the JAX function does."""
    cx, cy, cz = grid.lx / 2, grid.ly / 2, grid.lz / 2
    X = grid.coords1d("x").reshape(1, 1, -1)
    Y = grid.coords1d("y").reshape(1, -1, 1)
    Z = grid.coords1d("z").reshape(-1, 1, 1)
    H = 2.0 * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2))
    return torch.tensor(H, dtype=dtype, device=device)
