"""Exact (nabla^2 - c) coarse solve by dense sine-transform matmuls
(fpr_tpu/solvers/dst.py: _dst_consts, solve_interior, dst_solve).

The type-I DST diagonalises the 5-point Dirichlet operator, so

    u_int = -Vy ((Vy f_int Vx) / (lam_y (+) lam_x + c)) Vx .

The four products are plain ``torch.matmul`` in float32, outside any
kernel.  They must run in true float32: TF32 (10 mantissa bits) would
make the coarse correction inexact and cost outer iterations, so a CUDA
call asserts that TF32 matmuls are off (PyTorch's default).  The bases
are cached per (m, h, dtype, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fpr_tpu_torch.ops import stencil2d


@functools.lru_cache(maxsize=64)
def _dst_consts(m: int, h: float):
    """(V, lam) for m interior points at spacing h, float64 numpy."""
    j = np.arange(1, m + 1, dtype=np.float64)
    V = np.sqrt(2.0 / (m + 1)) * np.sin(np.outer(j, j) * (np.pi / (m + 1)))
    lam = (2.0 - 2.0 * np.cos(j * np.pi / (m + 1))) / (h * h)
    return V, lam


@functools.lru_cache(maxsize=64)
def _dst_tensors(my: int, mx: int, h: float, dtype: torch.dtype, device: torch.device):
    Vy, ly = _dst_consts(my, h)
    Vx, lx = _dst_consts(mx, h)
    as_t = functools.partial(torch.as_tensor, dtype=dtype, device=device)
    return as_t(Vy), as_t(Vx), as_t(ly[:, None] + lx[None, :])


def solve_interior(f_int: torch.Tensor, h: float, c) -> torch.Tensor:
    """u_int with A u = f_int under a zero Dirichlet boundary."""
    if f_int.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the DST coarse solve needs float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 must be False")
    my, mx = f_int.shape
    Vy, Vx, lam = _dst_tensors(my, mx, float(h), f_int.dtype, f_int.device)
    denom = lam + stencil2d.as_scalar(c, f_int)
    G = torch.matmul(Vy, torch.matmul(f_int, Vx))
    U = -G / denom
    return torch.matmul(Vy, torch.matmul(U, Vx))


def dst_solve(u0: torch.Tensor, f: torch.Tensor, h: float, c):
    """Coarse solve in defect form; returns (u, rms of its residual)."""
    res0 = stencil2d.residual(u0, f, h, c)
    e_int = solve_interior(res0[1:-1, 1:-1], h, c)
    u = u0.clone()
    u[1:-1, 1:-1] = u0[1:-1, 1:-1] + (-e_int)
    return u, stencil2d.rms(stencil2d.residual(u, f, h, c))
