"""Plain PyTorch 2D operators of the small-level V-cycle and the DST solve
(fpr_tpu/ops/stencil2d.py: residual, jacobi_step, rms).

Each keeps the JAX function's operation order, so its f32 roundings are
the same.  Divisions take a device tensor as divisor: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal instead.
"""

from __future__ import annotations

import torch


def as_scalar(c, like: torch.Tensor) -> torch.Tensor:
    """c (Python number or tensor) as a 0-dim tensor of like's dtype/device."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype=like.dtype, device=like.device)
    return like.new_full((), float(c))


def residual(u: torch.Tensor, f: torch.Tensor, h: float, c) -> torch.Tensor:
    """res = (u_E + u_W + u_N + u_S - C u)/h^2 - f on the interior, 0 on the
    boundary, C = 4 + c h^2 (stencil2d.residual)."""
    c = as_scalar(c, u)
    C = 4.0 + c * h * h
    inner = (
        u[1:-1, 2:] + u[1:-1, :-2] + u[2:, 1:-1] + u[:-2, 1:-1]
        - C * u[1:-1, 1:-1]
    ) / u.new_full((), h * h) - f[1:-1, 1:-1]
    res = torch.zeros_like(u)
    res[1:-1, 1:-1] = inner
    return res


def rms(a: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(a^2)/N) over the whole array (stencil2d.rms)."""
    return torch.sqrt(torch.sum(a * a) / a.new_full((), a.numel()))


def jacobi_step(u, f, h, c, alpha=0.8, with_norm=True):
    """One damped-Jacobi sweep u + alpha h^2/C res (stencil2d.jacobi_step).

    Returns (u_new, rms of the residual that fed the sweep, or None)."""
    c = as_scalar(c, u)
    C = 4.0 + c * h * h
    res = residual(u, f, h, c)
    r_rms = rms(res) if with_norm else None
    return u + (u.new_full((), alpha * h * h) / C) * res, r_rms
