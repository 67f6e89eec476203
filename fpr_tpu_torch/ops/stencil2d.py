"""Plain PyTorch 2D operators: the multigrid smoothers and residual, the CG
matvec and the Navier-Stokes operators of the host loop
(fpr_tpu/ops/stencil2d.py).

Each keeps the JAX function's operation order, so its roundings are the
same.  Divisions take a device tensor as divisor: PyTorch's CUDA division
by a Python scalar multiplies by its reciprocal instead.  Every operator
writes the interior and leaves a zero boundary ring.

The multigrid operators also run on a row shard of the row-sharded tier
(``solvers.dist_multigrid``): ``rows`` (``ops.rows.Rows``) gives the local
rows' global indices, and the residual is then zero on every row that is
not interior under the hooks (the global boundary rows, the rows past the
grid, the local first and last rows), red-black colours follow the global
row, and a norm is the owned rows' sum of squares, for the caller to add
across shards.
"""

from __future__ import annotations

import torch


def as_scalar(c, like: torch.Tensor) -> torch.Tensor:
    """c (Python number or tensor) as a 0-dim tensor of like's dtype/device."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype=like.dtype, device=like.device)
    return like.new_full((), float(c))


def _pad0(interior: torch.Tensor) -> torch.Tensor:
    """An (ny-2, nx-2) interior back to (ny, nx) with a zero ring."""
    out = interior.new_zeros((interior.shape[0] + 2, interior.shape[1] + 2))
    out[1:-1, 1:-1] = interior
    return out


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    return a / a.new_full((), d)


def laplacian_interior(u: torch.Tensor, hx: float, hy: float) -> torch.Tensor:
    """The 5-point Laplacian on the interior, shape (ny-2, nx-2)
    (stencil2d.laplacian_interior)."""
    c = u[1:-1, 1:-1]
    return (_div(u[1:-1, 2:] - 2.0 * c + u[1:-1, :-2], hx * hx)
            + _div(u[2:, 1:-1] - 2.0 * c + u[:-2, 1:-1], hy * hy))


def residual(u: torch.Tensor, f: torch.Tensor, h: float, c, rows=None) -> torch.Tensor:
    """res = (u_E + u_W + u_N + u_S - C u)/h^2 - f on the interior, 0 on the
    boundary, C = 4 + c h^2 (stencil2d.residual)."""
    c = as_scalar(c, u)
    C = 4.0 + c * h * h
    inner = (
        u[1:-1, 2:] + u[1:-1, :-2] + u[2:, 1:-1] + u[:-2, 1:-1]
        - C * u[1:-1, 1:-1]
    ) / u.new_full((), h * h) - f[1:-1, 1:-1]
    res = _pad0(inner)
    if rows is not None:
        res = torch.where(rows.interior(u.shape[0], u.device)[:, None], res, res.new_zeros(()))
    return res


def matvec(x: torch.Tensor, hx: float, hy: float, c) -> torch.Tensor:
    """(nabla^2 - c) x on the interior, 0 on the boundary (stencil2d.matvec)."""
    c = as_scalar(c, x)
    xc = x[1:-1, 1:-1]
    inner = (_div(x[1:-1, 2:] - 2.0 * xc + x[1:-1, :-2], hx * hx)
             + _div(x[2:, 1:-1] - 2.0 * xc + x[:-2, 1:-1], hy * hy)
             - c * xc)
    return _pad0(inner)


def rms(a: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(a^2)/N) over the whole array (stencil2d.rms)."""
    return torch.sqrt(torch.sum(a * a) / a.new_full((), a.numel()))


def _norm(res, rows):
    """rms(res), or on a row shard the owned rows' sum of squares."""
    return rms(res) if rows is None else torch.sum((res * res)[rows.own[0]:rows.own[1]])


def jacobi_step(u, f, h, c, alpha=0.8, with_norm=True, rows=None):
    """One damped-Jacobi sweep u + alpha h^2/C res (stencil2d.jacobi_step).

    Returns (u_new, rms of the residual that fed the sweep, or None)."""
    c = as_scalar(c, u)
    C = 4.0 + c * h * h
    res = residual(u, f, h, c, rows)
    r_rms = _norm(res, rows) if with_norm else None
    return u + (u.new_full((), alpha * h * h) / C) * res, r_rms


def red_black_gs_step(u, f, h, c, with_norm=True, rows=None):
    """One red-black Gauss-Seidel sweep: the (ix + iy) even points update
    first, then the others from the half-updated u
    (stencil2d.red_black_gs_step).  Returns (u_new, rms of the residual on
    entry, or None).  On a row shard iy is the global row, and the second
    half-sweep's rows next to the local edges are stale: two ghost rows
    keep the owned rows right."""
    ny, nx = u.shape
    iy = torch.arange(ny, device=u.device) if rows is None else rows.global_rows(ny, u.device)
    iy = iy.reshape(-1, 1)
    ix = torch.arange(nx, device=u.device).reshape(1, -1)
    red = ((ix + iy) % 2 == 0).to(u.dtype)
    c = as_scalar(c, u)
    C = 4.0 + c * h * h
    w = u.new_full((), h * h) / C
    res0 = residual(u, f, h, c, rows)
    r_rms = _norm(res0, rows) if with_norm else None
    u = u + w * res0 * red
    res1 = residual(u, f, h, c, rows)
    u = u + w * res1 * (1.0 - red)
    return u, r_rms


# the Navier-Stokes operators (part2.jl:90-137)


def velocity(S: torch.Tensor, hx: float, hy: float):
    """(vx, vy) = (dS/dy, -dS/dx) by central differences (stencil2d.velocity)."""
    vx = _pad0(_div(S[2:, 1:-1] - S[:-2, 1:-1], 2.0 * hy))
    vy = _pad0(_div(-(S[1:-1, 2:] - S[1:-1, :-2]), 2.0 * hx))
    return vx, vy


def buoyancy(T: torch.Tensor, Ra: float, hx: float) -> torch.Tensor:
    """Ra dT/dx by central differences (stencil2d.buoyancy)."""
    return _pad0(_div(Ra * (T[1:-1, 2:] - T[1:-1, :-2]), 2.0 * hx))


def diffusion(T: torch.Tensor, k, hx: float, hy: float) -> torch.Tensor:
    """k nabla^2 T on the interior (stencil2d.diffusion)."""
    return _pad0(k * laplacian_interior(T, hx, hy))


def _upwind(T, v, back, fwd, h):
    Ti = T[1:-1, 1:-1]
    up = _div(Ti - T[back], h)  # backward difference, v > 0
    dn = _div(T[fwd] - Ti, h)  # forward difference, v <= 0
    vi = v[1:-1, 1:-1]
    return _pad0(vi * torch.where(vi > 0, up, dn))


def advection_x(T: torch.Tensor, vx: torch.Tensor, hx: float) -> torch.Tensor:
    """First-order upwind vx dT/dx (stencil2d.advection_x)."""
    return _upwind(T, vx, (slice(1, -1), slice(None, -2)), (slice(1, -1), slice(2, None)), hx)


def advection_y(T: torch.Tensor, vy: torch.Tensor, hy: float) -> torch.Tensor:
    """First-order upwind vy dT/dy (stencil2d.advection_y)."""
    return _upwind(T, vy, (slice(None, -2), slice(1, -1)), (slice(2, None), slice(1, -1)), hy)
