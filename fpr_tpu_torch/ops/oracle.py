"""Dense/sparse test oracles (numpy/scipy; never used in the compute path),
the port's own copy of fpr_tpu/ops/oracle.py, so that a machine without JAX
can hold the kernels against them.

Equivalent of the reference's SparseArrays 5-point Kronecker Laplacian
``stencil_5pt`` (part2_utils.jl:42-49), used by the test suite to check the
matrix-free operators algebraically, plus a scatter-form prolongation oracle
(multigrid.jl:403-420 semantics) for validating the gather rewrite.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def stencil_5pt(nx: int, ny: int) -> sp.spmatrix:
    """Unscaled 5-point Laplacian on an nx*ny interior grid.

    Row-major ordering consistent with ``arr[1:-1, 1:-1].ravel()`` of an
    (ny, nx)-shaped field: index = iy * nx + ix.
    """
    Dx = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(nx, nx))
    Dy = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(ny, ny))
    Ix = sp.identity(nx)
    Iy = sp.identity(ny)
    return sp.kron(Dy, Ix) + sp.kron(Iy, Dx)


def helmholtz_operator(nx: int, ny: int, h: float, c: float) -> sp.spmatrix:
    """(nabla^2 - c) on the interior with Dirichlet-0 ring: A = L/h^2 - c*I."""
    n = nx * ny
    return stencil_5pt(nx, ny) / h**2 - c * sp.identity(n)


def stencil_7pt(nx: int, ny: int, nz: int) -> sp.spmatrix:
    """Unscaled 7-point Laplacian on an nx*ny*nz interior grid (z-major)."""
    Dx = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(nx, nx))
    Dy = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(ny, ny))
    Dz = sp.diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(nz, nz))
    Ix, Iy, Iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    return (
        sp.kron(sp.kron(Iz, Iy), Dx)
        + sp.kron(sp.kron(Iz, Dy), Ix)
        + sp.kron(sp.kron(Dz, Iy), Ix)
    )


def prolongate_scatter(coarse: np.ndarray, fine_shape: tuple[int, int]) -> np.ndarray:
    """Reference-style scatter prolongation (multigrid.jl:403-420), numpy.

    Every interior coarse point (a, b) scatters to fine (2a, 2b) with weight
    1, its 4 face neighbors with 1/2 and 4 corners with 1/4.
    """
    ny_f, nx_f = fine_shape
    fine = np.zeros(fine_shape, dtype=coarse.dtype)
    ny_c, nx_c = coarse.shape
    for a in range(1, ny_c - 1):
        for b in range(1, nx_c - 1):
            i, j = 2 * a, 2 * b
            v = coarse[a, b]
            fine[i, j] += v
            fine[i + 1, j] += 0.5 * v
            fine[i - 1, j] += 0.5 * v
            fine[i, j + 1] += 0.5 * v
            fine[i, j - 1] += 0.5 * v
            fine[i + 1, j + 1] += 0.25 * v
            fine[i + 1, j - 1] += 0.25 * v
            fine[i - 1, j + 1] += 0.25 * v
            fine[i - 1, j - 1] += 0.25 * v
    return fine
