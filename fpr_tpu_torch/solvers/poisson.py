"""The Poisson problem the MG rows and sweeps solve, and its true residual.

``poisson_rhs`` is the right-hand side of the bench's MG row and of the
multigrid sweeps; ``true_rel_residual`` checks a double-single solve in
float64 after it, without holding a whole float64 field.
"""

from __future__ import annotations

import numpy as np
import torch


def poisson_rhs(n: int, device, dtype=np.float32) -> torch.Tensor:
    """The MG rows' right-hand side: numpy's uniform draw from seed 0 in the
    interior, a zero ring."""
    b = np.zeros((n, n), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(0).random((n - 2, n - 2))
    return torch.tensor(b, device=device)


ROW_BLOCK = 2048  # rows of the float64 residual formed at a time


def true_rel_residual(u_hi, u_lo, b, h: float) -> float:
    """rms of the float64 residual of the Poisson problem at hi + lo (zero
    on the ring) over rms(b), formed ROW_BLOCK rows at a time, so that no
    whole float64 field is held."""
    n_rows = b.shape[0]
    res_ss = b_ss = 0.0
    for i0 in range(1, n_rows - 1, ROW_BLOCK):
        i1 = min(i0 + ROW_BLOCK, n_rows - 1)
        u = u_hi[i0 - 1:i1 + 1].double() + u_lo[i0 - 1:i1 + 1].double()
        lap = (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
               - 4.0 * u[1:-1, 1:-1]) / h**2
        f = b[i0:i1].double()
        res_ss += float(torch.sum((lap - f[:, 1:-1]) ** 2))
        b_ss += float(torch.sum(f * f))
    b_ss += float(torch.sum(b[0].double() ** 2) + torch.sum(b[-1].double() ** 2))
    return float(np.sqrt(res_ss / b_ss))
