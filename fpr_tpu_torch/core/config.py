"""Static configuration of the port's solvers and models.

The subset of ``fpr_tpu/core/config.py`` that the ported path reads, with
the same field names and defaults, kept in this package so that the port
imports nothing of the JAX package: ``MGConfig`` (minus the execution
policy, smoother and restriction choices, which are fixed here to damped
Jacobi and injection), ``NSConfig`` (minus ``mg_solver``, which selects
the unported host-loop tiers) and the ``InitScheme`` / ``CoarseSolver``
enums.  The CG coarse solver is not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum


class CoarseSolver(enum.Enum):
    """Coarse-grid solver of the V-cycle (fpr_tpu.core.config.CoarseSolver)."""

    JACOBI = "jacobi"
    DST = "dst"


class InitScheme(enum.Enum):
    """Initial condition of an NS field (fpr_tpu.core.config.InitScheme)."""

    COSINE = "cosine"
    RANDOM = "random"
    FROM_ARRAY = "from_array"


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Multigrid options (fpr_tpu.core.config.MGConfig).

    coarse_size: solve directly once min(nx, ny) <= coarse_size (2^l + 1).
    pre_smooth/post_smooth: damped-Jacobi sweeps per leg (1-6 on the fused
    legs).
    """

    coarse_size: int = 5
    coarse_solver: CoarseSolver = CoarseSolver.JACOBI
    pre_smooth: int = 2
    post_smooth: int = 2
    jacobi_damping: float = 0.8


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Navier-Stokes input (fpr_tpu.core.config.NSConfig)."""

    k: float = 1.0
    Ra: float = 1.0e6
    Pr: float = 1.0e-3
    nx: int = 257
    ny: int = 65
    ttot: float = 0.1
    beta: float = 0.0  # 0 explicit, 0.5 semi-implicit, 1 implicit
    niters: int = 50
    tol: float = 1.0e-3
    a_dif: float = 0.15
    a_adv: float = 0.4
    T_init: InitScheme = InitScheme.COSINE
    W_init: InitScheme = InitScheme.RANDOM
    mg: MGConfig = MGConfig()
    # let fast_mg_default upgrade a default ``mg`` to the DST ladder
    mg_auto: bool = True
    # the stream-function solve runs to s_tol_factor * tol * rms(W)
    s_tol_factor: float = 1.0

    @property
    def h(self) -> float:
        return 1.0 / (self.ny - 1.0)

    @property
    def width(self) -> float:
        return (self.nx - 1.0) / (self.ny - 1.0)

    @property
    def dt_dif(self) -> float:
        return self.a_dif * self.h**2 / max(self.k, self.Pr)

