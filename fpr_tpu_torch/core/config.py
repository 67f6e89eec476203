"""Static configuration of the port's solvers and models.

The subset of ``fpr_tpu/core/config.py`` that the ported path reads, with
the same field names and defaults, kept in this package so that the port
imports nothing of the JAX package: ``MGConfig`` (minus the execution
policy, smoother and restriction choices, which are fixed here to damped
Jacobi and injection), ``NSConfig`` (minus ``mg_solver``, which selects
the unported host-loop tiers), ``DiffusionConfig`` (minus
``scale_physical_size`` and ``overlap_comm``, which belong to the
unported sharded tier) and the ``ExecutionPolicy`` / ``InitScheme`` /
``CoarseSolver`` enums.  The CG coarse solver is not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum


class ExecutionPolicy(enum.Enum):
    """Tier of the 3D dual-time step (fpr_tpu.core.config.ExecutionPolicy),
    with the JAX names and values so that configs and ``--policy`` map one
    to one.

    - JNP: plain PyTorch ops (``ops/stencil3d.py``), on any device and dtype.
    - PALLAS: the float32 CUDA kernel (``ops/dual_time.py``); with
      ``check_every`` = K >= 2, K iterations per call between norm checks.
    - PALLAS_DS: the double-single (two-float32) CUDA kernel
      (``ops/ds3d.py``), for tolerances below the float32 floor.

    On a CPU tensor the two kernel tiers run their kernels' plain PyTorch
    versions.
    """

    JNP = "jnp"
    PALLAS = "pallas"
    PALLAS_DS = "pallas_ds"


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


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """3D pseudo-transient diffusion input (fpr_tpu.core.config.DiffusionConfig).

    check_every: pseudo-time iterations between convergence checks (PALLAS
    only); 1 checks every iteration, as the reference does.
    """

    nx: int = 128
    ny: int = 128
    nz: int = 128
    D: float = 1.0
    lx: float = 10.0
    ly: float = 10.0
    lz: float = 10.0
    ttot: float = 1.0
    dt: float = 0.2
    tol: float = 1.0e-8
    iter_max: int = 100_000
    policy: ExecutionPolicy = ExecutionPolicy.PALLAS
    check_every: int = 1

