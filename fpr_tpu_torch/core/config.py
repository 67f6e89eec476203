"""Static configuration of the port's solvers and models.

``fpr_tpu/core/config.py``, with the same field names and defaults, kept
in this package so that the port imports nothing of the JAX package:
``MGConfig``, ``NSConfig``, ``DiffusionConfig`` and the
``ExecutionPolicy`` / ``CoarseSolver`` / ``Smoother`` / ``Restriction`` /
``InitScheme`` enums.
"""

from __future__ import annotations

import dataclasses
import enum


class ExecutionPolicy(enum.Enum):
    """How the stencil operators execute (fpr_tpu.core.config.ExecutionPolicy),
    with the JAX names and values so that configs and ``--policy`` map one
    to one.

    - JNP: plain PyTorch ops (``ops/stencil2d.py``, ``ops/stencil3d.py``),
      on any device and dtype.
    - PALLAS: the CUDA kernels.  The 3D dual-time step runs
      ``ops/dual_time.py`` (float32; with ``check_every`` = K >= 2, K
      iterations per call between norm checks); ``MGConfig(policy=PALLAS)``
      runs the smoother, residual and CG matvec of ``mg_solve``, ``cg`` and
      ``mg_preconditioned_cg`` through ``ops/stencil_pass.py`` (float32 or
      float64).
    - PALLAS_DS: the double-single (two-float32) CUDA kernel
      (``ops/ds3d.py``), for tolerances below the float32 floor.

    On a CPU tensor the kernel tiers run their kernels' plain PyTorch
    versions.
    """

    JNP = "jnp"
    PALLAS = "pallas"
    PALLAS_DS = "pallas_ds"


class CoarseSolver(enum.Enum):
    """Coarse-grid solver of the V-cycle (fpr_tpu.core.config.CoarseSolver)."""

    JACOBI = "jacobi"
    CG = "cg"
    DST = "dst"


class Smoother(enum.Enum):
    """Multigrid smoother (fpr_tpu.core.config.Smoother): damped Jacobi, or
    red-black Gauss-Seidel as two masked half-sweeps."""

    JACOBI = "jacobi"
    RED_BLACK_GS = "red_black_gs"


class Restriction(enum.Enum):
    """Multigrid restriction (fpr_tpu.core.config.Restriction).  AUTO is
    injection for the Jacobi smoother and full weighting for red-black GS,
    whose checkerboard residual injection would alias."""

    AUTO = "auto"
    INJECTION = "injection"
    FULL_WEIGHTING = "full_weighting"


class InitScheme(enum.Enum):
    """Initial condition of an NS field (fpr_tpu.core.config.InitScheme)."""

    COSINE = "cosine"
    RANDOM = "random"
    FROM_ARRAY = "from_array"


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Multigrid options (fpr_tpu.core.config.MGConfig).

    coarse_size: solve directly once min(nx, ny) <= coarse_size (2^l + 1).
    policy: JNP (plain PyTorch) or PALLAS (the ``stencil_pass`` kernel) for
    the smoother and residual of ``vcycle``/``mg_solve``.
    pre_smooth/post_smooth: sweeps per leg (1-6 on the fused legs).
    """

    coarse_size: int = 5
    coarse_solver: CoarseSolver = CoarseSolver.JACOBI
    smoother: Smoother = Smoother.JACOBI
    policy: ExecutionPolicy = ExecutionPolicy.JNP
    pre_smooth: int = 2
    post_smooth: int = 2
    jacobi_damping: float = 0.8
    restriction: Restriction = Restriction.AUTO

    def resolved_restriction(self) -> Restriction:
        if self.restriction is Restriction.AUTO:
            return (Restriction.FULL_WEIGHTING if self.smoother is Smoother.RED_BLACK_GS
                    else Restriction.INJECTION)
        return self.restriction


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
    # the host loop's solver: "direct" (mg_solve in the state's dtype) or
    # "mixed" (mg_solve_mixed: defect correction around float32 V-cycles)
    mg_solver: str = "direct"
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
    The sharded tier (``parallel.dist_diffusion``) reads nx, ny, nz as
    each shard's local size; scale_physical_size scales lx, ly, lz by the
    shard grid as well (weak scaling, part1_kernel_programming.jl:106-114),
    and overlap_comm runs the halo exchange beside the interior update on
    a z-only mesh.
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
    scale_physical_size: bool = False
    policy: ExecutionPolicy = ExecutionPolicy.PALLAS
    check_every: int = 1
    overlap_comm: bool = False

