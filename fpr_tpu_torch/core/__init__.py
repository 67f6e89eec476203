from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy,
                                       InitScheme, MGConfig, NSConfig, Restriction, Smoother)
from fpr_tpu_torch.core.grid import Grid3D, mg_levels, outer_steps, pseudo_timestep

__all__ = ["CoarseSolver", "DiffusionConfig", "ExecutionPolicy", "Grid3D", "InitScheme",
           "MGConfig", "NSConfig", "Restriction", "Smoother", "mg_levels", "outer_steps",
           "pseudo_timestep"]
