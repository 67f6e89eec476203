from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy,
                                       InitScheme, MGConfig, NSConfig)
from fpr_tpu_torch.core.grid import Grid3D, mg_levels, outer_steps, pseudo_timestep

__all__ = ["CoarseSolver", "DiffusionConfig", "ExecutionPolicy", "Grid3D", "InitScheme",
           "MGConfig", "NSConfig", "mg_levels", "outer_steps", "pseudo_timestep"]
