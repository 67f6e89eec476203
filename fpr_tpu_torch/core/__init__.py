from fpr_tpu_torch.core.config import (CoarseSolver, DiffusionConfig, ExecutionPolicy,
                                       InitScheme, MGConfig, NSConfig, Restriction, Smoother)
from fpr_tpu_torch.core.grid import (Grid2D, Grid3D, is_mg_grid, mg_levels, outer_steps,
                                     pseudo_timestep)

__all__ = ["CoarseSolver", "DiffusionConfig", "ExecutionPolicy", "Grid2D", "Grid3D",
           "InitScheme", "MGConfig", "NSConfig", "Restriction", "Smoother", "is_mg_grid",
           "mg_levels", "outer_steps", "pseudo_timestep"]
