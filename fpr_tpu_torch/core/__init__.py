from fpr_tpu_torch.core.config import CoarseSolver, InitScheme, MGConfig, NSConfig
from fpr_tpu_torch.core.grid import mg_levels

__all__ = ["CoarseSolver", "InitScheme", "MGConfig", "NSConfig", "mg_levels"]
