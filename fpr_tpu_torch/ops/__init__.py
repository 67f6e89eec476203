from fpr_tpu_torch.ops import reductions, stencil2d, stencil3d, transfer

__all__ = ["stencil2d", "stencil3d", "transfer", "reductions"]
