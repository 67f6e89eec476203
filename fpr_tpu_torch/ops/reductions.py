"""Device reductions (fpr_tpu/ops/reductions.py: sumsq, rms).

The distributed norms of the JAX module (``dist_norm_l2``,
``dist_sumsq``) belong to the sharded tier and are not ported yet.
"""

from __future__ import annotations

import torch


def sumsq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a)


def rms(a: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(a^2) / N) over the whole array."""
    return torch.sqrt(sumsq(a) / a.new_full((), a.numel()))
