"""Device reductions and the distributed norms (fpr_tpu/ops/reductions.py:
sumsq, rms, dist_norm_l2, dist_sumsq).

The JAX module ``psum``s a shard's partial over the mesh axes inside a
``shard_map``.  The port's sharded tiers hold one partial per shard in one
process, so ``dist_sumsq`` adds the list of per-shard partials in shard
order on shard 0's device, and ``dist_max`` takes their maximum the same
way (``lax.pmax``).  Shard order fixes the order of the additions, so a
rerun gives the same bits; it need not be the order of JAX's ``psum``.
"""

from __future__ import annotations

import torch


def sumsq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a)


def rms(a: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(a^2) / N) over the whole array."""
    return torch.sqrt(sumsq(a) / a.new_full((), a.numel()))


def dist_sumsq(parts) -> torch.Tensor:
    """The global sum of per-shard 0-dim partials (dist_sumsq after the
    shard's own reduction), added in shard order on shard 0's device."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev, non_blocking=True)
    return total


def dist_max(parts) -> torch.Tensor:
    """The maximum of per-shard 0-dim partials (lax.pmax), on shard 0's
    device."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev, non_blocking=True))
    return out


def dist_norm_l2(blocks) -> torch.Tensor:
    """sqrt(global sum of squares) of a field held as per-shard blocks
    (dist_norm_l2, part1_utils.jl:36-40)."""
    return torch.sqrt(dist_sumsq([sumsq(b) for b in blocks]))
