"""Checkpoints of a simulation's state (fpr_tpu/utils/checkpoint.py): one
npz file with a schema version, written atomically (a temporary file, then
a rename).  Tensors are stored through ``.detach().cpu().numpy()``; a file
written by either package loads in the other, and a newer schema is
refused.  ``load``'s dict feeds ``navier_stokes.simulate_fast(state0=...)``
or ``simulate(T0=..., W0=...)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

SCHEMA = 1


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(path, **arrays_and_scalars) -> None:
    """Atomic checkpoint write (a temporary file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez(tmp, __schema__=SCHEMA, **{k: _array(v) for k, v in arrays_and_scalars.items()})
    # np.savez appends .npz to a name without it
    produced = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    produced.replace(path)


def load(path) -> dict:
    with np.load(path) as z:
        d = {k: z[k] for k in z.files if k != "__schema__"}
        schema = int(z["__schema__"]) if "__schema__" in z.files else 0
    if schema > SCHEMA:
        raise ValueError(f"checkpoint schema {schema} newer than supported {SCHEMA}")
    return d
