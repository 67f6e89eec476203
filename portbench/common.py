"""What the harness's parts share: loading the data-driven files by name, and
the comparison's arithmetic."""

from __future__ import annotations

import importlib.util
import json
import math
import random
from pathlib import Path

import numpy as np

PB = Path(__file__).resolve().parent
ROOT = PB.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(x) -> float:
    """x as a float; a NaN or an infinity reads as 1e300 (it fails any limit)."""
    x = float(x)
    return x if math.isfinite(x) else 1e300


def rel_max(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the interior of a 2D field, over max |want| there."""
    g, w = got[1:-1, 1:-1], want[1:-1, 1:-1]
    return finite(np.max(np.abs(g - w)) / max(float(np.max(np.abs(w))), 1e-300))


def judge(readings: list, limits: dict) -> tuple:
    """(checks, failed): each number's worst reading over the checked units
    beside its limit, and how many units read over a limit."""
    checks = {name: {"value": max(r[name] for r in readings), "limit": float(lim)}
              for name, lim in limits.items()}
    failed = sum(any(r[n] > float(lim) for n, lim in limits.items()) for r in readings)
    return checks, failed


class Reservoir:
    """A sample of at most ``size`` of the items offered, each offered item
    equally likely to be kept, drawn from ``seed`` (the same offers and seed
    keep the same items)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen, self.items = size, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item
