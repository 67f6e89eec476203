"""The device mesh of the sharded tiers (fpr_tpu/parallel/mesh.py: make_mesh).

The JAX package is single-controller: one process drives every shard of a
``jax.sharding.Mesh`` through ``shard_map``, with ``ppermute`` for halos and
``psum`` for norms.  The port keeps that design.  One process holds one
tensor per shard, each on the device of its slot of the mesh; halos are
face copies between those tensors (``parallel.halo``) and norms a sum of
the per-shard partials in shard order (``ops.reductions``).

``devices=None`` puts every shard on one device, a virtual mesh, as JAX's
CPU tests run eight virtual devices in one process; on one card every halo
exchange and global mask of the tier runs for real, but times taken that
way are the cost of the tier on one card, not scaling figures.  An explicit
device list puts one shard on each listed device.

``Mesh.route()`` is how the sharded tiers run their loops.  When every
shard sits on one device (``one_device``: the virtual mesh, every sharded
run one card can make) a solve, a chunk of NS steps or a physical step is
one ``core.loops.device_call``, on CUDA one CUDA graph with its loops as
conditional WHILE nodes, as JAX runs them on the device.  A CUDA graph
and its conditional nodes belong to one device, so a mesh over several
devices runs the same code under ``core.loops.host_mode()``: the plain
host loops, one host read a loop test, which is what that mesh ran before
the graphs.  No machine with several cards has run that route yet.
"""

from __future__ import annotations

import contextlib
import math

import torch

from fpr_tpu_torch.core import loops

AXES = ("z", "y", "x")


class Mesh:
    """A Cartesian grid of shards: ``shape`` maps each axis name to its
    extent (as ``jax.sharding.Mesh.shape``), shards are numbered row-major
    over the axes, and ``devices[i]`` holds shard i."""

    def __init__(self, dims, axis_names, devices):
        self.dims = tuple(int(d) for d in dims)
        self.axis_names = tuple(axis_names)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} and axis names {self.axis_names} differ "
                             "in length")
        if len(self.devices) != math.prod(self.dims):
            raise ValueError(f"mesh shape {self.dims} needs {math.prod(self.dims)} devices, "
                             f"got {len(self.devices)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        """Every shard sits on the same device."""
        return len(set(self.devices)) == 1

    def route(self):
        """The context a sharded tier runs its device calls in: graphs on one
        device, the host loops (``loops.host_mode()``) over several; see the
        module docstring."""
        return contextlib.nullcontext() if self.one_device else loops.host_mode()

    def extent(self, axis: str) -> int:
        """Shards along ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coords(self, shard: int) -> dict:
        """{axis name: index} of a shard."""
        out = {}
        for name, d in zip(reversed(self.axis_names), reversed(self.dims)):
            out[name] = shard % d
            shard //= d
        return {name: out[name] for name in self.axis_names}

    def shard(self, coords: dict) -> int:
        i = 0
        for name, d in zip(self.axis_names, self.dims):
            i = i * d + coords[name]
        return i

    def neighbor(self, shard: int, axis: str, step: int):
        """The shard ``step`` (+-1) away along ``axis``, or None past the
        global edge."""
        c = self.coords(shard)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return self.shard(c)

    def synchronize(self) -> None:
        """Wait for the work queued on every CUDA device of the mesh."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(shape=None, axis_names=None, devices=None, device="cuda") -> Mesh:
    """A Cartesian mesh (mesh.make_mesh).

    shape: the shard grid, e.g. (4,) or (2, 2, 2); by default one axis over
    the listed devices, or a single shard.  axis_names: by default the
    leading ``len(shape)`` of ('z', 'y', 'x').  devices: one device per
    shard (the first ``prod(shape)`` are used); None puts every shard on
    ``device``.
    """
    if shape is None:
        shape = (1,) if devices is None else (len(devices),)
    shape = tuple(int(s) for s in shape)
    need = math.prod(shape)
    if devices is None:
        devices = [torch.device(device)] * need
    else:
        devices = list(devices)
        if need > len(devices):
            raise ValueError(f"mesh shape {shape} needs {need} devices, have {len(devices)}")
        devices = devices[:need]
    if axis_names is None:
        axis_names = AXES[: len(shape)]
    return Mesh(shape, axis_names, devices)
