"""Halo exchange between the shards of a mesh (fpr_tpu/parallel/halo.py:
exchange_faces, refresh_ghosts_ext, mask_bounds, refresh_ghosts_zk, and
fpr_tpu/solvers/dist_mg_ds.py: _refresh, _refresh_x and _refresh2d as
``refresh_rows``, ``refresh_cols`` and ``refresh_2d``).

Each function takes the list of per-shard tensors of one field, in the
mesh's shard order.  A JAX ``ppermute`` of a face becomes a copy of the
neighbour's face into this shard's ghost slot, through ``Tensor.copy_``
with ``non_blocking=True``, so that a mesh over several cards works
unchanged; a ghost slot at the global edge gets zeros, as ``ppermute``
zero-fills a destination that no source lists.  Faces are read from
physical cells and ghosts written, so no copy reads what another writes.
The refresh functions update the blocks in place.
"""

from __future__ import annotations

import torch


def _put(dst: torch.Tensor, src) -> None:
    """dst <- src, or zeros where src is None (a global edge)."""
    if src is None:
        dst.zero_()
    else:
        dst.copy_(src, non_blocking=True)


def _slab(t: torch.Tensor, dim: int, start: int, length: int, inner: bool = False):
    """t's slab [start, start+length) along dim; ``inner`` drops the first
    and last cell of every other dim."""
    idx = [slice(1, -1) if inner else slice(None)] * t.dim()
    idx[dim] = slice(start, start + length)
    return t[tuple(idx)]


def exchange_faces(blocks, mesh, axis: str, dim: int):
    """The one-cell faces along array dim ``dim``, decomposed over mesh axis
    ``axis``: returns (ghost_lo, ghost_hi), per shard the neighbour faces for
    local index -1 and n (new tensors; zeros at the global edges)."""
    lo, hi = [], []
    for i, b in enumerate(blocks):
        below, above = mesh.neighbor(i, axis, -1), mesh.neighbor(i, axis, +1)
        g_lo = torch.empty_like(_slab(b, dim, 0, 1))
        g_hi = torch.empty_like(g_lo)
        if below is not None:
            nb = blocks[below]
            _put(g_lo, _slab(nb, dim, nb.shape[dim] - 1, 1))
        else:
            _put(g_lo, None)
        _put(g_hi, None if above is None else _slab(blocks[above], dim, 0, 1))
        lo.append(g_lo)
        hi.append(g_hi)
    return lo, hi


def refresh_ghosts_ext(blocks, mesh, sharded: dict) -> None:
    """Refresh the ghost shells of fully ghost-padded (n+2 per dim) blocks:
    sharded maps an array dim to its mesh axis; unsharded dims keep their
    zero ghosts (the global Dirichlet outside).  Only each face's inner part
    is written: the 7-point stencil never reads a ghost edge or corner,
    which stay zero."""
    for dim, axis in sharded.items():
        for i, b in enumerate(blocks):
            n = b.shape[dim]
            below, above = mesh.neighbor(i, axis, -1), mesh.neighbor(i, axis, +1)
            _put(_slab(b, dim, 0, 1, inner=True),
                 None if below is None else _slab(blocks[below], dim, n - 2, 1, inner=True))
            _put(_slab(b, dim, n - 1, 1, inner=True),
                 None if above is None else _slab(blocks[above], dim, 1, 1, inner=True))


def mask_bounds(mesh, shard: int, axis, n_local: int):
    """(lo, hi): the inclusive local range of updateable cells along one
    dimension.  An interior shard updates everything; a global-edge shard
    leaves out the physical boundary layer.  axis None: unsharded, both
    edges global."""
    if axis is None:
        return 1, n_local - 2
    lo = 1 if mesh.neighbor(shard, axis, -1) is None else 0
    hi = n_local - 2 if mesh.neighbor(shard, axis, +1) is None else n_local - 1
    return lo, hi


def refresh_ghosts_zk(blocks, mesh, nz: int, axis: str, K: int, base: int | None = None) -> None:
    """Refresh the K-deep z ghost planes of K-ghost-padded blocks (physical
    planes at [base, base+nz), base defaulting to K): one K-plane copy per
    direction feeds K fused pseudo-time iterations."""
    base = K if base is None else base
    if K == 0:
        return
    for i, b in enumerate(blocks):
        below, above = mesh.neighbor(i, axis, -1), mesh.neighbor(i, axis, +1)
        _put(b[base - K:base], None if below is None else blocks[below][base + nz - K:base + nz])
        _put(b[base + nz:base + nz + K], None if above is None else blocks[above][base:base + K])


def refresh_rows(blocks, mesh, axis: str, ny_l: int, G: int) -> None:
    """Refresh the G ghost rows on each side of row-sharded blocks
    (..., G + ny_l + G, nx), rows at dim -2 (dist_mg_ds._refresh with G for
    PAD): the top slot takes the upper neighbour's last G physical rows, the
    bottom slot the lower neighbour's first G.  This also overwrites the
    stale ghost rows of a fresh kernel output."""
    for i, b in enumerate(blocks):
        up, dn = mesh.neighbor(i, axis, -1), mesh.neighbor(i, axis, +1)
        _put(b[..., 0:G, :], None if up is None else blocks[up][..., ny_l:ny_l + G, :])
        _put(b[..., G + ny_l:2 * G + ny_l, :],
             None if dn is None else blocks[dn][..., G:2 * G, :])


def refresh_cols(blocks, mesh, axis: str, nx_l: int, GX: int) -> None:
    """Refresh the GX ghost columns on each side of column-sharded blocks
    (..., GX + nx_l + GX), columns at dim -1, over every row
    (dist_mg_ds._refresh_x with GX for CPAD): the left slot takes the left
    neighbour's last GX owned columns, the right slot the right neighbour's
    first GX.  Each face is a strided slab, copied by one ``copy_``."""
    for i, b in enumerate(blocks):
        lf, rt = mesh.neighbor(i, axis, -1), mesh.neighbor(i, axis, +1)
        _put(b[..., 0:GX], None if lf is None else blocks[lf][..., nx_l:nx_l + GX])
        _put(b[..., GX + nx_l:2 * GX + nx_l],
             None if rt is None else blocks[rt][..., GX:2 * GX])


def refresh_2d(blocks, mesh, axes, ny_l: int, nx_l: int, G: int, GX: int) -> None:
    """Refresh the ghost ring of 2D-sharded blocks (..., G + ny_l + G,
    GX + nx_l + GX) over the mesh axes (ay, ax) (dist_mg_ds._refresh2d):
    columns first, then full-width rows, so that the row faces carry the
    y-neighbour's fresh ghost columns and the corner ghosts hold the
    diagonal neighbour's cells.  Global edges get zeros."""
    ay, ax = axes
    refresh_cols(blocks, mesh, ax, nx_l, GX)
    refresh_rows(blocks, mesh, ay, ny_l, G)
