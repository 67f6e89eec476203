"""The shard hooks of the 2D kernels: the row hooks of the row-sharded tier
(the TPU kernels' ``row_off``/``ny_mask``: fpr_tpu/ops/ds.py:575-641,
fpr_tpu/ops/pallas2d.py:547-573 and 802-825, fpr_tpu/ops/pallas_ns.py:431-495)
and the column hooks of the 2D (y, x) mesh (``col_off``/``nx_mask`` and
K1's ``own_lanes``: ds.py:355-372, pallas2d.py:547-573 and 802-825).

A row shard's local tensor is (G + ny_l + G, nx): its ny_l owned rows and G
ghost rows on each side, holding the neighbours' rows after a refresh.
Local row y is global row ``off + y`` of an ``ny``-row grid.  The kernels
mask by the global row (the Dirichlet rows, the interior) and also leave
out the local tensor's first and last row, whose outer neighbour is
missing; they update every other row, ghost rows included, so the owned
rows come out as the single-device rows do, bitwise, and the rows a sweep
leaves stale are outer ghost rows that the next refresh overwrites.
Reductions (sums, maxima) cover the owned rows ``[own[0], own[1])`` only,
so each global cell counts once across shards.  ``Rows.whole(ny)`` is the
single-device case: every row owned, local = global.

``Cols`` is the same for the columns of a 2D-mesh shard, (GX + nx_l + GX)
wide: local column x is global column ``off + x`` of an ``nx``-column grid
(``off`` is negative on the left edge), the interior needs a global
interior column and leaves out the local first and last column, and the
reductions cover the owned columns only: a ghost column is an interior
cell that the x-neighbour owns, and summing it twice would report a norm
that the field does not have.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class _Span:
    off: int                # global index of local index 0
    n: int                  # global count
    own: tuple[int, int]    # the owned local indices [own[0], own[1])

    @classmethod
    def whole(cls, n: int):
        return cls(0, n, (0, n))

    def is_whole(self, n_local: int) -> bool:
        return self == type(self).whole(n_local)

    def args(self) -> tuple[int, int, int, int]:
        """(off, n, own0, own1), the kernels' integer arguments."""
        return (self.off, self.n, self.own[0], self.own[1])

    def global_idx(self, n_local: int, device) -> torch.Tensor:
        return self.off + torch.arange(n_local, device=device)

    def interior(self, n_local: int, device) -> torch.Tensor:
        """(n_local,) bool: indices whose global index is interior and that
        have both neighbours in the local tensor."""
        g = self.global_idx(n_local, device)
        i = torch.arange(n_local, device=device)
        return (g > 0) & (g < self.n - 1) & (i > 0) & (i < n_local - 1)

    def physical(self, n_local: int, device) -> torch.Tensor:
        """(n_local,) bool: indices inside the global grid."""
        g = self.global_idx(n_local, device)
        return (g >= 0) & (g < self.n)

    def owned(self, n_local: int, device) -> torch.Tensor:
        """(n_local,) bool: the owned indices."""
        i = torch.arange(n_local, device=device)
        return (i >= self.own[0]) & (i < self.own[1])

    def owned_physical(self, n_local: int) -> slice:
        """The owned local indices that lie inside the global grid."""
        return slice(max(self.own[0], -self.off), min(self.own[1], self.n - self.off))


class Rows(_Span):
    """Row hooks: Rows(off, ny, own)."""

    @property
    def ny(self) -> int:
        return self.n

    def global_rows(self, rows: int, device) -> torch.Tensor:
        return self.global_idx(rows, device)


class Cols(_Span):
    """Column hooks: Cols(off, nx, own)."""

    @property
    def nx(self) -> int:
        return self.n


def check(name: str, hooks: _Span, n_local: int) -> None:
    if not 0 <= hooks.own[0] <= hooks.own[1] <= n_local or hooks.n < 3:
        raise ValueError(f"{name}: shard hooks {hooks} do not fit {n_local} local indices")


def check_cols(name: str, cols, n_local: int, **whole_only) -> None:
    """check() for column hooks; an option of ``whole_only`` that is set
    (elim, apply_bcs: their side columns are local) needs whole columns,
    and the offset must be even, as the row offset (the transfers' column
    parity)."""
    if cols is None:
        return
    check(name, cols, n_local)
    if cols.off % 2:
        raise ValueError(f"{name}: the column offset {cols.off} must be even")
    for opt, on in whole_only.items():
        if on and not cols.is_whole(n_local):
            raise ValueError(f"{name}: {opt} is not defined under column hooks {cols}")
