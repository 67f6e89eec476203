"""The row hooks of the 2D kernels for the row-sharded tier (the TPU kernels'
``row_off``/``ny_mask``: fpr_tpu/ops/ds.py:575-641,
fpr_tpu/ops/pallas2d.py:547-573 and 802-825, fpr_tpu/ops/pallas_ns.py:431-495).

A shard's local tensor is (G + ny_l + G, nx): its ny_l owned rows and G
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
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    off: int                # global row of local row 0
    ny: int                 # global row count
    own: tuple[int, int]    # the owned local rows [own[0], own[1])

    @classmethod
    def whole(cls, ny: int) -> "Rows":
        return cls(0, ny, (0, ny))

    def args(self) -> tuple[int, int, int, int]:
        """(row_off, ny_g, own0, own1), the kernels' integer arguments."""
        return (self.off, self.ny, self.own[0], self.own[1])

    def global_rows(self, rows: int, device) -> torch.Tensor:
        return self.off + torch.arange(rows, device=device)

    def interior(self, rows: int, device) -> torch.Tensor:
        """(rows,) bool: rows whose global index is interior and that have
        both neighbours in the local tensor."""
        g = self.global_rows(rows, device)
        y = torch.arange(rows, device=device)
        return (g > 0) & (g < self.ny - 1) & (y > 0) & (y < rows - 1)

    def physical(self, rows: int, device) -> torch.Tensor:
        """(rows,) bool: rows inside the global grid."""
        g = self.global_rows(rows, device)
        return (g >= 0) & (g < self.ny)

    def owned_physical(self, rows: int) -> slice:
        """The owned local rows that lie inside the global grid."""
        return slice(max(self.own[0], -self.off), min(self.own[1], self.ny - self.off))


def check(name: str, rows: Rows, n_local: int) -> None:
    if not 0 <= rows.own[0] <= rows.own[1] <= n_local or rows.ny < 3:
        raise ValueError(f"{name}: row hooks {rows} do not fit {n_local} local rows")
