"""I/O of the port (fpr_tpu/utils/io.py, kept here so that the port imports
nothing of the JAX package).

- ``load_fortran`` / ``save_fortran``: the reference's Fortran binary field
  format, int32 nx, int32 ny, then float64 data in column-major (nx, ny)
  order, as a row-major (ny, nx) array; a round trip is bit-exact.
- ``append_csv_row``, ``update_csv_row``, ``csv_has_row``,
  ``csv_has_rows``: CSV rows written under an exclusive ``fcntl`` lock,
  with resume by key (a row whose key fields already exist is skipped).
  They write the same bytes as the JAX package's functions, so the two
  packages can share a file.
"""

from __future__ import annotations

import csv
import fcntl
import os
from pathlib import Path

import numpy as np


def load_fortran(path) -> np.ndarray:
    """Read an (nx, ny) column-major float64 field as a (ny, nx) array."""
    with open(path, "rb") as f:
        nx = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        ny = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        data = np.fromfile(f, dtype=np.float64, count=nx * ny)
    if data.size != nx * ny:
        raise ValueError(f"{path}: expected {nx}x{ny} f64 payload, got {data.size}")
    # column-major (nx, ny) memory order == row-major (ny, nx)
    return data.reshape(ny, nx)


def save_fortran(path, arr: np.ndarray) -> None:
    """Write a (ny, nx) array in the reference's binary format."""
    ny, nx = arr.shape
    with open(path, "wb") as f:
        np.asarray([nx], dtype=np.int32).tofile(f)
        np.asarray([ny], dtype=np.int32).tofile(f)
        np.ascontiguousarray(arr, dtype=np.float64).tofile(f)


def append_csv_row(path, row: dict, key_fields=()) -> bool:
    """Append a row under an exclusive lock, unless a row with the same
    key_fields values exists.  Returns True if the row was written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a+", newline="") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            f.seek(0)
            existing = list(csv.DictReader(f))
            if key_fields:
                key = tuple(str(row[k]) for k in key_fields)
                if any(tuple(r.get(k, "") for k in key_fields) == key for r in existing):
                    return False
            f.seek(0, os.SEEK_END)
            if f.tell() == 0:
                writer = csv.DictWriter(f, fieldnames=list(row.keys()))
                writer.writeheader()
            else:
                # the existing header's order; a field it lacks is an error
                f.seek(0)
                header = next(csv.reader(f))
                missing = [k for k in row if k not in header]
                if missing:
                    raise ValueError(
                        f"{path}: row fields {missing} not in existing header {header}")
                f.seek(0, os.SEEK_END)
                writer = csv.DictWriter(f, fieldnames=header, restval="")
            writer.writerow(row)
            return True
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def update_csv_row(path, key: dict, updates: dict) -> bool:
    """Update the first row matching every key field, in place, under the
    same lock.  New fields join the header (older rows get "").  Returns
    True if a row was updated."""
    path = Path(path)
    if not path.exists():
        return False
    with open(path, "r+", newline="") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            rows = list(csv.DictReader(f))
            f.seek(0)
            header = next(csv.reader(f))
            for r in rows:
                if all(r.get(k, "") == str(v) for k, v in key.items()):
                    r.update({k: str(v) for k, v in updates.items()})
                    break
            else:
                return False
            header = header + [k for k in updates if k not in header]
            f.seek(0)
            f.truncate()
            writer = csv.DictWriter(f, fieldnames=header, restval="")
            writer.writeheader()
            writer.writerows(rows)
            return True
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def csv_has_row(path, key: dict) -> bool:
    """True if a row matching every key field exists: check before running
    a costly configuration."""
    path = Path(path)
    if not path.exists():
        return False
    with open(path) as f:
        return any(all(r.get(k, "") == str(v) for k, v in key.items())
                   for r in csv.DictReader(f))


def csv_has_rows(path) -> bool:
    path = Path(path)
    if not path.exists():
        return False
    with open(path) as f:
        return next(csv.DictReader(f), None) is not None
