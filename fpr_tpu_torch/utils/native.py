"""ctypes bindings to the native C++ library of the checkout's ``native/``
(fpr_tpu/utils/native.py, with its C interface and Python signatures):
Fortran field I/O and an independent double-precision stencil oracle (the
2D residual and damped-Jacobi sweep, one 3D dual-time iteration), written
without shared code with either package.

The library is compiled from ``native/fortran_io.cpp`` and
``native/stencil_oracle.cpp`` by ``g++`` at first use, into
``build/fpr_tpu_torch/native/`` beside the CUDA kernels' library
(``kernels.BUILD_DIR``), named by a hash of the sources and flags and moved
into place only when whole.  A prebuilt ``native/libfpr_native.so`` is never
loaded, and ``make`` is never run.  These oracles run on the host, never on
a solver's path; ``get_lib()`` is None where the sources or ``g++`` are
missing, and the oracles then raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from fpr_tpu_torch.kernels import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("fortran_io.cpp", "stencil_oracle.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None
_build_failed = False
_lock = threading.Lock()

_D = ctypes.c_double
_DP = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.c_int32
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "fio_probe": ([ctypes.c_char_p, _I32P, _I32P], ctypes.c_int),
    "fio_read": ([ctypes.c_char_p, _DP, _I32, _I32], ctypes.c_int),
    "fio_write": ([ctypes.c_char_p, _DP, _I32, _I32], ctypes.c_int),
    "oracle_residual2d": ([_DP, _DP, _D, _D, _I32, _I32, _DP], None),
    "oracle_jacobi2d": ([_DP, _DP, _D, _D, _D, _I32, _I32, _DP], _D),
    "oracle_dual_time3d": ([_DP, _DP, _D, _D, _D, _D, _D, _D, _I32, _I32, _I32, _DP], _D),
}


def library_path() -> Path:
    """Where the library of the present sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / "native" / f"libfpr_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources with g++ unless a library of the same hash
    exists; raise if g++ or the sources are missing or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native oracle library cannot be built")
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, building it if necessary; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native oracle library is unavailable (no g++ or no native/)")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def _f64(a, ndim: int, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {a.shape}")
    return a


def load_fortran_native(path) -> np.ndarray | None:
    """The (ny, nx) float64 field of a Fortran record file; None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    nx, ny = ctypes.c_int32(), ctypes.c_int32()
    if lib.fio_probe(str(path).encode(), ctypes.byref(nx), ctypes.byref(ny)):
        raise IOError(f"cannot read header of {path}")
    out = np.empty((ny.value, nx.value), dtype=np.float64)
    if lib.fio_read(str(path).encode(), _ptr(out), nx, ny):
        raise IOError(f"short read in {path}")
    return out


def save_fortran_native(path, arr: np.ndarray) -> bool:
    """Write arr as a Fortran record file; False without the library."""
    lib = get_lib()
    if lib is None:
        return False
    a = _f64(arr, 2, "save_fortran_native")
    ny, nx = a.shape
    if lib.fio_write(str(path).encode(), _ptr(a), nx, ny):
        raise IOError(f"cannot write {path}")
    return True


def oracle_residual2d(u, f, h, c):
    """(u_E + u_W + u_N + u_S - (4 + c h^2) u) / h^2 - f on the interior, 0
    on the ring."""
    lib = _require()
    u, f = _f64(u, 2, "oracle_residual2d"), _f64(f, 2, "oracle_residual2d")
    if f.shape != u.shape:
        raise ValueError(f"oracle_residual2d: shapes {u.shape} and {f.shape} differ")
    res = np.empty_like(u)
    ny, nx = u.shape
    lib.oracle_residual2d(_ptr(u), _ptr(f), h, c, ny, nx, _ptr(res))
    return res


def oracle_jacobi2d(u, f, h, c, alpha=0.8):
    """One damped-Jacobi sweep from u; returns (u', sum of the residual's
    squares)."""
    lib = _require()
    u, f = _f64(u, 2, "oracle_jacobi2d").copy(), _f64(f, 2, "oracle_jacobi2d")
    if f.shape != u.shape:
        raise ValueError(f"oracle_jacobi2d: shapes {u.shape} and {f.shape} differ")
    scratch = np.empty_like(u)
    ny, nx = u.shape
    sumsq = lib.oracle_jacobi2d(_ptr(u), _ptr(f), h, c, alpha, ny, nx, _ptr(scratch))
    return u, sumsq


def oracle_dual_time3d(ht, htau, dt, dtau, dx, dy, dz, D):
    """One pseudo-transient 3D diffusion iteration; returns (htau', sum of
    the pseudo-time residual's squares)."""
    lib = _require()
    ht, htau = _f64(ht, 3, "oracle_dual_time3d"), _f64(htau, 3, "oracle_dual_time3d")
    if ht.shape != htau.shape:
        raise ValueError(f"oracle_dual_time3d: shapes {ht.shape} and {htau.shape} differ")
    out = np.empty_like(htau)
    nz, ny, nx = ht.shape
    sumsq = lib.oracle_dual_time3d(_ptr(ht), _ptr(htau), dt, dtau, dx, dy, dz, D, nz, ny, nx,
                                   _ptr(out))
    return out, sumsq
