"""Build, load and bind the CUDA kernels of ``fpr_tpu_torch/csrc``.

The ``.cu`` sources have a plain C interface.  At the first call on a CUDA
tensor each is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library for ``sm_90a``, loaded
with ``ctypes``; nothing is built on import, so the package imports on a
CPU-only PyTorch.  The library is named by a hash of the sources and
flags, written to a temporary name first and moved into place with
``os.replace`` so that concurrent processes never load a half-written
file.  The library lands in ``build/fpr_tpu_torch/`` of
the checkout when the package runs from one (a ``pyproject.toml`` beside
it); an installed package builds under ``$XDG_CACHE_HOME/fpr_tpu_torch``
(default ``~/.cache/fpr_tpu_torch``) instead, so that environments sharing
an interpreter do not share a build directory.

``-fmad=false`` keeps every multiply and add a separately rounded IEEE
single operation: the double-single error-free transforms need it (see
``csrc/fpr_common.cuh``), and it makes the f32 kernels bitwise equal to
their plain PyTorch versions.

``launches`` counts, per kernel, the wrapper calls that launched the CUDA
kernel (never the plain-PyTorch calls), so a run can show which kernels
its main path went through.  ``dual_timek`` and ``dual_timek_padded``
count calls of the K-sweep wrappers (#10 and #9), each of which launches
the fused K-sweep kernel once per pass of at most ``K_MAX`` sweeps, and
``stencil`` calls of its wrappers (one launch a call, ``smooth2``
included), and ``stencil_<mode>`` the same calls by mode.
``smooth2r_split`` and ``corr_smooth2`` count the separate-buffer V-cycle
legs of the row-padded V-cycle, which launch the leg kernel of
``smooth_down`` and ``corr_up`` (one launch a call, all four).
``ns_fused_helm`` counts the NS operator kernel's launches in its
Helmholtz-defect mode, ``ns_fused`` the others.
A tested launch of #8 or #11 (part 1's loop test finished in the launch,
``LoopTestArgs``) is one launch of ``dual_time`` or ``ds3d``, as any other.

A wrapper called while ``core/loops.py`` captures a CUDA graph launches
nothing: the graph launches its kernel each time it runs, as often as its
loops go round.  ``core/loops.py`` takes such calls out of ``launches``
and adds them back per run of the graph, the ones inside a loop's body
times the passes a device counter saw, which ``sync_launches`` reads (one
host sync); ``reset_launches`` reads them first, so that a count set to 0
stays 0 until the next launch.  ``csrc/graph_loop.cu`` (the graphs'
conditional nodes) is built into the same library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

KERNELS = ("defect", "smooth_down", "corr_up", "ns_fused", "dual_time", "dual_timek", "ds3d",
           "stencil", "smooth2r_split", "corr_smooth2", "dual_timek_padded", "ns_fused_helm",
           "stencil_smooth", "stencil_smooth2", "stencil_residual", "stencil_matvec",
           "stencil_matvec_dot")
launches = dict.fromkeys(KERNELS, 0)

# the block shape of csrc/fpr_common.cuh (FPR_BX, FPR_BY); the 3D entry
# points check the partials length they are given against their grid
BX, BY = 32, 8
# the tile of the single-pass 2D kernels K1, K4 and #5 (fpr::TILE_* of
# csrc/fpr_common.cuh): TILE_X columns x TILE_WARPS * S rows, S <=
# TILE_S_MAX rows a thread, chosen per launch by tile_plan
TILE_X, TILE_WARPS, TILE_S_MAX = 32, 8, 4
# the sweeps of one launch of csrc/dual_timek.cu (KMAX), which refuses more;
# its grid and partials length come from fpr_dual_timek_blocks
K_MAX = 4

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    checkout = Path(__file__).resolve().parent.parent.parent
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "fpr_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "fpr_tpu_torch"


BUILD_DIR = _build_dir()
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-O3", "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "fpr_defect": [*[_P] * 6, _I, *[_F] * 4, _P, *[_F] * 3, *[_I] * 13, *[_P] * 7],
    "fpr_defect_fill": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "fpr_leg": [_P, _P, _P, _P, _F, _F, _F, *[_I] * 13, _P, _P, _P, _I, _P],
    "fpr_leg_blocks": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "fpr_ns_fused": [*[_P] * 7, *[_F] * 9, *[_I] * 9, *[_P] * 8],
    "fpr_ns_fill": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "fpr_dual_time": [_P, _P, _P, _P, _I, *[_F] * 6, *[_I] * 11, _P, _P],
    "fpr_dual_timek": [_P, _P, _P, _P, _I, *[_F] * 6, *[_I] * 7, _P, *[_I] * 4, _P],
    "fpr_dual_timek_blocks": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "fpr_ds3d": [_P, _P, _P, _P, _I, *[_F] * 10, _I, _I, _I, _P, _P],
    "fpr_stencil_f32": [_P, _P, _P, *[_F] * 4, *[_I] * 5, *[_P] * 5],
    "fpr_stencil_f64": [_P, _P, _P, *[_D] * 4, *[_I] * 5, *[_P] * 5],
    "fpr_stencil_fill": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "fpr_graph_create": [ctypes.POINTER(_P)],
    "fpr_graph_destroy": [_P],
    "fpr_graph_nodes": [_P, ctypes.POINTER(ctypes.c_size_t)],
    "fpr_graph_add_child": [_P, _P, _P, ctypes.POINTER(_P)],
    "fpr_graph_add_cond": [_P, _P, _I, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                           ctypes.POINTER(ctypes.c_ulonglong)],
    "fpr_graph_add_set": [_P, _P, ctypes.c_ulonglong, _P, _P, ctypes.POINTER(_P)],
    "fpr_graph_instantiate": [_P, ctypes.POINTER(_P)],
    "fpr_graph_launch": [_P, _P],
    "fpr_graph_exec_destroy": [_P],
    "fpr_graph_dot": [_P, ctypes.c_char_p],
}

_lib = None
_lock = threading.Lock()


# callables that add the launches of the graphs' past runs into `launches`
# (core/loops.py registers its one)
_device_counts = []


def sync_launches() -> dict:
    """``launches`` with every graph run so far counted in (a copy)."""
    for fold in _device_counts:
        fold()
    return dict(launches)


def reset_launches() -> None:
    sync_launches()
    for name in KERNELS:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the fpr_tpu_torch CUDA kernels "
        "cannot be built, and CUDA tensors have no other path"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfpr_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists: one
    nvcc per ``.cu`` file, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs, errors = [], []
        try:
            for src in sorted(CSRC.glob("*.cu")):
                obj = Path(tmp) / f"{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            for cmd, _, proc in jobs:
                _, stderr = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
        finally:
            for _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("\n".join(errors))
        lib_tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *GENCODE, "-shared", "-o", str(lib_tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(lib_tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


CUDA_ERROR_MEMORY_ALLOCATION = 2  # cudaErrorMemoryAllocation


def check(err: int, name: str) -> None:
    """Raise for a cudaError_t other than cudaSuccess: out of memory (a
    graph's instantiation, say) as torch's OutOfMemoryError, which
    ``core.loops.device_call`` answers by freeing cached graphs."""
    if err == CUDA_ERROR_MEMORY_ALLOCATION:
        raise torch.cuda.OutOfMemoryError(f"{name}: CUDA out of memory (cudaError_t {err})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def card_fill(fill: str, variant: int, device_index: int) -> tuple[int, int]:
    """(SMs, resident blocks an SM) of a kernel on a card, from the C entry
    point ``fill`` (fpr_defect_fill, fpr_ns_fill, fpr_stencil_fill) for the
    kernel's template ``variant``; read once per card."""
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(getattr(lib(), fill)(variant, ctypes.byref(sms), ctypes.byref(per_sm)), fill)
    return sms.value, per_sm.value


def tile_plan(ny: int, nx: int, sms: int, per_sm: int,
              s_max: int = TILE_S_MAX) -> tuple[int, int]:
    """(S, blocks) of a K1, K4 or #5 launch over (ny, nx) on a card of ``sms``
    SMs that hold ``per_sm`` blocks each: S rows a thread, the largest S up
    to ``s_max`` that still gives every block the card holds at once a tile
    (S = 1 where none does), and as many blocks as the card holds at once,
    at most one a tile, which take the tiles in turn.  On an H100 the
    largest such S was the fastest at 513 x 2049 and 4097^2 in K4, and in
    K1 up to 3 (PERF.md §6)."""
    slots = sms * per_sm
    S = max([s for s in range(1, s_max + 1) if n_tiles(ny, nx, s) >= slots], default=1)
    return S, min(n_tiles(ny, nx, S), slots)


def n_tiles(ny: int, nx: int, S: int) -> int:
    """Tiles of a K1, K4 or #5 launch over (ny, nx) with S rows a thread."""
    return -(-nx // TILE_X) * -(-ny // (TILE_WARPS * S))


_counters: dict = {}


def launch_counter(t: torch.Tensor, name: str = "sums") -> torch.Tensor:
    """The ticket word of in-launch sums for launches on t's device: one
    int32, 0 between launches (the last block of each launch re-arms it).
    ``"sums"`` serves K1, K4 and #5, ``"loop_test"`` the tested #8 and #11
    (``loop_test_args``).  One word per device and name serves every
    stream, the side stream a graph is captured on included: the port
    launches these kernels, eagerly or in a graph, on the device's current
    stream only, one launch after another (``parallel/mesh.py`` makes no
    streams: every shard of a virtual mesh launches on its device's current
    stream; the one side stream, ``parallel/dist_diffusion.py``'s, carries
    part 1's face copies only).  The word is made outside any capture (a
    graph's warm-up pass makes it), never in a graph's memory pool."""
    key = (t.device.index, name)
    word = _counters.get(key)
    if word is None:
        _refuse_capture(f"launch_counter({name!r})")
        word = _counters[key] = torch.zeros(1, dtype=torch.int32, device=t.device)
    return word


def _refuse_capture(what: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what}: the first launch on a device that uses it is being "
                           "captured; run the body once before capturing it")


class LoopTestArgs(ctypes.Structure):
    """csrc/fpr_common.cuh's fpr::LoopTest."""
    _fields_ = [("ticket", _P), ("sumsq", _P), ("err", _P), ("it", _P), ("go", _P),
                ("dt", _F), ("sqrt_n", _F), ("tol", _F), ("iter_max", _I)]


def loop_test_args(t: torch.Tensor, sumsq: torch.Tensor, test) -> LoopTestArgs:
    """The fpr::LoopTest of a tested launch (#8, #11) on t's device: the
    ticket word ``launch_counter(t, "loop_test")``, the launch's sum into
    sumsq, and test's err, it and go buffers and constants
    (``ops.dual_time.LoopTest``)."""
    return LoopTestArgs(
        launch_counter(t, "loop_test").data_ptr(), sumsq.data_ptr(), test.err.data_ptr(),
        test.it.data_ptr(), test.go.data_ptr(), test.dt, test.sqrt_n, test.tol,
        min(int(test.iter_max), 2**31 - 1))


def num_blocks_3d(nz: int, ny: int, nx: int) -> int:
    """Blocks of the 3D kernels' launch grid over an (nz, ny, nx) field:
    (nx/BX, ny/BY, nz), rounded up; the length of their partials buffer."""
    return -(-nx // BX) * -(-ny // BY) * nz


def partials_3d(shape, device) -> torch.Tensor | None:
    """The float32 partials buffer of a 3D kernel over an (nz, ny, nx) field,
    for a caller that reuses one across calls; None on the CPU, where the
    plain versions take none.  Every block writes its entry: no zeroing."""
    if torch.device(device).type == "cpu":
        return None
    return torch.empty(num_blocks_3d(*shape), dtype=torch.float32, device=device)


def require_cuda_f32(name: str, *tensors) -> None:
    """Device, dtype and layout checks before pointers go to a kernel."""
    require_cuda(name, (torch.float32,), *tensors)


def require_cuda(name: str, dtypes, *tensors) -> None:
    """require_cuda_f32 for a kernel that takes the given dtypes; all the
    tensors must share one of them."""
    dev, dtype = None, None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if t.dtype not in dtypes or (dtype is not None and t.dtype != dtype):
            takes = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name}: the CUDA kernel takes {takes} tensors of one dtype, "
                             f"got {t.dtype}")
        dtype = t.dtype
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
