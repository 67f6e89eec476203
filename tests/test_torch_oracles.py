"""The port's own copies of the JAX package's test oracles
(fpr_tpu_torch.ops.oracle and fpr_tpu_torch.utils.native), which the card's
machine uses where JAX is absent.

- The scipy oracles: the difference from JAX's matrices has no nonzero
  entries; ``prolongate_scatter`` is bitwise JAX's (the same numpy loop).
- The native library is built by the port from ``native/*.cpp`` into
  ``build/``; its I/O and its three oracles are bitwise equal to
  ``fpr_tpu.utils.native``'s on the same numpy inputs (the same C code).
- The native third check: the port's float64 ``stencil2d.residual`` and
  ``jacobi_step`` against ``oracle_residual2d`` and ``oracle_jacobi2d``, and
  its ``stencil3d.dual_time_step`` against ``oracle_dual_time3d``, at
  tests/test_native.py's bounds (residual rtol 1e-13 with atol 1e-10 on
  values of size 1/h^2; the sweep atol 1e-13 and its norm rel 1e-12): the
  same arithmetic in another order of operations.
"""

import os

import numpy as np
import pytest
import torch

from fpr_tpu.ops import oracle as joracle
from fpr_tpu.utils import native as jnative
from fpr_tpu_torch.kernels import BUILD_DIR
from fpr_tpu_torch.ops import oracle, stencil2d, stencil3d
from fpr_tpu_torch.utils import native

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("name,args", [
    ("stencil_5pt", (7, 5)),
    ("helmholtz_operator", (7, 5, 1 / 8, 2.5)),
    ("stencil_7pt", (4, 5, 3)),
])
def test_scipy_oracles_match_jax(name, args):
    got, want = getattr(oracle, name)(*args), getattr(joracle, name)(*args)
    assert got.shape == want.shape
    assert (got - want).count_nonzero() == 0


def test_prolongate_scatter_is_bitwise_jax(rng):
    coarse = rng.random((9, 17))
    np.testing.assert_array_equal(oracle.prolongate_scatter(coarse, (17, 33)),
                                  joracle.prolongate_scatter(coarse, (17, 33)))


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ is present here: the port's native library must build"
    return lib


def test_native_library_builds_under_build(lib):
    path = native.library_path()
    assert path.exists() and path.parent == BUILD_DIR / "native"
    assert path.name != "libfpr_native.so"  # never the tracked prebuilt library


def test_native_io_is_bitwise_jax(lib, rng, tmp_path):
    w = os.path.join(FIX, "Winit.bin")
    np.testing.assert_array_equal(native.load_fortran_native(w), jnative.load_fortran_native(w))
    a = rng.random((17, 33))
    assert native.save_fortran_native(tmp_path / "port.bin", a)
    assert jnative.save_fortran_native(tmp_path / "jax.bin", a)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    np.testing.assert_array_equal(native.load_fortran_native(tmp_path / "port.bin"), a)


def test_native_oracles_are_bitwise_jax(lib, rng):
    u, f = rng.random((33, 65)), rng.random((33, 65))
    np.testing.assert_array_equal(native.oracle_residual2d(u, f, 1 / 32, 2.5),
                                  jnative.oracle_residual2d(u, f, 1 / 32, 2.5))
    got_u, got_ss = native.oracle_jacobi2d(u, f, 1 / 32, 0.5)
    want_u, want_ss = jnative.oracle_jacobi2d(u, f, 1 / 32, 0.5)
    np.testing.assert_array_equal(got_u, want_u)
    assert got_ss == want_ss
    ht, htau = rng.random((10, 12, 14)), rng.random((10, 12, 14))
    args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
    got, got_ss = native.oracle_dual_time3d(ht, htau, **args)
    want, want_ss = jnative.oracle_dual_time3d(ht, htau, **args)
    np.testing.assert_array_equal(got, want)
    assert got_ss == want_ss


def test_native_oracles_check_their_inputs(lib):
    with pytest.raises(ValueError, match="differ"):
        native.oracle_residual2d(np.zeros((5, 5)), np.zeros((5, 7)), 0.25, 0.0)
    with pytest.raises(ValueError, match="3 dimensions"):
        native.oracle_dual_time3d(np.zeros((5, 5)), np.zeros((5, 5)), 1, 1, 1, 1, 1, 1)


@pytest.mark.parametrize("c", [0.0, 2.5])
def test_native_third_check_residual(lib, rng, c):
    u, f = rng.random((33, 65)), rng.random((33, 65))
    got = stencil2d.residual(torch.tensor(u), torch.tensor(f), 1 / 32, c).numpy()
    np.testing.assert_allclose(got, native.oracle_residual2d(u, f, 1 / 32, c),
                               rtol=1e-13, atol=1e-10)


@pytest.mark.parametrize("c", [0.0, 2.5])
def test_native_third_check_jacobi(lib, rng, c):
    u, f = rng.random((33, 65)), rng.random((33, 65))
    got_u, got_rms = stencil2d.jacobi_step(torch.tensor(u), torch.tensor(f), 1 / 32, c)
    want_u, want_ss = native.oracle_jacobi2d(u, f, 1 / 32, c)
    np.testing.assert_allclose(got_u.numpy(), want_u, atol=1e-13)
    assert float(got_rms) == pytest.approx(np.sqrt(want_ss / u.size), rel=1e-12)


def test_native_third_check_dual_time(lib, rng):
    ht, htau = rng.random((10, 12, 14)), rng.random((10, 12, 14))
    args = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
    got, got_ss = stencil3d.dual_time_step(torch.tensor(ht), torch.tensor(htau), **args)
    want, want_ss = native.oracle_dual_time3d(ht, htau, **args)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-13)
    assert float(got_ss) == pytest.approx(want_ss, rel=1e-12)
