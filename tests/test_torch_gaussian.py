"""The diffusion entry's Gaussian initial field: the card build
(``stencil3d.gaussian_slabs``) against the numpy build, and the route
``init_gaussian`` takes.

The file imports no JAX, so its card tests run on a machine that has none
(skipping without a CUDA device; ``-s`` prints the float64 cells that the
card's exp changed):

    python -m pytest --noconftest -p no:cacheprovider -m card -s tests/test_torch_gaussian.py
"""

import numpy as np
import pytest
import torch

from fpr_tpu_torch.core import bc
from fpr_tpu_torch.core.config import DiffusionConfig
from fpr_tpu_torch.core.grid import Grid3D
from fpr_tpu_torch.models import diffusion3d
from fpr_tpu_torch.ops import stencil3d

OFFSETS = (2.5, -1.25, 7.0)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card build runs only there")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64).numpy()


def _builds():
    return stencil3d.builds["gaussian.card"], stencil3d.builds["gaussian.host"]


# one slab, and slabs of 7 planes with a ragged last one
@pytest.mark.parametrize("slab_bytes", [stencil3d.GAUSSIAN_SLAB_BYTES, 8 * 48 * 64 * 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_formula_matches_numpy_build(dtype, slab_bytes):
    """float32 bitwise; float64 within 1 ulp (torch's exp against numpy's)."""
    g = Grid3D(64, 48, 40)
    got = stencil3d.gaussian_slabs(g, dtype, *OFFSETS, device="cpu", slab_bytes=slab_bytes)
    want = stencil3d.init_gaussian(g, dtype, *OFFSETS, device="cpu")
    assert got.shape == want.shape == (40, 48, 64) and got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_builds_take_host_route(dtype):
    before = _builds()
    stencil3d.init_gaussian(Grid3D(8, 6, 5), dtype, device="cpu")
    card, host = _builds()
    assert (card - before[0], host - before[1]) == (0, 1)


@pytest.mark.parametrize("device, dtype, on_card", [
    ("cuda", torch.float32, True),
    (torch.device("cuda", 0), torch.float32, True),
    ("cuda", torch.float64, False),
    ("cpu", torch.float32, False),
])
def test_route(device, dtype, on_card):
    assert stencil3d._on_card(device, dtype) is on_card


@pytest.mark.card
@pytest.mark.parametrize("n", [128, 512])
def test_card_field_bitwise_equals_numpy_build(card, n):
    """The cells' grids: the float32 field after the Dirichlet faces equal
    to the numpy build's bits, 0 cells differing; the float64 cells that
    differ before the cast are printed."""
    g = Grid3D(n, n, n)
    before = _builds()
    got = _bits(bc.dirichlet_faces_3d(stencil3d.init_gaussian(g, torch.float32, device=card)))
    assert _builds()[0] == before[0] + 1
    want = _bits(bc.dirichlet_faces_3d(stencil3d.init_gaussian(g, torch.float32, device="cpu")))
    n32 = int(np.count_nonzero(got != want))
    del got, want
    got64 = _bits(stencil3d.gaussian_slabs(g, torch.float64, device=card))
    want64 = _bits(stencil3d.init_gaussian(g, torch.float64, device="cpu"))
    ulps = np.abs(got64 - want64)
    print(f"\ngaussian {n}^3 on {torch.cuda.get_device_name(card)}: float32 cells "
          f"differing {n32} of {n ** 3}; float64 cells differing {np.count_nonzero(ulps)}, "
          f"largest {ulps.max()} ulp")
    assert n32 == 0


@pytest.mark.card
def test_solve_builds_field_on_card(card):
    before = _builds()
    diffusion3d.solve(DiffusionConfig(ttot=0.2, tol=1e-6), device=card)
    card_n, host_n = _builds()
    assert (card_n - before[0], host_n - before[1]) == (1, 0)
