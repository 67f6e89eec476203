"""The port's shift-based prolongation (fpr_tpu_torch.ops.transfer.
prolongate_shifts) against JAX's, against the port's gather-form
``prolongate`` and against both packages' numpy scatter oracle
(``prolongate_scatter``), at JAX's shapes, in float64, with and without the
Neumann side copies.

Bound rtol = atol = 1e-14, tests/test_ops2d.py's for the same cross-check:
the three forms are linear in the coarse values with weights 1, 1/2 and
1/4, so they differ by the order of a few exact-weight additions only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import oracle as joracle
from fpr_tpu.ops import transfer as jtransfer
from fpr_tpu_torch.core import bc
from fpr_tpu_torch.ops import oracle, transfer

TOL = dict(rtol=1e-14, atol=1e-14)
SHAPES = [(9, 9), (5, 17), (9, 33)]


def _fine(shape):
    return (2 * (shape[0] - 1) + 1, 2 * (shape[1] - 1) + 1)


@pytest.mark.parametrize("apply_bcs", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_prolongate_shifts_matches_jax_gather_and_scatter(rng, shape, apply_bcs):
    coarse = rng.random(shape)
    fine_shape = _fine(shape)
    got = transfer.prolongate_shifts(torch.tensor(coarse), fine_shape, apply_bcs=apply_bcs)
    assert got.shape == fine_shape and got.dtype == torch.float64
    got = got.numpy()
    want = np.asarray(jtransfer.prolongate_shifts(jnp.asarray(coarse), fine_shape,
                                                  apply_bcs=apply_bcs))
    np.testing.assert_allclose(got, want, **TOL)
    gather = transfer.prolongate(torch.tensor(coarse), fine_shape, apply_bcs=apply_bcs).numpy()
    np.testing.assert_allclose(got, gather, **TOL)
    for scatter_of in (oracle.prolongate_scatter, joracle.prolongate_scatter):
        scatter = scatter_of(coarse, fine_shape)
        if apply_bcs:
            scatter = bc.neumann_left_right(torch.tensor(scatter)).numpy()
        np.testing.assert_allclose(got, scatter, **TOL)


def test_shift_fills_zeros(rng):
    """_shift moves values and fills with zeros (not a roll), as JAX's."""
    a = rng.random((5, 7))
    for dy, dx in [(1, 0), (-1, 0), (0, 1), (0, -1), (1, -1), (-1, 1)]:
        got = transfer._shift(torch.tensor(a), dy, dx).numpy()
        np.testing.assert_array_equal(got, np.asarray(jtransfer._shift(jnp.asarray(a), dy, dx)))
        assert not np.array_equal(got, np.roll(a, (dy, dx), axis=(0, 1)))


def test_only_interior_coarse_points_scatter():
    """A coarse value on the boundary ring contributes nothing."""
    coarse = np.zeros((5, 5))
    coarse[0, 2] = coarse[2, 0] = coarse[4, 4] = 1.0
    assert not transfer.prolongate_shifts(torch.tensor(coarse), (9, 9)).any()
