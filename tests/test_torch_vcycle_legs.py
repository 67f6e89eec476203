"""The port's V-cycle legs (fpr_tpu_torch.ops.vcycle_legs: smooth_down, K2;
corr_up, K3) against fpr_tpu.ops.pallas2d.smooth2r_stk / corr_smooth2_stk,
run in interpret mode on the CPU, where the port runs its plain versions.

Tolerances: XLA:CPU contracts a*b+c into an FMA inside jit (and interpret
mode runs inside jit), eager PyTorch does not, so the two differ by a few
ulps per operation.  The residual cancels terms of size max|u| C/h^2, so
it is held to 64 ulps of that scale plus 64 ulps of max|f|; the iterate to
64 ulps of max|u|.  The rms norm, a sum in another order, to 1e-5
relative in float32.  The legs are dtype-generic: in float64 the same
bounds in float64 ulps make a bar near 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import pallas2d
from fpr_tpu.ops import transfer as jtransfer
from fpr_tpu_torch.ops import transfer
from fpr_tpu_torch.ops import vcycle_legs as legs

SHAPES = [(129, 129), (65, 257)]
DTYPE_NS = [(np.float32, 1), (np.float32, 3), (np.float32, 5), (np.float64, 3)]


def _setup(rng, shape, dtype):
    ny, nx = shape
    h = 1.0 / (min(ny, nx) - 1)
    br = pallas2d._pick_br(ny, nx, np.dtype(dtype).itemsize)
    total, nxp = pallas2d.padded_rows(ny, br), pallas2d.padded_cols(nx)
    f = rng.standard_normal(shape).astype(dtype)
    u = rng.standard_normal(shape).astype(dtype)
    L = (jnp.zeros((2, total, nxp), dtype)
         .at[0].set(pallas2d.pad2d(jnp.asarray(u), br))
         .at[1].set(pallas2d.pad2d(jnp.asarray(f), br)))
    return h, br, f, u, L


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _scale(u, h, c, f):
    return np.abs(u).max() * (4.0 + c * h * h) / (h * h) + np.abs(f).max()


@pytest.mark.parametrize("dtype,ns", DTYPE_NS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("zero_u,elim,c", [(True, False, 0.0), (False, False, 0.7),
                                           (True, True, 900.0), (False, True, 0.0)])
def test_smooth_down_matches_smooth2r_stk(rng, dtype, shape, ns, zero_u, elim, c):
    ny, nx = shape
    h, br, f, u, L = _setup(rng, shape, dtype)
    L1, res_ps = pallas2d.smooth2r_stk(L, ny, nx, br, h, c, zero_u=zero_u, ns=ns,
                                       elim=elim)
    u_j = np.asarray(pallas2d.unpad2d(L1[0], ny, nx))
    rc_j = np.asarray(jtransfer.restrict_ps(res_ps, ny, nx, br))
    u_t, res_t = legs.smooth_down(None if zero_u else torch.tensor(u), torch.tensor(f),
                                  h, c, ns=ns, elim=elim)
    rc_t = transfer.restrict(res_t).numpy()
    eps = _eps(dtype)
    ref_u = np.abs(u).max() if not zero_u else np.abs(u_j).max()
    assert np.abs(u_t.numpy() - u_j).max() <= 64 * eps * ref_u
    assert np.abs(rc_t - rc_j).max() <= 64 * eps * _scale(u_j, h, c, f)
    if elim:
        got = u_t.numpy()
        np.testing.assert_array_equal(got[:, 0], got[:, 1])
        np.testing.assert_array_equal(got[:, -1], got[:, -2])


@pytest.mark.parametrize("dtype,ns", DTYPE_NS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("elim,apply_bcs,c", [(False, False, 0.7), (True, True, 900.0)])
def test_corr_up_matches_corr_smooth2_stk(rng, dtype, shape, ns, elim, apply_bcs, c):
    ny, nx = shape
    h, br, f, u, L = _setup(rng, shape, dtype)
    nyc, nxc = (ny - 1) // 2 + 1, (nx - 1) // 2 + 1
    coarse = rng.standard_normal((nyc, nxc)).astype(dtype) * 1e-2
    corrx = pallas2d.x_interleave_coarse(jnp.asarray(coarse), apply_bcs=apply_bcs)
    corrx_rp = (jnp.zeros((pallas2d.corr_rows_needed(ny, br), pallas2d.padded_cols(nx)),
                          dtype)
                .at[pallas2d.PAD:pallas2d.PAD + nyc, :nx].set(corrx))
    L3, n3 = pallas2d.corr_smooth2_stk(L, corrx_rp, ny, nx, br, h, c, with_norm=True,
                                       ns=ns, elim=elim)
    cx_t = transfer.x_interleave_coarse(torch.tensor(coarse), apply_bcs=apply_bcs)
    np.testing.assert_array_equal(cx_t.numpy(), np.asarray(corrx))
    out = torch.full((ny, nx), float("nan"), dtype=cx_t.dtype)
    u_t, n_t = legs.corr_up(torch.tensor(u), torch.tensor(f), cx_t, h, c, ns=ns,
                            elim=elim, with_norm=True, out=out)
    assert u_t is out
    eps = _eps(dtype)
    assert np.abs(u_t.numpy() - np.asarray(pallas2d.unpad2d(L3[0], ny, nx))).max() \
        <= 64 * eps * np.abs(u).max()
    rel = 1e-5 if dtype == np.float32 else 1e-12
    assert abs(float(n_t) - float(n3)) <= rel * float(n3)


def test_prolong_y_is_the_y_half_of_prolongate(rng):
    """x_interleave_coarse then the y interpolation equals the bilinear
    prolongation up to the order of the midpoint sums: bitwise in float64
    on exactly representable inputs."""
    coarse = torch.tensor(rng.integers(-64, 64, (17, 33)) / 8.0)
    P = legs.prolong_y(transfer.x_interleave_coarse(coarse), 33)
    torch.testing.assert_close(P, transfer.prolongate(coarse, (33, 65)), rtol=0, atol=0)


def test_corr_up_rejects_aliased_output(rng):
    u = torch.zeros((9, 9))
    with pytest.raises(ValueError, match="alias"):
        legs.corr_up(u, u, torch.zeros((5, 9)), 0.125, 0.0, out=u)
