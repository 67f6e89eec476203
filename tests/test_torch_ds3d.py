"""The port's double-single pseudo-time kernel (fpr_tpu_torch.ops.ds3d)
against fpr_tpu.ops.ds3d on the CPU, where the port runs the kernel's
plain PyTorch version and the Pallas kernel runs in interpret mode.  The
same state goes to both sides through the port's layout converters.

Tolerances: the iteration is double-single arithmetic, exact to about
2^-48 of the field; XLA:CPU may contract multiply-adds inside jit where
eager PyTorch rounds each operation, which moves the pair's last bits, so
hi + lo agree to 2^-44 of max|H| over 3 iterations.  sum(dH_hi^2) is a
float32 sum in another order: 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import ds3d as jds3d
from fpr_tpu_torch.ops import ds3d

ARGS = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)


def _pair_inputs(rng, shape):
    H = torch.tensor(rng.random(shape))
    return ds3d.to_ds(H), ds3d.to_ds(H + 1e-3 * torch.tensor(rng.standard_normal(shape)))


def test_plain_step_matches_jax(rng):
    shape = (8, 12, 20)
    Ht, Htau = _pair_inputs(rng, shape)
    Ht_j = jnp.asarray(ds3d.state_to_jax(Ht, "ht"))
    Htau_j = jnp.asarray(ds3d.state_to_jax(Htau, "padded"))
    for _ in range(3):
        Htau_j, s_j = jds3d.dual_time_step_ds_padded(Ht_j, Htau_j, shape, **ARGS)
        Htau, s_t = ds3d.dual_time_step_ds(Ht, Htau, **ARGS)
    want = jds3d.from_ds_padded(Htau_j, shape)
    got = ds3d.from_ds(Htau).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=2.0**-44 * np.abs(np.asarray(want)).max())
    assert abs(float(s_t) - float(s_j)) <= 1e-5 * float(s_j)
    # the port reads the JAX state back on physical cells only
    back = ds3d.state_from_jax(np.asarray(Htau_j), shape, "padded")
    np.testing.assert_allclose(ds3d.from_ds(back).numpy(), got, rtol=0,
                               atol=2.0**-44 * np.abs(got).max())


def test_plain_step_keeps_faces_and_writes_out(rng):
    Ht, Htau = _pair_inputs(rng, (6, 7, 9))
    out = torch.full_like(Htau, float("nan"))
    got, _ = ds3d.dual_time_step_ds(Ht, Htau, **ARGS, out=out)
    assert got is out and torch.isfinite(out).all()
    for axis in (1, 2, 3):
        for i in (0, -1):
            torch.testing.assert_close(out.select(axis, i), Htau.select(axis, i),
                                       rtol=0, atol=0)
    assert not torch.equal(out[:, 1:-1, 1:-1, 1:-1], Htau[:, 1:-1, 1:-1, 1:-1])


def test_to_ds_from_ds_exact(rng):
    H = torch.tensor(rng.standard_normal((5, 6, 7)))
    P = ds3d.to_ds(H)
    assert P.dtype == torch.float32 and P.shape == (2, 5, 6, 7)
    torch.testing.assert_close(P[0], H.float(), rtol=0, atol=0)
    back = ds3d.from_ds(P)
    assert (back - H).abs().max() <= 2.0**-48 * H.abs().max()
    torch.testing.assert_close(ds3d.to_ds(back), P, rtol=0, atol=0)  # a pair survives
    np.testing.assert_array_equal(ds3d.to_ds_padded(H.numpy()),
                                  np.asarray(jds3d.to_ds_padded(jnp.asarray(H.numpy()))))
    np.testing.assert_array_equal(ds3d.from_ds_padded(ds3d.to_ds_padded(H.numpy()), H.shape),
                                  back.numpy())


def test_state_converters(rng):
    shape = (5, 9, 11)
    P = ds3d.to_ds(torch.tensor(rng.random(shape)))
    padded = ds3d.state_to_jax(P, "padded")
    hi, lo = P[0].numpy(), P[1].numpy()
    np.testing.assert_array_equal(padded, np.asarray(jds3d.pad3d_ds(jnp.asarray(hi),
                                                                    jnp.asarray(lo))))
    ht = ds3d.state_to_jax(P, "ht")
    np.testing.assert_array_equal(ht, padded[:, 1:1 + shape[0]])
    # ghost planes are never read: poison them
    poisoned = padded.copy()
    poisoned[:, 0] = poisoned[:, -1] = np.nan
    for a, layout in ((poisoned, "padded"), (ht, "ht")):
        torch.testing.assert_close(ds3d.state_from_jax(a, shape, layout), P, rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout"):
        ds3d.state_to_jax(P, "stacked")


def test_ds_wrapper_refuses_bad_buffers():
    P = torch.zeros((2, 5, 6, 7))
    Q = P.clone()
    with pytest.raises(ValueError, match="must not be Htau_ds"):
        ds3d.dual_time_step_ds(P, Q, **ARGS, out=Q)
    with pytest.raises(ValueError, match=r"\(2, nz, ny, nx\)"):
        ds3d.dual_time_step_ds(P[0], Q[0], **ARGS)
    with pytest.raises(ValueError, match="float32"):
        ds3d.dual_time_step_ds(P.double(), Q.double(), **ARGS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ds3d._ds3d_cuda(P, Q, ds3d.ds_coeffs(**ARGS))


def test_ds_coeffs_split_in_float64():
    cp = ds3d.ds_coeffs(dt=0.2, dtau=(10 / 127) ** 2 / 8.1, dx=10 / 127, dy=10 / 127,
                        dz=10 / 127, D=1.0)
    want = [1 / 0.2, (127 / 10) ** 2, (127 / 10) ** 2, (127 / 10) ** 2, (10 / 127) ** 2 / 8.1]
    for (hi, lo), w in zip(zip(cp[::2], cp[1::2]), want):
        assert np.float32(hi) == hi and np.float32(lo) == lo
        assert abs(hi + lo - w) <= 2.0**-46 * abs(w)
