"""The port's double-single arithmetic and defect pass (fpr_tpu_torch.ops.ds)
against fpr_tpu.ops.ds, on the CPU, where the port runs the plain PyTorch
version of its CUDA kernel.

Tolerances: the defect pass is double-single arithmetic, exact to about
2^-48 of the stencil scale, so u' (hi + lo) agrees to 2^-44 of max|u| and
the float32 residual r to 4 float32 ulps of the stencil scale
max|u|/h^2.  Sums of squares are taken in another order than in JAX:
1e-5 relative.  Maxima of values that agree to a few ulps: 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import ds as jds
from fpr_tpu.ops import pallas2d
from fpr_tpu_torch.ops import ds as tds

EPS32 = float(np.finfo(np.float32).eps)


def test_eft_exactness(rng):
    """two_sum and two_prod in torch float32 are exact (tests/test_ds.py)."""
    a = torch.tensor(rng.standard_normal(4096), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(4096) * 1e-3, dtype=torch.float32)
    s, e = tds.two_sum(a, b)
    np.testing.assert_array_equal(s.double() + e.double(), a.double() + b.double())
    p, e = tds.two_prod(a, b)
    np.testing.assert_array_equal(p.double() + e.double(), a.double() * b.double())


def test_ds_neg_mul_f1_from_ds_match_jax(rng):
    """ds_neg, ds_mul_f1 and from_ds bitwise against JAX's on float32."""
    xh, xl = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))
    xl *= np.float32(1e-8)
    c = rng.standard_normal(4096).astype(np.float32)
    T = torch.tensor
    for got, want in ((tds.ds_neg(T(xh), T(xl)), jds.ds_neg(jnp.asarray(xh), jnp.asarray(xl))),
                      (tds.ds_mul_f1(T(xh), T(xl), T(c)),
                       jds.ds_mul_f1(jnp.asarray(xh), jnp.asarray(xl), jnp.asarray(c))),
                      (tds.ds_mul_f1(T(xh), T(xl), 3.0),
                       jds.ds_mul_f1(jnp.asarray(xh), jnp.asarray(xl), jnp.float32(3.0)))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for dtype, jdtype in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        got = tds.from_ds(T(xh), T(xl), dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jds.from_ds(jnp.asarray(xh), jnp.asarray(xl), jdtype)))
    assert tds.from_ds(T(xh), T(xl)).dtype == torch.float64


def test_defect_scalars_match(rng):
    """C = 4 + c h^2 as a ds pair: a Python c split on the host, a float32
    tensor c by error-free transforms, both as ds._defect_scalars."""
    h = 1.0 / 64
    for c in (0.0, 3.14, 1234.5):
        got = tds.defect_scalars(c, h, "cpu").numpy()
        want = np.asarray(jds._defect_scalars(c, h, 0.0, 0))[1:3, 0]
        np.testing.assert_array_equal(got, want)
    c32 = np.float32(rng.random() * 1e4)
    got = tds.defect_scalars(torch.tensor(c32), h, "cpu").numpy()
    want = np.asarray(jds._defect_scalars(jnp.float32(c32), h, 0.0, 0))[1:3, 0]
    np.testing.assert_array_equal(got, want)


def _inputs(rng, ny, nx, f_planes):
    u64 = rng.standard_normal((ny, nx))
    hi = u64.astype(np.float32)
    lo = (u64 - hi).astype(np.float32)
    f64 = rng.standard_normal((ny, nx))
    fh = f64.astype(np.float32)
    f = np.stack([fh, (f64 - fh).astype(np.float32)])[:f_planes]
    e = (rng.standard_normal((ny, nx)) * 1e-2).astype(np.float32)
    return np.stack([hi, lo]), f, e


def _jax_defect(u, f, e, scale, h, c, stk=False, **kw):
    ny, nx = u.shape[1:]
    br = pallas2d._pick_br(ny, nx, 4)
    pad = lambda a: pallas2d.pad2d(jnp.asarray(a), br)  # noqa: E731
    unp = lambda a: np.asarray(pallas2d.unpad2d(a, ny, nx))  # noqa: E731
    u_j = jnp.stack([pad(u[0]), pad(u[1])])
    f_j = jnp.stack([pad(p) for p in f])
    if stk:
        L = jnp.stack([pad(e), jnp.zeros_like(pad(e))])
        out = jds.defect_pass_stk(u_j, f_j, L, scale, ny, nx, br, h, c, **kw)
        r = out[1][1]  # plane 0 of L' is unspecified: never compared
    else:
        out = jds.defect_pass(u_j, f_j, pad(e), scale, ny, nx, br, h, c, **kw)
        r = out[1]
    extras = out[3] if len(out) > 3 else None
    return np.stack([unp(out[0][0]), unp(out[0][1])]), unp(r), float(out[2]), extras


def _check(u, got, want, h):
    (u2, r2, rr2, ex2), (u1, r1, rr1, ex1) = got, want
    scale = np.abs(u[0]).max()
    s_got = u2[0].astype(np.float64) + u2[1]
    s_want = u1[0].astype(np.float64) + u1[1]
    assert np.abs(s_got - s_want).max() <= 2.0**-44 * scale
    assert np.abs(r2 - r1).max() <= 4 * EPS32 * scale / h**2
    assert abs(rr2 - rr1) <= 1e-5 * rr1
    if ex1 is not None:
        for a, b in zip(ex2, ex1):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b)) + 1e-30


@pytest.mark.parametrize("scale", [0.0, 1.0])
@pytest.mark.parametrize("c", ["zero", "f32"])
@pytest.mark.parametrize("f_planes", [1, 2])
@pytest.mark.parametrize("apply_bcs", [False, True])
def test_defect_pass_matches_jax(rng, scale, c, f_planes, apply_bcs):
    ny, nx = 65, 257
    h = 1.0 / 64
    u, f, e = _inputs(rng, ny, nx, f_planes)
    c32 = np.float32(0.5 / h**2)
    cj = 0.0 if c == "zero" else jnp.float32(c32)
    ct = 0.0 if c == "zero" else torch.tensor(c32)
    kw = dict(apply_bcs=apply_bcs, velocity_max=True, field_sumsq=True)
    want = _jax_defect(u, f, e, scale, h, cj, **kw)
    u2, r2, rr2, ex2 = tds.defect_pass(torch.tensor(u), torch.tensor(f), torch.tensor(e),
                                       scale, h, ct, **kw)
    _check(u, (u2.numpy(), r2.numpy(), float(rr2), ex2), want, h)
    if apply_bcs:
        got = u2[0].numpy()
        assert (got[0, 1:-1] == 1.0).all() and (got[-1, 1:-1] == 0.0).all()
        np.testing.assert_array_equal(got[:, 0], got[:, 1])


@pytest.mark.parametrize("flags", [dict(), dict(velocity_max=True), dict(field_sumsq=True)])
def test_defect_pass_extras(rng, flags):
    """The extras tuple appears with either flag; the unrequested entries are
    zero, as in the TPU kernel's zeroed accumulator slots."""
    ny, nx = 33, 65
    h = 1.0 / 32
    u, f, e = _inputs(rng, ny, nx, 1)
    want = _jax_defect(u, f, e, 1.0, h, 0.0, **flags)
    out = tds.defect_pass(torch.tensor(u), torch.tensor(f), torch.tensor(e), 1.0, h,
                          0.0, **flags)
    assert len(out) == len(want[:3]) + (1 if flags else 0)
    if flags:
        for a, b in zip(out[3], want[3]):
            assert (float(a) == 0.0) == (float(b) == 0.0)


def test_defect_pass_stk_poisoned_plane(rng):
    """defect_pass_stk reads e from L[0] and overwrites all of L[1]: a
    poisoned L[1] must not leak, and L'[1] equals JAX's new defect plane."""
    ny, nx = 65, 129
    h = 1.0 / 64
    u, f, e = _inputs(rng, ny, nx, 1)
    c32 = np.float32(123.0)
    L = torch.stack([torch.tensor(e), torch.full((ny, nx), float("nan"))])
    u2, L2, rr2 = tds.defect_pass_stk(torch.tensor(u), torch.tensor(f), L, 1.0, h,
                                      torch.tensor(c32))
    assert torch.isfinite(L2[1]).all()
    torch.testing.assert_close(L2[0], torch.tensor(e), rtol=0, atol=0)
    want = _jax_defect(u, f, e, 1.0, h, jnp.float32(c32), stk=True)
    _check(u, (u2.numpy(), L2[1].numpy(), float(rr2), None), want, h)


def test_defect_pass_rejects_non_pow2_h(rng):
    u = torch.zeros((2, 9, 9))
    f = torch.zeros((1, 9, 9))
    with pytest.raises(ValueError, match="power of two"):
        tds.defect_pass(u, f, None, 0.0, 1.0 / 6, 0.0)
