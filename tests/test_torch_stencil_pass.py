"""The port's stencil pass, TPU kernel #5 (fpr_tpu_torch.ops.stencil_pass),
against fpr_tpu.ops.pallas2d's row-padded kernel run in interpret mode on
the CPU, where the port runs its plain version.  Operands cross between
the packages through the layout converters (pad2d / unpad2d), which must
match the JAX ones.

Tolerances: XLA:CPU contracts a*b+c into an FMA inside jit (interpret
mode runs inside jit), eager PyTorch does not, so the two differ by a few
ulps per operation.  Residuals and matvecs cancel terms of size
max|u| C/h^2, so they are held to 64 ulps of that scale plus 64 ulps of
max|f|; the smoothed iterate to 64 ulps of max|u| plus the residual bound
times the sweep weight; sums (another order) to 1e-5 relative in float32
and 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import pallas2d
from fpr_tpu_torch.ops import stencil_pass as sp

SHAPES = [(17, 33), (33, 129), (65, 257)]
DTYPES = [np.float64, np.float32]
MODES = ["smooth", "smooth2", "residual", "matvec", "matvec_dot"]


def _bounds(u, f, h, c, dtype):
    eps = float(np.finfo(dtype).eps)
    scale = np.abs(u).max() * (4.0 + abs(c) * h * h) / (h * h) + np.abs(f).max()
    return 64 * eps * scale, (1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [0.0, 3.14])
@pytest.mark.parametrize("shape", SHAPES)
def test_modes_match_stencil_kernel(rng, shape, c, dtype, mode):
    ny, nx = shape
    h = 1.0 / (ny - 1)
    u = rng.standard_normal(shape).astype(dtype)
    f = rng.standard_normal(shape).astype(dtype)
    br = pallas2d._pick_br(ny, nx, np.dtype(dtype).itemsize)
    u_rp, f_rp = pallas2d.pad2d(jnp.asarray(u), br), pallas2d.pad2d(jnp.asarray(f), br)
    ut, ft = torch.tensor(u), torch.tensor(f)
    tol_field, tol_sum = _bounds(u, f, h, c, dtype)
    w = 0.8 * h * h / (4.0 + c * h * h)

    if mode in ("smooth", "smooth2"):
        jfn, tfn = (pallas2d.smooth_rp, sp.smooth_rp) if mode == "smooth" else \
            (pallas2d.smooth2_rp, sp.smooth2_rp)
        uj, rj = jfn(u_rp, f_rp, ny, nx, br, h, c, with_norm=True)
        got, rt = tfn(ut, ft, h, c, with_norm=True)
        want = np.asarray(pallas2d.unpad2d(uj, ny, nx))
        bound = 64 * float(np.finfo(dtype).eps) * np.abs(u).max() + 2 * w * tol_field
        assert np.abs(got.numpy() - want).max() <= bound
        assert abs(float(rt) - float(rj)) <= tol_sum * float(rj) + tol_field
        _, none = tfn(ut, ft, h, c, with_norm=False)
        assert none is None
    elif mode == "residual":
        want = np.asarray(pallas2d.unpad2d(pallas2d.residual_rp(u_rp, f_rp, ny, nx, br, h, c),
                                           ny, nx))
        got = sp.residual_rp(ut, ft, h, c).numpy()
        assert np.abs(got - want).max() <= tol_field
        assert (got[0] == 0).all() and (got[:, -1] == 0).all()
    elif mode == "matvec":
        out_j, dot_j = pallas2d.matvec_rp(u_rp, ny, nx, br, h, c, with_dot=True)
        out_t, dot_t = sp.matvec_rp(ut, h, c, with_dot=True)
        want = np.asarray(pallas2d.unpad2d(out_j, ny, nx))
        assert np.abs(out_t.numpy() - want).max() <= tol_field
        n_terms = u.size * np.abs(u).max() * tol_field
        assert abs(float(dot_t) - float(dot_j)) <= tol_sum * abs(float(dot_j)) + n_terms
        assert torch.equal(sp.matvec_rp(ut, h, c), out_t)
    else:
        dot_j = float(pallas2d.matvec_dot_rp(u_rp, ny, nx, br, h, c))
        dot_t = float(sp.matvec_dot_rp(ut, h, c))
        n_terms = u.size * np.abs(u).max() * tol_field
        assert abs(dot_t - dot_j) <= tol_sum * abs(dot_j) + n_terms


@pytest.mark.parametrize("c", [0.0, 3.14])
def test_physical_drop_ins_match(rng, c):
    """jacobi_step, residual and matvec: the PALLAS policy's drop-ins
    (pallas2d.py:903-925), in float64."""
    shape = (33, 129)
    h = 1.0 / 32
    u, f = rng.random(shape), rng.random(shape)
    uj, nj = pallas2d.jacobi_step(jnp.asarray(u), jnp.asarray(f), h, c)
    ut, nt = sp.jacobi_step(torch.tensor(u), torch.tensor(f), h, c)
    tol_field, _ = _bounds(u, f, h, c, np.float64)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-14)
    assert abs(float(nt) - float(nj)) <= 1e-12 * float(nj)
    np.testing.assert_allclose(sp.residual(torch.tensor(u), torch.tensor(f), h, c).numpy(),
                               np.asarray(pallas2d.residual(jnp.asarray(u), jnp.asarray(f),
                                                            h, c)), rtol=0, atol=tol_field)
    np.testing.assert_allclose(sp.matvec(torch.tensor(u), h, h, c).numpy(),
                               np.asarray(pallas2d.matvec(jnp.asarray(u), h, h, c)),
                               rtol=0, atol=tol_field)
    with pytest.raises(ValueError, match="hx == hy"):
        sp.matvec(torch.tensor(u), h, 2 * h, c)


def test_device_scalar_shift_equals_python_shift(rng):
    """c as a 0-dim tensor (a shift computed on the device) gives the same
    bits as the Python number."""
    u, f = torch.tensor(rng.random((17, 33))), torch.tensor(rng.random((17, 33)))
    for dtype in (torch.float32, torch.float64):
        a, ra = sp.smooth_rp(u.to(dtype), f.to(dtype), 1 / 16, 41.25)
        b, rb = sp.smooth_rp(u.to(dtype), f.to(dtype), 1 / 16, torch.tensor(41.25))
        assert torch.equal(a, b) and torch.equal(ra, rb)


@pytest.mark.parametrize("shape,itemsize", [((17, 33), 8), ((513, 2049), 4), ((65, 257), 4),
                                            ((4097, 4097), 4), ((1025, 257), 8)])
def test_layout_converters_match_pallas2d(rng, shape, itemsize):
    ny, nx = shape
    br = sp.pick_br(ny, nx, itemsize)
    assert br == pallas2d._pick_br(ny, nx, itemsize)
    assert sp.padded_rows(ny, br) == pallas2d.padded_rows(ny, br)
    assert sp.padded_cols(nx) == pallas2d.padded_cols(nx)
    if ny * nx <= 65 * 257:
        a = rng.random(shape)
        ap = sp.pad2d(torch.tensor(a), br)
        np.testing.assert_array_equal(ap.numpy(), np.asarray(pallas2d.pad2d(jnp.asarray(a), br)))
        np.testing.assert_array_equal(sp.unpad2d(ap, ny, nx).numpy(), a)


def test_cpu_tensors_run_the_plain_version(rng):
    from fpr_tpu_torch import kernels

    kernels.reset_launches()
    u = torch.tensor(rng.random((17, 17)))
    out, sums = sp.stencil_plain("matvec", u, None, 1 / 16, 0.5)
    assert torch.equal(sp.matvec_rp(u, 1 / 16, 0.5), out)
    assert float(sp.matvec_dot_rp(u, 1 / 16, 0.5)) == float(sums[0])
    assert kernels.launches["stencil"] == 0
    with pytest.raises(ValueError, match="does not match"):
        sp.residual_rp(u, u[:-1], 1 / 16, 0.0)
    # the CUDA path refuses what the kernel does not take; it never falls back
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sp._stencil_cuda("matvec", u, None, 1 / 16, 0.5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [0.0, 3.14, "tensor"])
@pytest.mark.parametrize("shape", SHAPES)
def test_smooth2_plain_matches_pallas2d(rng, shape, c, dtype):
    """``stencil_plain("smooth2")``, the kernel's plain version, against the
    TPU kernel's smooth2 mode in interpret mode; c also as a 0-dim tensor
    (a shift on the device).  Tolerances of the file's docstring: the
    iterate to 64 ulps of max|u| plus the residual bound times the two
    sweeps' weights, the sum to 1e-5 (1e-12) relative plus the residual
    bound."""
    ny, nx = shape
    h = 1.0 / (ny - 1)
    cv = 3.14 if c == "tensor" else c
    u = rng.standard_normal(shape).astype(dtype)
    f = rng.standard_normal(shape).astype(dtype)
    br = pallas2d._pick_br(ny, nx, np.dtype(dtype).itemsize)
    uj, rj = pallas2d.smooth2_rp(pallas2d.pad2d(jnp.asarray(u), br),
                                 pallas2d.pad2d(jnp.asarray(f), br), ny, nx, br, h, cv)
    ct = torch.tensor(cv, dtype=torch.float32 if dtype == np.float32 else torch.float64) \
        if c == "tensor" else c
    got, sums = sp.stencil_plain("smooth2", torch.tensor(u), torch.tensor(f), h, ct)
    tol_field, tol_sum = _bounds(u, f, h, cv, dtype)
    w = 0.8 * h * h / (4.0 + cv * h * h)
    bound = 64 * float(np.finfo(dtype).eps) * np.abs(u).max() + 2 * w * tol_field
    want = np.asarray(pallas2d.unpad2d(uj, ny, nx))
    assert np.abs(got.numpy() - want).max() <= bound
    assert abs(float(sums[1]) - float(rj)) <= tol_sum * float(rj) + tol_field


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_smooth2_without_norm_returns_none(rng, dtype):
    """smooth2_rp(with_norm=False) returns (u'', None), u'' the bits of two
    smooth_rp sweeps and of smooth2_rp with the norm."""
    u = torch.tensor(rng.standard_normal((33, 129)), dtype=dtype)
    f = torch.tensor(rng.standard_normal((33, 129)), dtype=dtype)
    out, none = sp.smooth2_rp(u, f, 1 / 32, 3.14, with_norm=False)
    assert none is None
    two, r2 = sp.smooth_rp(sp.smooth_rp(u, f, 1 / 32, 3.14, with_norm=False)[0], f, 1 / 32, 3.14)
    normed, r = sp.smooth2_rp(u, f, 1 / 32, 3.14)
    assert torch.equal(out, two) and torch.equal(out, normed) and torch.equal(r, r2)


@pytest.mark.parametrize("card", [(132, 8), (132, 4), (132, 3)])
@pytest.mark.parametrize("shape,dtype", [((513, 2049), torch.float32),
                                         ((4097, 4097), torch.float32),
                                         ((2049, 2049), torch.float64)])
def test_plan_tiles_cover_every_cell_once(monkeypatch, shape, dtype, card):
    """The launch plan at phase 3's shapes on an H100-sized card (132 SMs,
    a few blocks each): the blocks take tiles b, b + blocks, ..., which
    cover every cell once, and the partials have one entry a block.  Exact:
    integer counts."""
    from fpr_tpu_torch import kernels

    monkeypatch.setattr(kernels, "card_fill", lambda fill, variant, index: card)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, dtypes, *tensors: None)
    seen = []
    monkeypatch.setattr(sp, "_launch", lambda mode, u, f, c, h, alpha, out, partials, sums,
                        plan: seen.append((plan, partials.numel())))
    ny, nx = shape
    u = torch.empty(shape, dtype=dtype, device="meta")
    for mode in sp.MODES:
        f = None if mode.startswith("matvec") else u
        sp._stencil_cuda(mode, u, f, 1.0 / (ny - 1), 0.0, with_acc=True)
        (S, blocks), n_partials = seen.pop()
        assert n_partials == blocks <= card[0] * card[1]
        ty, tiles_x = kernels.TILE_WARPS * S, -(-nx // kernels.TILE_X)
        n_tiles = kernels.n_tiles(ny, nx, S)
        assert blocks <= n_tiles
        count = np.zeros((-(-ny // ty) * ty, tiles_x * kernels.TILE_X), dtype=np.int8)
        for b in range(blocks):
            for t in range(b, n_tiles, blocks):
                y0, x0 = t // tiles_x * ty, t % tiles_x * kernels.TILE_X
                count[y0:y0 + ty, x0:x0 + kernels.TILE_X] += 1
        assert (count == 1).all()
