"""The port's V-cycle legs (fpr_tpu_torch.ops.vcycle_legs: smooth_down, K2;
corr_up, K3) against fpr_tpu.ops.pallas2d.smooth2r_stk / corr_smooth2_stk,
run in interpret mode on the CPU, where the port runs its plain versions;
and the CUDA wrappers' Python side on CPU tensors, with the launch replaced
by an emulation that goes tile by tile over the halo as the leg kernel does
(csrc/vcycle_legs.cu), bitwise against the whole-grid plain versions.

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
from fpr_tpu_torch import kernels
from fpr_tpu_torch.ops import transfer
from fpr_tpu_torch.ops import vcycle_legs as legs
from fpr_tpu_torch.ops.rows import Cols, Rows

SHAPES = [(129, 129), (65, 257)]
DTYPE_NS = [(np.float32, 1), (np.float32, 3), (np.float32, 5), (np.float64, 3),
            (np.float32, 2), (np.float32, 4), (np.float32, 6)]


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


# ---------------------------------------------------------------------------
# The wrappers' Python side with the kernel emulated tile by tile.


def _stencil(R, F, C, inv_h2):
    """res of a region R at its every cell, in the legs' operation order, with
    the cells beyond the region NaN (the garbage a tile's edge reads)."""
    P = torch.nn.functional.pad(R, (1, 1, 1, 1), value=float("nan"))
    return (P[:-2, 1:-1] + P[2:, 1:-1] + P[1:-1, :-2] + P[1:-1, 2:] - C * R) * inv_h2 - F


def _emulated_launch(tile, calls):
    """_launch_leg done tile by tile: each (ty, tx) output tile (tx even)
    sweeps its region (the tile and a halo of H rows and an even halo of
    columns, as the kernel's) on its own, zeros past the array's edges and
    NaN beyond the region, and writes its cells of out, res and (the up leg)
    partials[t]."""
    ty, tx = tile

    def launch(mode, u, f, corrx, c, h, alpha, ns, elim, hooks, out, res, partials):
        ny, nx = f.shape
        up, zero = mode == legs._UP, mode == legs._DOWN_ZERO
        H = ns if up else ns + 1
        hx = (H + 1) // 2 * 2
        C, inv_h2, hc = legs._consts(c, h, f)
        w = f.new_full((), float(alpha)) * hc
        row_off, ny_g, own0, own1, col_off, nx_g, ownc0, ownc1 = hooks
        # the field's interior under the hooks, the input, the owned cells
        gy, gx = row_off + torch.arange(ny), col_off + torch.arange(nx)
        iy, ix = torch.arange(ny), torch.arange(nx)
        interior = (((gy > 0) & (gy < ny_g - 1) & (iy > 0) & (iy < ny - 1))[:, None]
                    & ((gx > 0) & (gx < nx_g - 1) & (ix > 0) & (ix < nx - 1))[None, :])
        owned = (((iy >= own0) & (iy < own1))[:, None] & ((ix >= ownc0) & (ix < ownc1))[None, :])
        if up:
            v0 = u - legs.prolong_y(corrx, ny)
            if elim:
                v0 = legs._elim(v0)
        else:
            v0 = torch.zeros_like(f) if zero else u
        nty, ntx = -(-ny // ty), -(-nx // tx)
        for t in range(nty * ntx):
            y0, x0 = t // ntx * ty, t % ntx * tx
            ys, xs = y0 - H, x0 - hx  # the region's first cell
            rh, rw = ty + 2 * H, tx + 2 * hx

            def region(a, fill=0.0):
                r = a.new_full((rh, rw), fill)
                a0, a1 = max(ys, 0), min(ys + rh, ny)
                b0, b1 = max(xs, 0), min(xs + rw, nx)
                if a0 < a1 and b0 < b1:
                    r[a0 - ys:a1 - ys, b0 - xs:b1 - xs] = a[a0:a1, b0:b1]
                return r

            R, F = region(v0), region(f)
            inner = region(interior.to(f.dtype)) > 0
            last = None
            for s in range(ns):
                if zero and s == 0:
                    R = w * torch.where(inner, -F, torch.zeros_like(F))
                else:
                    last = torch.where(inner, _stencil(R, F, C, inv_h2), torch.zeros_like(F))
                    R = R + w * last
                if elim:  # the side columns that lie in the region
                    R = R.clone()
                    if 0 <= -xs < rw:
                        R[:, -xs] = R[:, -xs + 1] if -xs + 1 < rw else float("nan")
                    if 0 <= nx - 1 - xs < rw:
                        R[:, nx - 1 - xs] = (R[:, nx - 2 - xs] if nx - 2 - xs >= 0
                                             else float("nan"))
            a1, b1 = min(y0 + ty, ny), min(x0 + tx, nx)
            ti = (slice(H, H + a1 - y0), slice(hx, hx + b1 - x0))
            # under elim, column nx-1 goes out with the tile that holds its
            # source nx-2 (the kernel's second store), not with its own
            c0, c1 = x0, b1
            if elim and x0 == nx - 1:
                c0 = nx
            elif elim and b1 == nx - 1:
                c1 = nx
            out[y0:a1, c0:c1] = R[H:H + a1 - y0, hx + c0 - x0:hx + c1 - x0]
            if not up:
                r = torch.where(inner, _stencil(R, F, C, inv_h2), torch.zeros_like(F))
                res[y0:a1, x0:b1] = r[ti]
            elif partials is not None:
                sq = torch.where(owned[y0:a1, x0:b1], last[ti] * last[ti], 0.0)
                partials[t] = torch.sum(sq)
        calls.append((mode, ns, bool(elim), partials is not None))

    return launch


@pytest.fixture(params=[(1, 2), (3, 4), (8, 6), (40, 64)], ids=lambda t: f"tile{t[0]}x{t[1]}")
def emulated(request, monkeypatch):
    """The CUDA wrappers on CPU tensors, their launch emulated with (ty, tx)
    tiles (the first three smaller than the halo at ns >= 3); returns the
    launches' records."""
    ty, tx = request.param
    calls = []
    monkeypatch.setattr(legs, "_launch_leg", _emulated_launch((ty, tx), calls))
    monkeypatch.setattr(legs, "leg_blocks",
                        lambda up, ns, ny, nx: -(-ny // ty) * -(-nx // tx))
    monkeypatch.setattr(kernels, "require_cuda_f32", lambda *tensors: None)
    kernels.reset_launches()
    return calls


def _inputs(rng, shape):
    ny, nx = shape
    f = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    u = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    corrx = torch.tensor(rng.standard_normal((ny // 2 + 1, nx)) * 1e-2, dtype=torch.float32)
    return 1.0 / (min(ny, nx) - 1), f, u, corrx


def _bitwise(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=False)


@pytest.mark.parametrize("ns", range(1, 7))
@pytest.mark.parametrize("zero_u,elim,c", [(True, True, 900.0), (False, False, 0.7)])
def test_down_leg_tile_by_tile(rng, emulated, ns, zero_u, elim, c):
    """K2's wrapper: one launch, u' and res bitwise equal to the whole-grid
    plain version at every tile size."""
    h, f, u, _ = _inputs(rng, (13, 11))
    ct = torch.tensor(c, dtype=torch.float32)
    got = legs._smooth_down_cuda(None if zero_u else u, f, h, ct, 0.8, ns, elim)
    want = legs.smooth_down_plain(None if zero_u else u, f, h, ct, 0.8, ns, elim)
    _bitwise(got[0], want[0])
    _bitwise(got[1], want[1])
    assert emulated == [(legs._DOWN_ZERO if zero_u else legs._DOWN, ns, elim, False)]
    assert kernels.launches["smooth_down"] == 1


@pytest.mark.parametrize("ns", range(1, 7))
@pytest.mark.parametrize("elim", [False, True])
def test_up_leg_tile_by_tile(rng, emulated, ns, elim):
    """K3's wrapper: one launch into out, u' bitwise equal to the plain
    version, the rms from the per-tile partials within 1e-6 (another order
    of the sum); an aliased out refused before any launch."""
    h, f, u, corrx = _inputs(rng, (13, 11))
    ct = torch.tensor(41.25, dtype=torch.float32)
    out = torch.full_like(u, float("nan"))
    got, norm = legs._corr_up_cuda(u, f, corrx, h, ct, 0.8, ns, elim, True, out)
    want, wnorm = legs.corr_up_plain(u, f, corrx, h, ct, 0.8, ns, elim, True)
    assert got is out
    _bitwise(got, want)
    assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
    assert emulated == [(legs._UP, ns, elim, True)]
    assert kernels.launches["corr_up"] == 1
    with pytest.raises(ValueError, match="alias"):
        legs._corr_up_cuda(u, f, corrx, h, ct, 0.8, ns, elim, True, u)
    assert len(emulated) == 1


@pytest.mark.parametrize("ns", [1, 3, 6])
@pytest.mark.parametrize("with_cols", [False, True])
def test_legs_tile_by_tile_hooks(rng, emulated, ns, with_cols):
    """#6 and #7 with the row hooks (a shard whose local rows start above
    the global grid's first row) and the column hooks (col_off < 0): u',
    res and the norm over the owned cells, one launch each, bitwise as the
    plain versions."""
    h, f, u, corrx = _inputs(rng, (20, 17))
    rows = Rows(-4, 14, (4, 16))
    cols = Cols(-2, 13, (3, 15)) if with_cols else None
    ct = torch.tensor(41.25, dtype=torch.float32)
    for uu in (None, u):
        got = legs._smooth2r_split_cuda(uu, f, h, ct, 0.8, ns, False, rows, cols)
        want = legs.smooth_down_plain(uu, f, h, ct, 0.8, ns, False, rows, cols)
        _bitwise(got[0], want[0])
        _bitwise(got[1], want[1])
    got, norm = legs._corr_smooth2_cuda(u, f, corrx, h, ct, 0.8, ns, False, True, None, rows,
                                        cols)
    want, wnorm = legs.corr_up_plain(u, f, corrx, h, ct, 0.8, ns, False, True, None, rows, cols)
    _bitwise(got, want)
    assert abs(float(norm) - float(wnorm)) <= 1e-6 * float(wnorm)
    assert [m for m, *_ in emulated] == [legs._DOWN_ZERO, legs._DOWN, legs._UP]
    assert (kernels.launches["smooth2r_split"], kernels.launches["corr_smooth2"]) == (2, 1)
