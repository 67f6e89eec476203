"""The CUDA wrappers of K1 (fpr_tpu_torch.ops.ds: the defect pass) and K4
(fpr_tpu_torch.ops.ns_fused: the NS operator pass) on CPU tensors, with
their one launch (``ds._launch_defect``, ``ns_fused._launch_ns``) replaced
by an emulation of the kernels' tile plan (csrc/defect.cu,
csrc/ns_fused.cu): tiles of 32 columns x 8 S rows, numbered row by row and
taken in turn by the plan's blocks; each tile's values (u updated and
BC'd, or T BC'd, W and S) loaded for its region, the tile and a one-cell
halo, with NaN beyond it, and its cells computed from that region alone;
each block's sums and maxima over its tiles as partials, added by a "last
block" in a fixed order; the rms from that sum.

Fields are held bitwise to the plain versions (``defect_pass_plain``,
``ns_fused_plain``), sums to 1e-6 relative (another order of float32
adds), maxima exactly.  Each call must be one launch.
"""

import math

import numpy as np
import pytest
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.core import bc
from fpr_tpu_torch.ops import ds, ns_fused
from fpr_tpu_torch.ops.ds import ds_add, ds_mul_ds, two_prod, two_sum
from fpr_tpu_torch.ops.rows import Cols, Rows

TX, TW_ = kernels.TILE_X, kernels.TILE_WARPS
NAN = float("nan")


def _tiles(ny, nx, S):
    """(y0, x0) of every tile of the plan, in the kernels' order."""
    ty = TW_ * S
    tiles_x = -(-nx // TX)
    return [(t // tiles_x * ty, t % tiles_x * TX) for t in range(kernels.n_tiles(ny, nx, S))]


def _region(a, y0, x0, ty):
    """The region of the tile at (y0, x0) of a (..., ny, nx) field, rows y0-1
    .. y0+ty and columns x0-1 .. x0+TX (zeros past the field's edges, as the
    kernels store), with a NaN border beyond it."""
    ny, nx = a.shape[-2:]
    R = a.new_zeros(a.shape[:-2] + (ty + 2, TX + 2))
    ya, yb, xa, xb = max(y0 - 1, 0), min(y0 + ty + 1, ny), max(x0 - 1, 0), min(x0 + TX + 1, nx)
    R[..., ya - y0 + 1:yb - y0 + 1, xa - x0 + 1:xb - x0 + 1] = a[..., ya:yb, xa:xb]
    return torch.nn.functional.pad(R, (1, 1, 1, 1), value=NAN)


def _taps(P):
    """Centre, up, down, left and right of the tile's cells on a padded region."""
    return (P[..., 2:-2, 2:-2], P[..., 1:-3, 2:-2], P[..., 3:-1, 2:-2], P[..., 2:-2, 1:-3],
            P[..., 2:-2, 3:-1])


def _masks(y0, x0, ty, ny, nx, hooks):
    """The tile's cells inside the field, and their interior, owned and
    physical masks under the hooks (row_off, ny_g, own0, own1[, col_off,
    nx_g, ownc0, ownc1])."""
    row_off, ny_g, own0, own1, *col = hooks
    col_off, nx_g, ownc0, ownc1 = col or (0, nx, 0, nx)
    y = torch.arange(y0, y0 + ty)[:, None]
    x = torch.arange(x0, x0 + TX)[None, :]
    gy, gx = row_off + y, col_off + x
    inside = (y < ny) & (x < nx)
    interior = ((y > 0) & (y < ny - 1) & (gy > 0) & (gy < ny_g - 1)
                & (x > 0) & (x < nx - 1) & (gx > 0) & (gx < nx_g - 1))
    own = (y >= own0) & (y < own1) & (x >= ownc0) & (x < ownc1)
    phys = (gy >= 0) & (gy < ny_g) & (gx >= 0) & (gx < nx_g)
    return inside, interior & inside, own & inside, phys & inside


def _finish(partials, max_mask, nt=kernels.TILE_X * kernels.TILE_WARPS):
    """The last block: thread t folds blocks t, t + nt, ... in order, then
    the block reduction (a tree in each warp, lane i taking lane i + o for
    o = 16 .. 1, and the same over the warps' results), per quantity."""
    n, nq = partials.shape
    rows = torch.zeros((-(-n // nt) * nt, nq))
    rows[:n] = partials
    mx = torch.tensor([(max_mask >> q) & 1 for q in range(nq)], dtype=torch.bool)

    def op(a, b):
        return torch.where(mx, torch.maximum(a, b), a + b)

    def warp_tree(x):  # (..., 32, nq) -> (..., nq)
        o = 16
        while o:
            x = op(x[..., :o, :], x[..., o:2 * o, :])
            o //= 2
        return x[..., 0, :]

    acc = torch.zeros((nt, nq))
    for row in rows.reshape(-1, nt, nq):
        acc = op(acc, row)
    warps = warp_tree(acc.reshape(nt // 32, 32, nq))
    return warp_tree(torch.cat([warps, torch.zeros((32 - nt // 32, nq))]))


def _put(dst, src, y0, x0, inside):
    ty, tx = int(inside[:, 0].sum()), int(inside[0].sum())
    dst[..., y0:y0 + ty, x0:x0 + tx] = src[..., :ty, :tx]


def _emulated_defect(calls):
    """ds._launch_defect done tile by tile."""

    def launch(u_ds, f_ds, e, C, scale, h, flags, hooks, u_out, r, out, plan):
        S, blocks = plan
        _, ny, nx = u_ds.shape
        ty = TW_ * S
        bcs, c_zero, f_single = flags & 1, flags & 2, flags & 4
        vmax, fsq = flags & 8, flags & 16
        hh = float(h) * float(h)
        if C is None or isinstance(C, tuple):
            Cp = torch.tensor(C or (0.0, 0.0), dtype=torch.float32)
        else:
            Cp = C if C.dim() else ds.defect_scalars(C, h, "cpu")
        # the updated, BC'd value of every cell, each from the inputs alone
        ee = torch.zeros_like(u_ds[0]) if e is None else e
        ph, pe = two_prod(ee, u_ds.new_full((), float(scale)))
        vh, vl = ds_add(u_ds[0], u_ds[1], -ph, -pe)
        if bcs:
            g = hooks[0] + torch.arange(ny)[:, None]
            vh = torch.where(g == 0, 1.0, torch.where(g == hooks[1] - 1, 0.0, vh))
            vl = torch.where((g == 0) | (g == hooks[1] - 1), 0.0, vl)
            vh, vl = bc.neumann_left_right(vh), bc.neumann_left_right(vl)
        V = torch.stack([vh, vl])
        partials = torch.zeros((blocks, 4))
        for t, (y0, x0) in enumerate(_tiles(ny, nx, S)):
            (ch, cl), up, dn, lf, rt = _taps(_region(V, y0, x0, ty))
            fh = _region(f_ds[0], y0, x0, ty)[2:-2, 2:-2]
            inside, interior, own, phys = _masks(y0, x0, ty, ny, nx, hooks)
            s1, e1 = two_sum(up[0], dn[0])
            s2, e2 = two_sum(lf[0], rt[0])
            sh_, e3 = two_sum(s1, s2)
            sl_ = ((e1 + e2) + e3) + ((up[1] + dn[1]) + (lf[1] + rt[1]))
            cuh, cul = (ch * 4.0, cl * 4.0) if c_zero else ds_mul_ds(ch, cl, Cp[0], Cp[1])
            th, tl = ds_add(sh_, sl_, -cuh, -cul)
            th, tl = th * (1.0 / hh), tl * (1.0 / hh)
            rs, re = two_sum(th, -fh)
            if f_single:
                rr = rs + (re + tl)
            else:
                rr = rs + (re + (tl - _region(f_ds[1], y0, x0, ty)[2:-2, 2:-2]))
            rr = torch.where(interior, rr, 0.0)
            _put(u_out, torch.stack([ch, cl]), y0, x0, inside)
            _put(r, rr, y0, x0, inside)
            b = t % blocks
            mo = interior & own
            zero = torch.zeros(())
            partials[b, 0] += torch.sum(torch.where(mo, rr * rr, zero))
            if vmax:
                inv2h = 0.5 / float(h)
                vy = torch.where(mo, torch.abs((dn[0] - up[0]) * inv2h), zero)
                vx = torch.where(mo, torch.abs((rt[0] - lf[0]) * inv2h), zero)
                partials[b, 1] = torch.maximum(partials[b, 1], vy.amax())
                partials[b, 2] = torch.maximum(partials[b, 2], vx.amax())
            if fsq:
                partials[b, 3] += torch.sum(torch.where(own & phys, ch * ch, zero))
        tot = _finish(partials, 0b0110)
        out[:4] = tot
        out[4] = torch.sqrt(tot[0] / torch.tensor(float(nx * ny)))
        calls.append(("defect", S, blocks))

    return launch


def _emulated_ns(calls):
    """ns_fused._launch_ns done tile by tile."""

    def launch(TW, Sh, Sl, scal, h, Pr, Ra, k, beta, flags, hooks, out, r, rw, sums, plan):
        S, blocks = plan
        _, ny, nx = TW.shape
        ty = TW_ * S
        rhs, defect, use_dif, helm = flags & 1, flags & 2, flags & 4, flags & 8
        dt, cT, cW = scal
        rows = Rows(hooks[0], hooks[1], (hooks[2], hooks[3]))
        # the region values: T with its BCs, W, S hi, S lo
        Tb = bc.ns_temperature_bcs(TW[0], rows)
        V = torch.stack([Tb, TW[1], Sh, torch.zeros_like(Sh) if Sl is None else Sl])
        if helm:
            CT, CW = ds.defect_scalars(cT, h, "cpu"), ds.defect_scalars(cW, h, "cpu")
        _2h, _h, _h2 = 0.5 / h, 1.0 / h, 1.0 / (h * h)
        partials = torch.zeros((blocks, 6))
        zero = torch.zeros(())
        for t, (y0, x0) in enumerate(_tiles(ny, nx, S)):
            c, U, D, L, R = _taps(_region(V, y0, x0, ty))
            inside, interior, own, phys = _masks(y0, x0, ty, ny, nx, hooks)
            Tc, Wc = c[0], c[1]
            vx = (D[2] - U[2]) * _2h
            vy = -(R[2] - L[2]) * _2h
            B = Ra * (R[0] - L[0]) * _2h
            if use_dif:
                dT2 = k * ((U[0] + D[0] + L[0] + R[0] - 4.0 * Tc) * _h2)
                dW2 = Pr * ((U[1] + D[1] + L[1] + R[1] - 4.0 * Wc) * _h2)
            else:
                dT2 = dW2 = zero
            dTx = vx * torch.where(vx > 0, (Tc - L[0]) * _h, (R[0] - Tc) * _h)
            dTy = vy * torch.where(vy > 0, (Tc - U[0]) * _h, (D[0] - Tc) * _h)
            dWx = vx * torch.where(vx > 0, (Wc - L[1]) * _h, (R[1] - Wc) * _h)
            dWy = vy * torch.where(vy > 0, (Wc - U[1]) * _h, (D[1] - Wc) * _h)
            PrB = Pr * B
            if rhs:
                termT = torch.where(interior, (1.0 - beta) * dT2 - dTx - dTy, zero)
                termW = torch.where(interior, (1.0 - beta) * dW2 - dWx - dWy - PrB, zero)
                to, wo = -cT * (Tc + dt * termT), -cW * (Wc + dt * termW)
            else:
                to = torch.where(interior, Tc + dt * (dT2 - dTx - dTy), Tc)
                wo = torch.where(interior, Wc + dt * (dW2 - dWx - dWy - PrB), Wc)
            to, wo = torch.where(phys, to, zero), torch.where(phys, wo, zero)
            _put(out, torch.stack([to, wo]), y0, x0, inside)
            b = t % blocks
            partials[b, 0] += torch.sum(torch.where(own, to * to, zero))
            partials[b, 1] += torch.sum(torch.where(own, wo * wo, zero))
            mo = own & interior
            if defect:
                s1, e1 = two_sum(U[2], D[2])
                s2, e2 = two_sum(L[2], R[2])
                sh_, e3 = two_sum(s1, s2)
                sl_ = ((e1 + e2) + e3) + ((U[3] + D[3]) + (L[3] + R[3]))
                th, tl = ds_add(sh_, sl_, -(c[2] * 4.0), -(c[3] * 4.0))
                rs, re = two_sum(th * _h2, -wo)
                rr = torch.where(interior, rs + (re + tl * _h2), zero)
                _put(r, rr, y0, x0, inside)
                partials[b, 2] += torch.sum(torch.where(mo, rr * rr, zero))
                partials[b, 3] = torch.maximum(partials[b, 3],
                                               torch.where(mo, vx.abs(), zero).amax())
                partials[b, 4] = torch.maximum(partials[b, 4],
                                               torch.where(mo, vy.abs(), zero).amax())
            if helm:
                for q, (X, Cp, rhs_, dst) in ((2, (0, CT, to, r)), (5, (1, CW, wo, rw))):
                    xc, z = c[X], torch.zeros_like(c[X])
                    s1, e1 = two_sum(U[X], D[X])
                    s2, e2 = two_sum(L[X], R[X])
                    sh_, e3 = two_sum(s1, s2)
                    sl_ = ((e1 + e2) + e3) + ((z + z) + (z + z))
                    cuh, cul = ds_mul_ds(xc, z, Cp[0], Cp[1])
                    th, tl = ds_add(sh_, sl_, -cuh, -cul)
                    rs, re = two_sum(th * _h2, -rhs_)
                    rr = torch.where(interior, rs + (re + tl * _h2), zero)
                    _put(dst, rr, y0, x0, inside)
                    partials[b, q] += torch.sum(torch.where(own, rr * rr, zero))
        tot = _finish(partials, 0b011000)
        sums[:6] = tot
        n = torch.tensor(float(nx * hooks[1]))
        sums[6], sums[7] = torch.sqrt(tot[2] / n), torch.sqrt(tot[5] / n)
        calls.append(("ns", S, blocks))

    return launch


# plans: a card given to kernels.tile_plan as (SMs, blocks an SM), or S
# forced with up to 5 blocks; S = 1 is the smallest tile, 32 x 8
PLANS = [("card", (132, 8)), ("card", (1, 1)), ("card", (2, 3)), ("S", 1), ("S", 2),
         ("S", 3), ("S", 4)]


@pytest.fixture
def emulate(monkeypatch):
    """emulate(plan): the CUDA wrappers on CPU tensors from then on, their
    launches emulated under the plan; returns the launches' records."""

    def start(plan):
        kind, arg = plan
        calls = []
        monkeypatch.setattr(ds, "_launch_defect", _emulated_defect(calls))
        monkeypatch.setattr(ns_fused, "_launch_ns", _emulated_ns(calls))
        monkeypatch.setattr(kernels, "require_cuda_f32", lambda *tensors: None)
        if kind == "card":
            monkeypatch.setattr(kernels, "card_fill", lambda fill, variant, index: arg)
        else:
            monkeypatch.setattr(kernels, "tile_plan", lambda ny, nx, sms, per_sm, s_max=4: (
                arg, min(5, kernels.n_tiles(ny, nx, arg))))
            monkeypatch.setattr(kernels, "card_fill", lambda fill, variant, index: (1, 1))
        kernels.reset_launches()
        return calls

    return start


def _plan(i):
    return PLANS[i % len(PLANS)]


def _bitwise(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=False)


def _sums(got, want, maxima):
    for i, (g, w) in enumerate(zip(got.tolist(), want.tolist())):
        if i in maxima:
            assert g == w, (i, g, w)
        else:
            assert abs(g - w) <= 1e-6 * max(abs(w), 1e-30), (i, g, w)


def _ds_inputs(rng, ny, nx):
    u64 = rng.standard_normal((ny, nx))
    hi = u64.astype(np.float32)
    u = torch.tensor(np.stack([hi, (u64 - hi).astype(np.float32)]))
    f = torch.tensor(rng.standard_normal((2, ny, nx)).astype(np.float32))
    f[1] *= 1e-8
    e = torch.tensor((rng.standard_normal((ny, nx)) * 1e-3).astype(np.float32))
    return u, f, e


# the last shape's last tile has one column, and its last strip one row
# under every S but 3
SHAPES = [(67, 45), (130, 257), (67, 113), (65, 97)]
CT = torch.tensor(41.25, dtype=torch.float32)
# name, c, flags, f planes, with a correction e
K1_CASES = [("S", 0.0, dict(velocity_max=True), 1, False),
            ("T", CT, dict(apply_bcs=True), 1, True),
            ("W", CT * 100.0, dict(), 2, True),
            ("sumsq", 0.0, dict(field_sumsq=True, velocity_max=True), 2, False),
            ("c float", 3.5, dict(field_sumsq=True, velocity_max=True, apply_bcs=True), 1, True)]


@pytest.mark.parametrize("si", range(len(SHAPES)), ids=lambda i: "x".join(map(str, SHAPES[i])))
@pytest.mark.parametrize("ci", range(len(K1_CASES)), ids=lambda i: K1_CASES[i][0])
def test_defect_tile_by_tile(rng, emulate, si, ci):
    """K1's wrapper in every flag set, f one plane or two, a correction e or
    none, C given or derived from c in the kernel, under one of the plans:
    one launch a call."""
    calls = emulate(_plan(si + ci))
    _, c, kw, planes, with_e = K1_CASES[ci]
    ny, nx = SHAPES[si]
    h = 1.0 / 512
    u, f, e = _ds_inputs(rng, ny, nx)
    C = ds.defect_scalars(c, h, "cpu")
    c_zero = not isinstance(c, torch.Tensor) and c == 0.0
    a = (u, f[:planes], e if with_e else None, 1.0 if with_e else 0.0, h)
    want = ds.defect_pass_plain(*a, C, c_zero, **kw)
    for CC in (C, ds.c_source(c, h)):
        got = ds._defect_cuda(*a, CC, c_zero, **kw)
        _bitwise(got[0], want[0])
        _bitwise(got[1], want[1])
        _sums(got[2], want[2], (1, 2))
    assert kernels.launches["defect"] == len(calls) == 2


def test_defect_takes_a_device_scale(rng, emulate):
    """A 0-dim tensor scale (mg_pcg_ds's step length, computed on the
    device) gives the bits of the same scale as a Python number, through
    the plain version and through the wrapper's one launch."""
    calls = emulate(_plan(1))
    u, f, e = _ds_inputs(rng, 67, 45)
    alpha = torch.tensor(0.37, dtype=torch.float32)
    a = (u, f[:1], e)
    want = ds.defect_pass_plain(*a, float(alpha), 1.0 / 512, None, True)
    for got in (ds.defect_pass_plain(*a, alpha, 1.0 / 512, None, True),
                ds._defect_cuda(*a, alpha, 1.0 / 512, None, True)):
        _bitwise(got[0], want[0])
        _bitwise(got[1], want[1])
    assert kernels.launches["defect"] == len(calls) == 1


def test_defect_stk_writes_into_the_level_state(rng, emulate):
    """defect_pass_stk's r lands in L[1] through the one launch."""
    calls = emulate(_plan(3))
    ny, nx = 67, 113
    h = 1.0 / 512
    u, f, e = _ds_inputs(rng, ny, nx)
    L = torch.stack([e, torch.full_like(e, NAN)])
    r1 = L[1]
    want = ds.defect_pass_plain(u, f[:1], e, 1.0, h, None, True, velocity_max=True)
    got = ds._defect_cuda(u, f[:1], L[0], 1.0, h, None, True, velocity_max=True, r_out=L[1])
    assert got[1].data_ptr() == r1.data_ptr()
    _bitwise(L[1], want[1])
    assert len(calls) == 1


def _rows_windows(a, n_shards, G):
    ny = a.shape[-2]
    ny_l = -(-ny // n_shards)
    ap = torch.nn.functional.pad(a, (0, 0, G, n_shards * ny_l + G - ny))
    return ny_l, [ap[..., d * ny_l:d * ny_l + ny_l + 2 * G, :].contiguous()
                  for d in range(n_shards)]


@pytest.mark.parametrize("ci", range(3), ids=lambda i: K1_CASES[i][0])
def test_defect_tile_by_tile_row_shards(rng, emulate, ci):
    """K1 with the row hooks of 4 row shards: each window bitwise as the
    plain version, its owned rows as the whole grid's."""
    calls = emulate(_plan(2 * ci))
    _, c, kw, _, _ = K1_CASES[ci]
    ny, nx, G = 67, 45, 2
    h = 1.0 / 512
    u, f, e = _ds_inputs(rng, ny, nx)
    C = ds.defect_scalars(c, h, "cpu")
    c_zero = not isinstance(c, torch.Tensor) and c == 0.0
    whole = ds.defect_pass_plain(u, f[:1], e, 1.0, h, C, c_zero, **kw)
    ny_l, us = _rows_windows(u, 4, G)
    _, fs = _rows_windows(f[:1], 4, G)
    _, es = _rows_windows(e, 4, G)
    total = 0.0
    for d in range(4):
        rows = Rows(d * ny_l - G, ny, (G, G + ny_l))
        a = (us[d], fs[d], es[d], 1.0, h, C, c_zero)
        got = ds._defect_cuda(*a, rows=rows, **kw)
        want = ds.defect_pass_plain(*a, rows=rows, **kw)
        _bitwise(got[0], want[0])
        _bitwise(got[1], want[1])
        _sums(got[2][:4], want[2][:4], (1, 2))
        k = min(ny_l, ny - d * ny_l)
        _bitwise(got[0][:, G:G + k], whole[0][:, d * ny_l:d * ny_l + k])
        _bitwise(got[1][G:G + k], whole[1][d * ny_l:d * ny_l + k])
        total += float(got[2][0])
    assert abs(total - float(whole[2][0])) <= 1e-6 * float(whole[2][0])
    assert len(calls) == 4


@pytest.mark.parametrize("pi", [0, 3])
def test_defect_tile_by_tile_2d_mesh(rng, emulate, pi):
    """K1 with the row and column hooks of a 2x2 split (even column
    offsets, ghost columns on both sides): each window bitwise as the plain
    version, its owned cells as the whole grid's."""
    calls = emulate(_plan(pi))
    ny, nx, G, GX = 67, 45, 2, 2
    ny_l, nx_l = 34, 24
    h = 1.0 / 512
    u, f, e = _ds_inputs(rng, ny, nx)
    kw = dict(velocity_max=True, field_sumsq=True)
    whole = ds.defect_pass_plain(u, f[:1], e, 1.0, h, None, True, **kw)

    def window(a, dy, dx):
        ap = torch.nn.functional.pad(a, (GX, 2 * nx_l + GX - nx, G, 2 * ny_l + G - ny))
        return ap[..., dy * ny_l:dy * ny_l + ny_l + 2 * G,
                  dx * nx_l:dx * nx_l + nx_l + 2 * GX].contiguous()

    sums = torch.zeros(4)
    for dy in range(2):
        for dx in range(2):
            k, j = min(ny_l, ny - dy * ny_l), min(nx_l, nx - dx * nx_l)
            hooks = dict(rows=Rows(dy * ny_l - G, ny, (G, G + k)),
                         cols=Cols(dx * nx_l - GX, nx, (GX, GX + j)))
            a = (window(u, dy, dx), window(f[:1], dy, dx), window(e, dy, dx), 1.0, h, None,
                 True)
            got = ds._defect_cuda(*a, **hooks, **kw)
            want = ds.defect_pass_plain(*a, **hooks, **kw)
            _bitwise(got[0], want[0])
            _bitwise(got[1], want[1])
            _sums(got[2][:4], want[2][:4], (1, 2))
            _bitwise(got[0][:, G:G + k, GX:GX + j],
                     whole[0][:, dy * ny_l:dy * ny_l + k, dx * nx_l:dx * nx_l + j])
            _bitwise(got[1][G:G + k, GX:GX + j],
                     whole[1][dy * ny_l:dy * ny_l + k, dx * nx_l:dx * nx_l + j])
            sums[0] += got[2][0]
            sums[3] += got[2][3]
            sums[1:3] = torch.maximum(sums[1:3], got[2][1:3])
    _sums(sums, whole[2][:4], (1, 2))
    assert len(calls) == 4


def _ns_inputs(rng, ny, nx):
    TW = torch.tensor(np.stack([rng.random((ny, nx)), rng.standard_normal((ny, nx)) * 10.0])
                      .astype(np.float32))
    S = torch.tensor(np.stack([rng.standard_normal((ny, nx)) * 0.1,
                               rng.standard_normal((ny, nx)) * 1e-9]).astype(np.float32))
    dt = torch.tensor(1.9e-6, dtype=torch.float32)
    cT = torch.tensor(1.0, dtype=torch.float32) / (0.5 * dt)
    return TW, S, dt, cT, cT / torch.tensor(0.01, dtype=torch.float32)


# mode, beta, with_defect, helm
NS_CASES = [("explicit", 0.0, True, False), ("explicit", 0.0, False, False),
            ("explicit", 1.0, False, False), ("rhs", 0.5, False, False),
            ("rhs", 1.0, False, False), ("rhs", 0.5, False, True)]


def _ns_id(i):
    mode, beta, wd, helm = NS_CASES[i]
    return f"{mode}{beta}{'-defect' * wd}{'-helm' * helm}"


@pytest.mark.parametrize("si", range(len(SHAPES)), ids=lambda i: "x".join(map(str, SHAPES[i])))
@pytest.mark.parametrize("ci", range(len(NS_CASES)), ids=_ns_id)
def test_ns_fused_tile_by_tile(rng, emulate, si, ci):
    """K4's wrapper in every mode, the Helmholtz defects included, under one
    of the plans: one launch a call, counted under its mode."""
    calls = emulate(_plan(si + 2 * ci))
    mode, beta, wd, helm = NS_CASES[ci]
    ny, nx = SHAPES[si]
    h = 1.0 / (ny - 1)
    TW, S, dt, cT, cW = _ns_inputs(rng, ny, nx)
    scal = (dt, cT, cW) if mode == "rhs" else (dt, None, None)
    a = (TW, S if wd else S[0], scal, h, 0.01, 1e6, 1.0, beta, mode, wd, None, helm)
    got = ns_fused._ns_fused_cuda(*a)
    want = ns_fused.ns_fused_plain(*a)
    _bitwise(got[0], want[0])
    if wd or helm:
        _bitwise(got[1], want[1])
    _sums(got[2], want[2], (3, 4))
    assert len(calls) == 1
    assert kernels.launches["ns_fused_helm" if helm else "ns_fused"] == 1


@pytest.mark.parametrize("ci", [0, 3, 5], ids=_ns_id)
def test_ns_fused_tile_by_tile_row_shards(rng, emulate, ci):
    """K4 with the row hooks of 4 row shards: each window bitwise as the
    plain version, its owned rows as the whole grid's."""
    calls = emulate(_plan(ci))
    mode, beta, wd, helm = NS_CASES[ci]
    ny, nx, G = 67, 45, 2
    h = 1.0 / (ny - 1)
    TW, S, dt, cT, cW = _ns_inputs(rng, ny, nx)
    SS = S if wd else S[0]
    scal = (dt, cT, cW) if mode == "rhs" else (dt, None, None)
    whole = ns_fused.ns_fused_plain(TW, SS, scal, h, 0.01, 1e6, 1.0, beta, mode, wd, None, helm)
    ny_l, TWs = _rows_windows(TW, 4, G)
    _, Ss = _rows_windows(SS, 4, G)
    for d in range(4):
        rows = Rows(d * ny_l - G, ny, (G, G + ny_l))
        a = (TWs[d], Ss[d], scal, h, 0.01, 1e6, 1.0, beta, mode, wd, rows, helm)
        got = ns_fused._ns_fused_cuda(*a)
        want = ns_fused.ns_fused_plain(*a)
        _bitwise(got[0], want[0])
        if wd or helm:
            _bitwise(got[1], want[1])
        _sums(got[2], want[2], (3, 4))
        k = min(ny_l, ny - d * ny_l)
        _bitwise(got[0][:, G:G + k], whole[0][:, d * ny_l:d * ny_l + k])
    assert len(calls) == 4


@pytest.mark.parametrize("pi", [0, 6])
def test_public_calls_are_one_launch(rng, emulate, monkeypatch, pi):
    """defect_pass, defect_pass_stk and ns_fused_rp in each mode through the
    CUDA wrappers: one launch each, with the rms and sums read off the
    launch's output as the plain path gives them."""
    ny, nx = 67, 113
    h = 1.0 / 512
    u, f, e = _ds_inputs(rng, ny, nx)
    TW, S, dt, cT, cW = _ns_inputs(rng, ny, nx)
    calls = [
        lambda: ds.defect_pass(u, f[:1], e, 1.0, h, 0.0, velocity_max=True),
        lambda: ds.defect_pass(u, f, None, 0.0, h, CT, apply_bcs=True, raw_sumsq=True),
        lambda: ds.defect_pass_stk(u, f[:1], torch.stack([e, e]), 1.0, h, 0.0,
                                   field_sumsq=True),
        lambda: ns_fused.ns_fused_rp(TW, S, dt, h, 0.01, 1e6, mode="explicit",
                                     with_defect=True),
        lambda: ns_fused.ns_fused_rp(TW, S[0], dt, h, 0.01, 1e6, beta=0.5, mode="rhs", cT=cT,
                                     cW=cW, with_sumsq=True),
        lambda: ns_fused.ns_fused_rp(TW, S[0], dt, h, 0.01, 1e6, beta=0.5, mode="rhs", cT=cT,
                                     cW=cW, with_helm_defect=True),
    ]
    wants = [fn() for fn in calls]
    launched = emulate(_plan(pi))
    monkeypatch.setattr(ds, "defect_pass_plain", ds._defect_cuda)
    monkeypatch.setattr(ns_fused, "ns_fused_plain", ns_fused._ns_fused_cuda)
    for i, (fn, want) in enumerate(zip(calls, wants)):
        got = fn()
        assert len(launched) == i + 1
        flat_g = [x for g in got for x in (g if isinstance(g, tuple) else (g,))]
        flat_w = [x for w in want for x in (w if isinstance(w, tuple) else (w,))]
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            if g.dim() == 0:
                assert math.isclose(float(g), float(w), rel_tol=1e-6, abs_tol=1e-30)
            else:
                _bitwise(g, w)


def test_tile_plan():
    """The plan: S within the tile's bounds, at most one block a tile and
    no more than the card holds; one block where the card holds one."""
    for ny, nx in SHAPES + [(513, 2049), (4097, 4097)]:
        for sms, per_sm in ((132, 8), (132, 4), (1, 1), (2, 3)):
            S, blocks = kernels.tile_plan(ny, nx, sms, per_sm)
            assert 1 <= S <= kernels.TILE_S_MAX
            assert 1 <= blocks <= min(kernels.n_tiles(ny, nx, S), sms * per_sm)
    assert kernels.tile_plan(4097, 4097, 1, 1)[1] == 1
    assert kernels.tile_plan(4097, 4097, 132, 5, s_max=3) == (3, 660)
    assert kernels.tile_plan(513, 2049, 132, 4) == (4, 528)
    assert kernels.tile_plan(67, 45, 132, 4) == (1, 18)
    assert kernels.n_tiles(513, 2049, 4) == 65 * 17
