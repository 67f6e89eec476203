"""The CUDA wrapper of #5 (fpr_tpu_torch.ops.stencil_pass: the stencil pass)
on CPU tensors, with its one launch (``stencil_pass._launch``) replaced by
an emulation of csrc/stencil.cu's tile plan: tiles of 32 columns x 8 S
rows, numbered row by row and taken in turn by the plan's blocks; each
tile's u loaded for the tile and the halo cells that the kernel loads
(``halo_cell``: a ring of one cell without its corners, or for smooth2
two rings with them), NaN everywhere else; smooth2's first sweep on the
tile and the ring of one cell around it, f read there where the cell is
interior, its second sweep on the tile; each block's sum over its tiles
as its partial, the partials added by a "last block".

Fields are held bitwise to ``stencil_plain`` (the same operations in the
same order, each rounded on its own), sums to 1e-6 relative in float32
and 1e-12 in float64 (another order of the adds).  Each call must be one
launch.
"""

import pytest
import torch

from fpr_tpu_torch import kernels
from fpr_tpu_torch.ops import stencil_pass as sp

TX, TW = kernels.TILE_X, kernels.TILE_WARPS
NAN = float("nan")
MODES = list(sp.MODES)
DTYPES = [torch.float32, torch.float64]
# ragged shapes: a last tile of one column (65x97), of 13 (67x45)
SHAPES = [(17, 33), (67, 45), (130, 257), (65, 97)]
# plans: a card given to kernels.tile_plan as (SMs, blocks an SM), or S
# forced with up to 5 blocks
PLANS = [("card", (132, 8)), ("card", (1, 1)), ("card", (2, 3)), ("S", 1), ("S", 2),
         ("S", 3), ("S", 4)]


def _halo_cell(j, H, TY):
    """csrc/stencil.cu's halo_cell: cell j of the halo of H cells around a
    tile of TY rows, in tile coordinates."""
    wide = TX + 2 * H
    band = H * wide
    if j < 2 * band:
        k = j if j < band else j - band
        return (k // wide - H if j < band else TY + k // wide), k % wide - H
    side = H * TY
    k = j - 2 * band
    kk = k if k < side else k - side
    return kk % TY, (kk // TY - H if k < side else TX + kk // TY)


def _loaded(H, TY):
    """The cells of a tile's plane, (TY + 2H) x (TX + 2H), that the kernel
    loads: the tile and its halo."""
    m = torch.zeros((TY + 2 * H, TX + 2 * H), dtype=torch.bool)
    m[H:H + TY, H:H + TX] = True
    for j in range(2 * H * (TX + 2 * H) + 2 * H * TY):
        ry, rx = _halo_cell(j, H, TY)
        m[ry + H, rx + H] = True
    return m


def _plane(a, y0, x0, TY, H, mask):
    """a over rows y0-H .. y0+TY+H-1 and columns x0-H .. x0+TX+H-1, zeros
    past the field's edges (as the kernel stores), NaN off mask."""
    ny, nx = a.shape
    P = a.new_zeros((TY + 2 * H, TX + 2 * H))
    ya, yb, xa, xb = max(y0 - H, 0), min(y0 + TY + H, ny), max(x0 - H, 0), min(x0 + TX + H, nx)
    P[ya - y0 + H:yb - y0 + H, xa - x0 + H:xb - x0 + H] = a[ya:yb, xa:xb]
    return torch.where(mask, P, NAN)


def _interior(y0, x0, rows, cols, ny, nx):
    y = torch.arange(y0, y0 + rows)[:, None]
    x = torch.arange(x0, x0 + cols)[None, :]
    return (y > 0) & (y < ny - 1) & (x > 0) & (x < nx - 1)


def _sweep(P, F, interior, C, inv_h2, wgt):
    """A Jacobi sweep on the inner cells of plane P, in the plain version's
    order: (their values + wgt res, res)."""
    core = P[1:-1, 1:-1]
    near = P[:-2, 1:-1] + P[2:, 1:-1] + P[1:-1, :-2] + P[1:-1, 2:]
    r = torch.where(interior, (near - C * core) * inv_h2 - F, 0.0)
    return core + wgt * r, r


def _emulated(calls):
    """stencil_pass._launch done tile by tile."""

    def launch(mode, u, f, c, h, alpha, out, partials, sums, plan):
        S, blocks = plan
        ny, nx = u.shape
        TY = TW * S
        H = 2 if mode == "smooth2" else 1
        assert (partials is None) == (sums is None)
        assert partials is None or partials.numel() == blocks
        assert 1 <= blocks <= kernels.n_tiles(ny, nx, S)
        h2, inv_h2 = u.new_full((), float(h) * float(h)), u.new_full((), 1.0 / (float(h) ** 2))
        C = 4.0 + c * h2
        wgt = u.new_full((), float(alpha)) * (h2 / C)
        mask = _loaded(H, TY)
        if out is not None:
            out.fill_(NAN)
        acc = torch.zeros(blocks, dtype=u.dtype)
        tiles_x = -(-nx // TX)
        for t in range(kernels.n_tiles(ny, nx, S)):
            y0, x0 = t // tiles_x * TY, t % tiles_x * TX
            P = _plane(u, y0, x0, TY, H, mask)
            if mode == "smooth2":
                # sweep 1 on the tile and one ring, f read where interior
                ring = _interior(y0 - 1, x0 - 1, TY + 2, TX + 2, ny, nx)
                F = _plane(f, y0, x0, TY, 1, torch.ones((TY + 2, TX + 2), dtype=torch.bool))
                P, _ = _sweep(P, torch.where(ring, F, NAN), ring, C, inv_h2, wgt)
            core = P[1:-1, 1:-1]
            interior = _interior(y0, x0, TY, TX, ny, nx)
            if mode in ("matvec", "matvec_dot"):
                near = P[:-2, 1:-1] + P[2:, 1:-1] + P[1:-1, :-2] + P[1:-1, 2:]
                o = torch.where(interior, (near - 4.0 * core) * inv_h2 - c * core, 0.0)
                terms = core * o
            else:
                F = _plane(f, y0, x0, TY, 0, torch.ones((TY, TX), dtype=torch.bool))
                o, r = _sweep(P, F, interior, C, inv_h2, wgt)
                terms = r * r
                if mode == "residual":
                    o = r
            ty, tx = min(TY, ny - y0), min(TX, nx - x0)
            if out is not None:
                out[y0:y0 + ty, x0:x0 + tx] = o[:ty, :tx]
            acc[t % blocks] += torch.sum(terms[:ty, :tx])
        if sums is not None:
            partials.copy_(acc)
            total = partials.sum()
            sums[0] = total
            if not mode.startswith("matvec"):
                sums[1] = torch.sqrt(total / total.new_full((), float(ny * nx)))
        calls.append((mode, S, blocks))

    return launch


@pytest.fixture
def emulate(monkeypatch):
    """emulate(plan): the CUDA wrapper on CPU tensors from then on, its
    launch emulated under the plan; returns the launches' records."""

    def start(plan):
        kind, arg = plan
        calls = []
        monkeypatch.setattr(sp, "_launch", _emulated(calls))
        monkeypatch.setattr(kernels, "require_cuda", lambda name, dtypes, *tensors: None)
        if kind == "card":
            monkeypatch.setattr(kernels, "card_fill", lambda fill, variant, index: arg)
        else:
            monkeypatch.setattr(kernels, "tile_plan", lambda ny, nx, sms, per_sm, s_max=4: (
                arg, min(5, kernels.n_tiles(ny, nx, arg))))
            monkeypatch.setattr(kernels, "card_fill", lambda fill, variant, index: (1, 1))
        kernels.reset_launches()
        return calls

    return start


def _sums_close(got, want, dtype):
    rel = 1e-6 if dtype == torch.float32 else 1e-12
    assert got.shape == want.shape
    for g, w in zip(got.tolist(), want.tolist()):
        assert abs(g - w) <= rel * max(abs(w), 1e-30), (g, w)


@pytest.mark.parametrize("si", range(len(SHAPES)), ids=lambda i: "x".join(map(str, SHAPES[i])))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_stencil_tile_by_tile(rng, emulate, si, dtype, mode):
    """Every mode, with and without the sum, c as a number and as a 0-dim
    tensor, under one of the plans: fields bitwise, one launch a call."""
    calls = emulate(PLANS[(si + MODES.index(mode) + DTYPES.index(dtype)) % len(PLANS)])
    ny, nx = SHAPES[si]
    h = 1.0 / 64
    u = torch.tensor(rng.standard_normal((ny, nx)), dtype=dtype)
    f = None if mode.startswith("matvec") else torch.tensor(rng.standard_normal((ny, nx)),
                                                            dtype=dtype)
    n = 0
    for c in (0.0, torch.tensor(41.25, dtype=dtype)):
        for with_acc in (True, False):
            got = sp._stencil_cuda(mode, u, f, h, c, 0.8, with_acc)
            want = sp.stencil_plain(mode, u, f, h, c, 0.8, with_acc)
            n += 1
            if mode == "matvec_dot":
                assert got[0] is None and want[0] is None
            else:
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
            if with_acc or mode == "matvec_dot":
                _sums_close(got[1], want[1], dtype)
            else:
                assert got[1] is None and want[1] is None
    assert kernels.launches["stencil"] == len(calls) == n


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_public_calls_launch_once(rng, emulate, monkeypatch, dtype):
    """Each public entry point, routed as a CUDA tensor is, is one launch,
    smooth2 included, and returns the plain version's field and its sum or
    rms; smooth2_rp(with_norm=False) returns None."""
    u = torch.tensor(rng.standard_normal((67, 45)), dtype=dtype)
    f = torch.tensor(rng.standard_normal((67, 45)), dtype=dtype)
    h, c = 1.0 / 64, torch.tensor(3.5, dtype=dtype)
    plain = {mode: sp.stencil_plain(mode, u, None if mode.startswith("matvec") else f, h, c)
             for mode in MODES}
    calls = emulate(PLANS[3])
    monkeypatch.setattr(sp, "_pass", lambda mode, u, f, h, c, alpha=0.8, with_acc=False:
                        sp._stencil_cuda(mode, u, f, h, c, alpha, with_acc))
    for mode, call, field, total in (
            ("smooth", lambda: sp.smooth_rp(u, f, h, c), 0, 1),
            ("smooth2", lambda: sp.smooth2_rp(u, f, h, c), 0, 1),
            ("residual", lambda: (sp.residual_rp(u, f, h, c), None), 0, None),
            ("matvec", lambda: sp.matvec_rp(u, h, c, with_dot=True), 0, 0),
            ("matvec_dot", lambda: (None, sp.matvec_dot_rp(u, h, c)), None, 0)):
        before = len(calls)
        got = call()
        assert len(calls) == before + 1, mode
        out, sums = plain[mode]
        if field is not None:
            torch.testing.assert_close(got[0], out, rtol=0, atol=0)
        if total is not None:
            assert got[1].dim() == 0
            _sums_close(got[1][None], sums[total][None], dtype)
    out, none = sp.smooth2_rp(u, f, h, c, with_norm=False)
    assert none is None
    torch.testing.assert_close(out, plain["smooth2"][0], rtol=0, atol=0)
    assert kernels.launches["stencil"] == len(calls) == 6
    assert {m: kernels.launches[f"stencil_{m}"] for m in MODES} == {
        "smooth": 1, "smooth2": 2, "residual": 1, "matvec": 1, "matvec_dot": 1}
