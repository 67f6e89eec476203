"""The port's fused NS operator pass (fpr_tpu_torch.ops.ns_fused, K4) against
fpr_tpu.ops.pallas_ns.ns_fused_rp in interpret mode on the CPU, where the
port runs its plain version.

Tolerances: XLA:CPU contracts a*b+c into FMAs inside jit and eager PyTorch
does not, so outputs differ by a few float32 ulps: 16 ulps of max|out|.
The ds defect r = A S - W' cancels terms of size 8 max|S|/h^2, so it is
held to 16 ulps of that scale plus max|W'|.  Sums of squares are taken in
another order: 1e-5 relative; the curl maxima are maxima of values equal
to a few ulps: 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import pallas2d, pallas_ns
from fpr_tpu_torch.ops import ns_fused

EPS32 = float(np.finfo(np.float32).eps)
NY, NX = 65, 129
H = 1.0 / 64
PR, RA = 0.01, 1e6


def _fields(rng):
    T = rng.random((NY, NX)).astype(np.float32)
    W = (rng.standard_normal((NY, NX)) * 10.0).astype(np.float32)
    Sh = (rng.standard_normal((NY, NX)) * 0.1).astype(np.float32)
    Sl = (rng.standard_normal((NY, NX)) * 1e-9).astype(np.float32)
    return T, W, Sh, Sl


def _jax(T, W, S, dt, **kw):
    br = pallas2d._pick_br(NY, NX, 4)
    pad = lambda a: pallas2d.pad2d(jnp.asarray(a), br)  # noqa: E731
    S_j = jnp.stack([pad(s) for s in S]) if S.ndim == 3 else pad(S)
    return pallas_ns.ns_fused_rp(jnp.stack([pad(T), pad(W)]), S_j, jnp.float32(dt),
                                 NY, NX, br, H, PR, RA, **kw)


def _unp(a):
    return np.asarray(pallas2d.unpad2d(a, NY, NX))


def _close_fields(got, want):
    for i in range(2):
        g, w = got[i].numpy(), _unp(want[i])
        assert np.abs(g - w).max() <= 16 * EPS32 * np.abs(w).max(), i


def _close_sums(got, want, rel=1e-5):
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= rel * abs(float(w)) + 1e-30


def test_explicit_with_defect(rng):
    T, W, Sh, Sl = _fields(rng)
    dt = np.float32(1.3e-5)
    out, ss, (r, rr), ex = _jax(T, W, np.stack([Sh, Sl]), dt, mode="explicit",
                                with_defect=True)
    o2, ss2, (r2, rr2), ex2 = ns_fused.ns_fused_rp(
        torch.tensor(np.stack([T, W])), torch.tensor(np.stack([Sh, Sl])),
        torch.tensor(dt), H, PR, RA, mode="explicit", with_defect=True)
    _close_fields(o2, out)
    scale = 8 * np.abs(Sh).max() / H**2 + np.abs(_unp(out[1])).max()
    assert np.abs(r2.numpy() - _unp(r)).max() <= 16 * EPS32 * scale
    _close_sums(ss2, ss)
    _close_sums((rr2,), (rr,))
    _close_sums(ex2[:2], ex[:2], rel=1e-6)
    assert float(ex2[2]) == 0.0
    # boundary contract: T' carries the BC'd T, W' the old W
    Tn = o2[0].numpy()
    assert (Tn[0] == 1.0).all() and (Tn[-1] == 0.0).all()
    np.testing.assert_array_equal(Tn[1:-1, 0], T[1:-1, 1])
    np.testing.assert_array_equal(o2[1].numpy()[0], W[0])


@pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
def test_rhs_with_sumsq(rng, beta):
    T, W, Sh, _ = _fields(rng)
    dt = np.float32(2.1e-5)
    cT = np.float32(1.0 / (max(beta, 0.5) * dt))
    cW = np.float32(cT / PR)
    out, ss = _jax(T, W, Sh, dt, beta=beta, mode="rhs", cT=jnp.float32(cT),
                   cW=jnp.float32(cW), with_sumsq=True)
    o2, ss2 = ns_fused.ns_fused_rp(
        torch.tensor(np.stack([T, W])), torch.tensor(Sh), torch.tensor(dt), H, PR, RA,
        beta=beta, mode="rhs", cT=torch.tensor(cT), cW=torch.tensor(cW),
        with_sumsq=True)
    _close_fields(o2, out)
    _close_sums(ss2, ss)


def test_explicit_without_defect_and_beta_one_skips_diffusion(rng):
    """Without with_defect the pass returns the bare stacked output; at
    beta = 1 the diffusion terms vanish from the rhs (pallas_ns.py:198-208)."""
    T, W, Sh, _ = _fields(rng)
    dt = torch.tensor(np.float32(1e-5))
    TW = torch.tensor(np.stack([T, W]))
    out = ns_fused.ns_fused_rp(TW, torch.tensor(Sh), dt, H, PR, RA, mode="explicit")
    assert out.shape == (2, NY, NX)
    flat = torch.tensor(np.zeros((NY, NX), np.float32))
    cT, cW = torch.tensor(2.0), torch.tensor(3.0)
    a = ns_fused.ns_fused_rp(TW, flat, dt, H, PR, RA, beta=1.0, mode="rhs", cT=cT, cW=cW)
    W_int = torch.tensor(W)[1:-1, 1:-1]
    # S = 0: no advection; beta = 1: no diffusion; W' = -cW (W - dt Pr B)
    assert not torch.equal(a[1][1:-1, 1:-1], -cW * W_int)
    b = ns_fused.ns_fused_rp(TW, flat, dt, H, PR, 0.0, beta=1.0, mode="rhs", cT=cT, cW=cW)
    torch.testing.assert_close(b[1][1:-1, 1:-1], -cW * W_int, rtol=0, atol=0)


def test_rejects_bad_modes(rng):
    TW = torch.zeros((2, 9, 9))
    dt = torch.tensor(1.0)
    with pytest.raises(ValueError):
        ns_fused.ns_fused_rp(TW, torch.zeros((9, 9)), dt, 0.125, 1.0, 1.0, mode="rhs")
    with pytest.raises(ValueError):
        ns_fused.ns_fused_rp(TW, torch.zeros((9, 9)), dt, 0.125, 1.0, 1.0,
                             with_defect=True)


def _helm_inputs(rng):
    """test_pallas_ns.py:154-208's inputs: 65x257, beta 0.5, dt 1e-4."""
    ny, nx = 65, 257
    T, W, S = (rng.standard_normal((ny, nx)).astype(np.float32) for _ in range(3))
    dt = np.float32(1e-4)
    cT = np.float32(1.0) / (np.float32(0.5) * dt)
    return ny, nx, T, W, S, dt, cT, np.float32(cT / np.float32(0.01))


def _port_helm(T, W, S, dt, cT, cW, h, **kw):
    return ns_fused.ns_fused_rp(torch.tensor(np.stack([T, W])), torch.tensor(S),
                                torch.tensor(dt), h, 0.01, 1e6, mode="rhs", beta=0.5,
                                cT=torch.tensor(cT), cW=torch.tensor(cW), **kw)


def test_helm_defect_matches_jax(rng):
    """with_helm_defect against fpr_tpu's in interpret mode.  XLA:CPU
    contracts the rhs pass's a*b+c into FMAs (see the top of this file), so
    the rhs is held to 16 ulps and its sums to 1e-5; the two warm-start
    defects, which are ds arithmetic, equal fpr_tpu's defect pass on the
    same rhs bitwise (that pass equals fpr_tpu's with_helm_defect bitwise,
    tests/test_pallas_ns.py:154-208), and their rms values agree with
    fpr_tpu's with_helm_defect within 1e-5."""
    from fpr_tpu.ops import ds as jds

    ny, nx, T, W, S, dt, cT, cW = _helm_inputs(rng)
    h = 1.0 / (ny - 1)
    br = pallas2d._pick_br(ny, nx, 4)
    pad = lambda a: pallas2d.pad2d(jnp.asarray(a), br)  # noqa: E731
    unp = lambda a: np.asarray(pallas2d.unpad2d(a, ny, nx))  # noqa: E731
    out_j, ss_j, (_, rTr_j), (_, rWr_j) = pallas_ns.ns_fused_rp(
        jnp.stack([pad(T), pad(W)]), pad(S), jnp.float32(dt), ny, nx, br, h, 0.01, 1e6,
        mode="rhs", beta=0.5, cT=jnp.float32(cT), cW=jnp.float32(cW), with_helm_defect=True)
    out, ss, (rT, rTr), (rW, rWr) = _port_helm(T, W, S, dt, cT, cW, h, with_helm_defect=True)
    for i in range(2):
        g, w = out[i].numpy(), unp(out_j[i])
        assert np.abs(g - w).max() <= 16 * EPS32 * np.abs(w).max(), i
    _close_sums(ss, ss_j)
    _close_sums((rTr, rWr), (rTr_j, rWr_j))
    zeros = jnp.zeros_like(pad(T))
    for X, r, c, plane, bcs in ((T, rT, cT, 0, True), (W, rW, cW, 1, False)):
        _, r_j, _ = jds.defect_pass(jnp.stack([pad(X), zeros]), pad(out[plane].numpy())[None],
                                    zeros, 0.0, ny, nx, br, h, jnp.float32(c), apply_bcs=bcs)
        np.testing.assert_array_equal(r.numpy(), unp(r_j))


def test_helm_defect_equals_rhs_and_two_defect_passes(rng):
    """The contract of test_pallas_ns.py:154-208 on the port: the rhs pass
    plus ds.defect_pass on (T, 0) with the BCs and on (W, 0), bitwise."""
    from fpr_tpu_torch.ops import ds

    ny, nx, T, W, S, dt, cT, cW = _helm_inputs(rng)
    h = 1.0 / (ny - 1)
    rhs, (tss, wss) = _port_helm(T, W, S, dt, cT, cW, h, with_sumsq=True)
    zeros = torch.zeros((ny, nx))
    _, rT_ref, rTr_ref = ds.defect_pass(torch.stack([torch.tensor(T), zeros]), rhs[0:1], None,
                                        0.0, h, torch.tensor(cT), apply_bcs=True)
    _, rW_ref, rWr_ref = ds.defect_pass(torch.stack([torch.tensor(W), zeros]), rhs[1:2], None,
                                        0.0, h, torch.tensor(cW))
    out, ss, (rT, rTr), (rW, rWr) = _port_helm(T, W, S, dt, cT, cW, h, with_helm_defect=True)
    torch.testing.assert_close(out, rhs, rtol=0, atol=0)
    torch.testing.assert_close(rT, rT_ref, rtol=0, atol=0)
    torch.testing.assert_close(rW, rW_ref, rtol=0, atol=0)
    assert (float(ss[0]), float(ss[1])) == (float(tss), float(wss))
    assert (float(rTr), float(rWr)) == (float(rTr_ref), float(rWr_ref))


def test_helm_defect_rejects_explicit_and_with_defect(rng):
    TW, S, dt = torch.zeros((2, 9, 9)), torch.zeros((2, 9, 9)), torch.tensor(1.0)
    with pytest.raises(ValueError, match="rhs-only"):
        ns_fused.ns_fused_rp(TW, S[0], dt, 0.125, 1.0, 1.0, with_helm_defect=True)
    with pytest.raises(ValueError, match="explicit-only"):
        ns_fused.ns_fused_rp(TW, S, dt, 0.125, 1.0, 1.0, mode="rhs", cT=dt, cW=dt,
                             with_defect=True, with_helm_defect=True)
