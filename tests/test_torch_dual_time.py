"""The port's float32 pseudo-time kernel (fpr_tpu_torch.ops.dual_time) and
its JNP tier (ops.stencil3d) against fpr_tpu.ops.pallas3d and
fpr_tpu.ops.stencil3d, on the CPU, where the port runs the kernel's plain
PyTorch version and the Pallas kernels run in interpret mode.  The same
state goes to both sides through the port's layout converters.

Tolerances: float64 fields at atol 1e-14, as tests/test_pallas3d.py holds
JAX's own kernels.  float32 fields within 16 ulps of max|H|: XLA:CPU
contracts multiply-adds into FMAs inside jit and eager PyTorch rounds
every operation on its own, so a few roundings per iteration differ, each
by an ulp of the field's scale (the stencil terms enter through dtau,
which scales them back to |H|), over at most 8 iterations.  Sums of
squares are taken in another order: 1e-12 relative in float64, 1e-5 in
float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpr_tpu.ops import pallas3d
from fpr_tpu.ops import stencil3d as jst
from fpr_tpu_torch import kernels
from fpr_tpu_torch.ops import dual_time, stencil3d

ARGS = dict(dt=0.2, dtau=1e-3, dx=0.1, dy=0.11, dz=0.12, D=1.0)
DTYPES = {"f64": (np.float64, 1e-14, 1e-12), "f32": (np.float32, None, 1e-5)}


def _fields(rng, shape, np_dtype):
    return rng.random(shape).astype(np_dtype), rng.random(shape).astype(np_dtype)


def _agree(got, want, sum_got, sum_want, dtype):
    _, atol, rel = DTYPES[dtype]
    if atol is None:
        atol = 16 * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)
    assert abs(float(sum_got) - float(sum_want)) <= rel * abs(float(sum_want))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(8, 8, 16), (12, 20, 24)])
def test_plain_step_matches_pallas(rng, shape, dtype):
    """Port state -> JAX layout -> _dual_time_kernel, against the port's
    plain iteration, compared back on physical cells."""
    Ht, Htau = (torch.tensor(a) for a in _fields(rng, shape, DTYPES[dtype][0]))
    out_j, s_j = pallas3d.dual_time_step_padded(
        jnp.asarray(dual_time.state_to_jax(Ht, "pad_ht")),
        jnp.asarray(dual_time.state_to_jax(Htau, "pad3d")), shape, **ARGS)
    out_t, s_t = dual_time.dual_time_step(Ht, Htau, **ARGS)
    assert out_t.dtype == Htau.dtype and out_t.data_ptr() != Htau.data_ptr()
    want = dual_time.state_from_jax(np.asarray(out_j), shape, "pad3d")
    _agree(out_t, want, s_t, s_j, dtype)
    # boundary cells pass through unchanged
    torch.testing.assert_close(out_t[0], Htau[0], rtol=0, atol=0)
    torch.testing.assert_close(out_t[:, :, -1], Htau[:, :, -1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_stepk_matches_stacked(rng, K, dtype):
    """K iterations per call against dual_time_stepk_stacked (block_z=4:
    three blocks, the multi-block halo arithmetic), two consecutive calls,
    the JAX state handed to the port once at the start."""
    shape = (12, 20, 24)
    Ht_np, Htau_np = _fields(rng, shape, DTYPES[dtype][0])
    state = jnp.asarray(dual_time.stack_state_k(Ht_np, Htau_np, K))
    Ht, Htau = dual_time.state_from_jax(np.asarray(state), shape, "stacked", K)
    scratch = torch.empty_like(Htau)
    for _ in range(2):
        state, s_j = pallas3d.dual_time_stepk_stacked(state, shape, K=K, block_z=4, **ARGS)
        out, s_t = dual_time.dual_time_stepk(Ht, Htau, K, **ARGS, scratch=scratch)
        assert out is scratch  # the buffer contract: the result in scratch
        Htau, scratch = out, (Htau if out is scratch else scratch)
        Ht_j, Htau_j = dual_time.state_from_jax(np.asarray(state), shape, "stacked", K)
        torch.testing.assert_close(Ht_j, Ht, rtol=0, atol=0)  # Ht planes persist
        _agree(Htau, Htau_j, s_t, s_j, dtype)


def test_stepk_is_k_single_steps(rng):
    """The K-call is exactly K plain iterations; its sum is the last one's."""
    Ht, Htau = (torch.tensor(a) for a in _fields(rng, (10, 9, 11), np.float32))
    want, s = Htau, None
    for _ in range(3):
        want, s = dual_time.dual_time_step(Ht, want, **ARGS)
    got, s3 = dual_time.dual_time_stepk(Ht, Htau.clone(), 3, **ARGS)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(s3) == float(s)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_jnp_tier_matches_jax(rng, dtype):
    shape = (12, 20, 24)
    Ht, Htau = _fields(rng, shape, DTYPES[dtype][0])
    want, got = jnp.asarray(Htau), torch.tensor(Htau)
    for _ in range(3):
        want, s_j = jst.dual_time_step(jnp.asarray(Ht), want, **ARGS)
        got, s_t = stencil3d.dual_time_step(torch.tensor(Ht), got, **ARGS)
    _agree(got, np.asarray(want), s_t, s_j, dtype)


def test_jnp_tier_divides_kernel_multiplies():
    """The two tiers round differently on purpose: JNP divides by dt, the
    kernel multiplies by 1/dt (stencil3d.py:46 vs pallas3d.py:233)."""
    rng = np.random.default_rng(3)
    Ht, Htau = (torch.tensor(a) for a in _fields(rng, (16, 16, 16), np.float32))
    args = dict(ARGS, dt=0.3)
    a, _ = stencil3d.dual_time_step(Ht, Htau, **args)
    b, _ = dual_time.dual_time_step(Ht, Htau, **args)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=0, atol=16 * 2.0**-23)


def test_converters_match_pallas3d(rng):
    shape = (6, 10, 9)
    Ht_np, Htau_np = _fields(rng, shape, np.float64)
    Ht, Htau = torch.tensor(Ht_np), torch.tensor(Htau_np)
    for layout, fn, H in (("pad3d", pallas3d.pad3d, Htau), ("pad_ht", pallas3d.pad_ht, Ht)):
        a = dual_time.state_to_jax(H, layout)
        np.testing.assert_array_equal(a, np.asarray(fn(jnp.asarray(H.numpy()))))
        torch.testing.assert_close(dual_time.state_from_jax(a, shape, layout), H,
                                   rtol=0, atol=0)
    st = dual_time.state_to_jax((Ht, Htau), "stacked", K=3)
    np.testing.assert_array_equal(
        st, np.asarray(pallas3d.stack_state_k(jnp.asarray(Ht_np), jnp.asarray(Htau_np), 3)))
    np.testing.assert_array_equal(dual_time.unstack_state_k(st, shape, 3), Htau_np)
    back = dual_time.state_from_jax(st, shape, "stacked", K=3)
    torch.testing.assert_close(back[0], Ht, rtol=0, atol=0)
    torch.testing.assert_close(back[1], Htau, rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout"):
        dual_time.state_from_jax(st, shape, "padded")


def test_wrappers_refuse_bad_buffers():
    H = torch.zeros((5, 6, 7))
    Hs = H.clone()
    with pytest.raises(ValueError, match="must not be Htau"):
        dual_time.dual_time_step(H, Hs, **ARGS, out=Hs)
    with pytest.raises(ValueError, match="does not match"):
        dual_time.dual_time_step(torch.zeros((5, 6, 8)), Hs, **ARGS)
    with pytest.raises(ValueError, match="K must be"):
        dual_time.dual_time_stepk(H, Hs, 0, **ARGS)
    # a CPU tensor never reaches the CUDA wrapper's launch: it refuses
    with pytest.raises(ValueError, match="CUDA tensor"):
        dual_time._dual_time_cuda(H, Hs, dual_time.coeffs(**ARGS))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dual_time._dual_timek_cuda(H, Hs, 2, dual_time.coeffs(**ARGS))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dual_time._dual_time_stepk_padded_cuda(torch.zeros((7, 6, 7)), torch.zeros((9, 6, 7)),
                                               2, dual_time.coeffs(**ARGS), (1, 3))


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5])
def test_stepk_buffer_contract(rng, K):
    """The K-call writes its result into scratch and leaves Htau bitwise
    unwritten, and the result is K single steps."""
    Ht, Htau = (torch.tensor(a) for a in _fields(rng, (9, 10, 11), np.float32))
    Htau0, scratch = Htau.clone(), torch.full_like(Htau, float("nan"))
    want, s = Htau, None
    for _ in range(K):
        want, s = dual_time.dual_time_step(Ht, want, **ARGS)
    out, sk = dual_time.dual_time_stepk(Ht, Htau, K, **ARGS, scratch=scratch)
    assert out is scratch
    torch.testing.assert_close(Htau, Htau0, rtol=0, atol=0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert float(sk) == float(s)


@pytest.mark.parametrize("K", range(1, 14))
def test_split_passes(K):
    ks = dual_time.split_passes(K)
    assert sum(ks) == K and max(ks) <= kernels.K_MAX
    assert len(ks) == -(-K // kernels.K_MAX) and max(ks) - min(ks) <= 1
    assert ks == sorted(ks, reverse=True)


@pytest.fixture
def launch_plain(monkeypatch):
    """The CUDA wrappers' Python side on CPU tensors: ``_launch_k`` does the
    kernel's function in plain PyTorch (each sweep updates its box over
    every plane and copies the rest; the planes of the last sweep into out;
    the norm into partials[0]).  Returns the launches' records
    (sweeps, planes, norm taken)."""
    calls = []

    def launch_k(Ht, src, cf, out, partials, zboxes, planes, ht_shift):
        nz, ny, nx = src.shape
        cur = src
        for z0, z1 in zboxes:
            nxt = torch.empty_like(cur)
            dh = dual_time.dual_time_box_plain(Ht, cur, cf, (z0, z1, 1, ny - 2, 1, nx - 2),
                                               (0, nz - 1), nxt, None, ht_shift)
            cur = nxt
        out[planes[0]:planes[1] + 1] = cur[planes[0]:planes[1] + 1]
        if partials is not None:
            partials.zero_()
            partials[0] = torch.sum(dh * dh)
        calls.append((len(zboxes), planes, partials is not None))

    monkeypatch.setattr(dual_time, "_launch_k", launch_k)
    monkeypatch.setattr(kernels, "require_cuda_f32", lambda *tensors: None)
    return calls


@pytest.mark.parametrize("K", range(1, 10))
def test_fused_passes_stepk(rng, launch_plain, K):
    """#10's wrapper on the card: split_passes(K) launches, the norm from
    the last, the result in scratch, Htau unwritten, equal to the plain
    version bitwise (fields and norm)."""
    Ht, Htau = (torch.tensor(a) for a in _fields(rng, (10, 9, 11), np.float64))
    Htau0, scratch = Htau.clone(), torch.full_like(Htau, float("nan"))
    out, s = dual_time._dual_timek_cuda(Ht, Htau, K, dual_time.coeffs(**ARGS), scratch)
    want, sw = dual_time.dual_time_stepk_plain(Ht, Htau.clone(), K, dual_time.coeffs(**ARGS))
    assert out is scratch
    torch.testing.assert_close(Htau, Htau0, rtol=0, atol=0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert float(s) == float(sw)
    ks = dual_time.split_passes(K)
    assert launch_plain == [(k, (0, 9), m == len(ks) - 1) for m, k in enumerate(ks)]


@pytest.mark.parametrize("K", range(1, 8))
@pytest.mark.parametrize("edge", ["whole", "first", "interior", "last"])
def test_fused_passes_stepk_padded(rng, launch_plain, K, edge):
    """#9's wrapper on the card: a pass ending at sweep j writes the window
    (j, nz-1-j), the last one the owned planes, which equal the plain
    version's bitwise; the norm (summed in another order) within 1e-12."""
    nzl, ny, nx = 9, 8, 10
    nz = nzl + 2 * K
    Ht_k = torch.tensor(rng.random((nz - 2, ny, nx)))
    Hp = torch.tensor(rng.random((nz, ny, nx)))
    zb = {"whole": (1, nzl - 2), "first": (1, nzl - 1 + K), "interior": (-K, nzl - 1 + K),
          "last": (-K, nzl - 2)}[edge]
    cf = dual_time.coeffs(**ARGS)
    Hp0, scratch = Hp.clone(), torch.full_like(Hp, float("nan"))
    out, s = dual_time._dual_time_stepk_padded_cuda(Ht_k, Hp, K, cf, zb, scratch,
                                                    torch.zeros(nzl, dtype=Hp.dtype))
    want, sw = dual_time.dual_time_stepk_padded_plain(Ht_k, Hp.clone(), K, cf, zb)
    assert out is scratch
    torch.testing.assert_close(Hp, Hp0, rtol=0, atol=0)
    torch.testing.assert_close(out[K:K + nzl], want[K:K + nzl], rtol=0, atol=0)
    assert abs(float(s) - float(sw)) <= 1e-12 * abs(float(sw))
    ks = dual_time.split_passes(K)
    ends = np.cumsum(ks)
    assert launch_plain == [(k, (int(e), nz - 1 - int(e)), m == len(ks) - 1)
                            for m, (k, e) in enumerate(zip(ks, ends))]
