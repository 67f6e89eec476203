"""The port's single-controller mesh, halo exchange and distributed norms
(fpr_tpu_torch.parallel.mesh, .halo, ops.reductions) against
fpr_tpu.parallel.halo and dist_mg_ds._refresh inside shard_map on the
conftest's 8-virtual-device CPU mesh: the same numpy blocks go to both
sides, and every ghost slot must come out bitwise equal.  Also the guard
that the port and chip_smoke.py import neither jax nor fpr_tpu."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.8 top-level spelling
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from fpr_tpu.parallel import halo as jhalo
from fpr_tpu.parallel.mesh import make_mesh as jmesh
from fpr_tpu.solvers import dist_mg_ds as jdist
from fpr_tpu_torch.ops import reductions
from fpr_tpu_torch.parallel import halo
from fpr_tpu_torch.parallel.mesh import make_mesh

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_per_shard(fn, glob, n_shards, axis, n_out):
    """fn on each shard of glob (split along dim 0 over a 1D mesh): the
    outputs split back per shard."""
    mesh = jmesh((n_shards,), (axis,))
    spec = P(axis, *([None] * (glob.ndim - 1)))
    outs = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,),
                             out_specs=tuple([spec] * n_out)))(jnp.asarray(glob))
    return [np.split(np.asarray(o), n_shards) for o in outs]


def test_make_mesh_layout():
    mesh = make_mesh((2, 3), device="cpu")
    assert mesh.axis_names == ("z", "y") and mesh.shape == {"z": 2, "y": 3}
    assert mesh.size == 6 and all(d == torch.device("cpu") for d in mesh.devices)
    assert mesh.coords(4) == {"z": 1, "y": 1} and mesh.shard({"z": 1, "y": 1}) == 4
    assert mesh.neighbor(4, "z", -1) == 1 and mesh.neighbor(4, "z", +1) is None
    assert mesh.neighbor(4, "y", +1) == 5 and mesh.neighbor(3, "y", -1) is None
    assert mesh.extent("x") == 1
    assert make_mesh(device="cpu").shape == {"z": 1}
    listed = make_mesh(devices=["cpu", "cpu", "cpu"], axis_names=("y",))
    assert listed.shape == {"y": 3}
    assert make_mesh((2,), devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), devices=["cpu"] * 2)


def test_exchange_faces_matches_jax(rng):
    a = rng.random((16, 4, 8))
    below_j, above_j = _jax_per_shard(lambda x: jhalo.exchange_faces_z(x, "z"), a, 4, "z", 2)
    mesh = make_mesh((4,), device="cpu")
    lo, hi = halo.exchange_faces([torch.tensor(b) for b in np.split(a, 4)], mesh, "z", 0)
    for k in range(4):
        np.testing.assert_array_equal(lo[k].numpy(), below_j[k])
        np.testing.assert_array_equal(hi[k].numpy(), above_j[k])
    assert not lo[0].any() and not hi[3].any()


@pytest.mark.parametrize("K", [1, 2, 3])
def test_refresh_ghosts_zk_matches_jax(rng, K):
    """K-deep ghosts (Htau of #9; Ht's K-1 deep ones are the case K-1)."""
    nz = 5
    blocks = rng.random((4, nz + 2 * K, 3, 6))
    (got_j,) = _jax_per_shard(lambda x: (jhalo.refresh_ghosts_zk(x, nz, "z", K),),
                              blocks.reshape(-1, 3, 6), 4, "z", 1)
    mine = [torch.tensor(b) for b in blocks]
    halo.refresh_ghosts_zk(mine, make_mesh((4,), device="cpu"), nz, "z", K)
    for k in range(4):
        np.testing.assert_array_equal(mine[k].numpy(), got_j[k])


@pytest.mark.parametrize("lead", [(), (2,)])
def test_refresh_rows_matches_jax(rng, lead):
    PAD, ny_l, nx = jdist.PAD, 16, 12
    blocks = rng.random((4, *lead, ny_l + 2 * PAD, nx))
    (got_j,) = _jax_per_shard(lambda x: (jdist._refresh(x, ny_l, "y"),),
                              blocks.reshape(-1, *blocks.shape[2:]), 4, "y", 1)
    mine = [torch.tensor(b) for b in blocks]
    halo.refresh_rows(mine, make_mesh((4,), ("y",), device="cpu"), "y", ny_l, PAD)
    for k in range(4):
        np.testing.assert_array_equal(mine[k].numpy(), got_j[k].reshape(mine[k].shape))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_refresh_2d_matches_jax(rng, lead):
    """A 2x2 (y, x) mesh at JAX's own ghost widths (8 rows, CPAD columns):
    refresh_2d equals dist_mg_ds._refresh2d in shard_map bitwise."""
    PAD, CPAD, ny_l, nx_l = jdist.PAD, jdist.CPAD, 16, 128
    R, C = ny_l + 2 * PAD, nx_l + 2 * CPAD
    blocks = rng.random((2, 2, *lead, R, C))
    nl = len(lead)
    perm = (*range(2, 2 + nl), 0, 2 + nl, 1, 3 + nl)
    glob = blocks.transpose(perm).reshape(*lead, 2 * R, 2 * C)
    spec = P(*([None] * nl), "y", "x")
    out = jax.jit(shard_map(lambda x: jdist._refresh2d(x, ny_l, nx_l, "y", "x"),
                            mesh=jmesh((2, 2), ("y", "x")), in_specs=(spec,),
                            out_specs=spec))(jnp.asarray(glob))
    got_j = np.asarray(out).reshape(*lead, 2, R, 2, C)
    mine = [torch.tensor(blocks[dy, dx]) for dy in range(2) for dx in range(2)]
    halo.refresh_2d(mine, make_mesh((2, 2), ("y", "x"), device="cpu"), ("y", "x"), ny_l,
                    nx_l, PAD, CPAD)
    for i, (dy, dx) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        np.testing.assert_array_equal(mine[i].numpy(), got_j[..., dy, :, dx, :])


def test_refresh_2d_fills_corners_from_the_diagonal_neighbour():
    """Columns first, then full-width rows: the corner ghosts of a 3x3 mesh's
    middle shard hold its diagonal neighbours' cells, and a corner shard's
    ghosts past the global edge are zeros."""
    G, GX, ny_l, nx_l = 2, 3, 4, 5
    R, C = ny_l + 2 * G, nx_l + 2 * GX
    mesh = make_mesh((3, 3), ("y", "x"), device="cpu")
    glob = torch.arange(3 * ny_l * 3 * nx_l, dtype=torch.float64).reshape(3 * ny_l, 3 * nx_l)
    glob += 1.0  # no global cell is 0
    blocks = []
    for i in range(9):
        cc = mesh.coords(i)
        b = torch.full((R, C), -1.0, dtype=torch.float64)
        b[G:G + ny_l, GX:GX + nx_l] = glob[cc["y"] * ny_l:(cc["y"] + 1) * ny_l,
                                           cc["x"] * nx_l:(cc["x"] + 1) * nx_l]
        blocks.append(b)
    halo.refresh_2d(blocks, mesh, ("y", "x"), ny_l, nx_l, G, GX)
    padded = torch.nn.functional.pad(glob, (GX, GX, G, G))
    for i in range(9):
        cc = mesh.coords(i)
        want = padded[cc["y"] * ny_l:cc["y"] * ny_l + R, cc["x"] * nx_l:cc["x"] * nx_l + C]
        torch.testing.assert_close(blocks[i], want, rtol=0, atol=0)
    mid = blocks[4]
    assert float(mid[0, 0]) == float(glob[ny_l - G, nx_l - GX])           # up-left shard
    assert float(mid[-1, -1]) == float(glob[2 * ny_l + G - 1, 2 * nx_l + GX - 1])
    assert not blocks[0][:G].any() and not blocks[0][:, :GX].any()
    assert not blocks[8][-G:].any() and not blocks[8][:, -GX:].any()


def test_refresh_ghosts_ext_matches_jax(rng):
    """A 2x2x2 mesh: each sharded dim's ghost faces from the neighbours,
    zeros at the global edges, ghost edges and corners untouched (zero)."""
    n = 4
    inner = rng.random((8, n, n, n))
    ext = np.pad(inner, ((0, 0), (1, 1), (1, 1), (1, 1)))
    mesh_j = jmesh((2, 2, 2), ("z", "y", "x"))
    sharded = {0: "z", 1: "y", 2: "x"}
    glob = ext.reshape(2, 2, 2, n + 2, n + 2, n + 2).transpose(0, 3, 1, 4, 2, 5).reshape(
        2 * (n + 2), 2 * (n + 2), 2 * (n + 2))
    spec = P("z", "y", "x")
    out = jax.jit(shard_map(lambda x: jhalo.refresh_ghosts_ext(x, sharded), mesh=mesh_j,
                            in_specs=(spec,), out_specs=spec))(jnp.asarray(glob))
    got_j = np.asarray(out).reshape(2, n + 2, 2, n + 2, 2, n + 2).transpose(0, 2, 4, 1, 3, 5)
    mine = [torch.tensor(b) for b in ext]
    halo.refresh_ghosts_ext(mine, make_mesh((2, 2, 2), device="cpu"), sharded)
    for k in range(8):
        np.testing.assert_array_equal(mine[k].numpy(), got_j.reshape(8, *mine[k].shape)[k])


def test_mask_bounds():
    mesh = make_mesh((3,), device="cpu")
    assert [halo.mask_bounds(mesh, i, "z", 6) for i in range(3)] == [(1, 5), (0, 5), (0, 4)]
    assert halo.mask_bounds(mesh, 1, None, 6) == (1, 4)


def test_dist_reductions_add_in_shard_order(rng):
    blocks = [torch.tensor(rng.standard_normal((3, 5))) for _ in range(4)]
    parts = [reductions.sumsq(b) for b in blocks]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert float(reductions.dist_sumsq(parts)) == float(want)
    assert float(reductions.dist_norm_l2(blocks)) == float(torch.sqrt(want))
    maxima = [torch.tensor(v) for v in (0.5, 2.0, 1.5)]
    assert float(reductions.dist_max(maxima)) == 2.0


def test_port_sources_import_no_jax():
    """No module of fpr_tpu_torch, and not chip_smoke.py, imports jax or
    the JAX package (the port must start on a machine without either)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|fpr_tpu)(\.|\s|$)", re.MULTILINE)
    files = sorted((REPO / "fpr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax or fpr_tpu"
