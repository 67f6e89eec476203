"""Part 1's 3D pseudo-transient diffusion over a mesh of shards
(fpr_tpu/parallel/dist_diffusion.py: DistDiffusionResult, _global_grid,
build_step, solve_distributed).

Cartesian decomposition of the global grid over a 1D/2D/3D mesh (axis
names 'z'/'y'/'x' map to array dims 0/1/2), each shard holding a local
grid of (cfg.nz, cfg.ny, cfg.nx) cells, optionally with the physical size
scaled by the shard grid (weak scaling, part1_kernel_programming.jl:
106-114).  Each pseudo-time iteration refreshes the ghosts from the
neighbours (``halo``), updates every shard, and adds the shards' sums of
squares in shard order (``reductions.dist_sumsq``) into the global norm.
The tiers:

- JNP: ``stencil3d.dual_time_step_ext3`` on fully ghost-padded blocks; with
  overlap_comm on a z-only mesh, ``dual_time_step_overlap_z`` on unpadded
  blocks and the exchanged faces.
- PALLAS: the dual-time kernel (#8) on fully ghost-padded blocks (one
  ghost cell on every dim; the TPU's 8-row/128-lane ghost blocks exist for
  its tiling only), its update box the shard's global-edge masks.  With
  overlap_comm on a z-only mesh the face copies run on a second CUDA
  stream while the kernel updates the planes that need no ghost; the two
  edge planes then go through the same kernel with one-plane boxes, and
  their partial sums land in the slots a single launch would fill, so the
  numbers equal the plain path's bitwise.
- PALLAS with check_every = K > 1 on a z-only mesh: #9 on K-deep z ghosts,
  one K-plane exchange per K iterations; Ht's (K-1)-deep ghosts are
  exchanged once per physical step.

As in ``models.diffusion3d``, the loop over iterations is a
``core.loops.while_loop`` over (the per-shard blocks, err, it), as JAX's
``lax.while_loop``, and a physical step one device call in
``mesh.route()``: on a mesh whose shards share one CUDA device one launch
of a cached CUDA graph, the host reading err and the iterations once a
physical step; on a mesh over several devices the plain host loops, one
read a test.  err = sqrt(sumsq) dt / sqrt(N) is formed on the device in
the field's dtype.  The kernel tiers iterate on ping-pong pairs of
buffers (two iterations a graph pass, no copy of a field).  A call of the
physical step takes and returns lists of per-shard physical blocks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fpr_tpu_torch.core import bc, loops
from fpr_tpu_torch.core.config import DiffusionConfig, ExecutionPolicy
from fpr_tpu_torch.core.grid import Grid3D, outer_steps, pseudo_timestep
from fpr_tpu_torch.ops import dual_time, reductions, stencil3d
from fpr_tpu_torch.parallel import halo
from fpr_tpu_torch.parallel.mesh import Mesh, make_mesh
from fpr_tpu_torch.utils.timing import BenchResults, diffusion_bench_results

AXIS_DIM = {"z": 0, "y": 1, "x": 2}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class DistDiffusionResult:
    H: np.ndarray            # gathered global field (nz_g, ny_g, nx_g)
    iters_total: int
    timed_iters: int
    bench: BenchResults
    converged: bool
    n_devices: int


def _global_grid(cfg: DiffusionConfig, mesh: Mesh) -> Grid3D:
    ez, ey, ex = (mesh.extent(a) for a in ("z", "y", "x"))
    s = cfg.scale_physical_size
    return Grid3D(cfg.nx * ex, cfg.ny * ey, cfg.nz * ez,
                  cfg.lx * (ex if s else 1), cfg.ly * (ey if s else 1),
                  cfg.lz * (ez if s else 1))


def shard_field(H: torch.Tensor, mesh: Mesh) -> list:
    """A global (nz_g, ny_g, nx_g) field as the per-shard local blocks, each
    on its shard's device."""
    sizes = [H.shape[AXIS_DIM[a]] // mesh.extent(a) for a in ("z", "y", "x")]
    blocks = []
    for i, dev in enumerate(mesh.devices):
        c = mesh.coords(i)
        idx = tuple(slice(c.get(a, 0) * n, (c.get(a, 0) + 1) * n)
                    for a, n in zip(("z", "y", "x"), sizes))
        blocks.append(H[idx].to(dev, copy=True).contiguous())
    return blocks


def gather_field(blocks, mesh: Mesh) -> np.ndarray:
    """The per-shard blocks as one global numpy field."""
    nz, ny, nx = blocks[0].shape
    ez, ey, ex = (mesh.extent(a) for a in ("z", "y", "x"))
    out = np.empty((nz * ez, ny * ey, nx * ex), dtype=_NP[blocks[0].dtype])
    for i, b in enumerate(blocks):
        c = mesh.coords(i)
        out[c.get("z", 0) * nz:(c.get("z", 0) + 1) * nz,
            c.get("y", 0) * ny:(c.get("y", 0) + 1) * ny,
            c.get("x", 0) * nx:(c.get("x", 0) + 1) * nx] = b.cpu().numpy()
    return out


def _pad1(b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(b, (1, 1, 1, 1, 1, 1))


def build_step(cfg: DiffusionConfig, mesh: Mesh, axis: str = "z", *, dtype=torch.float32):
    """The physical step over ``mesh`` (dist_diffusion.build_step, with its
    positional order).  axis: ignored, as in JAX (the mesh's axis names
    place the shards).

    Returns (step, grid): step(Ht_blocks, Htau_blocks) iterates Htau to
    convergence against Ht and returns (H_blocks, H_blocks, err,
    iterations), err a numpy scalar of the field's dtype: one device call
    (``mesh.route()``) and one host read a physical step.
    """
    del axis
    grid = _global_grid(cfg, mesh)
    dtau = pseudo_timestep(grid.dx, grid.dy, grid.dz, cfg.D)
    kw = dict(dt=cfg.dt, dtau=dtau, dx=grid.dx, dy=grid.dy, dz=grid.dz, D=cfg.D)
    if cfg.policy is ExecutionPolicy.PALLAS_DS:
        raise ValueError("the sharded tier runs policy jnp or pallas (the ds tier is a "
                         "single-device path)")
    use_pallas = cfg.policy is ExecutionPolicy.PALLAS
    local_shape = (cfg.nz, cfg.ny, cfg.nx)
    nzl = cfg.nz
    sharded = {AXIS_DIM[a]: a for a in mesh.axis_names}
    Kf = cfg.check_every
    use_kfused = use_pallas and Kf > 1 and set(sharded) <= {0}
    if use_pallas and Kf > 1 and not use_kfused:
        raise ValueError("check_every > 1 over a mesh needs a z-only decomposition")
    if use_kfused and nzl < Kf:
        raise ValueError(f"local nz={nzl} must be >= check_every={Kf}")
    overlap = cfg.overlap_comm and not use_pallas and set(sharded) <= {0}
    pallas_overlap = cfg.overlap_comm and use_pallas and set(sharded) <= {0} and nzl >= 2
    axis_of = {d: sharded.get(d) for d in range(3)}
    bounds = [[halo.mask_bounds(mesh, i, axis_of[d], local_shape[d]) for d in range(3)]
              for i in range(mesh.size)]
    devs = list(dict.fromkeys(mesh.devices))
    # the overlap's face copies run on this stream; inside a capture it
    # forks from the capture stream and joins it again within the iteration
    side = (torch.cuda.Stream(device=devs[0])
            if pallas_overlap and devs[0].type == "cuda" else None)

    def loop(body, H, inc=1):
        """The pseudo-time while_loop over (H, err, it): body(H) ->
        (H', [per-shard sumsq]) while err > tol and it < iter_max (the JAX
        test, in the field's dtype).  The kernel tiers' bodies write the
        buffer of a ping-pong pair they do not read: two passes a graph
        pass, no copy."""
        like = H[0]
        tol, dt, sqrt_n = (like.new_full((), v) for v in (cfg.tol, cfg.dt,
                                                           float(np.sqrt(grid.n))))

        def cond(s):
            return (s[1] > tol) & (s[2] < cfg.iter_max)

        def step(s):
            H, parts = body(s[0])
            return H, torch.sqrt(reductions.dist_sumsq(parts)) * dt / sqrt_n, s[2] + inc

        return loops.while_loop(cond, step, (H, like.new_full((), float("inf")),
                                             torch.zeros((), dtype=torch.int32,
                                                         device=like.device)),
                                unroll=1 if cfg.policy is ExecutionPolicy.JNP else 2,
                                donate=True)

    def pair(A, B):
        """other(X): the list of the ping-pong pair (A, B) that X is not."""
        def other(X):
            return B if X[0] is A[0] else A
        return other

    def step_jnp(Ht_l, Htau_l):
        def body(ext):
            halo.refresh_ghosts_ext(ext, mesh, sharded)
            out = []
            for i in range(mesh.size):
                (zlo, zhi), (ylo, yhi), (xlo, xhi) = bounds[i]
                out.append(stencil3d.dual_time_step_ext3(
                    Ht_l[i], ext[i], **kw, zlo=zlo, zhi=zhi, ylo=ylo, yhi=yhi, xlo=xlo,
                    xhi=xhi))
            return [o[0] for o in out], [o[1] for o in out]

        ext, err, it = loop(body, [_pad1(b) for b in Htau_l])
        return [e[1:-1, 1:-1, 1:-1].contiguous() for e in ext], err, it

    def step_jnp_overlap(Ht_l, Htau_l):
        def body(H):
            if 0 in sharded:
                lo, hi = halo.exchange_faces(H, mesh, sharded[0], 0)
            else:
                lo = hi = [torch.zeros_like(b[:1]) for b in H]
            out = []
            for i in range(mesh.size):
                (zlo, zhi), _, _ = bounds[i]
                out.append(stencil3d.dual_time_step_overlap_z(
                    Ht_l[i], H[i], lo[i], hi[i], **kw, zlo=zlo, zhi=zhi))
            return [o[0] for o in out], [o[1] for o in out]

        return loop(body, list(Htau_l))

    def step_pallas(Ht_l, Htau_l):
        A = [_pad1(b) for b in Htau_l]
        # the launches write the box only: B starts as A's copy
        other = pair(A, [a.clone() for a in A])
        Ht_p = [_pad1(b) for b in Ht_l]
        parts = [dual_time.box_partials(a, nzl) for a in A]
        window = (1, nzl)
        boxes = [tuple(v + 1 for lohi in bd for v in lohi) for bd in bounds]

        def body(A):
            B = other(A)

            def launch(i, box, w, part):
                dual_time.dual_time_box(Ht_p[i], A[i], box, **kw, window=w, out=B[i],
                                        partials=part)

            if not pallas_overlap:
                if sharded:
                    halo.refresh_ghosts_ext(A, mesh, sharded)
                for i in range(mesh.size):
                    launch(i, boxes[i], window, parts[i])
                return B, [p.sum() for p in parts]
            # the face copies into A's z ghosts on a side stream, beside
            # the update of the planes that read no ghost
            if side is not None:
                for dev in devs:
                    side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    halo.refresh_ghosts_ext(A, mesh, sharded)
            else:
                halo.refresh_ghosts_ext(A, mesh, sharded)
            for i in range(mesh.size):
                z0, z1, y0, y1, x0, x1 = boxes[i]
                launch(i, (max(z0, 2), min(z1, nzl - 1), y0, y1, x0, x1), window, parts[i])
            if side is not None:
                for dev in devs:
                    torch.cuda.current_stream(dev).wait_stream(side)
            for i in range(mesh.size):
                z0, z1, y0, y1, x0, x1 = boxes[i]
                if z0 <= 1:  # the first plane is not a global Dirichlet face
                    launch(i, (1, 1, y0, y1, x0, x1), (1, 1),
                           dual_time.plane_partials(parts[i], 0, A[i]))
                if z1 >= nzl:
                    launch(i, (nzl, nzl, y0, y1, x0, x1), (nzl, nzl),
                           dual_time.plane_partials(parts[i], nzl - 1, A[i]))
            return B, [p.sum() for p in parts]

        A, err, it = loop(body, A)
        return [a[1:-1, 1:-1, 1:-1].contiguous() for a in A], err, it

    def step_kfused(Ht_l, Htau_l):
        K = Kf
        Hp = [dual_time.pad3dk(b, K) for b in Htau_l]
        other = pair(Hp, [torch.empty_like(b) for b in Hp])
        Ht_k = [dual_time.pad_htk(b, K) for b in Ht_l]
        parts = [dual_time.fused_partials(b, nzl, K) for b in Hp]
        if 0 in sharded:
            # Ht is constant through pseudo-time: its K-1 ghost planes are
            # exchanged once per physical step
            halo.refresh_ghosts_zk(Ht_k, mesh, nzl, sharded[0], K - 1, base=K - 1)
            # interior shard edges reach into the ghosts: the fused sweeps
            # recompute those planes as the neighbour computes them
            zb = [(1 if mesh.neighbor(i, "z", -1) is None else -K,
                   nzl - 2 if mesh.neighbor(i, "z", +1) is None else nzl - 1 + K)
                  for i in range(mesh.size)]
        else:
            zb = [(1, nzl - 2)] * mesh.size

        def body(Hp):
            scratch = other(Hp)
            if 0 in sharded:
                halo.refresh_ghosts_zk(Hp, mesh, nzl, sharded[0], K)
            # the result lands in scratch, its ghost planes unspecified:
            # refreshed above when z is sharded, never read otherwise
            out = [dual_time.dual_time_stepk_padded(
                Ht_k[i], Hp[i], K, **kw, z_bounds=zb[i], scratch=scratch[i],
                partials=parts[i]) for i in range(mesh.size)]
            return [o[0] for o in out], [o[1] for o in out]

        Hp, err, it = loop(body, Hp, inc=K)
        return [b[K:K + nzl].contiguous() for b in Hp], err, it

    if use_kfused:
        body = step_kfused
    elif use_pallas:
        body = step_pallas
    elif overlap:
        body = step_jnp_overlap
    else:
        body = step_jnp

    def physical(a):
        H, err, it = body(a["Ht"], a["Htau"])
        return dict(H=H, err=err, it=it)

    npf = _NP[dtype]

    def step(Ht_l, Htau_l):
        with mesh.route():
            out = loops.device_call(physical, dict(Ht=list(Ht_l), Htau=list(Htau_l)), key=(
                "dist_diffusion", cfg, dtype, mesh.dims, mesh.axis_names))
        # the host's one read a physical step: err (exact in float64) and
        # the iterations
        err, it = torch.stack([out["err"].double(), out["it"].double()]).tolist()
        return out["H"], out["H"], npf(err), int(it)

    return step, grid


def solve_distributed(cfg: DiffusionConfig = DiffusionConfig(), mesh: Mesh | None = None,
                      axis: str = "z", dtype=torch.float32, verbose: bool = False, *,
                      device="cuda") -> DistDiffusionResult:
    """The distributed solve with the reference's 3-step warm-up
    (dist_diffusion.solve_distributed, part1_kernel_programming.jl:166-204,
    with its positional order).

    cfg.nx, ny, nz are each shard's local size.  mesh: None is one shard on
    ``device``; a given mesh carries its own devices.  axis: ignored, as in
    JAX (the mesh's axis names place the shards).  The PALLAS tiers on a
    CUDA mesh take float32 (their kernel does).
    """
    del axis
    mesh = make_mesh(device=device) if mesh is None else mesh
    if dtype not in _NP:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    if (any(d.type == "cuda" for d in mesh.devices) and cfg.policy is not ExecutionPolicy.JNP
            and dtype != torch.float32):
        raise ValueError(f"policy {cfg.policy.value} runs float32 CUDA kernels; got {dtype}")
    step, grid = build_step(cfg, mesh, dtype=dtype)
    nt = outer_steps(cfg.ttot, cfg.dt)
    H0 = bc.dirichlet_faces_3d(stencil3d.init_gaussian(grid, dtype, device="cpu"))
    Ht = shard_field(H0, mesh)
    del H0
    Htau = Ht

    iters_total = timed_iters = 0
    converged = True
    tic = time.perf_counter()
    for it_outer in range(nt):
        if it_outer == 3:  # warm-up (ref part1_kernel_programming.jl:170-176)
            mesh.synchronize()
            tic = time.perf_counter()
            timed_iters = 0
        Ht, Htau, err, n_it = step(Ht, Htau)
        iters_total += n_it
        timed_iters += n_it
        if n_it >= cfg.iter_max:
            converged = False
        if verbose:
            print(f"step {it_outer}: {n_it} iters, err={float(err):.3e}")
    mesh.synchronize()
    delta_t = time.perf_counter() - tic

    bench = diffusion_bench_results(
        delta_t, timed_iters, cfg.nx, cfg.ny, cfg.nz,
        word_bytes=torch.empty((), dtype=dtype).element_size(),
        model="fused" if cfg.policy is ExecutionPolicy.PALLAS else "plain",
        n_devices=mesh.size,
    )
    return DistDiffusionResult(H=gather_field(Ht, mesh), iters_total=iters_total,
                               timed_iters=timed_iters, bench=bench, converged=converged,
                               n_devices=mesh.size)
