"""fpr_tpu_torch — the PyTorch + CUDA port of ``fpr_tpu`` for an NVIDIA H100.

The JAX package ``fpr_tpu`` beside it is the reference this port is tested
against; the port imports neither it nor JAX.  Ported so far are the
Navier-Stokes loops with the solvers under them, part 1's 3D dual-time
diffusion, and their sharded tiers:

- ``models.navier_stokes.simulate_fast``: the streamfunction-vorticity
  thermal-convection fast loop (explicit and semi-implicit, float32 state,
  double-single solves);
- ``models.navier_stokes.simulate`` / ``ns_step``: the host loop (float64
  state by default; ``mg_solver`` "direct" or "mixed");
- ``solvers.multigrid``: ``mg_solve`` (the reference-semantics V-cycle,
  plain PyTorch or the stencil-pass kernel), ``mg_solve_rp`` and
  ``mg_solve_mixed`` (the row-padded V-cycle's legs, float64 defect
  correction around float32 cycles), ``mg_solve_ds`` (double-single
  defect correction), with Jacobi, CG or DST coarse solves;
- ``solvers.krylov``: ``cg``, ``mg_preconditioned_cg``, ``mg_pcg_ds``;
- ``models.diffusion3d.solve``: pseudo-transient 3D diffusion to steady
  state per backward-Euler step, in three tiers (plain PyTorch, the f32
  kernel with a check every K iterations, the double-single kernel);
- the sharded tiers on a single-controller mesh of shards
  (``parallel.mesh``, ``parallel.halo``): ``parallel.dist_diffusion``
  (part 1 over a 1D/2D/3D mesh), ``solvers.dist_mg_ds`` (the ds multigrid
  over row shards or a 2D (y, x) mesh), ``models.dist_ns`` (the fast loop
  over row shards) and the GSPMD tier (``solvers.dist_multigrid``:
  ``mg_solve`` on row shards; ``simulate(mesh=)``), with
  ``parallel.dryrun``;
- ``ops``: the plain PyTorch operators and the hand-written CUDA kernels
  of those paths (``csrc/``, built by ``kernels``).

Arrays are physical ``(ny, nx)`` or ``(nz, ny, nx)`` tensors.  Every entry
point takes an explicit device or defaults to ``cuda``; the CPU runs the
kernels' plain PyTorch versions, and a CUDA tensor always goes through the
CUDA kernel.
"""

__version__ = "0.1.0"
