"""fpr_tpu_torch — the PyTorch + CUDA port of ``fpr_tpu`` for an NVIDIA H100.

The JAX package ``fpr_tpu`` beside it is the reference this port is tested
against; the port imports neither it nor JAX.  Ported so far is the
Navier-Stokes fast loop and the solver under it:

- ``models.navier_stokes.simulate_fast``: the streamfunction-vorticity
  thermal-convection time loop (explicit and semi-implicit);
- ``solvers.multigrid.mg_solve_ds``: double-single defect-correction
  multigrid around f32 V-cycles, with a DST or Jacobi coarse solve;
- ``ops``: the plain PyTorch operators and the four hand-written CUDA
  kernels of that path (``csrc/``, built by ``kernels``).

Arrays are physical ``(ny, nx)`` tensors.  Every entry point takes an
explicit device; the CPU runs the kernels' plain PyTorch versions, and a
CUDA tensor always goes through the CUDA kernel.
"""

__version__ = "0.1.0"
