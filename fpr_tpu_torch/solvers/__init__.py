from fpr_tpu_torch.solvers.krylov import cg, mg_preconditioned_cg
from fpr_tpu_torch.solvers.multigrid import mg_solve, mg_solve_ds, mg_solve_mixed, mg_solve_rp, vcycle

__all__ = ["mg_solve", "mg_solve_ds", "mg_solve_mixed", "mg_solve_rp", "vcycle", "cg",
           "mg_preconditioned_cg"]
