"""``mg_solve`` with policy PALLAS, whose smoother and residual are the
stencil-pass kernel #5 at every level (fpr_tpu_torch.ops.stencil_pass;
its plain version on the CPU), against fpr_tpu's mg_solve with the Pallas
drop-ins in interpret mode, in float64, over the reference's sweep: grid
k 7..9 x coarse l 2..3 x {Jacobi, CG} coarse solve (the CG coarse solve
takes the kernel's matvec too).  Bars as in tests/test_torch_mg_solve.py:
equal cycle counts, iterates within 1e-10 of max|u|.
"""

import pytest

from test_torch_mg_solve import compare_mg_solve


@pytest.mark.parametrize("coarse", ["jacobi", "cg"])
@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("k", [7, 8, 9])
def test_mg_solve_pallas_matches(k, l, coarse):
    compare_mg_solve(k, l, coarse, "pallas")
