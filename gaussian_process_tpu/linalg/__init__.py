"""Dense and iterative linear algebra for GP solves."""

from gaussian_process_tpu.linalg.cholesky import (
    safe_cholesky,
    cholesky_solve,
    tri_solve,
    logdet_from_chol,
    CholeskyResult,
)
from gaussian_process_tpu.linalg.cg import cg_solve, cg_solve_grad, CGState
from gaussian_process_tpu.linalg.blocked import blocked_cholesky
from gaussian_process_tpu.linalg.nystrom import (
    NystromPreconditioner,
    make_nystrom_preconditioner,
)

__all__ = [
    "safe_cholesky",
    "cholesky_solve",
    "tri_solve",
    "logdet_from_chol",
    "CholeskyResult",
    "cg_solve",
    "cg_solve_grad",
    "CGState",
    "blocked_cholesky",
    "NystromPreconditioner",
    "make_nystrom_preconditioner",
]
