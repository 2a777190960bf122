"""Linear solvers, coarse spaces and the Newton solver (counterpart of
`fea_large_tpu/solvers/`)."""

from fea_large_tpu_torch.solvers.linear import (  # noqa: F401
    PCGResult,
    block_jacobi_preconditioner,
    dense_cholesky_solve,
    pcg,
)
from fea_large_tpu_torch.solvers.newton import (  # noqa: F401
    NewtonSolver,
    SolveResult,
    SolverOptions,
)
