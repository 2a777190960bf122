"""PyTorch port: the three-level and 12-mode mixed solves of
tests/test_torch_three_level.py on a Kuhn TET10 lattice n=4 (2,187 DOF,
the 12-mode basis through the pooled lattice transfer), against the JAX
reference, with the same bounds."""

import torch

from tests.test_torch_three_level import PRECONDITIONERS, _Case, check_mixed_solve

torch.set_num_threads(2)


@PRECONDITIONERS
def test_mixed_solve_kuhn_matches_reference(precond):
    check_mixed_solve(_Case("kuhn4"), precond)
