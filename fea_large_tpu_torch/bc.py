"""Dirichlet boundary conditions by free-DOF masking (counterpart of
`fea_large_tpu/bc.py`).

Every array keeps its full shape [N, 3] and prescribed DOFs are projected
out by an elementwise mask. The linear system of a Newton iteration is

    A = M K M + (I - M),   b = M R          (M = diag(free mask))

which is SPD whenever K restricted to the free DOFs is, and gives du = 0
on prescribed DOFs by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.config import DTYPE

_COMP = {"x": 0, "y": 1, "z": 2}


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """free_mask  f64[N, 3]  1.0 on free DOFs, 0.0 on prescribed DOFs
    values     f64[N, 3]  total prescribed displacement at full load
                          (zero on free DOFs), scaled by the load factor"""

    free_mask: torch.Tensor
    values: torch.Tensor

    def impose(self, u: torch.Tensor, scale) -> torch.Tensor:
        """Set prescribed DOFs of u to scale * values (free DOFs untouched)."""
        return self.free_mask * u + (1.0 - self.free_mask) * (scale * self.values)

    def project(self, r: torch.Tensor) -> torch.Tensor:
        """Zero out prescribed DOFs (restrict a residual to free DOFs)."""
        return self.free_mask * r

    @property
    def n_fixed(self) -> int:
        return int((self.free_mask == 0.0).sum())


class DirichletBuilder:
    """Host-side accumulation of prescribed-displacement specs (node set +
    components + value) into a `DirichletBC` on the mesh's device."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._free = np.ones((mesh.n_nodes, 3), dtype=bool)
        self._vals = np.zeros((mesh.n_nodes, 3))

    def _nodes(self, node_set) -> np.ndarray:
        if isinstance(node_set, str):
            return np.asarray(self._mesh.node_sets[node_set])
        return np.asarray(node_set)

    def fix(self, node_set, components: str = "xyz") -> "DirichletBuilder":
        """Clamp the given components to zero on a node set."""
        return self.prescribe(node_set, components, 0.0)

    def prescribe(self, node_set, components: str, value) -> "DirichletBuilder":
        """Prescribe the TOTAL displacement `value` (scalar or per-node
        array) at full load for the given components on a node set."""
        nodes = self._nodes(node_set)
        for c in components:
            j = _COMP[c]
            self._free[nodes, j] = False
            self._vals[nodes, j] = value
        return self

    def build(self) -> DirichletBC:
        dev = self._mesh.device
        return DirichletBC(
            free_mask=torch.as_tensor(self._free, dtype=DTYPE, device=dev),
            values=torch.as_tensor(self._vals, dtype=DTYPE, device=dev),
        )
