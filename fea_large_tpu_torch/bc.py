"""Dirichlet boundary conditions by free-DOF masking, and external loads
(counterpart of `fea_large_tpu/bc.py`).

Every array keeps its full shape [N, 3] and prescribed DOFs are projected
out by an elementwise mask. The linear system of a Newton iteration is

    A = M K M + (I - M),   b = M R          (M = diag(free mask))

which is SPD whenever K restricted to the free DOFs is, and gives du = 0
on prescribed DOFs by construction.

The loads (`nodal_forces`, `body_forces`) are dead loads: integrated over
the undeformed mesh once at setup, on the host, and scaled by the load
factor during stepping. They return f64 [N, 3] on the mesh's device.
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


def body_forces(mesh, vector) -> torch.Tensor:
    """Consistent nodal forces f64 [N, 3] of a dead body force b per unit
    reference volume (rho0 * g for self-weight):

        f[a] = sum_e sum_q w_q det(J)_q N_a(xi_q) b

    with the mesh's quadrature rule (`mesh.n_quad`). Host-side numpy, once
    at setup; the result lies on the mesh's device."""
    et = mesh.element
    conn = mesh.conn_host
    Xe = mesh.coords_host[conn]  # [E, npe, 3]
    J = np.einsum("eai,qad->eqid", Xe, et.shape_grad)  # [E, q, 3, 3]
    wdet = np.linalg.det(J) * et.quad_weights[None, :]  # [E, q]
    fa = np.einsum("eq,qa->ea", wdet, et.shape)[..., None] * np.asarray(vector, float)
    f = np.zeros((mesh.n_nodes, 3))
    np.add.at(f, conn.reshape(-1), fa.reshape(-1, 3))
    return torch.as_tensor(f, dtype=DTYPE, device=mesh.device)


def nodal_forces(mesh, specs: dict) -> torch.Tensor:
    """Total external nodal forces f64 [N, 3] from {node set name: force
    vector}: the vector is applied to EACH node of the set. On the mesh's
    device."""
    f = np.zeros((mesh.n_nodes, 3))
    for name, vec in specs.items():
        f[np.asarray(mesh.node_sets[name])] += np.asarray(vec)
    return torch.as_tensor(f, dtype=DTYPE, device=mesh.device)
