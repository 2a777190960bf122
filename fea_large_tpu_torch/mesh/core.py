"""Mesh data model (counterpart of `fea_large_tpu/mesh/core.py`).

A `Mesh` holds the nodal coordinates (f64) and the connectivity as tensors
on one device, plus host-side metadata: the element type name, named node
sets (numpy index arrays, used to build boundary conditions), an optional
quadrature override and, on generated Kuhn boxes, the `BoxStructure`
descriptor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from fea_large_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device
from fea_large_tpu_torch.elements.reference import ElementType, get_element


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Tetrahedral mesh.

    coords        f64[N, 3] material (undeformed) nodal coordinates
    conn          i64[E, npe] element connectivity (npe = 4 or 10)
    element_type  "tet4" | "tet10"
    node_sets     dict[str, np.ndarray] named node index sets (host)
    structure     optional BoxStructure (mesh/structure.py)
    coords_host, conn_host  numpy copies for host-side setup code
    n_quad        quadrature override (None: the element's default rule;
                  5 on a TET10 mesh: the 5-point degree-3 rule)
    """

    coords: torch.Tensor
    conn: torch.Tensor
    element_type: str
    node_sets: dict
    structure: object | None
    coords_host: np.ndarray
    conn_host: np.ndarray
    n_quad: int | None = None

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elements(self) -> int:
        return self.conn.shape[0]

    @property
    def n_dof(self) -> int:
        return 3 * self.n_nodes

    @property
    def element(self) -> ElementType:
        return get_element(self.element_type, self.n_quad)

    def with_node_sets(self, **sets) -> "Mesh":
        """A mesh with the given named node sets added (or replaced)."""
        ns = dict(self.node_sets)
        ns.update({k: np.asarray(v, np.int64) for k, v in sets.items()})
        return dataclasses.replace(self, node_sets=ns)

    @staticmethod
    def create(coords, conn, element_type: str, node_sets: dict | None = None,
               structure=None, device="cuda", n_quad: int | None = None) -> "Mesh":
        """Mesh on `device` (the card by default; raises where CUDA is
        absent, with no fallback to the CPU)."""
        coords_np = np.asarray(coords, np.float64)
        conn_np = np.asarray(conn, np.int64)
        npe = {"tet4": 4, "tet10": 10}[element_type]
        if conn_np.ndim != 2 or conn_np.shape[1] != npe:
            raise ValueError(
                f"{element_type} expects {npe} nodes/element, conn has shape "
                f"{conn_np.shape}"
            )
        dev = as_device(device)
        return Mesh(
            coords=torch.tensor(coords_np, dtype=DTYPE, device=dev),
            conn=torch.tensor(conn_np, dtype=INDEX_DTYPE, device=dev),
            element_type=element_type,
            node_sets={k: np.asarray(v, np.int64) for k, v in (node_sets or {}).items()},
            structure=structure,
            coords_host=coords_np,
            conn_host=conn_np,
            n_quad=n_quad,
        )


def make_node_sets(
    coords: np.ndarray, predicates: dict[str, Callable[[np.ndarray], np.ndarray]]
) -> dict[str, np.ndarray]:
    """Named node sets from coordinate predicates (host-side): each
    predicate maps coords [N, 3] -> bool [N]; the set holds the indices
    where it is true."""
    coords = np.asarray(coords)
    return {
        name: np.nonzero(np.asarray(pred(coords)))[0].astype(np.int64)
        for name, pred in predicates.items()
    }
