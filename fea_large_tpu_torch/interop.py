"""Build the port's objects from numpy arrays, so that the JAX reference and
the port can compute on the same inputs (the tests convert the reference's
objects to numpy and hand them here). Takes numpy only; never imports the
reference."""

from __future__ import annotations

import numpy as np
import torch

from fea_large_tpu_torch.bc import DirichletBC
from fea_large_tpu_torch.config import DTYPE, as_device
from fea_large_tpu_torch.materials import MATERIAL_REGISTRY, Material
from fea_large_tpu_torch.mesh.core import Mesh
from fea_large_tpu_torch.mesh.structure import BoxStructure
from fea_large_tpu_torch.ops.soa import SoAState



def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple, np.ndarray)) else int(x)


def mesh_from_numpy(coords, conn, element_type: str, node_sets: dict | None = None,
                    structure_fields: dict | None = None, device="cpu") -> Mesh:
    """Mesh from coords [N, 3], conn [E, npe], named node sets and, for a
    Kuhn lattice, the BoxStructure fields (cells, classes, class_dims,
    class_base, slot_class, slot_offset) as nested sequences of ints."""
    structure = None
    if structure_fields is not None:
        structure = BoxStructure(
            **{k: _tuples(structure_fields[k]) for k in (
                "cells", "classes", "class_dims", "class_base", "slot_class",
                "slot_offset",
            )}
        )
    return Mesh.create(coords, conn, element_type,
                       {k: np.asarray(v) for k, v in (node_sets or {}).items()},
                       structure=structure, device=device)


def dirichlet_from_numpy(free_mask, prescribed_values, device="cpu") -> DirichletBC:
    """DirichletBC from the [N, 3] free mask and total prescribed values."""
    dev = as_device(device)
    return DirichletBC(
        free_mask=torch.tensor(np.asarray(free_mask), dtype=DTYPE, device=dev),
        values=torch.tensor(np.asarray(prescribed_values), dtype=DTYPE, device=dev),
    )


def material_from_numpy(kind, lam, mu) -> Material:
    """Material from its kind (0 SVK, 1 neo-Hookean, 2 neo-Hookean
    volumetric) and Lame constants."""
    cls = next(c for c in set(MATERIAL_REGISTRY.values()) if c.kind == int(kind))
    return cls(float(np.asarray(lam)), float(np.asarray(mu)))


def soa_state_from_numpy(F, S, A, alpha, beta, dtype=torch.float32, device="cpu") -> SoAState:
    """SoAState from F, S, A [q, 3, 3, E] and alpha, beta [q, E]."""
    dev = as_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return SoAState(F=t(F), S=t(S), A=t(A), alpha=t(alpha), beta=t(beta))
