"""Build the port's objects from numpy arrays, so that the JAX reference and
the port can compute on the same inputs (the tests convert the reference's
objects to numpy and hand them here). Takes numpy only; never imports the
reference.

Every builder builds on the card unless the caller passes `device="cpu"`;
without CUDA the default raises (no fallback), as the mesh generators do."""

from __future__ import annotations

import numpy as np
import torch

from fea_large_tpu_torch.bc import DirichletBC
from fea_large_tpu_torch.config import DTYPE, as_device
from fea_large_tpu_torch.materials import MATERIAL_REGISTRY, Material
from fea_large_tpu_torch.mesh.core import Mesh
from fea_large_tpu_torch.mesh.structure import BoxStructure
from fea_large_tpu_torch.ops.soa import ScatterBuckets, SoAProblem, SoAState


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple, np.ndarray)) else int(x)


def mesh_from_numpy(coords, conn, element_type: str, node_sets: dict | None = None,
                    structure_fields: dict | None = None, device="cuda") -> Mesh:
    """Mesh from coords [N, 3], conn [E, npe], named node sets and, for a
    Kuhn lattice, the BoxStructure fields (None: an unstructured mesh) (cells, classes, class_dims,
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


def dirichlet_from_numpy(free_mask, prescribed_values, device="cuda") -> DirichletBC:
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


def soa_state_from_numpy(F, S, A, alpha, beta, dtype=torch.float32, device="cuda") -> SoAState:
    """SoAState from F, S, A [q, 3, 3, E] and alpha, beta [q, E]."""
    dev = as_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return SoAState(F=t(F), S=t(S), A=t(A), alpha=t(alpha), beta=t(beta))


def scatter_buckets_from_numpy(idx, mask, inv, device="cuda") -> ScatterBuckets:
    """ScatterBuckets from per-bucket idx [nb, cap] and mask [nb, cap]
    sequences and inv [N]."""
    dev = as_device(device)
    return ScatterBuckets(
        idx=tuple(torch.tensor(np.asarray(x), dtype=torch.int64, device=dev) for x in idx),
        mask=tuple(torch.tensor(np.asarray(x), dtype=torch.float32, device=dev) for x in mask),
        inv=torch.tensor(np.asarray(inv), dtype=torch.int64, device=dev),
    )


def soa_problem_from_numpy(n_nodes, gradN, detJxW, conn_T, buckets,
                           dtype=torch.float32, device="cuda") -> SoAProblem:
    """Unstructured SoAProblem from gradN [q, npe, 3, E], detJxW [q, E],
    conn_T [npe, E] and a ScatterBuckets."""
    dev = as_device(device)
    return SoAProblem(
        n_nodes=int(n_nodes),
        gradN=torch.tensor(np.asarray(gradN), dtype=dtype, device=dev),
        detJxW=torch.tensor(np.asarray(detJxW), dtype=dtype, device=dev),
        conn_T=torch.tensor(np.asarray(conn_T), dtype=torch.int64, device=dev),
        buckets=buckets,
    )
