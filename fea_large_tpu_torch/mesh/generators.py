"""Box mesh generators (host-side numpy; counterpart of
`fea_large_tpu/mesh/generators.py`, Kuhn lattice and TET10 upgrade)."""

from __future__ import annotations

import numpy as np

from fea_large_tpu_torch.elements.reference import TET10_EDGES
from fea_large_tpu_torch.mesh.core import Mesh, make_node_sets
from fea_large_tpu_torch.mesh.structure import (
    build_box_structure,
    class_coords,
    structure_conn,
)


def box_mesh_kuhn(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
    element_type: str = "tet4",
    tol: float = 1e-9,
    device="cpu",
) -> Mesh:
    """Box [0,lx]x[0,ly]x[0,lz] of nx*ny*nz cells with the uniform
    Kuhn/Freudenthal 6-tet decomposition and class-contiguous node
    numbering, carrying a `BoxStructure` descriptor (mesh/structure.py).
    Node sets: the six faces xmin ... zmax (mid-side nodes included)."""
    st = build_box_structure(nx, ny, nz, element_type)
    coords = class_coords(st, lx, ly, lz)
    conn = structure_conn(st)
    sets = make_node_sets(
        coords,
        {
            "xmin": lambda c: c[:, 0] < tol,
            "xmax": lambda c: c[:, 0] > lx - tol,
            "ymin": lambda c: c[:, 1] < tol,
            "ymax": lambda c: c[:, 1] > ly - tol,
            "zmin": lambda c: c[:, 2] < tol,
            "zmax": lambda c: c[:, 2] > lz - tol,
        },
    )
    return Mesh.create(coords, conn, element_type, sets, structure=st,
                       device=device)


def tet4_to_tet10(coords: np.ndarray, conn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Insert unique mid-edge nodes, producing TET10 connectivity in the
    canonical (Gmsh) edge order of `TET10_EDGES`."""
    coords = np.asarray(coords, np.float64)
    conn = np.asarray(conn, np.int64)
    E = conn.shape[0]
    pairs = np.stack(
        [np.stack([conn[:, i], conn[:, j]], axis=1) for i, j in TET10_EDGES], axis=1
    )  # [E, 6, 2]
    flat = np.sort(pairs.reshape(-1, 2), axis=1)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    mid_coords = 0.5 * (coords[uniq[:, 0]] + coords[uniq[:, 1]])
    mid_ids = coords.shape[0] + np.arange(uniq.shape[0])
    new_coords = np.concatenate([coords, mid_coords], axis=0)
    new_conn = np.concatenate(
        [conn, mid_ids[inverse.reshape(-1)].reshape(E, 6)], axis=1
    )
    return new_coords, new_conn
