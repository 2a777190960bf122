"""Box mesh generators (host-side numpy; counterpart of
`fea_large_tpu/mesh/generators.py`): the 5-tet box, the Kuhn lattice and
the TET10 upgrade.

Every generator builds on the card unless the caller passes
`device="cpu"`; without CUDA the default raises (no fallback)."""

from __future__ import annotations

import numpy as np

from fea_large_tpu_torch.elements.reference import TET10_EDGES
from fea_large_tpu_torch.mesh.core import Mesh, make_node_sets
from fea_large_tpu_torch.mesh.structure import (
    build_box_structure,
    class_coords,
    structure_conn,
)

# 5-tet decomposition of the unit cube, two mirror variants so that
# neighbouring cells share diagonals (conforming mesh).
_CUBE_TETS_EVEN = np.array(
    [[0, 1, 2, 5], [0, 2, 3, 7], [0, 5, 7, 4], [2, 7, 5, 6], [0, 2, 7, 5]]
)
_CUBE_TETS_ODD = np.array(
    [[1, 3, 0, 4], [1, 2, 3, 6], [1, 6, 4, 5], [3, 4, 6, 7], [1, 3, 6, 4]]
)


def _face_sets(coords, lx, ly, lz, tol):
    return make_node_sets(
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


def box_mesh(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
    element_type: str = "tet4",
    tol: float = 1e-9,
    device="cuda",
    n_quad: int | None = None,
) -> Mesh:
    """Box [0,lx]x[0,ly]x[0,lz] of nx*ny*nz cells, 5 tets each, the
    parity of (i + j + k) choosing the mirror variant; no `BoxStructure`,
    so the element passes take the unstructured (indexed) path. Cells in
    lexicographic (i, j, k) order, 5 tets per cell; negatively oriented
    tets get two vertices swapped. Node sets: the six faces xmin ... zmax
    (mid-side nodes included). `n_quad` overrides the element's default
    quadrature rule (`Mesh.n_quad`)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    I, J, K = (g.ravel() for g in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    corner = np.stack(
        [nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K), nid(I, J + 1, K),
         nid(I, J, K + 1), nid(I + 1, J, K + 1), nid(I + 1, J + 1, K + 1),
         nid(I, J + 1, K + 1)],
        axis=1,
    )  # [cells, 8]
    even = ((I + J + K) % 2 == 0)[:, None, None]
    conn = np.where(
        even, corner[:, _CUBE_TETS_EVEN], corner[:, _CUBE_TETS_ODD]
    ).reshape(-1, 4)

    # enforce positive orientation (det of edge matrix > 0)
    v = coords[conn]
    flip = np.linalg.det(v[:, 1:4] - v[:, :1]) < 0
    conn[flip] = conn[flip][:, [0, 2, 1, 3]]

    if element_type == "tet10":
        coords, conn = tet4_to_tet10(coords, conn)
    return Mesh.create(coords, conn, element_type,
                       _face_sets(coords, lx, ly, lz, tol), device=device,
                       n_quad=n_quad)


def box_mesh_kuhn(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 1.0,
    ly: float = 1.0,
    lz: float = 1.0,
    element_type: str = "tet4",
    tol: float = 1e-9,
    device="cuda",
    n_quad: int | None = None,
) -> Mesh:
    """Box [0,lx]x[0,ly]x[0,lz] of nx*ny*nz cells with the uniform
    Kuhn/Freudenthal 6-tet decomposition and class-contiguous node
    numbering, carrying a `BoxStructure` descriptor (mesh/structure.py).
    Node sets: the six faces xmin ... zmax (mid-side nodes included).
    `n_quad` overrides the element's default quadrature rule."""
    st = build_box_structure(nx, ny, nz, element_type)
    coords = class_coords(st, lx, ly, lz)
    conn = structure_conn(st)
    return Mesh.create(coords, conn, element_type,
                       _face_sets(coords, lx, ly, lz, tol), structure=st,
                       device=device, n_quad=n_quad)


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
