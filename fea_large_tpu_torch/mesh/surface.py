"""Boundary-surface extraction and consistent traction loads (Neumann BCs;
counterpart of `fea_large_tpu/mesh/surface.py`).

Total-Lagrangian **dead tractions**: a traction vector t (force per unit
REFERENCE area) applied over a named boundary patch, converted once at
setup into the consistent nodal force vector

    f[a] += sum_q w_q N_a(xi_q) ||dX/dxi x dX/deta||(xi_q) t

by isoparametric integration over the boundary faces (TRI3 under TET4,
TRI6 under TET10 — curved quadratic faces integrate their true metric).
Because the traction is dead (reference-configuration), the result is a
constant f64[N, 3] scaled by the load factor during incremental stepping —
exactly the `f_ext` contract of `bc.nodal_forces`, so the solvers need no
changes and the external-load potential stays linear in u (no load
stiffness).

Everything here is host-side numpy, the reference's own (boundary
extraction and load integration are cold setup paths); the forces land as
f64 [N, 3] on the mesh's device, as `bc.nodal_forces` does.
"""

from __future__ import annotations

import numpy as np
import torch

from fea_large_tpu_torch.config import DTYPE
from fea_large_tpu_torch.elements.reference import TET10_EDGES
from fea_large_tpu_torch.mesh.core import Mesh

# Tet faces with OUTWARD-oriented corner ordering (right-hand normal points
# out of the element) in local vertex indices.
TET_FACES = ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2))

_EDGE_MID = {frozenset(e): 4 + k for k, e in enumerate(TET10_EDGES)}


def _face_local_nodes(element_type: str):
    """Per tet face: the local node indices of its surface element.
    TET4 -> TRI3 corner triple; TET10 -> TRI6 (3 corners + the mid-edge
    node of each face edge, Gmsh TRI6 ordering: edges (0,1),(1,2),(2,0))."""
    faces = []
    for a, b, c in TET_FACES:
        if element_type == "tet4":
            faces.append((a, b, c))
        else:
            faces.append(
                (a, b, c)
                + tuple(
                    _EDGE_MID[frozenset(e)] for e in ((a, b), (b, c), (c, a))
                )
            )
    return np.asarray(faces, np.int64)  # [4, 3 or 6]


def boundary_faces(mesh: Mesh) -> np.ndarray:
    """i64[F, 3|6] node indices of the boundary faces (outward-oriented).

    A tet face is on the boundary iff its corner triple appears in exactly
    one element: interior faces are shared by two tets (with opposite
    orientations), so a sorted-triple unique-count of all 4E faces
    identifies the boundary in O(E log E) host time.
    """
    conn = mesh.conn_host.astype(np.int64)
    local = _face_local_nodes(mesh.element_type)  # [4, nfn]
    faces = conn[:, local]  # [E, 4, nfn]
    faces = faces.reshape(-1, local.shape[1])  # [4E, nfn]
    key = np.sort(faces[:, :3], axis=1)  # corner triples, orientation-free
    _, inv, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    return faces[counts[inv] == 1]


def _tri_rule(n_corner: int):
    """(points [q, 2], weights [q], shape fn): TRI3 1-pt centroid rule
    (exact: linear N x constant metric -> each corner gets A/3) or TRI6
    3-pt degree-2 rule (exact for the quadratic N on flat faces; verified
    in tests: corners get 0, mid-edges A/3)."""
    if n_corner == 3:
        pts = np.array([[1.0 / 3.0, 1.0 / 3.0]])
        w = np.array([0.5])

        def shape(xi):
            x, y = xi[..., 0], xi[..., 1]
            return np.stack([1.0 - x - y, x, y], axis=-1)

        def shape_grad(xi):
            g = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
            return np.broadcast_to(g, (*xi.shape[:-1], 3, 2))

    else:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        w = np.full(3, 1.0 / 6.0)
        edges = ((0, 1), (1, 2), (2, 0))  # Gmsh TRI6 mid-edge ordering

        def shape(xi):
            x, y = xi[..., 0], xi[..., 1]
            L = np.stack([1.0 - x - y, x, y], axis=-1)
            vert = L * (2.0 * L - 1.0)
            mid = np.stack([4.0 * L[..., i] * L[..., j] for i, j in edges], -1)
            return np.concatenate([vert, mid], axis=-1)

        def shape_grad(xi):
            x, y = xi[..., 0], xi[..., 1]
            L = np.stack([1.0 - x - y, x, y], axis=-1)
            dL = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
            out = np.zeros((*xi.shape[:-1], 6, 2))
            for a in range(3):
                out[..., a, :] = (4.0 * L[..., a, None] - 1.0) * dL[a]
            for k, (i, j) in enumerate(edges):
                out[..., 3 + k, :] = 4.0 * (
                    L[..., i, None] * dL[j] + L[..., j, None] * dL[i]
                )
            return out

    return pts, w, shape, shape_grad


def face_area_normals(coords: np.ndarray, faces: np.ndarray):
    """(dA [F, q], n [F, q, 3]): reference area weights and unit outward
    normals at each face quadrature point (isoparametric metric)."""
    pts, w, _shape, shape_grad = _tri_rule(3 if faces.shape[1] == 3 else 6)
    Xf = coords[faces]  # [F, nfn, 3]
    dN = shape_grad(pts)  # [q, nfn, 2]
    tang = np.einsum("fak,qad->fqkd", Xf, dN)  # [F, q, 3, 2]
    nrm = np.cross(tang[..., 0], tang[..., 1])  # [F, q, 3]
    mag = np.linalg.norm(nrm, axis=-1)
    return mag * w[None, :], nrm / mag[..., None]


def traction_forces(mesh: Mesh, specs: dict, faces: np.ndarray | None = None):
    """Consistent nodal forces f64[N, 3] for dead surface tractions.

    specs: {node_set_name: traction_vector} — the traction (force / unit
    reference area) acts on every boundary face ALL of whose nodes belong
    to the named set. `pressure_forces` is the scalar-normal variant.
    """
    coords = np.asarray(mesh.coords_host, float)
    if faces is None:
        faces = boundary_faces(mesh)
    f = np.zeros((mesh.n_nodes, 3))
    for name, vec in specs.items():
        sel = _faces_in_set(mesh, faces, name)
        if not sel.size:
            raise ValueError(
                f"traction set '{name}' selects no boundary faces"
            )
        fsel = faces[sel]
        dA, _n = face_area_normals(coords, fsel)  # [F, q]
        pts, _w, shape, _sg = _tri_rule(3 if faces.shape[1] == 3 else 6)
        N = shape(pts)  # [q, nfn]
        # f[a] += sum_q (w dA)_q N_a(q) t
        fa = np.einsum("fq,qa->fa", dA, N)[..., None] * np.asarray(vec, float)
        np.add.at(f, fsel.reshape(-1), fa.reshape(-1, 3))
    return torch.as_tensor(f, dtype=DTYPE, device=mesh.device)


def pressure_forces(mesh: Mesh, specs: dict, faces: np.ndarray | None = None):
    """Consistent nodal forces for dead normal pressure p (force / unit
    reference area along the INWARD normal, the usual sign convention:
    positive p pushes against the surface). Dead-load form: the normal is
    the reference-configuration normal, so the force is constant and the
    tangent needs no follower-load term."""
    coords = np.asarray(mesh.coords_host, float)
    if faces is None:
        faces = boundary_faces(mesh)
    f = np.zeros((mesh.n_nodes, 3))
    for name, p in specs.items():
        sel = _faces_in_set(mesh, faces, name)
        if not sel.size:
            raise ValueError(
                f"pressure set '{name}' selects no boundary faces"
            )
        fsel = faces[sel]
        dA, n = face_area_normals(coords, fsel)  # [F, q], [F, q, 3]
        pts, _w, shape, _sg = _tri_rule(3 if faces.shape[1] == 3 else 6)
        N = shape(pts)  # [q, nfn]
        # f[a] += sum_q (w dA)_q N_a(q) (-p n_q)
        fa = np.einsum("fq,qa,fqk->fak", dA, N, n) * (-float(p))
        np.add.at(f, fsel.reshape(-1), fa.reshape(-1, 3))
    return torch.as_tensor(f, dtype=DTYPE, device=mesh.device)


def _faces_in_set(mesh: Mesh, faces: np.ndarray, name: str) -> np.ndarray:
    if name not in mesh.node_sets:
        raise KeyError(
            f"unknown node set '{name}' (have {sorted(mesh.node_sets)})"
        )
    member = np.zeros(mesh.n_nodes, bool)
    member[np.asarray(mesh.node_sets[name])] = True
    return np.nonzero(member[faces].all(axis=1))[0]
