"""Reference-tetrahedron element definitions: shape functions + quadrature.

Implements SURVEY.md §5.2 (isoparametric TET4/TET10, Gmsh node ordering) and
§5.3 (quadrature rules on the reference tetrahedron xi,eta,zeta >= 0,
xi+eta+zeta <= 1; weights sum to the reference volume 1/6).

Host-side numpy, a copy of `fea_large_tpu/elements/reference.py` pinned to
it by tests/test_torch_mesh.py. Shape-function derivative tables are
evaluated once at the fixed quadrature points; `ops.soa.SoAProblem.build`
turns them into the per-tet-slot geometry tables the element passes read.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# Quadrature rules (SURVEY.md §5.3). Barycentric points on the reference tet,
# weights sum to 1/6 (the reference volume).
# ---------------------------------------------------------------------------


def _quad_tet_1pt():
    pts = np.array([[0.25, 0.25, 0.25]])
    wts = np.array([1.0 / 6.0])
    return pts, wts


def _quad_tet_4pt():
    # degree-2 rule: permutations of (a, b, b, b) with
    # a=(5+3*sqrt5)/20, b=(5-sqrt5)/20 (verified exact on quadratics,
    # SURVEY.md §5.3)
    a = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
    b = (5.0 - np.sqrt(5.0)) / 20.0
    # barycentric (L1,L2,L3,L4); (xi,eta,zeta) = (L2,L3,L4)
    bary = np.array(
        [
            [a, b, b, b],
            [b, a, b, b],
            [b, b, a, b],
            [b, b, b, a],
        ]
    )
    pts = bary[:, 1:]
    wts = np.full(4, 1.0 / 24.0)
    return pts, wts


def _quad_tet_5pt():
    # degree-3 rule: centroid with negative weight plus four (1/2,1/6,1/6,1/6)
    # permutations (SURVEY.md §5.3, ambiguity A2 option).
    bary = np.array(
        [
            [0.25, 0.25, 0.25, 0.25],
            [0.5, 1 / 6, 1 / 6, 1 / 6],
            [1 / 6, 0.5, 1 / 6, 1 / 6],
            [1 / 6, 1 / 6, 0.5, 1 / 6],
            [1 / 6, 1 / 6, 1 / 6, 0.5],
        ]
    )
    pts = bary[:, 1:]
    wts = np.array([-4.0 / 5.0, 9.0 / 20.0, 9.0 / 20.0, 9.0 / 20.0, 9.0 / 20.0]) / 6.0
    return pts, wts


_QUAD_RULES = {
    ("tet", 1): _quad_tet_1pt,
    ("tet", 4): _quad_tet_4pt,
    ("tet", 5): _quad_tet_5pt,
}


def tet_quadrature(n_points: int) -> tuple[np.ndarray, np.ndarray]:
    """(points [q,3] in (xi,eta,zeta), weights [q]) for the reference tet."""
    return _QUAD_RULES[("tet", n_points)]()


# ---------------------------------------------------------------------------
# Shape functions (SURVEY.md §5.2)
# ---------------------------------------------------------------------------


def tet4_shape(xi: np.ndarray) -> np.ndarray:
    """N [.., 4] at natural coords xi [.., 3]: linear barycentric."""
    x, y, z = xi[..., 0], xi[..., 1], xi[..., 2]
    return np.stack([1.0 - x - y - z, x, y, z], axis=-1)


def tet4_shape_grad(xi: np.ndarray) -> np.ndarray:
    """dN/dxi [.., 4, 3] — constant for TET4."""
    g = np.array(
        [
            [-1.0, -1.0, -1.0],
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    return np.broadcast_to(g, (*xi.shape[:-1], 4, 3)).copy()


# Gmsh TET10 mid-edge node ordering: nodes 4..9 sit on edges
# (1,2),(2,3),(3,1),(1,4),(2,4),(3,4) in 1-based vertex numbering
# (SURVEY.md §5.2, ambiguity A4 — canonical ordering of this framework;
# the mesh importer canonicalizes other orderings at load time).
TET10_EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))


def _tet_bary(xi: np.ndarray) -> np.ndarray:
    x, y, z = xi[..., 0], xi[..., 1], xi[..., 2]
    return np.stack([1.0 - x - y - z, x, y, z], axis=-1)


def tet10_shape(xi: np.ndarray) -> np.ndarray:
    """N [.., 10]: vertex N_a = L_a(2L_a-1), mid-edge N = 4 L_i L_j."""
    L = _tet_bary(xi)
    vert = L * (2.0 * L - 1.0)
    edge = np.stack([4.0 * L[..., i] * L[..., j] for i, j in TET10_EDGES], axis=-1)
    return np.concatenate([vert, edge], axis=-1)


def tet10_shape_grad(xi: np.ndarray) -> np.ndarray:
    """dN/dxi [.., 10, 3]."""
    L = _tet_bary(xi)
    # dL/dxi: L1 -> (-1,-1,-1); L2,L3,L4 -> unit rows
    dL = np.array(
        [
            [-1.0, -1.0, -1.0],
            [1.0, 0.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )  # [4, 3]
    batch = xi.shape[:-1]
    out = np.zeros((*batch, 10, 3))
    for a in range(4):
        out[..., a, :] = (4.0 * L[..., a, None] - 1.0) * dL[a]
    for e, (i, j) in enumerate(TET10_EDGES):
        out[..., 4 + e, :] = 4.0 * (L[..., i, None] * dL[j] + L[..., j, None] * dL[i])
    return out


# ---------------------------------------------------------------------------
# ElementType: the static (host-side) description consumed by kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ElementType:
    """Static element description; all tables are host numpy constants."""

    name: str
    n_nodes: int
    n_quad: int
    quad_points: np.ndarray  # [q, 3] natural coords
    quad_weights: np.ndarray  # [q]
    shape: np.ndarray  # N at quad points      [q, npe]
    shape_grad: np.ndarray  # dN/dxi at quad points [q, npe, 3]
    corner_nodes: tuple  # indices of the geometric vertices

    @property
    def n_dof(self) -> int:
        return 3 * self.n_nodes

    def __repr__(self) -> str:
        return f"ElementType({self.name}, q={self.n_quad})"

    def __hash__(self) -> int:
        return hash((self.name, self.n_quad))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ElementType)
            and self.name == other.name
            and self.n_quad == other.n_quad
        )


@lru_cache(maxsize=None)
def get_element(name: str, n_quad: int | None = None) -> ElementType:
    """Element factory. ``name`` in {"tet4", "tet10"}; ``n_quad`` overrides
    the default quadrature count (TET10: 4-pt degree-2 default, 5-pt degree-3
    option — SURVEY.md ambiguity A2, both rules shipped as config)."""
    name = name.lower()
    if name == "tet4":
        q = 1 if n_quad is None else n_quad
        pts, wts = tet_quadrature(q)
        return ElementType(
            name="tet4",
            n_nodes=4,
            n_quad=q,
            quad_points=pts,
            quad_weights=wts,
            shape=tet4_shape(pts),
            shape_grad=tet4_shape_grad(pts),
            corner_nodes=(0, 1, 2, 3),
        )
    if name == "tet10":
        q = 4 if n_quad is None else n_quad
        pts, wts = tet_quadrature(q)
        return ElementType(
            name="tet10",
            n_nodes=10,
            n_quad=q,
            quad_points=pts,
            quad_weights=wts,
            shape=tet10_shape(pts),
            shape_grad=tet10_shape_grad(pts),
            corner_nodes=(0, 1, 2, 3),
        )
    raise ValueError(f"unknown element type {name!r}")


TET4 = get_element("tet4")
TET10 = get_element("tet10")
