"""The benchmark's own TET10 box meshes, on the half-grid of the cell lattice.

A box of side L cut into n_x x n_y x n_z cells (n on every axis for a
cube of cubes) has its TET10 nodes (corners and straight-edge midpoints) on
the half-grid: node (i, j, k) lies at (i L / (2 n_x), j L / (2 n_y),
k L / (2 n_z)), i in 0..2 n_x and so on, with the linear index
(i * (2 n_y + 1) + j) * (2 n_z + 1) + k. Every array here is indexed that
way, so two meshes of the same box agree node by node whatever order a
program numbers its nodes in.

Two decompositions of the unit cell:
  * "kuhn": the six Kuhn (Freudenthal) tets along the monotone corner paths
    (0,0,0) -> (1,1,1), one per axis permutation, the same in every cell;
  * "5tet": five tets a cell, the corner table mirrored in cells of odd
    i + j + k so that neighbouring cells share their face diagonals.
"""

from __future__ import annotations

import itertools

import numpy as np

#: unit-cube corners in the 5-tet tables' numbering
CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
FIVE_TET_EVEN = np.array([[0, 1, 2, 5], [0, 2, 3, 7], [0, 5, 7, 4], [2, 7, 5, 6], [0, 2, 7, 5]])
FIVE_TET_ODD = np.array([[1, 3, 0, 4], [1, 2, 3, 6], [1, 6, 4, 5], [3, 4, 6, 7], [1, 3, 6, 4]])
#: TET10 edges (vertex pairs) in the order of the mid-edge nodes 4..9
EDGES = ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))


def kuhn_cell() -> np.ndarray:
    """i64[6, 4, 3]: the corner offsets of the six Kuhn tets of a cell."""
    tets = []
    for perm in itertools.permutations(range(3)):
        v = [np.zeros(3, np.int64)]
        for ax in perm:
            v.append(v[-1] + np.eye(3, dtype=np.int64)[ax])
        tets.append(np.stack(v))
    return np.stack(tets)


def cells_per_axis(n) -> tuple:
    """(n_x, n_y, n_z) of a box's `n`: one count for every axis, or three."""
    return (int(n),) * 3 if np.ndim(n) == 0 else tuple(int(k) for k in n)


def cell_tets(kind: str, n) -> np.ndarray:
    """i64[E, 4, 3] the corner lattice points of every tet of the box."""
    axes = (np.arange(k) for k in cells_per_axis(n))
    cells = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    if kind == "kuhn":
        return (cells[:, None, None, :] + kuhn_cell()[None]).reshape(-1, 4, 3)
    if kind == "5tet":
        odd = cells.sum(1) % 2 == 1
        table = np.where(odd[:, None, None], FIVE_TET_ODD[None], FIVE_TET_EVEN[None])
        return (cells[:, None, None, :] + CUBE_CORNERS[table]).reshape(-1, 4, 3)
    raise ValueError(f"unknown decomposition {kind!r}")


def half_index(points: np.ndarray, n) -> np.ndarray:
    """Linear half-grid index of half-grid points [..., 3]."""
    _, my, mz = (2 * k + 1 for k in cells_per_axis(n))
    return (points[..., 0] * my + points[..., 1]) * mz + points[..., 2]


class BoxMesh:
    """A TET10 box of one decomposition, side `length`, of n^3 cells or,
    where `n` is three counts, of n_x x n_y x n_z.

    conn     i64[E, 10] half-grid node index of each element node: the four
             vertices, positively oriented, then the midpoints of EDGES
    present  bool[P] which of the P = prod(2 n_a + 1) half-grid points are
             nodes
    coords   f64[P, 3] every half-grid point's position
    """

    def __init__(self, kind: str, n, length: float = 1.0):
        self.kind, self.n, self.length = kind, n, float(length)
        self.half = np.array([2 * k for k in cells_per_axis(n)])  # half-cells per axis
        verts = 2 * cell_tets(kind, n)  # half-grid points of the vertices
        edge = (verts[:, 1:] - verts[:, :1]).astype(np.float64)
        flip = np.linalg.det(edge) < 0
        verts[flip] = verts[flip][:, [0, 2, 1, 3]]
        mids = np.stack([(verts[:, a] + verts[:, b]) // 2 for a, b in EDGES], 1)
        self.conn = half_index(np.concatenate([verts, mids], 1), n)
        self.present = np.zeros(int(np.prod(self.half + 1)), bool)
        self.present[self.conn.reshape(-1)] = True
        axes = (np.arange(m) for m in self.half + 1)
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        self.grid = grid
        self.coords = grid * (self.length / self.half)

    @property
    def n_points(self) -> int:
        return self.present.size

    @property
    def n_nodes(self) -> int:
        return int(self.present.sum())

    @property
    def n_elements(self) -> int:
        return self.conn.shape[0]

    def face(self, name: str) -> np.ndarray:
        """bool[P] the nodes of a face ("xmin" ... "zmax")."""
        axis = "xyz".index(name[0])
        end = 0 if name[1:] == "min" else self.half[axis]
        return self.present & (self.grid[:, axis] == end)

    def locate(self, points: np.ndarray) -> np.ndarray:
        """Half-grid index of each of the positions [N, 3]; raises where a
        position is not a node of this mesh or two positions share one."""
        scaled = np.asarray(points, np.float64) * (self.half / self.length)
        snapped = np.rint(scaled)
        off = float(np.abs(scaled - snapped).max()) if scaled.size else 0.0
        if off > 1e-6:
            raise ValueError(f"a node lies {off:.3e} half-cells off the half-grid")
        idx = half_index(snapped.astype(np.int64), self.n)
        inside = (snapped >= 0).all(1) & (snapped <= self.half).all(1)
        if not inside.all() or not self.present[np.where(inside, idx, 0)].all():
            raise ValueError("a node is not a node of the benchmark's mesh")
        if np.unique(idx).size != idx.size or idx.size != self.n_nodes:
            raise ValueError(f"{idx.size} nodes do not map one to one onto the benchmark's "
                             f"{self.n_nodes}")
        return idx
