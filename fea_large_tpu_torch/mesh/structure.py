"""Structured-box mesh descriptor: gathers and scatters without indices.

Host-side numpy, a copy of `fea_large_tpu/mesh/structure.py` pinned to it
by tests/test_torch_mesh.py. On a generated box mesh with the uniform
Kuhn/Freudenthal 6-tet cell decomposition and class-contiguous node
numbering, the (tet-slot, node-slot) -> node map is AFFINE in the cell
lattice index. Every gather of nodal values is then a static shifted SLICE
of a class subgrid, and every nodal scatter-add a sum of shifted cell-grid
blocks added into the class grids: plain memory ops, no indexed addressing,
deterministic order by construction.

`BoxStructure` records that affine map. Meshes built by
`mesh.generators.box_mesh_kuhn` carry one; `ops.soa` and
`ops.struct_kernels` use it for the (class, offset) pair gather and the
pair-row scatter.

Node classes: each node of the Kuhn lattice is either a cell corner or the
midpoint of a monotone lattice edge; the class is the component-difference
pattern d in {0,1}^3 of that edge (corners: d = (0,0,0)). A class forms its
own regular grid of dims[ax] = n_cells[ax] + (0 if d[ax] else 1), numbered
contiguously and lexicographically — that contiguity is what makes the
gather a reshape+slice.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from fea_large_tpu_torch.elements.reference import TET10_EDGES

#: class numbering order: corners first, then the 7 mid-edge difference
#: patterns (x, y, z cube edges; xy, xz, yz face diagonals; body diagonal)
CLASS_ORDER = (
    (0, 0, 0),
    (1, 0, 0),
    (0, 1, 0),
    (0, 0, 1),
    (1, 1, 0),
    (1, 0, 1),
    (0, 1, 1),
    (1, 1, 1),
)


def kuhn_tets() -> np.ndarray:
    """i64[6, 4, 3] corner lattice offsets of the six positively-oriented
    Kuhn tets filling the unit cube: one per axis permutation, vertices on
    the monotone path (0,0,0) -> (1,1,1); odd permutations get two vertices
    swapped to fix orientation. The decomposition is conforming across
    translated cells (every face diagonal runs min-corner -> max-corner)."""
    tets = []
    for perm in itertools.permutations((0, 1, 2)):
        v = [np.zeros(3, np.int64)]
        for ax in perm:
            nxt = v[-1].copy()
            nxt[ax] = 1
            v.append(nxt)
        arr = np.stack(v)
        if np.linalg.det((arr[1:] - arr[0]).astype(float)) < 0:
            arr[[1, 2]] = arr[[2, 1]]
        tets.append(arr)
    return np.stack(tets)


@dataclasses.dataclass(frozen=True)
class BoxStructure:
    """Static affine connectivity of a Kuhn-decomposed box (all tuples —
    hashable, carried as pytree aux metadata on Mesh/SoAProblem).

    cells        (nx, ny, nz) cell-lattice dims; elements are numbered
                 TET-SLOT-MAJOR: element e = t * ncells + c with c the
                 lexicographic cell index — so an [E]-vector reshapes to
                 [T, ncells] and per-slot views are contiguous.
    classes      node-class difference patterns, in node-numbering order
    class_dims   per class: its grid dims (gx, gy, gz)
    class_base   per class: first node id (classes are contiguous)
    slot_class   [T][npe] class index of local node slot a of tet slot t
    slot_offset  [T][npe] lattice offset (0/1 per axis): node id =
                 class_base + ravel(cell_ijk + offset, class_dims)
    """

    cells: tuple
    classes: tuple
    class_dims: tuple
    class_base: tuple
    slot_class: tuple
    slot_offset: tuple

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.cells
        return nx * ny * nz

    @property
    def n_tets(self) -> int:
        return len(self.slot_class)

    @property
    def n_nodes(self) -> int:
        k = len(self.classes) - 1
        gx, gy, gz = self.class_dims[k]
        return self.class_base[k] + gx * gy * gz

    @property
    def npe(self) -> int:
        return len(self.slot_class[0])


def build_box_structure(
    nx: int, ny: int, nz: int, element_type: str
) -> BoxStructure:
    """Construct the descriptor (classes + slot tables) for an nx*ny*nz
    Kuhn box of the given element type."""
    tets = kuhn_tets()
    slot_class, slot_offset = [], []
    used = [(0, 0, 0)] if element_type == "tet4" else list(CLASS_ORDER)
    cindex = {d: k for k, d in enumerate(used)}
    for t in range(tets.shape[0]):
        corners = tets[t]
        specs = [((0, 0, 0), tuple(int(x) for x in c)) for c in corners]
        if element_type == "tet10":
            for i, j in TET10_EDGES:
                p, q = corners[i], corners[j]
                d = tuple(int(x) for x in np.abs(q - p))
                o = tuple(int(x) for x in np.minimum(p, q))
                specs.append((d, o))
        slot_class.append(tuple(cindex[d] for d, _o in specs))
        slot_offset.append(tuple(o for _d, o in specs))
    dims, base, acc = [], [], 0
    for d in used:
        dm = tuple(
            n + (0 if d[ax] else 1) for ax, n in enumerate((nx, ny, nz))
        )
        dims.append(dm)
        base.append(acc)
        acc += dm[0] * dm[1] * dm[2]
    return BoxStructure(
        cells=(nx, ny, nz),
        classes=tuple(used),
        class_dims=tuple(dims),
        class_base=tuple(base),
        slot_class=tuple(slot_class),
        slot_offset=tuple(slot_offset),
    )


def class_coords(
    st: BoxStructure, lx: float, ly: float, lz: float
) -> np.ndarray:
    """f64[N, 3] nodal coordinates in class-contiguous numbering."""
    nx, ny, nz = st.cells
    h = (lx / nx, ly / ny, lz / nz)
    parts = []
    for d, dm in zip(st.classes, st.class_dims):
        axes = [
            (np.arange(dm[ax]) + 0.5 * d[ax]) * h[ax] for ax in range(3)
        ]
        G = np.meshgrid(*axes, indexing="ij")
        parts.append(np.stack([g.ravel() for g in G], axis=1))
    return np.concatenate(parts, axis=0)


def structure_conn(st: BoxStructure) -> np.ndarray:
    """i64[T*ncells, npe] connectivity realizing the affine map (tet-slot-
    major element order)."""
    nx, ny, nz = st.cells
    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    ci, cj, ck = I.ravel(), J.ravel(), K.ravel()
    C = st.n_cells
    conn = np.empty((st.n_tets * C, st.npe), np.int64)
    for t in range(st.n_tets):
        for a in range(st.npe):
            k = st.slot_class[t][a]
            o = st.slot_offset[t][a]
            gx, gy, gz = st.class_dims[k]
            ids = st.class_base[k] + (
                ((ci + o[0]) * gy + (cj + o[1])) * gz + (ck + o[2])
            )
            conn[t * C : (t + 1) * C, a] = ids
    return conn
