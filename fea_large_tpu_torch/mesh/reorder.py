"""Node/element reordering (bandwidth reduction) for imported meshes
(counterpart of `fea_large_tpu/mesh/reorder.py`).

Imported unstructured meshes can come in any node order. Reverse
Cuthill-McKee over the node adjacency graph (through shared elements), by
scipy's `reverse_cuthill_mckee` as in the reference, restores a banded
ordering comparable to the generators', so that the permutation is the
reference's.

Task-file usage: `"mesh": {"file": "part.msh", "reorder": "rcm"}`
(io/task.py). The permutation is applied once at load time: coords,
connectivity, and every named node set are renumbered consistently, and
elements are sorted by their minimum renumbered node so nearby elements
touch nearby nodes. All downstream artifacts (solution vectors, exports)
are in the renumbered ordering — self-consistent end-to-end.
"""

from __future__ import annotations

import numpy as np

from fea_large_tpu_torch.mesh.core import Mesh


def rcm_permutation(mesh: Mesh) -> np.ndarray:
    """Reverse Cuthill-McKee node permutation: `perm[i]` = new id of old
    node i. Adjacency = nodes sharing an element (the exact sparsity of
    the assembled stiffness)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    conn = mesh.conn_host
    e = np.repeat(np.arange(len(conn)), conn.shape[1])
    n = conn.reshape(-1)
    inc = sp.coo_matrix(
        (np.ones(len(n)), (n, e)), shape=(mesh.n_nodes, len(conn))
    ).tocsr()
    adj = (inc @ inc.T).tocsr()
    order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    perm = np.empty(mesh.n_nodes, np.int64)
    perm[order] = np.arange(mesh.n_nodes)
    return perm


def renumber_nodes(mesh: Mesh, perm: np.ndarray) -> Mesh:
    """Apply a node permutation (`perm[i]` = new id of old node i) to
    coords, connectivity, and node sets; sort elements by min new node.
    The result lies on `mesh`'s device."""
    coords = np.empty_like(mesh.coords_host)
    coords[perm] = mesh.coords_host
    conn = perm[mesh.conn_host]
    conn = conn[np.argsort(conn.min(axis=1), kind="stable")]
    node_sets = {k: np.sort(perm[v]) for k, v in mesh.node_sets.items()}
    return Mesh.create(coords, conn, mesh.element_type, node_sets=node_sets,
                       device=mesh.device, n_quad=mesh.n_quad)


def reorder_rcm(mesh: Mesh) -> Mesh:
    """RCM-renumbered copy of `mesh` (see module docstring)."""
    return renumber_nodes(mesh, rcm_permutation(mesh))
