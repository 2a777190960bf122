"""The work of the f64 BCSR product y = K x (kernel B10) for the yardstick
(yardstick.py), counted from the configuration's shapes, never from the
program's tensors.

The product's stored 3x3 blocks are the distinct node pairs (a, b) that
share a tet, counted on the benchmark's own mesh of the configuration
(`reference.mesh.BoxMesh`) and cached per mesh. Bytes: each input read
once and the output written once, in the storage the product states: the
f64 blocks (72 B a block), the int32 block columns (4 B a block) and row
pointers (4 B a row, N + 1 rows), x and y (24 B a node each). Arithmetic:
one multiply-add per stored entry, 18 a block.
"""

from __future__ import annotations

import functools

import numpy as np

import yardstick
from reference.mesh import BoxMesh, cells_per_axis

INDEX_BYTES = 4


@functools.lru_cache(maxsize=None)
def _count(kind: str, cells: tuple) -> tuple[int, int]:
    mesh = BoxMesh(kind, cells)
    conn = mesh.conn
    keys = conn[:, :, None] * np.int64(mesh.n_points) + conn[:, None, :]
    return mesh.n_nodes, int(np.unique(keys.reshape(-1)).size)


def blocks(config: dict) -> tuple[int, int]:
    """(N, nnzb): the block rows (nodes) and stored blocks of the global
    stiffness on the configuration's mesh."""
    m = config["mesh"]
    return _count(m["kind"], cells_per_axis(m["n"]))


def spmv_work(config: dict) -> tuple[int, int]:
    """(bytes, flops) of one f64 BCSR product on the configuration's mesh."""
    n, nnzb = blocks(config)
    f64 = yardstick.ITEM_BYTES["float64"]
    nbytes = (9 * f64 + INDEX_BYTES) * nnzb + INDEX_BYTES * (n + 1) + 2 * 3 * f64 * n
    return nbytes, 18 * nnzb
