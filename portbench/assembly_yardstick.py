"""The work of one f64 assembly of the global BCSR stiffness (the element
stiffness and force, the slot sums, the nodal sum of the force) for the
yardstick (yardstick.py), counted from the configuration's shapes, never
from the program's tensors.

The least traffic any implementation moves: per tet its f64 geometry read
(q*npe*3 shape-function gradients and q weighted volumes) and its npe int32
nodes; per node u read and f_int written (48 B); per stored BCSR block its
72 B of values written once. The stored blocks and the tets are counted on
the benchmark's own mesh (`bcsr_yardstick.blocks`, `reference.mesh`).
Arithmetic: the stiffness's upper blocks alone, q*npe(npe+1)/2 blocks of 9
entries a tet at 8 operations an entry a point; the byte count bounds it.
"""

from __future__ import annotations

import functools

import bcsr_yardstick
import yardstick
from reference.mesh import BoxMesh, cells_per_axis

INDEX_BYTES = 4


@functools.lru_cache(maxsize=None)
def _tets(kind: str, cells: tuple) -> int:
    return int(BoxMesh(kind, cells).conn.shape[0])


def assembly_work(config: dict) -> tuple[int, int]:
    """(bytes, flops) of one f64 assembly on the configuration's TET10 mesh."""
    m = config["mesh"]
    E = _tets(m["kind"], cells_per_axis(m["n"]))
    n, nnzb = bcsr_yardstick.blocks(config)
    q, npe = yardstick.TET10_Q, yardstick.TET10_NPE
    f64 = yardstick.ITEM_BYTES["float64"]
    per_tet = (q * npe * 3 + q) * f64 + npe * INDEX_BYTES
    nbytes = per_tet * E + 2 * 3 * f64 * n + 9 * f64 * nnzb
    return nbytes, E * q * (npe * (npe + 1) // 2) * 9 * 8
