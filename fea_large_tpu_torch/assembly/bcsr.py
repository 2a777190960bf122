"""Block-CSR (3x3 nodal blocks) global stiffness of the f64 assembled path
(counterpart of `fea_large_tpu/assembly/bcsr.py`).

Storage (block rows = nodes, 3x3 blocks):
    indptr   int64 [N+1]         block-row pointers
    indices  int64 [nnzb]        block column (node) of each stored block
    row_ids  int64 [nnzb]        block row of each stored block
    data     f64 [nnzb, 3, 3]    block values

The sparsity and the assembly map are built once per mesh on the host
(`BCSRStructure.build`, the reference's numpy build). Assembly sums the
element blocks of each slot through valence buckets (`ScatterBuckets`) in
a fixed order; the product y = K x is the kernel B10 on the card and its
plain version on the CPU (ops/bcsr_kernels.py). The reference's product
is XLA, and its Pallas variant computes the same contraction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.elements.kernels import ElementGeometry, element_stiffness
from fea_large_tpu_torch.ops import bcsr_kernels
from fea_large_tpu_torch.ops.soa import ScatterBuckets


@dataclasses.dataclass(frozen=True)
class BCSRStructure:
    """Sparsity and assembly maps of one mesh, on one device.

    indptr, indices, row_ids   the BCSR index arrays (device tensors)
    perm, segment_ids          the reference's sorted assembly map (host
                               numpy): entries (e, a, b) sorted by slot,
                               and the slot of each sorted entry
    slot_buckets               entry (e, a, b) -> slot sums, in entry order
    row_buckets                slot -> block-row sums (the plain product)
    diag_slots                 int64 [N] slot of each diagonal block
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    row_ids: torch.Tensor
    perm: np.ndarray
    segment_ids: np.ndarray
    slot_buckets: ScatterBuckets
    row_buckets: ScatterBuckets
    diag_slots: torch.Tensor
    n_nodes: int
    nnzb: int

    @staticmethod
    def build(conn: np.ndarray, n_nodes: int, device) -> "BCSRStructure":
        """Host build from the connectivity [E, npe] (the reference's
        numpy), with the maps on `device`."""
        conn = np.asarray(conn)
        E, npe = conn.shape
        rows = np.repeat(conn, npe, axis=1).reshape(-1)  # (e, a, b) -> node a
        cols = np.tile(conn, (1, npe)).reshape(-1)  # (e, a, b) -> node b
        keys = rows.astype(np.int64) * n_nodes + cols
        uniq, slot_of_entry = np.unique(keys, return_inverse=True)
        slot_of_entry = slot_of_entry.reshape(-1)
        nnzb = uniq.shape[0]
        u_rows = (uniq // n_nodes).astype(np.int64)
        u_cols = (uniq % n_nodes).astype(np.int64)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, u_rows + 1, 1)
        indptr = np.cumsum(indptr)
        perm = np.argsort(slot_of_entry, kind="stable")
        diag = np.nonzero(u_rows == u_cols)[0]
        if diag.shape[0] != n_nodes:
            raise ValueError("every node needs a diagonal block (a node of no element?)")

        def dev(x):
            return torch.as_tensor(x, dtype=torch.int64, device=device)

        return BCSRStructure(
            indptr=dev(indptr), indices=dev(u_cols), row_ids=dev(u_rows),
            perm=perm, segment_ids=slot_of_entry[perm],
            slot_buckets=ScatterBuckets.from_flat(slot_of_entry, nnzb, device),
            row_buckets=ScatterBuckets.from_flat(u_rows, int(n_nodes), device),
            diag_slots=dev(diag), n_nodes=int(n_nodes), nnzb=int(nnzb),
        )

    def assemble_blocks(self, Ke: torch.Tensor) -> torch.Tensor:
        """Ke [E, npe, 3, npe, 3] -> BCSR data [nnzb, 3, 3], each slot the
        sum of its element blocks in (e, a, b) order."""
        E, npe = Ke.shape[0], Ke.shape[1]
        blocks = Ke.permute(0, 1, 3, 2, 4).reshape(E * npe * npe, 3, 3)
        return self.slot_buckets.apply_rows(blocks)


@dataclasses.dataclass(frozen=True)
class BCSRMatrix:
    """Assembled BCSR stiffness: structure, block data and the product."""

    structure: BCSRStructure
    data: torch.Tensor  # [nnzb, 3, 3]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y [N, 3] = K x for x [N, 3]: B10 on CUDA tensors, its plain
        version on CPU tensors."""
        return bcsr_kernels.bcsr_spmv(self.structure, self.data, x)

    def block_diagonal(self) -> torch.Tensor:
        """The nodal 3x3 diagonal blocks [N, 3, 3] (block-Jacobi)."""
        return self.data[self.structure.diag_slots]

    def to_dense(self) -> torch.Tensor:
        """Dense [3N, 3N]; tests only."""
        s = self.structure
        n = s.n_nodes
        K = self.data.new_zeros((n, 3, n, 3))
        K[s.row_ids, :, s.indices, :] = self.data
        return K.reshape(3 * n, 3 * n)


def assemble_bcsr(u, conn, geom: ElementGeometry, material, structure: BCSRStructure,
                  node_scatter):
    """(K as BCSRMatrix, f_int [N, 3]) at u [N, 3]: the config-2 assembly."""
    Ke, fe = element_stiffness(u[conn], geom, material)
    return BCSRMatrix(structure, structure.assemble_blocks(Ke)), node_scatter(fe)
