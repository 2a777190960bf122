"""Block-CSR (3x3 nodal blocks) global stiffness of the f64 assembled path
(counterpart of `fea_large_tpu/assembly/bcsr.py`).

Storage (block rows = nodes, 3x3 blocks):
    indptr   int64 [N+1]         block-row pointers
    indices  int64 [nnzb]        block column (node) of each stored block
    row_ids  int64 [nnzb]        block row of each stored block
    data     f64 [nnzb, 3, 3]    block values
The kernel B10 reads int32 copies of indptr and indices (half the index
bytes of every product); the int64 arrays serve everything else.

The sparsity and the assembly map are built once per mesh on the host
(`BCSRStructure.build`, the reference's numpy build). Assembly
(`assemble_bcsr`) sums the element blocks of each slot in a fixed order:
on the card, in f64, for the registered materials and the elements the
kernels are built for (`assembly_kernels.supported`), two kernels
(ops/assembly_kernels.py): an element pass that writes each tet's upper
stiffness blocks and its force, and a slot sum that walks each slot's
entries in (e, a, b) order, then the f64 nodal sum of the force
(`elem_kernels.nodal_sum`); everywhere else the plain element stiffness
(elements/kernels.py) and valence-bucket sums (`ScatterBuckets`). The
kernels' slot table and block buffer are built once per structure, by a
solver's set-up (`prepare_kernels`) or at their first use. The product
y = K x is the kernel B10 on the card and its plain version on the CPU
(ops/bcsr_kernels.py). The reference's product is XLA, and its Pallas
variant computes the same contraction.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fea_large_tpu_torch.elements.kernels import ElementGeometry, element_stiffness
from fea_large_tpu_torch.ops import assembly_kernels as ak
from fea_large_tpu_torch.ops import bcsr_kernels
from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops.soa import ScatterBuckets
from fea_large_tpu_torch.utils import profiling

INT32_LIMIT = 2**31


def check_int32_sizes(n_nodes: int, nnzb: int) -> None:
    """Raise unless block rows and stored blocks can be indexed in int32,
    as the kernel B10 indexes them."""
    if n_nodes >= INT32_LIMIT or nnzb >= INT32_LIMIT:
        raise ValueError(f"the BCSR product indexes in int32: n_nodes {n_nodes} and nnzb "
                         f"{nnzb} must both be below 2**31")


@dataclasses.dataclass(frozen=True)
class BCSRStructure:
    """Sparsity and assembly maps of one mesh, on one device.

    indptr, indices, row_ids   the BCSR index arrays (device tensors)
    indptr32, indices32        int32 copies of indptr and indices, which the
                               kernel B10 reads
    perm, segment_ids          the reference's sorted assembly map (host
                               numpy): entries (e, a, b) sorted by slot,
                               and the slot of each sorted entry
    slot_buckets               entry (e, a, b) -> slot sums, in entry order
    row_buckets                slot -> block-row sums (the plain product)
    diag_slots                 int64 [N] slot of each diagonal block
    conn32                     int32 [E, npe] connectivity, which the
                               assembly kernels read
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    row_ids: torch.Tensor
    indptr32: torch.Tensor
    indices32: torch.Tensor
    perm: np.ndarray
    segment_ids: np.ndarray
    slot_buckets: ScatterBuckets
    row_buckets: ScatterBuckets
    diag_slots: torch.Tensor
    conn32: torch.Tensor
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
        check_int32_sizes(int(n_nodes), int(nnzb))
        u_rows = (uniq // n_nodes).astype(np.int64)
        u_cols = (uniq % n_nodes).astype(np.int64)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, u_rows + 1, 1)
        indptr = np.cumsum(indptr)
        perm = np.argsort(slot_of_entry, kind="stable")
        diag = np.nonzero(u_rows == u_cols)[0]
        if diag.shape[0] != n_nodes:
            raise ValueError("every node needs a diagonal block (a node of no element?)")

        def dev(x, dtype=torch.int64):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return BCSRStructure(
            indptr=dev(indptr), indices=dev(u_cols), row_ids=dev(u_rows),
            indptr32=dev(indptr, torch.int32), indices32=dev(u_cols, torch.int32),
            perm=perm, segment_ids=slot_of_entry[perm],
            slot_buckets=ScatterBuckets.from_flat(slot_of_entry, nnzb, device),
            row_buckets=ScatterBuckets.from_flat(u_rows, int(n_nodes), device),
            diag_slots=dev(diag), conn32=dev(conn, torch.int32), n_nodes=int(n_nodes),
            nnzb=int(nnzb),
        )

    def assemble_blocks(self, Ke: torch.Tensor) -> torch.Tensor:
        """Ke [E, npe, 3, npe, 3] -> BCSR data [nnzb, 3, 3], each slot the
        sum of its element blocks in (e, a, b) order."""
        E, npe = Ke.shape[0], Ke.shape[1]
        blocks = Ke.permute(0, 1, 3, 2, 4).reshape(E * npe * npe, 3, 3)
        return self.slot_buckets.apply_rows(blocks)

    def prepare_kernels(self) -> None:
        """Build the assembly kernels' slot table and block buffer now (a
        solver's set-up) rather than at the first assembly."""
        self.slot_table, self.element_buffer  # noqa: B018

    @functools.cached_property
    def slot_table(self) -> ak.SlotTable:
        """The assembly kernels' slot table, built on the host at its first
        use and kept."""
        return ak.SlotTable.build(self.perm, self.segment_ids, self.nnzb, self.conn32.shape[1],
                                  self.indptr.device)

    @functools.cached_property
    def element_buffer(self) -> torch.Tensor:
        """f64 [E, P, 3, 3]: the element pass's blocks, allocated at its first
        use and written by every assembly after."""
        E, npe = self.conn32.shape
        return torch.empty((E, npe * (npe + 1) // 2, 3, 3), dtype=torch.float64,
                           device=self.indptr.device)


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
        """Dense [3N, 3N] (the direct path, assembly/dense.py): each stored
        block written once, no accumulation."""
        s = self.structure
        n = s.n_nodes
        K = self.data.new_zeros((n, 3, n, 3))
        K[s.row_ids, :, s.indices, :] = self.data
        return K.reshape(3 * n, 3 * n)


def assemble_bcsr(u, conn, geom: ElementGeometry, material, structure: BCSRStructure,
                  node_scatter):
    """(K as BCSRMatrix, f_int [N, 3]) at u [N, 3]: the config-2 assembly.
    Where `assembly_kernels.supported` (an f64 u on the card, a registered
    material, a kernel's element), the element pass and the slot sum of
    ops/assembly_kernels.py on the structure's conn32, slot table and block
    buffer, and the f64 nodal-sum kernel on `node_scatter`'s table; else
    the plain element stiffness at u[conn] and the bucket sums. Its device
    spans (utils/profiling.py): `stiffness` (the element pass), then
    `assemble` (the slot sums and the nodal sum), closed at its end."""
    if u.shape != (structure.n_nodes, 3):
        raise ValueError(f"u: expected [{structure.n_nodes}, 3], got {tuple(u.shape)}")
    profiling.stamp(u.device, "stiffness")
    if ak.supported(u.device, u.dtype, *geom.gradN.shape[1:3], material):
        blocks, fe = ak.element_blocks(u.contiguous(), structure.conn32, geom.gradN,
                                       geom.detJxW, material, out=structure.element_buffer)
        profiling.stamp(u.device, "assemble")
        K = BCSRMatrix(structure, ak.slot_sum(blocks, structure.slot_table))
        f_int = ek.nodal_sum(fe, node_scatter.buckets).T
    else:
        Ke, fe = element_stiffness(u[conn], geom, material)
        profiling.stamp(u.device, "assemble")
        K = BCSRMatrix(structure, structure.assemble_blocks(Ke))
        f_int = node_scatter(fe)
    profiling.close_span(u.device)
    return K, f_int
