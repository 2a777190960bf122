"""Dense global stiffness of the direct path (counterpart of
`fea_large_tpu/assembly/dense.py`), for problems whose [3N, 3N] f64 matrix
fits on the device (config 1: ~1k TET4 elements).

The reference scatter-adds the element tangents into K (`K.at[dofs,
dofs].add`). The torch counterpart (`index_put_` with accumulate,
`index_add_`) sums with float atomics on CUDA, whose order changes from run
to run. Here each slot of the BCSR sparsity is summed first, through the
slot buckets of `BCSRStructure.assemble_blocks` in a fixed (e, a, b) order,
and the distinct slots are then written into K once each
(`BCSRMatrix.to_dense`, no accumulation): bitwise-equal repeats on every
device.
"""

from __future__ import annotations

import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements.kernels import ElementGeometry


def element_dofs(conn: torch.Tensor) -> torch.Tensor:
    """Global DOF indices per element [E, 3 npe], DOF = 3 node + component:
    the numbering of K's rows and columns."""
    comp = torch.arange(3, dtype=conn.dtype, device=conn.device)
    return (3 * conn[:, :, None] + comp).reshape(conn.shape[0], -1)


def assemble_dense(u: torch.Tensor, conn: torch.Tensor, geom: ElementGeometry, material,
                   structure: BCSRStructure, scatter: NodeScatter):
    """(K [3N, 3N], f_int [N, 3]) at u [N, 3]; `structure` is the mesh's
    BCSR sparsity (the order of the sums), `scatter` its node scatter."""
    K, f_int = assemble_bcsr(u, conn, geom, material, structure, scatter)
    return K.to_dense(), f_int


def mask_dense_system(K: torch.Tensor, r: torch.Tensor, free_mask: torch.Tensor):
    """(A, b) of the masked system A = M K M + (I - M), b = M r: free_mask
    and r [N, 3], A [3N, 3N] and b [3N]. A is SPD where K restricted to the
    free DOFs is. One new [3N, 3N] buffer; K is left as it is."""
    m = free_mask.reshape(-1)
    A = K * m[:, None]
    A.mul_(m[None, :])
    A.diagonal().add_(1.0 - m)
    return A, r.reshape(-1) * m
