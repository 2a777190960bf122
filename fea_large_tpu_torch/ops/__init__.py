"""Element-pass operators and their CUDA kernels (counterpart of
`fea_large_tpu/ops/`). Only the 3x3 helpers are exported here; import
`ops.soa` and the kernel modules directly (they import the materials, and
build or load no CUDA library until a kernel is launched)."""

from fea_large_tpu_torch.ops.smallmat import (  # noqa: F401
    adjugate3,
    det3,
    inv3,
    inv_det3,
    sym3,
)
