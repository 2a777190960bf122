"""Node scatter, dense and BCSR assembly, and the matrix-free tangent
(counterpart of `fea_large_tpu/assembly/`)."""

from fea_large_tpu_torch.assembly.bcsr import BCSRMatrix, BCSRStructure  # noqa: F401
from fea_large_tpu_torch.assembly.dense import assemble_dense  # noqa: F401
from fea_large_tpu_torch.assembly.matfree import TangentState, make_operator  # noqa: F401
from fea_large_tpu_torch.assembly.scatter import NodeScatter  # noqa: F401
