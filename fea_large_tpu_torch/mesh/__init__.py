"""Meshes, node sets and the box generators (counterpart of
`fea_large_tpu/mesh/`)."""

from fea_large_tpu_torch.mesh.core import Mesh, make_node_sets  # noqa: F401
from fea_large_tpu_torch.mesh.generators import box_mesh, tet4_to_tet10  # noqa: F401
