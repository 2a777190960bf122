"""Task files, mesh files and result export (counterpart of
`fea_large_tpu/io/`)."""

from fea_large_tpu_torch.io.export import export_npz, export_vtk  # noqa: F401
from fea_large_tpu_torch.io.meshio import load_mesh_file, save_mesh_file  # noqa: F401
from fea_large_tpu_torch.io.task import Task, load_task  # noqa: F401
