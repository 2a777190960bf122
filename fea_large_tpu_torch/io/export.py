"""Result export (counterpart of `fea_large_tpu/io/export.py`): legacy-ASCII
VTK deformed-mesh output, the deformed Gmsh mesh, and `.npz` per-step
displacement dumps (the npz dump doubles as the checkpoint/restart file).
The files are byte-for-byte the reference's for the same inputs: the same
formats, the same header (whose title names the reference package), from
the mesh's host arrays. Fields may be numpy arrays or tensors on any
device."""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from fea_large_tpu_torch.io.meshio import save_mesh_file
from fea_large_tpu_torch.mesh.core import Mesh

# VTK cell type ids
_VTK_TETRA = 10
_VTK_QUADRATIC_TETRA = 24


def _host(x) -> np.ndarray:
    """f64 numpy copy of a numpy array, a list or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float)


def export_vtk(path, mesh: Mesh, u=None, point_data: dict | None = None) -> None:
    """Write a legacy-ASCII VTK unstructured grid of the (optionally
    deformed) mesh. `u` [N,3] is written both into the node positions and as
    a point-data vector field `displacement`."""
    path = pathlib.Path(path)
    coords = np.asarray(mesh.coords_host, float)
    conn = np.asarray(mesh.conn_host)
    u_np = None if u is None else _host(u)
    pts = coords if u_np is None else coords + u_np
    npe = conn.shape[1]
    cell_type = _VTK_TETRA if npe == 4 else _VTK_QUADRATIC_TETRA

    lines = [
        "# vtk DataFile Version 3.0",
        "fea_large_tpu deformed mesh",
        "ASCII",
        "DATASET UNSTRUCTURED_GRID",
        f"POINTS {pts.shape[0]} double",
    ]
    lines += [" ".join(f"{x:.17g}" for x in p) for p in pts]
    lines.append(f"CELLS {conn.shape[0]} {conn.shape[0] * (npe + 1)}")
    lines += [f"{npe} " + " ".join(str(int(n)) for n in c) for c in conn]
    lines.append(f"CELL_TYPES {conn.shape[0]}")
    lines += [str(cell_type)] * conn.shape[0]

    fields = dict(point_data or {})
    if u_np is not None:
        fields.setdefault("displacement", u_np)
    if fields:
        lines.append(f"POINT_DATA {pts.shape[0]}")
        for name, data in fields.items():
            data = _host(data)
            if data.ndim == 2 and data.shape[1] == 3:
                lines.append(f"VECTORS {name} double")
                lines += [" ".join(f"{x:.17g}" for x in row) for row in data]
            else:
                lines.append(f"SCALARS {name} double 1")
                lines.append("LOOKUP_TABLE default")
                lines += [f"{x:.17g}" for x in data.reshape(-1)]
    path.write_text("\n".join(lines) + "\n")


def export_msh(path, mesh: Mesh, u=None, deformed: bool = True) -> None:
    """Write a Gmsh v2.2 ASCII `.msh` of the (optionally deformed) mesh.

    The $Nodes/$Elements sections come from `io.meshio.save_mesh_file`
    (which owns the canonical->Gmsh TET10 edge permutation), with displaced
    positions when `u` is given (deformed=False keeps the reference
    coordinates), plus a $NodeData view named "displacement". Round-trips
    through `load_gmsh`."""
    path = pathlib.Path(path)
    u_np = None if u is None else _host(u)
    out_mesh = mesh
    if u_np is not None and deformed:
        out_mesh = dataclasses.replace(mesh, coords_host=mesh.coords_host + u_np)
    save_mesh_file(path, out_mesh)
    if u_np is not None:
        lines = [
            "$NodeData", "1", '"displacement"', "1", "0.0", "3", "0", "3",
            str(u_np.shape[0]),
        ]
        lines += [
            f"{i + 1} " + " ".join(f"{x:.17g}" for x in row)
            for i, row in enumerate(u_np)
        ]
        lines.append("$EndNodeData")
        with path.open("a") as fh:
            fh.write("\n".join(lines) + "\n")


def export_npz(path, u, load_step: int, history=None, **extra) -> None:
    """Per-load-step displacement dump / checkpoint. Restartable:
    `load_checkpoint` + `NewtonSolver.solve(u0=..., start_factor=...)`
    continues bit-identically (every sum in a fixed order)."""
    np.savez(
        path,
        u=_host(u),
        load_step=np.asarray(load_step),
        **({"residual_history": np.asarray(history, float)} if history is not None else {}),
        **extra,
    )


def load_checkpoint(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
