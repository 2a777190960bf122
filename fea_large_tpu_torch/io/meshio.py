"""Mesh file import/export (counterpart of `fea_large_tpu/io/meshio.py`):
Gmsh `.msh` (v2.2 ASCII) and TetGen-style `.node`/`.ele` text pairs. The
importer canonicalizes node ordering to the port's convention (Gmsh TET10
edge order). Host-side numpy, the reference's own; a loaded mesh lies on
`device` (the card unless the caller asks for the CPU, no fallback)."""

from __future__ import annotations

import pathlib

import numpy as np

from fea_large_tpu_torch.mesh.core import Mesh, make_node_sets

_GMSH_TET4 = 4
_GMSH_TET10 = 11


def load_mesh_file(path, element_type: str | None = None, device="cuda") -> Mesh:
    path = pathlib.Path(path)
    if path.suffix == ".msh":
        return load_gmsh(path, element_type, device=device)
    if path.suffix == ".node":
        return load_tetgen(path, element_type or "tet4", device=device)
    raise ValueError(f"unsupported mesh format: {path.suffix}")


def load_gmsh(path, element_type: str | None = None, device="cuda") -> Mesh:
    """Minimal Gmsh v2.2 ASCII reader: $Nodes + $Elements, tet cells only."""
    lines = pathlib.Path(path).read_text().splitlines()
    i = 0
    coords = None
    cells = {_GMSH_TET4: [], _GMSH_TET10: []}
    node_ids = None
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            n = int(lines[i + 1])
            raw = np.array(
                [lines[i + 2 + k].split() for k in range(n)], dtype=float
            )
            node_ids = raw[:, 0].astype(np.int64)
            coords = raw[:, 1:4]
            i += 2 + n
        elif line == "$Elements":
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                etype = int(parts[1])
                ntags = int(parts[2])
                if etype in cells:
                    cells[etype].append([int(x) for x in parts[3 + ntags :]])
            i += 2 + n
        else:
            i += 1
    if coords is None:
        raise ValueError("no $Nodes section")
    # remap 1-based possibly-sparse gmsh ids to dense 0-based
    remap = {int(g): j for j, g in enumerate(node_ids)}
    if cells[_GMSH_TET10]:
        conn = np.array(cells[_GMSH_TET10], np.int64)
        et = "tet10"
        # gmsh TET10 ordering: vertices 0-3 then edges (0,1),(1,2),(2,0),(3,0),(3,2),(3,1)
        # at positions 4..9 = [e01, e12, e20, e30, e32, e31]; our canonical
        # order is (0,1),(1,2),(2,0),(0,3),(1,3),(2,3) -> permute [4,5,6,7,9,8]
        conn = conn[:, [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]]
    elif cells[_GMSH_TET4]:
        conn = np.array(cells[_GMSH_TET4], np.int64)
        et = "tet4"
    else:
        raise ValueError("no tetrahedral cells in mesh")
    if element_type is not None and element_type != et:
        raise ValueError(f"task wants {element_type} but mesh holds {et}")
    conn = np.vectorize(remap.__getitem__)(conn).astype(np.int64)
    return Mesh.create(coords, conn, et, _bbox_node_sets(coords), device=device)


def load_tetgen(node_path, element_type: str = "tet4", device="cuda") -> Mesh:
    """TetGen `.node` + `.ele` pair (1- or 0-based indices auto-detected)."""
    node_path = pathlib.Path(node_path)
    ele_path = node_path.with_suffix(".ele")

    def _rows(p):
        return [
            ln.split()
            for ln in p.read_text().splitlines()
            if ln.strip() and not ln.strip().startswith("#")
        ]

    nrows = _rows(node_path)
    n = int(nrows[0][0])
    raw = np.array([r[:4] for r in nrows[1 : 1 + n]], float)
    first_id = int(raw[0, 0])
    coords = raw[:, 1:4]

    erows = _rows(ele_path)
    ne, npe = int(erows[0][0]), int(erows[0][1])
    conn = np.array([r[1 : 1 + npe] for r in erows[1 : 1 + ne]], np.int64) - first_id
    et = {4: "tet4", 10: "tet10"}[npe]
    if element_type != et:
        raise ValueError(f"task wants {element_type} but mesh holds {et}")
    return Mesh.create(coords, conn, et, _bbox_node_sets(coords), device=device)


def save_mesh_file(path, mesh: Mesh) -> None:
    """Write Gmsh v2.2 ASCII (round-trips through `load_gmsh`) from the
    mesh's host arrays."""
    path = pathlib.Path(path)
    coords = np.asarray(mesh.coords_host, float)
    conn = np.asarray(mesh.conn_host)
    npe = conn.shape[1]
    etype = _GMSH_TET4 if npe == 4 else _GMSH_TET10
    if npe == 10:  # canonical -> gmsh edge order
        conn = conn[:, [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]]
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(coords.shape[0])]
    out += [
        f"{i + 1} " + " ".join(f"{x:.17g}" for x in c) for i, c in enumerate(coords)
    ]
    out += ["$EndNodes", "$Elements", str(conn.shape[0])]
    out += [
        f"{e + 1} {etype} 2 0 0 " + " ".join(str(int(x) + 1) for x in row)
        for e, row in enumerate(conn)
    ]
    out += ["$EndElements"]
    path.write_text("\n".join(out) + "\n")


def _bbox_node_sets(coords: np.ndarray, tol: float = 1e-9) -> dict:
    """Face node sets on the bounding box (the generator's convention)."""
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    scale = max(float((hi - lo).max()), 1.0)
    t = tol * scale + 1e-12
    return make_node_sets(
        coords,
        {
            "xmin": lambda c: c[:, 0] < lo[0] + t,
            "xmax": lambda c: c[:, 0] > hi[0] - t,
            "ymin": lambda c: c[:, 1] < lo[1] + t,
            "ymax": lambda c: c[:, 1] > hi[1] - t,
            "zmin": lambda c: c[:, 2] < lo[2] + t,
            "zmax": lambda c: c[:, 2] > hi[2] - t,
        },
    )
