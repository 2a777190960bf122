"""Task configuration: the problem-description input (counterpart of
`fea_large_tpu/io/task.py`, the same schema and the same files).

A task file describes a problem (mesh, element type, material and
constants, boundary conditions, loads, load steps, solver tolerances) as
JSON, TOML or S-expressions; it loads into typed dataclasses, keeping
config an explicit argument through the stack: no global flags.

The port differs from the reference in one place: `load_task(path,
device=...)` builds the mesh, BCs and loads on `device`, the card unless
the caller asks for the CPU (no fallback).

Schema (JSON):
{
  "mesh": {"file": "beam.msh",                      # or {"box": {...}}
           "reorder": "rcm"},                       # optional: RCM renumber
                                  # box spec: {"nx": 8, "ny": 8, "nz": 8,
                                  #  "lx": 1.0, ..., "decomposition":
                                  #  "5tet" (default) | "kuhn"} — "kuhn"
                                  #  enables the structured fast path
  "element_type": "tet4" | "tet10",
  "quadrature": null | 1 | 4 | 5,                    # points per element
  "material": {"model": "svk"|"neo_hookean"|"mooney_rivlin"|...,  # registry
               "lambda": ..., "mu": ...               # or "E": ..., "nu": ...},
  "loading": {
     "n_steps": 3,
     "dirichlet": [{"set": "zmin", "components": "xyz", "value": 0.0}, ...],
     "forces":    [{"set": "xmax", "vector": [0, 0, -1.0]}, ...],
     "tractions": [{"set": "zmax", "vector": [0, 0, -0.1]}, ...],
                                  # dead surface traction, force / unit
                                  # reference area over the boundary faces
                                  # of the set (mesh/surface.py)
     "pressures": [{"set": "zmax", "value": 0.1}, ...],
                                  # dead normal pressure (positive = pushes
                                  # against the reference surface)
     "body_force": [0, 0, -9.81]  # dead body force per unit REFERENCE
                                  # volume (e.g. rho0*g), consistently
                                  # integrated (bc.body_forces)
  },
  "solver": {"linear": "direct"|"pcg"|"pcg_bcsr",
             "newton_rtol": 1e-10, "newton_atol": 1e-12, "max_newton": 30,
             "pcg_tol": 1e-12, "pcg_maxiter": 5000, "max_bisections": 5,
             "precision": "f64"|"mixed", "preconditioner": ...,
             "forcing": "fixed"|"ew", "ew_eta_min": 0.0,  # EW lower cap
             "pallas": false},                       # accepted, no effect here
                                                     # (mixed precision only)
  "partition": {"n_shards": 1},
  "output": {"dir": "out", "vtk": true, "npz": true}
}
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

from fea_large_tpu_torch.bc import (
    DirichletBC,
    DirichletBuilder,
    body_forces,
    nodal_forces,
)
from fea_large_tpu_torch.materials.base import Material, make_material
from fea_large_tpu_torch.mesh.core import Mesh
from fea_large_tpu_torch.mesh.surface import (
    boundary_faces,
    pressure_forces,
    traction_forces,
)
from fea_large_tpu_torch.solvers.newton import SolverOptions


@dataclasses.dataclass(frozen=True)
class DirichletSpec:
    set: str
    components: str = "xyz"
    value: float = 0.0


@dataclasses.dataclass(frozen=True)
class ForceSpec:
    set: str
    vector: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class PressureSpec:
    set: str
    value: float = 0.0


@dataclasses.dataclass(frozen=True)
class LoadingSpec:
    n_steps: int = 1
    dirichlet: tuple = ()
    forces: tuple = ()
    tractions: tuple = ()
    pressures: tuple = ()
    body_force: tuple | None = None


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    dir: str = "out"
    vtk: bool = True
    npz: bool = True
    msh: bool = False  # deformed-mesh Gmsh export (the reference's format)


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Domain decomposition request: n_shards shards along a 1-D ring,
    partitioned by `method` ("slab" or "rcb"): one process per shard
    (dist/, the CLI's sharded route)."""

    n_shards: int = 1
    method: str = "slab"


@dataclasses.dataclass(frozen=True)
class Task:
    """A fully-specified problem; the in-memory form of a task file."""

    mesh: Mesh
    material: Material
    loading: LoadingSpec
    solver: SolverOptions
    output: OutputSpec
    partition: PartitionSpec
    name: str = "task"

    def build_bc(self) -> DirichletBC:
        b = DirichletBuilder(self.mesh)
        for d in self.loading.dirichlet:
            b.prescribe(d.set, d.components, d.value)
        return b.build()

    def build_forces(self):
        """Total external force f64 [N, 3] on the mesh's device (nodal, body,
        traction and pressure loads summed in that order), or None."""
        ld = self.loading
        if not (
            ld.forces or ld.tractions or ld.pressures or ld.body_force
        ):
            return None
        f = None
        if ld.forces:
            f = nodal_forces(
                self.mesh, {s.set: list(s.vector) for s in ld.forces}
            )
        if ld.body_force:
            fb = body_forces(self.mesh, list(ld.body_force))
            f = fb if f is None else f + fb
        if ld.tractions or ld.pressures:
            faces = boundary_faces(self.mesh)
            if ld.tractions:
                ft = traction_forces(
                    self.mesh,
                    {s.set: list(s.vector) for s in ld.tractions},
                    faces=faces,
                )
                f = ft if f is None else f + ft
            if ld.pressures:
                fp = pressure_forces(
                    self.mesh,
                    {s.set: s.value for s in ld.pressures},
                    faces=faces,
                )
                f = fp if f is None else f + fp
        return f


def _build_mesh(spec: dict, element_type: str, base: pathlib.Path, device) -> Mesh:
    if "box" in spec:
        from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn

        kw = dict(spec["box"])
        # "decomposition": "kuhn" selects the uniform 6-tet cell split whose
        # affine connectivity enables the structured (indexed-op-free) SoA
        # fast path — mesh/structure.py; default is the 5-tet split.
        decomp = kw.pop("decomposition", "5tet")
        if decomp == "kuhn":
            mesh = box_mesh_kuhn(element_type=element_type, device=device, **kw)
        elif decomp == "5tet":
            mesh = box_mesh(element_type=element_type, device=device, **kw)
        else:
            raise ValueError(
                f"unknown box decomposition {decomp!r} ('5tet' or 'kuhn')"
            )
    elif "file" in spec:
        from fea_large_tpu_torch.io.meshio import load_mesh_file

        mesh = load_mesh_file(base / spec["file"], element_type=element_type, device=device)
    else:
        raise ValueError("mesh spec needs 'box' or 'file'")
    reorder = spec.get("reorder")
    if reorder:
        if reorder != "rcm":
            raise ValueError(f"unknown mesh reorder {reorder!r} (only 'rcm')")
        from fea_large_tpu_torch.mesh.reorder import reorder_rcm

        mesh = reorder_rcm(mesh)
    return mesh


def _partition(data: dict) -> PartitionSpec:
    part = data.get("partition", {})
    return PartitionSpec(n_shards=int(part.get("n_shards", 1)),
                         method=str(part.get("method", "slab")))


def _parse(data: dict, base: pathlib.Path, name: str, device) -> Task:
    element_type = data.get("element_type", "tet4")
    mesh = _build_mesh(data["mesh"], element_type, base, device)
    nq = data.get("quadrature")
    if nq is not None:
        # bind the requested quadrature rule into the mesh (A2 sweep support)
        mesh = dataclasses.replace(mesh, n_quad=int(nq))
    m = dict(data["material"])
    model = m.pop("model")
    if "lambda" in m:
        m["lam"] = m.pop("lambda")
    material = make_material(model, **m)

    ld = data.get("loading", {})
    loading = LoadingSpec(
        n_steps=int(ld.get("n_steps", 1)),
        dirichlet=tuple(DirichletSpec(**d) for d in ld.get("dirichlet", ())),
        forces=tuple(
            ForceSpec(set=f["set"], vector=tuple(f["vector"]))
            for f in ld.get("forces", ())
        ),
        tractions=tuple(
            ForceSpec(set=f["set"], vector=tuple(f["vector"]))
            for f in ld.get("tractions", ())
        ),
        pressures=tuple(
            PressureSpec(set=p["set"], value=float(p["value"]))
            for p in ld.get("pressures", ())
        ),
        body_force=(
            tuple(float(c) for c in ld["body_force"])
            if ld.get("body_force")
            else None
        ),
    )
    sv = data.get("solver", {})
    solver = SolverOptions(
        linear=sv.get("linear", "pcg"),
        n_steps=loading.n_steps,
        newton_rtol=float(sv.get("newton_rtol", 1e-10)),
        newton_atol=float(sv.get("newton_atol", 1e-12)),
        max_newton=int(sv.get("max_newton", 30)),
        pcg_tol=float(sv.get("pcg_tol", 1e-12)),
        pcg_maxiter=int(sv.get("pcg_maxiter", 5000)),
        pcg_chunk=int(sv.get("pcg_chunk", 250)),
        max_bisections=int(sv.get("max_bisections", 5)),
        precision=sv.get("precision", "f64"),
        preconditioner=sv.get("preconditioner", "jacobi"),
        agg_size=sv.get("agg_size"),
        coarse_modes=int(sv.get("coarse_modes", 3)),
        forcing=sv.get("forcing", "fixed"),
        ew_eta_min=float(sv.get("ew_eta_min", 0.0)),
        pallas=bool(sv.get("pallas", False)),
        device_loop=bool(sv.get("device_loop", True)),
        device_loop_budget=sv.get("device_loop_budget"),
    )
    out = data.get("output", {})
    output = OutputSpec(
        dir=out.get("dir", "out"),
        vtk=bool(out.get("vtk", True)),
        npz=bool(out.get("npz", True)),
        msh=bool(out.get("msh", False)),
    )
    partition = _partition(data)
    return Task(
        mesh=mesh,
        material=material,
        loading=loading,
        solver=solver,
        output=output,
        partition=partition,
        name=name,
    )


def _read(path: pathlib.Path) -> dict:
    if path.suffix == ".toml":
        import tomllib

        return tomllib.loads(path.read_text())
    if path.suffix in (".sexp", ".task", ".lisp"):
        from fea_large_tpu_torch.io.sexp import load_sexp_task_dict

        return load_sexp_task_dict(path)
    return json.loads(path.read_text())


def load_task(path, device="cuda") -> Task:
    """Load a task from a .json, .toml, or .sexp/.task file (S-expressions:
    io.sexp), with its mesh on `device` (the card by default; raises
    where CUDA is absent, with no fallback to the CPU)."""
    path = pathlib.Path(path)
    return _parse(_read(path), path.parent, name=path.stem, device=device)


def task_partition(path) -> PartitionSpec:
    """A task file's partition request, read without building its mesh."""
    return _partition(_read(pathlib.Path(path)))
