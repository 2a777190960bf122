"""PyTorch port: the host-side input, loads and output of the task-file
entry point, and its post-processing, against the JAX reference.

  * `io.sexp` tokenize, parse, `to_dict` and the task dict: equal to the
    reference's;
  * `load_task` on every file of tasks/: the same mesh, node sets, BC mask
    and values, forces within 1e-14 of the largest entry (host numpy in
    both packages), and the same options (`device_loop` and
    `device_loop_budget` included), output and partition;
  * surface traction and pressure forces (1e-14), the RCM permutation of a
    shuffled mesh (equal), the Gmsh and TetGen readers and writers (equal
    arrays, the same bytes), the VTK and Gmsh exports (the same bytes),
    `nodal_stress` and von Mises (1e-12), `PhaseTimer` and `trace_region`.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu import postprocess as ref_post
from fea_large_tpu.io import export as ref_export
from fea_large_tpu.io import meshio as ref_meshio
from fea_large_tpu.io import sexp as ref_sexp
from fea_large_tpu.io.task import load_task as ref_load_task
from fea_large_tpu.materials import neo_hookean as ref_nh
from fea_large_tpu.mesh import reorder as ref_reorder
from fea_large_tpu.mesh import surface as ref_surface
from fea_large_tpu.mesh.core import Mesh as RefMesh
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh

from fea_large_tpu_torch import postprocess
from fea_large_tpu_torch.io import export, meshio, sexp
from fea_large_tpu_torch.io.task import load_task
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh import reorder, surface
from fea_large_tpu_torch.mesh.core import Mesh
from fea_large_tpu_torch.mesh.generators import box_mesh

torch.set_num_threads(2)

TASKS = pathlib.Path(__file__).resolve().parent.parent / "tasks"
#: host numpy in both packages
HOST_ATOL = 1e-14
#: f64 against f64, summed in another order
F64_BOUND = 1e-12


def _rel_max(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-300)


SEXP_TEXT = """; a comment
(task
  (mesh (box (nx 2) (ny 1) (nz 1) (lx 2.5)))
  (element-type tet4)
  (material (model svk) (lambda 1.5) (mu 0.7))
  (loading (n-steps 2)
    (dirichlet (set xmin) (components xyz) (value 0.0))
    (forces (set xmax) (vector 0.0 0.0 -0.01))
    (forces (set ymax) (vector (x 0.1) (y 0.0) (z 0.0))))
  (solver (linear direct) (newton-rtol 1e-9))
  (output (dir "out/a b") (vtk 0)))
"""


@pytest.mark.parametrize("text", [SEXP_TEXT, (TASKS / "block_compression_tet10.sexp").read_text()],
                         ids=["synthetic", "task_file"])
def test_sexp_matches_reference(text, tmp_path):
    assert sexp.tokenize(text) == ref_sexp.tokenize(text)
    tree = sexp.parse(sexp.tokenize(text))
    assert tree == ref_sexp.parse(ref_sexp.tokenize(text))
    assert sexp.to_dict(tree) == ref_sexp.to_dict(tree)
    path = tmp_path / "t.sexp"
    path.write_text(text)
    assert sexp.load_sexp_task_dict(path) == ref_sexp.load_sexp_task_dict(path)


def _assert_same_mesh(mesh, ref_mesh):
    assert mesh.element_type == ref_mesh.element_type and mesh.n_quad == ref_mesh.n_quad
    np.testing.assert_array_equal(mesh.coords_host, np.asarray(ref_mesh.coords_host))
    np.testing.assert_array_equal(mesh.conn_host, np.asarray(ref_mesh.conn_host))
    assert sorted(mesh.node_sets) == sorted(ref_mesh.node_sets)
    for k, v in ref_mesh.node_sets.items():
        np.testing.assert_array_equal(mesh.node_sets[k], np.asarray(v))
    assert (mesh.structure is None) == (ref_mesh.structure is None)
    if mesh.structure is not None:
        assert dataclasses.asdict(mesh.structure) == dataclasses.asdict(ref_mesh.structure)


@pytest.mark.parametrize("name", sorted(p.name for p in TASKS.iterdir()))
def test_load_task_matches_reference(name):
    ref = ref_load_task(TASKS / name)
    task = load_task(TASKS / name, device="cpu")
    assert task.name == ref.name
    _assert_same_mesh(task.mesh, ref.mesh)
    assert type(task.material).name == type(ref.material).name
    assert (task.material.lam, task.material.mu) == (float(ref.material.lam),
                                                     float(ref.material.mu))
    assert dataclasses.asdict(task.loading) == dataclasses.asdict(ref.loading)
    assert dataclasses.asdict(task.output) == dataclasses.asdict(ref.output)
    assert dataclasses.asdict(task.partition) == dataclasses.asdict(ref.partition)
    # every solver field, device_loop and device_loop_budget included
    assert dataclasses.asdict(task.solver) == dataclasses.asdict(ref.solver)
    bc, ref_bc = task.build_bc(), ref.build_bc()
    np.testing.assert_array_equal(bc.free_mask.numpy(), np.asarray(ref_bc.free_mask))
    np.testing.assert_array_equal(bc.values.numpy(), np.asarray(ref_bc.values))
    f, ref_f = task.build_forces(), ref.build_forces()
    assert (f is None) == (ref_f is None)
    if f is not None:
        ref_f = np.asarray(ref_f)
        assert f.dtype == torch.float64 and f.device.type == "cpu"
        assert np.abs(f.numpy() - ref_f).max() <= HOST_ATOL * np.abs(ref_f).max()


@pytest.mark.parametrize("et", ["tet4", "tet10"])
def test_surface_loads_match_reference(et):
    ref_mesh = ref_box_mesh(3, 2, 2, lx=1.5, lz=0.8, element_type=et)
    mesh = box_mesh(3, 2, 2, lx=1.5, lz=0.8, element_type=et, device="cpu")
    faces = surface.boundary_faces(mesh)
    np.testing.assert_array_equal(faces, ref_surface.boundary_faces(ref_mesh))
    for got, want in zip(surface.face_area_normals(mesh.coords_host, faces),
                         ref_surface.face_area_normals(np.asarray(ref_mesh.coords_host), faces)):
        np.testing.assert_array_equal(got, want)
    tractions = {"zmax": [0.01, -0.02, -0.1], "xmax": [0.0, 0.0, 0.05]}
    pressures = {"zmax": 0.05, "ymin": -0.02}
    for f, ref_f in ((surface.traction_forces(mesh, tractions),
                      ref_surface.traction_forces(ref_mesh, tractions)),
                     (surface.pressure_forces(mesh, pressures, faces=faces),
                      ref_surface.pressure_forces(ref_mesh, pressures, faces=faces))):
        ref_f = np.asarray(ref_f)
        assert f.dtype == torch.float64 and tuple(f.shape) == ref_f.shape
        assert np.abs(f.numpy() - ref_f).max() <= HOST_ATOL * np.abs(ref_f).max()
    with pytest.raises(KeyError):
        surface.traction_forces(mesh, {"nowhere": [0.0, 0.0, 1.0]})


def test_rcm_matches_reference():
    """A TET10 box with its nodes shuffled: the same permutation and the
    same renumbered mesh as the reference's."""
    base = box_mesh(3, 2, 2, element_type="tet10", device="cpu")
    shuffle = np.random.default_rng(5).permutation(base.n_nodes)
    coords = np.empty_like(base.coords_host)
    coords[shuffle] = base.coords_host
    conn = shuffle[base.conn_host]
    sets = {k: shuffle[v] for k, v in base.node_sets.items()}
    mesh = Mesh.create(coords, conn, "tet10", sets, device="cpu", n_quad=5)
    ref_mesh = dataclasses.replace(RefMesh.create(coords, conn, "tet10", sets), n_quad=5)
    perm = reorder.rcm_permutation(mesh)
    np.testing.assert_array_equal(perm, ref_reorder.rcm_permutation(ref_mesh))
    assert sorted(perm.tolist()) == list(range(mesh.n_nodes))
    _assert_same_mesh(reorder.reorder_rcm(mesh), ref_reorder.reorder_rcm(ref_mesh))


@pytest.mark.parametrize("et", ["tet4", "tet10"])
def test_mesh_files_and_exports_match_reference(et, tmp_path):
    ref_mesh = ref_box_mesh(2, 1, 1, element_type=et)
    mesh = box_mesh(2, 1, 1, element_type=et, device="cpu")
    x = mesh.coords_host
    u = np.stack([0.1 * x[:, 0] * x[:, 2], -0.03 * x[:, 1], 0.2 * np.sin(x[:, 0])], axis=1)
    vm = np.cos(x[:, 0] + x[:, 1])
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    ours.mkdir(), theirs.mkdir()
    meshio.save_mesh_file(ours / "m.msh", mesh)
    ref_meshio.save_mesh_file(theirs / "m.msh", ref_mesh)
    export.export_vtk(ours / "d.vtk", mesh, torch.tensor(u), point_data={"von_mises": vm})
    ref_export.export_vtk(theirs / "d.vtk", ref_mesh, u, point_data={"von_mises": vm})
    export.export_vtk(ours / "r.vtk", mesh)
    ref_export.export_vtk(theirs / "r.vtk", ref_mesh)
    for deformed in (True, False):
        export.export_msh(ours / f"{deformed}.msh", mesh, torch.tensor(u), deformed=deformed)
        ref_export.export_msh(theirs / f"{deformed}.msh", ref_mesh, jnp.asarray(u),
                              deformed=deformed)
    for f in sorted(theirs.iterdir()):
        assert (ours / f.name).read_bytes() == f.read_bytes(), f.name
    # the Gmsh reader, and a TetGen pair (1-based) through both packages
    _assert_same_mesh(meshio.load_gmsh(ours / "True.msh", device="cpu"),
                      ref_meshio.load_gmsh(theirs / "True.msh"))
    npe = mesh.conn_host.shape[1]
    (tmp_path / "t.node").write_text(f"{mesh.n_nodes} 3 0 0\n" + "".join(
        f"{i + 1} {c[0]:.17g} {c[1]:.17g} {c[2]:.17g}\n" for i, c in enumerate(x)))
    (tmp_path / "t.ele").write_text(f"{mesh.n_elements} {npe} 0\n" + "".join(
        f"{e + 1} " + " ".join(str(n + 1) for n in row) + "\n"
        for e, row in enumerate(mesh.conn_host)))
    _assert_same_mesh(meshio.load_mesh_file(tmp_path / "t.node", et, device="cpu"),
                      ref_meshio.load_mesh_file(tmp_path / "t.node", et))
    # the checkpoint
    export.export_npz(ours / "c.npz", torch.tensor(u), 3, [1.0, 1e-3], load_factor=0.5)
    ref_export.export_npz(theirs / "c.npz", u, 3, [1.0, 1e-3], load_factor=0.5)
    a, b = export.load_checkpoint(ours / "c.npz"), ref_export.load_checkpoint(theirs / "c.npz")
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("et", ["tet4", "tet10"])
def test_nodal_stress_matches_reference(et):
    ref_mesh = ref_box_mesh(2, 2, 1, element_type=et)
    mesh = box_mesh(2, 2, 1, element_type=et, device="cpu")
    x = mesh.coords_host
    u = np.stack([0.02 * x[:, 0] * x[:, 1], -0.03 * x[:, 2] ** 2, -0.05 * x[:, 2]], axis=1)
    sig, vm = postprocess.nodal_stress(mesh, NeoHookean(1.0, 0.6), torch.tensor(u))
    ref_sig, ref_vm = ref_post.nodal_stress(
        ref_mesh, ref_nh.NeoHookean(jnp.asarray(1.0), jnp.asarray(0.6)), jnp.asarray(u))
    assert _rel_max(sig.numpy(), ref_sig) <= F64_BOUND
    assert _rel_max(vm.numpy(), ref_vm) <= F64_BOUND


def test_phase_timer_and_trace_region(tmp_path):
    """`PhaseTimer` accumulates per phase (the reference's summary
    schema); `trace_region` writes a Chrome trace of the enclosed work."""
    from fea_large_tpu.utils.profiling import PhaseTimer as RefPhaseTimer

    from fea_large_tpu_torch.utils.profiling import PhaseTimer, trace_region

    timer, ref_timer = PhaseTimer(), RefPhaseTimer()
    x = torch.ones(64, dtype=torch.float64)
    for t, sync in ((timer, (x,)), (ref_timer, ())):
        for _ in range(2):
            with t.phase("assembly", *sync):
                x = x * 2.0
        with t.phase("pcg"):
            pass
    summary, ref_summary = timer.summary(), ref_timer.summary()
    assert sorted(summary) == sorted(ref_summary) == ["assembly", "pcg"]
    assert [v["count"] for v in summary.values()] == [2, 1]
    assert all(v["total_s"] >= 0.0 for v in summary.values())
    with trace_region(tmp_path / "traces") as path:
        (x @ x).item()
    trace = json.loads((path / "trace.json").read_text())
    assert trace["traceEvents"]
