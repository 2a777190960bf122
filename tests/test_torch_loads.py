"""PyTorch port: the external loads of `fea_large_tpu_torch/bc.py`
(`nodal_forces`, `body_forces`) against the JAX reference.

Both are host-side numpy in both packages (the same einsum, determinant
and `np.add.at`), so the arrays must agree to 1e-14 of their largest entry.
A force-driven f64 solve (`f_ext` from `nodal_forces`, the load of config 3
of tests/test_parity.py, on the assembled path) must take the reference's
increments and Newton counts and reach its u within 1e-10 relative (both
f64, summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.bc import body_forces as ref_body_forces
from fea_large_tpu.bc import nodal_forces as ref_nodal_forces
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.core import Mesh as RefMesh
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch.bc import DirichletBuilder, body_forces, nodal_forces
from fea_large_tpu_torch.materials import StVenantKirchhoff
from fea_large_tpu_torch.mesh.core import Mesh
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

#: host-side numpy in both packages
HOST_ATOL = 1e-14

#: (reference generator, port generator, element type, cells, box lengths, n_quad)
BOXES = [
    pytest.param(ref_box_mesh, box_mesh, "tet4", (3, 2, 2), (1.5, 1.0, 0.8), None, id="tet4"),
    pytest.param(ref_box_mesh, box_mesh, "tet10", (2, 2, 1), (1.0, 1.2, 0.5), None, id="tet10"),
    pytest.param(ref_box_mesh, box_mesh, "tet10", (2, 1, 2), (1.0, 1.0, 1.0), 5, id="tet10-5pt"),
    pytest.param(ref_box_mesh_kuhn, box_mesh_kuhn, "tet10", (2, 2, 2), (1.0, 1.0, 2.0), None,
                 id="kuhn-tet10"),
]


def _pair(ref_gen, gen, et, cells, lengths, n_quad):
    lx, ly, lz = lengths
    ref = ref_gen(*cells, lx=lx, ly=ly, lz=lz, element_type=et)
    if n_quad is not None:
        ref = dataclasses.replace(ref, n_quad=n_quad)
    port = gen(*cells, lx=lx, ly=ly, lz=lz, element_type=et, device="cpu", n_quad=n_quad)
    return ref, port


def _assert_same(port: torch.Tensor, ref, n_nodes):
    ref = np.asarray(ref)
    assert port.dtype == torch.float64 and tuple(port.shape) == (n_nodes, 3)
    assert np.abs(port.numpy() - ref).max() <= HOST_ATOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("ref_gen,gen,et,cells,lengths,n_quad", BOXES)
def test_nodal_forces_match_reference(ref_gen, gen, et, cells, lengths, n_quad):
    ref_mesh, mesh = _pair(ref_gen, gen, et, cells, lengths, n_quad)
    # xmax and zmax share an edge: its nodes take both vectors
    specs = {"xmax": [0.0, 0.0, -0.05], "zmax": [0.01, -0.02, 0.03]}
    _assert_same(nodal_forces(mesh, specs), ref_nodal_forces(ref_mesh, specs), mesh.n_nodes)


@pytest.mark.parametrize("ref_gen,gen,et,cells,lengths,n_quad", BOXES)
def test_body_forces_match_reference(ref_gen, gen, et, cells, lengths, n_quad):
    ref_mesh, mesh = _pair(ref_gen, gen, et, cells, lengths, n_quad)
    b = [0.3, -0.2, -9.81]
    f = body_forces(mesh, b)
    _assert_same(f, ref_body_forces(ref_mesh, b), mesh.n_nodes)
    # a dead load integrates to volume x b, whatever the rule
    volume = float(np.prod(lengths))
    np.testing.assert_allclose(f.sum(0).numpy(), volume * np.asarray(b), rtol=1e-12)


def test_body_forces_use_the_mesh_quadrature_rule():
    """On a TET10 box with displaced mid-side nodes (curved edges: det J
    varies within an element) the 4-point and the 5-point rule give
    different nodal forces; each equals the reference's with the same rule."""
    ref4 = ref_box_mesh(2, 1, 2, element_type="tet10")
    coords = np.array(ref4.coords_host)
    n_corner = 3 * 2 * 3
    rng = np.random.default_rng(7)
    coords[n_corner:] += 0.03 * rng.standard_normal(coords[n_corner:].shape)
    forces = {}
    for n_quad in (None, 5):
        ref = dataclasses.replace(
            RefMesh.create(coords, ref4.conn_host, "tet10", ref4.node_sets), n_quad=n_quad)
        mesh = Mesh.create(coords, ref4.conn_host, "tet10", ref4.node_sets, device="cpu",
                           n_quad=n_quad)
        forces[n_quad] = body_forces(mesh, [0.0, 0.0, -1.0])
        _assert_same(forces[n_quad], ref_body_forces(ref, [0.0, 0.0, -1.0]), mesh.n_nodes)
    assert float((forces[None] - forces[5]).abs().max()) > 1e-6


def test_loads_lie_on_the_device_of_the_mesh():
    """The loads take no device: they follow the mesh, which lives on the
    card unless the caller asked for the CPU."""
    mesh = box_mesh(1, 1, 1, element_type="tet4", device="cpu")
    assert nodal_forces(mesh, {"zmax": [0.0, 0.0, 1.0]}).device == mesh.device
    assert body_forces(mesh, [0.0, 0.0, 1.0]).device == mesh.device


def test_force_driven_solve_matches_reference():
    """The beam of config 3 (TET4 box 4x1x1, lx=4, SVK (20, 10), xmin fixed,
    a dead nodal force on xmax) on the f64 assembled path, three load
    increments: the reference's load factors and Newton counts, u within
    1e-10 relative."""
    opts = dict(linear="pcg_bcsr", n_steps=3, pcg_tol=1e-13)
    load = {"xmax": [0.0, 0.0, -0.05]}
    ref_mesh = ref_box_mesh(4, 1, 1, lx=4.0, element_type="tet4")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("xmin").build()
    ref = RefNewtonSolver(ref_mesh, RefSVK(jnp.asarray(20.0), jnp.asarray(10.0)), ref_bc,
                          f_ext=ref_nodal_forces(ref_mesh, load), options=RefOptions(**opts)).solve()
    mesh = box_mesh(4, 1, 1, lx=4.0, element_type="tet4", device="cpu")
    bc = DirichletBuilder(mesh).fix("xmin").build()
    port = NewtonSolver(mesh, StVenantKirchhoff(20.0, 10.0), bc, f_ext=nodal_forces(mesh, load),
                        options=SolverOptions(**opts)).solve()
    assert ref.converged and port.converged
    assert [r.load_factor for r in port.history] == [float(r.load_factor) for r in ref.history]
    assert [r.newton_iters for r in port.history] == [r.newton_iters for r in ref.history]
    assert port.total_newton_iters == ref.total_newton_iters
    u_r = np.asarray(ref.u)
    assert np.abs(u_r).max() > 1e-3  # the load bends the beam
    assert np.linalg.norm(port.u.numpy() - u_r) <= 1e-10 * np.linalg.norm(u_r)
