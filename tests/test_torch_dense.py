"""PyTorch port: the f64 dense direct path (linear="direct") against the JAX
reference and the NumPy oracle.

  * `element_dofs`, `assemble_dense` (K and f_int at a smooth u) and
    `mask_dense_system` on 2x2x2 TET4 and TET10 boxes: within 1e-12 of the
    reference's largest entry (both f64; the port sums each slot through
    the BCSR slot buckets, the reference scatter-adds);
  * `dense_cholesky_solve` against numpy's solve of a seeded SPD system;
  * the counterparts of tests/test_parity.py with `linear="direct"`:
    config 1 (uniaxial tension, SVK, TET4 3x2x2), config 3 (force-driven
    beam bending, three increments) and the 5-point TET10 rule: the
    reference's increments and Newton counts, u within 1e-10 relative of
    the reference's and within 1e-8 of the oracle's (the parity contract).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.assembly.dense import assemble_dense as ref_assemble_dense
from fea_large_tpu.assembly.dense import element_dofs as ref_element_dofs
from fea_large_tpu.assembly.dense import mask_dense_system as ref_mask_dense_system
from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.bc import nodal_forces as ref_nodal_forces
from fea_large_tpu.elements.kernels import precompute_geometry as ref_precompute_geometry
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure
from fea_large_tpu_torch.assembly.dense import assemble_dense, element_dofs, mask_dense_system
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.bc import DirichletBuilder, nodal_forces
from fea_large_tpu_torch.elements.kernels import precompute_geometry
from fea_large_tpu_torch.materials import NeoHookean, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.linear import dense_cholesky_solve
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

from tests.oracle import oracle

torch.set_num_threads(2)

#: f64 against f64, summed in another order
F64_BOUND = 1e-12


def _rel(u, u_ref):
    return np.linalg.norm(u - u_ref) / max(np.linalg.norm(u_ref), 1e-300)


def _smooth_u(coords):
    x, y, z = np.asarray(coords).T
    return np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x,
                     -0.05 * z + 0.02 * np.cos(y)], axis=1)


@pytest.mark.parametrize("et", ["tet4", "tet10"])
def test_dense_assembly_matches_reference(et):
    ref_mesh = ref_box_mesh(2, 2, 2, element_type=et)
    mesh = box_mesh(2, 2, 2, element_type=et, device="cpu")
    np.testing.assert_array_equal(element_dofs(mesh.conn).numpy(),
                                  np.asarray(ref_element_dofs(ref_mesh.conn)))
    u = _smooth_u(mesh.coords_host)
    ref_geom = ref_precompute_geometry(ref_mesh.coords, ref_mesh.conn, ref_mesh.element)
    K_r, f_r = ref_assemble_dense(jnp.asarray(u), ref_mesh.conn, ref_geom,
                                  RefNH(jnp.asarray(1.0), jnp.asarray(0.6)))
    structure = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu")
    scatter = NodeScatter.build(mesh.conn_host, mesh.n_nodes, "cpu")
    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    K, f = assemble_dense(torch.tensor(u), mesh.conn, geom, NeoHookean(1.0, 0.6), structure,
                          scatter)
    K_r, f_r = np.asarray(K_r), np.asarray(f_r)
    assert K.shape == K_r.shape and f.shape == f_r.shape
    assert np.abs(K.numpy() - K_r).max() <= F64_BOUND * np.abs(K_r).max()
    assert np.abs(f.numpy() - f_r).max() <= F64_BOUND * np.abs(f_r).max()
    # the masked system, fixed zmin
    free = np.ones((mesh.n_nodes, 3))
    free[mesh.node_sets["zmin"]] = 0.0
    r = np.random.default_rng(3).standard_normal((mesh.n_nodes, 3))
    A, b = mask_dense_system(K, torch.tensor(r), torch.tensor(free))
    A_r, b_r = ref_mask_dense_system(jnp.asarray(K_r), jnp.asarray(r), jnp.asarray(free))
    assert np.abs(A.numpy() - np.asarray(A_r)).max() <= F64_BOUND * np.abs(K_r).max()
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_r))
    assert torch.equal(K, assemble_dense(torch.tensor(u), mesh.conn, geom, NeoHookean(1.0, 0.6),
                                         structure, scatter)[0]), "repeat bitwise equal"


def test_dense_cholesky_solve():
    rng = np.random.default_rng(7)
    M = rng.standard_normal((40, 40))
    A = M @ M.T + 40.0 * np.eye(40)
    b = rng.standard_normal(40)
    x = dense_cholesky_solve(torch.tensor(A), torch.tensor(b))
    assert x.shape == (40,) and x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), rtol=0, atol=1e-13)
    # not positive definite: all NaN, as the reference's factor (-> bisection)
    A[5, 5] = -1e3
    assert torch.isnan(dense_cholesky_solve(torch.tensor(A), torch.tensor(b))).all()


def _config1(ref_mesh_or_mesh, builder):
    return (builder(ref_mesh_or_mesh).prescribe("zmin", "z", 0.0).prescribe("zmax", "z", 0.25)
            .fix("xmin", "x").fix("ymin", "y").build())


def _both(ref_mesh, mesh, ref_mat, mat, bc_fn, opts, f_fn=None):
    """Both packages' solves of one problem: (ref result, port result, ref bc, ref f)."""
    ref_bc, bc = bc_fn(ref_mesh, RefDirichletBuilder), bc_fn(mesh, DirichletBuilder)
    ref_f = f = None
    if f_fn is not None:
        ref_f, f = f_fn(ref_mesh, ref_nodal_forces), f_fn(mesh, nodal_forces)
    ref = RefNewtonSolver(ref_mesh, ref_mat, ref_bc, f_ext=ref_f, options=RefOptions(**opts))
    port = NewtonSolver(mesh, mat, bc, f_ext=f, options=SolverOptions(**opts))
    return ref.solve(), port.solve(), ref_bc, ref_f


def _check(ref, port, oracle_u):
    assert ref.converged and port.converged
    assert [r.load_factor for r in port.history] == [float(r.load_factor) for r in ref.history]
    assert [r.newton_iters for r in port.history] == [r.newton_iters for r in ref.history]
    assert [r.pcg_iters for r in port.history] == [r.pcg_iters for r in ref.history]
    assert _rel(port.u.numpy(), np.asarray(ref.u)) <= 1e-10
    assert _rel(port.u.numpy(), oracle_u) < 1e-8


def test_config1_direct_matches_reference_and_oracle():
    ref_mesh = ref_box_mesh(3, 2, 2, element_type="tet4")
    mesh = box_mesh(3, 2, 2, element_type="tet4", device="cpu")
    ref, port, ref_bc, _ = _both(ref_mesh, mesh, RefSVK(jnp.asarray(1.2), jnp.asarray(0.8)),
                                 StVenantKirchhoff(1.2, 0.8), _config1,
                                 dict(linear="direct", n_steps=1, pcg_tol=1e-13))
    u_oracle, _ = oracle.solve(
        np.asarray(ref_mesh.coords), np.asarray(ref_mesh.conn), "tet4", "svk", 1.2, 0.8,
        np.asarray(ref_bc.free_mask) == 0.0, np.asarray(ref_bc.values), n_steps=1,
    )
    _check(ref, port, u_oracle)
    assert all(p == [1] * len(p) for p in (r.pcg_iters for r in port.history))


def test_config3_beam_direct_matches_reference_and_oracle():
    ref_mesh = ref_box_mesh(4, 1, 1, lx=4.0, element_type="tet4")
    mesh = box_mesh(4, 1, 1, lx=4.0, element_type="tet4", device="cpu")
    ref, port, ref_bc, ref_f = _both(
        ref_mesh, mesh, RefSVK(jnp.asarray(20.0), jnp.asarray(10.0)), StVenantKirchhoff(20.0, 10.0),
        lambda m, b: b(m).fix("xmin").build(), dict(linear="direct", n_steps=3),
        f_fn=lambda m, nf: nf(m, {"xmax": [0.0, 0.0, -0.05]}))
    assert len(port.history) == 3
    u_oracle, hist = oracle.solve(
        np.asarray(ref_mesh.coords), np.asarray(ref_mesh.conn), "tet4", "svk", 20.0, 10.0,
        np.asarray(ref_bc.free_mask) == 0.0, np.asarray(ref_bc.values), f_ext=np.asarray(ref_f),
        n_steps=3,
    )
    _check(ref, port, u_oracle)
    assert len(hist) == len(port.history)


def test_tet10_5pt_direct_matches_reference_and_oracle():
    ref_mesh = dataclasses.replace(ref_box_mesh(2, 2, 2, element_type="tet10"), n_quad=5)
    mesh = box_mesh(2, 2, 2, element_type="tet10", device="cpu", n_quad=5)
    ref, port, ref_bc, _ = _both(
        ref_mesh, mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), NeoHookean(1.0, 0.6),
        lambda m, b: b(m).fix("zmin").prescribe("zmax", "z", -0.15).build(),
        dict(linear="direct", n_steps=1))
    u_oracle, _ = oracle.solve(
        np.asarray(ref_mesh.coords), np.asarray(ref_mesh.conn), "tet10", "neo_hookean", 1.0, 0.6,
        np.asarray(ref_bc.free_mask) == 0.0, np.asarray(ref_bc.values), n_steps=1, n_quad=5,
    )
    _check(ref, port, u_oracle)


def test_direct_solve_repeats_bitwise_and_builds_the_bcsr_structure():
    """The direct path sums through the BCSR slot buckets, so it builds the
    structure (the matrix-free path does not, tests/test_torch_matfree.py),
    and two solves give bitwise-equal u."""
    mesh = box_mesh(2, 2, 2, element_type="tet4", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", 0.2).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 1.0), bc,
                          options=SolverOptions(linear="direct", n_steps=2))
    assert solver.bcsr is not None and solver.bcsr.n_nodes == mesh.n_nodes
    a, b = solver.solve(), solver.solve()
    assert a.converged and torch.equal(a.u, b.u)
