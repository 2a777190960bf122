"""PyTorch port: the f64 matrix-free path (linear="pcg", precision="f64")
against the JAX reference and the NumPy oracle.

  * `TangentState.freeze` (F, S and the element force), `apply_tangent`
    and `element_diag_blocks` on 2x2x2 TET4 and TET10 boxes for SVK and
    both neo-Hookean forms, at a smooth u and a seeded v: within 1e-12 of
    the reference's largest entry (both f64). The port's tangent action
    runs on the factored tangent (`stress_and_factors`), the reference's on
    `tangent_apply`; `make_operator` bundles the same pieces;
  * config 1 of tests/test_parity.py with `linear="pcg"`: the reference's
    Newton and PCG counts, u within 1e-10 relative of the reference's and
    within 1e-8 of the oracle's;
  * bench.py's FEA_BENCH_PRECISION=f64 settings (Jacobi, EW forcing with
    eta_min 1e-2, newton_rtol 1e-6, pcg_tol 1e-8, one Newton solve at full
    load from the 5% affine start) on a Kuhn TET10 box n=3: the
    reference's Newton count and PCG list;
  * the f64 routes the port runs: the matrix-free one builds no BCSR
    structure, and options the port rejected before (f64 with the
    matrix-free or the dense solve) now build a solver.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.assembly.matfree import TangentState as RefTangentState
from fea_large_tpu.assembly.matfree import apply_tangent as ref_apply_tangent
from fea_large_tpu.assembly.matfree import make_operator as ref_make_operator
from fea_large_tpu.assembly.scatter import NodeScatter as RefNodeScatter
from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.elements.kernels import element_diag_blocks as ref_element_diag_blocks
from fea_large_tpu.elements.kernels import precompute_geometry as ref_precompute_geometry
from fea_large_tpu.materials import neo_hookean as ref_nh
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch.assembly.matfree import TangentState, apply_tangent, make_operator
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.elements.kernels import element_diag_blocks, precompute_geometry
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

from tests.oracle import oracle

torch.set_num_threads(2)

#: f64 against f64, summed in another order
F64_BOUND = 1e-12

MATERIALS = [
    pytest.param(RefSVK, StVenantKirchhoff, id="svk"),
    pytest.param(ref_nh.NeoHookean, NeoHookean, id="nh"),
    pytest.param(ref_nh.NeoHookeanVolumetric, NeoHookeanVolumetric, id="nh_vol"),
]
BENCH_F64 = dict(linear="pcg", precision="f64", forcing="ew", ew_eta_min=1e-2,
                 newton_rtol=1e-6, pcg_tol=1e-8, pcg_maxiter=2000)


def _close(port: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    assert np.abs(port.numpy() - ref).max() <= F64_BOUND * np.abs(ref).max()


def _fields(coords):
    """A smooth u (an SPD tangent) and a seeded random v, [N, 3] each."""
    x, y, z = np.asarray(coords).T
    u = np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x,
                  -0.05 * z + 0.02 * np.cos(y)], axis=1)
    return u, np.random.default_rng(11).standard_normal(u.shape)


@pytest.mark.parametrize("et", ["tet4", "tet10"])
@pytest.mark.parametrize("ref_cls,cls", MATERIALS)
def test_matfree_pieces_match_reference(ref_cls, cls, et):
    ref_mesh = ref_box_mesh(2, 2, 2, element_type=et)
    mesh = box_mesh(2, 2, 2, element_type=et, device="cpu")
    u, v = _fields(mesh.coords_host)
    ref_mat, mat = ref_cls(jnp.asarray(1.0), jnp.asarray(0.6)), cls(1.0, 0.6)
    ref_geom = ref_precompute_geometry(ref_mesh.coords, ref_mesh.conn, ref_mesh.element)
    ref_scatter = RefNodeScatter.build(ref_mesh.conn_host, ref_mesh.n_nodes)
    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    scatter = NodeScatter.build(mesh.conn_host, mesh.n_nodes, "cpu")
    ut, vt = torch.tensor(u), torch.tensor(v)

    ref_state, ref_fe = RefTangentState.freeze(jnp.asarray(u), ref_mesh.conn, ref_geom, ref_mat)
    state, fe = TangentState.freeze(ut, mesh.conn, geom, mat)
    _close(state.F, ref_state.F)
    _close(state.S, ref_state.S)
    _close(fe, ref_fe)

    ref_kv = ref_apply_tangent(ref_state, jnp.asarray(v), ref_mesh.conn, ref_geom, ref_mat,
                               ref_scatter)
    _close(apply_tangent(state, vt, mesh.conn, geom, mat, scatter), ref_kv)
    ref_diag = ref_element_diag_blocks(jnp.asarray(u)[ref_mesh.conn], ref_geom, ref_mat)
    _close(element_diag_blocks(ut[mesh.conn], geom, mat), ref_diag)

    ref_op = ref_make_operator(jnp.asarray(u), ref_mesh.conn, ref_geom, ref_mat, ref_scatter)
    op = make_operator(ut, mesh.conn, geom, mat, scatter)
    _close(op.f_int, ref_op.f_int)
    _close(op.diag_blocks, ref_op.diag_blocks)
    _close(op.matvec(vt), ref_op.matvec(jnp.asarray(v)))


def test_config1_matfree_matches_reference_and_oracle():
    def bc_of(m, builder):
        return (builder(m).prescribe("zmin", "z", 0.0).prescribe("zmax", "z", 0.25)
                .fix("xmin", "x").fix("ymin", "y").build())

    opts = dict(linear="pcg", n_steps=1, pcg_tol=1e-13)
    ref_mesh = ref_box_mesh(3, 2, 2, element_type="tet4")
    ref_bc = bc_of(ref_mesh, RefDirichletBuilder)
    ref = RefNewtonSolver(ref_mesh, RefSVK(jnp.asarray(1.2), jnp.asarray(0.8)), ref_bc,
                          options=RefOptions(**opts)).solve()
    mesh = box_mesh(3, 2, 2, element_type="tet4", device="cpu")
    port = NewtonSolver(mesh, StVenantKirchhoff(1.2, 0.8), bc_of(mesh, DirichletBuilder),
                        options=SolverOptions(**opts)).solve()
    assert ref.converged and port.converged
    assert [r.newton_iters for r in port.history] == [r.newton_iters for r in ref.history]
    assert [r.pcg_iters for r in port.history] == [r.pcg_iters for r in ref.history]
    u, u_ref = port.u.numpy(), np.asarray(ref.u)
    assert np.linalg.norm(u - u_ref) <= 1e-10 * np.linalg.norm(u_ref)
    u_oracle, _ = oracle.solve(
        np.asarray(ref_mesh.coords), np.asarray(ref_mesh.conn), "tet4", "svk", 1.2, 0.8,
        np.asarray(ref_bc.free_mask) == 0.0, np.asarray(ref_bc.values), n_steps=1,
    )
    assert np.linalg.norm(u - u_oracle) < 1e-8 * np.linalg.norm(u_oracle)


def test_bench_f64_mode_kuhn_matches_reference_counts():
    """bench.py's own f64 mode (the matrix-free path) on a Kuhn TET10 n=3."""
    ref_mesh = ref_box_mesh_kuhn(3, 3, 3, element_type="tet10")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    ref = RefNewtonSolver(ref_mesh, ref_nh.NeoHookean(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                          options=RefOptions(**BENCH_F64))
    u = jnp.zeros((ref_mesh.n_nodes, 3)).at[:, 2].set(-0.05 * ref_mesh.coords[:, 2])
    _, ok_r, rec_r = ref._newton(ref.bc.impose(u, jnp.asarray(1.0)), jnp.asarray(1.0))
    mesh = box_mesh_kuhn(3, 3, 3, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    port = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**BENCH_F64))
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    _, ok_p, rec_p = port._newton(port.bc.impose(u, 1.0), 1.0)
    assert ok_r and ok_p
    assert rec_p.newton_iters == rec_r.newton_iters
    assert rec_p.pcg_iters == rec_r.pcg_iters, f"port {rec_p.pcg_iters} ref {rec_r.pcg_iters}"
    np.testing.assert_allclose(rec_p.residual_norms, rec_r.residual_norms, rtol=0,
                               atol=1e-12 * rec_r.residual_norms[0])
    assert rec_p.residual_norms[-1] / rec_p.residual_norms[0] <= 1e-6


@pytest.mark.parametrize("linear", ["pcg", "direct"])
def test_f64_routes_build(linear):
    """f64 with the matrix-free PCG or the dense solve builds a solver
    (both were NotImplementedError before they were ported), whatever the
    mixed-path fields say; only the dense route builds the BCSR structure
    it sums through, the matrix-free route none."""
    mesh = box_mesh(1, 1, 1, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(
        linear=linear, precision="f64", preconditioner="two_level", coarse_modes=6,
        device_loop=False, resid_df=None))
    assert (solver.bcsr is not None) == (linear == "direct")
    assert solver._coarse is None and not hasattr(solver, "_soa")
