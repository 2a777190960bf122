"""PyTorch port: the f64 assembled slice (linear="pcg_bcsr", precision="f64",
config 2 of BASELINE.json) against the JAX reference and the NumPy oracle.

  * config 2 as tests/test_parity.py runs it: neo-Hookean (1.0, 0.6) on the
    TET10 5-tet box 2x2x2, zmin fixed, zmax pushed -0.2 in z, two load
    increments, fixed forcing, pcg_tol 1e-13. The port must take the same
    increments, Newton counts and PCG counts as the reference, reach its u
    within 1e-10 relative (both f64, summed in another order), and the
    oracle's within 1e-8 (the parity contract of BASELINE.json);
  * bench.py's problem with the f64 settings that chip_smoke.py runs at
    full width (EW forcing, eta_min 1e-2, newton_rtol 1e-6, pcg_tol 1e-8,
    one Newton solve at full load from the 5% affine start) on the box
    n=3: the same Newton count, residual norms within 1e-12 of the first
    (the rounding level of the f64 residual), and PCG counts within one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

from tests.oracle import oracle

torch.set_num_threads(2)

CONFIG2 = dict(linear="pcg_bcsr", n_steps=2, pcg_tol=1e-13)
BENCH_F64 = dict(linear="pcg_bcsr", precision="f64", forcing="ew", ew_eta_min=1e-2,
                 newton_rtol=1e-6, pcg_tol=1e-8, pcg_maxiter=2000)


def _rel(u, u_ref):
    return np.linalg.norm(u - u_ref) / max(np.linalg.norm(u_ref), 1e-300)


@pytest.fixture(scope="module")
def config2():
    """(reference SolveResult, port SolveResult, reference mesh, reference bc)."""
    ref_mesh = ref_box_mesh(2, 2, 2, element_type="tet10")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.2).build()
    ref = RefNewtonSolver(ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                          options=RefOptions(**CONFIG2)).solve()
    mesh = box_mesh(2, 2, 2, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.2).build()
    port = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**CONFIG2)).solve()
    return ref, port, ref_mesh, ref_bc


def test_config2_matches_reference_counts(config2):
    ref, port, _, _ = config2
    assert ref.converged and port.converged
    assert [r.load_factor for r in port.history] == [float(r.load_factor) for r in ref.history]
    assert [r.newton_iters for r in port.history] == [r.newton_iters for r in ref.history]
    assert [r.pcg_iters for r in port.history] == [r.pcg_iters for r in ref.history]
    for rp, rr in zip(port.history, ref.history):
        np.testing.assert_allclose(rp.residual_norms[0], rr.residual_norms[0], rtol=1e-12)


def test_config2_matches_reference_u(config2):
    ref, port, _, _ = config2
    assert _rel(port.u.numpy(), np.asarray(ref.u)) <= 1e-10


def test_config2_matches_oracle(config2):
    _, port, ref_mesh, ref_bc = config2
    u_oracle, _ = oracle.solve(
        np.asarray(ref_mesh.coords), np.asarray(ref_mesh.conn), "tet10", "neo_hookean",
        1.0, 0.6, np.asarray(ref_bc.free_mask) == 0.0, np.asarray(ref_bc.values), n_steps=2,
    )
    assert _rel(port.u.numpy(), u_oracle) < 1e-8


def test_bench_f64_settings_match_reference_newton_count():
    ref_mesh = ref_box_mesh(3, 3, 3, element_type="tet10")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    ref = RefNewtonSolver(ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                          options=RefOptions(**BENCH_F64))
    u = jnp.zeros((ref_mesh.n_nodes, 3)).at[:, 2].set(-0.05 * ref_mesh.coords[:, 2])
    _, ok_r, rec_r = ref._newton(ref.bc.impose(u, jnp.asarray(1.0)), jnp.asarray(1.0))
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    port = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**BENCH_F64))
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    _, ok_p, rec_p = port._newton(port.bc.impose(u, 1.0), 1.0)
    assert ok_r and ok_p
    assert rec_p.newton_iters == rec_r.newton_iters
    # rounding of the f64 residual is relative to its first value
    np.testing.assert_allclose(rec_p.residual_norms, rec_r.residual_norms, rtol=0,
                               atol=1e-12 * rec_r.residual_norms[0])
    assert len(rec_p.pcg_iters) == len(rec_r.pcg_iters)
    assert all(abs(a - b) <= 1 for a, b in zip(rec_p.pcg_iters, rec_r.pcg_iters)), (
        f"PCG port {rec_p.pcg_iters} vs reference {rec_r.pcg_iters}")
    assert rec_p.residual_norms[-1] / rec_p.residual_norms[0] <= 1e-6


def test_f64_path_builds_no_mixed_state():
    """The f64 path skips the SoA problems and the coarse space, and builds
    its geometry and node scatter at first use."""
    mesh = box_mesh(1, 1, 1, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                          options=SolverOptions(**{**BENCH_F64, "preconditioner": "two_level"}))
    assert solver.bcsr is not None and solver._coarse is None and not solver._resid_df
    assert not hasattr(solver, "_soa") and solver._geom is None and solver._scatter is None
    assert solver.geom.gradN.shape == (mesh.n_elements, 4, 10, 3)
