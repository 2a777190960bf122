"""PyTorch port: the unstructured mixed-precision slice against the JAX
reference on the 5-tet TET10 box n=3 (1,029 DOF): bench.py's problem
(neo-Hookean (1.0, 0.6), zmin fixed, zmax pushed -0.05 in z, 5% affine
compression start, two-level preconditioner with 6 coarse modes, EW
forcing with eta_min 1e-2, newton_rtol = pcg_tol = 1e-6) on the mesh that
`FEA_BENCH_MESH=5tet` selects, with device_loop=False.

The port runs `pallas=True` as bench.py passes it (the option has no
effect in the port: its unstructured passes are the element-block kernels'
plain versions on the CPU), the reference `pallas=False` (the same math,
and no interpret mode in the solve). The reference takes 5 Newton iterations with
PCG [3, 4, 9, 13, 11]. The port must take the same Newton count, start from
the same residual norm (1e-12 relative: both are the f64 pass), and each
PCG count may move by one (the f32 PCG sums in another order). At
newton_rtol 1e-9 both converge to the same u: measured 1.5e-11 max|u| on
CPU, bound 1e-8."""

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

torch.set_num_threads(2)

BENCH = dict(
    linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
    forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
    resid_df=False, device_loop=False,
)


@pytest.fixture(scope="module")
def runs():
    """{newton_rtol: ((u, ok, rec) reference, (u, ok, rec) port)}."""
    ref_mesh = ref_box_mesh(3, 3, 3, element_type="tet10")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    out = {}
    for rtol in (1e-6, 1e-9):
        opts = {**BENCH, "newton_rtol": rtol}
        ref = RefNewtonSolver(ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                              options=RefOptions(**opts))
        u = jnp.zeros((ref_mesh.n_nodes, 3)).at[:, 2].set(-0.05 * ref_mesh.coords[:, 2])
        u_r, ok_r, rec_r = ref._newton(ref.bc.impose(u, jnp.asarray(1.0)), jnp.asarray(1.0))
        port = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                            options=SolverOptions(**opts, pallas=True))
        assert port._coarse.n_agg == ref._coarse.n_agg
        u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
        u[:, 2] = -0.05 * mesh.coords[:, 2]
        u_p, ok_p, rec_p = port._newton(port.bc.impose(u, 1.0), 1.0)
        out[rtol] = (np.asarray(u_r), ok_r, rec_r), (u_p.numpy(), ok_p, rec_p)
    return out


def _pcg_close(port, ref):
    assert len(port) == len(ref) and all(abs(a - b) <= 1 for a, b in zip(port, ref)), (
        f"PCG port {port} vs reference {ref}"
    )


def test_5tet_slice_matches_reference_newton_and_pcg(runs):
    (_, ok_r, rec_r), (_, ok_p, rec_p) = runs[1e-6]
    assert ok_r and ok_p
    assert rec_r.newton_iters == 5 and rec_p.newton_iters == rec_r.newton_iters
    _pcg_close(rec_p.pcg_iters, rec_r.pcg_iters)
    assert abs(rec_p.residual_norms[0] - rec_r.residual_norms[0]) <= 1e-12 * rec_r.residual_norms[0]
    assert rec_p.residual_norms[-1] / rec_p.residual_norms[0] <= 1e-6


def test_5tet_slice_converged_u_matches_reference(runs):
    (u_r, ok_r, rec_r), (u_p, ok_p, rec_p) = runs[1e-9]
    assert ok_r and ok_p
    assert rec_p.newton_iters == rec_r.newton_iters
    _pcg_close(rec_p.pcg_iters, rec_r.pcg_iters)
    assert np.abs(u_p - u_r).max() <= 1e-8 * np.abs(u_r).max()
