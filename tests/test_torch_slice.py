"""PyTorch port: the whole mixed-precision Newton slice against the JAX
reference, on a Kuhn TET10 n=4 lattice (2,187 DOF), with bench.py's
settings (neo-Hookean (1.0, 0.6), zmin fixed, zmax pushed -0.05 in z, 5%
affine compression start, two-level preconditioner with 6 coarse modes,
EW forcing with eta_min 1e-2, newton_rtol = pcg_tol = 1e-6) under the
slice's switches: resid_df=False (plain f64 residual) and
device_loop=False (the host Newton loop).

The reference takes 5 Newton iterations with PCG [5, 7, 15, 21, 14]. The
port must take the same Newton count, start from the same residual norm
(1e-12 relative: both are the f64 pass), and each PCG count may move by
one (the f32 PCG sums in another order). With `resid_df=True` the port's
f64 residual goes through the fused residual pass (its plain version on
the CPU) and must reproduce the same run."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

BENCH = dict(
    linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
    forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
    resid_df=False, device_loop=False,
)


class _Case:
    def __init__(self, n=4):
        self.ref_mesh = ref_box_mesh_kuhn(n, n, n, element_type="tet10")
        self.mesh = box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu")
        self.ref_bc = RefDirichletBuilder(self.ref_mesh).fix("zmin").prescribe(
            "zmax", "z", -0.05).build()
        self.bc = DirichletBuilder(self.mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()

    def newton(self, **opts):
        """Both packages' `_newton` from the bench start state."""
        ref = RefNewtonSolver(self.ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)),
                              self.ref_bc, options=RefOptions(**opts))
        u = jnp.zeros((self.ref_mesh.n_nodes, 3)).at[:, 2].set(-0.05 * self.ref_mesh.coords[:, 2])
        u_r, ok_r, rec_r = ref._newton(ref.bc.impose(u, jnp.asarray(1.0)), jnp.asarray(1.0))
        port = NewtonSolver(self.mesh, NeoHookean(1.0, 0.6), self.bc, options=SolverOptions(**opts))
        u = torch.zeros((self.mesh.n_nodes, 3), dtype=torch.float64)
        u[:, 2] = -0.05 * self.mesh.coords[:, 2]
        u_p, ok_p, rec_p = port._newton(port.bc.impose(u, 1.0), 1.0)
        return (np.asarray(u_r), ok_r, rec_r), (u_p.numpy(), ok_p, rec_p)

    def solve(self, **opts):
        ref = RefNewtonSolver(self.ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)),
                              self.ref_bc, options=RefOptions(**opts)).solve()
        port = NewtonSolver(self.mesh, NeoHookean(1.0, 0.6), self.bc,
                            options=SolverOptions(**opts)).solve()
        return ref, port


@pytest.fixture(scope="module")
def case():
    return _Case()


@pytest.fixture(scope="module")
def slice_runs(case):
    return {rtol: case.newton(**{**BENCH, "newton_rtol": rtol}) for rtol in (1e-6, 1e-9)}


def _pcg_close(port, ref):
    assert len(port) == len(ref) and all(abs(a - b) <= 1 for a, b in zip(port, ref)), (
        f"PCG port {port} vs reference {ref}"
    )


def test_slice_matches_reference_newton_and_pcg(slice_runs):
    (_, ok_r, rec_r), (_, ok_p, rec_p) = slice_runs[1e-6]
    assert ok_r and ok_p
    assert rec_r.newton_iters == 5 and rec_p.newton_iters == rec_r.newton_iters
    _pcg_close(rec_p.pcg_iters, rec_r.pcg_iters)
    assert abs(rec_p.residual_norms[0] - rec_r.residual_norms[0]) <= 1e-12 * rec_r.residual_norms[0]
    assert rec_p.residual_norms[-1] / rec_p.residual_norms[0] <= 1e-6


def test_slice_converged_u_matches_reference(slice_runs):
    """At newton_rtol=1e-9 both converge to the same fixed point; measured
    max|u_port - u_ref| = 9.8e-11 max|u_ref| on CPU, bound 1e-7."""
    (u_r, ok_r, rec_r), (u_p, ok_p, rec_p) = slice_runs[1e-9]
    assert ok_r and ok_p
    assert rec_p.newton_iters == rec_r.newton_iters
    _pcg_close(rec_p.pcg_iters, rec_r.pcg_iters)
    assert np.abs(u_p - u_r).max() <= 1e-7 * np.abs(u_r).max()


def test_solve_increments_with_jacobi_match_reference(case):
    """Two load increments with plain block-Jacobi (`coarse=None`)."""
    opts = dict(BENCH, preconditioner="jacobi", n_steps=2, newton_rtol=1e-8)
    ref, port = case.solve(**opts)
    assert ref.converged and port.converged
    assert [r.load_factor for r in port.history] == [r.load_factor for r in ref.history]
    assert [r.newton_iters for r in port.history] == [r.newton_iters for r in ref.history]
    for a, b in zip(port.history, ref.history):
        _pcg_close(a.pcg_iters, b.pcg_iters)
    u_r = np.asarray(ref.u)
    assert np.abs(port.u.numpy() - u_r).max() <= 1e-7 * np.abs(u_r).max()


def test_solve_bisection_matches_reference(case):
    """With max_newton=2 the full increment cannot converge: both packages
    bisect through the same sequence of load factors."""
    opts = dict(BENCH, preconditioner="jacobi", newton_rtol=1e-8, max_newton=2,
                max_bisections=2)
    ref, port = case.solve(**opts)
    assert port.converged == ref.converged
    assert [(r.load_factor, r.newton_iters) for r in port.history] == [
        (r.load_factor, r.newton_iters) for r in ref.history
    ]
    assert len(port.history) >= 3


def test_fused_residual_slice_matches_reference(case, slice_runs):
    """resid_df=True routes the in-increment f64 residual through
    ops/residual.py (B5's plain version on CPU tensors): the same Newton
    count as the reference's resid_df=False host loop, PCG within one."""
    (_, _, rec_r), _ = slice_runs[1e-6]
    port = NewtonSolver(case.mesh, NeoHookean(1.0, 0.6), case.bc,
                        options=SolverOptions(**{**BENCH, "resid_df": True}))
    assert port._resid_df
    u = torch.zeros((case.mesh.n_nodes, 3), dtype=torch.float64)
    u[:, 2] = -0.05 * case.mesh.coords[:, 2]
    _, ok, rec = port._newton(port.bc.impose(u, 1.0), 1.0)
    assert ok and rec.newton_iters == rec_r.newton_iters
    _pcg_close(rec.pcg_iters, rec_r.pcg_iters)
    assert abs(rec.residual_norms[0] - rec_r.residual_norms[0]) <= 1e-12 * rec_r.residual_norms[0]
    # resid_df=None turns the kernel on for CUDA tensors only
    auto = NewtonSolver(case.mesh, NeoHookean(1.0, 0.6), case.bc,
                        options=SolverOptions(**{**BENCH, "resid_df": None}))
    assert not auto._resid_df


def test_pallas_option_changes_nothing():
    """`pallas` is accepted for parity with the reference and has no
    effect: the element passes route by device and dtype alone."""
    mesh = box_mesh(2, 2, 1, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    opts = {**BENCH, "preconditioner": "jacobi"}
    runs = [NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts, pallas=flag))
            ._newton(torch.zeros((mesh.n_nodes, 3), dtype=torch.float64), 1.0)
            for flag in (False, True)]
    (u0, ok0, rec0), (u1, ok1, rec1) = runs
    assert ok0 and ok1 and torch.equal(u0, u1) and rec0.pcg_iters == rec1.pcg_iters


@pytest.mark.parametrize("bad", [dict(precision="f32")])
def test_newton_solver_rejects_unported_options(case, bad):
    """A precision other than "f64" and "mixed" is a ValueError naming the
    two (the reference runs its f64 route for any other string; its docs
    and task format name only the two)."""
    with pytest.raises(ValueError, match="'f64' or 'mixed'"):
        NewtonSolver(case.mesh, NeoHookean(1.0, 0.6), case.bc, options=SolverOptions(**{**BENCH, **bad}))


@pytest.mark.parametrize("bad", [
    dict(linear="pcg_bcsr"), dict(linear="gmres"), dict(linear="pcg_bcsr", precision="f64", pallas=True),
    dict(coarse_modes=5), dict(coarse_modes=5, device_loop=True), dict(linear="direct"),
])
def test_newton_solver_rejects_what_the_reference_rejects(case, bad):
    """ValueError where the reference raises one: the mixed path with the
    assembled BCSR system or the dense solve, an unknown linear solver,
    pallas=True on the f64 path, and coarse modes other than 3, 6 or 12."""
    with pytest.raises(ValueError):
        NewtonSolver(case.mesh, NeoHookean(1.0, 0.6), case.bc, options=SolverOptions(**{**BENCH, **bad}))
    with pytest.raises(ValueError):
        RefNewtonSolver(case.ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), case.ref_bc,
                        options=RefOptions(**{**BENCH, **bad}))


def test_tet10_five_point_rule_solve_matches_reference():
    """A TET10 5-tet box 2x2x2 with the 5-point degree-3 rule (`n_quad=5`,
    the mesh of tests/test_parity.py::test_parity_tet10_5pt_quadrature),
    f64 assembled path: the reference's increments and Newton counts, and u
    within 1e-10 relative (both f64, summed in another order)."""
    import dataclasses

    ref_mesh = dataclasses.replace(ref_box_mesh(2, 2, 2, element_type="tet10"), n_quad=5)
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.15).build()
    opts = dict(linear="pcg_bcsr", n_steps=1, pcg_tol=1e-13)
    ref = RefNewtonSolver(ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                          options=RefOptions(**opts)).solve()
    mesh = box_mesh(2, 2, 2, element_type="tet10", device="cpu", n_quad=5)
    assert mesh.element.n_quad == 5 and ref_mesh.element.n_quad == 5
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.15).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    assert solver.geom.gradN.shape[1] == 5
    port = solver.solve()
    assert ref.converged and port.converged
    assert [r.newton_iters for r in port.history] == [r.newton_iters for r in ref.history]
    assert port.total_newton_iters == ref.total_newton_iters == sum(
        r.newton_iters for r in port.history)
    u_r = np.asarray(ref.u)
    assert np.linalg.norm(port.u.numpy() - u_r) <= 1e-10 * np.linalg.norm(u_r)
    # the 4-point rule gives another answer: the override reached the element pass
    four = NewtonSolver(box_mesh(2, 2, 2, element_type="tet10", device="cpu"), NeoHookean(1.0, 0.6),
                        bc, options=SolverOptions(**opts)).solve()
    assert np.linalg.norm(four.u.numpy() - u_r) > 1e-6 * np.linalg.norm(u_r)


def test_total_newton_iters_matches_reference(case):
    """`SolveResult.total_newton_iters` over two increments."""
    ref, port = case.solve(**dict(BENCH, preconditioner="jacobi", n_steps=2))
    assert len(port.history) == 2
    assert port.total_newton_iters == ref.total_newton_iters == sum(
        r.newton_iters for r in port.history)
