"""PyTorch port: materials defined by their energy alone
(`fea_large_tpu_torch/materials/autodiff.py`, `MooneyRivlin`) and the
generic tangent branch of the element passes and the matrix-free product,
against the JAX reference (`fea_large_tpu/materials/autodiff.py`).

  * the registry: "mooney_rivlin" and its aliases in both packages;
  * `pk2` and `tangent_apply` (torch.func grad under vmap, and jvp) at
    seeded C and X: within 1e-12 of the reference's largest entry (both
    f64); the reference's finite-difference checks on the port; the
    registered materials' interface (`pk2`, `tangent_apply`,
    `iso_tangent_factors`, `tangent_full`) against the reference's;
  * generic `element_stiffness` and `element_diag_blocks` on
    `box_mesh(1,1,1)` and `box_mesh(2,2,2)` TET4, and the generic
    `apply_tangent`: 1e-12;
  * the reference's end-to-end case (2x2x2 TET4, zmax -0.15, two
    increments, direct): the same increments and Newton counts, u within
    1e-10 relative; the same problem on the f64 `pcg` and `pcg_bcsr` routes;
  * the mixed path raises NotImplementedError in both packages (the SoA
    material dispatch takes the registered materials only);
  * `load_task` of a task whose material is mooney_rivlin, in both.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.assembly.matfree import TangentState as RefTangentState
from fea_large_tpu.assembly.matfree import apply_tangent as ref_apply_tangent
from fea_large_tpu.assembly.scatter import NodeScatter as RefNodeScatter
from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.elements import kernels as ref_kernels
from fea_large_tpu.io.task import load_task as ref_load_task
from fea_large_tpu.materials import neo_hookean as ref_nh
from fea_large_tpu.materials.autodiff import MooneyRivlin as RefMR
from fea_large_tpu.materials.base import make_material as ref_make_material
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

import fea_large_tpu_torch
from fea_large_tpu_torch import interop
from fea_large_tpu_torch.assembly.matfree import TangentState, apply_tangent
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.elements import kernels
from fea_large_tpu_torch.io.task import load_task
from fea_large_tpu_torch.materials import (
    AutodiffMaterial,
    MooneyRivlin,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
    make_material,
)
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

#: f64 against f64, computed in another order
F64_BOUND = 1e-12
#: u of two f64 solves, against the reference
U_BOUND = 1e-10


def _close(port, ref, bound=F64_BOUND):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= bound * np.abs(ref).max()


def _rand_C(rng, batch=()):
    F = np.eye(3) + 0.1 * rng.standard_normal((*batch, 3, 3))
    return np.einsum("...ki,...kj->...ij", F, F)


@pytest.mark.parametrize("name", ["mooney_rivlin", "mooney-rivlin", "mr", "MR"])
def test_registry(name):
    m = make_material(name, E=2.0, nu=0.3)
    r = ref_make_material(name, E=2.0, nu=0.3)
    assert isinstance(m, MooneyRivlin) and isinstance(m, AutodiffMaterial)
    assert isinstance(r, RefMR)
    assert (m.lam, m.mu) == (float(r.lam), float(r.mu))
    assert m.name == "mooney_rivlin" and m.kind == -1
    assert fea_large_tpu_torch.MooneyRivlin is MooneyRivlin
    assert fea_large_tpu_torch.AutodiffMaterial is AutodiffMaterial
    assert interop.material_from_numpy(name, np.float64(1.0), 0.6) == MooneyRivlin(1.0, 0.6)


def test_pk2_and_tangent_apply_match_reference():
    rng = np.random.default_rng(7)
    C = _rand_C(rng, (5, 4))
    X = rng.standard_normal((5, 4, 3, 3))
    mat, ref = MooneyRivlin(1.2, 0.8), RefMR(jnp.asarray(1.2), jnp.asarray(0.8))
    _close(mat.pk2(torch.tensor(C)), ref.pk2(jnp.asarray(C)))
    S, state = mat.pk2_and_state(torch.tensor(C))
    _close(S, ref.pk2(jnp.asarray(C)))
    assert mat.iso_tangent_factors(state, torch.tensor(C)) is None
    _close(mat.tangent_apply(state, torch.tensor(X)), ref.tangent_apply(jnp.asarray(C), jnp.asarray(X)))
    # X broadcast over a batch that extends the state's is the reference's too
    _close(mat.tangent_apply(torch.tensor(C[0, 0]), torch.tensor(X[0, 0])),
           ref.tangent_apply(jnp.asarray(C[0, 0]), jnp.asarray(X[0, 0])))
    _close(mat.energy(torch.tensor(C)), ref.energy(jnp.asarray(C)))
    _close(mat.tangent_full(torch.tensor(C)), ref.tangent_full(jnp.asarray(C)))


def test_pk2_is_energy_gradient_fd(rng):
    """The reference's check: dW = 1/2 S : dC for symmetric dC."""
    mat = MooneyRivlin(1.2, 0.8)
    C = torch.tensor(_rand_C(rng))
    S = mat.pk2(C).numpy()
    h = 1e-6
    for i in range(3):
        for j in range(i, 3):
            dC = torch.zeros((3, 3), dtype=torch.float64)
            dC[i, j] = dC[j, i] = h
            dW = float(mat.energy((C + dC)[None])[0] - mat.energy((C - dC)[None])[0])
            np.testing.assert_allclose(dW / (2 * h), 0.5 * (S * dC.numpy() / h).sum(),
                                       rtol=1e-6, atol=1e-9)


def test_tangent_is_stress_derivative_fd(rng):
    """The reference's check: CC : Xs = dS along dC = 2 Xs."""
    mat = MooneyRivlin(1.2, 0.8)
    C = torch.tensor(_rand_C(rng))
    X = rng.standard_normal((3, 3))
    Xs = torch.tensor(0.5 * (X + X.T))
    Y = mat.tangent_apply(C, Xs).numpy()
    h = 1e-6
    dS = (mat.pk2(C + 2 * h * Xs) - mat.pk2(C - 2 * h * Xs)).numpy() / (2 * h)
    np.testing.assert_allclose(Y, dS, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ref_cls,cls", [(RefSVK, StVenantKirchhoff), (ref_nh.NeoHookean, NeoHookean),
                                         (ref_nh.NeoHookeanVolumetric, NeoHookeanVolumetric)],
                         ids=["svk", "nh", "nh_vol"])
def test_registered_material_interface_matches_reference(ref_cls, cls):
    """The registered materials' generic interface, derived from their
    factors: pk2, tangent_apply on a non-symmetric X, the factors and the
    rank-4 tangent."""
    rng = np.random.default_rng(3)
    C = _rand_C(rng, (6,))
    X = rng.standard_normal((6, 3, 3))
    mat, ref = cls(1.3, 0.7), ref_cls(jnp.asarray(1.3), jnp.asarray(0.7))
    Ct = torch.tensor(C)
    S, state = mat.pk2_and_state(Ct)
    ref_S, ref_state = ref.pk2_and_state(jnp.asarray(C))
    _close(S, ref_S)
    _close(mat.pk2(Ct), ref_S)
    _close(mat.tangent_apply(state, torch.tensor(X)), ref.tangent_apply(ref_state, jnp.asarray(X)))
    for p, r in zip(mat.iso_tangent_factors(state, Ct), ref.iso_tangent_factors(ref_state, jnp.asarray(C))):
        _close(p.expand(r.shape), r)
    _close(mat.tangent_full(Ct), ref.tangent_full(jnp.asarray(C)))
    # the factors are what `stress_and_factors` gives: the same tensors
    S2, alpha, A, beta = mat.stress_and_factors(Ct)
    assert torch.equal(S, S2) and all(torch.equal(a, b) for a, b in zip(state, (alpha, A, beta)))


def _element_case(n, seed=4):
    ref_mesh = ref_box_mesh(n, n, n, element_type="tet4")
    mesh = box_mesh(n, n, n, element_type="tet4", device="cpu")
    rng = np.random.default_rng(seed)
    u = 0.03 * rng.standard_normal((mesh.n_nodes, 3))
    v = rng.standard_normal((mesh.n_nodes, 3))
    ref_geom = ref_kernels.precompute_geometry(ref_mesh.coords, ref_mesh.conn, ref_mesh.element)
    geom = kernels.precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    return ref_mesh, mesh, u, v, ref_geom, geom


@pytest.mark.parametrize("n", [1, 2])
def test_generic_element_passes_match_reference(n):
    ref_mesh, mesh, u, _, ref_geom, geom = _element_case(n)
    mat, ref = MooneyRivlin(1.0, 0.6), RefMR(jnp.asarray(1.0), jnp.asarray(0.6))
    ue, ref_ue = torch.tensor(u)[mesh.conn], jnp.asarray(u)[ref_mesh.conn]
    Ke, fe = kernels.element_stiffness(ue, geom, mat)
    ref_Ke, ref_fe = ref_kernels.element_stiffness(ref_ue, ref_geom, ref)
    _close(Ke, ref_Ke)
    _close(fe, ref_fe)
    _close(kernels.element_internal_force(ue, geom, mat), ref_fe)
    _close(kernels.element_diag_blocks(ue, geom, mat), ref_kernels.element_diag_blocks(ref_ue, ref_geom, ref))
    # the diagonal blocks are the stiffness's own
    idx = torch.arange(Ke.shape[1])
    assert torch.allclose(kernels.element_diag_blocks(ue, geom, mat), Ke[:, idx, :, idx].transpose(0, 1),
                          rtol=0, atol=1e-13 * float(Ke.abs().max()))


def test_generic_branch_chunks(monkeypatch):
    """The generic branch computes each element within one chunk: chunks of
    7 elements agree with one chunk to 1e-14 (the batched contraction may
    block a smaller batch otherwise), and the chunks are fixed, so two calls
    are bitwise equal."""
    _, mesh, u, _, _, geom = _element_case(2)
    mat = MooneyRivlin(1.0, 0.6)
    ue = torch.tensor(u)[mesh.conn]
    whole = kernels.element_stiffness(ue, geom, mat)[0], kernels.element_diag_blocks(ue, geom, mat)
    monkeypatch.setattr(kernels, "GENERIC_CHUNK", 7)
    assert mesh.n_elements > 7
    chunked = kernels.element_stiffness(ue, geom, mat)[0], kernels.element_diag_blocks(ue, geom, mat)
    for a, b in zip(chunked, whole):
        _close(a, b, 1e-14)
    assert torch.equal(kernels.element_stiffness(ue, geom, mat)[0], chunked[0])
    assert torch.equal(kernels.element_diag_blocks(ue, geom, mat), chunked[1])


def test_generic_apply_tangent_matches_reference():
    ref_mesh, mesh, u, v, ref_geom, geom = _element_case(2)
    mat, ref = MooneyRivlin(1.0, 0.6), RefMR(jnp.asarray(1.0), jnp.asarray(0.6))
    state, fe = TangentState.freeze(torch.tensor(u), mesh.conn, geom, mat)
    ref_state, ref_fe = RefTangentState.freeze(jnp.asarray(u), ref_mesh.conn, ref_geom, ref)
    assert isinstance(state.mat_state, torch.Tensor)  # the material's state: C
    _close(state.mat_state, ref_state.mat_state)
    _close(fe, ref_fe)
    scatter = NodeScatter.build(mesh.conn_host, mesh.n_nodes, "cpu")
    ref_scatter = RefNodeScatter.build(ref_mesh.conn_host, ref_mesh.n_nodes)
    _close(apply_tangent(state, torch.tensor(v), mesh.conn, geom, mat, scatter),
           ref_apply_tangent(ref_state, jnp.asarray(v), ref_mesh.conn, ref_geom, ref, ref_scatter))


def _e2e(linear, **extra):
    """The reference's end-to-end case on both packages."""
    opts = dict(linear=linear, n_steps=2, **extra)
    ref_mesh = ref_box_mesh(2, 2, 2, element_type="tet4")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.15).build()
    ref = RefNewtonSolver(ref_mesh, RefMR(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                          options=RefOptions(**opts)).solve()
    mesh = box_mesh(2, 2, 2, element_type="tet4", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.15).build()
    port = NewtonSolver(mesh, MooneyRivlin(1.0, 0.6), bc, options=SolverOptions(**opts)).solve()
    return ref, port


@pytest.mark.parametrize("linear,extra", [
    ("direct", {}), ("pcg", dict(pcg_tol=1e-13)), ("pcg_bcsr", dict(pcg_tol=1e-13)),
], ids=["direct", "pcg", "pcg_bcsr"])
def test_mooney_rivlin_end_to_end_matches_reference(linear, extra):
    ref, port = _e2e(linear, **extra)
    assert ref.converged and port.converged
    assert [(r.load_factor, r.newton_iters) for r in port.history] == [
        (r.load_factor, r.newton_iters) for r in ref.history]
    assert len(port.history[-1].residual_norms) <= 8  # the consistent tangent: fast Newton
    u_r = np.asarray(ref.u)
    assert np.abs(port.u.numpy() - u_r).max() <= U_BOUND * np.abs(u_r).max()
    assert port.u[:, 0].max() > 1e-3  # lateral bulge under compression
    if linear != "direct":
        for a, b in zip(port.history, ref.history):
            assert len(a.pcg_iters) == len(b.pcg_iters)
            assert all(abs(x - y) <= 1 for x, y in zip(a.pcg_iters, b.pcg_iters))


@pytest.mark.parametrize("preconditioner", ["jacobi", "two_level"])
def test_mixed_path_rejects_autodiff_materials_as_the_reference(preconditioner):
    """The SoA passes take the registered isotropic materials only: both
    packages raise NotImplementedError on the mixed path (at setup with
    the two-level probes, at the first residual with Jacobi)."""
    opts = dict(linear="pcg", precision="mixed", device_loop=False, preconditioner=preconditioner,
                coarse_modes=6)
    ref_mesh = ref_box_mesh(2, 2, 2, element_type="tet4")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.15).build()
    with pytest.raises(NotImplementedError, match="registered isotropic materials"):
        RefNewtonSolver(ref_mesh, RefMR(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                        options=RefOptions(**opts)).solve()
    mesh = box_mesh(2, 2, 2, element_type="tet4", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.15).build()
    with pytest.raises(NotImplementedError, match="registered isotropic materials"):
        NewtonSolver(mesh, MooneyRivlin(1.0, 0.6), bc, options=SolverOptions(**opts)).solve()


def test_load_task_mooney_rivlin_matches_reference(tmp_path):
    """A task file whose material is mooney_rivlin loads in both packages,
    and its direct solve takes the reference's Newton counts."""
    task = {
        "name": "mr_block", "element_type": "tet4",
        "mesh": {"box": {"nx": 2, "ny": 2, "nz": 2}},
        "material": {"model": "mooney_rivlin", "E": 2.0, "nu": 0.3},
        "loading": {"n_steps": 2, "dirichlet": [
            {"set": "zmin", "components": "xyz", "value": 0.0},
            {"set": "zmax", "components": "z", "value": -0.1}]},
        "solver": {"linear": "direct"},
    }
    path = tmp_path / "mr_block.json"
    path.write_text(json.dumps(task))
    ref, port = ref_load_task(path), load_task(path, device="cpu")
    assert isinstance(ref.material, RefMR) and isinstance(port.material, MooneyRivlin)
    assert (port.material.lam, port.material.mu) == (float(ref.material.lam), float(ref.material.mu))
    assert port.solver.linear == ref.solver.linear == "direct"
    ref_res = RefNewtonSolver(ref.mesh, ref.material, ref.build_bc(), ref.build_forces(),
                              ref.solver).solve()
    res = NewtonSolver(port.mesh, port.material, port.build_bc(), port.build_forces(),
                       port.solver).solve()
    assert res.converged and ref_res.converged
    assert [r.newton_iters for r in res.history] == [r.newton_iters for r in ref_res.history]
    u_r = np.asarray(ref_res.u)
    assert np.abs(res.u.numpy() - u_r).max() <= U_BOUND * np.abs(u_r).max()
