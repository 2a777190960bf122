"""The plain reference against the program's CPU path, at small sizes."""

import portbench_paths  # noqa: F401  (first: the paths)
import json

import numpy as np
import pytest
import torch

from reference.fem import Problem
from reference.mesh import BoxMesh

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.solvers.newton import (
    NewtonSolver,
    SolverOptions,
    _mixed_matvec,
    _residual_soa_fn,
)

BC = {"fix": ["zmin"], "prescribe": [{"set": "zmax", "component": "z", "value": -0.05}]}
BUILD = {"kuhn": box_mesh_kuhn, "5tet": box_mesh}


def _setup(kind, n):
    mesh = BUILD[kind](n, n, n, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                          options=SolverOptions(precision="mixed", preconditioner="jacobi"))
    ref = BoxMesh(kind, n)
    idx = torch.as_tensor(ref.locate(mesh.coords_host))
    return mesh, bc, solver, Problem(ref, 1.0, 0.6, BC, "cpu"), idx


def _field(n_nodes, seed, scale=0.01):
    return torch.tensor(scale * np.random.default_rng(seed).standard_normal((n_nodes, 3)))


@pytest.mark.parametrize("kind,n", [("kuhn", 3), ("kuhn", 4), ("5tet", 3), ("5tet", 4)])
def test_residual_matches_the_program(kind, n):
    mesh, bc, solver, prob, idx = _setup(kind, n)
    assert prob.mesh.n_nodes == mesh.n_nodes and prob.mesh.n_elements == mesh.n_elements
    u = _field(mesh.n_nodes, n)
    r_prog, _ = _residual_soa_fn(u, 1.0, solver._soa64, solver.material, bc, solver.f_ext)
    g = prob.zeros()
    g[idx] = u
    r_ref = prob.residual(g)[idx]
    assert float((r_ref - r_prog).abs().max() / r_prog.abs().max()) < 1e-13


@pytest.mark.parametrize("kind", ["kuhn", "5tet"])
def test_tangent_matches_finite_differences_and_the_program(kind):
    mesh, bc, solver, prob, idx = _setup(kind, 3)
    u, v = prob.zeros(), prob.zeros()
    u[idx], v[idx] = _field(mesh.n_nodes, 1), _field(mesh.n_nodes, 2, 1.0)
    kv = prob.tangent_apply(u, v)
    eps = 1e-6
    fd = (prob.internal_force(u + eps * v) - prob.internal_force(u - eps * v)) / (2 * eps)
    assert float((kv - fd).abs().max() / kv.abs().max()) < 1e-7
    # the program's masked f32 tangent action M K M v + (I - M) v at u
    state = solver._freeze(u[idx])
    free32 = bc.free_mask.to(torch.float32)
    y = _mixed_matvec(solver._soa, state, free32.T.contiguous(), v[idx].float())
    want = prob.free * prob.tangent_apply(u, prob.free * v) + (1 - prob.free) * v
    assert float((y.double() - want[idx]).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("kind", ["kuhn", "5tet"])
def test_start_state_and_prescribed_values(kind):
    mesh, bc, _, prob, idx = _setup(kind, 3)
    start = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    start[:, 2] = -0.05 * 1.2 * mesh.coords[:, 2]
    assert torch.allclose(prob.affine_start(1.2)[idx], start, rtol=0, atol=1e-16)
    assert torch.equal(prob.free[idx], bc.free_mask)
    assert torch.allclose(prob.impose(prob.zeros(), 1.2)[idx], bc.impose(start * 0, 1.2))


def test_locate_refuses_a_foreign_mesh():
    ref = BoxMesh("kuhn", 3)
    other = box_mesh_kuhn(4, 4, 4, element_type="tet10", device="cpu")
    with pytest.raises(ValueError):
        ref.locate(other.coords_host)
    shifted = box_mesh_kuhn(3, 3, 3, element_type="tet10", device="cpu").coords_host + 0.01
    with pytest.raises(ValueError):
        ref.locate(shifted)


@pytest.mark.parametrize("name", ["kuhn-tet10-1m", "5tet-tet10-1m"])
def test_full_size_meshes_are_the_configurations(name):
    m = json.loads((portbench_paths.PORTBENCH / "configs" / f"{name}.json").read_text())["mesh"]
    mesh = BoxMesh(m["kind"], m["n"])
    assert (3 * mesh.n_nodes, mesh.n_elements) == (m["dof"], m["elements"])
