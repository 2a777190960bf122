"""PyTorch port (fea_large_tpu_torch): host model against the JAX reference.

Mesh generation, the Kuhn-lattice BoxStructure and the element tables are
numpy in both packages and must agree bitwise (or to 1e-15 for the
floating tables). Materials are compared in f64 at 1e-12 relative: both
evaluate the same closed forms, so only summation-order rounding differs.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.elements.reference import get_element as ref_get_element
from fea_large_tpu.materials.base import MATERIAL_REGISTRY as REF_REGISTRY
from fea_large_tpu.materials.base import lame_from_E_nu as ref_lame
from fea_large_tpu.materials.base import make_material as ref_make_material
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.materials.neo_hookean import NeoHookeanVolumetric as RefNHVol
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh import structure as ref_structure
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.mesh.generators import tet4_to_tet10 as ref_tet4_to_tet10

from fea_large_tpu_torch import interop
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.elements.reference import get_element
from fea_large_tpu_torch.materials import (
    MATERIAL_REGISTRY,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
    lame_from_E_nu,
    make_material,
)
from fea_large_tpu_torch.mesh import structure
from fea_large_tpu_torch.mesh.generators import box_mesh_kuhn, tet4_to_tet10

torch.set_num_threads(2)

#: f64 closed forms evaluated in two frameworks: rounding-level agreement
F64_RTOL = 1e-12

MESHES = [("tet4", (3, 2, 4)), ("tet10", (2, 3, 2)), ("tet10", (4, 4, 4))]


@pytest.mark.parametrize("et,cells", MESHES)
def test_box_mesh_kuhn_matches_reference(et, cells):
    ref = ref_box_mesh_kuhn(*cells, element_type=et)
    port = box_mesh_kuhn(*cells, element_type=et, device="cpu")
    assert np.array_equal(port.coords_host, ref.coords_host)
    assert np.array_equal(port.conn_host, np.asarray(ref.conn_host, np.int64))
    assert np.array_equal(port.coords.numpy(), ref.coords_host)
    assert np.array_equal(port.conn.numpy(), ref.conn_host)
    assert port.node_sets.keys() == ref.node_sets.keys()
    for k in ref.node_sets:
        assert np.array_equal(port.node_sets[k], ref.node_sets[k]), k
    assert (port.n_nodes, port.n_elements, port.n_dof) == (
        ref.n_nodes, ref.n_elements, ref.n_dof
    )


@pytest.mark.parametrize("et,cells", MESHES)
def test_box_structure_matches_reference(et, cells):
    ref = ref_box_mesh_kuhn(*cells, element_type=et).structure
    port = box_mesh_kuhn(*cells, element_type=et, device="cpu").structure
    for f in ("cells", "classes", "class_dims", "class_base", "slot_class", "slot_offset"):
        assert getattr(port, f) == getattr(ref, f), f
    for prop in ("n_cells", "n_tets", "n_nodes", "npe"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    np.testing.assert_array_equal(structure.kuhn_tets(), ref_structure.kuhn_tets())
    np.testing.assert_array_equal(
        structure.class_coords(port, 1.0, 2.0, 0.5),
        ref_structure.class_coords(ref, 1.0, 2.0, 0.5),
    )
    np.testing.assert_array_equal(
        structure.structure_conn(port), ref_structure.structure_conn(ref)
    )


def test_tet4_to_tet10_matches_reference():
    base = ref_box_mesh_kuhn(2, 2, 3, element_type="tet4")
    rc, rn = ref_tet4_to_tet10(base.coords_host, base.conn_host)
    pc, pn = tet4_to_tet10(base.coords_host, base.conn_host)
    np.testing.assert_array_equal(pc, rc)
    np.testing.assert_array_equal(pn, rn)


@pytest.mark.parametrize("name,q", [("tet4", None), ("tet10", None), ("tet10", 5), ("tet4", 4)])
def test_element_tables_match_reference(name, q):
    ref, port = ref_get_element(name, q), get_element(name, q)
    assert (port.name, port.n_nodes, port.n_quad, port.corner_nodes) == (
        ref.name, ref.n_nodes, ref.n_quad, ref.corner_nodes
    )
    for f in ("quad_points", "quad_weights", "shape", "shape_grad"):
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f), rtol=0, atol=1e-15)
    np.testing.assert_allclose(port.quad_weights.sum(), 1.0 / 6.0, atol=1e-15)


def _stretches(n=64, seed=3):
    rng = np.random.default_rng(seed)
    F = np.eye(3) + 0.15 * rng.standard_normal((n, 3, 3))
    return np.einsum("nki,nkj->nij", F, F)  # C = F^T F, SPD


MATERIALS = [(RefSVK, StVenantKirchhoff), (RefNH, NeoHookean), (RefNHVol, NeoHookeanVolumetric)]


@pytest.mark.parametrize("ref_cls,port_cls", MATERIALS)
def test_material_stress_and_factors_match_reference(ref_cls, port_cls):
    C = _stretches()
    ref = ref_cls(jnp.asarray(1.3), jnp.asarray(0.7))
    S_r, state = ref.pk2_and_state(jnp.asarray(C))
    al_r, A_r, be_r = ref.iso_tangent_factors(state, jnp.asarray(C))
    S, al, A, be = port_cls(1.3, 0.7).stress_and_factors(torch.tensor(C))
    for a, r in ((S, S_r), (A, A_r), (al, al_r), (be, be_r)):
        r = np.broadcast_to(np.asarray(r), a.shape)
        np.testing.assert_allclose(a.numpy(), r, rtol=F64_RTOL,
                                   atol=F64_RTOL * np.abs(r).max())


def test_material_registry_matches_reference():
    for name in ("svk", "st_venant_kirchhoff", "neo_hookean", "nh", "neo_hookean_vol", "a1",
                 "mooney_rivlin", "mr"):
        ref = ref_make_material(name, lam=1.0, mu=0.5)
        port = make_material(name, lam=1.0, mu=0.5)
        assert type(port).__name__ == type(ref).__name__
        assert port.name == ref.name
        assert (port.lam, port.mu) == (1.0, 0.5)
    assert make_material("svk", E=2.0, nu=0.3) == StVenantKirchhoff(*lame_from_E_nu(2.0, 0.3))
    assert lame_from_E_nu(2.0, 0.3) == tuple(float(x) for x in ref_lame(2.0, 0.3))
    assert {StVenantKirchhoff.kind, NeoHookean.kind, NeoHookeanVolumetric.kind} == {0, 1, 2}
    # every name and alias of the reference's registry, to the same class;
    # the three with a kernel code are the closed-form materials
    assert sorted(MATERIAL_REGISTRY) == sorted(REF_REGISTRY)
    assert all(MATERIAL_REGISTRY[k].__name__ == REF_REGISTRY[k].__name__ for k in REF_REGISTRY)
    assert {c for c in MATERIAL_REGISTRY.values() if c.kind >= 0} == {
        StVenantKirchhoff, NeoHookean, NeoHookeanVolumetric}


def test_dirichlet_matches_reference():
    ref_mesh = ref_box_mesh_kuhn(2, 2, 3, element_type="tet10")
    mesh = box_mesh_kuhn(2, 2, 3, element_type="tet10", device="cpu")
    ref = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).prescribe(
        "xmax", "xy", 0.02).build()
    port = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).prescribe(
        "xmax", "xy", 0.02).build()
    np.testing.assert_array_equal(port.free_mask.numpy(), np.asarray(ref.free_mask))
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    assert port.n_fixed == ref.n_fixed
    u = np.random.default_rng(0).standard_normal((mesh.n_nodes, 3))
    np.testing.assert_array_equal(
        port.impose(torch.tensor(u), 0.5).numpy(), np.asarray(ref.impose(jnp.asarray(u), 0.5))
    )
    np.testing.assert_array_equal(
        port.project(torch.tensor(u)).numpy(), np.asarray(ref.project(jnp.asarray(u)))
    )


def test_interop_builds_port_objects_from_reference_arrays():
    ref_mesh = ref_box_mesh_kuhn(3, 2, 2, element_type="tet10")
    st = ref_mesh.structure
    mesh = interop.mesh_from_numpy(
        ref_mesh.coords_host, ref_mesh.conn_host, "tet10", ref_mesh.node_sets,
        {f: getattr(st, f) for f in ("cells", "classes", "class_dims", "class_base",
                                     "slot_class", "slot_offset")},
        device="cpu",
    )
    assert mesh.structure == box_mesh_kuhn(3, 2, 2, element_type="tet10", device="cpu").structure
    np.testing.assert_array_equal(mesh.coords.numpy(), ref_mesh.coords_host)
    bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    pbc = interop.dirichlet_from_numpy(np.asarray(bc.free_mask), np.asarray(bc.values),
                                       device="cpu")
    np.testing.assert_array_equal(pbc.free_mask.numpy(), np.asarray(bc.free_mask))
    for kind, cls in ((0, StVenantKirchhoff), (1, NeoHookean), (2, NeoHookeanVolumetric)):
        assert interop.material_from_numpy(kind, np.float32(1.0), 0.6) == cls(1.0, 0.6)
    q, E = 4, mesh.n_elements
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((q, 3, 3, E)) for _ in range(3)] + [
        rng.standard_normal((q, E)) for _ in range(2)
    ]
    state = interop.soa_state_from_numpy(*arrs, device="cpu")
    for a, t in zip(arrs, (state.F, state.S, state.A, state.alpha, state.beta)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))


def test_mesh_n_quad_matches_reference():
    """The quadrature override: through `Mesh.create`, the generators,
    `interop.mesh_from_numpy` and `dataclasses.replace`, as the reference's
    `Mesh.n_quad`; the element tables of the overridden mesh are the
    reference's (1e-15)."""
    import dataclasses

    from fea_large_tpu_torch.mesh.core import Mesh
    from fea_large_tpu_torch.mesh.generators import box_mesh

    ref = dataclasses.replace(ref_box_mesh_kuhn(2, 2, 2, element_type="tet10"), n_quad=5)
    base = box_mesh_kuhn(2, 2, 2, element_type="tet10", device="cpu")
    assert base.n_quad is None and base.element.n_quad == 4
    meshes = [
        box_mesh_kuhn(2, 2, 2, element_type="tet10", device="cpu", n_quad=5),
        box_mesh(2, 2, 2, element_type="tet10", device="cpu", n_quad=5),
        dataclasses.replace(base, n_quad=5),
        Mesh.create(base.coords_host, base.conn_host, "tet10", device="cpu", n_quad=5),
        interop.mesh_from_numpy(ref.coords_host, ref.conn_host, "tet10", ref.node_sets,
                                device="cpu", n_quad=ref.n_quad),
    ]
    for mesh in meshes:
        assert mesh.n_quad == ref.n_quad == 5
        assert (mesh.element.name, mesh.element.n_quad) == (ref.element.name, ref.element.n_quad)
        for f in ("quad_points", "quad_weights", "shape", "shape_grad"):
            np.testing.assert_allclose(getattr(mesh.element, f), getattr(ref.element, f),
                                       rtol=0, atol=1e-15)


def test_mesh_with_node_sets_matches_reference():
    """`Mesh.with_node_sets` adds and replaces named sets and leaves the
    mesh it was called on as it was, as the reference's."""
    ref_mesh = ref_box_mesh_kuhn(2, 2, 3, element_type="tet10")
    mesh = box_mesh_kuhn(2, 2, 3, element_type="tet10", device="cpu", n_quad=5)
    corner = np.nonzero((ref_mesh.coords_host < 1e-9).all(1))[0]
    ref = ref_mesh.with_node_sets(corner=corner, zmin=[0, 1])
    port = mesh.with_node_sets(corner=corner, zmin=[0, 1])
    assert port.node_sets.keys() == ref.node_sets.keys()
    for k in ref.node_sets:
        np.testing.assert_array_equal(port.node_sets[k], ref.node_sets[k])
    assert "corner" not in mesh.node_sets and len(mesh.node_sets["zmin"]) > 2
    assert port.coords is mesh.coords and port.structure is mesh.structure and port.n_quad == 5
    bc = DirichletBuilder(port).fix("corner").build()
    ref_bc = RefDirichletBuilder(ref).fix("corner").build()
    np.testing.assert_array_equal(bc.free_mask.numpy(), np.asarray(ref_bc.free_mask))


def test_port_never_imports_jax_or_the_reference():
    """The port imports torch and numpy only; the reference turns on JAX
    x64 globally when imported, so only tests may import both."""
    root = pathlib.Path(__file__).resolve().parents[1]
    bad = re.compile(r"^\s*(import|from)\s+(jax|fea_large_tpu)(\s|\.|$)", re.M)
    files = list((root / "fea_large_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        assert not bad.search(path.read_text()), path


def test_generators_default_to_the_card():
    """The entry points build on the card unless the caller asks for the
    CPU; without CUDA the default raises instead of falling back."""
    import inspect

    from fea_large_tpu_torch.mesh.core import Mesh
    from fea_large_tpu_torch.mesh.generators import box_mesh

    for fn in (box_mesh, box_mesh_kuhn, Mesh.create):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for build in (box_mesh, box_mesh_kuhn):
        if torch.cuda.is_available():
            assert build(2, 2, 2).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                build(2, 2, 2)


def test_interop_builders_default_to_the_card():
    """The interop builders, entry points for the reference's numpy state,
    build on the card unless the caller asks for the CPU."""
    import inspect

    for fn in (interop.mesh_from_numpy, interop.dirichlet_from_numpy,
               interop.soa_state_from_numpy, interop.scatter_buckets_from_numpy,
               interop.soa_problem_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.dirichlet_from_numpy(np.ones((2, 3)), np.zeros((2, 3)))
    # the loads take no device of their own: they lie where the mesh lies,
    # which is the card unless the caller asked for the CPU
    from fea_large_tpu_torch.bc import body_forces, nodal_forces

    for fn in (nodal_forces, body_forces):
        assert "device" not in inspect.signature(fn).parameters
    if torch.cuda.is_available():
        mesh = box_mesh_kuhn(1, 1, 1)
        assert nodal_forces(mesh, {"zmax": [0.0, 0.0, 1.0]}).device.type == "cuda"
        assert body_forces(mesh, [0.0, 0.0, 1.0]).device.type == "cuda"
    mesh = box_mesh_kuhn(1, 1, 1, device="cpu")
    assert nodal_forces(mesh, {"zmax": [0.0, 0.0, 1.0]}).device.type == "cpu"
    assert body_forces(mesh, [0.0, 0.0, 1.0]).device.type == "cpu"
