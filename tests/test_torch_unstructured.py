"""PyTorch port: the unstructured SoA path against the JAX reference on the
5-tet box (`fea_large_tpu/mesh/generators.py::box_mesh`,
`fea_large_tpu/ops/soa.py`, `fea_large_tpu/solvers/multilevel.py`), on CPU.

Tolerances:
  * mesh, node sets, ScatterBuckets and the aggregate map are host numpy
    in both packages: equal;
  * the f64 geometry tables, the f64 passes and the bucketed sums in f64:
    1e-12 relative to the largest entry (sums in another order);
  * the f32 passes: 2e-5 relative and absolute (the bound of bench.py's
    kernel check);
  * the coarse inverse and apply: 2e-5 relative to the largest entry
    (f32 probes, Cholesky and explicit inverse).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.materials.neo_hookean import NeoHookeanVolumetric as RefNHVol
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.ops import soa as ref_soa
from fea_large_tpu.solvers import multilevel as ref_ml

from fea_large_tpu_torch import interop
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.ops import soa
from fea_large_tpu_torch.solvers import multilevel as ml

torch.set_num_threads(2)

BOXES = [("tet4", (3, 2, 4)), ("tet10", (2, 3, 2))]
F32 = dict(rtol=2e-5, atol=2e-5)


def _fields(coords):
    rng = np.random.default_rng(11)
    u = 0.03 * rng.standard_normal((3, coords.shape[0]))
    u[2] -= 0.05 * coords[:, 2]
    v = rng.standard_normal((3, coords.shape[0]))
    return u, v


def _close64(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("et,cells", BOXES)
def test_box_mesh_matches_reference(et, cells):
    ref = ref_box_mesh(*cells, element_type=et)
    port = box_mesh(*cells, element_type=et, device="cpu")
    assert port.structure is None
    np.testing.assert_array_equal(port.coords_host, ref.coords_host)
    np.testing.assert_array_equal(port.conn_host, np.asarray(ref.conn_host, np.int64))
    np.testing.assert_array_equal(port.coords.numpy(), ref.coords_host)
    assert sorted(port.node_sets) == sorted(ref.node_sets)
    for name, ids in ref.node_sets.items():
        np.testing.assert_array_equal(port.node_sets[name], np.asarray(ids))


def _tet10_box_nodes(n):
    """Nodes of the TET10 5-tet box n^3: corners, axis edges and one
    diagonal per cell face (the 5-tet cell has no interior diagonal)."""
    return (n + 1) ** 3 + 3 * n * (n + 1) ** 2 + 3 * n * n * (n + 1)


def test_box_mesh_sizes_and_the_full_width_pick():
    """The generator's sizes follow the closed form, which at bench.py's
    5-tet pick n=36 gives 342,361 nodes (1,027,083 DOF) and 233,280 tets."""
    for n in (1, 2, 3):
        mesh = box_mesh(n, n, n, element_type="tet10", device="cpu")
        assert mesh.n_nodes == _tet10_box_nodes(n) and mesh.n_elements == 5 * n**3
    assert _tet10_box_nodes(36) == 342_361 and 5 * 36**3 == 233_280


@pytest.mark.parametrize("et,cells", BOXES)
def test_scatter_buckets_match_reference(et, cells):
    ref = ref_soa.SoAProblem.build(ref_box_mesh(*cells, element_type=et), jnp.float32)
    port = soa.SoAProblem.build(box_mesh(*cells, element_type=et, device="cpu"), torch.float32)
    assert len(port.buckets.idx) == len(ref.buckets.idx)
    for p, r in zip(port.buckets.idx, ref.buckets.idx):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for p, r in zip(port.buckets.mask, ref.buckets.mask):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(port.buckets.inv.numpy(), np.asarray(ref.buckets.inv))


@pytest.mark.parametrize("et,cells", BOXES)
def test_soa_problem_tables_match_reference(et, cells):
    ref_mesh = ref_box_mesh(*cells, element_type=et)
    ref = ref_soa.SoAProblem.build(ref_mesh, jnp.float64)
    port = soa.SoAProblem.build(box_mesh(*cells, element_type=et, device="cpu"), torch.float64)
    _close64(port.gradN.numpy(), ref.gradN)
    _close64(port.detJxW.numpy(), ref.detJxW)
    np.testing.assert_array_equal(port.conn_T.numpy(), np.asarray(ref.conn_T))
    shared = soa.SoAProblem.build(box_mesh(*cells, element_type=et, device="cpu"),
                                  torch.float32, share_maps_from=port)
    assert shared.buckets is port.buckets and shared.dtype == torch.float32


def test_interop_carries_reference_tables():
    ref_mesh = ref_box_mesh(2, 2, 1, element_type="tet10")
    ref = ref_soa.SoAProblem.build(ref_mesh, jnp.float64)
    b = ref.buckets
    port = interop.soa_problem_from_numpy(
        ref.n_nodes, np.asarray(ref.gradN), np.asarray(ref.detJxW), np.asarray(ref.conn_T),
        interop.scatter_buckets_from_numpy([np.asarray(x) for x in b.idx],
                                           [np.asarray(x) for x in b.mask], np.asarray(b.inv),
                                           device="cpu"),
        dtype=torch.float64, device="cpu",
    )
    mesh = interop.mesh_from_numpy(ref_mesh.coords_host, ref_mesh.conn_host, "tet10",
                                   ref_mesh.node_sets, device="cpu")
    built = soa.SoAProblem.build(mesh, torch.float64)
    assert mesh.structure is None
    assert torch.equal(port.gradN, built.gradN) and torch.equal(port.conn_T, built.conn_T)
    u, _ = _fields(ref_mesh.coords_host)
    st = soa.soa_freeze(port, NeoHookean(1.0, 0.6), torch.tensor(u))
    assert torch.equal(soa.soa_internal_force(port, st),
                       soa.soa_internal_force(built, soa.soa_freeze(built, NeoHookean(1.0, 0.6),
                                                                    torch.tensor(u))))


@pytest.mark.parametrize("et,cells", BOXES)
@pytest.mark.parametrize("n_comp", [3, 9])
def test_gather_and_scatter_match_reference(et, cells, n_comp):
    """The conn_T gather is exact in both packages; the bucketed sums in
    f64 agree to rounding."""
    ref = ref_soa.SoAProblem.build(ref_box_mesh(*cells, element_type=et), jnp.float64)
    port = soa.SoAProblem.build(box_mesh(*cells, element_type=et, device="cpu"), torch.float64)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((n_comp, ref.n_nodes))
    g = np.asarray(ref_soa.soa_gather(ref, jnp.asarray(v[:3])))
    np.testing.assert_array_equal(soa.soa_gather(port, torch.tensor(v[:3])).numpy(), g)
    npe, E = ref.conn_T.shape
    fe = rng.standard_normal((n_comp, npe, E))
    r = ref_soa.soa_scatter_channels(ref, [[jnp.asarray(fe[c, a]) for a in range(npe)]
                                           for c in range(n_comp)])
    _close64(soa.soa_scatter(port, torch.tensor(fe)).numpy(), r)


@pytest.mark.parametrize("et,cells", BOXES)
@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("ref_cls,port_cls", [(RefSVK, StVenantKirchhoff), (RefNH, NeoHookean),
                                              (RefNHVol, NeoHookeanVolumetric)],
                         ids=["svk", "nh", "nh_vol"])
def test_plain_passes_match_reference(et, cells, jdt, tdt, ref_cls, port_cls):
    ref_mesh = ref_box_mesh(*cells, element_type=et)
    rp = ref_soa.SoAProblem.build(ref_mesh, jdt)
    pp = soa.SoAProblem.build(box_mesh(*cells, element_type=et, device="cpu"), tdt)
    u, v = _fields(ref_mesh.coords_host)
    rs = ref_soa.soa_freeze(rp, ref_cls(jnp.asarray(1.0, jdt), jnp.asarray(0.6, jdt)),
                            jnp.asarray(u, jdt))
    ps = soa.soa_freeze(pp, port_cls(1.0, 0.6), torch.tensor(u, dtype=tdt))
    pairs = [(getattr(ps, n), getattr(rs, n)) for n in ("F", "S", "A", "alpha", "beta")]
    pairs += [
        (soa.soa_internal_force(pp, ps), ref_soa.soa_internal_force(rp, rs)),
        (soa.soa_apply_tangent(pp, ps, torch.tensor(v, dtype=tdt)),
         ref_soa.soa_apply_tangent(rp, rs, jnp.asarray(v, jdt))),
        (soa.soa_diag_blocks(pp, ps), ref_soa.soa_diag_blocks(rp, rs)),
    ]
    for p, r in pairs:
        assert p.dtype == tdt and tuple(p.shape) == tuple(np.shape(r))
        if tdt == torch.float64:
            _close64(p.numpy(), r)
        else:
            np.testing.assert_allclose(p.numpy(), np.asarray(r), **F32)


def test_aggregate_nodes_matches_reference():
    mesh = box_mesh(4, 3, 5, element_type="tet10", device="cpu")
    for agg_size in (7, 60, 100, 512):
        np.testing.assert_array_equal(ml.aggregate_nodes(mesh.coords_host, agg_size),
                                      ref_ml.aggregate_nodes(mesh.coords_host, agg_size))


@pytest.fixture(scope="module")
def box():
    ref_mesh = ref_box_mesh(3, 3, 3, element_type="tet10")
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    return dict(
        ref_mesh=ref_mesh, mesh=mesh,
        ref_bc=RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build(),
        bc=DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build(),
        ref_soa=ref_soa.SoAProblem.build(ref_mesh, jnp.float32),
        soa=soa.SoAProblem.build(mesh, torch.float32),
    )


@pytest.mark.parametrize("modes", [3, 6])
def test_unstructured_coarse_space_matches_reference(box, modes):
    ref = ref_ml.build_coarse_space(box["ref_mesh"], RefNH(jnp.asarray(1.0), jnp.asarray(0.6)),
                                    box["ref_bc"], agg_size=40, modes=modes, soa=box["ref_soa"])
    port = ml.build_coarse_space(box["mesh"], NeoHookean(1.0, 0.6), box["bc"], agg_size=40,
                                 modes=modes, soa=box["soa"])
    assert port.n_agg == ref.n_agg == 8 and port.modes == modes
    np.testing.assert_array_equal(port.pool.agg_host(), np.asarray(ref.agg))
    ref_inv = np.asarray(ref.acinv)
    assert torch.equal(port.acinv, port.acinv.T)
    np.testing.assert_allclose(port.acinv.numpy(), ref_inv, rtol=0,
                               atol=2e-5 * np.abs(ref_inv).max())
    rng = np.random.default_rng(4)
    r = (rng.standard_normal((box["mesh"].n_nodes, 3))
         * np.asarray(box["ref_bc"].free_mask)).astype(np.float32)
    za = np.asarray(ref.apply(jnp.asarray(r)))
    np.testing.assert_allclose(port.apply(torch.tensor(r)).numpy(), za, rtol=0,
                               atol=2e-5 * np.abs(za).max())
    # restrict is the exact transpose of prolong
    w = torch.tensor(rng.standard_normal((port.n_agg, modes)), dtype=torch.float64)
    rt = torch.tensor(r, dtype=torch.float64)
    lhs = float((port.restrict(rt) * w).sum())
    rhs = float((rt * port.prolong(w)).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)
