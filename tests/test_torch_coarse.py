"""PyTorch port: lattice pooling and the two-level coarse space against the
JAX reference (`fea_large_tpu/ops/pooling.py`,
`fea_large_tpu/solvers/multilevel.py`).

Tolerances: the pooled transfer in f64 to 1e-12 (sums in another order);
the probed coarse matrix and the coarse apply to 1e-5 relative to the
largest entry: both are f32 (probes through the f32 tangent action, an
f32 Cholesky and explicit inverse), so f32 rounding amplified by the
coarse condition number sets the bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.ops import pooling as ref_pooling
from fea_large_tpu.ops.soa import SoAProblem as RefSoAProblem
from fea_large_tpu.solvers import multilevel as ref_ml

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh_kuhn
from fea_large_tpu_torch.ops import pooling
from fea_large_tpu_torch.ops.soa import SoAProblem
from fea_large_tpu_torch.solvers import multilevel as ml

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "et,cells,target",
    [("tet10", (4, 4, 4), 8), ("tet10", (5, 3, 4), 6), ("tet4", (7, 5, 3), 10), ("tet10", (3, 3, 3), 27)],
)
def test_lattice_pool_matches_reference(et, cells, target):
    st = box_mesh_kuhn(*cells, element_type=et, device="cpu").structure
    ref = ref_pooling.make_lattice_pool(st, target)
    port = pooling.make_lattice_pool(st, target)
    assert (port.block, port.nb, port.n_agg) == (ref.block, ref.nb, ref.n_agg)
    np.testing.assert_array_equal(port.agg_host(), ref.agg_host())
    rng = np.random.default_rng(5)
    v = rng.standard_normal((st.n_nodes, 6))
    w = rng.standard_normal((port.n_agg, 6))
    rr = np.asarray(ref.restrict(jnp.asarray(v)))
    np.testing.assert_allclose(port.restrict(torch.tensor(v)).numpy(), rr, rtol=1e-12,
                               atol=1e-12 * np.abs(rr).max())
    np.testing.assert_array_equal(port.prolong(torch.tensor(w)).numpy(),
                                  np.asarray(ref.prolong(jnp.asarray(w))))
    # restrict is the exact transpose of prolong
    lhs = float((port.restrict(torch.tensor(v)) * torch.tensor(w)).sum())
    rhs = float((torch.tensor(v) * port.prolong(torch.tensor(w))).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)


def test_default_agg_size_matches_reference():
    for n in (729, 9261, 100_000, 357_911, 2_000_000):
        for structured in (False, True):
            for tc in (2500, 5000):
                assert ml.default_agg_size(n, tc, structured) == ref_ml.default_agg_size(n, tc, structured)


@pytest.fixture(scope="module")
def problem():
    ref_mesh = ref_box_mesh_kuhn(4, 4, 4, element_type="tet10")
    mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device="cpu")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    return dict(
        ref_mesh=ref_mesh, mesh=mesh, ref_bc=ref_bc, bc=bc,
        ref_mat=RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), mat=NeoHookean(1.0, 0.6),
        ref_soa=RefSoAProblem.build(ref_mesh, jnp.float32),
        soa=SoAProblem.build(mesh, torch.float32),
    )


def _plan_inputs(pb, modes):
    mesh = pb["mesh"]
    agg_size = ml.default_agg_size(mesh.n_nodes, {3: 5000, 6: 2500}[modes], structured=True)
    pool = pooling.make_lattice_pool(mesh.structure, max(1, mesh.n_nodes // agg_size))
    agg = pool.agg_host()
    n_agg = int(agg.max()) + 1
    cnt = np.bincount(agg, minlength=n_agg).astype(float)
    cent = np.stack([np.bincount(agg, weights=mesh.coords_host[:, d], minlength=n_agg) / cnt
                     for d in range(3)], axis=1)
    dvec = ml._rbm_dvec(mesh.coords_host, agg, cent, n_agg)
    np.testing.assert_array_equal(dvec, ref_ml._rbm_dvec(mesh.coords_host, agg, cent, n_agg))
    return pool, agg, n_agg, dvec


@pytest.mark.parametrize("modes", [3, 6])
def test_probe_plan_matches_reference(problem, modes):
    """The aggregate map, the distance-2 coloring, the probe schedule and the
    placement indices are host numpy in both packages: equal."""
    pool, agg, n_agg, dvec = _plan_inputs(problem, modes)
    assert n_agg == 8
    ref_pool = ref_pooling.make_lattice_pool(problem["ref_mesh"].structure, pool.n_agg)
    np.testing.assert_array_equal(agg, ref_pool.agg_host())
    conn = problem["mesh"].conn_host
    ref = ref_ml._probe_plan(problem["ref_mesh"].conn_host, agg, n_agg, modes, dvec)
    port = ml._probe_plan(conn, agg, n_agg, modes, dvec)
    for name, p, r in zip(("color", "Bn", "d", "cm", "src", "dst", "nc"), port, ref):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r), err_msg=name)


def test_probed_coarse_matrix_matches_reference(problem):
    pool, agg, n_agg, dvec = _plan_inputs(problem, 6)
    ref_mat32 = RefNH(jnp.asarray(1.0, jnp.float32), jnp.asarray(0.6, jnp.float32))
    ref_Ac = np.asarray(ref_ml._device_coarse_matrix_probing(
        problem["ref_soa"], ref_mat32, problem["ref_bc"].free_mask,
        problem["ref_mesh"].coords_host, agg, dvec, n_agg, 6,
        problem["ref_mesh"].conn_host,
        pool=ref_pooling.make_lattice_pool(problem["ref_mesh"].structure, pool.n_agg),
    ))
    mesh, soa = problem["mesh"], problem["soa"]
    color, Bn, d, cm, src, dst, nc = ml._probe_plan(mesh.conn_host, agg, n_agg, 6, dvec)
    free32 = problem["bc"].free_mask.to(torch.float32)
    state0 = ml.soa_freeze(soa, problem["mat"], torch.zeros((3, mesh.n_nodes)))
    Z = ml._probe_run(soa, state0, free32, torch.tensor(Bn), torch.tensor(d),
                      torch.tensor(color[agg]), cm, 6, pool)
    Ac = ml._assemble_dense_coarse(Z.reshape(-1), torch.tensor(src), torch.tensor(dst), nc)
    assert Ac.dtype == torch.float32 and torch.equal(Ac, Ac.T)
    np.testing.assert_allclose(Ac.numpy(), ref_Ac, rtol=0, atol=1e-5 * np.abs(ref_Ac).max())


@pytest.mark.parametrize("modes", [3, 6])
def test_coarse_apply_matches_reference(problem, modes):
    ref = ref_ml.build_coarse_space(problem["ref_mesh"], problem["ref_mat"], problem["ref_bc"],
                                    modes=modes, soa=problem["ref_soa"])
    port = ml.build_coarse_space(problem["mesh"], problem["mat"], problem["bc"],
                                 modes=modes, soa=problem["soa"])
    assert port.n_agg == ref.n_agg and port.modes == ref.modes
    np.testing.assert_array_equal(port.pool.agg_host(), np.asarray(ref.agg))
    assert port.acinv.dtype == torch.float32
    assert torch.equal(port.acinv, port.acinv.T)
    rng = np.random.default_rng(3)
    r = (rng.standard_normal((problem["mesh"].n_nodes, 3))
         * np.asarray(problem["ref_bc"].free_mask)).astype(np.float32)
    za = np.asarray(ref.apply(jnp.asarray(r)))
    zp = port.apply(torch.tensor(r)).numpy()
    np.testing.assert_allclose(zp, za, rtol=0, atol=1e-5 * np.abs(za).max())
    np.testing.assert_allclose(port.restrict(torch.tensor(r)).numpy(),
                               np.asarray(ref.restrict(jnp.asarray(r))), rtol=1e-5, atol=1e-5)


def test_build_coarse_space_rejects_unported_paths(problem):
    with pytest.raises(NotImplementedError):
        ml.build_coarse_space(problem["mesh"], problem["mat"], problem["bc"], modes=12,
                              soa=problem["soa"])
    with pytest.raises(NotImplementedError):
        ml.build_coarse_space(problem["mesh"], problem["mat"], problem["bc"], modes=6)


def test_build_coarse_space_rejects_bad_modes_as_the_reference(problem):
    """Modes outside (3, 6, 12) are a ValueError in both packages."""
    with pytest.raises(ValueError, match="3, 6 or 12"):
        ml.build_coarse_space(problem["mesh"], problem["mat"], problem["bc"], modes=5,
                              soa=problem["soa"])
    with pytest.raises(ValueError, match="3, 6 or 12"):
        ref_ml.build_coarse_space(problem["ref_mesh"], problem["ref_mat"], problem["ref_bc"],
                                  modes=5)
