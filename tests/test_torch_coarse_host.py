"""PyTorch port: the host coarse builders of the two-level preconditioner
(`_host_k0_csr`, `_prolongator_csr`, `_host_coarse_matrix`,
`_host_coarse_matrix_rbm`, `_host_coarse_matrix_reference`,
`_coarse_entry_chunks`, `_host_invert_coarse`, and `build_coarse_space`
with `soa=None`) against the JAX reference
(`fea_large_tpu/solvers/multilevel.py`), on 5-tet TET4 and TET10 boxes 3^3.

Tolerances: the host builders are f64 numpy in both packages, 1e-12 of the
largest entry (the sparsity pattern exactly equal); the port's f32 probing
against its f64 host matrix 2e-5 of the largest entry, the reference test's
bound (tests/test_multilevel.py); the explicit f32 inverses 5e-5 of the
largest entry (f32 Cholesky of a ridged SPD matrix, the reference test's
bound for the host route), and the coarse apply 1e-5 of the largest entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.solvers import multilevel as ref_ml

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.ops.soa import SoAProblem
from fea_large_tpu_torch.solvers import multilevel as ml

torch.set_num_threads(2)

LAM, MU = 1.0, 0.6
F64_BOUND = 1e-12
PROBE_BOUND = 2e-5
INV_BOUND = 5e-5


def _close(port, ref, bound):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= bound * np.abs(ref).max()


class _Box:
    def __init__(self, et, n=3, agg_size=40):
        self.ref_mesh = ref_box_mesh(n, n, n, element_type=et)
        self.mesh = box_mesh(n, n, n, element_type=et, device="cpu")
        self.ref_bc = RefDirichletBuilder(self.ref_mesh).fix("zmin").prescribe(
            "zmax", "z", -0.05).build()
        self.bc = DirichletBuilder(self.mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
        self.free = self.bc.free_mask.numpy()
        np.testing.assert_array_equal(self.free, np.asarray(self.ref_bc.free_mask))
        coords = self.mesh.coords_host
        self.agg = ml.aggregate_nodes(coords, agg_size)
        np.testing.assert_array_equal(self.agg, ref_ml.aggregate_nodes(coords, agg_size))
        self.n_agg = int(self.agg.max()) + 1
        cnt = np.bincount(self.agg, minlength=self.n_agg).astype(float)
        cent = np.stack([np.bincount(self.agg, weights=coords[:, d], minlength=self.n_agg) / cnt
                         for d in range(3)], axis=1)
        self.dvec = ml._rbm_dvec(coords, self.agg, cent, self.n_agg)


@pytest.fixture(scope="module", params=["tet4", "tet10"])
def box(request):
    return _Box(request.param)


def test_host_k0_csr_matches_reference(box):
    K = ml._host_k0_csr(box.mesh, LAM, MU, box.free)
    R = ref_ml._host_k0_csr(box.ref_mesh, LAM, MU, box.free)
    np.testing.assert_array_equal(K.indptr, R.indptr)
    np.testing.assert_array_equal(K.indices, R.indices)
    _close(K.data, R.data, F64_BOUND)
    assert K.shape == (box.mesh.n_dof, box.mesh.n_dof)
    # symmetric, and fixed DOFs have empty rows
    assert abs(K - K.T).max() <= 1e-13 * abs(K).max()
    fixed = np.nonzero(box.free.reshape(-1) == 0)[0]
    assert K[fixed].nnz == 0


@pytest.mark.parametrize("modes", [3, 6])
def test_prolongator_csr_matches_reference(box, modes):
    dvec = box.dvec if modes == 6 else None
    P = ml._prolongator_csr(box.mesh.coords_host, box.agg, box.n_agg, modes, dvec)
    R = ref_ml._prolongator_csr(box.mesh.coords_host, box.agg, box.n_agg, modes, dvec)
    assert P.shape == R.shape == (box.mesh.n_dof, modes * box.n_agg)
    np.testing.assert_array_equal(P.toarray(), R.toarray())


def test_host_coarse_matrices_match_reference(box):
    args = (LAM, MU, box.agg, box.n_agg, box.free)
    A3 = ml._host_coarse_matrix(box.mesh, *args)
    _close(A3, ref_ml._host_coarse_matrix(box.ref_mesh, *args), F64_BOUND)
    _close(ml._host_coarse_matrix_reference(box.mesh, *args),
           ref_ml._host_coarse_matrix_reference(box.ref_mesh, *args), F64_BOUND)
    # the Galerkin product and the direct assembly are one matrix
    _close(A3, ml._host_coarse_matrix_reference(box.mesh, *args), F64_BOUND)
    A6 = ml._host_coarse_matrix_rbm(box.mesh, LAM, MU, box.agg, box.dvec, box.n_agg, box.free)
    _close(A6, ref_ml._host_coarse_matrix_rbm(box.ref_mesh, LAM, MU, box.agg, box.dvec,
                                               box.n_agg, box.free), F64_BOUND)
    # a K0 given by the caller is the same product
    K = ml._host_k0_csr(box.mesh, LAM, MU, box.free)
    assert np.array_equal(ml._host_coarse_matrix_rbm(box.mesh, LAM, MU, box.agg, box.dvec,
                                                     box.n_agg, box.free, k0=K), A6)


def test_coarse_entry_chunks_match_reference(box):
    """The factored per-element aggregate blocks, chunk by chunk (a chunk
    smaller than the mesh), and their sum is the translations' Ac."""
    chunk = box.mesh.n_elements // 2 + 1
    port = list(ml._coarse_entry_chunks(box.mesh, LAM, MU, box.agg, box.free, chunk=chunk))
    ref = list(ref_ml._coarse_entry_chunks(box.ref_mesh, LAM, MU, box.agg, box.free, chunk=chunk))
    assert len(port) == len(ref) == 2
    nc3 = 3 * box.n_agg
    Ac = np.zeros((box.n_agg, 3, box.n_agg, 3))
    for (sa, blk, pv), (rsa, rblk, rpv) in zip(port, ref):
        np.testing.assert_array_equal(sa, rsa)
        np.testing.assert_array_equal(pv, rpv)
        _close(blk, rblk, F64_BOUND)
        e, ns = sa.shape
        for s in range(ns):
            for t in range(ns):
                np.add.at(Ac, (sa[:, s], slice(None), sa[:, t]), blk[:, s, t] * pv[:, s, t, None, None])
    _close(Ac.reshape(nc3, nc3),
           ml._host_coarse_matrix(box.mesh, LAM, MU, box.agg, box.n_agg, box.free), 1e-11)


@pytest.mark.parametrize("modes", [3, 6])
def test_probing_matches_host_coarse_matrix(box, modes):
    """The f32 probing assembly on the device (here the CPU) against the
    f64 host Galerkin product of the same aggregates."""
    mesh = box.mesh
    dvec = box.dvec if modes == 6 else None
    soa = SoAProblem.build(mesh, torch.float32)
    pool = ml.AggregateTransfer.build(box.agg, "cpu")
    color, Bn, d, cm, src, dst, nc = ml._probe_plan(mesh.conn_host, box.agg, box.n_agg, modes, dvec)
    state0 = ml.soa_freeze(soa, NeoHookean(LAM, MU), torch.zeros((3, mesh.n_nodes)))
    Z = ml._probe_run(soa, state0, box.bc.free_mask.to(torch.float32), torch.tensor(Bn),
                      torch.tensor(d), torch.tensor(color[box.agg]), cm, modes, pool)
    Ac = ml._assemble_dense_coarse(Z.reshape(-1), torch.tensor(src), torch.tensor(dst), nc)
    if modes == 3:
        host = ml._host_coarse_matrix(mesh, LAM, MU, box.agg, box.n_agg, box.free)
    else:
        host = ml._host_coarse_matrix_rbm(mesh, LAM, MU, box.agg, box.dvec, box.n_agg, box.free)
    _close(Ac.numpy(), host, PROBE_BOUND)


@pytest.mark.parametrize("modes", [3, 6])
def test_host_build_coarse_space_matches_reference(box, modes):
    ref = ref_ml.build_coarse_space(box.ref_mesh, RefNH(jnp.asarray(LAM), jnp.asarray(MU)),
                                    box.ref_bc, agg_size=40, modes=modes)
    port = ml.build_coarse_space(box.mesh, NeoHookean(LAM, MU), box.bc, agg_size=40, modes=modes)
    assert port.n_agg == ref.n_agg == box.n_agg and port.modes == ref.modes
    np.testing.assert_array_equal(port.pool.agg_host(), np.asarray(ref.agg))
    assert port.acinv.dtype == torch.float32 and port.setup["invert"] == "device"
    assert port.setup["host_s"] > 0.0 and port.setup["device_s"] > 0.0
    _close(port.acinv.numpy(), np.asarray(ref.acinv), INV_BOUND)
    r = (np.random.default_rng(3).standard_normal((box.mesh.n_nodes, 3)) * box.free).astype(np.float32)
    za = np.asarray(ref.apply(jnp.asarray(r)))
    _close(port.apply(torch.tensor(r)).numpy(), za, 1e-5)


@pytest.mark.parametrize("soa", [False, True], ids=["host_Ac", "probed_Ac"])
def test_host_inverse_matches_device_inverse(box, soa, monkeypatch):
    """FEA_COARSE_INVERT=host: LAPACK's factor and triangular inverse on
    the host, the Gram product on the mesh's device, against the device
    build; for the host and the probed Ac."""
    mat = NeoHookean(LAM, MU)
    kw = dict(agg_size=40, modes=6, soa=SoAProblem.build(box.mesh, torch.float32) if soa else None)
    dev = ml.build_coarse_space(box.mesh, mat, box.bc, **kw)
    monkeypatch.setenv("FEA_COARSE_INVERT", "host")
    host = ml.build_coarse_space(box.mesh, mat, box.bc, **kw)
    assert host.setup["invert"] == "host" and dev.setup["invert"] == "device"
    _close(host.acinv.numpy(), dev.acinv.numpy(), INV_BOUND)
    assert torch.equal(host.acinv, host.acinv.T)


def test_device_out_of_memory_falls_back_to_the_host_inverse(box, monkeypatch, capsys):
    """An out-of-memory error of the device inverse build takes the host
    route and says so on stderr (never silently)."""
    soa = SoAProblem.build(box.mesh, torch.float32)
    mat = NeoHookean(LAM, MU)
    want = ml.build_coarse_space(box.mesh, mat, box.bc, agg_size=40, modes=6, soa=soa)
    capsys.readouterr()

    def oom(_):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(ml, "_ridge_and_factor", oom)
    got = ml.build_coarse_space(box.mesh, mat, box.bc, agg_size=40, modes=6, soa=soa)
    assert got.setup["invert"] == "host after device out of memory"
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "_host_invert_coarse" in err and "out of memory" in err
    _close(got.acinv.numpy(), want.acinv.numpy(), INV_BOUND)


def test_host_invert_coarse_matches_reference(box):
    A = ml._host_coarse_matrix_rbm(box.mesh, LAM, MU, box.agg, box.dvec, box.n_agg, box.free)
    port = ml._host_invert_coarse(A, torch.device("cpu"))
    ref = np.asarray(ref_ml._host_invert_coarse(A, jnp.float32))
    assert port.dtype == torch.float32
    _close(port.numpy(), ref, INV_BOUND)
