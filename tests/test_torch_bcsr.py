"""PyTorch port: the modules of the f64 assembled path against the JAX
reference, on CPU: element geometry, internal force and stiffness
(`fea_large_tpu/elements/kernels.py`), the node scatter
(`assembly/scatter.py`), the BCSR structure, assembly and product
(`assembly/bcsr.py`) and the BCSR SpMV B10 (`ops/pallas_kernels.py::
bcsr_spmv_pallas`, run in interpret mode as tests/test_pallas.py runs it).

Tolerances: the BCSR index arrays are host numpy in both packages and must
be equal; every f64 value agrees to 1e-12 relative to the largest entry
(both f64, summed in another order). On the card, B10 holds against its
plain version to 1e-12 in f64 and 2e-5 in f32 (rounding in another
summation order), and skips without CUDA
(`python -m pytest --noconftest -k on_card tests/test_torch_bcsr.py`).
"""

import numpy as np
import pytest
import torch

from fea_large_tpu_torch.assembly import bcsr as port_bcsr
from fea_large_tpu_torch.assembly.bcsr import BCSRMatrix, BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements import kernels as ek
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.ops import bcsr_kernels as bk

torch.set_num_threads(2)

BOXES = [("tet4", (3, 2, 2)), ("tet10", (2, 2, 1))]
MATERIALS = [("svk", StVenantKirchhoff), ("nh", NeoHookean), ("nh_vol", NeoHookeanVolumetric)]


def _close(port, ref, tol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fea_large_tpu.assembly import bcsr, scatter
    from fea_large_tpu.elements import kernels
    from fea_large_tpu.materials.neo_hookean import NeoHookean, NeoHookeanVolumetric
    from fea_large_tpu.materials.svk import StVenantKirchhoff
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh

    return dict(jnp=jnp, bcsr=bcsr, scatter=scatter, kernels=kernels, box_mesh=ref_box_mesh,
                svk=StVenantKirchhoff, nh=NeoHookean, nh_vol=NeoHookeanVolumetric)


class _Case:
    """One box in both packages, a displacement field u and a vector x."""

    def __init__(self, ref, et, cells):
        jnp = ref["jnp"]
        self.rmesh = ref["box_mesh"](*cells, element_type=et)
        self.mesh = box_mesh(*cells, element_type=et, device="cpu")
        rng = np.random.default_rng(7)
        self.u = 0.03 * rng.standard_normal((self.mesh.n_nodes, 3))
        self.u[:, 2] -= 0.05 * self.mesh.coords_host[:, 2]
        self.x = rng.standard_normal((self.mesh.n_nodes, 3))
        self.rgeom = ref["kernels"].precompute_geometry(
            self.rmesh.coords, self.rmesh.conn, self.rmesh.element)
        self.geom = ek.precompute_geometry(self.mesh.coords, self.mesh.conn, self.mesh.element)
        self.rue = jnp.asarray(self.u)[self.rmesh.conn]
        self.ue = torch.tensor(self.u)[self.mesh.conn]


@pytest.fixture(scope="module", params=BOXES, ids=[b[0] for b in BOXES])
def case(ref, request):
    return _Case(ref, *request.param)


def _materials(ref, kind, port_cls):
    jnp = ref["jnp"]
    return ref[kind](jnp.asarray(1.0), jnp.asarray(0.6)), port_cls(1.0, 0.6)


def test_geometry_matches_reference(ref, case):
    _close(case.geom.gradN, case.rgeom.gradN)
    _close(case.geom.detJxW, case.rgeom.detJxW)
    _close(ek.deformation_gradient(case.ue, case.geom.gradN),
           ref["kernels"].deformation_gradient(case.rue, case.rgeom.gradN))


@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_internal_force_and_stiffness_match_reference(ref, case, kind, port_cls):
    rmat, mat = _materials(ref, kind, port_cls)
    _close(ek.element_internal_force(case.ue, case.geom, mat),
           ref["kernels"].element_internal_force(case.rue, case.rgeom, rmat))
    Ke, fe = ek.element_stiffness(case.ue, case.geom, mat)
    Ke_r, fe_r = ref["kernels"].element_stiffness(case.rue, case.rgeom, rmat)
    _close(Ke, Ke_r)
    _close(fe, fe_r)


def test_node_scatter_matches_reference(ref, case):
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((case.mesh.n_elements, case.mesh.conn.shape[1], 3, 3))
    rs = ref["scatter"].NodeScatter.build(case.rmesh.conn_host, case.rmesh.n_nodes)
    ps = NodeScatter.build(case.mesh.conn_host, case.mesh.n_nodes, "cpu")
    _close(ps(torch.tensor(vals)), rs(ref["jnp"].asarray(vals)))
    assert torch.equal(ps(torch.tensor(vals)), ps(torch.tensor(vals)))


def test_bcsr_structure_equals_reference(ref, case):
    rs = ref["bcsr"].BCSRStructure.build(case.rmesh.conn_host, case.rmesh.n_nodes)
    ps = BCSRStructure.build(case.mesh.conn_host, case.mesh.n_nodes, "cpu")
    assert (ps.n_nodes, ps.nnzb) == (rs.n_nodes, rs.nnzb)
    for name in ("indptr", "indices", "row_ids"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(rs, name)))
    for name in ("perm", "segment_ids"):
        np.testing.assert_array_equal(getattr(ps, name), np.asarray(getattr(rs, name)))
    rows, cols = ps.row_ids[ps.diag_slots], ps.indices[ps.diag_slots]
    assert torch.equal(rows, torch.arange(ps.n_nodes)) and torch.equal(cols, rows)


def test_int32_index_copies_equal_the_int64_arrays(case):
    """The kernel's int32 indptr and indices are the int64 arrays the
    structure is held against the reference with."""
    ps = BCSRStructure.build(case.mesh.conn_host, case.mesh.n_nodes, "cpu")
    assert ps.indptr32.dtype == torch.int32 and ps.indices32.dtype == torch.int32
    assert ps.indptr32.is_contiguous() and ps.indices32.is_contiguous()
    assert torch.equal(ps.indptr32.long(), ps.indptr)
    assert torch.equal(ps.indices32.long(), ps.indices)


@pytest.mark.parametrize("n_nodes,nnzb,ok", [
    (2**31 - 1, 2**31 - 1, True), (342_361, 9_184_321, True),
    (2**31, 10, False), (10, 2**31, False),
], ids=["at-limit", "full-width", "rows-over", "blocks-over"])
def test_int32_size_limit(n_nodes, nnzb, ok):
    """`BCSRStructure.build` calls this on its sizes before it makes the
    int32 copies; checked on the sizes, not by building such a mesh."""
    if ok:
        port_bcsr.check_int32_sizes(n_nodes, nnzb)
    else:
        with pytest.raises(ValueError, match="int32"):
            port_bcsr.check_int32_sizes(n_nodes, nnzb)


@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_assemble_bcsr_matches_reference(ref, case, kind, port_cls):
    rmat, mat = _materials(ref, kind, port_cls)
    jnp = ref["jnp"]
    rs = ref["bcsr"].BCSRStructure.build(case.rmesh.conn_host, case.rmesh.n_nodes)
    rK, rf = ref["bcsr"].assemble_bcsr(
        jnp.asarray(case.u), case.rmesh.conn, case.rgeom, rmat, rs,
        ref["scatter"].NodeScatter.build(case.rmesh.conn_host, case.rmesh.n_nodes))
    ps = BCSRStructure.build(case.mesh.conn_host, case.mesh.n_nodes, "cpu")
    K, f = assemble_bcsr(torch.tensor(case.u), case.mesh.conn, case.geom, mat, ps,
                         NodeScatter.build(case.mesh.conn_host, case.mesh.n_nodes, "cpu"))
    _close(K.data, rK.data)
    _close(f, rf)
    _close(K.block_diagonal(), rK.block_diagonal())
    _close(K.to_dense(), rK.to_dense())
    _close(K.matvec(torch.tensor(case.x)), rK.matvec(jnp.asarray(case.x)))


def test_spmv_plain_matches_matvec_and_pallas(ref):
    """`bcsr_spmv_plain` against `BCSRMatrix.matvec` and the Pallas SpMV in
    interpret mode (block_k=256, as tests/test_pallas.py)."""
    from fea_large_tpu.ops.pallas_kernels import bcsr_spmv_pallas

    case = _Case(ref, "tet4", (3, 2, 2))
    jnp = ref["jnp"]
    rmat, mat = _materials(ref, "svk", StVenantKirchhoff)
    rs = ref["bcsr"].BCSRStructure.build(case.rmesh.conn_host, case.rmesh.n_nodes)
    rK, _ = ref["bcsr"].assemble_bcsr(
        jnp.asarray(case.u), case.rmesh.conn, case.rgeom, rmat, rs,
        ref["scatter"].NodeScatter.build(case.rmesh.conn_host, case.rmesh.n_nodes))
    ps = BCSRStructure.build(case.mesh.conn_host, case.mesh.n_nodes, "cpu")
    data = torch.tensor(np.asarray(rK.data))
    y = bk.bcsr_spmv_plain(ps, data, torch.tensor(case.x))
    _close(y, rK.matvec(jnp.asarray(case.x)))
    _close(y, bcsr_spmv_pallas(rK, jnp.asarray(case.x), block_k=256))
    before = dict(bk.LAUNCHES)
    assert torch.equal(BCSRMatrix(ps, data).matvec(torch.tensor(case.x)), y)
    assert bk.LAUNCHES == before


# ---------------------------------------------------------------------------
# kernel vs plain version on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12), (torch.float32, 2e-5)],
                         ids=["f64", "f32"])
def test_spmv_kernel_matches_plain_on_card(dtype, bound):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a")
    # 5-tet TET10 box: rows of 10 to 65 blocks; 2,475 nodes = 19*128 + 43
    mesh = box_mesh(6, 5, 3, element_type="tet10", device="cuda")
    ps = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cuda")
    geom = ek.precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    rng = np.random.default_rng(5)
    u = torch.tensor(0.03 * rng.standard_normal((mesh.n_nodes, 3)), device="cuda")
    K, _ = assemble_bcsr(u, mesh.conn, geom, NeoHookean(1.0, 0.6), ps,
                         NodeScatter.build(mesh.conn_host, mesh.n_nodes, "cuda"))
    data = K.data.to(dtype).contiguous()
    x = torch.tensor(rng.standard_normal((mesh.n_nodes, 3)), dtype=dtype, device="cuda")
    n0 = bk.LAUNCHES["spmv"]
    y = bk.bcsr_spmv(ps, data, x)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["spmv"] == n0 + 1
    plain = bk.bcsr_spmv_plain(ps, data, x)
    assert float((y - plain).abs().max()) <= bound * float(plain.abs().max())


def _rows_structure(lengths, device):
    """A BCSR structure with the given row lengths (columns r, r+1, ...
    wrapped) and only the fields the product reads."""
    import types

    from fea_large_tpu_torch.ops.soa import ScatterBuckets

    n = len(lengths)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    cols = np.concatenate([(r + np.arange(k)) % n for r, k in enumerate(lengths)])
    rows = np.repeat(np.arange(n), lengths)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return types.SimpleNamespace(
        n_nodes=n, nnzb=int(indptr[-1]), indptr=t(indptr, torch.int64),
        indices=t(cols, torch.int64), indptr32=t(indptr, torch.int32),
        indices32=t(cols, torch.int32), row_buckets=ScatterBuckets.from_flat(rows, n, device))


def test_rows_structure_plain_product_matches_dense():
    """The synthetic rows the card test uses give the dense product on CPU."""
    st = _rows_structure([1, 3, 8, 16, 33, 70, 2], "cpu")
    rng = np.random.default_rng(2)
    data = torch.tensor(rng.standard_normal((st.nnzb, 3, 3)))
    x = torch.tensor(rng.standard_normal((st.n_nodes, 3)))
    K = torch.zeros(st.n_nodes, 3, st.n_nodes, 3, dtype=torch.float64)
    rows = torch.repeat_interleave(torch.arange(st.n_nodes), st.indptr[1:] - st.indptr[:-1])
    # a row longer than n wraps onto columns it already has: those blocks add
    K.index_put_((rows[:, None, None], torch.arange(3)[None, :, None], st.indices[:, None, None],
                  torch.arange(3)[None, None, :]), data, accumulate=True)
    dense = (K.reshape(3 * st.n_nodes, -1) @ x.reshape(-1)).reshape(-1, 3)
    _close(bk.bcsr_spmv(st, data, x), dense)


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12), (torch.float32, 2e-5)],
                         ids=["f64", "f32"])
def test_spmv_kernel_row_lengths_on_card(dtype, bound):
    """Rows shorter than L, equal to L and longer than 4L, a row count that
    fills no CUDA block, and two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a")
    lanes = bk.LANES
    lengths = [1, lanes - 1, lanes, lanes + 1, 2 * lanes, 4 * lanes + 3, 7 * lanes, 2] * 5 + [3]
    st = _rows_structure(lengths, "cuda")
    rng = np.random.default_rng(11)
    data = torch.tensor(rng.standard_normal((st.nnzb, 3, 3)), dtype=dtype, device="cuda")
    x = torch.tensor(rng.standard_normal((st.n_nodes, 3)), dtype=dtype, device="cuda")
    y = bk.bcsr_spmv(st, data, x)
    again = bk.bcsr_spmv(st, data, x)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    plain = bk.bcsr_spmv_plain(st, data, x)
    assert float((y - plain).abs().max()) <= bound * float(plain.abs().max())
