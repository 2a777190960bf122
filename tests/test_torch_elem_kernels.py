"""PyTorch port: the plain versions of the three element-block kernels
(`fea_large_tpu_torch/ops/elem_kernels.py`) against the reference's Pallas
kernels (`fea_large_tpu/ops/pallas_kernels.py`: `pallas_element_apply`,
`pallas_freeze`, `pallas_internal_force`) in interpret mode, as
tests/test_pallas.py runs them, on 5-tet boxes whose element count is not a
multiple of the block (E = 15 TET4 and 20 TET10 elements, blocks of 8).

The tolerance is f32 2e-5 relative and absolute (the bound of bench.py's
kernel check): both sides compute in f32 with different summation orders.

The CUDA kernels run only on a GPU: the `*_on_card` tests hold each against
its plain version there and skip on a machine without CUDA. The reference
is imported inside a fixture, so that the card tests also run where JAX is
not installed:
`python -m pytest --noconftest -k on_card tests/test_torch_elem_kernels.py`.
"""

import numpy as np
import pytest
import torch

from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import soa

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
BOXES = {"tet4": (3, 1, 1), "tet10": (2, 2, 1)}  # 15 and 20 elements
MATERIALS = [("svk", StVenantKirchhoff), ("nh", NeoHookean), ("nh_vol", NeoHookeanVolumetric)]


def _fields(n_nodes, seed=9):
    rng = np.random.default_rng(seed)
    return 0.03 * rng.standard_normal((3, n_nodes)), rng.standard_normal((3, n_nodes))


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's modules (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fea_large_tpu.materials.neo_hookean import NeoHookean, NeoHookeanVolumetric
    from fea_large_tpu.materials.svk import StVenantKirchhoff
    from fea_large_tpu.ops import pallas_kernels, soa as ref_soa

    return dict(jnp=jnp, svk=StVenantKirchhoff, nh=NeoHookean, nh_vol=NeoHookeanVolumetric,
                pk=pallas_kernels, soa=ref_soa)


def _inputs(et):
    """The flattened kernel inputs of a 5-tet box, as numpy (f32)."""
    p = soa.SoAProblem.build(box_mesh(*BOXES[et], element_type=et, device="cpu"), torch.float32)
    q, npe, _, E = p.gradN.shape
    u, v = _fields(p.n_nodes)
    ue = ek._gather_flat(p, torch.tensor(u, dtype=torch.float32))
    ve = ek._gather_flat(p, torch.tensor(v, dtype=torch.float32))
    state = soa.soa_freeze(p, NeoHookean(1.0, 0.6), torch.tensor(u, dtype=torch.float32))
    assert E % 8 != 0
    return dict(p=p, q=q, npe=npe, ue=ue, ve=ve, gradN=p.gradN.view(q * npe * 3, E),
                detJxW=p.detJxW, state=ek.flatten_state(state))


def _j(ref, x):
    return ref["jnp"].asarray(x.numpy())


@pytest.mark.parametrize("et", ["tet4", "tet10"])
def test_plain_apply_matches_pallas(ref, et):
    x = _inputs(et)
    port = ek.elem_apply_plain(x["ve"], x["gradN"], x["detJxW"], *x["state"], npe=x["npe"], q=x["q"])
    out = ref["pk"].pallas_element_apply(
        _j(ref, x["ve"]), _j(ref, x["gradN"]), _j(ref, x["detJxW"]),
        *(_j(ref, s) for s in x["state"]), npe=x["npe"], q=x["q"], block_e=8)
    np.testing.assert_allclose(port.numpy(), np.asarray(out), **TOL)


@pytest.mark.parametrize("et", ["tet4", "tet10"])
def test_plain_force_matches_pallas(ref, et):
    x = _inputs(et)
    F, S = x["state"][:2]
    port = ek.elem_force_plain(x["gradN"], x["detJxW"], F, S, npe=x["npe"], q=x["q"])
    out = ref["pk"].pallas_internal_force(_j(ref, x["gradN"]), _j(ref, x["detJxW"]), _j(ref, F),
                                          _j(ref, S), npe=x["npe"], q=x["q"], block_e=8)
    np.testing.assert_allclose(port.numpy(), np.asarray(out), **TOL)


@pytest.mark.parametrize("et", ["tet4", "tet10"])
@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_plain_freeze_matches_pallas(ref, et, kind, port_cls):
    jnp = ref["jnp"]
    x = _inputs(et)
    mat = port_cls(1.1, 0.8)
    port = ek.elem_freeze_plain(x["ue"], x["gradN"], mat, npe=x["npe"], q=x["q"])
    out = ref["pk"].pallas_freeze(_j(ref, x["ue"]), _j(ref, x["gradN"]),
                                  jnp.asarray(1.1, jnp.float32), jnp.asarray(0.8, jnp.float32),
                                  npe=x["npe"], q=x["q"], kind=ek._material_kind(mat), block_e=8)
    assert ref["pk"]._material_kind(ref[kind](jnp.asarray(1.1), jnp.asarray(0.8))) == mat.kind
    for name, p, r in zip(("F", "S", "A", "alpha", "beta"), port, out):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_unstructured_passes_route_f32_through_the_wrappers(monkeypatch):
    """The f32 unstructured passes of ops/soa.py call the kernel wrappers,
    which launch on CUDA tensors and run the plain version on CPU tensors
    (bitwise here, with no launch counted); the f64 passes call the plain
    versions. Every nodal sum, f32 and f64, goes through `ek.nodal_sum`,
    which on the CPU is the buckets' sum (`ScatterBuckets.apply`). A Kuhn
    lattice never reaches the element-block wrappers nor the buckets."""
    calls = []
    for name in ("elem_freeze", "elem_apply", "elem_force", "elem_diag", "nodal_sum"):
        wrapper = getattr(ek, name)
        monkeypatch.setattr(ek, name, lambda *a, _w=wrapper, _n=name, **k: (calls.append(_n), _w(*a, **k))[1])
    bucket_sum = soa.ScatterBuckets.apply
    monkeypatch.setattr(soa.ScatterBuckets, "apply",
                        lambda self, d: (calls.append("apply"), bucket_sum(self, d))[1])
    summed = ["nodal_sum", "apply"]
    before = dict(ek.LAUNCHES)
    mat = NeoHookean(1.0, 0.6)
    for dtype in (torch.float32, torch.float64):
        p = soa.SoAProblem.build(box_mesh(2, 2, 1, element_type="tet10", device="cpu"), dtype)
        q, npe, gradN, dV = ek.flat_tables(p)
        u, v = (torch.tensor(a, dtype=dtype) for a in _fields(p.n_nodes))
        st = soa.soa_freeze(p, mat, u)
        rows = ek.elem_freeze_plain(ek._gather_flat(p, u), gradN, mat, npe=npe, q=q)
        for name, a, b in zip(("F", "S", "A", "alpha", "beta"), ek.flatten_state(st), rows):
            assert torch.equal(a, b), name
        ke = ek.elem_apply_plain(ek._gather_flat(p, v), gradN, dV, *rows, npe=npe, q=q)
        assert torch.equal(soa.soa_apply_tangent(p, st, v), soa.soa_scatter(p, ke.view(3, npe, -1)))
        fe = ek.elem_force_plain(gradN, dV, *rows[:2], npe=npe, q=q)
        assert torch.equal(soa.soa_internal_force(p, st), soa.soa_scatter(p, fe.view(3, npe, -1)))
        de = ek.elem_diag_plain(gradN, dV, *rows, p.buckets, npe=npe, q=q)
        assert torch.equal(soa.soa_diag_blocks(p, st), de)
        if dtype == torch.float32:
            assert calls == ["elem_freeze", "elem_apply", *summed, *summed, "elem_force",
                             *summed, *summed, "apply", "elem_diag", "apply"]
        else:
            assert calls == [*summed * 4, "apply", "apply"]
        calls.clear()
    p = soa.SoAProblem.build(box_mesh_kuhn(2, 2, 1, element_type="tet10", device="cpu"), torch.float32)
    st = soa.soa_freeze(p, mat, torch.zeros((3, p.n_nodes)))
    soa.soa_apply_tangent(p, st, torch.ones((3, p.n_nodes)))
    soa.soa_internal_force(p, st)
    soa.soa_diag_blocks(p, st)
    assert calls == [] and ek.LAUNCHES == before


def test_nodal_table_lists_each_nodes_bucket_entries_in_their_order():
    """`ScatterBuckets.csr`, the nodal sums' table, holds for every node the
    real entries of its bucket row in the row's order: on a box that is the
    stable sort of the flat slots by node (`host_build`'s own order), and
    on a shard's stacked buckets (mask-0 padding rows, padded elements) the
    same walk of its rows. `conn32` is conn_T in int32; a problem built
    with `share_maps_from` shares it and the table."""
    from fea_large_tpu_torch.dist.partition import partition_mesh
    from fea_large_tpu_torch.dist.sharded import shard_soa

    mesh = box_mesh(4, 3, 2, element_type="tet10", device="cpu")
    p = soa.SoAProblem.build(mesh, torch.float32)
    flat = p.conn_T.reshape(-1).numpy()
    offsets, ids, span = p.buckets.csr
    assert offsets.dtype == ids.dtype == p.conn32.dtype == torch.int32
    assert torch.equal(p.conn32.long(), p.conn_T) and span == flat.size
    np.testing.assert_array_equal(ids.numpy(), np.argsort(flat, kind="stable"))
    np.testing.assert_array_equal(np.diff(offsets.numpy()), np.bincount(flat, minlength=p.n_nodes))
    p64 = soa.SoAProblem.build(mesh, torch.float64, share_maps_from=p)
    assert p64.conn32 is p.conn32 and p64.buckets.csr is p.buckets.csr
    sharded = box_mesh(5, 2, 2, element_type="tet4", device="cpu")
    part = partition_mesh(sharded, 3, method="slab")
    r = int(np.argmin((part.elem_global >= 0).sum(axis=1)))
    shard = shard_soa(sharded, part, r, "cpu", mixed=True)
    assert shard.p32.conn32 is shard.p64.conn32 and (part.elem_global[r] < 0).any()
    b = shard.p32.buckets
    assert sum(int((m.sum(1) == 0).sum()) for m in b.mask) > 0
    offsets, ids, _ = b.csr
    rows = [(i, m) for idx, mask in zip(b.idx, b.mask) for i, m in zip(idx, mask)]
    for n in range(shard.p32.n_nodes):
        i, m = rows[int(b.inv[n])]
        assert torch.equal(ids[offsets[n]:offsets[n + 1]].long(), i[m != 0])


def test_unstructured_diag_routes_f32_to_the_kernel_on_card(monkeypatch):
    """On the card the f32 unstructured diagonal reaches `ek.elem_diag`,
    which launches (one count of `LAUNCHES["diag"]`) and runs no plain
    pass; the f64 diagonal stays plain and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    plain = []
    wrapped = ek.elem_diag_plain
    monkeypatch.setattr(ek, "elem_diag_plain", lambda *a, **k: (plain.append(1), wrapped(*a, **k))[1])
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cuda")
    u, _ = _smooth(mesh.coords_host)
    for dtype in (torch.float32, torch.float64):
        p = soa.SoAProblem.build(mesh, dtype)
        st = soa.soa_freeze(p, NeoHookean(1.0, 0.6), torch.tensor(u, dtype=dtype, device="cuda"))
        n0 = ek.LAUNCHES["diag"]
        out = soa.soa_diag_blocks(p, st)
        torch.cuda.synchronize()
        assert out.shape == (3, 3, p.n_nodes) and out.dtype == dtype
        assert ek.LAUNCHES["diag"] == n0 + (dtype == torch.float32)
        assert plain == ([] if dtype == torch.float32 else [1])


def test_material_kind_rejects_other_materials():
    class Other(NeoHookean):
        kind = -1

    with pytest.raises(NotImplementedError):
        ek._material_kind(Other(1.0, 0.6))


# ---------------------------------------------------------------------------
# kernel vs plain version on the card
# ---------------------------------------------------------------------------


def _smooth(coords):
    """bench.py's smooth check fields u, v [3, N] (as chip_smoke.py): random
    nodal noise inverts elements of the TET10 box, where f32 alone misses
    the bound (`test_card_inputs_are_well_conditioned_in_f32`)."""
    x, y, z = coords.T
    u = np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x, -0.05 * z + 0.02 * np.cos(y)])
    v = np.stack([0.01 * np.cos(y) * z, 0.02 * x * y, -0.03 * np.sin(z)])
    return u, v


def _f32_conditioning(et, fields):
    """(min det F, points with det F <= 0, worst relative gap between the
    f32 and the f64 plain versions of B6-B8) on the 3x3x3 card box."""
    mesh = box_mesh(3, 3, 3, element_type=et, device="cpu")
    u, v = _fields(mesh.n_nodes) if fields == "noise" else _smooth(mesh.coords_host)
    outs = {}
    for dt in (torch.float32, torch.float64):
        p = soa.SoAProblem.build(mesh, dt)
        q, npe, gradN, dV = ek.flat_tables(p)
        ue, ve = (ek._gather_flat(p, torch.tensor(a, dtype=dt)) for a in (u, v))
        rows = ek.elem_freeze_plain(ue, gradN, NeoHookean(1.0, 0.6), npe=npe, q=q)
        outs[dt] = [*rows, *(ek.elem_freeze_plain(ue, gradN, cls(1.0, 0.6), npe=npe, q=q)[1]
                             for cls in (StVenantKirchhoff, NeoHookeanVolumetric)),
                    ek.elem_apply_plain(ve, gradN, dV, *rows, npe=npe, q=q),
                    ek.elem_force_plain(gradN, dV, *rows[:2], npe=npe, q=q)]
    J = torch.linalg.det(outs[torch.float64][0].view(q, 3, 3, -1).permute(0, 3, 1, 2))
    gap = max(_rel(a.double(), b) for a, b in zip(outs[torch.float32], outs[torch.float64]))
    return float(J.min()), int((J <= 0).sum()), gap


@pytest.mark.parametrize("et", ["tet10", "tet4"])
@pytest.mark.parametrize("fields", ["smooth", "noise"])
def test_card_inputs_are_well_conditioned_in_f32(et, fields):
    """Two f32 computations can only be held to 2e-5 of each other where
    f32 itself is that close to f64. The smooth fields are: no inverted
    point, and f32 within 5e-6 of f64. Random nodal noise of amplitude 0.03
    inverts quadrature points of the TET10 box, where the neo-Hookean
    state loses f32 digits far beyond the bound: such inputs cannot hold a
    kernel against its plain version."""
    min_det, inverted, gap = _f32_conditioning(et, fields)
    if fields == "smooth" or et == "tet4":
        assert min_det > 0.5 and inverted == 0 and gap <= 5e-6
    else:
        assert min_det < 0 and inverted > 0 and gap > 2e-5


def _card_inputs(et, block, n_quad=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    # 5*3*3*3 = 135 elements: a partial last block for blocks of 32 and 128
    mesh = box_mesh(3, 3, 3, element_type=et, device="cuda", n_quad=n_quad)
    p = soa.SoAProblem.build(mesh, torch.float32)
    q, npe, _, E = p.gradN.shape
    assert E % block != 0
    u, v = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in _smooth(mesh.coords_host))
    state = ek.flatten_state(soa.soa_freeze(p, NeoHookean(1.0, 0.6), u))
    return p, q, npe, ek._gather_flat(p, u), v, state


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("et", ["tet10", "tet4"])
@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_elem_freeze_kernel_matches_plain_on_card(et, kind, port_cls):
    p, q, npe, ue, _, _ = _card_inputs(et, 128)
    gradN = p.gradN.view(q * npe * 3, -1)
    mat = port_cls(1.0, 0.6)
    n0 = ek.LAUNCHES["freeze"]
    out = ek.elem_freeze(ue, gradN, mat, npe=npe, q=q)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["freeze"] == n0 + 1
    for a, b in zip(out, ek.elem_freeze_plain(ue, gradN, mat, npe=npe, q=q)):
        assert _rel(a, b) <= 2e-5


@pytest.mark.parametrize("et", ["tet10", "tet4"])
@pytest.mark.parametrize("block", [32, 128])
def test_elem_apply_kernel_matches_plain_on_card(et, block):
    """B6 reads v [3, N] through the int32 connectivity itself: against the
    plain gather and `ek.elem_apply_plain`; two launches bitwise equal."""
    p, q, npe, _, v, state = _card_inputs(et, block)
    gradN = p.gradN.view(q * npe * 3, -1)
    n0 = ek.LAUNCHES["apply"]
    out = ek.elem_apply(v, p.conn32, gradN, p.detJxW, *state, npe=npe, q=q, block=block)
    again = ek.elem_apply(v, p.conn32, gradN, p.detJxW, *state, npe=npe, q=q, block=block)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["apply"] == n0 + 2 and torch.equal(out, again)
    plain = ek.elem_apply_plain(ek._gather_flat(p, v), gradN, p.detJxW, *state, npe=npe, q=q)
    assert _rel(out, plain) <= 2e-5


@pytest.mark.parametrize("et", ["tet10", "tet4"])
def test_elem_force_kernel_matches_plain_on_card(et):
    p, q, npe, _, _, state = _card_inputs(et, 128)
    gradN = p.gradN.view(q * npe * 3, -1)
    out = ek.elem_force(gradN, p.detJxW, *state[:2], npe=npe, q=q)
    torch.cuda.synchronize()
    assert _rel(out, ek.elem_force_plain(gradN, p.detJxW, *state[:2], npe=npe, q=q)) <= 2e-5


def test_five_point_rule_elem_kernels_match_plain_on_card():
    """The (q, npe) = (5, 10) instances of B6-B9 on a TET10 box with
    `n_quad=5`."""
    p, q, npe, ue, v, state = _card_inputs("tet10", 128, n_quad=5)
    assert (q, npe) == (5, 10)
    ve = ek._gather_flat(p, v)
    kw = dict(npe=npe, q=q)
    gradN = p.gradN.view(q * npe * 3, -1)
    mat = NeoHookean(1.0, 0.6)
    for a, b in zip(ek.elem_freeze(ue, gradN, mat, **kw), ek.elem_freeze_plain(ue, gradN, mat, **kw)):
        assert _rel(a, b) <= 2e-5
    assert _rel(ek.elem_apply(v, p.conn32, gradN, p.detJxW, *state, **kw),
                ek.elem_apply_plain(ve, gradN, p.detJxW, *state, **kw)) <= 2e-5
    assert _rel(ek.elem_force(gradN, p.detJxW, *state[:2], **kw),
                ek.elem_force_plain(gradN, p.detJxW, *state[:2], **kw)) <= 2e-5
    args = (ue.double(), gradN.double(), p.detJxW.double(), mat)
    assert _rel(ek.elem_resid(*args, **kw), ek.elem_resid_plain(*args, **kw)) <= 1e-12
    torch.cuda.synchronize()


@pytest.mark.parametrize("et,n_quad", [("tet10", None), ("tet10", 5), ("tet4", None)],
                         ids=["tet10", "tet10-5pt", "tet4"])
@pytest.mark.parametrize("block", [32, 128])
def test_elem_diag_kernel_matches_plain_on_card(et, n_quad, block):
    """The unstructured diagonal's element pass and nodal sum (`ek.elem_diag`)
    for the three (q, npe) instances against `ek.elem_diag_plain`: within
    2e-5 of the largest entry, symmetric blocks, and two launches bitwise
    equal (a fixed-order sum, no atomics); one count a call."""
    p, q, npe, _, _, state = _card_inputs(et, block, n_quad)
    assert (q, npe) in ek.SUPPORTED
    gradN = p.gradN.view(q * npe * 3, -1)
    n0 = ek.LAUNCHES["diag"]
    a = ek.elem_diag(gradN, p.detJxW, *state, p.buckets, npe=npe, q=q, block=block)
    b = ek.elem_diag(gradN, p.detJxW, *state, p.buckets, npe=npe, q=q, block=block)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["diag"] == n0 + 2
    assert a.shape == (3, 3, p.n_nodes) and torch.equal(a, b) and torch.equal(a, a.transpose(0, 1))
    assert _rel(a, ek.elem_diag_plain(gradN, p.detJxW, *state, p.buckets, npe=npe, q=q)) <= 2e-5


def test_elem_diag_kernel_matches_plain_on_a_shard_on_card():
    """The diagonal on the card on the padded tables of the shard with the
    most padding of a 5-tet box cut into 4 slabs, built as the sharded ranks
    build them (`shard_soa`): padded elements and the mask-0 rows of the
    stacked buckets sum nothing; within 2e-5 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    from fea_large_tpu_torch.dist.partition import partition_mesh
    from fea_large_tpu_torch.dist.sharded import shard_soa

    mesh = box_mesh(6, 3, 3, element_type="tet10", device="cpu")
    part = partition_mesh(mesh, 4, method="slab")
    r = int(np.argmin((part.elem_global >= 0).sum(axis=1)))
    p = shard_soa(mesh, part, r, torch.device("cuda"), mixed=True).p32
    assert int((part.elem_global[r] < 0).sum()) > 0
    assert sum(m.shape[0] for m in p.buckets.mask) > p.buckets.inv.shape[0]
    u, _ = _smooth(part.from_global(mesh.coords_host, space="local")[r])
    st = soa.soa_freeze(p, NeoHookean(1.0, 0.6), torch.tensor(u, dtype=torch.float32, device="cuda"))
    q, npe, gradN, dV = ek.flat_tables(p)
    rows = ek.flatten_state(st)
    out = ek.elem_diag(gradN, dV, *rows, p.buckets, npe=npe, q=q)
    torch.cuda.synchronize()
    assert _rel(out, ek.elem_diag_plain(gradN, dV, *rows, p.buckets, npe=npe, q=q)) <= 2e-5


def _rand_slots(p, dtype, seed=3):
    """Per-slot values [3, npe*E] of `p` on its device."""
    d = np.random.default_rng(seed).standard_normal((3, p.conn_T.numel()))
    return torch.tensor(d, dtype=dtype, device=p.conn_T.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("block", [32, 128])
def test_nodal_sum_kernel_matches_buckets_on_card(dtype, block):
    """The fixed-order nodal sum (`ek.nodal_sum`) on the card against the
    buckets' plain sum (`ScatterBuckets.apply`): within 2e-5 (f32) and
    1e-12 (f64) of the largest entry, two launches bitwise equal, one count
    of `LAUNCHES["nodal_sum"]` each."""
    p = _card_inputs("tet10", block)[0]
    d = _rand_slots(p, dtype)
    n0 = ek.LAUNCHES["nodal_sum"]
    a, b = (ek.nodal_sum(d, p.buckets, block=block) for _ in range(2))
    torch.cuda.synchronize()
    assert ek.LAUNCHES["nodal_sum"] == n0 + 2 and a.shape == (3, p.n_nodes)
    assert torch.equal(a, b)
    assert _rel(a, p.buckets.apply(d)) <= (2e-5 if dtype == torch.float32 else 1e-12)


def test_elem_apply_and_nodal_sum_match_plain_on_a_shard_on_card():
    """B6 with its gather and the nodal sum on the padded tables of the
    shard with the most padding of a 5-tet box cut into 4 slabs
    (`shard_soa`): padded elements and the stacked buckets' mask-0 rows sum
    nothing; within 2e-5 (f32) and 1e-12 (f64) of the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    from fea_large_tpu_torch.dist.partition import partition_mesh
    from fea_large_tpu_torch.dist.sharded import shard_soa

    mesh = box_mesh(6, 3, 3, element_type="tet10", device="cpu")
    part = partition_mesh(mesh, 4, method="slab")
    r = int(np.argmin((part.elem_global >= 0).sum(axis=1)))
    p = shard_soa(mesh, part, r, torch.device("cuda"), mixed=True).p32
    assert int((part.elem_global[r] < 0).sum()) > 0
    u, v = (torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in _smooth(part.from_global(mesh.coords_host, space="local")[r]))
    q, npe, gradN, dV = ek.flat_tables(p)
    rows = ek.flatten_state(soa.soa_freeze(p, NeoHookean(1.0, 0.6), u))
    out = ek.elem_apply(v, p.conn32, gradN, dV, *rows, npe=npe, q=q)
    assert _rel(out, ek.elem_apply_plain(ek._gather_flat(p, v), gradN, dV, *rows, npe=npe,
                                         q=q)) <= 2e-5
    for dtype, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        d = _rand_slots(p, dtype)
        assert _rel(ek.nodal_sum(d, p.buckets), p.buckets.apply(d)) <= bound
    torch.cuda.synchronize()


def test_unstructured_sums_route_to_the_nodal_sum_kernel_on_card(monkeypatch):
    """On the card every unstructured nodal sum, f32 and f64, is the
    nodal-sum kernel (one count a sum) and never the buckets' plain sum;
    the f32 tangent action is one B6 launch, with no plain gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    plain = []
    bucket_sum = soa.ScatterBuckets.apply
    monkeypatch.setattr(soa.ScatterBuckets, "apply",
                        lambda self, d: (plain.append(1), bucket_sum(self, d))[1])
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cuda")
    u, v = _smooth(mesh.coords_host)
    for dtype in (torch.float32, torch.float64):
        p = soa.SoAProblem.build(mesh, dtype)
        ut, vt = (torch.tensor(a, dtype=dtype, device="cuda") for a in (u, v))
        st = soa.soa_freeze(p, NeoHookean(1.0, 0.6), ut)
        n0 = dict(ek.LAUNCHES)
        kv = soa.soa_apply_tangent(p, st, vt)
        f = soa.soa_internal_force(p, st)
        torch.cuda.synchronize()
        assert kv.shape == f.shape == (3, p.n_nodes) and kv.dtype == f.dtype == dtype
        assert ek.LAUNCHES["nodal_sum"] == n0["nodal_sum"] + 2 and plain == []
        assert ek.LAUNCHES["apply"] == n0["apply"] + (dtype == torch.float32)


def test_nodal_sum_wrapper_refuses_bad_inputs_on_card():
    """`ek.nodal_sum` on the card refuses a channel count other than 3, a
    dtype other than f32 and f64, fewer slots than its table names and a
    table on another device."""
    p = _card_inputs("tet10", 128)[0]
    d = _rand_slots(p, torch.float32)
    with pytest.raises(ValueError):
        ek.nodal_sum(d[:2].contiguous(), p.buckets)
    with pytest.raises(TypeError):
        ek.nodal_sum(d.half(), p.buckets)
    with pytest.raises(ValueError):
        ek.nodal_sum(d[:, :-1].contiguous(), p.buckets)
    cpu = soa.SoAProblem.build(box_mesh(3, 3, 3, element_type="tet10", device="cpu"))
    with pytest.raises(ValueError):
        ek.nodal_sum(d, cpu.buckets)
