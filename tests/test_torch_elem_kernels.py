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
    versions. A Kuhn lattice never reaches the element-block wrappers."""
    calls = []
    for name in ("elem_freeze", "elem_apply", "elem_force"):
        wrapper = getattr(ek, name)
        monkeypatch.setattr(ek, name, lambda *a, _w=wrapper, _n=name, **k: (calls.append(_n), _w(*a, **k))[1])
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
        assert calls == (["elem_freeze", "elem_apply", "elem_force"] if dtype == torch.float32 else [])
        calls.clear()
    p = soa.SoAProblem.build(box_mesh_kuhn(2, 2, 1, element_type="tet10", device="cpu"), torch.float32)
    st = soa.soa_freeze(p, mat, torch.zeros((3, p.n_nodes)))
    soa.soa_apply_tangent(p, st, torch.ones((3, p.n_nodes)))
    soa.soa_internal_force(p, st)
    assert calls == [] and ek.LAUNCHES == before


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
    return p, q, npe, ek._gather_flat(p, u), ek._gather_flat(p, v), state


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
    p, q, npe, _, ve, state = _card_inputs(et, block)
    gradN = p.gradN.view(q * npe * 3, -1)
    out = ek.elem_apply(ve, gradN, p.detJxW, *state, npe=npe, q=q, block=block)
    torch.cuda.synchronize()
    plain = ek.elem_apply_plain(ve, gradN, p.detJxW, *state, npe=npe, q=q)
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
    p, q, npe, ue, ve, state = _card_inputs("tet10", 128, n_quad=5)
    assert (q, npe) == (5, 10)
    kw = dict(npe=npe, q=q)
    gradN = p.gradN.view(q * npe * 3, -1)
    mat = NeoHookean(1.0, 0.6)
    for a, b in zip(ek.elem_freeze(ue, gradN, mat, **kw), ek.elem_freeze_plain(ue, gradN, mat, **kw)):
        assert _rel(a, b) <= 2e-5
    assert _rel(ek.elem_apply(ve, gradN, p.detJxW, *state, **kw),
                ek.elem_apply_plain(ve, gradN, p.detJxW, *state, **kw)) <= 2e-5
    assert _rel(ek.elem_force(gradN, p.detJxW, *state[:2], **kw),
                ek.elem_force_plain(gradN, p.detJxW, *state[:2], **kw)) <= 2e-5
    args = (ue.double(), gradN.double(), p.detJxW.double(), mat)
    assert _rel(ek.elem_resid(*args, **kw), ek.elem_resid_plain(*args, **kw)) <= 1e-12
    torch.cuda.synchronize()
