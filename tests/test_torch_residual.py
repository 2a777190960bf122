"""PyTorch port: the fused f64 residuals (`fea_large_tpu_torch/ops/residual.py`),
B5 (`struct_kernels.struct_resid`) on TET10 and TET4 Kuhn lattices and B9
(`elem_kernels.elem_resid`) on TET10 and TET4 5-tet boxes, with all three
materials, against the JAX reference's pure-f64 pass
(`fea_large_tpu.ops.soa.soa_freeze` + `soa_internal_force` on an f64
SoAProblem).

Tolerance 1e-12 relative to the largest entry: both sides are f64, summed
in another order. The reference's double-word pass (~1e-13) is not the
oracle (ROADMAP.md section C).

The CUDA kernel runs only on a GPU: the `*_on_card` tests hold it against
its plain version there and skip on a machine without CUDA
(`python -m pytest --noconftest -k on_card tests/test_torch_residual.py`).
"""

import numpy as np
import pytest
import torch

from fea_large_tpu_torch.materials import (
    Material,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
)
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import elem_kernels as ek, residual, soa, struct_kernels as sk

torch.set_num_threads(2)

LATTICES = [("tet10", (3, 4, 2)), ("tet4", (4, 3, 5))]
BOXES = [("tet10", (2, 3, 2)), ("tet4", (4, 3, 3))]
MATERIALS = [("svk", StVenantKirchhoff), ("nh", NeoHookean), ("nh_vol", NeoHookeanVolumetric)]


def _u(coords):
    """A smooth large-strain field u [3, N] (f64)."""
    x, y, z = coords.T
    return np.stack([0.05 * np.sin(2.0 * x) * y + 0.02 * z,
                     -0.03 * z * z + 0.04 * x * y,
                     -0.08 * z + 0.03 * np.cos(3.0 * y) * x])


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fea_large_tpu.materials.neo_hookean import NeoHookean, NeoHookeanVolumetric
    from fea_large_tpu.materials.svk import StVenantKirchhoff
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
    from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
    from fea_large_tpu.ops import soa as ref_soa

    return dict(jnp=jnp, svk=StVenantKirchhoff, nh=NeoHookean, nh_vol=NeoHookeanVolumetric,
                box_mesh=ref_box_mesh, box_mesh_kuhn=ref_box_mesh_kuhn, soa=ref_soa)


@pytest.mark.parametrize("et,cells", LATTICES)
@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_fused_residual_plain_matches_reference_f64(ref, et, cells, kind, port_cls):
    jnp = ref["jnp"]
    ref_mesh = ref["box_mesh_kuhn"](*cells, element_type=et)
    rp = ref["soa"].SoAProblem.build(ref_mesh, jnp.float64)
    u = _u(ref_mesh.coords_host)
    rmat = ref[kind](jnp.asarray(1.0, jnp.float64), jnp.asarray(0.6, jnp.float64))
    f_ref = np.asarray(ref["soa"].soa_internal_force(
        rp, ref["soa"].soa_freeze(rp, rmat, jnp.asarray(u))))
    p64 = soa.SoAProblem.build(box_mesh_kuhn(*cells, element_type=et, device="cpu"), torch.float64)
    mat = port_cls(1.0, 0.6)
    assert residual.resid_df_supported(p64, mat)
    f_port = residual.soa_internal_force_df(p64, mat, torch.tensor(u)).numpy()
    np.testing.assert_allclose(f_port, f_ref, rtol=0, atol=1e-12 * np.abs(f_ref).max())


@pytest.mark.parametrize("et,cells", BOXES)
@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_unstructured_residual_plain_matches_reference_f64(ref, et, cells, kind, port_cls):
    """B9's plain version, through `soa_internal_force_df` (f64 conn gather,
    B9, f64 bucket scatter) on a 5-tet box."""
    jnp = ref["jnp"]
    ref_mesh = ref["box_mesh"](*cells, element_type=et)
    rp = ref["soa"].SoAProblem.build(ref_mesh, jnp.float64)
    u = _u(ref_mesh.coords_host)
    rmat = ref[kind](jnp.asarray(1.0, jnp.float64), jnp.asarray(0.6, jnp.float64))
    f_ref = np.asarray(ref["soa"].soa_internal_force(
        rp, ref["soa"].soa_freeze(rp, rmat, jnp.asarray(u))))
    p64 = soa.SoAProblem.build(box_mesh(*cells, element_type=et, device="cpu"), torch.float64)
    mat = port_cls(1.0, 0.6)
    assert residual.resid_df_supported(p64, mat)
    f_port = residual.soa_internal_force_df(p64, mat, torch.tensor(u)).numpy()
    np.testing.assert_allclose(f_port, f_ref, rtol=0, atol=1e-12 * np.abs(f_ref).max())


def test_unstructured_resid_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors `elem_resid` is its plain version, which is the plain
    f64 freeze followed by the force (bitwise), and counts no launch."""
    mesh = box_mesh(2, 3, 2, element_type="tet10", device="cpu")
    p64 = soa.SoAProblem.build(mesh, torch.float64)
    q, npe, gradN, detJxW = ek.flat_tables(p64)
    u = torch.tensor(_u(mesh.coords_host))
    mat = NeoHookeanVolumetric(1.0, 0.6)
    before = dict(ek.LAUNCHES)
    out = ek.elem_resid(ek._gather_flat(p64, u), gradN, detJxW, mat, npe=npe, q=q)
    assert ek.LAUNCHES == before
    f_two_pass = soa.soa_internal_force(p64, soa.soa_freeze(p64, mat, u))
    assert torch.equal(soa.soa_scatter(p64, out.view(3, npe, -1)), f_two_pass)
    assert torch.equal(residual.soa_internal_force_df(p64, mat, u), f_two_pass)


def test_resid_wrapper_runs_the_plain_version_on_cpu():
    """On CPU tensors `struct_resid` is its plain version (bitwise), which is
    the plain f64 freeze followed by the force, and counts no launch."""
    mesh = box_mesh_kuhn(3, 2, 2, element_type="tet10", device="cpu")
    p64 = soa.SoAProblem.build(mesh, torch.float64)
    tb = p64.tables
    u = torch.tensor(_u(mesh.coords_host))
    cache = sk.gather_cache(p64.structure, tb.pairs, u)
    mat = NeoHookean(1.0, 0.6)
    before = dict(sk.LAUNCHES)
    out = sk.struct_resid(tb, cache, mat)
    assert torch.equal(out, sk.struct_resid_plain(tb, cache, mat))
    assert sk.LAUNCHES == before
    f_two_pass = soa.soa_internal_force(p64, soa.soa_freeze(p64, mat, u))
    assert torch.equal(sk.scatter_pairs(p64.structure, tb.pairs, out, 3), f_two_pass)


def test_fused_residual_is_for_lattices_only():
    """Both mesh kinds are supported now; what is not: a material without a
    kernel code (NotImplementedError) and an f32 problem (TypeError)."""
    mat = NeoHookean(1.0, 0.6)
    p64 = soa.SoAProblem.build(box_mesh(2, 2, 2, element_type="tet4", device="cpu"), torch.float64)
    assert residual.resid_df_supported(p64, mat)
    other = Material(1.0, 0.6)
    assert not residual.resid_df_supported(p64, other)
    with pytest.raises(NotImplementedError):
        residual.soa_internal_force_df(p64, other, torch.zeros((3, p64.n_nodes), dtype=torch.float64))
    lat32 = soa.SoAProblem.build(box_mesh_kuhn(2, 2, 2, element_type="tet4", device="cpu"))
    with pytest.raises(TypeError):
        residual.soa_internal_force_df(lat32, mat, torch.zeros((3, lat32.n_nodes), dtype=torch.float64))


# ---------------------------------------------------------------------------
# kernel vs plain version on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("et", ["tet10", "tet4"])
@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_resid_kernel_matches_plain_on_card(et, kind, port_cls):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a")
    # C = 8*4*5 = 160 = 128 + 32 cells: a partial last block
    mesh = box_mesh_kuhn(8, 4, 5, element_type=et, device="cuda")
    p64 = soa.SoAProblem.build(mesh, torch.float64)
    tb = p64.tables
    cache = sk.gather_cache(p64.structure, tb.pairs,
                            torch.tensor(_u(mesh.coords_host), device="cuda"))
    mat = port_cls(1.0, 0.6)
    n0 = sk.LAUNCHES["resid"]
    out = sk.struct_resid(tb, cache, mat)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["resid"] == n0 + 1
    plain = sk.struct_resid_plain(tb, cache, mat)
    assert float((out - plain).abs().max()) <= 1e-12 * float(plain.abs().max())


@pytest.mark.parametrize("et", ["tet10", "tet4"])
@pytest.mark.parametrize("kind,port_cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_unstructured_resid_kernel_matches_plain_on_card(et, kind, port_cls):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ for sm_90a")
    # E = 5*6*5*5 = 750 = 5*128 + 110 elements: a partial last block
    mesh = box_mesh(6, 5, 5, element_type=et, device="cuda")
    p64 = soa.SoAProblem.build(mesh, torch.float64)
    q, npe, gradN, detJxW = ek.flat_tables(p64)
    ue = ek._gather_flat(p64, torch.tensor(_u(mesh.coords_host), device="cuda"))
    mat = port_cls(1.0, 0.6)
    n0 = ek.LAUNCHES["resid"]
    out = ek.elem_resid(ue, gradN, detJxW, mat, npe=npe, q=q)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["resid"] == n0 + 1
    plain = ek.elem_resid_plain(ue, gradN, detJxW, mat, npe=npe, q=q)
    assert float((out - plain).abs().max()) <= 1e-12 * float(plain.abs().max())
