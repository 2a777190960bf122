"""PyTorch port: the structured SoA element passes against the JAX
reference's XLA functions (`fea_large_tpu/ops/soa.py`), on CPU.

On the CPU the port's `soa_*` functions run the plain versions of the four
kernels. Inputs are smooth physical fields (random nodal displacements can
invert elements and NaN both paths). Tolerances:
  * f32: 2e-5 relative and absolute, the bound of bench.py's kernel check
    and tests/test_pallas_structured.py (f32 rounding in another
    summation order);
  * f64: 1e-12 relative to the largest entry (f64 rounding only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.materials.neo_hookean import NeoHookeanVolumetric as RefNHVol
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.ops import pallas_structured as ref_ps
from fea_large_tpu.ops import soa as ref_soa

from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh_kuhn
from fea_large_tpu_torch.ops import soa, struct_kernels as sk

torch.set_num_threads(2)

LATTICES = [("tet10", (3, 2, 2)), ("tet4", (4, 3, 2))]
MATERIALS = [(RefSVK, StVenantKirchhoff), (RefNH, NeoHookean), (RefNHVol, NeoHookeanVolumetric)]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _close(port, ref, dtype):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(port, ref, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def _fields(coords):
    x, y, z = coords.T
    u = np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x, -0.05 * z + 0.02 * np.cos(y)])
    v = np.stack([0.01 * np.cos(y) * z, 0.02 * x * y, -0.03 * np.sin(z)])
    return u, v


@pytest.mark.parametrize("et,cells", LATTICES)
def test_soa_problem_tables_match_reference(et, cells):
    ref = ref_soa.SoAProblem.build(ref_box_mesh_kuhn(*cells, element_type=et), jnp.float64)
    port = soa.SoAProblem.build(box_mesh_kuhn(*cells, element_type=et, device="cpu"), torch.float64)
    for p, r, host in ((port.gradN, ref.gradN, ref.tables_host[0]),
                       (port.detJxW, ref.detJxW, ref.tables_host[1])):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-14)
        np.testing.assert_allclose(p.numpy(), np.asarray(host), rtol=0, atol=1e-14)
    assert port.n_nodes == ref.n_nodes


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("ref_cls,port_cls", MATERIALS, ids=["svk", "nh", "nh_vol"])
@pytest.mark.parametrize("et,cells", LATTICES, ids=["tet10", "tet4"])
def test_soa_passes_match_reference(et, cells, ref_cls, port_cls, jdt, tdt):
    ref_mesh = ref_box_mesh_kuhn(*cells, element_type=et)
    rp = ref_soa.SoAProblem.build(ref_mesh, jdt)
    pp = soa.SoAProblem.build(box_mesh_kuhn(*cells, element_type=et, device="cpu"), tdt)
    u, v = _fields(ref_mesh.coords_host)
    rmat = ref_cls(jnp.asarray(1.0, jdt), jnp.asarray(0.6, jdt))
    pmat = port_cls(1.0, 0.6)

    rs = ref_soa.soa_freeze(rp, rmat, jnp.asarray(u, jdt))
    ps = soa.soa_freeze(pp, pmat, torch.tensor(u, dtype=tdt))
    for f in ("F", "S", "A", "alpha", "beta"):
        _close(getattr(ps, f), getattr(rs, f), tdt)
    _close(soa.soa_internal_force(pp, ps), ref_soa.soa_internal_force(rp, rs), tdt)
    _close(
        soa.soa_apply_tangent(pp, ps, torch.tensor(v, dtype=tdt)),
        ref_soa.soa_apply_tangent(rp, rs, jnp.asarray(v, jdt)), tdt,
    )
    _close(soa.soa_diag_blocks(pp, ps), ref_soa.soa_diag_blocks(rp, rs), tdt)


@pytest.mark.parametrize("et,cells", LATTICES)
def test_struct_pairs_match_reference(et, cells):
    st = box_mesh_kuhn(*cells, element_type=et, device="cpu").structure
    pairs, pair_of = sk.struct_pairs(st)
    ref_pairs, ref_pair_of = ref_ps.struct_pairs(st)
    assert pairs == ref_pairs
    assert pair_of == ref_pair_of
    assert len(pairs) == {"tet10": 27, "tet4": 8}[et]


@pytest.mark.parametrize("n_comp", [3, 9])
@pytest.mark.parametrize("et,cells", LATTICES)
def test_gather_and_scatter_match_reference(et, cells, n_comp):
    """The pair-cache gather and the pair-row scatter are exact memory ops
    in both packages: bitwise equal."""
    mesh = box_mesh_kuhn(*cells, element_type=et, device="cpu")
    st = mesh.structure
    pairs, _ = sk.struct_pairs(st)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((n_comp, mesh.n_nodes))
    C = st.n_cells
    ref_cache = np.asarray(ref_ps._gather_cache(st, pairs, jnp.asarray(v), 1, C)).reshape(-1, C)
    np.testing.assert_array_equal(sk.gather_cache(st, pairs, torch.tensor(v)).numpy(), ref_cache)
    rows = rng.standard_normal((n_comp * len(pairs), C))
    np.testing.assert_array_equal(
        sk.scatter_pairs(st, pairs, torch.tensor(rows), n_comp).numpy(),
        np.asarray(ref_ps._scatter_pairs(st, pairs, jnp.asarray(rows), n_comp)),
    )


def test_soa_rejects_mismatched_dtype():
    p = soa.SoAProblem.build(box_mesh_kuhn(2, 2, 2, element_type="tet4", device="cpu"), torch.float32)
    with pytest.raises(TypeError):
        soa.soa_freeze(p, NeoHookean(1.0, 0.6), torch.zeros((3, p.n_nodes), dtype=torch.float64))
