"""PyTorch port: the plain pair-row versions of the four structured kernels
(`fea_large_tpu_torch/ops/struct_kernels.py`) against the reference's Pallas
kernels (`fea_large_tpu/ops/pallas_structured.py`) in interpret mode, on a
(8, 4, 4) TET10 Kuhn lattice, as tests/test_pallas_structured.py runs them.

The tolerance is f32 2e-5 relative and absolute (the bound of bench.py's
kernel check): both sides compute in f32 with different summation orders.

The CUDA kernels themselves run only on a GPU: the `*_on_card` tests hold
each against its plain version there and skip on a machine without CUDA.
The reference is imported inside a fixture, so that the card tests also
run where JAX is not installed:
`python -m pytest --noconftest -k on_card tests/test_torch_struct_kernels.py`.
"""

import numpy as np
import pytest
import torch

from fea_large_tpu_torch import interop
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh_kuhn
from fea_large_tpu_torch.ops import soa, struct_kernels as sk

torch.set_num_threads(2)

CELLS = (8, 4, 4)
TOL = dict(rtol=2e-5, atol=2e-5)


def _fields(coords):
    c = coords.T
    u = np.zeros((3, coords.shape[0]))
    u[2] = -0.05 * c[2]
    u[0] = 0.01 * np.sin(np.pi * c[0]) * c[2]
    v = np.cos(np.pi * c) * (1.0 + c[::-1])
    return u, v


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's modules (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fea_large_tpu.materials.neo_hookean import NeoHookean, NeoHookeanVolumetric
    from fea_large_tpu.materials.svk import StVenantKirchhoff
    from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
    from fea_large_tpu.ops import pallas_structured, soa as ref_soa

    return dict(jnp=jnp, svk=StVenantKirchhoff, nh=NeoHookean, nh_vol=NeoHookeanVolumetric,
                box_mesh_kuhn=ref_box_mesh_kuhn, ps=pallas_structured, soa=ref_soa)


@pytest.fixture(scope="module")
def lattice(ref):
    jnp, ref_soa = ref["jnp"], ref["soa"]
    ref_mesh = ref["box_mesh_kuhn"](*CELLS, element_type="tet10")
    rp = ref_soa.SoAProblem.build(ref_mesh, jnp.float32)
    pp = soa.SoAProblem.build(box_mesh_kuhn(*CELLS, element_type="tet10", device="cpu"), torch.float32)
    u, v = _fields(ref_mesh.coords_host)
    rmat = ref["nh"](jnp.asarray(1.0, jnp.float32), jnp.asarray(0.6, jnp.float32))
    rstate = ref_soa.soa_freeze(rp, rmat, jnp.asarray(u, jnp.float32))
    pstate = interop.soa_state_from_numpy(*(np.asarray(x) for x in rstate), device="cpu")
    return rp, pp, rstate, pstate, u, v


def test_plain_apply_matches_pallas(ref, lattice):
    jnp = ref["jnp"]
    rp, pp, rstate, pstate, _, v = lattice
    tb = pp.tables
    cache = sk.gather_cache(pp.structure, tb.pairs, torch.tensor(v, dtype=torch.float32))
    rows = sk.struct_apply_plain(tb, cache, *pstate.rows(tb))
    port = sk.scatter_pairs(pp.structure, tb.pairs, rows, 3)
    out = ref["ps"].soa_apply_tangent_struct_pallas(rp, rstate, jnp.asarray(v, jnp.float32))
    np.testing.assert_allclose(port.numpy(), np.asarray(out), **TOL)


def test_plain_force_matches_pallas(ref, lattice):
    rp, pp, rstate, pstate, _, _ = lattice
    tb = pp.tables
    F, S = pstate.rows(tb)[:2]
    port = sk.scatter_pairs(pp.structure, tb.pairs, sk.struct_force_plain(tb, F, S), 3)
    out = ref["ps"].soa_internal_force_struct_pallas(rp, rstate)
    np.testing.assert_allclose(port.numpy(), np.asarray(out), **TOL)


def test_plain_diag_matches_pallas(ref, lattice):
    rp, pp, rstate, pstate, _, _ = lattice
    tb = pp.tables
    rows = sk.struct_diag_plain(tb, *pstate.rows(tb))
    port = sk.scatter_pairs(pp.structure, tb.pairs, rows, 9).reshape(3, 3, -1)
    out = ref["ps"].soa_diag_blocks_struct_pallas(rp, rstate)
    np.testing.assert_allclose(port.numpy(), np.asarray(out), **TOL)


@pytest.mark.parametrize(
    "kind,port_cls", [("svk", StVenantKirchhoff), ("nh", NeoHookean),
                      ("nh_vol", NeoHookeanVolumetric)],
    ids=["svk", "nh", "nh_vol"],
)
def test_plain_freeze_matches_pallas(ref, lattice, kind, port_cls):
    jnp = ref["jnp"]
    rp, pp, _, _, u, _ = lattice
    tb = pp.tables
    rmat = ref[kind](jnp.asarray(1.0, jnp.float32), jnp.asarray(0.6, jnp.float32))
    out = ref["ps"].soa_freeze_struct_pallas(rp, rmat, jnp.asarray(u, jnp.float32))
    cache = sk.gather_cache(pp.structure, tb.pairs, torch.tensor(u, dtype=torch.float32))
    port = sk.struct_freeze_plain(tb, cache, port_cls(1.0, 0.6))
    for name, p, r in zip(("F", "S", "A", "alpha", "beta"), port, out):
        np.testing.assert_allclose(
            p.numpy(), np.asarray(r).reshape(p.shape), err_msg=name, **TOL
        )


def test_wrappers_run_the_plain_version_on_cpu():
    """CPU tensors go to the plain versions (bitwise), and nothing counts
    as a kernel launch."""
    mesh = box_mesh_kuhn(*CELLS, element_type="tet10", device="cpu")
    pp = soa.SoAProblem.build(mesh, torch.float32)
    u, v = _fields(mesh.coords_host)
    pstate = soa.soa_freeze(pp, NeoHookean(1.0, 0.6), torch.tensor(u, dtype=torch.float32))
    tb = pp.tables
    before = dict(sk.LAUNCHES)
    rows = pstate.rows(tb)
    vc = sk.gather_cache(pp.structure, tb.pairs, torch.tensor(v, dtype=torch.float32))
    uc = sk.gather_cache(pp.structure, tb.pairs, torch.tensor(u, dtype=torch.float32))
    mat = NeoHookean(1.0, 0.6)
    assert torch.equal(sk.struct_apply(tb, vc, *rows), sk.struct_apply_plain(tb, vc, *rows))
    assert torch.equal(sk.struct_diag(tb, *rows), sk.struct_diag_plain(tb, *rows))
    assert torch.equal(sk.struct_force(tb, *rows[:2]), sk.struct_force_plain(tb, *rows[:2]))
    for a, b in zip(sk.struct_freeze(tb, uc, mat), sk.struct_freeze_plain(tb, uc, mat)):
        assert torch.equal(a, b)
    assert sk.LAUNCHES == before


@pytest.mark.parametrize("et", ["tet10", "tet4"])
def test_slot_table_combine_reproduces_pair_rows(et):
    """The kernel B1 sums each pair row over `slot_table`'s slots in order,
    skipping the padding; on random per-slot contributions that is
    `_pair_rows`, the plain versions' pair sum."""
    mesh = box_mesh_kuhn(3, 2, 2, element_type=et, device="cpu")
    tb = soa.SoAProblem.build(mesh, torch.float64).tables
    T, npe, P = tb.T, tb.npe, tb.P
    table = tb.slot_table
    assert table.dtype == torch.int32 and tuple(table.shape) == (P, T)
    assert torch.equal(table.long(), tb.slot_rows)
    # every (tet slot, node slot) feeds exactly one pair, the one of pair_of
    live = table[table < T * npe].long()
    assert sorted(live.tolist()) == list(range(T * npe))
    for p in range(P):
        for s in table[p][table[p] < T * npe].tolist():
            assert int(tb.pair_of[s // npe, s % npe]) == p
    rng = np.random.default_rng(4)
    contrib = torch.tensor(rng.standard_normal((T, npe, 3, tb.C)))
    flat = contrib.reshape(T * npe, 3, tb.C)
    out = torch.zeros(P, 3, tb.C, dtype=torch.float64)
    for p in range(P):
        for s in table[p].tolist():  # the kernel's order: t-major, padding skipped
            if s < T * npe:
                out[p] += flat[s]
    np.testing.assert_allclose(out.reshape(3 * P, tb.C).numpy(),
                               sk._pair_rows(tb, contrib).numpy(), rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# kernel vs plain version on the card
# ---------------------------------------------------------------------------


def _card_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    # C = 8*4*5 = 160 = 128 + 32: a partial last block
    mesh = box_mesh_kuhn(8, 4, 5, element_type="tet10", device="cuda")
    p = soa.SoAProblem.build(mesh, torch.float32)
    u, v = _fields(mesh.coords_host)
    u = torch.tensor(u, dtype=torch.float32, device="cuda")
    v = torch.tensor(v, dtype=torch.float32, device="cuda")
    return p, u, v


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("material", [StVenantKirchhoff(1.0, 0.6), NeoHookean(1.0, 0.6),
                                      NeoHookeanVolumetric(1.0, 0.6)], ids=["svk", "nh", "nh_vol"])
def test_freeze_kernel_matches_plain_on_card(material):
    p, u, _ = _card_problem()
    tb = p.tables
    cache = sk.gather_cache(p.structure, tb.pairs, u)
    n0 = sk.LAUNCHES["freeze"]
    out = sk.struct_freeze(tb, cache, material)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["freeze"] == n0 + 1
    for a, b in zip(out, sk.struct_freeze_plain(tb, cache, material)):
        assert _rel(a, b) <= 2e-5


def test_apply_kernel_matches_plain_on_card():
    p, u, v = _card_problem()
    tb = p.tables
    rows = soa.soa_freeze(p, NeoHookean(1.0, 0.6), u).rows(tb)
    cache = sk.gather_cache(p.structure, tb.pairs, v)
    out = sk.struct_apply(tb, cache, *rows)
    torch.cuda.synchronize()
    assert _rel(out, sk.struct_apply_plain(tb, cache, *rows)) <= 2e-5


def test_diag_kernel_matches_plain_on_card():
    p, u, _ = _card_problem()
    tb = p.tables
    rows = soa.soa_freeze(p, NeoHookean(1.0, 0.6), u).rows(tb)
    out = sk.struct_diag(tb, *rows)
    torch.cuda.synchronize()
    assert _rel(out, sk.struct_diag_plain(tb, *rows)) <= 2e-5


def test_force_kernel_matches_plain_on_card():
    p, u, _ = _card_problem()
    tb = p.tables
    rows = soa.soa_freeze(p, NeoHookean(1.0, 0.6), u).rows(tb)
    n0 = sk.LAUNCHES["force"]
    out = sk.struct_force(tb, *rows[:2])
    again = sk.struct_force(tb, *rows[:2])
    torch.cuda.synchronize()
    assert sk.LAUNCHES["force"] == n0 + 2
    assert torch.equal(out, again)
    assert _rel(out, sk.struct_force_plain(tb, *rows[:2])) <= 2e-5


@pytest.mark.parametrize("et,cells", [("tet10", (5, 3, 3)), ("tet4", (7, 3, 2)), ("tet10", (4, 4, 4))],
                         ids=["tet10-45", "tet4-42", "tet10-64"])
def test_apply_kernel_ragged_cell_tile_on_card(et, cells):
    """B1 on lattices whose C is not (45, 42) and is (64) a multiple of the
    32-cell tile of a block; two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    mesh = box_mesh_kuhn(*cells, element_type=et, device="cuda")
    p = soa.SoAProblem.build(mesh, torch.float32)
    u, v = _fields(mesh.coords_host)
    u = torch.tensor(u, dtype=torch.float32, device="cuda")
    v = torch.tensor(v, dtype=torch.float32, device="cuda")
    tb = p.tables
    rows = soa.soa_freeze(p, NeoHookean(1.0, 0.6), u).rows(tb)
    cache = sk.gather_cache(p.structure, tb.pairs, v)
    n0 = sk.LAUNCHES["apply"]
    out = sk.struct_apply(tb, cache, *rows)
    again = sk.struct_apply(tb, cache, *rows)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["apply"] == n0 + 2
    assert torch.equal(out, again)
    assert _rel(out, sk.struct_apply_plain(tb, cache, *rows)) <= 2e-5


RAGGED_ON_CARD = pytest.mark.parametrize(
    "et,cells,n_quad",
    [("tet10", (5, 3, 3), None), ("tet4", (7, 3, 2), None), ("tet10", (4, 4, 4), None),
     ("tet10", (5, 3, 3), 5)],
    ids=["tet10-45", "tet4-42", "tet10-64", "tet10-5pt-45"])


@RAGGED_ON_CARD
def test_force_kernel_ragged_cell_tile_on_card(et, cells, n_quad):
    """B4 on lattices whose C is not (45, 42) and is (64) a multiple of the
    32-cell tile of a block, and with the 5-point rule; its sums cross
    threads: two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    mesh = box_mesh_kuhn(*cells, element_type=et, device="cuda", n_quad=n_quad)
    p = soa.SoAProblem.build(mesh, torch.float32)
    u = torch.tensor(_fields(mesh.coords_host)[0], dtype=torch.float32, device="cuda")
    tb = p.tables
    rows = soa.soa_freeze(p, NeoHookean(1.0, 0.6), u).rows(tb)
    n0 = sk.LAUNCHES["force"]
    out = sk.struct_force(tb, *rows[:2])
    again = sk.struct_force(tb, *rows[:2])
    torch.cuda.synchronize()
    assert sk.LAUNCHES["force"] == n0 + 2
    assert torch.equal(out, again)
    assert _rel(out, sk.struct_force_plain(tb, *rows[:2])) <= 2e-5


def test_five_point_rule_kernels_match_plain_on_card():
    """The (5, 10, 6) instances of B1, B2 and B3 (B4 and B5 have their own
    cases) on a TET10 lattice with `n_quad=5`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    mesh = box_mesh_kuhn(5, 3, 3, element_type="tet10", device="cuda", n_quad=5)
    p = soa.SoAProblem.build(mesh, torch.float32)
    tb = p.tables
    assert (tb.q, tb.npe, tb.T) == (5, 10, 6)
    u, v = (torch.tensor(x, dtype=torch.float32, device="cuda") for x in _fields(mesh.coords_host))
    mat = NeoHookean(1.0, 0.6)
    cache = sk.gather_cache(p.structure, tb.pairs, u)
    rows = sk.struct_freeze(tb, cache, mat)
    for a, b in zip(rows, sk.struct_freeze_plain(tb, cache, mat)):
        assert _rel(a, b) <= 2e-5
    vc = sk.gather_cache(p.structure, tb.pairs, v)
    assert _rel(sk.struct_apply(tb, vc, *rows), sk.struct_apply_plain(tb, vc, *rows)) <= 2e-5
    assert _rel(sk.struct_diag(tb, *rows), sk.struct_diag_plain(tb, *rows)) <= 2e-5
