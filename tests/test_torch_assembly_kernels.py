"""PyTorch port: the f64 assembly kernels of the BCSR route
(`fea_large_tpu_torch/ops/assembly_kernels.py`, csrc/assembly_kernels.cu),
their routing in `assemble_bcsr`, and the benchmark's `assembly_roofline`.

On the CPU: the plain versions, in the kernels' layout and order (each
tet's upper stiffness blocks and its force, then each slot's entries in
the slot table's order), against the plain `element_stiffness`, the plain
`assemble_bcsr` and the JAX reference's `assemble_bcsr`, in f64, on TET10
with the 4- and 5-point rules and TET4, for SVK and both neo-Hookean kinds;
the slot table against `BCSRStructure.perm`; the routing rule (CPU tensors,
an autodiff material, f32 and other elements take the plain path); the
yardstick and reader of `assembly_roofline.bcsr`.

Tolerance 1e-12 of the largest entry: both sides f64, summed in other
orders, and the kernels' slots read the transposed upper block where the
plain path forms the lower one, which differ by the plain stiffness's own
rounding asymmetry. The displacement is a smooth field plus noise of
0.01: far from inverted points, where that asymmetry grows with the
cancellation between the points (5e-13 of the largest entry with the
5-point rule, whose centre weight is negative, at noise 0.05).

The `*_on_card` tests hold the kernels to the plain versions on the card,
two launches bitwise equal, the launches of a `NewtonSolver` on
`linear="pcg_bcsr"` and the wrapper's refusals; they skip without CUDA
(`python -m pytest --noconftest -k on_card tests/test_torch_assembly_kernels.py`).
"""

import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.elements import kernels as elk
from fea_large_tpu_torch.materials import (
    MooneyRivlin,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
)
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.ops import assembly_kernels as ak
from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions
from fea_large_tpu_torch.utils import profiling

torch.set_num_threads(2)

PORTBENCH = pathlib.Path(__file__).resolve().parents[1] / "portbench"
TOL = 1e-12
#: (element, quadrature points, box): 5-tet boxes of 40 tets (TET10: 10
#: blocks of 4 tets, 7 of 6 with the 5-point rule; TET4: 2 blocks of 32,
#: the last partly filled)
ELEMENTS = [("tet10", None, (2, 2, 2)), ("tet10", 5, (2, 2, 2)), ("tet4", None, (4, 2, 1))]
MATERIALS = [("svk", StVenantKirchhoff), ("nh", NeoHookean), ("nh_vol", NeoHookeanVolumetric)]


def _field(coords_host, seed=11):
    """A smooth displacement plus noise of 0.01 [N, 3] (numpy)."""
    x, y, z = coords_host.T
    u = np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x, -0.05 * z], axis=1)
    return u + 0.01 * np.random.default_rng(seed).standard_normal(u.shape)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


class _Box:
    """One box on `device`: mesh, structure, scatter, geometry and u."""

    def __init__(self, et, n_quad, cells, device="cpu"):
        self.params = (et, n_quad, cells)
        self.mesh = box_mesh(*cells, element_type=et, device=device, n_quad=n_quad)
        m = self.mesh
        self.structure = BCSRStructure.build(m.conn_host, m.n_nodes, device)
        self.scatter = NodeScatter.build(m.conn_host, m.n_nodes, device)
        self.geom = elk.precompute_geometry(m.coords, m.conn, m.element)
        self.u_np = _field(m.coords_host)
        self.u = torch.tensor(self.u_np, device=device)

    def plain(self, mat):
        """(blocks, fe) of the kernels' plain versions."""
        return ak.element_blocks_plain(self.u, self.structure.conn32, self.geom.gradN,
                                       self.geom.detJxW, mat)


@pytest.fixture(autouse=True, scope="module")
def _read_cpu_spans():
    """Read the CPU's span table after the module, as a request's fetch
    does: the stamps of its assemblies are then counted here, not in the
    next module's spans."""
    yield
    profiling.read_spans(torch.device("cpu"), profiling.span_table("cpu"))


@pytest.fixture(scope="module", params=ELEMENTS, ids=["tet10", "tet10_5pt", "tet4"])
def box(request):
    return _Box(*request.param)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's modules (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fea_large_tpu.assembly import bcsr, scatter
    from fea_large_tpu.elements import kernels
    from fea_large_tpu.elements.reference import get_element
    from fea_large_tpu.materials.neo_hookean import NeoHookean, NeoHookeanVolumetric
    from fea_large_tpu.materials.svk import StVenantKirchhoff
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh

    return dict(jnp=jnp, bcsr=bcsr, scatter=scatter, kernels=kernels, box_mesh=ref_box_mesh,
                get_element=get_element, svk=StVenantKirchhoff, nh=NeoHookean,
                nh_vol=NeoHookeanVolumetric)


# ---------------------------------------------------------------------------
# the plain versions on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_plain_blocks_are_the_element_stiffness_upper_blocks(box, kind, cls):
    """The stored blocks are `element_stiffness`'s Ke[a, :, b, :] with a <=
    b, in row-major (a, b) order, and fe its force at the flat e-major
    slots e*npe + a."""
    mat = cls(1.0, 0.6)
    Ke, fe = elk.element_stiffness(box.u[box.mesh.conn], box.geom, mat)
    blocks, fe_k = box.plain(mat)
    E, npe = box.structure.conn32.shape
    a, b = ak.pairs(npe)
    assert blocks.shape == (E, npe * (npe + 1) // 2, 3, 3) and blocks.is_contiguous()
    assert fe_k.shape == (3, E * npe)
    _close(blocks, Ke.permute(0, 1, 3, 2, 4)[:, a, b])
    _close(fe_k, fe.permute(2, 0, 1).reshape(3, -1))


@pytest.mark.parametrize("kind,cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_plain_slot_sum_is_the_plain_assembly(box, kind, cls):
    """The slot sum of the stored blocks and the nodal sum of fe on the
    nodal-sum table (`ek.nodal_sum`'s plain version) give `assemble_bcsr`'s
    plain K and f_int; the blocks (n, m) and (m, n), n != m, transposes
    of each other bitwise."""
    mat = cls(1.0, 0.6)
    blocks, fe = box.plain(mat)
    data = ak.slot_sum_plain(blocks, box.structure.slot_table)
    K, f_int = assemble_bcsr(box.u, box.mesh.conn, box.geom, mat, box.structure, box.scatter)
    _close(data, K.data)
    _close(ek.nodal_sum(fe, box.scatter.buckets).T, f_int)
    st = box.structure
    dense = torch.zeros((st.n_nodes, 3, st.n_nodes, 3), dtype=torch.float64)
    dense[st.row_ids, :, st.indices, :] = data
    off = ~torch.eye(st.n_nodes, dtype=torch.bool)[:, None, :, None].expand(dense.shape)
    assert torch.equal(dense[off], dense.permute(2, 3, 0, 1)[off])


@pytest.mark.parametrize("kind,cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_plain_versions_match_the_reference_assembly(ref, box, kind, cls):
    """The plain versions' K and f_int against the JAX reference's
    `assemble_bcsr` on the same box."""
    jnp = ref["jnp"]
    et, n_quad, cells = box.params
    rmesh = ref["box_mesh"](*cells, element_type=et)
    np.testing.assert_array_equal(np.asarray(rmesh.conn_host), box.mesh.conn_host)
    rgeom = ref["kernels"].precompute_geometry(rmesh.coords, rmesh.conn,
                                               ref["get_element"](et, n_quad))
    rs = ref["bcsr"].BCSRStructure.build(rmesh.conn_host, rmesh.n_nodes)
    rK, rf = ref["bcsr"].assemble_bcsr(
        jnp.asarray(box.u_np), rmesh.conn, rgeom, ref[kind](jnp.asarray(1.0), jnp.asarray(0.6)),
        rs, ref["scatter"].NodeScatter.build(rmesh.conn_host, rmesh.n_nodes))
    blocks, fe = box.plain(cls(1.0, 0.6))
    _close(ak.slot_sum_plain(blocks, box.structure.slot_table), rK.data)
    _close(ek.nodal_sum(fe, box.scatter.buckets).T, rf)


def test_slot_table_walks_each_slot_in_the_plain_order(box):
    """Each slot's codes are `BCSRStructure.perm`'s entries (e, a, b) of
    that slot, in order: ascending elements, a stored block p = (min, max)
    of (a, b), transposed exactly where a > b."""
    st = box.structure
    E, npe = st.conn32.shape
    P = npe * (npe + 1) // 2
    tb = st.slot_table
    assert tb.offsets.dtype == tb.codes.dtype == torch.int32
    assert tb.n_blocks == E * P and len(tb.codes) == E * npe * npe == int(tb.offsets[-1])
    codes = tb.codes.long().numpy()
    e, p, t = codes // 2 // P, codes // 2 % P, codes % 2
    pe, rest = np.divmod(st.perm, npe * npe)
    pa, pb = np.divmod(rest, npe)
    a_of, b_of = ak.pairs(npe)
    np.testing.assert_array_equal(e, pe)
    np.testing.assert_array_equal(np.where(t == 1, b_of[p], a_of[p]), pa)
    np.testing.assert_array_equal(np.where(t == 1, a_of[p], b_of[p]), pb)
    np.testing.assert_array_equal(t, pa > pb)
    starts = tb.offsets.long().numpy()
    np.testing.assert_array_equal(np.repeat(np.arange(st.nnzb), np.diff(starts)),
                                  st.segment_ids)
    for s in range(st.nnzb):  # one entry a tet, in ascending tets
        assert np.all(np.diff(e[starts[s]:starts[s + 1]]) > 0)


def test_plain_slot_sum_adds_each_slots_entries_in_order():
    """Slot s is ((0 + x0) + x1) + ... in the table's order, bitwise: the
    kernel's order, whatever the blocks' values."""
    box = _Box("tet10", None, (2, 1, 1))
    tb = box.structure.slot_table
    E, npe = box.structure.conn32.shape
    rng = np.random.default_rng(3)
    blocks = torch.tensor(rng.standard_normal((E, npe * (npe + 1) // 2, 3, 3)) * 10.0 **
                          rng.integers(-8, 8, (E, npe * (npe + 1) // 2, 1, 1)))
    data = ak.slot_sum_plain(blocks, tb)
    flat = blocks.reshape(-1, 3, 3)
    for s in range(0, box.structure.nnzb, 7):
        acc = torch.zeros((3, 3), dtype=torch.float64)
        for c in tb.codes[tb.offsets[s]:tb.offsets[s + 1]].tolist():
            acc = acc + (flat[c >> 1].T if c & 1 else flat[c >> 1])
        assert torch.equal(data[s], acc)


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,npe,cls,dtype,want", [
    (4, 10, NeoHookean, torch.float64, True),
    (5, 10, StVenantKirchhoff, torch.float64, True),
    (1, 4, NeoHookeanVolumetric, torch.float64, True),
    (4, 10, MooneyRivlin, torch.float64, False),
    (4, 10, NeoHookean, torch.float32, False),
    (4, 4, NeoHookean, torch.float64, False),
], ids=["tet10", "tet10_5pt", "tet4", "autodiff", "f32", "other_element"])
def test_kernels_take_f64_card_registered_materials_and_built_elements(q, npe, cls, dtype, want):
    assert ak.supported(torch.device("cuda", 0), dtype, q, npe, cls(1.0, 0.6)) is want
    assert ak.supported("cpu", dtype, q, npe, cls(1.0, 0.6)) is False


@pytest.mark.parametrize("cls", [NeoHookean, MooneyRivlin], ids=["nh", "autodiff"])
def test_cpu_and_autodiff_assembly_take_the_plain_path(cls):
    """On CPU tensors `assemble_bcsr` runs the plain element stiffness and
    bucket sums (bitwise), launches nothing and builds no slot table or
    block buffer, nor does a CPU solver's set-up."""
    box = _Box("tet10", None, (2, 1, 1))
    mat = cls(1.0, 0.6)
    before = dict(ak.LAUNCHES)
    K, f = assemble_bcsr(box.u, box.mesh.conn, box.geom, mat, box.structure, box.scatter)
    Ke, fe = elk.element_stiffness(box.u[box.mesh.conn], box.geom, mat)
    assert torch.equal(K.data, box.structure.assemble_blocks(Ke))
    assert torch.equal(f, box.scatter(fe))
    assert ak.LAUNCHES == before
    assert "slot_table" not in vars(box.structure) and "element_buffer" not in vars(box.structure)
    bc = DirichletBuilder(box.mesh).fix("zmin").build()
    solver = NewtonSolver(box.mesh, mat, bc, options=SolverOptions(linear="pcg_bcsr",
                                                                   precision="f64"))
    assert "slot_table" not in vars(solver.bcsr)  # the CPU's solver builds none


def test_assembly_spans_keep_their_names():
    """`stiffness` opens before the element pass, `assemble` before the
    sums, and the assembly closes its span (on the CPU: host clock)."""
    box = _Box("tet4", None, (2, 1, 1))
    dev = box.u.device
    profiling.read_spans(dev, profiling.span_table(dev))
    before = {n: profiling.SPAN_TOTALS[n][0] for n in ("stiffness", "assemble")}
    assemble_bcsr(box.u, box.mesh.conn, box.geom, NeoHookean(1.0, 0.6), box.structure,
                  box.scatter)
    profiling.read_spans(dev, profiling.span_table(dev))
    assert all(profiling.SPAN_TOTALS[n][0] == before[n] + 1 for n in before)


# ---------------------------------------------------------------------------
# the benchmark's assembly_roofline (portbench/assembly_yardstick.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_modules():
    """portbench's yardstick modules and the metric's reader, as the
    harness loads them (portbench/ on the path, after the checkout's)."""
    if str(PORTBENCH) not in sys.path:
        sys.path.append(str(PORTBENCH))
    import assembly_yardstick
    import yardstick

    spec = importlib.util.spec_from_file_location(
        "portbench_metric_assembly_roofline", PORTBENCH / "metrics" / "assembly_roofline.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return assembly_yardstick, yardstick, reader


def _bench_config(n):
    import json

    config = json.loads((PORTBENCH / "configs" / "5tet-tet10-1m-bcsr64.json").read_text())
    return dict(config, mesh=dict(config["mesh"], n=n))


def test_assembly_work_at_full_width(bench_modules):
    """918,449,400 B at n=36: the f64 geometry and int32 conn a tet, u and
    f_int a node, 72 B a stored BCSR block; bound by bytes."""
    ay, ys, _ = bench_modules
    nbytes, flops = ay.assembly_work(_bench_config(36))
    E, N, nnzb = 233_280, 342_361, 9_184_321
    assert nbytes == E * ((4 * 10 * 3 + 4) * 8 + 10 * 4) + N * 48 + nnzb * 72 == 918_449_400
    assert flops == E * 4 * 55 * 9 * 8
    assert ys.bound_s((nbytes, flops), "float64") == nbytes / ys.HBM_BYTES_S


@pytest.mark.parametrize("n", [2, 3])
def test_assembly_work_counts_the_programs_mesh(bench_modules, n):
    ay, _, _ = bench_modules
    mesh = box_mesh(n, n, n, element_type="tet10", device="cpu")
    st = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu")
    E = mesh.n_elements
    want = E * ((4 * 10 * 3 + 4) * 8 + 10 * 4) + mesh.n_nodes * 48 + st.nnzb * 72
    assert ay.assembly_work(_bench_config(n))[0] == want


def test_assembly_roofline_reads_the_spans_and_nothing_without_them(bench_modules, monkeypatch):
    ay, ys, reader = bench_modules
    run = types.SimpleNamespace(config=_bench_config(2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "SPAN_TOTALS", {"stiffness": [4, 3_000_000],
                                                   "assemble": [4, 1_000_000]})
    want = 100.0 * ys.bound_s(ay.assembly_work(run.config), "float64") / 1e-3
    assert reader.read(run) == pytest.approx(want)
    monkeypatch.setattr(profiling, "SPAN_TOTALS", {"residual64": [3, 1_000]})
    assert reader.read(run) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert reader.read(run) is None


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


def _card_box(et, n_quad, cells):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return _Box(et, n_quad, cells, device="cuda")


@pytest.mark.parametrize("et,n_quad,cells", ELEMENTS, ids=["tet10", "tet10_5pt", "tet4"])
@pytest.mark.parametrize("kind,cls", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_assembly_kernels_match_plain_on_card(et, n_quad, cells, kind, cls):
    """The element pass against its plain version to 1e-12 of the largest
    value; the slot sum bitwise equal to its plain version on the kernel's
    blocks; two launches of each bitwise equal; `assemble_bcsr` on the card
    against the plain path on the CPU."""
    box = _card_box(et, n_quad, cells)
    mat = cls(1.0, 0.6)
    st, g = box.structure, box.geom
    n0 = dict(ak.LAUNCHES)
    blocks, fe = ak.element_blocks(box.u, st.conn32, g.gradN, g.detJxW, mat)
    blocks2, fe2 = ak.element_blocks(box.u, st.conn32, g.gradN, g.detJxW, mat)
    data = ak.slot_sum(blocks, st.slot_table)
    data2 = ak.slot_sum(blocks, st.slot_table)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == {"stiffness": n0["stiffness"] + 2, "slot_sum": n0["slot_sum"] + 2}
    want_b, want_f = box.plain(mat)
    _close(blocks.cpu(), want_b.cpu())
    _close(fe.cpu(), want_f.cpu())
    assert torch.equal(blocks, blocks2) and torch.equal(fe, fe2) and torch.equal(data, data2)
    assert torch.equal(data, ak.slot_sum_plain(blocks, st.slot_table))
    K, f = assemble_bcsr(box.u, box.mesh.conn, g, mat, st, box.scatter)
    cpu = _Box(et, n_quad, cells)
    Kc, fc = assemble_bcsr(cpu.u, cpu.mesh.conn, cpu.geom, mat, cpu.structure, cpu.scatter)
    _close(K.data.cpu(), Kc.data)
    _close(f.cpu(), fc)


def test_bcsr_newton_solver_takes_the_kernels_on_card():
    """A `NewtonSolver` on linear="pcg_bcsr", precision="f64" builds the
    slot table and block buffer at its set-up and launches the element
    pass, the slot sum and the f64 nodal sum once a Newton step; a
    Mooney-Rivlin solver builds none and takes the plain path."""
    box = _card_box("tet10", None, (2, 2, 2))
    mesh = box.mesh
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    opts = SolverOptions(linear="pcg_bcsr", precision="f64", n_steps=1)
    n0 = (dict(ak.LAUNCHES), ek.LAUNCHES["nodal_sum"])
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=opts)
    assert {"slot_table", "element_buffer"} <= set(vars(solver.bcsr))  # built at set-up
    u, ok, rec = solver._newton(
        torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device="cuda"), 1.0)
    assert ok and rec.newton_iters > 0
    steps = rec.newton_iters
    assert ak.LAUNCHES == {k: n0[0][k] + steps for k in n0[0]}
    assert ek.LAUNCHES["nodal_sum"] >= n0[1] + steps
    n1 = dict(ak.LAUNCHES)
    solver = NewtonSolver(mesh, MooneyRivlin(1.0, 0.6), bc, options=opts)
    assert "slot_table" not in vars(solver.bcsr)
    solver._newton(torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device="cuda"), 1.0)
    assert ak.LAUNCHES == n1


def test_assembly_wrappers_refuse_bad_inputs_on_card():
    """The wrappers raise on what the kernels do not take, and fall back to
    nothing: an autodiff material, f32, an element without a kernel, a
    non-contiguous u, a table on another mesh."""
    box = _card_box("tet10", None, (2, 1, 1))
    st, g, u = box.structure, box.geom, box.u
    nh = NeoHookean(1.0, 0.6)
    with pytest.raises(NotImplementedError):
        ak.element_blocks(u, st.conn32, g.gradN, g.detJxW, MooneyRivlin(1.0, 0.6))
    with pytest.raises(TypeError):
        ak.element_blocks(u.float(), st.conn32, g.gradN, g.detJxW, nh)
    with pytest.raises(ValueError):
        ak.element_blocks(u, st.conn32[:, :4].contiguous(), g.gradN[:, :, :4].contiguous(),
                          g.detJxW, nh)
    with pytest.raises(ValueError):
        ak.element_blocks(u.T.contiguous().T, st.conn32, g.gradN, g.detJxW, nh)
    with pytest.raises(TypeError):
        ak.element_blocks(u, st.conn32.long(), g.gradN, g.detJxW, nh)
    blocks, _ = ak.element_blocks(u, st.conn32, g.gradN, g.detJxW, nh)
    other = _Box("tet10", None, (2, 2, 1), device="cuda").structure.slot_table
    with pytest.raises(ValueError):
        ak.slot_sum(blocks, other)
    with pytest.raises(TypeError):
        ak.slot_sum(blocks.float(), st.slot_table)
