"""The cell bcsr-increment's yardstick and readers, and the operator it
times against the plain reference: on 5-tet TET10 boxes at n=2 and n=3
with a seeded u and direction v, the program's assembled BCSR stiffness
times v (B10's plain version on the CPU) and its f_int against
`reference.fem.Problem`, on every row; B10's work counted from the
benchmark's own mesh against the program's BCSR structure, and at full
width; the readers of `assembly_ms` and `bcsr_spmv_roofline`."""

import portbench_paths  # noqa: F401  (first: the paths)
import json

import numpy as np
import pytest
import torch

import bcsr_yardstick
import harness
import tracing
import yardstick
from reference.fem import Problem
from reference.mesh import BoxMesh

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements.kernels import precompute_geometry
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.utils import profiling

CONFIG = json.loads((portbench_paths.PORTBENCH / "configs" / "5tet-tet10-1m-bcsr64.json")
                    .read_text())
#: both f64 sums of the same element terms, in other orders
REL = 1e-12


def _config(n):
    return dict(CONFIG, mesh=dict(CONFIG["mesh"], n=n))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _assembled(n, seed):
    """(K v, f_int) of the program and of the reference on the half-grid,
    at a seeded u and v."""
    mesh = box_mesh(n, n, n, element_type="tet10", device="cpu")
    structure = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu")
    scatter = NodeScatter.build(mesh.conn_host, mesh.n_nodes, "cpu")
    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    rng = np.random.default_rng(seed)
    u = torch.tensor(0.01 * rng.standard_normal((mesh.n_nodes, 3)))
    v = torch.tensor(rng.standard_normal((mesh.n_nodes, 3)))
    K, f_int = assemble_bcsr(u, mesh.conn, geom, NeoHookean(1.0, 0.6), structure, scatter)
    prob = Problem(BoxMesh("5tet", n), 1.0, 0.6, CONFIG["bc"], "cpu")
    idx = torch.as_tensor(prob.mesh.locate(mesh.coords_host))

    def on_grid(x):
        g = prob.zeros()
        g[idx] = x
        return g

    ref_u = on_grid(u)
    return (on_grid(K.matvec(v)), prob.tangent_apply(ref_u, on_grid(v)),
            on_grid(f_int), prob.internal_force(ref_u))


@pytest.mark.parametrize("n", [2, 3])
def test_assembled_stiffness_times_v_is_the_references_tangent_action(n):
    kv, ref_kv, _, _ = _assembled(n, 3_000_000_031 + n)
    assert _rel(kv, ref_kv) <= REL


@pytest.mark.parametrize("n", [2, 3])
def test_assembled_internal_force_is_the_references(n):
    _, _, f_int, ref_f = _assembled(n, 3_000_000_037 + n)
    assert _rel(f_int, ref_f) <= REL


@pytest.mark.parametrize("n", [2, 3])
def test_counted_blocks_are_the_programs(n):
    mesh = box_mesh(n, n, n, element_type="tet10", device="cpu")
    structure = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu")
    assert bcsr_yardstick.blocks(_config(n)) == (mesh.n_nodes, structure.nnzb)


def test_work_at_full_width():
    # 5-tet n=36: 342,361 nodes, 9,184,321 stored blocks; 715.8 MB, bytes-bound
    assert bcsr_yardstick.blocks(CONFIG) == (342_361, 9_184_321)
    nbytes, flops = bcsr_yardstick.spmv_work(CONFIG)
    assert nbytes == 76 * 9_184_321 + 4 * 342_362 + 48 * 342_361 == 715_811_172
    assert flops == 18 * 9_184_321
    assert yardstick.bound_s((nbytes, flops), "float64") == nbytes / yardstick.HBM_BYTES_S
    assert round(yardstick.bound_s((nbytes, flops), "float64") * 1e3, 4) == 0.2137


class _Run:
    def __init__(self, config, kernels):
        self.config = config
        self.trace = tracing.Trace(busy_s=1.0, window_s=1.0, kernels=kernels,
                                   in_graphs=set(kernels), ops={}, gaps=[], requests=1)


def test_the_roofline_reads_b10_under_the_graph_launches():
    b10 = "void (anonymous namespace)::spmv_kernel<double>(int const*, int const*, double const*)"
    other = "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>"
    read = harness.reader("bcsr_spmv_roofline.bcsr").read
    got = read(_Run(_config(2), {b10: [2e-6, 4e-6], other: [1e-6]}))
    want = yardstick.roofline_share(bcsr_yardstick.spmv_work(_config(2)), "float64", 3e-6)
    assert got == pytest.approx(want)
    assert read(_Run(_config(2), {other: [1e-6]})) is None


def test_assembly_ms_reads_its_spans_and_nothing_without_them(monkeypatch):
    read = harness.reader("assembly_ms.bcsr").read
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "SPAN_TOTALS", {"stiffness": [4, 120_000_000],
                                                   "assemble": [4, 30_000_000]})
    assert read(None) == pytest.approx(150.0 / 4)
    # a program whose table has no such spans (a checkout older than them)
    monkeypatch.setattr(profiling, "SPAN_TOTALS", {"jacobi": [4, 5_000_000]})
    assert read(None) is None
