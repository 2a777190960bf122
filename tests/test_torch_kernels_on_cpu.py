"""PyTorch port: the CUDA sources of the kernels whose threads share a
block's work, run on the CPU against their plain versions.

B10 (`csrc/bcsr_kernels.cu`: a warp per block row, a shuffle tree), the
five kernels of `csrc/struct_kernels.cu`, all one thread per (tet slot,
cell): B1 (`apply_kernel`), B3 (`diag_kernel`), B4 (`force_kernel`) and B5
(`resid_kernel`, in double), whose register sums end in a shared-memory
combine behind `__syncthreads()`, and B2 (`freeze_kernel`), whose threads
store their own rows, and, of `csrc/elem_kernels.cu`, the unstructured
block-Jacobi diagonal (`diag_kernel`, a thread per element writing padded
slot sums, and `diag_sum_kernel`, a thread per node summing them in the
valence buckets' order), B6 (`apply_kernel`, a thread per element that
gathers its own nodal values through the int32 connectivity) and the
fixed-order nodal sum (`nodal_sum_kernel`, a thread per node, f32 and
f64), and the f64 assembly of `csrc/assembly_kernels.cu`
(`stiffness_kernel`, a block of tets in shared memory and a thread per
stored block, and `slot_sum_kernel`, a thread per BCSR slot), are compiled
with g++ against `tests/cuda_on_cpu/cuda_runtime.h`, which runs every CUDA
block as real host threads with barriers for `__syncthreads()` and for the
warp shuffles. The C interface is then called on CPU tensors exactly as the
wrappers call it on the card. This holds the kernels' indexing, masking of
ragged tiles, reduction order and determinism on a machine without nvcc;
the `*_on_card` tests and `chip_smoke.py` hold the nvcc build on a card.

Tolerances as on the card: f64 1e-12 and f32 2e-5 of the largest entry
(another summation order than the plain version); two launches bitwise
equal. Skips where g++ is absent or lacks C++20's <barrier>.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure
from fea_large_tpu_torch.elements.kernels import precompute_geometry
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import assembly_kernels as ak
from fea_large_tpu_torch.ops import bcsr_kernels as bk, cuda_build, soa, struct_kernels as sk
from fea_large_tpu_torch.ops import elem_kernels as ek

torch.set_num_threads(2)

STUB = Path(__file__).parent / "cuda_on_cpu"
MATERIALS = (StVenantKirchhoff(1.0, 0.6), NeoHookean(1.0, 0.6), NeoHookeanVolumetric(1.0, 0.6))
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*?>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def _split_args(args: str) -> list:
    """The comma-separated arguments of a launch's <<<...>>>, split only at
    commas outside parentheses (a grid may be a call, `grid_for(E, block)`)."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(args):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            parts.append(args[start:i])
            start = i + 1
    return [*parts, args[start:]]


def _rewrite_launches(src: str) -> str:
    """`name<...><<<grid, block, shared, stream>>>(args)` ->
    `CUDA_ON_CPU_LAUNCH((name<...>), grid, block, args)`."""
    out, pos = [], 0
    for m in iter(lambda: LAUNCH.search(src, pos), None):
        depth, end = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[end], 0)
            end += 1
        grid, block = (c.strip() for c in _split_args(m.group(2))[:2])
        out.append(src[pos:m.start()])
        out.append(f"CUDA_ON_CPU_LAUNCH(({m.group(1)}), {grid}, {block}, {src[m.end():end - 1]})")
        pos = end
    return "".join(out) + src[pos:]


def _build(source: Path, tmp: Path) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source against the CPU stand-in")
    flags = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", f"-I{STUB}"]
    probe = tmp / "probe.cpp"
    probe.write_text("#include <cuda_runtime.h>\n")
    if subprocess.run([*flags, "-o", str(tmp / "probe.so"), str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("needs a g++ with C++20 <barrier> for the CPU stand-in of the CUDA runtime")
    cpp = tmp / (source.stem + ".cpp")
    cpp.write_text(_rewrite_launches(source.read_text()))
    lib = tmp / f"lib{source.stem}.so"
    proc = subprocess.run([*flags, f"-I{cuda_build.CSRC}", "-o", str(lib), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


def _ptr(t: torch.Tensor):
    assert t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


@pytest.fixture(scope="module")
def bcsr_lib(tmp_path_factory):
    lib = _build(bk.SOURCE, tmp_path_factory.mktemp("bcsr"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in ("fea_bcsr_spmv_f64", "fea_bcsr_spmv_f32"):
        getattr(lib, fn).argtypes = [P] * 5 + [I] * 2 + [P]
        getattr(lib, fn).restype = I
    return lib


@pytest.fixture(scope="module")
def struct_lib(tmp_path_factory):
    lib = _build(sk.SOURCE, tmp_path_factory.mktemp("struct"))
    P, I = ctypes.c_void_p, ctypes.c_int
    F, D = ctypes.c_float, ctypes.c_double
    for fn, argtypes in {"fea_struct_apply_f32": [P] * 11 + [I] * 5 + [P],
                         "fea_struct_diag_f32": [P] * 10 + [I] * 5 + [P],
                         "fea_struct_freeze_f32": [P] * 8 + [I] * 5 + [F, F, P],
                         "fea_struct_force_f32": [P] * 7 + [I] * 5 + [P],
                         "fea_struct_resid_f64": [P] * 6 + [I] * 6 + [D, D, P]}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    return lib


@pytest.mark.parametrize("et,cells", [("tet10", (3, 2, 1)), ("tet4", (4, 4, 2))],
                         ids=["tet10", "tet4"])
def test_spmv_source_matches_plain_on_cpu_threads(bcsr_lib, et, cells):
    """B10 on rows of 10-85 (TET10: longer than the 32 lanes) and 4-19 (TET4:
    shorter) blocks, a row count that fills no CUDA block of 128 threads,
    blocks of 32 and 128 threads: the same y, bitwise, whatever the block
    size."""
    mesh = box_mesh(*cells, element_type=et, device="cpu")
    st = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu")
    N = st.n_nodes
    assert N % (bk.BLOCK // bk.LANES) != 0
    rng = np.random.default_rng(1)
    data64 = torch.tensor(rng.standard_normal((st.nnzb, 3, 3)))
    x64 = torch.tensor(rng.standard_normal((N, 3)))
    for dtype, sfx, bound in ((torch.float64, "f64", 1e-12), (torch.float32, "f32", 2e-5)):
        data, x = data64.to(dtype).contiguous(), x64.to(dtype).contiguous()
        plain = bk.bcsr_spmv_plain(st, data, x)
        ys = []
        for block in (32, 128):
            y = torch.full_like(x, float("nan"))
            err = getattr(bcsr_lib, f"fea_bcsr_spmv_{sfx}")(
                _ptr(st.indptr32), _ptr(st.indices32), _ptr(data), _ptr(x), _ptr(y), N, block,
                None)
            assert err == 0
            assert float((y - plain).abs().max()) <= bound * float(plain.abs().max())
            ys.append(y)
        assert torch.equal(*ys)


def test_spmv_source_refuses_other_block_sizes(bcsr_lib):
    z = torch.zeros(4, dtype=torch.float64)
    i = torch.zeros(4, dtype=torch.int32)
    for block in (0, 100, 512):
        assert bcsr_lib.fea_bcsr_spmv_f64(_ptr(i), _ptr(i), _ptr(z), _ptr(z), _ptr(z), 1, block,
                                          None) != 0


RAGGED = pytest.mark.parametrize(
    "et,cells", [("tet10", (5, 3, 3)), ("tet4", (7, 3, 2)), ("tet10", (4, 3, 2))],
    ids=["tet10-45", "tet4-42", "tet10-24"])


def _lattice(et, cells, material=NeoHookean(1.0, 0.6), dtype=torch.float32, n_quad=None):
    """A Kuhn lattice whose C is not a multiple of the 32-cell tile of a
    block (45 and 42: rows that start anywhere within a 32-byte sector, so
    B2's blocks overlap; 24: a multiple of 8, so they do not): its problem
    in `dtype`, the pair caches of a displacement u and a direction v, and
    the state rows frozen at u."""
    mesh = box_mesh_kuhn(*cells, element_type=et, device="cpu", n_quad=n_quad)
    p = soa.SoAProblem.build(mesh, dtype)
    tb = p.tables
    assert tb.C % 32 != 0
    c = mesh.coords_host.T
    u = np.stack([0.01 * np.sin(np.pi * c[0]) * c[2], np.zeros_like(c[0]), -0.05 * c[2]])
    v = np.cos(np.pi * c) * (1.0 + c[::-1])
    uc, vc = (sk.gather_cache(p.structure, tb.pairs, torch.tensor(x, dtype=dtype)).contiguous()
              for x in (u, v))
    rows = [r.contiguous() for r in sk.struct_freeze_plain(tb, uc, material)]
    return tb, uc, vc, rows


def _launch_lattice(lib, name, tb, cache, vcache, rows, material):
    """One launch of lattice kernel `name` through the C interface, as the
    wrappers of ops/struct_kernels.py make it, on outputs pre-filled with
    NaN: (outputs, plain outputs, CUDA error code)."""
    geo = (_ptr(tb.gN), _ptr(tb.dV), _ptr(tb.pair_of), _ptr(tb.slot_table))
    dims = (tb.C, tb.q, tb.npe, tb.T)
    state = [_ptr(r) for r in rows]
    if name == "freeze":
        plain = sk.struct_freeze_plain(tb, cache, material)
        outs = [torch.full_like(r, float("nan")) for r in plain]
        err = lib.fea_struct_freeze_f32(_ptr(cache), geo[0], geo[2], *(_ptr(o) for o in outs),
                                        *dims, material.kind, material.lam, material.mu, None)
        return outs, plain, err
    n_rows = 9 * tb.P if name == "diag" else 3 * tb.P
    out = torch.full((n_rows, tb.C), float("nan"), dtype=cache.dtype)
    if name == "apply":
        err = lib.fea_struct_apply_f32(_ptr(vcache), *state, *geo, _ptr(out), *dims, tb.P, None)
        plain = sk.struct_apply_plain(tb, vcache, *rows)
    elif name == "diag":
        err = lib.fea_struct_diag_f32(*state, *geo, _ptr(out), *dims, tb.P, None)
        plain = sk.struct_diag_plain(tb, *rows)
    elif name == "force":
        err = lib.fea_struct_force_f32(*state[:2], *geo, _ptr(out), *dims, tb.P, None)
        plain = sk.struct_force_plain(tb, *rows[:2])
    else:
        err = lib.fea_struct_resid_f64(_ptr(cache), *geo, _ptr(out), *dims, tb.P, material.kind,
                                       material.lam, material.mu, None)
        plain = sk.struct_resid_plain(tb, cache, material)
    return [out], [plain], err


def _check_lattice(lib, name, et, cells, material=NeoHookean(1.0, 0.6), n_quad=None):
    """Kernel `name` launched twice on one lattice: every output written
    (none left NaN), the two launches bitwise equal, and within 2e-5 (f32;
    the f64 residual 1e-12) of the plain version's largest entry: another
    summation order than the plain version's. Returns (tables, outputs)."""
    dtype, bound = (torch.float64, 1e-12) if name == "resid" else (torch.float32, 2e-5)
    tb, cache, vcache, rows = _lattice(et, cells, material, dtype, n_quad)
    (first, plain, err1), (second, _, err2) = (
        _launch_lattice(lib, name, tb, cache, vcache, rows, material) for _ in range(2))
    assert err1 == 0 and err2 == 0
    for a, b, ref in zip(first, second, plain):
        assert torch.equal(a, b)
        assert float((a - ref).abs().max()) <= bound * float(ref.abs().max())
    return tb, first


@RAGGED
def test_apply_source_matches_plain_on_cpu_threads(struct_lib, et, cells):
    """B1 on ragged lattices; two launches bitwise equal."""
    _check_lattice(struct_lib, "apply", et, cells)


@RAGGED
def test_diag_source_matches_plain_on_cpu_threads(struct_lib, et, cells):
    """B3 on ragged lattices: every one of the 9P rows written by the
    combine, the mirrored lower triangle within the f32 bound of the plain
    version's; two launches bitwise equal."""
    tb, (out,) = _check_lattice(struct_lib, "diag", et, cells)
    blocks = out.view(tb.P, 3, 3, tb.C)
    assert torch.equal(blocks, blocks.transpose(1, 2))


@RAGGED
@pytest.mark.parametrize("material", MATERIALS, ids=lambda m: m.name)
def test_freeze_source_matches_plain_on_cpu_threads(struct_lib, et, cells, material):
    """B2 on ragged lattices, for the three material kinds: each of the five
    outputs (F, S, A, alpha, beta) against the plain version's; two
    launches bitwise equal."""
    _check_lattice(struct_lib, "freeze", et, cells, material)


@RAGGED
def test_force_source_matches_plain_on_cpu_threads(struct_lib, et, cells):
    """B4 on ragged lattices: every one of the 3P rows written by the
    combine; two launches bitwise equal."""
    _check_lattice(struct_lib, "force", et, cells)


@RAGGED
@pytest.mark.parametrize("material", MATERIALS, ids=lambda m: m.name)
def test_resid_source_matches_plain_on_cpu_threads(struct_lib, et, cells, material):
    """B5 (f64) on ragged lattices, for the three material kinds: within
    1e-12 of the plain version (another summation order, and the stress
    from the symmetric half of C); two launches bitwise equal."""
    _check_lattice(struct_lib, "resid", et, cells, material)


@pytest.mark.parametrize("name", ["freeze", "apply", "diag", "force", "resid"])
def test_five_point_rule_source_matches_plain_on_cpu_threads(struct_lib, name):
    """The (q, npe, T) = (5, 10, 6) instances of B1-B5 (a TET10 lattice with
    the 5-point rule, `Mesh.n_quad = 5`) on a ragged lattice of 45 cells."""
    tb, _ = _check_lattice(struct_lib, name, "tet10", (5, 3, 3), n_quad=5)
    assert (tb.q, tb.npe, tb.T) == (5, 10, 6) and (tb.q, tb.npe, tb.T) in sk.SUPPORTED


def test_lattice_source_refuses_other_rules(struct_lib):
    """A (q, npe) with no instance (TET4 with a 4-point rule) is refused by
    the C interface, as the wrappers refuse it before (`_check`)."""
    material = NeoHookean(1.0, 0.6)
    tb, cache, vcache, rows = _lattice("tet4", (4, 3, 2), material, n_quad=4)
    assert (tb.q, tb.npe, tb.T) == (4, 4, 6) and (tb.q, tb.npe, tb.T) not in sk.SUPPORTED
    assert _launch_lattice(struct_lib, "force", tb, cache, vcache, rows, material)[2] != 0


@pytest.fixture(scope="module")
def elem_lib(tmp_path_factory):
    lib = _build(ek.SOURCE, tmp_path_factory.mktemp("elem"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in {"fea_elem_diag_f32": [P] * 8 + [I] * 4 + [P],
                         "fea_elem_diag_sum_f32": [P] * 4 + [I] * 2 + [P],
                         "fea_elem_apply_f32": [P] * 10 + [I] * 5 + [P],
                         "fea_elem_nodal_sum_f32": [P] * 4 + [I] * 4 + [P],
                         "fea_elem_nodal_sum_f64": [P] * 4 + [I] * 4 + [P]}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    return lib


def _launch_diag(lib, p, rows, block):
    """The unstructured diagonal through the C interface, as `ek.elem_diag`
    launches it (the element pass into a NaN-filled slot scratch, then the
    nodal sum into NaN-filled blocks): (blocks [3, 3, N], CUDA errors)."""
    q, npe, gradN, dV = ek.flat_tables(p)
    E = gradN.shape[-1]
    N = p.buckets.inv.shape[0]
    slots = torch.full((npe * E, ek.SLOT_PAD), float("nan"))
    out = torch.full((3, 3, N), float("nan"))
    err1 = lib.fea_elem_diag_f32(_ptr(gradN), _ptr(dV), *(_ptr(r) for r in rows), _ptr(slots),
                                 E, q, npe, block, None)
    offsets, ids, _ = p.buckets.csr
    err2 = lib.fea_elem_diag_sum_f32(_ptr(slots), _ptr(offsets), _ptr(ids), _ptr(out), N, block,
                                     None)
    return out, (err1, err2)


def _sharded_problem(et):
    """The shard with the most padding of a 5-tet box cut into 3 slabs: its
    f32 SoA problem (padded elements with zero geometry) and its stacked
    buckets, which hold mask-0 padding rows, as the sharded ranks build
    them (`shard_soa`), and the shard's nodes' coordinates."""
    from fea_large_tpu_torch.dist.partition import partition_mesh
    from fea_large_tpu_torch.dist.sharded import shard_soa

    mesh = box_mesh(5, 2, 2, element_type=et, device="cpu")
    part = partition_mesh(mesh, 3, method="slab")
    r = int(np.argmin((part.elem_global >= 0).sum(axis=1)))
    p = shard_soa(mesh, part, r, "cpu", mixed=True).p32
    padded = int((part.elem_global[r] < 0).sum())
    named = p.buckets.inv.shape[0]
    rows = sum(m.shape[0] for m in p.buckets.mask)
    zero_rows = sum(int((m.sum(1) == 0).sum()) for m in p.buckets.mask)
    assert padded > 0 and rows > named and zero_rows > 0
    return p, part.from_global(mesh.coords_host, space="local")[r]


DIAG_CASES = {
    "tet4": lambda: box_mesh(4, 3, 2, element_type="tet4", device="cpu"),
    "tet10": lambda: box_mesh(4, 3, 2, element_type="tet10", device="cpu"),
    "tet10-5pt": lambda: box_mesh(4, 3, 2, element_type="tet10", device="cpu", n_quad=5),
}


def _problem(case):
    """(f32 problem, node coordinates) of a DIAG_CASES box or of a shard
    ("tet10-shard", "tet4-shard": `_sharded_problem`)."""
    if case.endswith("-shard"):
        return _sharded_problem(case.split("-")[0])
    mesh = DIAG_CASES[case]()
    return soa.SoAProblem.build(mesh, torch.float32), mesh.coords_host


def _nodal_fields(coords, dtype=torch.float32):
    """A smooth displacement u and direction v [3, N] on the nodes."""
    c = coords.T
    u = np.stack([0.01 * np.sin(np.pi * c[0]) * c[2], 0.02 * c[0] * c[1], -0.05 * c[2]])
    v = np.stack([np.cos(np.pi * c[1]) * c[2], 0.5 * c[0] - c[2], np.sin(np.pi * c[0]) + c[1]])
    return torch.tensor(u, dtype=dtype), torch.tensor(v, dtype=dtype)


@pytest.mark.parametrize("case", [*DIAG_CASES, "tet10-shard", "tet4-shard"])
def test_elem_diag_source_matches_plain_on_cpu_threads(elem_lib, case):
    """The unstructured diagonal's two kernels (`fea_elem_diag_f32`,
    `fea_elem_diag_sum_f32`) against `ek.elem_diag_plain`: TET4 (q = 1),
    TET10 with the 4-point and the 5-point rule on a box of 120 elements (a
    partial last block of 32 and of 128), and a shard of a box cut into
    slabs, whose padded elements sum nothing and whose stacked buckets
    hold mask-0 padding rows. Blocks of 32 and 128 threads: every block
    written, symmetric, within 2e-5 of the plain version's largest entry,
    bitwise equal across block sizes and across two launches."""
    p, coords = _problem(case)
    q, npe, gradN, dV = ek.flat_tables(p)
    assert (q, npe) in ek.SUPPORTED and gradN.shape[-1] % 32 != 0
    state = soa.soa_freeze(p, NeoHookean(1.0, 0.6), _nodal_fields(coords)[0])
    rows = [r.contiguous() for r in ek.flatten_state(state)]
    plain = ek.elem_diag_plain(gradN, dV, *rows, p.buckets, npe=npe, q=q)
    outs = []
    for block in (32, 128, 128):
        out, errs = _launch_diag(elem_lib, p, rows, block)
        assert errs == (0, 0)
        assert not out.isnan().any()
        assert torch.equal(out, out.transpose(0, 1))
        assert float((out - plain).abs().max()) <= 2e-5 * float(plain.abs().max())
        outs.append(out)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def test_elem_diag_source_refuses_bad_launches(elem_lib):
    """A (q, npe) with no instance, a block that is not a multiple of 32 or
    is over the element pass's 128 are refused by the C interface; so are a
    nodal sum over no node and one in blocks that are not a multiple of 32."""
    z = torch.zeros(8)
    i = torch.zeros(2, dtype=torch.int32)
    for q, npe, block in ((4, 4, 32), (4, 10, 100), (4, 10, 256)):
        assert elem_lib.fea_elem_diag_f32(*(_ptr(z) for _ in range(8)), 1, q, npe, block,
                                          None) != 0
    for n, block in ((0, 32), (1, 100)):
        assert elem_lib.fea_elem_diag_sum_f32(_ptr(z), _ptr(i), _ptr(i), _ptr(z), n, block,
                                              None) != 0


@pytest.mark.parametrize("case", [*DIAG_CASES, "tet10-shard", "tet4-shard"])
def test_elem_apply_source_matches_plain_on_cpu_threads(elem_lib, case):
    """B6 with the gather folded in (`fea_elem_apply_f32` on v [3, N] and the
    int32 `conn32`) against the plain gather (`soa_gather`) and
    `ek.elem_apply_plain`: TET4, TET10 with the 4- and 5-point rules on a
    box of 120 elements (a partial last block of 32 and of 128), and a
    shard whose padded elements sum nothing. Blocks of 32 and 128 threads:
    every output written, within 2e-5 of the plain version's largest entry,
    bitwise equal across block sizes and across two launches."""
    p, coords = _problem(case)
    q, npe, gradN, dV = ek.flat_tables(p)
    E = gradN.shape[-1]
    assert (q, npe) in ek.SUPPORTED and E % 32 != 0 and p.conn32.dtype == torch.int32
    u, v = _nodal_fields(coords)
    rows = [r.contiguous() for r in ek.flatten_state(soa.soa_freeze(p, NeoHookean(1.0, 0.6), u))]
    ve = soa.soa_gather(p, v).transpose(0, 1).reshape(3 * npe, E)
    plain = ek.elem_apply_plain(ve, gradN, dV, *rows, npe=npe, q=q)
    outs = []
    for block in (32, 128, 128):
        out = torch.full((3 * npe, E), float("nan"))
        err = elem_lib.fea_elem_apply_f32(_ptr(v), _ptr(p.conn32), _ptr(gradN), _ptr(dV),
                                          *(_ptr(r) for r in rows), _ptr(out), E, p.n_nodes, q,
                                          npe, block, None)
        assert err == 0 and not out.isnan().any()
        assert float((out - plain).abs().max()) <= 2e-5 * float(plain.abs().max())
        outs.append(out)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["tet4", "tet10", "tet10-shard", "tet4-shard"])
def test_nodal_sum_source_matches_buckets_on_cpu_threads(elem_lib, case, dtype):
    """The fixed-order nodal sum (`fea_elem_nodal_sum_f32`/`_f64`, walking
    `ScatterBuckets.csr`) against `ScatterBuckets.apply` on per-slot values
    of three channels: TET4 and TET10 boxes and shards whose stacked
    buckets hold mask-0 padding rows (named by no node). Within 2e-5 (f32)
    and 1e-12 (f64) of the largest entry; every node written; blocks of 32
    and 128 and two launches bitwise equal."""
    p, _ = _problem(case)
    offsets, ids, span = p.buckets.csr
    N, M = p.n_nodes, p.conn_T.numel()
    assert offsets.shape == (N + 1,) and span <= M
    d = torch.tensor(np.random.default_rng(5).standard_normal((3, M)), dtype=dtype)
    plain = p.buckets.apply(d)
    fn = getattr(elem_lib, "fea_elem_nodal_sum_" + ("f32" if dtype == torch.float32 else "f64"))
    bound = 2e-5 if dtype == torch.float32 else 1e-12
    outs = []
    for block in (32, 128, 128):
        out = torch.full((3, N), float("nan"), dtype=dtype)
        assert fn(_ptr(d), _ptr(offsets), _ptr(ids), _ptr(out), 3, M, N, block, None) == 0
        assert not out.isnan().any()
        assert float((out - plain).abs().max()) <= bound * float(plain.abs().max())
        outs.append(out)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])


def test_nodal_sum_and_apply_sources_refuse_bad_launches(elem_lib):
    """The nodal sum refuses a channel count other than 3, no node, no slot
    and blocks that are not a multiple of 32 up to 256; B6 refuses a (q,
    npe) with no instance, no node and such blocks."""
    z = torch.zeros(64, dtype=torch.float64)
    i = torch.zeros(2, dtype=torch.int32)
    for fn in (elem_lib.fea_elem_nodal_sum_f32, elem_lib.fea_elem_nodal_sum_f64):
        assert fn(_ptr(z), _ptr(i), _ptr(i), _ptr(z), 3, 1, 1, 32, None) == 0
        for C, M, N, block in ((1, 1, 1, 32), (4, 1, 1, 32), (3, 1, 0, 32), (3, 0, 1, 32),
                               (3, 1, 1, 100), (3, 1, 1, 512)):
            assert fn(_ptr(z), _ptr(i), _ptr(i), _ptr(z), C, M, N, block, None) != 0
    for N, q, npe, block in ((1, 4, 4, 32), (0, 4, 10, 32), (1, 4, 10, 100), (1, 4, 10, 512)):
        assert elem_lib.fea_elem_apply_f32(*(_ptr(z) for _ in range(10)), 1, N, q, npe, block,
                                           None) != 0


@pytest.fixture(scope="module")
def asm_lib(tmp_path_factory):
    lib = _build(ak.SOURCE, tmp_path_factory.mktemp("asm"))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn, argtypes in {"fea_asm_stiffness_f64": [P] * 6 + [I] * 4 + [D, D, P],
                         "fea_asm_slot_sum_f64": [P] * 4 + [I, P]}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    return lib


@pytest.mark.parametrize("et,n_quad,cells", [("tet10", None, (3, 1, 1)), ("tet10", 5, (3, 1, 1)),
                                             ("tet4", None, (7, 2, 1))],
                         ids=["tet10", "tet10_5pt", "tet4"])
@pytest.mark.parametrize("material", MATERIALS, ids=lambda m: m.name)
def test_assembly_sources_match_plain_on_cpu_threads(asm_lib, et, n_quad, cells, material):
    """The f64 assembly's element pass (a block of 4, 6 or 32 tets, a
    thread a stored block, phases behind barriers) on 15 and 70 tets, which
    fill no last block, against `element_blocks_plain` to 1e-12 of the
    largest value; its slot sum (a thread a slot, blocks of 32 slots, the
    last partly filled) bitwise equal to `slot_sum_plain` on the kernel's
    blocks; two launches of each bitwise equal."""
    mesh = box_mesh(*cells, element_type=et, device="cpu", n_quad=n_quad)
    st = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu")
    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    E, q, npe, _ = geom.gradN.shape
    assert E % {4: 4, 5: 6, 1: 32}[q] != 0 and st.nnzb % 32 != 0
    u = _nodal_fields(mesh.coords_host, torch.float64)[0].T.contiguous()
    want_b, want_f = ak.element_blocks_plain(u, st.conn32, geom.gradN, geom.detJxW, material)
    outs = []
    for _ in range(2):
        blocks = torch.full(want_b.shape, float("nan"), dtype=torch.float64)
        fe = torch.full(want_f.shape, float("nan"), dtype=torch.float64)
        data = torch.full((st.nnzb, 3, 3), float("nan"), dtype=torch.float64)
        assert asm_lib.fea_asm_stiffness_f64(
            _ptr(u), _ptr(st.conn32), _ptr(geom.gradN), _ptr(geom.detJxW), _ptr(blocks),
            _ptr(fe), E, q, npe, material.kind, material.lam, material.mu, None) == 0
        tb = st.slot_table
        assert asm_lib.fea_asm_slot_sum_f64(_ptr(blocks), _ptr(tb.offsets), _ptr(tb.codes),
                                            _ptr(data), st.nnzb, None) == 0
        outs.append((blocks, fe, data))
    (blocks, fe, data), again = outs
    for got, want in ((blocks, want_b), (fe, want_f)):
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert torch.equal(data, ak.slot_sum_plain(blocks, tb))
    assert all(torch.equal(a, b) for a, b in zip(outs[0], again))


def test_assembly_sources_refuse_bad_launches(asm_lib):
    """An element without an instance, a material code outside 0-2 and an
    empty launch are refused before any launch (CUDA's invalid value)."""
    null = ctypes.c_void_p(0)
    for q, npe, kind, E in ((4, 4, 1, 8), (4, 10, 3, 8), (4, 10, 1, 0)):
        assert asm_lib.fea_asm_stiffness_f64(*[null] * 6, E, q, npe, kind, 1.0, 0.6, None) == 1
    assert asm_lib.fea_asm_slot_sum_f64(*[null] * 4, 0, None) == 1
