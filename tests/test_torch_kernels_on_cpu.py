"""PyTorch port: the CUDA sources of the kernels whose threads share a
block's work, run on the CPU against their plain versions.

B10 (`csrc/bcsr_kernels.cu`: a warp per block row, a shuffle tree) and, of
`csrc/struct_kernels.cu`, B1 (`apply_kernel`) and B3 (`diag_kernel`: one
thread per (tet slot, cell), a shared-memory combine behind
`__syncthreads()`, B3's in three rounds) and B2 (`freeze_kernel`: one thread
per (tet slot, cell), each storing its own rows) are compiled
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
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import bcsr_kernels as bk, cuda_build, soa, struct_kernels as sk

torch.set_num_threads(2)

STUB = Path(__file__).parent / "cuda_on_cpu"
MATERIALS = (StVenantKirchhoff(1.0, 0.6), NeoHookean(1.0, 0.6), NeoHookeanVolumetric(1.0, 0.6))
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*?>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def _rewrite_launches(src: str) -> str:
    """`name<...><<<grid, block, shared, stream>>>(args)` ->
    `CUDA_ON_CPU_LAUNCH((name<...>), grid, block, args)`."""
    out, pos = [], 0
    for m in iter(lambda: LAUNCH.search(src, pos), None):
        depth, end = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[end], 0)
            end += 1
        grid, block = (c.strip() for c in m.group(2).split(",")[:2])
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
    F = ctypes.c_float
    for fn, argtypes in {"fea_struct_apply_f32": [P] * 11 + [I] * 5 + [P],
                         "fea_struct_diag_f32": [P] * 10 + [I] * 5 + [P],
                         "fea_struct_freeze_f32": [P] * 8 + [I] * 5 + [F, F, P]}.items():
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


def _lattice(et, cells, material=NeoHookean(1.0, 0.6)):
    """A Kuhn lattice whose C is not a multiple of the 32-cell tile of a
    block (45 and 42: rows that start anywhere within a 32-byte sector, so
    B2's blocks overlap; 24: a multiple of 8, so they do not): its f32
    problem, the pair caches of a displacement u and a direction v, and the
    state rows frozen at u."""
    mesh = box_mesh_kuhn(*cells, element_type=et, device="cpu")
    p = soa.SoAProblem.build(mesh, torch.float32)
    tb = p.tables
    assert tb.C % 32 != 0
    c = mesh.coords_host.T
    u = np.stack([0.01 * np.sin(np.pi * c[0]) * c[2], np.zeros_like(c[0]), -0.05 * c[2]])
    v = np.cos(np.pi * c) * (1.0 + c[::-1])
    uc, vc = (sk.gather_cache(p.structure, tb.pairs, torch.tensor(x, dtype=torch.float32)).contiguous()
              for x in (u, v))
    rows = [r.contiguous() for r in sk.struct_freeze_plain(tb, uc, material)]
    return tb, uc, vc, rows


def _assert_matches(outs, plain):
    """Two launches bitwise equal, and within 2e-5 of the plain version's
    largest entry."""
    assert torch.equal(*outs)
    assert float((outs[0] - plain).abs().max()) <= 2e-5 * float(plain.abs().max())


@RAGGED
def test_apply_source_matches_plain_on_cpu_threads(struct_lib, et, cells):
    """B1 on ragged lattices; two launches bitwise equal."""
    tb, _, cache, rows = _lattice(et, cells)
    outs = []
    for _ in range(2):
        out = torch.full((3 * tb.P, tb.C), float("nan"), dtype=torch.float32)
        err = struct_lib.fea_struct_apply_f32(
            _ptr(cache), *(_ptr(r) for r in rows), _ptr(tb.gN), _ptr(tb.dV), _ptr(tb.pair_of),
            _ptr(tb.slot_table), _ptr(out), tb.C, tb.q, tb.npe, tb.T, tb.P, None)
        assert err == 0
        outs.append(out)
    _assert_matches(outs, sk.struct_apply_plain(tb, cache, *rows))


@RAGGED
def test_diag_source_matches_plain_on_cpu_threads(struct_lib, et, cells):
    """B3 on ragged lattices: every one of the 9P rows written (none left
    NaN) by the three rounds of the combine, the mirrored lower triangle
    within the f32 bound of the plain version's; two launches bitwise
    equal."""
    tb, _, _, rows = _lattice(et, cells)
    outs = []
    for _ in range(2):
        out = torch.full((9 * tb.P, tb.C), float("nan"), dtype=torch.float32)
        err = struct_lib.fea_struct_diag_f32(
            *(_ptr(r) for r in rows), _ptr(tb.gN), _ptr(tb.dV), _ptr(tb.pair_of),
            _ptr(tb.slot_table), _ptr(out), tb.C, tb.q, tb.npe, tb.T, tb.P, None)
        assert err == 0
        outs.append(out)
    _assert_matches(outs, sk.struct_diag_plain(tb, *rows))
    blocks = outs[0].view(tb.P, 3, 3, tb.C)
    assert torch.equal(blocks, blocks.transpose(1, 2))


@RAGGED
@pytest.mark.parametrize("material", MATERIALS, ids=lambda m: m.name)
def test_freeze_source_matches_plain_on_cpu_threads(struct_lib, et, cells, material):
    """B2 on ragged lattices, for the three material kinds: each of the five
    outputs (F, S, A, alpha, beta) against the plain version's; two
    launches bitwise equal."""
    tb, cache, _, plain = _lattice(et, cells, material)
    runs = []
    for _ in range(2):
        outs = [torch.full_like(r, float("nan")) for r in plain]
        err = struct_lib.fea_struct_freeze_f32(
            _ptr(cache), _ptr(tb.gN), _ptr(tb.pair_of), *(_ptr(o) for o in outs), tb.C, tb.q,
            tb.npe, tb.T, material.kind, material.lam, material.mu, None)
        assert err == 0
        runs.append(outs)
    for a, b, ref in zip(*runs, plain):
        _assert_matches((a, b), ref)
