"""PyTorch port: the CUDA sources of the kernels whose threads share a
block's work, run on the CPU against their plain versions.

B10 (`csrc/bcsr_kernels.cu`: a warp per block row, a shuffle tree) and
the five kernels of `csrc/struct_kernels.cu`, all one thread per (tet slot,
cell): B1 (`apply_kernel`), B3 (`diag_kernel`), B4 (`force_kernel`) and B5
(`resid_kernel`, in double), whose register sums end in a shared-memory
combine behind `__syncthreads()`, and B2 (`freeze_kernel`), whose threads
store their own rows, are compiled with g++ against `tests/cuda_on_cpu/cuda_runtime.h`, which runs every CUDA
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
