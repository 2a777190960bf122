"""Smoke run of the PyTorch + CUDA port (fea_large_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--against CHECKOUT ...] [--lattice-only]

Drives the port's three paths through a Newton solve of bench.py's problem
(neo-Hookean (1.0, 0.6), zmin fixed, zmax pushed -0.05 in z, 5% affine
start, EW forcing with eta_min 1e-2, newton_rtol 1e-6) at full width, and
checks them:

  * the Kuhn path, bench.py's default (mixed precision, two-level PCG with
    6 coarse modes, device_loop=False): TET10 Kuhn lattice n=35, 1,073,733
    DOF, the lattice kernels B1-B4 and, with resid_df=None, the fused f64
    residual B5 (csrc/struct_kernels.cu);
  * the 5-tet path, `FEA_BENCH_MESH=5tet FEA_BENCH_PALLAS=1` (mixed):
    TET10 5-tet box n=36, 1,027,083 DOF, aggregates of 100 nodes, the
    element-block kernels B6-B8 (csrc/elem_kernels.cu), which every f32
    pass of an unstructured mesh runs on the card, the coarse-space probes
    included, and, with resid_df=None, the fused f64 residual B9;
  * the f64 assembled path of config 2 (linear="pcg_bcsr",
    precision="f64", block-Jacobi PCG, pcg_tol 1e-8, bench.py's f64
    settings): the same 5-tet box, nnzb 9,184,321, the BCSR product B10
    (csrc/bcsr_kernels.cu) in every PCG iteration.

Phases:

  0. card: nvidia-smi name and power limit, torch and CUDA versions;
  1. build: every kernel source with nvcc, all at once, and ptxas's
     registers, spills and static shared memory per kernel (for the
     lattice kernels also the blocks an SM holds);
  2. kernel checks, each kernel against its plain PyTorch version on the
     same inputs: B1-B5 on TET10 and TET4 Kuhn lattices n=21 (C = 9,261 =
     289*32 + 13 cells; B2 also on n=22, whose C is a multiple of 8, where
     its blocks do not overlap), B6-B9 on TET10 and TET4 5-tet boxes n=13
     (E = 10,985 = 85*128 + 105 elements), every freeze and f64 residual
     for all three materials, B1-B9 also on the TET10 meshes with the
     5-point rule (`n_quad=5`, the (5, 10) instances), and B10 in f64 and
     f32 on the stiffness assembled on those boxes (rows of varying length)
     and on a (6, 4, 2) box whose N is not a multiple of the block rows a
     CUDA block holds (a B10 block of 128 threads holds 4 rows, a warp of
     32 lanes a row; a block of B1-B5 holds 32 cells times the 6 tet
     slots). Bounds relative to the largest entry: 2e-5 for the f32
     kernels, 1e-12 for the f64 ones. B1, B3, B4, B5 (all three materials)
     and B10 (f64 and f32), whose sums cross threads, and B2 (all three
     materials) are launched twice on the same inputs and must give
     bitwise-equal outputs;
  3. the Kuhn path: n=4 with resid_df=False and with resid_df=None against
     the JAX reference's counts (measured on CPU), then full width with
     resid_df=None;
  4. the 5-tet path: n=4 with resid_df=False and None against the
     reference's counts, then full width with resid_df=None.
     At full width each path runs setup, one warm-up and two timed solves
     (bitwise-equal u and equal PCG lists required), prints s/step, peak
     memory and setup seconds, requires every kernel of the path launched
     (counts set to 0 before the path, read after), the fused f64 residual
     launched once per f64 residual and the freeze and tangent-action
     kernels launched by the setup's probes already, and recomputes the
     converged u's f64 residual on the host CPU (reduction <= 1e-6);
  5. the f64 BCSR path: config 2 of tests/test_parity.py (TET10 box 2^3,
     zmax -0.2, two increments, pcg_tol 1e-13) against the reference's
     counts, then full width: one warm-up and one timed solve (bitwise-equal
     u and equal PCG lists), B10 launched at least once per PCG iteration,
     peak memory, and the host CPU recheck of the converged residual;
  6. timings at full width: each kernel and its plain version with CUDA
     events around each call (median of 10: `ms`, `plain_ms`; the host's
     launch path is in it when the kernel is shorter than its wrapper's
     host time) beside its bound, the same kernel queued behind a busy
     card (20 launches between one pair of events: `device_ms`, without
     the host's launch path) and the host's microseconds per launch; B2,
     B4 and B5 also on the n=36 lattice, whose C is a multiple of 8 (rows
     that start on a 32-byte sector); the card's measured f64 multiply-add
     rate (csrc/probe_kernels.cu, a yardstick outside the port) beside the
     data sheet's, which the bounds use; B10 beside cuSPARSE's BSR product
     (`torch.sparse_bsr_tensor @ x`), the passes of one Newton and one PCG
     iteration on every path, and the Kuhn and the 5-tet solves with the
     plain and the fused f64 residual in turns; with `--against CHECKOUT
     ...` (other checkouts of this repository: an earlier commit, or a
     variant of a kernel source, e.g. unpacked by `git archive` into
     build/), the lattice kernels as each checkout builds them, queued, at
     n=35 and n=36, in turns with this one's (there, here, here, there);
  7. a JSON line of the kernels, then the result line.

`--lattice-only` runs phases 0-2 and the lattice kernels' part of phase 6
(with `--against`) and stops: a short call that checks and times a change
to csrc/struct_kernels.cu. It prints no result line.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it stops in phase 0.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.elements.kernels import element_stiffness, precompute_geometry
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import bcsr_kernels as bk
from fea_large_tpu_torch.ops import cuda_build, elem_kernels as ek, soa, struct_kernels as sk
from fea_large_tpu_torch.solvers.linear import (
    block_jacobi_preconditioner,
    jacobi_inverse_blocks,
    pcg_chunk,
    pcg_init,
)
from fea_large_tpu_torch.solvers.newton import (
    NewtonSolver,
    SolverOptions,
    _mixed_matvec,
    _mixed_precond,
    _residual_df_fn,
    _residual_soa_fn,
)

#: f32 kernel vs f32 plain version: rounding in another summation order
KERNEL_BOUND = 2e-5
#: f64 kernel (the fused residuals, the f64 BCSR product) vs its f64 plain
#: version
RESID_BOUND = 1e-12
F64_KERNELS = ("struct_resid", "elem_resid", "bcsr_spmv/f64")

#: H100 SXM data sheet: HBM3 bytes/s, f32 and f64 FLOP/s outside the
#: tensor cores (at the 700 W power limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

#: the JAX reference's n=4 runs (fea_large_tpu, resid_df=False,
#: device_loop=False, pallas=False, bench settings), measured on CPU
REFERENCE_N4 = {"newton_iters": 5, "pcg_iters": [5, 7, 15, 21, 14],
                "residual0": 0.014014692693970307}
REFERENCE_5TET_N4 = {"newton_iters": 5, "pcg_iters": [4, 4, 11, 15, 16],
                     "residual0": 0.014014692693970307}
#: the JAX reference's config 2 (tests/test_parity.py: TET10 5-tet box 2^3,
#: zmin fixed, zmax -0.2, linear="pcg_bcsr", f64, n_steps=2, pcg_tol
#: 1e-13), measured on CPU: per increment (load factor, Newton count, PCG
#: counts, first residual norm)
REFERENCE_CONFIG2 = [(0.5, 5, [41, 40, 40, 37, 30], 0.5840485492109236),
                     (1.0, 5, [41, 40, 40, 37, 34], 0.8107087021552396)]

BENCH = dict(
    linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
    forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
    device_loop=False,
)
KUHN = dict(BENCH, resid_df=None)
FIVE_TET = dict(BENCH, pallas=True, agg_size=100, resid_df=None)
#: bench.py's f64 settings (FEA_BENCH_PRECISION=f64: Jacobi, pcg_tol 1e-8)
#: on the assembled system
BCSR = dict(linear="pcg_bcsr", precision="f64", forcing="ew", ew_eta_min=1e-2,
            newton_rtol=1e-6, pcg_tol=1e-8, pcg_maxiter=2000)

#: cells per axis of the phase-2 checks, and (cells per axis, DOF) of the
#: full-width solves
CHECK_N = {"kuhn": 21, "5tet": 13}
FULL = {"kuhn": (35, 1_073_733), "5tet": (36, 1_027_083), "bcsr": (36, 1_027_083)}

STRUCT_SRC = "fea_large_tpu_torch/csrc/struct_kernels.cu"
ELEM_SRC = "fea_large_tpu_torch/csrc/elem_kernels.cu"
BCSR_SRC = "fea_large_tpu_torch/csrc/bcsr_kernels.cu"
#: a yardstick outside the port: the card's measured f64 multiply-add rate
PROBE_SOURCE = cuda_build.CSRC / "probe_kernels.cu"
KERNELS = {  # name -> (LAUNCHES dict, key, source, TPU kernel it replaces)
    "struct_freeze": (sk.LAUNCHES, "freeze", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:538"),
    "struct_apply": (sk.LAUNCHES, "apply", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:120"),
    "struct_diag": (sk.LAUNCHES, "diag", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:434"),
    "struct_force": (sk.LAUNCHES, "force", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:363"),
    "struct_resid": (sk.LAUNCHES, "resid", STRUCT_SRC, "fea_large_tpu/ops/pallas_residual.py:250"),
    "elem_apply": (ek.LAUNCHES, "apply", ELEM_SRC, "fea_large_tpu/ops/pallas_kernels.py:44"),
    "elem_freeze": (ek.LAUNCHES, "freeze", ELEM_SRC, "fea_large_tpu/ops/pallas_kernels.py:176"),
    "elem_force": (ek.LAUNCHES, "force", ELEM_SRC, "fea_large_tpu/ops/pallas_kernels.py:307"),
    "elem_resid": (ek.LAUNCHES, "resid", ELEM_SRC, "fea_large_tpu/ops/pallas_residual.py:349"),
    "bcsr_spmv": (bk.LAUNCHES, "spmv", BCSR_SRC, "fea_large_tpu/ops/pallas_kernels.py:376"),
}

#: arithmetic per quadrature point, counted from the kernels' sources
#: (a multiply-add is 2): the nodal gradient and the nodal contraction are
#: 18*npe each; the material law per kind (0 SVK, 1 NH, 2 NH volumetric)
MATERIAL_FLOPS = {0: 30, 1: 85, 2: 90}
#: the stress alone on the symmetric half of C (B5, `material_stress`)
STRESS_FLOPS = {0: 17, 1: 57, 2: 57}
POINT_FLOPS = {
    "freeze": lambda npe, kind: 18 * npe + 48 + MATERIAL_FLOPS[kind],
    "force": lambda npe, kind: 54 + 18 * npe,
    "apply": lambda npe, kind: 36 * npe + 360,
    "diag": lambda npe, kind: 86 + 86 * npe,
    "resid": lambda npe, kind: 36 * npe + 84 + STRESS_FLOPS[kind],
    "elem_resid": lambda npe, kind: 36 * npe + 102 + MATERIAL_FLOPS[kind],
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(a, b):
    """(max |a - b|, that over max |b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def compare(kernel_out, plain_out):
    """Worst (abs err, rel err) over a kernel's outputs."""
    if isinstance(kernel_out, torch.Tensor):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    errs = [rel_err(a, b) for a, b in zip(kernel_out, plain_out)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def reset_launches():
    for counts in (sk.LAUNCHES, ek.LAUNCHES, bk.LAUNCHES):
        for key in counts:
            counts[key] = 0


def smooth_fields(coords_host, device, dtype=torch.float32):
    """bench.py's smooth check fields u, v [3, N]."""
    x, y, z = coords_host.T
    u = np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x, -0.05 * z + 0.02 * np.cos(y)])
    v = np.stack([0.01 * np.cos(y) * z, 0.02 * x * y, -0.03 * np.sin(z)])
    return (torch.tensor(u, dtype=dtype, device=device),
            torch.tensor(v, dtype=dtype, device=device))


def bench_start(mesh, bc):
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device=mesh.device)
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    return bc.impose(u, 1.0)


def bench_bc(mesh):
    return DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print("== phase 0: card")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return smi


#: threads of a block of the lattice kernels: 32 cells x 6 tet slots
TILE_THREADS = 192
TILE_KERNELS = {"apply_kernel": "B1", "freeze_kernel": "B2", "diag_kernel": "B3",
                "force_kernel": "B4", "resid_kernel": "B5"}


def resident_blocks(registers, smem, threads):
    """Blocks one SM of the H100 holds at once: 65,536 registers (allocated
    per warp in units of 256), 227 KB of shared memory (1 KB reserved per
    block), 2,048 threads."""
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-registers * 32 // 256) * 256 * warps)
    return min(by_regs, 232448 // (smem + 1024), 2048 // threads)


def phase_build():
    print("== phase 1: build (one nvcc per source, started together)")
    sources = (sk.SOURCE, ek.SOURCE, bk.SOURCE, PROBE_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build_library, sources))
    sk._library()
    ek._library()
    bk._library()
    for src, (path, seconds, log) in zip(sources, builds):
        print(f"{src.name}: {path.name} (nvcc {seconds:.1f} s{'' if seconds else ', reused'})")
        name = None
        for line in log.splitlines():  # ptxas -v: entry function, spills, registers
            m = re.search(r"([a-z]+_kernel)I([fd]?)((?:Li\d+E)*)", line)
            if "Compiling entry function" in line and m:
                args = ([m.group(2)] if m.group(2) else []) + re.findall(r"Li(\d+)E", m.group(3))
                name = f"{m.group(1)}<{', '.join(args)}>"
            elif name and ("spill" in line or "registers" in line):
                print(f"  ptxas {name}: {line.split(':')[-1].strip()}")
                m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
                tag = TILE_KERNELS.get(name.split("<")[0])
                if m and src == sk.SOURCE and tag:
                    print(f"    {tag} blocks of {TILE_THREADS} threads resident per SM: "
                          f"{resident_blocks(int(m.group(1)), int(m.group(2)), TILE_THREADS)}")


MATERIALS = (StVenantKirchhoff(1.0, 0.6), NeoHookean(1.0, 0.6), NeoHookeanVolumetric(1.0, 0.6))


def lattice_inputs(mesh):
    """f32 and f64 problems of a Kuhn lattice and the kernels' inputs."""
    device = mesh.device
    p = soa.SoAProblem.build(mesh, torch.float32)
    p64 = soa.SoAProblem.build(mesh, torch.float64)
    tb = p.tables
    u, v = smooth_fields(mesh.coords_host, device)
    u64, _ = smooth_fields(mesh.coords_host, device, torch.float64)
    uc = sk.gather_cache(p.structure, tb.pairs, u)
    vc = sk.gather_cache(p.structure, tb.pairs, v)
    uc64 = sk.gather_cache(p.structure, tb.pairs, u64)
    rows = sk.struct_freeze_plain(tb, uc, NeoHookean(1.0, 0.6))
    return dict(p=p, tb=tb, tb64=p64.tables, uc=uc, vc=vc, uc64=uc64, rows=rows)


def element_inputs(mesh):
    """f32 and f64 problems of a 5-tet box and the element kernels' inputs."""
    p = soa.SoAProblem.build(mesh, torch.float32)
    p64 = soa.SoAProblem.build(mesh, torch.float64, share_maps_from=p)
    q, npe, _, E = p.gradN.shape
    u, v = smooth_fields(mesh.coords_host, mesh.device)
    u64, _ = smooth_fields(mesh.coords_host, mesh.device, torch.float64)
    ue, ve = ek._gather_flat(p, u), ek._gather_flat(p, v)
    gradN = p.gradN.view(q * npe * 3, E)
    rows = ek.elem_freeze_plain(ue, gradN, NeoHookean(1.0, 0.6), npe=npe, q=q)
    return dict(p=p, q=q, npe=npe, E=E, ue=ue, ve=ve, gradN=gradN, rows=rows,
                ue64=ek._gather_flat(p64, u64), gradN64=p64.gradN.view(q * npe * 3, E),
                dV64=p64.detJxW)


def spmv_x(n_nodes, device):
    """A seeded random x [N, 3] f64 for the product checks: a smooth field
    nearly cancels in K x, and the rounding relative to the output would
    then grow with the cancellation, not with the kernel's error."""
    x = np.random.default_rng(0).standard_normal((n_nodes, 3))
    return torch.tensor(x, dtype=torch.float64, device=device)


def bcsr_inputs(mesh):
    """The BCSR structure of a 5-tet box, its stiffness at bench.py's smooth
    field, and a random x, in f64 and f32."""
    structure = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, mesh.device)
    u, _ = smooth_fields(mesh.coords_host, mesh.device, torch.float64)
    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    K, _ = assemble_bcsr(u.T.contiguous(), mesh.conn, geom, NeoHookean(1.0, 0.6), structure,
                         NodeScatter.build(mesh.conn_host, mesh.n_nodes, mesh.device))
    x = spmv_x(mesh.n_nodes, mesh.device)
    return dict(structure=structure, data64=K.data, x64=x, data32=K.data.float(), x32=x.float())


def bcsr_calls(b):
    """{name: (kernel call, plain call, inputs)} of B10 in f64 and f32; the
    inputs are what the kernel is given and reads once (int32 indices)."""
    st = b["structure"]
    calls = {}
    for tag in ("64", "32"):
        data, x = b["data" + tag], b["x" + tag]
        calls[f"bcsr_spmv/f{tag}"] = (
            lambda d=data, v=x: bk.bcsr_spmv(st, d, v),
            lambda d=data, v=x: bk.bcsr_spmv_plain(st, d, v),
            (st.indptr32, st.indices32, data, x))
    return calls


def lattice_calls(x, materials):
    """{name: (kernel call, plain call, inputs, material kind)} of B1-B5."""
    tb, tb64, uc, vc, uc64, rows = x["tb"], x["tb64"], x["uc"], x["vc"], x["uc64"], x["rows"]
    geo = (tb.gN, tb.dV, tb.pair_of)
    calls = {}
    for mat in materials:
        calls[f"struct_freeze/{mat.name}"] = (
            lambda m=mat: sk.struct_freeze(tb, uc, m), lambda m=mat: sk.struct_freeze_plain(tb, uc, m),
            (uc, tb.gN, tb.pair_of), mat.kind)
        calls[f"struct_resid/{mat.name}"] = (
            lambda m=mat: sk.struct_resid(tb64, uc64, m),
            lambda m=mat: sk.struct_resid_plain(tb64, uc64, m),
            (uc64, tb64.gN, tb64.dV, tb64.pair_of, tb64.slot_table), mat.kind)
    calls["struct_apply"] = (lambda: sk.struct_apply(tb, vc, *rows),
                             lambda: sk.struct_apply_plain(tb, vc, *rows),
                             (vc, *rows, *geo, tb.slot_table), 1)
    calls["struct_diag"] = (lambda: sk.struct_diag(tb, *rows),
                            lambda: sk.struct_diag_plain(tb, *rows),
                            (*rows, *geo, tb.slot_table), 1)
    calls["struct_force"] = (lambda: sk.struct_force(tb, *rows[:2]),
                             lambda: sk.struct_force_plain(tb, *rows[:2]),
                             (*rows[:2], *geo, tb.slot_table), 1)
    return calls


def element_calls(x, materials):
    """{name: (kernel call, plain call, inputs, material kind)} of B6-B8."""
    q, npe, ue, ve, gradN, rows = x["q"], x["npe"], x["ue"], x["ve"], x["gradN"], x["rows"]
    dV = x["p"].detJxW
    kw = dict(npe=npe, q=q)
    ue64, gradN64, dV64 = x["ue64"], x["gradN64"], x["dV64"]
    calls = {}
    for mat in materials:
        calls[f"elem_freeze/{mat.name}"] = (
            lambda m=mat: ek.elem_freeze(ue, gradN, m, **kw),
            lambda m=mat: ek.elem_freeze_plain(ue, gradN, m, **kw), (ue, gradN), mat.kind)
        calls[f"elem_resid/{mat.name}"] = (
            lambda m=mat: ek.elem_resid(ue64, gradN64, dV64, m, **kw),
            lambda m=mat: ek.elem_resid_plain(ue64, gradN64, dV64, m, **kw),
            (ue64, gradN64, dV64), mat.kind)
    calls["elem_apply"] = (lambda: ek.elem_apply(ve, gradN, dV, *rows, **kw),
                           lambda: ek.elem_apply_plain(ve, gradN, dV, *rows, **kw),
                           (ve, gradN, dV, *rows), 1)
    calls["elem_force"] = (lambda: ek.elem_force(gradN, dV, *rows[:2], **kw),
                           lambda: ek.elem_force_plain(gradN, dV, *rows[:2], **kw),
                           (gradN, dV, *rows[:2]), 1)
    return calls


def run_checks(calls):
    """Kernel vs plain on the same inputs: {name: (abs, rel)}."""
    out = {name: compare(c[0](), c[1]()) for name, c in calls.items()}
    torch.cuda.synchronize()
    return out


def check_repeats(label, calls):
    """Two launches of a kernel on the same inputs give bitwise-equal
    outputs (the kernels whose sums cross threads, B1, B3, B4, B5 and B10,
    and B2)."""
    for name, c in calls.items():
        a, b = c[0](), c[0]()
        torch.cuda.synchronize()
        if isinstance(a, torch.Tensor):
            a, b = (a,), (b,)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{label} {name}: two launches bitwise equal")
        print(f"  {label:10s} {name:28s} two launches bitwise equal")


def check_bcsr(label, mesh):
    """B10 against its plain version and against itself on one box."""
    b = bcsr_inputs(mesh)
    st = b["structure"]
    lengths = (st.indptr[1:] - st.indptr[:-1]).tolist()
    rows = bk.BLOCK // bk.LANES
    print(f"BCSR {label}: N = {st.n_nodes} rows = {st.n_nodes // rows} x {rows} + "
          f"{st.n_nodes % rows} ({bk.LANES} lanes a row, {rows} rows a block of {bk.BLOCK}), "
          f"nnzb {st.nnzb}, blocks per row {min(lengths)}-{max(lengths)}")
    check(min(lengths) < max(lengths), "the BCSR rows vary in length")
    calls = bcsr_calls(b)
    report_checks(f"bcsr {label.split()[0]}", run_checks(calls))
    check_repeats(f"bcsr {label.split()[0]}", calls)
    return st.n_nodes % rows


def report_checks(label, errs):
    for name, (err, rel) in errs.items():
        bound = RESID_BOUND if name.startswith(F64_KERNELS) else KERNEL_BOUND
        ok = rel <= bound
        print(f"  {label:10s} {name:28s} rel {rel:.3e}  bound {bound:.0e}  "
              f"abs {err:.3e}  {'ok' if ok else 'FAIL'}")
        check(ok, f"{label} {name} rel {rel:.3e} > {bound}")


def phase_kernel_checks(device):
    print("== phase 2: kernel checks (kernel vs plain version)")
    t0 = time.perf_counter()
    nk, n5 = CHECK_N["kuhn"], CHECK_N["5tet"]
    for et in ("tet10", "tet4"):
        x = lattice_inputs(box_mesh_kuhn(nk, nk, nk, element_type=et, device=device))
        C = x["tb"].C
        print(f"Kuhn {et} n={nk}: C = {C} cells = {C // 32} x 32 + {C % 32} "
              f"(B1-B5: 32 cells x 6 tet slots a block)")
        calls = lattice_calls(x, MATERIALS)
        report_checks(f"kuhn {et}", run_checks(calls))
        check_repeats(f"kuhn {et}", calls)
        # B2's blocks overlap unless C is a multiple of 8: the other case
        x = lattice_inputs(box_mesh_kuhn(nk + 1, nk + 1, nk + 1, element_type=et, device=device))
        check(C % 8 != 0 and x["tb"].C % 8 == 0, "B2 is checked with and without overlapping blocks")
        even = {k: c for k, c in lattice_calls(x, MATERIALS).items() if k.startswith("struct_freeze")}
        report_checks(f"kuhn {et}", {f"{k} C={x['tb'].C}": v for k, v in run_checks(even).items()})
        mesh5 = box_mesh(n5, n5, n5, element_type=et, device=device)
        x = element_inputs(mesh5)
        E = x["E"]
        print(f"5-tet {et} n={n5}: E = {E} elements = {E // ek.BLOCK} x {ek.BLOCK} + {E % ek.BLOCK}")
        report_checks(f"5tet {et}", run_checks(element_calls(x, MATERIALS)))
        check_bcsr(f"{et} n={n5}", mesh5)
        ragged = check_bcsr(f"{et} (6, 4, 2)", box_mesh(6, 4, 2, element_type=et, device=device))
        check(ragged != 0, "the (6, 4, 2) box (an odd N) leaves a CUDA block of B10 partly filled")
    # the (5, 10) instances: TET10 with the 5-point rule
    x = lattice_inputs(box_mesh_kuhn(nk, nk, nk, element_type="tet10", device=device, n_quad=5))
    check((x["tb"].q, x["tb"].npe) == (5, 10), "the lattice's rule is the 5-point one")
    calls = lattice_calls(x, MATERIALS)
    report_checks("kuhn 5pt", run_checks(calls))
    check_repeats("kuhn 5pt", {k: c for k, c in calls.items()
                               if k.startswith(("struct_force", "struct_resid"))})
    x = element_inputs(box_mesh(n5, n5, n5, element_type="tet10", device=device, n_quad=5))
    check((x["q"], x["npe"]) == (5, 10), "the box's rule is the 5-point one")
    report_checks("5tet 5pt", run_checks(element_calls(x, MATERIALS)))
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")


def solve_n4(build, opts, reference, label, device):
    mesh = build(4, 4, 4, element_type="tet10", device=device)
    bc = bench_bc(mesh)
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    _, ok, rec = solver._newton(bench_start(mesh, bc), 1.0)
    ref = reference
    print(f"{label} n=4: newton {rec.newton_iters} pcg {rec.pcg_iters} |R0| "
          f"{rec.residual_norms[0]!r} (reference: newton {ref['newton_iters']} pcg "
          f"{ref['pcg_iters']} |R0| {ref['residual0']!r})")
    check(ok and rec.newton_iters == ref["newton_iters"], f"{label} n=4 Newton count")
    check(len(rec.pcg_iters) == len(ref["pcg_iters"])
          and all(abs(a - b) <= 1 for a, b in zip(rec.pcg_iters, ref["pcg_iters"])),
          f"{label} n=4 PCG counts within 1")
    check(abs(rec.residual_norms[0] - ref["residual0"]) <= 1e-12 * ref["residual0"],
          f"{label} n=4 initial residual")
    return solver


def f64_residuals(rec):
    """How many of a mixed solve's residuals took the f64 pass: the first,
    and every one after a residual at or below 3e-2 of the first (the
    resid32 gate of `_newton_mixed` under EW forcing)."""
    norms = rec.residual_norms
    return sum(1 for it in range(len(norms)) if it == 0 or norms[it - 1] <= 3e-2 * norms[0])


def full_width(label, build, opts, keys, device, card):
    """Setup, warm-up and two timed solves at full width; launch counts of
    the path's kernels `keys` (names in KERNELS) over the whole run. The
    setup's coarse-space probes must already launch the path's freeze and
    tangent-action kernels, and the path's fused residual kernel must
    launch once per f64 residual of the solves."""
    n, n_dof = FULL[label]
    t0 = time.perf_counter()
    mesh = build(n, n, n, element_type="tet10", device=device)
    bc = bench_bc(mesh)
    check(mesh.n_dof == n_dof, f"{label} full width is {n_dof} DOF, got {mesh.n_dof}")
    u0 = bench_start(mesh, bc)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t1
    in_setup = {name: KERNELS[name][0][KERNELS[name][1]] for name in keys}
    print(f"kernel launches in setup: {in_setup}")
    check(all(in_setup[k] > 0 for k in keys if k.endswith(("_freeze", "_apply"))),
          f"the {label} setup's probes launch the freeze and tangent-action kernels")
    print(f"{label} n={n}: {mesh.n_nodes} nodes, {mesh.n_elements} tets, {mesh.n_dof} DOF; "
          f"mesh {t_mesh:.2f} s, solver setup {t_setup:.2f} s "
          f"(coarse: {solver._coarse.n_agg} aggregates, dim {solver._coarse.acinv.shape[0]})")
    t2 = time.perf_counter()
    _, ok, rec = solver._newton(u0, 1.0)
    torch.cuda.synchronize()
    print(f"warm-up solve: {time.perf_counter() - t2:.3f} s, ok={ok}, newton {rec.newton_iters}, "
          f"pcg {rec.pcg_iters}")
    n_f64 = f64_residuals(rec)
    runs = []
    for rep in range(2):
        t3 = time.perf_counter()
        u, ok, rec = solver._newton(u0, 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t3
        red = rec.residual_norms[-1] / rec.residual_norms[0]
        print(f"timed solve {rep}: {dt:.4f} s, newton {rec.newton_iters}, pcg {rec.pcg_iters}, "
              f"|R| {rec.residual_norms[0]:.6e} -> {rec.residual_norms[-1]:.6e} "
              f"(reduction {red:.3e}), {dt / max(rec.newton_iters, 1):.5f} s/step")
        check(ok and red <= 1e-6, f"{label} solve {rep} converged to reduction <= 1e-6")
        runs.append((u, rec, dt))
        n_f64 += f64_residuals(rec)
    launches = {name: KERNELS[name][0][KERNELS[name][1]] for name in keys}
    peak = torch.cuda.max_memory_allocated()
    print(f"kernel launches (setup + 3 solves): {launches}")
    print(f"peak device memory: {peak} B ({peak / 2**30:.2f} GiB)")
    check(all(v > 0 for v in launches.values()), f"every kernel of the {label} path launched")
    resid = next(k for k in keys if k.endswith("_resid"))
    print(f"f64 residuals in the 3 solves: {n_f64}, {resid} launches: {launches[resid]}")
    check(launches[resid] == n_f64, f"{resid} launched once per f64 residual")
    (ua, reca, _), (ub, recb, _) = runs
    check(torch.equal(ua, ub), "two timed solves give bitwise-equal u")
    check(reca.pcg_iters == recb.pcg_iters and reca.residual_norms == recb.residual_norms,
          "two timed solves give identical PCG lists and residual norms")
    check(bool(torch.isfinite(ua).all()) and tuple(ua.shape) == (mesh.n_nodes, 3), "finite u [N, 3]")
    # the converged u's residual, recomputed by the plain f64 pass on the host CPU
    mesh_cpu = build(n, n, n, element_type="tet10", device="cpu")
    p64 = soa.SoAProblem.build(mesh_cpu, torch.float64)
    _, r_cpu = _residual_soa_fn(ua.cpu(), 1.0, p64, NeoHookean(1.0, 0.6), bench_bc(mesh_cpu),
                                torch.zeros((mesh.n_nodes, 3), dtype=torch.float64))
    red_cpu = float(r_cpu) / reca.residual_norms[0]
    print(f"host CPU f64 residual of the converged u: {float(r_cpu):.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, "host-recomputed residual reduction <= 1e-6")
    summary = {
        "path": label, "n_dof": mesh.n_dof, "newton_iters": reca.newton_iters,
        "pcg_iters": reca.pcg_iters,
        "residual_reduction": reca.residual_norms[-1] / reca.residual_norms[0],
        "s_per_step": [dt / r.newton_iters for _, r, dt in runs],
        "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup, "peak_bytes": peak,
        "launches": launches, "setup_launches": in_setup, "card": card,
    }
    print("slice: " + json.dumps(summary))
    return solver, u0, launches


def phase_kuhn(device, card):
    print(f"== phase 3: Kuhn path ({card})")
    t0 = time.perf_counter()
    solve_n4(box_mesh_kuhn, dict(BENCH, resid_df=False), REFERENCE_N4, "kuhn resid_df=False", device)
    solver = solve_n4(box_mesh_kuhn, KUHN, REFERENCE_N4, "kuhn resid_df=None", device)
    check(solver._resid_df, "resid_df=None routes the fused residual on the card")
    out = full_width("kuhn", box_mesh_kuhn, KUHN,
                     [k for k in KERNELS if k.startswith("struct_")], device, card)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    return out


def phase_5tet(device, card):
    print(f"== phase 4: 5-tet path ({card})")
    t0 = time.perf_counter()
    solve_n4(box_mesh, dict(FIVE_TET, resid_df=False), REFERENCE_5TET_N4, "5tet resid_df=False",
             device)
    solver = solve_n4(box_mesh, FIVE_TET, REFERENCE_5TET_N4, "5tet resid_df=None", device)
    check(solver._resid_df, "resid_df=None routes the fused residual B9 on the card")
    out = full_width("5tet", box_mesh, FIVE_TET,
                     [k for k in KERNELS if k.startswith("elem_")], device, card)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")
    return out


def phase_bcsr(device, card):
    print(f"== phase 5: f64 BCSR path ({card})")
    t0 = time.perf_counter()
    mat = NeoHookean(1.0, 0.6)
    mesh = box_mesh(2, 2, 2, element_type="tet10", device=device)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.2).build()
    res = NewtonSolver(mesh, mat, bc, options=SolverOptions(
        linear="pcg_bcsr", n_steps=2, pcg_tol=1e-13)).solve()
    got = [(r.load_factor, r.newton_iters, r.pcg_iters, r.residual_norms[0]) for r in res.history]
    print(f"config 2: {got}\n  (reference: {REFERENCE_CONFIG2})")
    check(res.converged and len(got) == len(REFERENCE_CONFIG2),
          "config 2 converges in the reference's increments")
    for (lf, newton, pcg, r0), (lf_r, newton_r, pcg_r, r0_r) in zip(got, REFERENCE_CONFIG2):
        check(lf == lf_r and newton == newton_r, "config 2 load factors and Newton counts")
        check(len(pcg) == len(pcg_r) and all(abs(a - b) <= 1 for a, b in zip(pcg, pcg_r)),
              "config 2 PCG counts within 1")
        check(abs(r0 - r0_r) <= 1e-12 * r0_r, "config 2 first residual of each increment")
    n, n_dof = FULL["bcsr"]
    t1 = time.perf_counter()
    mesh = box_mesh(n, n, n, element_type="tet10", device=device)
    bc = bench_bc(mesh)
    check(mesh.n_dof == n_dof, f"bcsr full width is {n_dof} DOF, got {mesh.n_dof}")
    u0 = bench_start(mesh, bc)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t1
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    solver = NewtonSolver(mesh, mat, bc, options=SolverOptions(**BCSR))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t2
    st = solver.bcsr
    print(f"bcsr n={n}: {mesh.n_nodes} nodes, {mesh.n_elements} tets, {mesh.n_dof} DOF, "
          f"nnzb {st.nnzb} ({st.nnzb / st.n_nodes:.1f} blocks per row); mesh {t_mesh:.2f} s, "
          f"solver setup (host BCSR build) {t_setup:.2f} s")
    runs = []
    for rep in ("warm-up", "timed"):
        t3 = time.perf_counter()
        u, ok, rec = solver._newton(u0, 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t3
        red = rec.residual_norms[-1] / rec.residual_norms[0]
        print(f"{rep} solve: {dt:.4f} s, newton {rec.newton_iters}, pcg {rec.pcg_iters} "
              f"(total {sum(rec.pcg_iters)}), |R| {rec.residual_norms[0]:.6e} -> "
              f"{rec.residual_norms[-1]:.6e} (reduction {red:.3e}), "
              f"{dt / max(rec.newton_iters, 1):.5f} s/step")
        check(ok and red <= 1e-6, f"bcsr {rep} solve converged to reduction <= 1e-6")
        runs.append((u, rec, dt))
    launches = bk.LAUNCHES["spmv"]
    total_pcg = sum(sum(r.pcg_iters) for _, r, _ in runs)
    peak = torch.cuda.max_memory_allocated()
    print(f"bcsr_spmv launches (2 solves): {launches}, PCG iterations: {total_pcg}")
    print(f"peak device memory: {peak} B ({peak / 2**30:.2f} GiB)")
    check(launches >= total_pcg, "B10 launched at least once per PCG iteration")
    (ua, reca, _), (ub, recb, dtb) = runs
    check(torch.equal(ua, ub), "warm-up and timed solve give bitwise-equal u")
    check(reca.pcg_iters == recb.pcg_iters and reca.residual_norms == recb.residual_norms,
          "warm-up and timed solve give identical PCG lists and residual norms")
    check(bool(torch.isfinite(ua).all()) and tuple(ua.shape) == (mesh.n_nodes, 3), "finite u [N, 3]")
    mesh_cpu = box_mesh(n, n, n, element_type="tet10", device="cpu")
    p64 = soa.SoAProblem.build(mesh_cpu, torch.float64)
    _, r_cpu = _residual_soa_fn(ua.cpu(), 1.0, p64, mat, bench_bc(mesh_cpu),
                                torch.zeros((mesh.n_nodes, 3), dtype=torch.float64))
    red_cpu = float(r_cpu) / reca.residual_norms[0]
    print(f"host CPU f64 residual of the converged u: {float(r_cpu):.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, "host-recomputed residual reduction <= 1e-6")
    summary = {
        "path": "bcsr", "n_dof": mesh.n_dof, "nnzb": st.nnzb, "newton_iters": recb.newton_iters,
        "pcg_iters": recb.pcg_iters, "residual_reduction": red, "s_per_step": dtb / recb.newton_iters,
        "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup, "peak_bytes": peak,
        "launches": {"bcsr_spmv": launches}, "card": card,
    }
    print("slice: " + json.dumps(summary))
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    return solver, u0, {"bcsr_spmv": launches}


def cuda_ms(fn, n=10):
    """Median over n calls of fn's device time (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def queued_ms(fn, n=20):
    """Device time per call of n launches queued behind a busy card (one
    pair of events around them all), so that the host's launch path is not
    in it: what a kernel shorter than its wrapper's host time costs."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)  # cycles: the card is busy while the host enqueues
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def host_us(fn, n=20):
    """Host microseconds to enqueue one call (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def bound(name, inputs, out, points, npe, kind):
    """(bound ms, "bytes" or "operations"): each input read once, each
    output written once, over HBM's rate; the counted arithmetic over the
    peak rate of the working type."""
    outs = out if isinstance(out, tuple) else (out,)
    t_bytes = nbytes(*inputs, *outs) / HBM_BYTES_S
    flops = POINT_FLOPS.get(name, POINT_FLOPS[name.split("_", 1)[1]])
    t_ops = points * flops(npe, kind) / PEAK_FLOPS[outs[0].dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_calls(calls, points, npe, table):
    for name, (kern, plain, inputs, kind) in calls.items():
        out = kern()
        key = name.split("/")[0]
        b_ms, b_by = bound(key, inputs, out, points, npe, kind)
        ms, device_ms, plain_ms = cuda_ms(kern), queued_ms(kern), cuda_ms(plain)
        table[key] = dict(bound_ms=b_ms, bound_by=b_by, ms=ms, device_ms=device_ms,
                          plain_ms=plain_ms)
        print(f"  {name:24s} kernel {ms:9.4f} ms   queued {device_ms:9.4f} ms   bound "
              f"{b_ms:8.4f} ms ({b_by}, {100 * b_ms / ms:5.1f}% / {100 * b_ms / device_ms:5.1f}% "
              f"of it)   plain {plain_ms:9.4f} ms   host {host_us(kern):6.1f} us/launch")


def time_passes(passes):
    for name, fn in passes.items():
        print(f"  pass {name:30s} {cuda_ms(fn):9.4f} ms")


def newton_pcg_passes(solver, u0, mat, freeze, f64_resid):
    p = solver._soa
    u32 = u0.to(torch.float32).T.contiguous()
    state = freeze(p, mat, u32)
    free32 = solver.bc.free_mask.to(torch.float32)
    r = torch.cos(2.0 * solver.mesh.coords).to(torch.float32) * free32
    inv_blocks = jacobi_inverse_blocks(soa.soa_diag_blocks(p, state).permute(2, 0, 1), free32)
    precond = _mixed_precond(inv_blocks, free32, solver._coarse)
    return {
        f"f64 residual ({f64_resid.__name__})": lambda: f64_resid(
            u0, 1.0, solver._soa64, mat, solver.bc, solver.f_ext),
        "freeze f32": lambda: freeze(p, mat, u32),
        "soa_diag_blocks f32": lambda: soa.soa_diag_blocks(p, state),
        "masked matvec": lambda: _mixed_matvec(p, state, free32.T.contiguous(), r),
        "preconditioner": lambda: precond(r),
        "coarse apply": lambda: solver._coarse.apply(r),
    }


def resid_df_turns(solver, u0, label, rounds=3):
    """A mixed solve with its f64 residual as the plain pass (resid_df
    False) and as the fused kernel, in turns on one solver and one card
    (rounds of plain, fused, fused, plain): seconds per Newton step of
    each, and their medians."""
    per_step = {False: [], True: []}
    for fused in (False, True, True, False) * rounds:
        solver._resid_df = fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ok, rec = solver._newton(u0, 1.0)
        torch.cuda.synchronize()
        check(ok, f"{label} solve converged")
        per_step[fused].append((time.perf_counter() - t0) / rec.newton_iters)
    solver._resid_df = True
    print(f"  {label} s/step, f64 residual plain: {per_step[False]}, fused: {per_step[True]}; "
          f"medians {statistics.median(per_step[False]):.5f} plain, "
          f"{statistics.median(per_step[True]):.5f} fused")


def bcsr_timings(solver, u0, mat, table):
    """B10 at full width on the stiffness at u0 (f64): kernel vs plain,
    its bound, cuSPARSE's BSR product, and the passes of one Newton and
    one PCG iteration of the assembled path."""
    st, bc = solver.bcsr, solver.bc
    K, _ = assemble_bcsr(u0, solver.mesh.conn, solver.geom, mat, st, solver.scatter)
    x = spmv_x(st.n_nodes, u0.device)
    calls = bcsr_calls(dict(structure=st, data64=K.data, x64=x, data32=K.data.float(),
                            x32=x.float()))
    errs = run_checks(calls)
    report_checks("bcsr full", errs)
    kern, plain, inputs = calls["bcsr_spmv/f64"]
    y = kern()
    t_bytes = (nbytes(*inputs) + nbytes(y)) / HBM_BYTES_S
    t_ops = 18 * st.nnzb / PEAK_FLOPS[torch.float64]
    b_ms, b_by = max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    ms, device_ms, plain_ms = cuda_ms(kern), queued_ms(kern), cuda_ms(plain)
    N = st.n_nodes
    try:
        with warnings.catch_warnings():  # torch marks BSR tensors as beta
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_bsr_tensor(st.indptr, st.indices, K.data, size=(3 * N, 3 * N))
        xc = x.reshape(3 * N, 1)
        lib_err = rel_err((A @ xc).reshape(N, 3), y)[1]
        lib_ms = cuda_ms(lambda: A @ xc)
        lib = f"{lib_ms:9.4f} ms (rel diff to the kernel {lib_err:.2e})"
    except (RuntimeError, NotImplementedError) as exc:  # a yardstick, not a path of the port
        lib_ms, lib = None, f"refused by torch on this card: {str(exc).splitlines()[0]}"
    table["bcsr_spmv"] = dict(bound_ms=b_ms, bound_by=b_by, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, max_abs_err=errs["bcsr_spmv/f64"][0],
                              library_ms=lib_ms)
    print(f"  {'bcsr_spmv/f64':24s} kernel {ms:9.4f} ms   queued {device_ms:9.4f} ms   bound "
          f"{b_ms:8.4f} ms ({nbytes(*inputs, y)} B, {b_by}, {100 * b_ms / ms:5.1f}% / "
          f"{100 * b_ms / device_ms:5.1f}% of it)   plain {plain_ms:9.4f} ms   host "
          f"{host_us(kern):6.1f} us/launch")
    print(f"  {'bcsr_spmv/f32':24s} kernel {cuda_ms(calls['bcsr_spmv/f32'][0]):9.4f} ms")
    print(f"  cuSPARSE BSR product (torch.sparse_bsr_tensor @ x, f64): {lib}")
    ue = u0[solver.mesh.conn]
    Ke, _ = element_stiffness(ue, solver.geom, mat)
    free = bc.free_mask
    precond = block_jacobi_preconditioner(K.block_diagonal(), free)

    def matvec(v):
        vm = bc.project(v)
        return bc.project(K.matvec(vm)) + (v - vm)

    pcg_state = pcg_init(matvec, bc.project(x), precond, tol=1e-30)
    time_passes({
        "f64 residual (_residual_fn)": lambda: solver._residual(u0, 1.0),
        "element_stiffness f64": lambda: element_stiffness(ue, solver.geom, mat),
        "assemble_blocks f64": lambda: st.assemble_blocks(Ke),
        "block-Jacobi preconditioner": lambda: precond(x),
        "one PCG iteration": lambda: pcg_chunk(matvec, pcg_state, precond, maxiter=1),
    })
    # the same iteration inside a run of 50, as a solve takes them (host clock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = pcg_chunk(matvec, pcg_state, precond, maxiter=50).k - pcg_state.k
    torch.cuda.synchronize()
    print(f"  one PCG iteration within a chunk of {done}: "
          f"{1e3 * (time.perf_counter() - t0) / max(done, 1):.4f} ms")


#: run from the root of another checkout: its lattice kernels, queued, on
#: its own inputs at full width and on the next lattice (C a multiple of 8)
AGAINST = """
import json, torch
import chip_smoke as cs
out = {}
for n in (cs.FULL["kuhn"][0], cs.FULL["kuhn"][0] + 1):
    mesh = cs.box_mesh_kuhn(n, n, n, element_type="tet10", device=torch.device("cuda", 0))
    calls = cs.lattice_calls(cs.lattice_inputs(mesh), (cs.NeoHookean(1.0, 0.6),))
    out[str(n)] = {name.split("/")[0]: cs.queued_ms(c[0]) for name, c in calls.items()}
name = None
for line in cs.cuda_build.build_library(cs.sk.SOURCE)[2].splitlines():  # full-width TET10 instances
    if "Compiling entry function" in line:
        m = cs.re.search(r"([a-z]+_kernel)I[fd]?Li4ELi10ELi6E", line)
        name = m.group(1) if m else None
    elif name and ("spill" in line or "registers" in line):
        out.setdefault("ptxas", {}).setdefault(name, []).append(line.split(":")[-1].strip())
print(json.dumps(out))
"""


def queued_there(checkout):
    """{n: {kernel: queued ms}} of the lattice kernels B1-B5 at full width
    (n=35) and on the next lattice (n=36) as another checkout of this
    repository builds and launches them, in a process of its own on the
    same card."""
    proc = subprocess.run([sys.executable, "-c", AGAINST], cwd=checkout, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"the lattice kernels of {checkout} ran:\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def f64_rate(device, register_operands, blocks_per_sm=8, iters=4096):
    """The card's f64 multiply-add rate outside the tensor cores, in FLOP/s,
    measured by csrc/probe_kernels.cu (independent chains of dependent
    multiply-adds at full occupancy), with both factors constant or, as in
    the kernels, all three operands in registers: what the f64 kernels'
    arithmetic could reach at best, beside the data sheet's PEAK_FLOPS."""
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib = cuda_build.load(PROBE_SOURCE, {"fea_probe_dfma": [P, I, I, I, D, D, P]})
    blocks = blocks_per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * 256, dtype=torch.float64, device=device)

    def launch():
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fea_probe_dfma(out.data_ptr(), blocks, iters, int(register_operands),
                                 0.999999, 1e-9, stream)
        check(err == 0, f"the f64 probe launched (CUDA error {err})")

    ms = cuda_ms(launch)
    check(bool(torch.isfinite(out).all()), "the f64 probe wrote finite sums")
    return 2.0 * blocks * 256 * iters * 8 / (ms * 1e-3)


def lattice_timings(mesh, table, against=()):
    """B1-B5 at full width on `mesh` (n=35) against their plain versions
    and timed; B2, B4 and B5 also on the next lattice, whose C is a
    multiple of 8 (every row starts on a 32-byte sector: B2's blocks do not
    overlap there, and the combine of B4 and B5 stores whole sectors); with
    `against`, the lattice kernels of those checkouts, queued, in turns
    with this one's. Returns the checks' errors."""
    mat = NeoHookean(1.0, 0.6)
    n = FULL["kuhn"][0]
    x = lattice_inputs(mesh)
    calls = lattice_calls(x, (mat,))
    errs = run_checks(calls)
    report_checks("kuhn full", errs)
    check_repeats("kuhn full", calls)
    tb = x["tb"]
    there = {path: [queued_there(path)] for path in against}
    const_rate, reg_rate = f64_rate(mesh.device, False), f64_rate(mesh.device, True)
    print(f"  f64 multiply-add rate of this card, measured (csrc/probe_kernels.cu): "
          f"{const_rate / 1e12:.2f} TFLOP/s with constant factors, {reg_rate / 1e12:.2f} with "
          f"three register operands, as the kernels' (data sheet, used for the bounds: "
          f"{PEAK_FLOPS[torch.float64] / 1e12:.0f}); B5's counted arithmetic at the latter: "
          f"{1e3 * tb.q * tb.T * tb.C * POINT_FLOPS['resid'](tb.npe, 1) / reg_rate:.4f} ms")
    time_calls(calls, tb.q * tb.T * tb.C, tb.npe, table)
    even = lattice_inputs(box_mesh_kuhn(n + 1, n + 1, n + 1, element_type="tet10",
                                        device=mesh.device))
    te = even["tb"]
    check(tb.C % 8 != 0 and te.C % 8 == 0, "timed with rows that start within and on a sector")
    print(f"  B2, B4 and B5 at C = {te.C} (a multiple of 8):")
    calls_even = lattice_calls(even, (mat,))
    table_even = {}
    time_calls({k: c for k, c in calls_even.items()
                if k.startswith(("struct_freeze", "struct_force", "struct_resid"))},
               te.q * te.T * te.C, te.npe, table_even)
    if against:
        here = {str(n): ({k: table[k]["device_ms"] for k in table},
                         {name.split("/")[0]: queued_ms(c[0]) for name, c in calls.items()}),
                str(n + 1): tuple({name.split("/")[0]: queued_ms(c[0])
                                   for name, c in calls_even.items()} for _ in range(2))}
        for path in against:
            there[path].append(queued_there(path))
            for name, lines in there[path][0].get("ptxas", {}).items():
                print(f"  ptxas in {path}: {name}<4, 10, 6>: {'; '.join(lines)}")
        for size, (first, second) in here.items():
            for name in first:
                for path, (before, after) in there.items():
                    print(f"  n={size} {name:14s} queued, in turns: {before[size][name]:.4f} ms in "
                          f"{path}, {first[name]:.4f} and {second[name]:.4f} here, "
                          f"{after[size][name]:.4f} there")
    return errs


def phase_timings(kuhn, five_tet, bcsr, card, against=()):
    print(f"== phase 6: full-width timings (CUDA events; kernels, plain versions and passes "
          f"median of 10 calls; queued: 20 launches between one pair of events; {card})")
    t0 = time.perf_counter()
    mat = NeoHookean(1.0, 0.6)
    table = {}
    solver, u0, _ = kuhn
    errs = lattice_timings(solver.mesh, table, against)
    time_passes(newton_pcg_passes(solver, u0, mat, soa.soa_freeze, _residual_df_fn))
    time_passes({"f64 residual (_residual_soa_fn)": lambda: _residual_soa_fn(
        u0, 1.0, solver._soa64, mat, solver.bc, solver.f_ext)})
    resid_df_turns(solver, u0, "Kuhn")
    solver5, u05, _ = five_tet
    y = element_inputs(solver5.mesh)
    calls5 = element_calls(y, (mat,))
    errs5 = run_checks(calls5)
    report_checks("5tet full", errs5)
    time_calls(calls5, y["q"] * y["E"], y["npe"], table)
    time_passes(newton_pcg_passes(solver5, u05, mat, soa.soa_freeze, _residual_df_fn))
    time_passes({"f64 residual (_residual_soa_fn)": lambda: _residual_soa_fn(
        u05, 1.0, solver5._soa64, mat, solver5.bc, solver5.f_ext)})
    resid_df_turns(solver5, u05, "5-tet")
    for name, (err, _) in {**errs, **errs5}.items():
        table[name.split("/")[0]]["max_abs_err"] = err
    solver_b, u0b, _ = bcsr
    bcsr_timings(solver_b, u0b, mat, table)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    return table


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="CHECKOUT", nargs="+", default=(),
                        help="other checkouts of this repository whose lattice kernels phase 6 "
                             "times, queued, in turns with this one's")
    parser.add_argument("--lattice-only", action="store_true",
                        help="phases 0-2 and the lattice kernels' timings only; no result line")
    args = parser.parse_args()
    t0 = time.perf_counter()
    card = phase_card()
    device = torch.device("cuda", 0)
    phase_build()
    print(f"phase 1 done at {time.perf_counter() - t0:.1f} s")
    phase_kernel_checks(device)
    if args.lattice_only:
        n = FULL["kuhn"][0]
        print(f"== lattice kernels at full width ({card})")
        lattice_timings(box_mesh_kuhn(n, n, n, element_type="tet10", device=device), {},
                        args.against)
        print(f"total: {time.perf_counter() - t0:.1f} s (lattice only: no result line)")
        return
    kuhn = phase_kuhn(device, card)
    five_tet = phase_5tet(device, card)
    bcsr = phase_bcsr(device, card)
    table = phase_timings(kuhn, five_tet, bcsr, card, args.against)
    launches = {**kuhn[2], **five_tet[2], **bcsr[2]}
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        t = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "device_ms": t["device_ms"],
        })
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
