"""Smoke run of the PyTorch + CUDA port (fea_large_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths through the mixed-precision Newton solve of
bench.py's problem (neo-Hookean (1.0, 0.6), zmin fixed, zmax pushed -0.05
in z, 5% affine start, two-level PCG with 6 coarse modes, EW forcing,
device_loop=False) at full width, and checks them:

  * the Kuhn path, bench.py's default: TET10 Kuhn lattice n=35, 1,073,733
    DOF, the lattice kernels B1-B4 and, with resid_df=None, the fused f64
    residual B5 (csrc/struct_kernels.cu);
  * the 5-tet path, `FEA_BENCH_MESH=5tet FEA_BENCH_PALLAS=1`: TET10 5-tet
    box n=36, 1,027,083 DOF, aggregates of 100 nodes, the element-block
    kernels B6-B8 (csrc/elem_kernels.cu), which every f32 pass of an
    unstructured mesh runs on the card, the coarse-space probes included.

Phases:

  0. card: nvidia-smi name and power limit, torch and CUDA versions;
  1. build: every kernel source with nvcc, all at once, and ptxas's
     registers and spills per kernel;
  2. kernel checks, each kernel against its plain PyTorch version on the
     same inputs: B1-B4 and B5 on TET10 and TET4 Kuhn lattices n=21 (C =
     9,261 = 72*128 + 45 cells), B6-B8 on TET10 and TET4 5-tet boxes n=13
     (E = 10,985 = 85*128 + 105 elements), every freeze for all three
     materials. Bounds relative to the largest entry: 2e-5 for the f32
     kernels, 1e-12 for the f64 residual;
  3. the Kuhn path: n=4 with resid_df=False and with resid_df=None against
     the JAX reference's counts (measured on CPU), then full width with
     resid_df=None;
  4. the 5-tet path: n=4 against the reference's counts, then full width.
     At full width each path runs setup, one warm-up and two timed solves
     (bitwise-equal u and equal PCG lists required), prints s/step, peak
     memory and setup seconds, requires every kernel of the path launched
     (counts set to 0 before the path, read after) and the freeze and
     tangent-action kernels launched by the setup's probes already, and
     recomputes the converged u's f64 residual on the host CPU (reduction
     <= 1e-6);
  5. timings at full width: each kernel and its plain version (CUDA
     events, median of 10 calls) beside its bound, the passes of one
     Newton and one PCG iteration on both paths, and the Kuhn solve with
     the plain and the fused f64 residual in turns;
  6. a JSON line of the kernels, then the result line.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it stops in phase 0.
"""

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import cuda_build, elem_kernels as ek, soa, struct_kernels as sk
from fea_large_tpu_torch.solvers.linear import jacobi_inverse_blocks
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
#: f64 residual kernel vs its f64 plain version
RESID_BOUND = 1e-12

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

BENCH = dict(
    linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
    forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
    device_loop=False,
)
KUHN = dict(BENCH, resid_df=None)
FIVE_TET = dict(BENCH, pallas=True, agg_size=100)

#: cells per axis of the phase-2 checks, and (cells per axis, DOF) of the
#: full-width solves
CHECK_N = {"kuhn": 21, "5tet": 13}
FULL = {"kuhn": (35, 1_073_733), "5tet": (36, 1_027_083)}

STRUCT_SRC = "fea_large_tpu_torch/csrc/struct_kernels.cu"
ELEM_SRC = "fea_large_tpu_torch/csrc/elem_kernels.cu"
KERNELS = {  # name -> (LAUNCHES dict, key, source, TPU kernel it replaces)
    "struct_freeze": (sk.LAUNCHES, "freeze", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:538"),
    "struct_apply": (sk.LAUNCHES, "apply", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:120"),
    "struct_diag": (sk.LAUNCHES, "diag", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:434"),
    "struct_force": (sk.LAUNCHES, "force", STRUCT_SRC, "fea_large_tpu/ops/pallas_structured.py:363"),
    "struct_resid": (sk.LAUNCHES, "resid", STRUCT_SRC, "fea_large_tpu/ops/pallas_residual.py:250"),
    "elem_apply": (ek.LAUNCHES, "apply", ELEM_SRC, "fea_large_tpu/ops/pallas_kernels.py:44"),
    "elem_freeze": (ek.LAUNCHES, "freeze", ELEM_SRC, "fea_large_tpu/ops/pallas_kernels.py:176"),
    "elem_force": (ek.LAUNCHES, "force", ELEM_SRC, "fea_large_tpu/ops/pallas_kernels.py:307"),
}

#: arithmetic per quadrature point, counted from the kernels' sources
#: (a multiply-add is 2): the nodal gradient and the nodal contraction are
#: 18*npe each; the material law per kind (0 SVK, 1 NH, 2 NH volumetric)
MATERIAL_FLOPS = {0: 30, 1: 85, 2: 90}
POINT_FLOPS = {
    "freeze": lambda npe, kind: 18 * npe + 48 + MATERIAL_FLOPS[kind],
    "force": lambda npe, kind: 54 + 18 * npe,
    "apply": lambda npe, kind: 36 * npe + 360,
    "diag": lambda npe, kind: 94 + 106 * npe,
    "resid": lambda npe, kind: 36 * npe + 102 + MATERIAL_FLOPS[kind],
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
    for counts in (sk.LAUNCHES, ek.LAUNCHES):
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


def phase_build():
    print("== phase 1: build (one nvcc per source, started together)")
    sources = (sk.SOURCE, ek.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build_library, sources))
    sk._library()
    ek._library()
    for src, (path, seconds, log) in zip(sources, builds):
        print(f"{src.name}: {path.name} (nvcc {seconds:.1f} s{'' if seconds else ', reused'})")
        name = None
        for line in log.splitlines():  # ptxas -v: entry function, spills, registers
            m = re.search(r"([a-z]+_kernel)I([fd]?)((?:Li\d+E)+)", line)
            if "Compiling entry function" in line and m:
                args = ([m.group(2)] if m.group(2) else []) + re.findall(r"Li(\d+)E", m.group(3))
                name = f"{m.group(1)}<{', '.join(args)}>"
            elif name and ("spill" in line or "registers" in line):
                print(f"  ptxas {name}: {line.split(':')[-1].strip()}")


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
    """f32 problem of a 5-tet box and the element kernels' inputs."""
    p = soa.SoAProblem.build(mesh, torch.float32)
    q, npe, _, E = p.gradN.shape
    u, v = smooth_fields(mesh.coords_host, mesh.device)
    ue, ve = ek._gather_flat(p, u), ek._gather_flat(p, v)
    gradN = p.gradN.view(q * npe * 3, E)
    rows = ek.elem_freeze_plain(ue, gradN, NeoHookean(1.0, 0.6), npe=npe, q=q)
    return dict(p=p, q=q, npe=npe, E=E, ue=ue, ve=ve, gradN=gradN, rows=rows)


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
            (uc64, tb64.gN, tb64.dV, tb64.pair_of), mat.kind)
    calls["struct_apply"] = (lambda: sk.struct_apply(tb, vc, *rows),
                             lambda: sk.struct_apply_plain(tb, vc, *rows), (vc, *rows, *geo), 1)
    calls["struct_diag"] = (lambda: sk.struct_diag(tb, *rows),
                            lambda: sk.struct_diag_plain(tb, *rows), (*rows, *geo), 1)
    calls["struct_force"] = (lambda: sk.struct_force(tb, *rows[:2]),
                             lambda: sk.struct_force_plain(tb, *rows[:2]), (*rows[:2], *geo), 1)
    return calls


def element_calls(x, materials):
    """{name: (kernel call, plain call, inputs, material kind)} of B6-B8."""
    q, npe, ue, ve, gradN, rows = x["q"], x["npe"], x["ue"], x["ve"], x["gradN"], x["rows"]
    dV = x["p"].detJxW
    kw = dict(npe=npe, q=q)
    calls = {}
    for mat in materials:
        calls[f"elem_freeze/{mat.name}"] = (
            lambda m=mat: ek.elem_freeze(ue, gradN, m, **kw),
            lambda m=mat: ek.elem_freeze_plain(ue, gradN, m, **kw), (ue, gradN), mat.kind)
    calls["elem_apply"] = (lambda: ek.elem_apply(ve, gradN, dV, *rows, **kw),
                           lambda: ek.elem_apply_plain(ve, gradN, dV, *rows, **kw),
                           (ve, gradN, dV, *rows), 1)
    calls["elem_force"] = (lambda: ek.elem_force(gradN, dV, *rows[:2], **kw),
                           lambda: ek.elem_force_plain(gradN, dV, *rows[:2], **kw),
                           (gradN, dV, *rows[:2]), 1)
    return calls


def run_checks(calls):
    """Kernel vs plain on the same inputs: {name: (abs, rel)}."""
    out = {name: compare(kern(), plain()) for name, (kern, plain, _, _) in calls.items()}
    torch.cuda.synchronize()
    return out


def report_checks(label, errs):
    for name, (err, rel) in errs.items():
        bound = RESID_BOUND if name.startswith("struct_resid") else KERNEL_BOUND
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
        print(f"Kuhn {et} n={nk}: C = {C} cells = {C // 128} x 128 + {C % 128}")
        report_checks(f"kuhn {et}", run_checks(lattice_calls(x, MATERIALS)))
        x = element_inputs(box_mesh(n5, n5, n5, element_type=et, device=device))
        E = x["E"]
        print(f"5-tet {et} n={n5}: E = {E} elements = {E // ek.BLOCK} x {ek.BLOCK} + {E % ek.BLOCK}")
        report_checks(f"5tet {et}", run_checks(element_calls(x, MATERIALS)))
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


def full_width(label, build, opts, keys, device, card):
    """Setup, warm-up and two timed solves at full width; launch counts of
    the path's kernels `keys` (names in KERNELS) over the whole run. The
    setup's coarse-space probes must already launch the path's freeze and
    tangent-action kernels."""
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
    launches = {name: KERNELS[name][0][KERNELS[name][1]] for name in keys}
    peak = torch.cuda.max_memory_allocated()
    print(f"kernel launches (setup + 3 solves): {launches}")
    print(f"peak device memory: {peak} B ({peak / 2**30:.2f} GiB)")
    check(all(v > 0 for v in launches.values()), f"every kernel of the {label} path launched")
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
    solve_n4(box_mesh, FIVE_TET, REFERENCE_5TET_N4, "5tet", device)
    out = full_width("5tet", box_mesh, FIVE_TET,
                     [k for k in KERNELS if k.startswith("elem_")], device, card)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")
    return out


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


def bound(name, inputs, out, points, npe, kind):
    """(bound ms, "bytes" or "operations"): each input read once, each
    output written once, over HBM's rate; the counted arithmetic over the
    peak rate of the working type."""
    outs = out if isinstance(out, tuple) else (out,)
    t_bytes = nbytes(*inputs, *outs) / HBM_BYTES_S
    t_ops = points * POINT_FLOPS[name.split("_", 1)[1]](npe, kind) / PEAK_FLOPS[outs[0].dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_calls(calls, points, npe, table):
    for name, (kern, plain, inputs, kind) in calls.items():
        out = kern()
        key = name.split("/")[0]
        b_ms, b_by = bound(key, inputs, out, points, npe, kind)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        table[key] = dict(bound_ms=b_ms, bound_by=b_by, ms=ms, plain_ms=plain_ms)
        print(f"  {name:24s} kernel {ms:9.4f} ms   plain {plain_ms:9.4f} ms   bound {b_ms:8.4f} ms "
              f"({b_by}, {100 * b_ms / ms:5.1f}% of it)")


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


def resid_df_turns(solver, u0):
    """The Kuhn solve with its f64 residual as the plain pass (resid_df
    False, the path before B5) and as B5, in turns on one solver and one
    card (plain, B5, B5, plain): seconds per Newton step of each."""
    per_step = {False: [], True: []}
    for fused in (False, True, True, False):
        solver._resid_df = fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ok, rec = solver._newton(u0, 1.0)
        torch.cuda.synchronize()
        check(ok, "Kuhn solve converged")
        per_step[fused].append((time.perf_counter() - t0) / rec.newton_iters)
    solver._resid_df = True
    print(f"  Kuhn s/step, f64 residual plain: {per_step[False]}, fused (B5): {per_step[True]}")


def phase_timings(kuhn, five_tet, card):
    print(f"== phase 5: full-width timings (CUDA events, median of 10; {card})")
    t0 = time.perf_counter()
    mat = NeoHookean(1.0, 0.6)
    table = {}
    solver, u0, _ = kuhn
    x = lattice_inputs(solver.mesh)
    calls = lattice_calls(x, (mat,))
    errs = run_checks(calls)
    report_checks("kuhn full", errs)
    tb = x["tb"]
    time_calls(calls, tb.q * tb.T * tb.C, tb.npe, table)
    time_passes(newton_pcg_passes(solver, u0, mat, soa.soa_freeze, _residual_df_fn))
    time_passes({"f64 residual (_residual_soa_fn)": lambda: _residual_soa_fn(
        u0, 1.0, solver._soa64, mat, solver.bc, solver.f_ext)})
    resid_df_turns(solver, u0)
    solver5, u05, _ = five_tet
    y = element_inputs(solver5.mesh)
    calls5 = element_calls(y, (mat,))
    errs5 = run_checks(calls5)
    report_checks("5tet full", errs5)
    time_calls(calls5, y["q"] * y["E"], y["npe"], table)
    time_passes(newton_pcg_passes(solver5, u05, mat, soa.soa_freeze, _residual_soa_fn))
    for name, (err, _) in {**errs, **errs5}.items():
        table[name.split("/")[0]]["max_abs_err"] = err
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    return table


def main():
    t0 = time.perf_counter()
    card = phase_card()
    device = torch.device("cuda", 0)
    phase_build()
    print(f"phase 1 done at {time.perf_counter() - t0:.1f} s")
    phase_kernel_checks(device)
    kuhn = phase_kuhn(device, card)
    five_tet = phase_5tet(device, card)
    table = phase_timings(kuhn, five_tet, card)
    launches = {**kuhn[2], **five_tet[2]}
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        t = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
