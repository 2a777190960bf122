"""Smoke run of the PyTorch + CUDA port (fea_large_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the mixed-precision Newton solve of bench.py's
problem (TET10 Kuhn lattice n=35, 1,073,733 DOF, neo-Hookean (1.0, 0.6),
two-level PCG, EW forcing) with the slice's switches resid_df=False and
device_loop=False, and checks it. Phases:

  0. card: nvidia-smi name and power limit, torch and CUDA versions;
  1. build: the structured kernels from fea_large_tpu_torch/csrc with nvcc;
  2. kernel checks: each kernel against its plain PyTorch version on a
     TET10 and a TET4 n=21 lattice (C = 9,261 = 72*128 + 45 cells: a
     partial last block), freeze for all three materials, bound 2e-5
     relative to the largest entry;
  3. the n=4 slice against the JAX reference's counts (measured on CPU),
     then the full-width slice: setup, one warm-up and two timed solves
     (bitwise-equal u and equal PCG lists required), s/step, peak memory,
     kernel launch counts (all > 0), and the converged u's f64 residual
     recomputed on the host CPU;
  4. timings at full width: each kernel and its plain version (CUDA
     events, median of 10 calls), and the main per-iteration passes;
  5. a JSON line of the kernels, then the result line.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it stops in phase 0.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean, NeoHookeanVolumetric, StVenantKirchhoff
from fea_large_tpu_torch.mesh.generators import box_mesh_kuhn
from fea_large_tpu_torch.ops import soa, struct_kernels as sk
from fea_large_tpu_torch.solvers.linear import jacobi_inverse_blocks
from fea_large_tpu_torch.solvers.newton import (
    NewtonSolver,
    SolverOptions,
    _mixed_matvec,
    _mixed_precond,
    _residual_soa_fn,
)

#: f32 kernel vs f32 plain version: rounding in another summation order
KERNEL_BOUND = 2e-5

#: the JAX reference's n=4 slice (fea_large_tpu, resid_df=False,
#: device_loop=False, bench settings), measured on CPU
REFERENCE_N4 = {"newton_iters": 5, "pcg_iters": [5, 7, 15, 21, 14],
                "residual0": 0.014014692693970307}

SLICE = dict(
    linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
    forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
    resid_df=False, device_loop=False,
)

KERNELS = {  # wrapper name -> (LAUNCHES key, TPU kernel it replaces)
    "struct_freeze": ("freeze", "fea_large_tpu/ops/pallas_structured.py:538"),
    "struct_apply": ("apply", "fea_large_tpu/ops/pallas_structured.py:120"),
    "struct_diag": ("diag", "fea_large_tpu/ops/pallas_structured.py:434"),
    "struct_force": ("force", "fea_large_tpu/ops/pallas_structured.py:363"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(a, b):
    """(max |a - b|, that over max |b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def smooth_fields(mesh, device):
    """bench.py's smooth check fields u, v [3, N] (f32)."""
    x, y, z = mesh.coords_host.T
    u = np.stack([0.03 * np.sin(x) * y, -0.02 * z * z + 0.01 * x, -0.05 * z + 0.02 * np.cos(y)])
    v = np.stack([0.01 * np.cos(y) * z, 0.02 * x * y, -0.03 * np.sin(z)])
    return (torch.tensor(u, dtype=torch.float32, device=device),
            torch.tensor(v, dtype=torch.float32, device=device))


def bench_start(mesh, bc):
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device=mesh.device)
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    return bc.impose(u, 1.0)


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
    print("== phase 1: build")
    path, seconds, log = sk.build_library()
    sk._library()
    print(f"kernels: {path} (nvcc {seconds:.1f} s{'' if seconds else ', reused'})")
    name = None
    for line in log.splitlines():  # ptxas -v: entry function, spills, registers
        m = re.search(r"([a-z]+_kernel)IfLi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            name = f"{m.group(1)}<float, {m.group(2)}, {m.group(3)}, {m.group(4)}>"
        elif name and ("spill" in line or "registers" in line):
            print(f"  ptxas {name}: {line.split(':')[-1].strip()}")


def compare(kernel_out, plain_out):
    """Worst (abs err, rel err) over a kernel's outputs."""
    if isinstance(kernel_out, torch.Tensor):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    errs = [rel_err(a, b) for a, b in zip(kernel_out, plain_out)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def run_checks(p, uc, vc, rows, materials):
    """Kernel vs plain on the same inputs: {wrapper: (abs, rel)}."""
    tb = p.tables
    out = {}
    for mat in materials:
        out[f"struct_freeze/{mat.name}"] = compare(
            sk.struct_freeze(tb, uc, mat), sk.struct_freeze_plain(tb, uc, mat))
    out["struct_apply"] = compare(sk.struct_apply(tb, vc, *rows),
                                  sk.struct_apply_plain(tb, vc, *rows))
    out["struct_diag"] = compare(sk.struct_diag(tb, *rows), sk.struct_diag_plain(tb, *rows))
    out["struct_force"] = compare(sk.struct_force(tb, *rows[:2]),
                                  sk.struct_force_plain(tb, *rows[:2]))
    torch.cuda.synchronize()
    return out


def lattice_inputs(n, et, device):
    mesh = box_mesh_kuhn(n, n, n, element_type=et, device=device)
    p = soa.SoAProblem.build(mesh, torch.float32)
    tb = p.tables
    u, v = smooth_fields(mesh, device)
    uc = sk.gather_cache(p.structure, tb.pairs, u)
    vc = sk.gather_cache(p.structure, tb.pairs, v)
    rows = sk.struct_freeze_plain(tb, uc, NeoHookean(1.0, 0.6))
    return p, uc, vc, rows


def phase_kernel_checks(device):
    print("== phase 2: kernel checks (kernel vs plain version, n=21)")
    materials = (StVenantKirchhoff(1.0, 0.6), NeoHookean(1.0, 0.6), NeoHookeanVolumetric(1.0, 0.6))
    for et in ("tet10", "tet4"):
        p, uc, vc, rows = lattice_inputs(21, et, device)
        C = p.tables.C
        print(f"{et}: C = {C} cells = {C // 128} x 128 + {C % 128}")
        for name, (err, rel) in run_checks(p, uc, vc, rows, materials).items():
            ok = rel <= KERNEL_BOUND
            print(f"  {et:5s} {name:28s} rel {rel:.3e}  bound {KERNEL_BOUND:.0e}  "
                  f"abs {err:.3e}  {'ok' if ok else 'FAIL'}")
            check(ok, f"{et} {name} rel {rel:.3e} > {KERNEL_BOUND}")


def solve_n4(device):
    mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device=device)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**SLICE))
    _, ok, rec = solver._newton(bench_start(mesh, bc), 1.0)
    ref = REFERENCE_N4
    print(f"n=4: newton {rec.newton_iters} pcg {rec.pcg_iters} |R0| {rec.residual_norms[0]!r} "
          f"(reference: newton {ref['newton_iters']} pcg {ref['pcg_iters']} "
          f"|R0| {ref['residual0']!r})")
    check(ok and rec.newton_iters == ref["newton_iters"], "n=4 Newton count")
    check(all(abs(a - b) <= 1 for a, b in zip(rec.pcg_iters, ref["pcg_iters"]))
          and len(rec.pcg_iters) == len(ref["pcg_iters"]), "n=4 PCG counts within 1")
    check(abs(rec.residual_norms[0] - ref["residual0"]) <= 1e-12 * ref["residual0"],
          "n=4 initial residual")


def phase_slice(device, card):
    print(f"== phase 3: slice ({card})")
    solve_n4(device)
    t0 = time.perf_counter()
    mesh = box_mesh_kuhn(35, 35, 35, element_type="tet10", device=device)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    check(mesh.n_dof == 1_073_733, f"full width is 1,073,733 DOF, got {mesh.n_dof}")
    u0 = bench_start(mesh, bc)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    for key in sk.LAUNCHES:
        sk.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**SLICE))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t1
    print(f"n=35: {mesh.n_nodes} nodes, {mesh.n_elements} tets, {mesh.n_dof} DOF; "
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
        check(ok and red <= 1e-6, f"solve {rep} converged to reduction <= 1e-6")
        runs.append((u, rec, dt))
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"kernel launches (setup + 3 solves): {launches}")
    print(f"peak device memory: {peak} B ({peak / 2**30:.2f} GiB)")
    check(all(n > 0 for n in launches.values()), "every kernel launched on the main path")
    (ua, reca, _), (ub, recb, _) = runs
    check(torch.equal(ua, ub), "two timed solves give bitwise-equal u")
    check(reca.pcg_iters == recb.pcg_iters and reca.residual_norms == recb.residual_norms,
          "two timed solves give identical PCG lists and residual norms")
    check(bool(torch.isfinite(ua).all()) and tuple(ua.shape) == (mesh.n_nodes, 3), "finite u [N, 3]")
    # the converged u's residual, recomputed by the f64 pass on the host CPU
    mesh_cpu = box_mesh_kuhn(35, 35, 35, element_type="tet10")
    bc_cpu = DirichletBuilder(mesh_cpu).fix("zmin").prescribe("zmax", "z", -0.05).build()
    p64 = soa.SoAProblem.build(mesh_cpu, torch.float64)
    _, r_cpu = _residual_soa_fn(ua.cpu(), 1.0, p64, NeoHookean(1.0, 0.6), bc_cpu,
                                torch.zeros((mesh.n_nodes, 3), dtype=torch.float64))
    red_cpu = float(r_cpu) / reca.residual_norms[0]
    print(f"host CPU f64 residual of the converged u: {float(r_cpu):.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, "host-recomputed residual reduction <= 1e-6")
    per_step = [dt / rec.newton_iters for _, rec, dt in runs]
    summary = {
        "n_dof": mesh.n_dof, "newton_iters": reca.newton_iters, "pcg_iters": reca.pcg_iters,
        "residual_reduction": reca.residual_norms[-1] / reca.residual_norms[0],
        "s_per_step": per_step, "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup,
        "peak_bytes": peak, "launches": launches, "card": card,
    }
    print("slice: " + json.dumps(summary))
    return solver, u0, launches


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


def phase_timings(solver, u0, card):
    print(f"== phase 4: full-width timings (CUDA events, median of 10; {card})")
    p = solver._soa
    tb = p.tables
    u32 = u0.to(torch.float32).T.contiguous()
    v = torch.cos(3.0 * solver.mesh.coords).to(torch.float32).T.contiguous()
    uc = sk.gather_cache(p.structure, tb.pairs, u32)
    vc = sk.gather_cache(p.structure, tb.pairs, v)
    mat = NeoHookean(1.0, 0.6)
    rows = sk.struct_freeze_plain(tb, uc, mat)
    errs = run_checks(p, uc, vc, rows, (mat,))
    calls = {
        "struct_freeze": (lambda: sk.struct_freeze(tb, uc, mat),
                          lambda: sk.struct_freeze_plain(tb, uc, mat)),
        "struct_apply": (lambda: sk.struct_apply(tb, vc, *rows),
                         lambda: sk.struct_apply_plain(tb, vc, *rows)),
        "struct_diag": (lambda: sk.struct_diag(tb, *rows), lambda: sk.struct_diag_plain(tb, *rows)),
        "struct_force": (lambda: sk.struct_force(tb, *rows[:2]),
                         lambda: sk.struct_force_plain(tb, *rows[:2])),
    }
    table = {}
    for name, (kern, plain) in calls.items():
        err, rel = errs[name if name != "struct_freeze" else f"struct_freeze/{mat.name}"]
        check(rel <= KERNEL_BOUND, f"full-width {name} rel {rel:.3e}")
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        table[name] = (err, rel, ms, plain_ms)
        print(f"  {name:14s} kernel {ms:9.4f} ms   plain {plain_ms:9.4f} ms   "
              f"rel {rel:.3e}  abs {err:.3e}")
    # the passes of one Newton iteration and one PCG iteration
    state = soa.soa_freeze(p, mat, u32)
    free32 = solver.bc.free_mask.to(torch.float32)
    r = torch.cos(2.0 * solver.mesh.coords).to(torch.float32) * free32
    inv_blocks = jacobi_inverse_blocks(soa.soa_diag_blocks(p, state).permute(2, 0, 1), free32)
    precond = _mixed_precond(inv_blocks, free32, solver._coarse)
    passes = {
        "f64 residual (plain)": lambda: _residual_soa_fn(
            u0, 1.0, solver._soa64, mat, solver.bc, solver.f_ext),
        "soa_freeze f32": lambda: soa.soa_freeze(p, mat, u32),
        "soa_diag_blocks f32": lambda: soa.soa_diag_blocks(p, state),
        "masked matvec": lambda: _mixed_matvec(p, state, free32.T.contiguous(), r),
        "preconditioner": lambda: precond(r),
        "coarse apply": lambda: solver._coarse.apply(r),
    }
    for name, fn in passes.items():
        print(f"  pass {name:22s} {cuda_ms(fn):9.4f} ms")
    return table


def main():
    card = phase_card()
    device = torch.device("cuda", 0)
    phase_build()
    phase_kernel_checks(device)
    solver, u0, launches = phase_slice(device, card)
    table = phase_timings(solver, u0, card)
    kernels = []
    for name, (key, replaces) in KERNELS.items():
        err, _rel, ms, plain_ms = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "fea_large_tpu_torch/csrc/struct_kernels.cu",
            "replaces": replaces, "launches": launches[key], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
