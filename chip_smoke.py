"""Smoke run of the PyTorch + CUDA port (fea_large_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--against CHECKOUT ...] [--lattice-only] [--sharded-only]

Drives the port's four paths through a Newton solve of bench.py's problem
(neo-Hookean (1.0, 0.6), zmin fixed, zmax pushed -0.05 in z, 5% affine
start, EW forcing with eta_min 1e-2, newton_rtol 1e-6) at full width, the
dense direct path, the task-file entry point, the three-level and 12-mode
preconditioners, the host coarse builders, an autodiff material on the
f64 paths, the examples and the sharded paths, and checks them:

  * the Kuhn path, bench.py's default (mixed precision, two-level PCG with
    6 coarse modes, device_loop=True: the device-resident Newton loop, an
    increment one launched CUDA graph of nested WHILE and IF nodes and one
    fetch, solvers/device_loop.py), with the
    host Newton loop (device_loop=False) beside it: TET10 Kuhn lattice
    n=35, 1,073,733 DOF, the lattice kernels B1-B4 and, with
    resid_df=None, the fused f64 residual B5 (csrc/struct_kernels.cu);
  * the 5-tet path, `FEA_BENCH_MESH=5tet FEA_BENCH_PALLAS=1` (mixed):
    TET10 5-tet box n=36, 1,027,083 DOF, aggregates of 100 nodes, the
    element-block kernels B6-B8 and the block-Jacobi diagonal's two
    kernels (csrc/elem_kernels.cu), which every f32 pass of an
    unstructured mesh runs on the card, the coarse-space probes included,
    and, with resid_df=None, the fused f64 residual B9;
  * the f64 assembled path of config 2 (linear="pcg_bcsr",
    precision="f64", block-Jacobi PCG) with the tolerances of bench.py's
    f64 mode (pcg_tol 1e-8): the same 5-tet box, nnzb 9,184,321, the BCSR
    product B10 (csrc/bcsr_kernels.cu) in every PCG iteration;
  * the f64 matrix-free path, bench.py's own f64 mode
    (FEA_BENCH_PRECISION=f64: linear="pcg", precision="f64", Jacobi, pcg_tol
    1e-8) on the Kuhn box n=35, plain PyTorch (the reference runs no Pallas
    kernel there), the dense direct path (linear="direct") and the seven
    single-device task files through `python -m fea_large_tpu_torch run`.

Phases:

  0. card: nvidia-smi name and power limit, torch, CUDA and driver
     versions (the conditional graph nodes need CUDA >= 12.4);
  1. build: every kernel source with nvcc, all at once (and
     csrc/graph_kernels.cu, the programs' WHILE and IF nodes), and
     ptxas's registers, spills and static shared memory per kernel (for
     the lattice kernels also the blocks an SM holds); then a nested
     program over counter bodies (WHILE {IF, WHILE}) against the run
     counts of the same Python loop, and whether CUDA takes a composed
     program as a child graph (it must not: nested chains go into the
     conditional nodes' own body graphs);
  2. kernel checks, each kernel against its plain PyTorch version on the
     same inputs: B1-B5 on TET10 and TET4 Kuhn lattices n=21 (C = 9,261 =
     289*32 + 13 cells; B2 also on n=22, whose C is a multiple of 8, where
     its blocks do not overlap), B6-B9 (B6 gathering its nodal values
     through the int32 conn), the unstructured diagonal (`elem_diag`) and
     the fixed-order nodal sum (`nodal_sum`, f32 and f64, on B6's and B9's
     outputs, against the valence buckets' sum) on TET10 and TET4 5-tet
     boxes n=13
     (E = 10,985 = 85*128 + 105 elements), every freeze and f64 residual
     for all three materials, B1-B9 also on the TET10 meshes with the
     5-point rule (`n_quad=5`, the (5, 10) instances), and B10 in f64 and
     f32 on the stiffness assembled on those boxes (rows of varying length)
     and on a (6, 4, 2) box whose N is not a multiple of the block rows a
     CUDA block holds (a B10 block of 128 threads holds 4 rows, a warp of
     32 lanes a row; a block of B1-B5 holds 32 cells times the 6 tet
     slots). Bounds relative to the largest entry: 2e-5 for the f32
     kernels, 1e-12 for the f64 ones. B1, B3, B4, B5 (all three materials)
     and B10 (f64 and f32), whose sums cross threads, B2 (all three
     materials), B6, the unstructured diagonal and the nodal sum are
     launched twice on the same inputs and must give bitwise-equal outputs;
  3. the Kuhn path: n=4 on the host loop (resid_df=False) and on the
     device loop (resid_df=False and None) against the JAX reference's
     counts of each loop (measured on CPU), then full width with
     resid_df=None;
  4. the 5-tet path: n=4 the same way, then full width with resid_df=None.
     At full width each path runs setup, then the device loop (the first
     solve captures its graphs, then 5 timed solves) and the host loop on
     the same setup (a warm-up and 5 timed solves): all bitwise equal
     within a loop, the same Newton count in both, the device loop's u
     within 1e-7 of max |u| of the host loop's, both PCG lists beside the
     TPU's; s/step (median and range of each loop), host fetches per
     solve (the device loop: one, checked), capture seconds, graph nodes,
     peak memory and setup seconds.
     The host loop's CG runs the mixed route's PCG chunk (the reference's
     `pcg_chunk`: captured graphs, the CG iteration under a WHILE node,
     solvers/linear.py `DevicePCGChunk`): its capture seconds, fetches per
     solve and peak memory, and one solve with the chunks' bodies run
     eagerly on the card beside it (u bitwise, the same PCG list).
     Counts set to 0 before the setup and read after the device-loop
     solves: every kernel of the path launched (the setup's probes and the
     loop's warm-up eagerly, the rest by the replays: launches per capture
     times the body's runs), no kernel wrapper called during a replayed
     solve, the fused f64 residual replayed once per f64 residual, the
     freeze and tangent-action kernels launched by the setup's probes
     already; the device loop's u's f64 residual recomputed on the host CPU
     (reduction <= 1e-6). Phase 3 then runs the device loop with a CG
     budget of 20 on the same setup, which must hand over to the host loop
     and converge (u within 1e-7). Then, on the same setup of each path,
     bench.py's step mode (FEA_BENCH_MODE=step: `NewtonSolver._step` with
     forcing "fixed", the mixed step: the plain f64 residual, the freeze,
     block-Jacobi plus the coarse correction, chunked f32 PCG at pcg_tol
     1e-6 on the PCG chunk): a warm-up (with the chunk's capture) and 3
     timed steps (s/step median and range, PCG iterations, ok, rel, host
     fetches per step, capture seconds, peak memory), all bitwise equal,
     counts set to 0 just before and read just after (B1-B3 or B6-B7
     launched, the tangent action at least once per PCG iteration, the
     replays included), one step with eager chunks beside (bitwise), the
     stepped u's f64 residual recomputed on the host CPU under the
     start's; one `step_fn` (one run of the chunk, one fetch); phase 3
     also `entry()`'s step (entry.py) on the card against its CPU run
     (1e-10 of max |u|), and phase 5 one `step_fn` on its route (the f64
     step: B10 at least once per PCG iteration, one fetch: the solve and
     its restart in one launch);
  5. the f64 BCSR path: config 2 of tests/test_parity.py (TET10 box 2^3,
     zmax -0.2, two increments, pcg_tol 1e-13) against the reference's
     counts, then full width: one warm-up (with the PCG chunk's capture)
     and one timed solve (bitwise-equal u and equal PCG lists), the
     chunk's host fetches per solve (one a Newton step, checked: the solve
     and its restart in one launch) and one solve with eager chunks beside
     (bitwise), B10
     launched at least once per PCG iteration (replays included), peak
     memory, and the host CPU recheck of the converged residual;
  6. timings at full width: each kernel and its plain version with CUDA
     events around each call (median of 10: `ms`, `plain_ms`; the host's
     launch path is in it when the kernel is shorter than its wrapper's
     host time) beside its bound (the unstructured diagonal also as its
     two kernels apart, `diag_parts`), the same kernel queued behind a busy
     card (20 launches between one pair of events: `device_ms`, without
     the host's launch path) and the host's microseconds per launch; B2,
     B4 and B5 also on the n=36 lattice, whose C is a multiple of 8 (rows
     that start on a 32-byte sector); the card's measured f64 multiply-add
     rate (csrc/probe_kernels.cu, a yardstick outside the port) beside the
     data sheet's, which the bounds use; B10 beside cuSPARSE's BSR product
     (`torch.sparse_bsr_tensor @ x`), the passes of one Newton and one PCG
     iteration on every path (a PCG iteration of the host loop: a captured
     chunk's run, beside the eager `pcg_chunk`), the pieces of a replayed
     PCG iteration
     (Kuhn and 5-tet), each captured into a CUDA graph of its own and
     replayed, the program's device spans over three device-loop solves of
     each (a Newton iteration's head, block-Jacobi, a PCG iteration, and
     the spans' sum against the launches' CUDA events: `span_solves`) and
     over three 5-tet `step_fn` calls (`span_steps`),
     %globaltimer's tick and its offset against the profiler's kernel
     starts (`span_clock`), and the Kuhn and the 5-tet solves with the
     plain and the fused f64 residual in turns; with `--against CHECKOUT
     ...` (other checkouts of this repository: an earlier commit, or a
     variant of a kernel source, e.g. unpacked by `git archive` into
     build/), the lattice kernels as each checkout builds them, queued, at
     n=35 and n=36, in turns with this one's (there, here, here, there);
  7. the f64 matrix-free, direct and CLI paths, none of which launches a
     kernel of the port: (a) bench.py's f64 mode at full width (1,073,733
     DOF; setup, one warm-up and three timed solves, bitwise-equal u and
     equal PCG lists, s/step, peak memory, the PCG chunk's fetches and
     capture, one solve with eager chunks beside (bitwise), the host CPU
     recheck, and the ms
     of TangentState.freeze, the scattered element_diag_blocks and one
     masked apply_tangent product); (b) the dense direct path on
     tasks/uniaxial_tet4.json (1,029 DOF) and on config 2's compression of
     a 5-tet TET10 box n=8 (13,203 DOF, dense K 1.39 GB), with the
     assembly and Cholesky ms, a bitwise-equal repeat and the host CPU
     recheck; (c) `python -m fea_large_tpu_torch run` on the seven
     single-device task files at once (each must converge and write its
     convergence JSON, checkpoint, npz and vtk; the f64 ones in the
     reference's increments and Newton counts), the mixed Kuhn task's u
     against an f64 solve of the same file, one `info` and one `bench
     --reps 3` (its JSON line printed);
  8. (a) bench.py's problem at full width with preconditioner="three_level"
     (levels of 21,952 and 2,744 aggregates) and (b) with the 12-mode
     two-level space: setup seconds on the host and on the card, three
     host-loop solves, then two device-loop solves on the same setup (the
     Newton count of the host loop, u within 1e-7), the lattice kernels
     launched (B1-B5, counted over the host-loop solves), the
     Newton count and PCG list beside phase 3's, and phase 6's passes of
     one Newton and one PCG iteration (the preconditioner and its coarse
     apply among them); (c) the host coarse
     builders at full width: the f64 Galerkin product of the rigid-body
     basis over phase 3's aggregates (K0 kept from (a)) against the probed
     Ac (2e-5 of its largest entry), and FEA_COARSE_INVERT=host against the
     device inverse, both against the f64 inverse of the same Ac; (d)
     MooneyRivlin(1.0, 0.6), whose tangent the generic branch forms
     through torch.func: phase 5's assembled path at full width (B10 in
     every PCG iteration) with the generic and the factored
     `element_stiffness` timed, the direct path on the
     uniaxial_tension example's box and the matrix-free path on a Kuhn box
     n=12, each with a warm-up, two timed solves (bitwise equal) and the
     host CPU recheck; (e) the three examples through `python -m
     fea_large_tpu_torch.examples.<name>`, each exiting 0 with OK. No
     coarse inverse of phases 3, 4 and 8 may take the host fallback;
  9. the sharded paths (fea_large_tpu_torch/dist/), one process per shard,
     the ranks sharing the card over gloo (CUDA tensors staged through the
     host): first B1-B3 on rank 0's local Kuhn box (9 x 36 x 36 cells) and
     B6-B7 on a rank's padded element tables of (b), built as the ranks
     build them, against their plain versions at the phase-2 bounds; then
     (a) bench.py's problem on a Kuhn TET10 box n=36 (1,167,051 DOF;
     36 cells divide by 4) on 4 ranks, the structured solver (B1-B3 on
     every rank), and (b) on the 5-tet TET10 box n=36 (1,027,083 DOF,
     aggregates of 100 nodes) on 4 ranks, the generic solver (B6-B7): each
     against the single-device solve on the card (the same Newton count, u
     within 1e-7 of max |u|, the PCG lists side by side), two sharded
     solves bitwise equal, setup, s/step, the collectives' host seconds,
     peak memory per rank, every kernel of the path launched (counts
     summed over the ranks), and on every rank the eager route (gloo),
     the same records and the reference's fetch contract: one fetch per
     Newton iteration, per further PCG chunk and per restart, with the
     fetches per Newton iteration and per solve printed; (c) both solvers in f64 on a Kuhn box n=12 on
     2 ranks, u within 1e-10 of the single-device f64 solve; (d) the two
     8-shard task files on 8 ranks (the reference's Newton counts, measured
     on CPU), the distributed example through `python -m`,
     `dist.dryrun.dryrun_multichip(2)`, and `python -m fea_large_tpu_torch
     run` of an 8-shard task, which exits 2 on fewer than 8 cards; (f)
     both solvers with one rank in this process (LocalComm) on the
     captured route (each rank's programs as CUDA graphs: a Newton
     iteration, a further chunk and a restart one launch and one fetch
     each) at (a)'s and (b)'s widths, a solve() of two increments from
     zero twice: the single-device solve's Newton counts, u within 1e-7 of
     max |u|, bitwise the same solver on the eager route, the fetch
     contract, the path's kernels replayed, s/step, graph nodes, capture
     seconds and peak memory; (e) where there are 4 cards, (a) again with
     one NCCL rank per card on the captured route (the collectives inside
     the graphs), bitwise equal to (a)'s gloo run, with its s/step beside the
     eager host loop's 0.149;
  10. a JSON line of the kernels (`launches`: on the main path of phases
     3-5, the replays of the device loop's and the PCG chunks' graphs
     included; beside it each kernel's
     launches on the step routes of phases 3-5 (`launches_step`), on phase
     8's paths and, summed over the ranks, on phase 9's), then the result
     line.

`--lattice-only` runs phases 0-2 and the lattice kernels' part of phase 6
(with `--against`) and stops: a short call that checks and times a change
to csrc/struct_kernels.cu. It prints no result line. `--sharded-only` runs
phases 0, 1 and 9 and stops, with no result line (on a machine with 4
cards, 9e included).

Phases 7 and 8 run after phase 6, once the solvers of phases 3-5 are
released, so that their peak memory is their own.

Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it stops in phase 0.
"""

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.dense import assemble_dense, mask_dense_system
from fea_large_tpu_torch.assembly.matfree import TangentState, apply_tangent
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.elements.kernels import (
    element_diag_blocks,
    element_stiffness,
    precompute_geometry,
)
from fea_large_tpu_torch.entry import entry
from fea_large_tpu_torch.io.export import load_checkpoint
from fea_large_tpu_torch.io.task import load_task
from fea_large_tpu_torch.materials import (
    MooneyRivlin,
    NeoHookean,
    NeoHookeanVolumetric,
    StVenantKirchhoff,
)
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import bcsr_kernels as bk
from fea_large_tpu_torch.ops import cuda_build, cuda_graphs, soa
from fea_large_tpu_torch.ops import elem_kernels as ek, struct_kernels as sk
from fea_large_tpu_torch.ops.pooling import make_lattice_pool
from fea_large_tpu_torch.solvers import device_loop as dl, multilevel as ml
from fea_large_tpu_torch.solvers.linear import (
    DevicePCGChunk,
    apply_block_jacobi,
    block_jacobi_preconditioner,
    dense_cholesky_solve,
    device_pcg_step,
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
from fea_large_tpu_torch.utils import profiling

#: f32 kernel vs f32 plain version: rounding in another summation order
KERNEL_BOUND = 2e-5
#: f64 kernel (the fused residuals, the f64 BCSR product) vs its f64 plain
#: version
RESID_BOUND = 1e-12
F64_KERNELS = ("struct_resid", "elem_resid", "bcsr_spmv/f64", "elem_nodal_sum/f64")

#: H100 SXM data sheet: HBM3 bytes/s, f32 and f64 FLOP/s outside the
#: tensor cores (at the 700 W power limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

#: the JAX reference's n=4 runs (fea_large_tpu, resid_df=False,
#: pallas=False, bench settings), measured on CPU, where both packages
#: store the coarse inverse in f32: the host loop (device_loop=False) and
#: the device loop (device_loop=True, `_mixed_solve_fn`, bench.py's route)
REFERENCE_N4 = {"newton_iters": 5, "pcg_iters": [5, 7, 15, 21, 14],
                "residual0": 0.014014692693970307}
REFERENCE_N4_DEVICE_LOOP = {"newton_iters": 5, "pcg_iters": [5, 7, 15, 21, 14],
                            "residual0": 0.014014692693970307}
REFERENCE_5TET_N4 = {"newton_iters": 5, "pcg_iters": [4, 4, 11, 15, 16],
                     "residual0": 0.014014692693970307}
REFERENCE_5TET_N4_DEVICE_LOOP = {"newton_iters": 5, "pcg_iters": [4, 4, 11, 15, 16],
                                 "residual0": 0.014014692693970307}
#: the same four runs with the reference's accelerator storage of the
#: explicit coarse inverse (bf16: the reference's `_store_acinv`,
#: fea_large_tpu/solvers/multilevel.py:584, patched to its bf16 branch),
#: measured on CPU by
#: tests/reference_bf16_lists.py: the card stores the inverse in bf16 as the
#: reference's accelerator does (`multilevel._store_acinv`), so its n=4 runs
#: are held to these
REFERENCE_N4_BF16 = {"newton_iters": 5, "pcg_iters": [5, 7, 15, 21, 14],
                     "residual0": 0.014014692693970307}
REFERENCE_N4_DEVICE_LOOP_BF16 = {"newton_iters": 5, "pcg_iters": [5, 7, 15, 21, 14],
                                 "residual0": 0.014014692693970307}
REFERENCE_5TET_N4_BF16 = {"newton_iters": 5, "pcg_iters": [4, 4, 11, 15, 16],
                          "residual0": 0.014014692693970307}
REFERENCE_5TET_N4_DEVICE_LOOP_BF16 = {"newton_iters": 5, "pcg_iters": [4, 4, 11, 15, 16],
                                      "residual0": 0.014014692693970307}
#: the TPU's PCG list of bench.py's default route (BENCH_r05.json: the
#: reference's device loop on a TPU v5e, its inverse stored in bf16)
TPU_PCG = [10, 8, 17, 28, 28]
#: the storage of the explicit coarse inverses on the card: every
#: two-level space (single device and sharded ranks) in bf16, the
#: three-level level-2 inverse in f32 (the reference stores only the
#: former in bf16); the stored apply `coarse_solve` against the f64
#: product of the same bf16 inputs rounded once to bf16, relative to its
#: largest entry (one bf16 rounding of another order's f32 sum)
TWO_LEVEL_STORAGE = torch.bfloat16
LEVEL2_STORAGE = torch.float32
STORED_APPLY_BOUND = 2.0**-8
#: the figures of this script's last run with every inverse stored in
#: f32, printed beside this run's (NVIDIA H100 80GB HBM3, 700.00 W;
#: PERF.md section 5): PCG list, s/step (device loop: median; 9a-9b: per
#: solve; 9e: per solve on 4 cards), peak device memory (B; 9a-9b rank 0),
#: the coarse gemv's ms (phase 6)
F32_STORAGE = {
    "kuhn": {"pcg_iters": [10, 8, 17, 28, 26], "s_per_step": 0.014675, "peak_bytes": 2056428544,
             "gemv_ms": 0.0918},
    "5tet": {"pcg_iters": [7, 6, 13, 18, 18], "s_per_step": 0.023921,
             "peak_bytes": 13054352896, "gemv_ms": 0.5553},
    "8a three_level": {"pcg_iters": [8, 8, 26, 33, 27], "s_per_step": 0.013915,
                       "peak_bytes": 2607056384},
    "8b two_level modes 12": {"pcg_iters": [3, 6, 17, 28, 28], "s_per_step": 0.017762,
                              "peak_bytes": 3725524992},
    "sharded kuhn": {"pcg_iters": [8, 10, 20, 24, 18], "s_per_step": [0.5774, 0.4437],
                     "peak_bytes": 2646573056},
    "sharded 5tet": {"pcg_iters": [7, 6, 13, 18, 17], "s_per_step": [0.4959, 0.3591],
                     "peak_bytes": 10500409856},
    "9e": {"pcg_iters": [8, 10, 20, 24, 18], "s_per_step": [0.01763, 0.01756],
           "peak_bytes": [2646880768, 733988352, 733988352, 733988352]},
}
#: phases 3-4: timed solves of each loop (s/step: their median and range),
#: u of the device loop against the host loop relative to max |u| (the
#: reference's bound for its budget hand-over, tests/test_solvers.py), and
#: the CG budget of the Kuhn hand-over run (its solve needs 89)
LOOP_REPS = 5
LOOP_BOUND = 1e-7
HANDOVER_BUDGET = 20
#: phases 3-4: bench.py's step mode (FEA_BENCH_MODE=step: `_step` with
#: forcing "fixed", a warm-up, then bench.py's default of 3 timed steps);
#: entry()'s step on the card against its CPU run, relative to max |u|
STEP_REPS = 3
ENTRY_BOUND = 1e-10
#: the JAX reference's config 2 (tests/test_parity.py: TET10 5-tet box 2^3,
#: zmin fixed, zmax -0.2, linear="pcg_bcsr", f64, n_steps=2, pcg_tol
#: 1e-13), measured on CPU: per increment (load factor, Newton count, PCG
#: counts, first residual norm)
REFERENCE_CONFIG2 = [(0.5, 5, [41, 40, 40, 37, 30], 0.5840485492109236),
                     (1.0, 5, [41, 40, 40, 37, 34], 0.8107087021552396)]

#: bench.py's solver options (its SolverOptions leave device_loop at the
#: default, True: the device-resident Newton loop)
BENCH = dict(
    linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
    forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
)
#: the host Newton loop, run beside the device loop on the same setup
HOST_LOOP = dict(device_loop=False)
KUHN = dict(BENCH, resid_df=None)
FIVE_TET = dict(BENCH, pallas=True, agg_size=100, resid_df=None)
#: config 2's assembled system (linear="pcg_bcsr") with the tolerances of
#: bench.py's f64 mode (Jacobi, pcg_tol 1e-8)
BCSR = dict(linear="pcg_bcsr", precision="f64", forcing="ew", ew_eta_min=1e-2,
            newton_rtol=1e-6, pcg_tol=1e-8, pcg_maxiter=2000)
#: bench.py's own f64 mode (FEA_BENCH_PRECISION=f64): Jacobi PCG on the
#: matrix-free tangent
MATFREE = dict(BCSR, linear="pcg")
#: the dense direct path on config 2's compression (zmin fixed, zmax -0.2,
#: two increments) of a 5-tet TET10 box: (cells per axis, DOF); dense K
#: 1.39 GB in f64
DIRECT = dict(linear="direct", n_steps=2)
DIRECT_N = (8, 13_203)
#: the task files one card runs (tasks/distributed_* ask for 8 shards)
REPO = pathlib.Path(__file__).resolve().parent
SINGLE_DEVICE_TASKS = (
    "uniaxial_tet4.json", "beam_bending.json", "block_compression_tet10.json",
    "block_compression_tet10.sexp", "block_compression_kuhn.json", "gravity_column_tet10.json",
    "pressure_tet10.json",
)
#: the JAX reference's `run` of the f64 task files, measured on CPU: Newton
#: count per converged increment
REFERENCE_TASK_NEWTON = {
    "uniaxial_tet4.json": [6], "beam_bending.json": [5, 6, 6, 6, 6],
    "block_compression_tet10.json": [7, 7, 5, 5, 5, 6],
    "block_compression_tet10.sexp": [7, 7, 5, 5, 5, 6],
    "gravity_column_tet10.json": [4, 4], "pressure_tet10.json": [3, 3],
}
#: the mixed Kuhn task's u against an f64 solve of the same file (max-norm,
#: relative): its newton_rtol is 1e-8; 8.4e-8 measured on CPU
MIXED_TASK_BOUND = 1e-6

#: phase 8: bench.py's problem with the three-level space (aggregates of
#: 16 nodes) and with the 12-mode two-level space; phase 3's resid_df=None
THREE_LEVEL = dict(KUHN, preconditioner="three_level", **HOST_LOOP)
TWELVE_MODES = dict(KUHN, coarse_modes=12, **HOST_LOOP)
#: phase 8c: the host Galerkin product against the probed Ac
#: (tests/test_multilevel.py's bound), and the host inverse against the
#: device one: the reference test's bound on a 3^3 box, or, where the two
#: f32 routes differ by more at full width (f32 rounding times the
#: condition of Ac), the host route no farther from the f64 inverse than
#: twice the device route
HOST_AC_BOUND = 2e-5
HOST_INV_BOUND = 5e-5
#: phase 8d: the autodiff material on the f64 paths, and the depth of its
#: matrix-free run (a Kuhn box, cells per axis)
MR = MooneyRivlin(1.0, 0.6)
MR_MATFREE_N = 12
#: phase 8e: the example counterparts, run as `python -m`
EXAMPLES = ("uniaxial_tension", "beam_bending", "block_compression")

#: phase 9: the sharded paths (dist/), ranks sharing the card over gloo:
#: (cells per axis, DOF) of the structured (a) and generic (b) runs on 4
#: ranks, and of the f64 runs (c) on 2 ranks
SHARDED = {"kuhn": (36, 1_167_051), "5tet": (36, 1_027_083), "f64": (12, 46_875)}
SHARDED_RANKS = 4
#: u against the single-device solve, relative to max |u|: the reference's
#: bounds for the mixed (tests/test_dist.py:183) and the f64 sharded solves
SHARDED_MIXED_BOUND = 1e-7
SHARDED_F64_BOUND = 1e-10
SHARDED_F64 = dict(linear="pcg", precision="f64", forcing="ew", pcg_tol=1e-13)
#: the JAX reference's `run` of the 8-shard task files (FEA_PLATFORM=cpu, 8
#: virtual CPU devices), measured on CPU: per increment (Newton count, PCG)
REFERENCE_SHARDED_TASKS = {
    "distributed_compression.json": [(5, [1, 4, 13, 30, 149]), (5, [1, 4, 13, 30, 153])],
    "distributed_compression_kuhn.json": [(5, [1, 3, 12, 24, 35]), (5, [1, 3, 11, 27, 39])],
}
#: the same with the reference's accelerator storage (bf16), measured on
#: CPU by tests/reference_bf16_lists.py; and the storage the card's ranks
#: choose: bf16, save on the Kuhn task, whose bf16 copy of the inverse is
#: not positive definite (`multilevel._bf16_where_definite`; ROADMAP C1:
#: the reference stores it in bf16 all the same and its CG stalls), so the
#: card keeps f32 there. Each task is held to the reference's list of the
#: storage its ranks chose.
REFERENCE_SHARDED_TASKS_BF16 = {
    "distributed_compression.json": [(5, [1, 4, 13, 30, 150]), (5, [1, 4, 13, 30, 180])],
    "distributed_compression_kuhn.json": [(6, [1, 3, 5042, 400, 653, 11]),
                                          (6, [1, 3, 5042, 404, 662, 11])],
}
SHARDED_TASK_STORAGE = {"distributed_compression.json": "bfloat16",
                        "distributed_compression_kuhn.json": "float32"}
#: the sharded paths' kernels (B1-B3 and the f64 residual B5 on a lattice;
#: B6, B7, the diagonal, the nodal sum and the f64 residual B9 on a 5-tet box)
SHARDED_KERNELS = {"kuhn": ("struct_freeze", "struct_apply", "struct_diag", "struct_resid"),
                   "5tet": ("elem_apply", "elem_freeze", "elem_diag", "elem_nodal_sum",
                            "elem_resid")}
#: phase 9f: one rank in this process (LocalComm) on the captured route,
#: a solve() of this many increments at 9a's and 9b's widths
ONE_RANK_STEPS = 2
#: 9e's s/step with CG driven from the host, eagerly (NCCL on 4 cards; PERF.md)
NCCL_EAGER_S_PER_STEP = 0.149

#: cells per axis of the phase-2 checks, and (cells per axis, DOF) of the
#: full-width solves
CHECK_N = {"kuhn": 21, "5tet": 13}
FULL = {"kuhn": (35, 1_073_733), "5tet": (36, 1_027_083), "bcsr": (36, 1_027_083),
        "matfree": (35, 1_073_733)}

STRUCT_SRC = "fea_large_tpu_torch/csrc/struct_kernels.cu"
ELEM_SRC = "fea_large_tpu_torch/csrc/elem_kernels.cu"
BCSR_SRC = "fea_large_tpu_torch/csrc/bcsr_kernels.cu"
#: a yardstick outside the port: the card's measured f64 multiply-add rate
PROBE_SOURCE = cuda_build.CSRC / "probe_kernels.cu"
PROBE_SIGNATURES = {
    "fea_probe_dfma": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_double, ctypes.c_double, ctypes.c_void_p],
    "fea_probe_globaltimer": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}
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
    "elem_diag": (ek.LAUNCHES, "diag", ELEM_SRC, "none (the reference's ops/soa.py forms it in jnp)"),
    "elem_nodal_sum": (ek.LAUNCHES, "nodal_sum", ELEM_SRC,
                       "none (the reference's ops/soa.py sums through valence buckets in XLA)"),
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
    "nodal_sum": lambda npe, kind: 0,  # adds only: bound by bytes
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
    for counts in (sk.LAUNCHES, ek.LAUNCHES, bk.LAUNCHES, dl.REPLAYED):
        for key in counts:
            counts[key] = 0


def wrapper_counts(names):
    """The kernel wrappers' launch counts of `names` (KERNELS keys): the
    eager launches (a capture takes its counts back)."""
    return {k: KERNELS[k][0][KERNELS[k][1]] for k in names}


def launch_counts(names):
    """Every launch of `names`: the wrappers' eager ones and those of the
    replayed graphs (the device loop's and the PCG chunks')."""
    return {k: KERNELS[k][0][KERNELS[k][1]] + cuda_graphs.REPLAYED[k] for k in names}


def chunk_stats(solver):
    """(fetches, capture seconds, graph nodes) over the PCG chunks of the
    solver's routes (solvers/newton.py `_ChunkRoute`); every chunk on the
    card captured."""
    chunks = {f"{r}/{k}": c for r, route in solver._routes.items() for k, c in route.chunks.items()}
    check(all(c.captured for c in chunks.values()) or solver._capture_chunks is False,
          "every PCG chunk on the card runs as captured graphs")
    return (sum(c.fetches for c in chunks.values()), sum(c.capture_s for c in chunks.values()),
            {name: c.graph_nodes for name, c in chunks.items()})


def eager_beside(label, solver, run, u_graph, pcg_graph):
    """`run(other)` -> (u, PCG list) once on a copy of `solver` whose PCG
    chunks run their bodies eagerly on the card (one fetch of `active` an
    iteration), beside the graph route's (u_graph, pcg_graph): the same
    PCG list and u bitwise. Returns its seconds and fetches."""
    other = with_options(solver)
    other._capture_chunks = False
    t0 = time.perf_counter()
    u, pcg = run(other)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = torch.equal(u, u_graph) and pcg == pcg_graph
    print(f"  {label}, the same call with eager chunks: {dt:.4f} s, pcg {pcg}; u bitwise the "
          f"graph chunk's: {same}")
    check(same, f"{label}: the graph chunk's u and PCG list are the eager chunk's, bitwise")
    return {"eager_s": dt, "eager_pcg": pcg, "bitwise": same}


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
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]
    print("== phase 0: card")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, driver {driver}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    # the programs' WHILE nodes (csrc/graph_kernels.cu): CUDA 12.4 or later,
    # whose drivers are 550 or later
    check(tuple(int(x) for x in torch.version.cuda.split(".")[:2]) >= (12, 4),
          f"conditional graph nodes need CUDA >= 12.4, torch has {torch.version.cuda}")
    check(int(driver.split(".")[0]) >= 550, f"CUDA 12.4 needs a driver >= 550, got {driver}")
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
    sources = (sk.SOURCE, ek.SOURCE, bk.SOURCE, cuda_graphs.SOURCE, PROBE_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(cuda_build.build_library, sources))
    sk._library()
    ek._library()
    bk._library()
    cuda_graphs._library()
    graph_nesting()
    for src, (path, seconds, log) in zip(sources, builds):
        print(f"{src.name}: {path.name} (nvcc {seconds:.1f} s{'' if seconds else ', reused'})")
        name = None
        for line in log.splitlines():  # ptxas -v: entry function, spills, registers
            m = re.search(r"([a-z_]+_kernel)(?:I([fd]?)((?:Li\d+E)*)|E)", line)
            if "Compiling entry function" in line:
                args = ([m.group(2)] if m and m.group(2) else []) + re.findall(
                    r"Li(\d+)E", m.group(3) or "") if m else []
                name = f"{m.group(1)}<{', '.join(args)}>" if m else None
            elif name and ("spill" in line or "registers" in line):
                print(f"  ptxas {name}: {line.split(':')[-1].strip()}")
                m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
                tag = TILE_KERNELS.get(name.split("<")[0])
                if m and src == sk.SOURCE and tag:
                    print(f"    {tag} blocks of {TILE_THREADS} threads resident per SM: "
                          f"{resident_blocks(int(m.group(1)), int(m.group(2)), TILE_THREADS)}")


def graph_nesting():
    """The nested programs' composition on this card's CUDA: WHILE(outer)
    {a; IF(odd) b; WHILE(inner) c; d} over counter bodies (a: i += 1; b
    counts; c: j += 1, inner = j % 3 != 0; d: outer = i < 5, odd = i odd,
    inner = True; every flag set at the launch) gives the counts of the
    same Python loop and the nodes of its items; CUDA refuses the composed
    graph as a child graph."""
    cnt = torch.zeros(3, dtype=torch.int64, device="cuda")
    outer, odd, inner = (torch.ones((), dtype=torch.bool, device="cuda") for _ in range(3))

    def c():
        cnt[2].add_(1)
        inner.copy_(cnt[2] % 3 != 0)

    def d():
        outer.copy_(cnt[0] < 5)
        odd.copy_(cnt[0] % 2 == 1)
        inner.fill_(True)

    a, b = (cuda_graphs.Body(lambda i=i: cnt[i].add_(1)) for i in (0, 1))
    c, d = cuda_graphs.Body(c), cuda_graphs.Body(d)
    prog = cuda_graphs.Program([([(a, None), (b, odd), (c, cuda_graphs.While(inner)), (d, None)],
                                 cuda_graphs.While(outer))])
    t0 = time.perf_counter()
    prog.launch()
    got = cnt.tolist()
    dt = time.perf_counter() - t0
    i = n_b = j = 0
    flag = True
    while True:  # the program's structure in Python, its flags initially set
        i, n_b = i + 1, n_b + flag
        while True:
            j += 1
            if j % 3 == 0:
                break
        flag = i % 2 == 1
        if i >= 5:
            break
    child = cuda_graphs.child_graph_error(prog)
    print(f"nested program WHILE {{IF, WHILE}} over counters: runs {got} (Python loop "
          f"{[i, n_b, j]}), {prog.nodes} nodes, {dt * 1e3:.3f} ms with the fetch; the composed "
          f"graph as a child graph: CUDA error {child} (0: taken)")
    check(got == [i, n_b, j], "the nested program runs its bodies as the Python loop does")
    check(prog.nodes == a.nodes + b.nodes + c.nodes + d.nodes + 8, "the nested program's nodes")
    check(child != 0, "CUDA refuses a child graph that holds conditional nodes")


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
    return element_inputs_of(p, p64, mesh.coords_host)


def element_inputs_of(p, p64, coords_host):
    """The element kernels' inputs on the f32 and f64 SoA problems p, p64
    whose nodes lie at `coords_host`."""
    device = p.gradN.device
    q, npe, _, E = p.gradN.shape
    u, v = smooth_fields(coords_host, device)
    u64, _ = smooth_fields(coords_host, device, torch.float64)
    ue, ve = ek._gather_flat(p, u), ek._gather_flat(p, v)
    gradN = p.gradN.view(q * npe * 3, E)
    rows = ek.elem_freeze_plain(ue, gradN, NeoHookean(1.0, 0.6), npe=npe, q=q)
    ue64, gradN64 = ek._gather_flat(p64, u64), p64.gradN.view(q * npe * 3, E)
    # the nodal sums' inputs: what B6 and B9 hand them, [3, npe*E]
    d32 = ek.elem_apply_plain(ve, gradN, p.detJxW, *rows, npe=npe, q=q).reshape(3, -1)
    d64 = ek.elem_resid_plain(ue64, gradN64, p64.detJxW, NeoHookean(1.0, 0.6), npe=npe,
                              q=q).reshape(3, -1)
    return dict(p=p, q=q, npe=npe, E=E, ue=ue, v=v, ve=ve, gradN=gradN, rows=rows,
                ue64=ue64, gradN64=gradN64, dV64=p64.detJxW, d32=d32.contiguous(),
                d64=d64.contiguous())


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


def diag_traffic(p, E, npe):
    """What the unstructured diagonal moves besides its state and geometry
    (the bound's bytes, as tensors): the slot scratch written by the element
    pass and read by the nodal sum (counted twice), and the nodal table's
    offsets and slot ids (`ScatterBuckets.csr`), read once."""
    slots = torch.empty((npe * E, ek.SLOT_PAD), device=p.gradN.device)
    return (slots, slots, *p.buckets.csr[:2])


def element_calls(x, materials):
    """{name: (kernel call, plain call, inputs, material kind)} of B6-B9,
    of the unstructured diagonal (its element pass and nodal sum) and of the
    nodal sum in f64 and f32 (f32 last: the one `time_calls` keeps). B6's
    inputs are what it reads: v [3, N] and the int32 conn, not the gathered
    values (which the roofline's yardstick in portbench still counts)."""
    q, npe, ue, ve, gradN, rows = x["q"], x["npe"], x["ue"], x["ve"], x["gradN"], x["rows"]
    p, v = x["p"], x["v"]
    dV = p.detJxW
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
    calls["elem_apply"] = (lambda: ek.elem_apply(v, p.conn32, gradN, dV, *rows, **kw),
                           lambda: ek.elem_apply_plain(ve, gradN, dV, *rows, **kw),
                           (v, p.conn32, gradN, dV, *rows), 1)
    calls["elem_force"] = (lambda: ek.elem_force(gradN, dV, *rows[:2], **kw),
                           lambda: ek.elem_force_plain(gradN, dV, *rows[:2], **kw),
                           (gradN, dV, *rows[:2]), 1)
    calls["elem_diag"] = (lambda: ek.elem_diag(gradN, dV, *rows, p.buckets, **kw),
                          lambda: ek.elem_diag_plain(gradN, dV, *rows, p.buckets, **kw),
                          (gradN, dV, *rows, *diag_traffic(p, x["E"], npe)), 1)
    for tag in ("64", "32"):
        d = x["d" + tag]
        calls[f"elem_nodal_sum/f{tag}"] = (lambda d=d: ek.nodal_sum(d, p.buckets),
                                           lambda d=d: p.buckets.apply(d),
                                           (d, *p.buckets.csr[:2]), 1)
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
        calls = element_calls(x, MATERIALS)
        report_checks(f"5tet {et}", run_checks(calls))
        check_repeats(f"5tet {et}", {k: c for k, c in calls.items()
                                     if k.startswith(("elem_diag", "elem_nodal_sum", "elem_apply"))})
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
    calls = element_calls(x, MATERIALS)
    report_checks("5tet 5pt", run_checks(calls))
    check_repeats("5tet 5pt", {k: c for k, c in calls.items()
                               if k.startswith(("elem_diag", "elem_nodal_sum", "elem_apply"))})
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")


def solve_n4(build, opts, references, label, device):
    """bench.py's settings on a box n=4 against the reference's run with
    its accelerator storage, `references` (bf16 list, f32 list beside)."""
    label = f"{label} {'device' if opts.get('device_loop', True) else 'host'} loop"
    mesh = build(4, 4, 4, element_type="tet10", device=device)
    bc = bench_bc(mesh)
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    _, ok, rec = solver._newton(bench_start(mesh, bc), 1.0)
    ref, ref32 = references
    print(f"{label} n=4: newton {rec.newton_iters} pcg {rec.pcg_iters} |R0| "
          f"{rec.residual_norms[0]!r} (reference, inverse stored in bf16: newton "
          f"{ref['newton_iters']} pcg {ref['pcg_iters']} |R0| {ref['residual0']!r}; PCG equal: "
          f"{rec.pcg_iters == ref['pcg_iters']}; in f32: pcg {ref32['pcg_iters']}); coarse "
          f"inverse stored {str(solver._coarse.acinv.dtype).removeprefix('torch.')}")
    check(solver._coarse.acinv.dtype == TWO_LEVEL_STORAGE,
          f"{label} n=4: the coarse inverse is stored in {TWO_LEVEL_STORAGE}")
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


def with_options(solver, **changes):
    """The same setup (meshes, SoA tables, coarse space) under other
    options: a shallow copy of `solver` with its own device loop and PCG
    chunks."""
    other = copy.copy(solver)
    other.options = dataclasses.replace(solver.options, **changes)
    other._device_loop = None
    other._routes = {}
    return other


def timed_solves(label, run, reps):
    """`reps` solves of `run()` -> (u, ok, record), each ending in a
    synchronise: [(u, record, seconds)]; every one converged to a reduction
    <= 1e-6 and bitwise equal to the first in u, PCG list and norms."""
    runs = []
    for rep in range(reps):
        t0 = time.perf_counter()
        u, ok, rec = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        red = rec.residual_norms[-1] / rec.residual_norms[0]
        check(ok and red <= 1e-6, f"{label} solve {rep} converged to reduction <= 1e-6")
        runs.append((u, rec, dt))
    ua, reca, _ = runs[0]
    for u, rec, _ in runs[1:]:
        check(torch.equal(ua, u), f"{label}: repeat solves give bitwise-equal u")
        check(rec.pcg_iters == reca.pcg_iters and rec.residual_norms == reca.residual_norms,
              f"{label}: repeat solves give identical PCG lists and residual norms")
    steps = [dt / r.newton_iters for _, r, dt in runs]
    print(f"{label}: {reps} solves, newton {reca.newton_iters}, pcg {reca.pcg_iters} "
          f"(total {sum(reca.pcg_iters)}), |R| {reca.residual_norms[0]:.6e} -> "
          f"{reca.residual_norms[-1]:.6e} (reduction {red:.3e}); s/step median "
          f"{statistics.median(steps):.5f}, range {min(steps):.5f}-{max(steps):.5f}")
    return runs


def coarse_storage(label, acinv, want):
    """The storage of an explicit coarse inverse on the card: its dtype
    (checked against `want`), dim and bytes, printed and returned."""
    nbytes = acinv.numel() * acinv.element_size()
    dtype = str(acinv.dtype).removeprefix("torch.")
    print(f"  {label} coarse inverse: stored {dtype}, dim {acinv.shape[0]}, {nbytes} B "
          f"({nbytes / 2**20:.1f} MiB)")
    check(acinv.dtype == want, f"{label}: the coarse inverse is stored in {want}")
    return {"dtype": dtype, "dim": acinv.shape[0], "bytes": nbytes}


def stored_apply(label, coarse):
    """`coarse_solve` on the card with the stored inverse against the f64
    product of the same inputs (the stored inverse, rc rounded to its
    dtype) rounded once to that dtype: within STORED_APPLY_BOUND of the
    largest entry, rc's dtype kept, and a repeat bitwise equal (cuBLAS's
    product is deterministic on one stream). Returns (relative error,
    entries that differ from the once-rounded product)."""
    g = torch.Generator(device=coarse.acinv.device).manual_seed(0)
    rc = torch.randn((coarse.n_agg, coarse.modes), generator=g, device=coarse.acinv.device)
    got = coarse.coarse_solve(rc)
    again = coarse.coarse_solve(rc)
    stored = coarse.acinv.dtype
    exact = (coarse.acinv.double() @ rc.reshape(-1).to(stored).double()).to(stored).float()
    diff = (got.reshape(-1) - exact).abs()
    err = float(diff.max() / exact.abs().max())
    flips = int((diff > 0).sum())
    print(f"  {label} stored apply ({str(stored).removeprefix('torch.')} x {rc.shape[0]}x"
          f"{rc.shape[1]}): against the f64 product rounded once, {err:.3e} of max |x| (bound "
          f"{STORED_APPLY_BOUND:.4g}), {flips} of {exact.numel()} entries differ; repeat "
          f"bitwise: {torch.equal(got, again)}")
    check(got.dtype == rc.dtype and got.shape == rc.shape, f"{label}: the apply keeps rc's dtype")
    check(err <= STORED_APPLY_BOUND, f"{label}: the stored apply rounds once to its dtype")
    check(torch.equal(got, again), f"{label}: the stored apply is bitwise repeatable")
    return err, flips


def beside_f32(label, pcg, s_per_step, peak):
    """One line: this run's PCG list, s/step and peak device memory beside
    those with the inverse stored in f32 (F32_STORAGE)."""
    old = F32_STORAGE[label]
    print(f"  {label}, inverse stored as above, beside f32 storage: PCG {pcg} (f32 "
          f"{old['pcg_iters']}), s/step {s_per_step} (f32 {old['s_per_step']}), peak "
          f"{peak} B (f32 {old['peak_bytes']})")


def full_width(label, build, opts, keys, device, card):
    """bench.py's default route at full width: setup, then the device loop
    (the first solve captures its graphs; then LOOP_REPS timed solves), then
    the host loop on the same setup (a warm-up and LOOP_REPS timed solves).
    Counts are set to 0 before the setup and read after the device-loop
    solves: the main path's launches are the wrappers' eager launches (the
    setup's probes, the loop's warm-up) plus what the replayed graphs
    launched (per capture x body runs), and no wrapper may be called during
    a replayed solve. `keys`: the path's kernels (names in KERNELS)."""
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
    check(solver.options.device_loop, f"the {label} path runs bench.py's default, the device loop")
    in_setup = wrapper_counts(keys)
    print(f"kernel launches in setup: {in_setup}; coarse setup {solver._coarse.setup}")
    check(solver._coarse.setup["invert"] == "device", "the coarse inverse was built on the card")
    check(all(in_setup[k] > 0 for k in keys if k.endswith(("_freeze", "_apply"))),
          f"the {label} setup's probes launch the freeze and tangent-action kernels")
    print(f"{label} n={n}: {mesh.n_nodes} nodes, {mesh.n_elements} tets, {mesh.n_dof} DOF; "
          f"mesh {t_mesh:.2f} s, solver setup {t_setup:.2f} s "
          f"(coarse: {solver._coarse.n_agg} aggregates, dim {solver._coarse.acinv.shape[0]})")
    storage = coarse_storage(label, solver._coarse.acinv, TWO_LEVEL_STORAGE)
    storage["apply_rel_err"], storage["apply_entries_off"] = stored_apply(label, solver._coarse)
    # the device loop: the first solve builds and captures it
    setup_peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    t2 = time.perf_counter()
    u1, ok, rec1 = solver._newton(u0, 1.0)
    torch.cuda.synchronize()
    loop = solver._device_loop
    held = torch.cuda.memory_allocated() - held
    print(f"device loop holds {held} B ({held / 2**30:.2f} GiB: its state and the bodies' graph "
          f"pools); peak of the setup {setup_peak} B ({setup_peak / 2**30:.2f} GiB)")
    print(f"device loop, first solve (with the capture): {time.perf_counter() - t2:.3f} s, "
          f"capture {loop.capture_s:.3f} s, ok={ok}, newton {rec1.newton_iters}, "
          f"pcg {rec1.pcg_iters}; graph nodes {loop.graph_nodes} (one program: WHILE(running) "
          f"{{head, WHILE(active) cg, tail}})")
    ticks = wrapper_counts(keys)
    dev_runs = timed_solves(f"{label} device loop", lambda: solver._newton(u0, 1.0), LOOP_REPS)
    check(wrapper_counts(keys) == ticks,
          f"no kernel wrapper called during the {label} device loop's replayed solves")
    replayed = {k: dl.REPLAYED[k] for k in keys}
    launches = {k: ticks[k] + replayed[k] for k in keys}
    peak = torch.cuda.max_memory_allocated()
    fetches, runs = loop.last.fetches, dict(loop.runs)
    ud, recd, _ = dev_runs[0]
    check(torch.equal(u1, ud) and rec1.pcg_iters == recd.pcg_iters,
          "the capturing solve and the replayed ones give bitwise-equal u")
    print(f"kernel launches of the main path (setup + warm-up + the replays of {1 + LOOP_REPS} "
          f"solves): {launches}; by the replays: {replayed}; per capture: {loop.per_capture}")
    print(f"device loop: body runs per solve {runs}, host fetches per solve {fetches} (one launch), "
          f"peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    check(fetches == 1, f"a {label} device-loop solve is one launch and one fetch")
    captured = {k for c in loop.per_capture.values() for k in c}
    check(all(replayed[k] > 0 for k in keys if k in captured),
          f"every kernel of the {label} loop's bodies launched by the replays")
    check(all(v > 0 for v in launches.values()), f"every kernel of the {label} path launched")
    resid = next(k for k in keys if k.endswith("_resid"))
    n_f64 = f64_residuals(recd) * (1 + LOOP_REPS)
    print(f"f64 residuals in the device-loop solves: {n_f64}, {resid} replays: {replayed[resid]}")
    check(replayed[resid] == n_f64, f"{resid} launched once per f64 residual")
    # the host loop on the same setup: its CG on the mixed route's chunks
    host_before = launch_counts(keys)
    torch.cuda.reset_peak_memory_stats()
    host = with_options(solver)
    warm = timed_solves(f"{label} host loop (first solve with the chunk's capture)",
                        lambda: host._newton_mixed_host(u0, 1.0), 1)
    fetch0, host_capture_s, host_nodes = chunk_stats(host)
    host_runs = timed_solves(f"{label} host loop", lambda: host._newton_mixed_host(u0, 1.0),
                             LOOP_REPS)
    uh, rech, _ = host_runs[0]
    host_fetches = (chunk_stats(host)[0] - fetch0) / LOOP_REPS
    host_peak = torch.cuda.max_memory_allocated()
    host_launches = {k: v - host_before[k] for k, v in launch_counts(keys).items()}
    check(torch.equal(warm[0][0], uh), f"{label}: the host loop's capturing solve bitwise the rest")
    print(f"{label} host loop: PCG chunk capture {host_capture_s:.3f} s, graph nodes {host_nodes}, "
          f"host fetches of the chunks per solve {host_fetches:g} (a Newton iteration: one run of "
          f"at most pcg_chunk {solver.options.pcg_chunk}); peak device memory {host_peak} B "
          f"({host_peak / 2**30:.2f} GiB)")
    host_eager = eager_beside(f"{label} host loop", solver,
                              lambda o: (lambda out: (out[0], out[2].pcg_iters))(
                                  o._newton_mixed_host(u0, 1.0)), uh, rech.pcg_iters)
    check(recd.newton_iters == rech.newton_iters,
          f"{label}: the device loop takes the host loop's Newton count")
    du = float((ud - uh).abs().max() / uh.abs().max())
    tpu = f", TPU (device loop, BENCH_r05.json) {TPU_PCG}" if label == "kuhn" else ""
    print(f"{label} PCG: device loop {recd.pcg_iters}, host loop {rech.pcg_iters}{tpu}; u device "
          f"vs host: {du:.3e} of max |u|; host-loop launches over {1 + LOOP_REPS} solves "
          f"{host_launches}")
    check(du <= LOOP_BOUND, f"{label}: device-loop u within {LOOP_BOUND} of the host loop's")
    check(bool(torch.isfinite(ud).all()) and tuple(ud.shape) == (mesh.n_nodes, 3),
          "finite u [N, 3]")
    # the converged u's residual, recomputed by the plain f64 pass on the host CPU
    r_cpu, red_cpu = host_reduction(lambda: build(n, n, n, element_type="tet10", device="cpu"),
                                    NeoHookean(1.0, 0.6), bench_bc, ud, None, 1.0,
                                    recd.residual_norms[0])
    print(f"host CPU f64 residual of the device loop's u: {r_cpu:.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, "host-recomputed residual reduction <= 1e-6")
    dsteps = [dt / r.newton_iters for _, r, dt in dev_runs]
    hsteps = [dt / r.newton_iters for _, r, dt in host_runs]
    beside_f32(label, recd.pcg_iters, statistics.median(dsteps), peak)
    summary = {
        "path": label, "n_dof": mesh.n_dof, "newton_iters": recd.newton_iters,
        "pcg_iters": recd.pcg_iters, "pcg_iters_host_loop": rech.pcg_iters,
        "residual_reduction": recd.residual_norms[-1] / recd.residual_norms[0],
        "host_reduction": red_cpu, "u_vs_host_loop": du,
        "s_per_step": dsteps, "s_per_step_median": statistics.median(dsteps),
        "s_per_step_host_loop": hsteps, "s_per_step_host_loop_median": statistics.median(hsteps),
        "host_loop_chunk_fetches_per_solve": host_fetches, "host_loop_chunk_capture_s":
        host_capture_s, "host_loop_peak_bytes": host_peak, "host_loop_eager_chunk": host_eager,
        "fetches_per_solve": fetches, "capture_s": loop.capture_s, "graph_nodes": loop.graph_nodes,
        "body_runs_per_solve": runs, "setup_s": t_setup, "peak_bytes": peak,
        "setup_peak_bytes": setup_peak, "device_loop_bytes": held,
        "launches": launches, "setup_launches": in_setup, "host_loop_launches": host_launches,
        "coarse": storage, "card": card,
    }
    if label == "kuhn":
        summary["pcg_iters_tpu"] = TPU_PCG
        summary["handover"] = handover(solver, u0, ud)
    print("slice: " + json.dumps(summary))
    return solver, u0, launches, recd.pcg_iters


def handover(solver, u0, u_full):
    """The device loop with a CG budget of HANDOVER_BUDGET on the same
    setup: it must run out, hand the solve to the host loop, and converge,
    within LOOP_BOUND of the unbudgeted device loop's u."""
    other = with_options(solver, device_loop_budget=HANDOVER_BUDGET)
    t0 = time.perf_counter()
    u, ok, rec = other._newton(u0, 1.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = other._device_loop.last
    du = float((u - u_full).abs().max() / u_full.abs().max())
    red = rec.residual_norms[-1] / rec.residual_norms[0]
    print(f"hand-over, device_loop_budget={HANDOVER_BUDGET}: the device loop ran {out.n_iters} "
          f"Newton iterations, {out.total_cg} CG, exhausted={out.exhausted}; the host loop "
          f"finished: newton {rec.newton_iters}, pcg {rec.pcg_iters}, reduction {red:.3e}, "
          f"{dt:.3f} s (with the capture); u within {du:.3e} of the unbudgeted loop's")
    check(out.exhausted and not out.converged, "the budgeted device loop handed the solve over")
    check(ok and red <= 1e-6, "the handed-over solve converged")
    check(du <= LOOP_BOUND, f"the handed-over u within {LOOP_BOUND} of the device loop's")
    return {"device_newton": out.n_iters, "device_cg": out.total_cg,
            "newton_iters": rec.newton_iters,
            "pcg_iters": rec.pcg_iters, "u_vs_device_loop": du}


def step_mode(label, solver, u0, keys, build, card):
    """bench.py's step mode (FEA_BENCH_MODE=step) on the setup of `solver`
    (phases 3-4): `_step(u0, 1.0)` with forcing "fixed", the mixed step
    (the plain f64 residual, the freeze, block-Jacobi plus the coarse
    correction, chunked f32 PCG), a warm-up and STEP_REPS timed steps,
    all bitwise equal. Counts are set to 0 just before the steps and read
    just after: the freeze, diagonal and tangent-action kernels launched,
    the last at least once per PCG iteration. The stepped u's f64
    residual, recomputed on the host CPU, is under the start's. Then one
    `step_fn` (the same set-up and one PCG chunk of at most pcg_chunk
    iterations), bitwise the step where it took the step's count.
    Returns the steps' launches of `keys`."""
    other = with_options(solver, forcing="fixed")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for rep in range(1 + STEP_REPS):
        t0 = time.perf_counter()
        out = other._step(u0, 1.0)
        torch.cuda.synchronize()
        runs.append((out, time.perf_counter() - t0))
        if rep == 0:
            fetch0, capture_s, nodes = chunk_stats(other)
    launches = launch_counts(keys)
    peak = torch.cuda.max_memory_allocated()
    fetches = (chunk_stats(other)[0] - fetch0) / STEP_REPS
    (u1, it1, ok1, rel1), warm_s = runs[0]
    for (u, it, _, _), _ in runs[1:]:
        check(torch.equal(u, u1) and it == it1, f"{label} step mode: repeat steps bitwise equal")
    secs = [dt for _, dt in runs[1:]]
    apply_key = next(k for k in keys if k.endswith("_apply"))
    print(f"{label} step mode (bench.py FEA_BENCH_MODE=step, pcg_tol "
          f"{other.options.pcg_tol}): s/step median {statistics.median(secs):.5f}, range "
          f"{min(secs):.5f}-{max(secs):.5f} (warm-up {warm_s:.5f}, with the chunk's capture "
          f"{capture_s:.3f} s); pcg {it1}, ok={ok1}, rel {rel1:.3e}; host fetches of the chunk "
          f"per step {fetches:g}; graph nodes {nodes}; peak device memory {peak} B "
          f"({peak / 2**30:.2f} GiB); launches over {1 + STEP_REPS} steps (eager and replayed) "
          f"{launches}, replayed {dict((k, dl.REPLAYED[k]) for k in keys)}")
    eager = eager_beside(f"{label} step mode", other,
                         lambda o: (lambda out: (out[0], [out[1]]))(o._step(u0, 1.0)), u1, [it1])
    check(all(launches[k] > 0 for k in keys if k.endswith(("_freeze", "_diag", "_apply"))),
          f"the {label} step launches its freeze, diagonal and tangent-action kernels")
    check(launches[apply_key] >= (1 + STEP_REPS) * it1,
          f"{apply_key} launched at least once per PCG iteration of the step")
    r_start, r_step = host_norms(lambda: build(*(3 * [FULL[label][0]]), element_type="tet10",
                                               device="cpu"),
                                 NeoHookean(1.0, 0.6), bench_bc, [u0, u1], None, 1.0)
    print(f"host CPU f64 residual: start {r_start:.6e}, after the step {r_step:.6e} "
          f"({r_step / r_start:.3e})")
    check(r_step < r_start, f"the {label} step lowers the f64 residual")
    fetch0 = chunk_stats(other)[0]
    t0 = time.perf_counter()
    u_f, k, ok, rnorm = other.step_fn(u0, 1.0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fn_fetches = chunk_stats(other)[0] - fetch0
    same = k == it1 and torch.equal(u_f, u1)
    print(f"{label} step_fn (one chunk of at most {other.options.pcg_chunk}): {dt:.5f} s, pcg {k}, "
          f"ok={ok}, |r| {rnorm:.3e}, host fetches of the chunk {fn_fetches}; bitwise the step's "
          f"u: {same}")
    check(fn_fetches == 1, f"{label} step_fn: one fetch of the chunk")
    check(bool(torch.isfinite(u_f).all()) and u_f.shape == u0.shape and 0 < k
          <= other.options.pcg_chunk, f"{label} step_fn gives a finite u [N, 3] in one chunk")
    check(same or k != it1, f"{label} step_fn bitwise the step where it took the step's count")
    print("slice: " + json.dumps({
        "path": f"{label} step mode", "s_per_step": secs, "s_per_step_median":
        statistics.median(secs), "warmup_s": warm_s, "pcg_iters": it1, "ok": ok1, "rel": rel1,
        "host_residual_start": r_start, "host_residual_step": r_step, "launches": launches,
        "chunk_fetches_per_step": fetches, "chunk_capture_s": capture_s, "peak_bytes": peak,
        "eager_chunk": eager,
        "step_fn": {"s": dt, "pcg_iters": k, "ok": ok, "r_norm": rnorm, "fetches": fn_fetches},
        "card": card}))
    return launches


def entry_on_card(device, card):
    """`entry()`'s step (the f64 matrix-free route on a TET10 box 4^3) on
    the card against its CPU run, at its own arguments (u = 0, a zero
    residual) and at the 20% affine compression its BCs prescribe: within
    ENTRY_BOUND of max |u|, finite, shape and dtype kept."""
    fn, args = entry(device=device)
    fn_c, args_c = entry(device="cpu")
    mesh = box_mesh(4, 4, 4, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.2).build()
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    u[:, 2] = -0.2 * mesh.coords[:, 2]
    u = bc.impose(u, 1.0)
    for name, (a, a_c) in {"entry args": (args, args_c),
                           "20% compression": ((u.to(device), 1.0), (u, 1.0))}.items():
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = fn_c(*a_c)
        err = float((out.cpu() - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-300)
        print(f"entry() on the card, {name}: {dt:.4f} s, out {tuple(out.shape)} {out.dtype}, "
              f"max |u| {float(ref.abs().max()):.6e}, card vs CPU {err:.3e} ({card})")
        check(out.shape == a[0].shape and out.dtype == torch.float64
              and bool(torch.isfinite(out).all()), "entry() gives a finite f64 u [N, 3]")
        check(err <= ENTRY_BOUND * scale, f"entry() on the card within {ENTRY_BOUND} of the CPU's")


def phase_kuhn(device, card):
    print(f"== phase 3: Kuhn path ({card})")
    t0 = time.perf_counter()
    solve_n4(box_mesh_kuhn, dict(BENCH, resid_df=False, **HOST_LOOP),
             (REFERENCE_N4_BF16, REFERENCE_N4),
             "kuhn resid_df=False", device)
    solve_n4(box_mesh_kuhn, dict(BENCH, resid_df=False),
             (REFERENCE_N4_DEVICE_LOOP_BF16, REFERENCE_N4_DEVICE_LOOP),
             "kuhn resid_df=False", device)
    solver = solve_n4(box_mesh_kuhn, KUHN, (REFERENCE_N4_DEVICE_LOOP_BF16, REFERENCE_N4_DEVICE_LOOP),
                      "kuhn resid_df=None", device)
    check(solver._resid_df, "resid_df=None routes the fused residual on the card")
    keys = [k for k in KERNELS if k.startswith("struct_")]
    out = full_width("kuhn", box_mesh_kuhn, KUHN, keys, device, card)
    steps = step_mode("kuhn", out[0], out[1], keys, box_mesh_kuhn, card)
    entry_on_card(device, card)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    return out + (steps,)


def phase_5tet(device, card):
    print(f"== phase 4: 5-tet path ({card})")
    t0 = time.perf_counter()
    solve_n4(box_mesh, dict(FIVE_TET, resid_df=False, **HOST_LOOP),
             (REFERENCE_5TET_N4_BF16, REFERENCE_5TET_N4),
             "5tet resid_df=False", device)
    solve_n4(box_mesh, dict(FIVE_TET, resid_df=False),
             (REFERENCE_5TET_N4_DEVICE_LOOP_BF16, REFERENCE_5TET_N4_DEVICE_LOOP),
             "5tet resid_df=False", device)
    solver = solve_n4(box_mesh, FIVE_TET,
                      (REFERENCE_5TET_N4_DEVICE_LOOP_BF16, REFERENCE_5TET_N4_DEVICE_LOOP),
                      "5tet resid_df=None", device)
    check(solver._resid_df, "resid_df=None routes the fused residual B9 on the card")
    keys = [k for k in KERNELS if k.startswith("elem_")]
    out = full_width("5tet", box_mesh, FIVE_TET, keys, device, card)
    steps = step_mode("5tet", out[0], out[1], keys, box_mesh, card)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")
    return out + (steps,)


def f64_solves(label, solver, u0, reps, keys=()):
    """Solves of an f64 PCG route (phase 5, 7a): one per name in `reps`,
    the first capturing the route's PCG chunk, each converged to a
    reduction <= 1e-6, all bitwise equal in u and PCG list; the chunk's
    host fetches per solve and its capture seconds, the launches of `keys`
    so far (eager and replayed), then one solve with eager chunks beside
    (`eager_beside`). Returns a dict of runs [(u, record, s)], fetches,
    capture_s, launches, eager."""
    runs = []
    for i, rep in enumerate(reps):
        t0 = time.perf_counter()
        u, ok, rec = solver._newton(u0, 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        red = rec.residual_norms[-1] / rec.residual_norms[0]
        print(f"{rep} solve: {dt:.4f} s, newton {rec.newton_iters}, pcg {rec.pcg_iters} "
              f"(total {sum(rec.pcg_iters)}), |R| {rec.residual_norms[0]:.6e} -> "
              f"{rec.residual_norms[-1]:.6e} (reduction {red:.3e}), "
              f"{dt / max(rec.newton_iters, 1):.5f} s/step")
        check(ok and red <= 1e-6, f"{label} {rep} solve converged to reduction <= 1e-6")
        runs.append((u, rec, dt))
        if i == 0:
            fetch0, capture_s, nodes = chunk_stats(solver)
    ua, reca, _ = runs[0]
    for u, rec, _ in runs[1:]:
        check(torch.equal(ua, u), f"every {label} solve gives bitwise-equal u")
        check(rec.pcg_iters == reca.pcg_iters and rec.residual_norms == reca.residual_norms,
              f"every {label} solve gives identical PCG lists and residual norms")
    fetches = (chunk_stats(solver)[0] - fetch0) / max(len(runs) - 1, 1)
    launches = launch_counts(keys)
    print(f"{label}: PCG chunk capture {capture_s:.3f} s, graph nodes {nodes}, host fetches of the "
          f"chunk per solve {fetches:g} ({fetches / reca.newton_iters:g} a Newton step: the solve "
          f"and its restart in one launch)")
    check(fetches == reca.newton_iters, f"{label}: one fetch a Newton step")
    eager = eager_beside(f"{label} solve", solver,
                         lambda o: (lambda out: (out[0], out[2].pcg_iters))(o._newton(u0, 1.0)),
                         ua, reca.pcg_iters)
    return {"runs": runs, "fetches": fetches, "capture_s": capture_s, "launches": launches,
            "eager": eager}


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
    f64_solve = f64_solves("bcsr", solver, u0, ("warm-up", "timed"), ["bcsr_spmv"])
    runs, fetches, capture_s = f64_solve["runs"], f64_solve["fetches"], f64_solve["capture_s"]
    launches = f64_solve["launches"]["bcsr_spmv"]
    total_pcg = sum(sum(r.pcg_iters) for _, r, _ in runs)
    peak = torch.cuda.max_memory_allocated()
    print(f"bcsr_spmv launches (2 solves, eager and replayed): {launches}, replayed "
          f"{dl.REPLAYED['bcsr_spmv']}, PCG iterations: {total_pcg}")
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
    # entry.py's step (`step_fn`, here `_step`) on this route, counts
    # set to 0 just before it and read just after
    reset_launches()
    fetch0 = chunk_stats(solver)[0]
    t3 = time.perf_counter()
    u_s, k_s, ok_s, rel_s = solver.step_fn(u0, 1.0)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t3
    step_launches = launch_counts(["bcsr_spmv"])["bcsr_spmv"]
    step_fetches = chunk_stats(solver)[0] - fetch0
    print(f"step_fn (one f64 step at pcg_tol {solver.options.pcg_tol}): {dt_s:.4f} s, pcg {k_s}, "
          f"ok={ok_s}, rel {rel_s:.3e}, bcsr_spmv launches {step_launches} (replayed), host "
          f"fetches of the chunk {step_fetches}")
    check(step_fetches == 1, "step_fn on the BCSR path: one fetch (the solve and its restart)")
    check(bool(torch.isfinite(u_s).all()) and 0 < k_s <= step_launches,
          "step_fn on the BCSR path: a finite u, B10 at least once per PCG iteration")
    summary = {
        "path": "bcsr", "n_dof": mesh.n_dof, "nnzb": st.nnzb, "newton_iters": recb.newton_iters,
        "pcg_iters": recb.pcg_iters, "residual_reduction":
        recb.residual_norms[-1] / recb.residual_norms[0], "s_per_step": dtb / recb.newton_iters,
        "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup, "peak_bytes": peak,
        "launches": {"bcsr_spmv": launches}, "card": card, "chunk_fetches_per_solve": fetches,
        "chunk_capture_s": capture_s, "eager_chunk": f64_solve["eager"],
        "step_fn": {"s": dt_s, "pcg_iters": k_s, "ok": ok_s, "rel": rel_s,
                    "launches": step_launches, "fetches": step_fetches},
    }
    print("slice: " + json.dumps(summary))
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    return solver, u0, {"bcsr_spmv": launches}, {"bcsr_spmv": step_launches}


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


def diag_parts(x):
    """The unstructured diagonal's two kernels timed apart (per call and
    queued) beside their bytes bounds: the element pass (`ek.diag_slots`:
    state, geometry, the padded slot sums written) and the nodal sum
    (`ek.diag_sum`: the nodal table's offsets and slot ids, one 32-byte
    sector per slot, the [3, 3, N] blocks written)."""
    q, npe, E, p = x["q"], x["npe"], x["E"], x["p"]
    kw = dict(npe=npe, q=q)
    rows, b = x["rows"], p.buckets
    slots = ek.diag_slots(x["gradN"], p.detJxW, *rows, **kw)
    out = ek.diag_sum(slots, b)
    offsets, ids, _ = b.csr
    parts = {
        "elements": (lambda: ek.diag_slots(x["gradN"], p.detJxW, *rows, **kw),
                     nbytes(x["gradN"], p.detJxW, *rows, slots)),
        "nodal sum": (lambda: ek.diag_sum(slots, b),
                      nbytes(offsets, ids, out) + ids.numel() * 4 * ek.SLOT_PAD),
    }
    table = {}
    for name, (fn, n_bytes) in parts.items():
        b_ms = n_bytes / HBM_BYTES_S * 1e3
        ms, device_ms = cuda_ms(fn), queued_ms(fn)
        table[name] = dict(bytes=n_bytes, bound_ms=b_ms, ms=ms, device_ms=device_ms)
        print(f"  elem_diag {name:14s} kernel {ms:9.4f} ms   queued {device_ms:9.4f} ms   bound "
              f"{b_ms:8.4f} ms ({n_bytes / 1e6:.1f} MB, {100 * b_ms / ms:5.1f}% / "
              f"{100 * b_ms / device_ms:5.1f}% of it)")
    return table


#: CG iterations of one timed run of phase 6's PCG iteration timings
ITERATION_RUN = 16


def spans_now() -> dict:
    """The program's device-span totals now, {span: (runs, ns)}."""
    return {name: tuple(v) for name, v in profiling.SPAN_TOTALS.items()}


def spans_since(before: dict) -> dict:
    """{span: (runs, ns)} gained since `before` (`spans_now`), spans that ran."""
    out = {}
    for name, (runs, ns) in profiling.SPAN_TOTALS.items():
        d = (runs - before[name][0], ns - before[name][1])
        if d[0]:
            out[name] = d
    return out


@contextlib.contextmanager
def timed_launches():
    """CUDA events around each launch of a composed program
    (`cuda_graphs.Program.launch`) in the block: yields the list of (start,
    end) pairs."""
    launch, pairs = cuda_graphs.Program.launch, []

    def timed(program):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(program)
        end.record()
        pairs.append((start, end))

    cuda_graphs.Program.launch = timed
    try:
        yield pairs
    finally:
        cuda_graphs.Program.launch = launch


def span_report(label, gained, per, launch_ms):
    """Print each span's runs and ms a run, and the spans' sum against the
    launches' CUDA-event ms (`launch_ms`); returns {span: ms a run}."""
    total = 1e-6 * sum(ns for _, ns in gained.values())
    print(f"  {label} spans over {per}: " + ", ".join(
        f"{k} {r} x {1e-6 * ns / r:.4f} ms" for k, (r, ns) in gained.items())
        + f"; sum {total:.3f} ms against the launches' CUDA events {launch_ms:.3f} ms "
        f"({100 * total / launch_ms:.2f}%)")
    return {k: 1e-6 * ns / r for k, (r, ns) in gained.items()}


def span_solves(solver, u0, label, n=3):
    """Phase 6: n device-loop solves from u0 at the load factor 1 (their
    graphs already captured), each launch timed by CUDA events, and what
    the program's device spans say of them: each span's ms a run, a Newton
    iteration's head (every span of a Newton iteration but its CG
    iterations and its tail, over the heads run) and the spans' sum
    against the launches' time. The loop's state is the last solve's."""
    before = spans_now()
    with timed_launches() as pairs:
        for _ in range(n):
            solver._newton(u0, 1.0)
    torch.cuda.synchronize()
    gained = spans_since(before)
    launch_ms = sum(a.elapsed_time(b) for a, b in pairs)
    ms = span_report(f"{label} device loop", gained, f"{n} solves", launch_ms)
    head = 1e-6 * sum(ns for k, (_, ns) in gained.items()
                      if k not in ("pcg_iteration", "newton_tail")) / gained["freeze"][0]
    print(f"  {label} Newton iteration's head (spans): {head:.4f} ms")
    return {"head_ms": head, "span_ms": ms, "launches": len(pairs),
            "spans_over_launches": 1e-6 * sum(ns for _, ns in gained.values()) / launch_ms}


def span_steps(solver, u0, label, n=3):
    """`span_solves` for n `step_fn` calls (after one that builds the
    chunk): the step's eager set-up up to its chunk's first body (spans
    residual64, freeze, jacobi, step_refresh) a step, and the chunk's spans
    (pcg_init, pcg_control, pcg_iteration) against its launches' CUDA
    events."""
    solver.step_fn(u0, 1.0)
    torch.cuda.synchronize()
    before = spans_now()
    with timed_launches() as pairs:
        t0 = time.perf_counter()
        for _ in range(n):
            solver.step_fn(u0, 1.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    gained = spans_since(before)
    launch_ms = sum(a.elapsed_time(b) for a, b in pairs)
    chunk = {k: v for k, v in gained.items() if k.startswith("pcg_")}
    ms = span_report(f"{label} step chunk", chunk, f"{n} steps", launch_ms)
    prepare = 1e-6 * sum(ns for k, (_, ns) in gained.items() if k not in chunk) / n
    print(f"  {label} step: set-up (spans) {prepare:.4f} ms, chunk's spans "
          f"{1e-6 * sum(ns for _, ns in chunk.values()) / n:.4f} ms, host clock "
          f"{wall_ms / n:.4f} ms a step")
    return {"prepare_ms": prepare, "span_ms": ms, "step_ms": wall_ms / n}


def span_clock(device, n=64, stamps=24):
    """The span stamp's clock on this card: %globaltimer's tick (the steps
    between n successive distinct readings one thread sees; probe kernel),
    and the reading against the profiler's clock and the host's: `stamps`
    eager stamps under torch.profiler, each launched on an idle card (after
    a synchronise) and followed by a copy of its reading and 10-80 ms of a
    busy card (`torch.cuda._sleep`). Per stamp: CUPTI's start (ns) less the
    reading (the offset), CUPTI's start less the host's launch call in the
    trace (both the trace's clock) and the reading less the host's
    `time.time_ns()` before the launch; a drift of one clock against
    another is the slope of these over the readings (ppm)."""
    lib = cuda_build.load(PROBE_SOURCE, PROBE_SIGNATURES)
    out = torch.zeros(n + 1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(lib.fea_probe_globaltimer(out.data_ptr(), n, stream) == 0, "the timer probe launched")
    steps = torch.diff(out).tolist()
    table = profiling._table(device)
    readings = torch.zeros((stamps, 2), dtype=torch.int64, device=device)
    host = []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(stamps):
            torch.cuda.synchronize(device)
            host.append(time.time_ns())
            profiling.close_span(device)  # a stamp that opens nothing
            readings[i].copy_(table.open)
            torch.cuda._sleep(20_000_000 * (1 + i % 8))  # cycles: ~10-80 ms
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    corr = {(e.get("args") or {}).get("correlation"): float(e["ts"]) for e in events
            if e.get("cat") == "cuda_runtime" and e.get("name", "").startswith("cudaLaunchKernel")}
    starts = sorted((float(e["ts"]), corr.get((e.get("args") or {}).get("correlation")))
                    for e in events
                    if e.get("cat") == "kernel" and "stamp_kernel" in e.get("name", ""))
    check(len(starts) == stamps and all(c is not None for _, c in starts),
          f"the trace holds the {stamps} stamps and their launch calls")
    reading = readings[:, 1].tolist()
    series = {"offset": [1e3 * ts - r for (ts, _), r in zip(starts, reading)],
              "launch_to_start": [1e3 * (ts - call) for ts, call in starts],
              "reading_less_host": [r - h for r, h in zip(reading, host)]}
    span_ns = reading[-1] - reading[0]
    out = {"tick_ns": statistics.median(steps), "tick_min_ns": min(steps), "span_s": 1e-9 * span_ns}
    print(f"  %globaltimer: tick {statistics.median(steps)} ns (median of {n} steps; "
          f"min {min(steps)}, max {max(steps)}); {stamps} eager stamps over "
          f"{1e-9 * span_ns:.3f} s:")
    for name, v in series.items():
        rel = [1e-3 * (x - v[0]) for x in v]
        out[f"{name}_spread_us"] = max(rel) - min(rel)
        out[f"{name}_drift_ppm"] = 1e6 * (v[-1] - v[0]) / span_ns
        print(f"    {name}: spread {max(rel) - min(rel):.3f} us, drift "
              f"{out[f'{name}_drift_ppm']:.2f} ppm; each less the first (us) "
              f"{[round(x, 3) for x in rel]}")
    return out


def loop_iteration_ms(solver, u0, label):
    """Phase 6: the device loop's spans over three solves from u0
    (`span_solves`: a Newton iteration's head among them), then one PCG
    iteration of each loop, on the state the device loop's last solve left:
    the device loop's `cg` program (WHILE(active) over the CG body, as
    nested in its solve program) armed for ITERATION_RUN iterations (stop
    0, cap k + ITERATION_RUN; CUDA events around each launch, median of
    5, over the iterations a launch ran); the host loop's, a run of
    ITERATION_RUN iterations of a captured PCG chunk (its WHILE node, tol
    0) on the same frozen state and right-hand side, and the eager
    `pcg_chunk` (the reference's host-loop form) beside it (host clock
    ending in a synchronise, median of 5). The next solve resets the
    state."""
    spans = span_solves(solver, u0, label)
    loop = solver._device_loop
    st, k = loop.state, ITERATION_RUN

    def armed_cg():
        st.pcg.stop.zero_()
        st.pcg.cap.copy_(st.pcg.k + k)
        st.pcg.ok.fill_(True)
        st.pcg.active.fill_(True)
        loop.replay("cg")

    k0 = int(st.pcg.k)
    launch_ms = cuda_ms(armed_cg, n=5)
    per_launch = (int(st.pcg.k) - k0) / 6  # cuda_ms: a warm-up and 5 timed launches
    check(per_launch > 0, f"{label}: the device loop's cg program ran CG iterations")
    dev_ms = launch_ms / per_launch
    free32 = solver.bc.free_mask.to(torch.float32)
    free32_T = free32.T.contiguous()

    def matvec(v):
        return _mixed_matvec(solver._soa, st.frozen, free32_T, v)

    precond = _mixed_precond(st.inv_blocks, free32, solver._coarse)
    chunk = DevicePCGChunk(matvec, precond, st.b.shape, torch.float32, st.b.device)
    host, eager = [], []
    for _ in range(6):
        chunk.start(st.b, 0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = chunk.run(k).k
        host.append((time.perf_counter() - t0) * 1e3 / max(done, 1))
        pst = pcg_init(matvec, st.b, precond, tol=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pst = pcg_chunk(matvec, pst, precond, maxiter=k)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3 / max(pst.k, 1))
    host_ms, eager_ms = statistics.median(host[1:]), statistics.median(eager[1:])
    split = cg_iteration_split(solver, matvec, precond, dev_ms, label)
    head_ms = spans["head_ms"]
    print(f"  {label} PCG iteration: device loop {dev_ms:.4f} ms (replayed, {per_launch:g} a "
          f"launch of its cg program; its span in the solves "
          f"{spans['span_ms']['pcg_iteration']:.4f} ms), host "
          f"loop {host_ms:.4f} ms (a PCG chunk's run of {k}, replayed, one fetch), eager "
          f"pcg_chunk {eager_ms:.4f} ms; device loop head (u += x, freeze, residual, forcing, "
          f"block-Jacobi, pcg_init; spans) {head_ms:.4f} ms")
    return {"pcg_iteration_ms_device_loop": dev_ms, "pcg_iteration_ms_host_loop": host_ms,
            "pcg_iteration_ms_eager": eager_ms, "head_ms_device_loop": head_ms,
            "spans_device_loop": spans, "pcg_iteration_split_ms": split}


def graph_ms(fn, n=10):
    """Device time of `fn` as a replayed body runs it: `fn` warmed up on a
    side stream, captured into a CUDA graph of its own, and the graph's
    replays timed with CUDA events (median of n). Its nodes run back to
    back, as inside the device loop's graphs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    ms = cuda_ms(g.replay, n)
    del g
    return ms


def cg_iteration_split(solver, matvec, precond, iteration_ms, label):
    """Where a replayed PCG iteration's device time goes: its pieces on the
    device loop's state, each captured and replayed alone (`graph_ms`): one
    CG step (`device_pcg_step`, the `cg` body without its WHILE node), the
    masked matvec (gather, B1 or B6, scatter; on a 5-tet box also B6 and
    the nodal sum alone), the preconditioner, its
    block-Jacobi and coarse parts, and the coarse part's restrict, dense
    gemv and prolong. Derived, not timed: the replayed iteration less the
    step (the WHILE node's share and a graph's own start; it has come out
    negative, the step alone slower than inside `cg`) and the step's dots,
    axpys and flags (the step less the matvec and the preconditioner). The
    step's replays advance the state's CG; the next solve resets it."""
    st = solver._device_loop.state
    free32 = solver.bc.free_mask.to(torch.float32)
    coarse = solver._coarse
    r = st.pcg.r.clone()
    rc = coarse.restrict(r)
    xc = coarse.coarse_solve(rc)
    # an f32 copy of the stored inverse, made here only: the product the
    # port ran before the bf16 storage, timed beside it
    acinv32, rc32 = coarse.acinv.float(), rc.reshape(-1).clone()
    dim, stored = coarse.acinv.shape[0], str(coarse.acinv.dtype).removeprefix("torch.")
    pieces = {
        "masked matvec": lambda: matvec(st.pcg.p),
        "preconditioner": lambda: precond(r),
        "block-Jacobi": lambda: apply_block_jacobi(st.inv_blocks, free32, r),
        "coarse apply": lambda: coarse.apply(r),
        "coarse restrict": lambda: coarse.restrict(r),
        f"coarse gemv ({dim}^2, {stored})": lambda: coarse.coarse_solve(rc),
        f"coarse gemv ({dim}^2, f32 copy)": lambda: acinv32 @ rc32,
        "coarse prolong": lambda: coarse.prolong(xc),
    }
    p = solver._soa
    if p.structure is None:  # the unstructured matvec's two kernels
        q, npe, gradN, dV = ek.flat_tables(p)
        rows, v = ek.flatten_state(st.frozen), st.pcg.p.T.contiguous()
        kv = ek.elem_apply(v, p.conn32, gradN, dV, *rows, npe=npe, q=q).view(3, -1)
        pieces["B6 (its gather inside)"] = lambda: ek.elem_apply(v, p.conn32, gradN, dV, *rows,
                                                                npe=npe, q=q)
        pieces["nodal sum"] = lambda: ek.nodal_sum(kv, p.buckets)
    out = {name: graph_ms(fn) for name, fn in pieces.items()}
    st.pcg.stop.zero_()
    st.pcg.cap.fill_(2**62)
    st.pcg.ok.fill_(True)
    out["cg step"] = graph_ms(lambda: device_pcg_step(st.pcg, matvec, precond))
    out["iteration less cg step (derived)"] = iteration_ms - out["cg step"]
    out["dots, axpys, flags (derived)"] = (out["cg step"] - out["masked matvec"]
                                           - out["preconditioner"])
    del acinv32
    print(f"  {label} replayed PCG iteration {iteration_ms:.4f} ms, its pieces each captured "
          f"alone (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    for what, dtype in ((stored, coarse.acinv.dtype), ("f32 copy", torch.float32)):
        bound_ms = 1e3 * dim * dim * dtype.itemsize / HBM_BYTES_S  # the inverse, read once
        ms = out[f"coarse gemv ({dim}^2, {what})"]
        out[f"coarse gemv bound ({what})"] = bound_ms
        print(f"  {label} coarse gemv, inverse {what}: {ms:.4f} ms against its bytes bound "
              f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.0f}% of bound)")
    return out


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
    """A mixed solve on the host loop with its f64 residual as the plain
    pass (resid_df False) and as the fused kernel, in turns on one solver
    and one card (rounds of plain, fused, fused, plain): seconds per Newton
    step of each, and their medians, then the solver's own route again.
    (The device loop fixes its residual when it is built, and refuses to
    solve after a change.)"""
    per_step, route = {False: [], True: []}, solver._resid_df
    for fused in (False, True, True, False) * rounds:
        solver._resid_df = fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ok, rec = solver._newton_mixed_host(u0, 1.0)
        torch.cuda.synchronize()
        check(ok, f"{label} solve converged")
        per_step[fused].append((time.perf_counter() - t0) / rec.newton_iters)
    solver._resid_df = route
    print(f"  {label} host loop s/step, f64 residual plain: {per_step[False]}, "
          f"fused: {per_step[True]}; "
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
    lib_ms, lib = {}, {}
    for tag, data, xv in (("f64", K.data, x), ("f32", K.data.float(), x.float())):
        try:
            with warnings.catch_warnings():  # torch marks BSR tensors as beta
                warnings.simplefilter("ignore", UserWarning)
                A = torch.sparse_bsr_tensor(st.indptr, st.indices, data, size=(3 * N, 3 * N))
            xc = xv.reshape(3 * N, 1)
            y_k = calls[f"bcsr_spmv/{tag}"][0]()
            lib_err = rel_err((A @ xc).reshape(N, 3), y_k)[1]
            lib_ms[tag] = cuda_ms(lambda A=A, xc=xc: A @ xc)
            lib[tag] = f"{lib_ms[tag]:9.4f} ms (rel diff to the kernel {lib_err:.2e})"
        except (RuntimeError, NotImplementedError) as exc:  # a yardstick, not a path of the port
            lib_ms[tag], lib[tag] = None, f"refused by torch on this card: {str(exc).splitlines()[0]}"
    table["bcsr_spmv"] = dict(bound_ms=b_ms, bound_by=b_by, ms=ms, device_ms=device_ms,
                              plain_ms=plain_ms, max_abs_err=errs["bcsr_spmv/f64"][0],
                              library_ms=lib_ms["f64"], library_ms_f32=lib_ms["f32"])
    print(f"  {'bcsr_spmv/f64':24s} kernel {ms:9.4f} ms   queued {device_ms:9.4f} ms   bound "
          f"{b_ms:8.4f} ms ({nbytes(*inputs, y)} B, {b_by}, {100 * b_ms / ms:5.1f}% / "
          f"{100 * b_ms / device_ms:5.1f}% of it)   plain {plain_ms:9.4f} ms   host "
          f"{host_us(kern):6.1f} us/launch")
    print(f"  {'bcsr_spmv/f32':24s} kernel {cuda_ms(calls['bcsr_spmv/f32'][0]):9.4f} ms")
    for tag in ("f64", "f32"):
        print(f"  cuSPARSE BSR product (torch.sparse_bsr_tensor @ x, {tag}): {lib[tag]}")
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
    # the same iteration inside a run of 50, as a solve takes them (host
    # clock): eager (`pcg_chunk`) and a captured PCG chunk's run (its WHILE
    # node; the solver's route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = pcg_chunk(matvec, pcg_state, precond, maxiter=50).k - pcg_state.k
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / max(done, 1)
    chunk = DevicePCGChunk(matvec, precond, x.shape, x.dtype, x.device)
    graph = []
    for _ in range(3):
        chunk.start(bc.project(x), 1e-30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = chunk.run(50).k
        graph.append(1e3 * (time.perf_counter() - t0) / max(k, 1))
    print(f"  one PCG iteration within a run of {done}: eager {eager_ms:.4f} ms, a captured "
          f"chunk's {statistics.median(graph):.4f} ms (median of 3, one fetch a run; capture "
          f"{chunk.capture_s:.3f} s)")


def host_norms(build_cpu, material, bc_fn, us, f_ext, scale):
    """|R| of each u of `us` at `scale`, recomputed by the plain f64 element
    pass on the host CPU. `build_cpu()` builds the mesh on the CPU,
    `bc_fn(mesh)` its BCs; f_ext lies on any device (None: no load)."""
    mesh = build_cpu()
    f = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64) if f_ext is None else f_ext.cpu()
    p64 = soa.SoAProblem.build(mesh, torch.float64)
    bc = bc_fn(mesh)
    return [float(_residual_soa_fn(u.cpu(), scale, p64, material, bc, f)[1]) for u in us]


def host_reduction(build_cpu, material, bc_fn, u, f_ext, scale, r0):
    """(|R|, |R| / r0) of u on the host CPU (`host_norms`), over the
    increment's first residual r0."""
    r = host_norms(build_cpu, material, bc_fn, [u], f_ext, scale)[0]
    return r, r / r0


def matfree_full_width(device, card):
    """(a) bench.py's own f64 mode, the matrix-free path, at full width."""
    n, n_dof = FULL["matfree"]
    mat = NeoHookean(1.0, 0.6)
    t0 = time.perf_counter()
    mesh = box_mesh_kuhn(n, n, n, element_type="tet10", device=device)
    bc = bench_bc(mesh)
    check(mesh.n_dof == n_dof, f"matfree full width is {n_dof} DOF, got {mesh.n_dof}")
    u0 = bench_start(mesh, bc)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    solver = NewtonSolver(mesh, mat, bc, options=SolverOptions(**MATFREE))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t1
    check(solver.bcsr is None, "the matrix-free path builds no BCSR structure")
    print(f"matfree n={n}: {mesh.n_nodes} nodes, {mesh.n_elements} tets, {mesh.n_dof} DOF; mesh "
          f"{t_mesh:.2f} s, solver setup {t_setup:.2f} s")
    f64_solve = f64_solves("matfree", solver, u0, ("warm-up", "timed 0", "timed 1", "timed 2"))
    runs = f64_solve["runs"]
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory: {peak} B ({peak / 2**30:.2f} GiB)")
    ua, reca, _ = runs[0]
    check(bool(torch.isfinite(ua).all()) and tuple(ua.shape) == (mesh.n_nodes, 3), "finite u [N, 3]")
    r_cpu, red_cpu = host_reduction(
        lambda: box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu"), mat, bench_bc, ua,
        None, 1.0, reca.residual_norms[0])
    print(f"host CPU f64 residual of the converged u: {r_cpu:.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, "host-recomputed residual reduction <= 1e-6")
    conn, geom, scatter, free = mesh.conn, solver.geom, solver.scatter, bc.free_mask
    state, _ = TangentState.freeze(u0, conn, geom, mat)
    v = spmv_x(mesh.n_nodes, device)

    def matvec(x):  # the masked product of the route's chunk
        xm = x * free
        return apply_tangent(state, xm, conn, geom, mat, scatter) * free + (x - xm)

    passes = {
        "TangentState.freeze": lambda: TangentState.freeze(u0, conn, geom, mat),
        "scattered element_diag_blocks": lambda: scatter(element_diag_blocks(u0[conn], geom, mat)),
        "masked apply_tangent matvec": lambda: matvec(v),
        "f64 residual (_residual_fn)": lambda: solver._residual(u0, 1.0),
    }
    pass_ms = {name: cuda_ms(fn) for name, fn in passes.items()}
    for name, ms in pass_ms.items():
        print(f"  pass {name:30s} {ms:9.4f} ms")
    # the product's least time: its inputs read once, its output written once
    b = scatter.buckets
    mv_bytes = nbytes(v, conn, geom.gradN, geom.detJxW, state.F, state.S, *state.mat_state, free,
                      *b.idx, *b.mask, b.inv, matvec(v))
    mv_bound = 1e3 * mv_bytes / HBM_BYTES_S
    print(f"  masked apply_tangent matvec: {mv_bytes} B once each, bound {mv_bound:.4f} ms "
          f"(bytes), plain PyTorch at {100 * mv_bound / pass_ms['masked apply_tangent matvec']:.1f}%"
          f" of it; PCG {sum(reca.pcg_iters)} iterations, "
          f"{1e3 * runs[1][2] / sum(reca.pcg_iters):.3f} ms per iteration over a timed solve")
    summary = {
        "path": "matfree", "n_dof": mesh.n_dof, "newton_iters": reca.newton_iters,
        "pcg_iters": reca.pcg_iters, "residual_reduction": reca.residual_norms[-1]
        / reca.residual_norms[0], "host_reduction": red_cpu,
        "s_per_step": [dt / r.newton_iters for _, r, dt in runs[1:]],
        "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup, "peak_bytes": peak,
        "pass_ms": pass_ms, "chunk_fetches_per_solve": f64_solve["fetches"],
        "chunk_capture_s": f64_solve["capture_s"], "eager_chunk": f64_solve["eager"], "card": card,
    }
    print("slice: " + json.dumps(summary))


def direct_solve(label, mesh, material, bc, f_ext, opts, build_cpu, bc_fn):
    """(b) one dense direct solve and a repeat: Newton counts, the
    reduction (also recomputed on the host CPU), the assembly and Cholesky
    ms at the converged u, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solver = NewtonSolver(mesh, material, bc, f_ext, options=opts)
    check(solver.bcsr is not None, "the direct path sums through the BCSR slot buckets")
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0))
    (res, dt), (res2, dt2) = runs
    peak = torch.cuda.max_memory_allocated()
    last = res.history[-1]
    red = last.residual_norms[-1] / last.residual_norms[0]
    steps = [(r.load_factor, r.newton_iters) for r in res.history]
    print(f"{label}: {mesh.n_dof} DOF, dense K {(mesh.n_dof ** 2) * 8 / 1e9:.2f} GB; solve "
          f"{dt:.4f} s and {dt2:.4f} s, (load factor, newton) {steps}, reduction {red:.3e}")
    check(res.converged, f"{label} converged")
    check(torch.equal(res.u, res2.u) and steps == [(r.load_factor, r.newton_iters)
                                                   for r in res2.history],
          f"{label}: two solves bitwise equal")
    r_cpu, red_cpu = host_reduction(build_cpu, material, bc_fn, res.u, f_ext, 1.0,
                                    last.residual_norms[0])
    print(f"  host CPU f64 residual of the converged u: {r_cpu:.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-8, f"{label} host-recomputed reduction <= 1e-8")
    args = (res.u, mesh.conn, solver.geom, material, solver.bcsr, solver.scatter)
    K, f_int = assemble_dense(*args)
    A, b = mask_dense_system(K, bc.project(-f_int), bc.free_mask)
    del K
    ms = {"assemble_dense": cuda_ms(lambda: assemble_dense(*args)),
          "dense_cholesky_solve": cuda_ms(lambda: dense_cholesky_solve(A, b))}
    rate = mesh.n_dof ** 3 / 3.0 / (ms["dense_cholesky_solve"] * 1e-3)
    print(f"  assemble_dense {ms['assemble_dense']:.4f} ms, dense_cholesky_solve "
          f"{ms['dense_cholesky_solve']:.4f} ms (median of 10; n^3/3 FLOP of the factor at "
          f"{rate / 1e12:.2f} TFLOP/s f64), peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    return {"path": label, "n_dof": mesh.n_dof, "newton": [n for _, n in steps],
            "load_factors": [lf for lf, _ in steps], "reduction": red, "host_reduction": red_cpu,
            "solve_s": [dt, dt2], "ms": ms, "peak_bytes": peak}


def direct_runs(device, card):
    """(b) tasks/uniaxial_tet4.json at its own size, then config 2's
    compression of the 5-tet TET10 box n=8, by the dense direct solve."""
    path = REPO / "tasks" / "uniaxial_tet4.json"
    task, cpu_task = load_task(path, device=device), load_task(path, device="cpu")
    uni = direct_solve("direct uniaxial_tet4", task.mesh, task.material, task.build_bc(),
                       task.build_forces(), task.solver, lambda: cpu_task.mesh,
                       lambda _: cpu_task.build_bc())
    check(uni["newton"] == REFERENCE_TASK_NEWTON["uniaxial_tet4.json"],
          "uniaxial_tet4: the reference's Newton count")
    n, n_dof = DIRECT_N

    def bc_fn(m):
        return DirichletBuilder(m).fix("zmin").prescribe("zmax", "z", -0.2).build()

    mesh = box_mesh(n, n, n, element_type="tet10", device=device)
    check(mesh.n_dof == n_dof, f"the direct box is {n_dof} DOF, got {mesh.n_dof}")
    box = direct_solve(f"direct 5-tet TET10 n={n}", mesh, NeoHookean(1.0, 0.6), bc_fn(mesh), None,
                       SolverOptions(**DIRECT),
                       lambda: box_mesh(n, n, n, element_type="tet10", device="cpu"), bc_fn)
    for out in (uni, box):
        print("slice: " + json.dumps({**out, "card": card}))


def module_cli(*args, timeout=600):
    """`python -m fea_large_tpu_torch ARGS` from the repository's root on
    the card (FEA_PLATFORM unset): the finished process."""
    env = {k: v for k, v in os.environ.items() if k != "FEA_PLATFORM"}
    return subprocess.run([sys.executable, "-m", "fea_large_tpu_torch", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def cli_runs(device, card):
    """(c) `run` on the seven single-device task files, all started
    together; the mixed Kuhn task against an f64 solve of the same file;
    one `info`, then one `bench --reps 3` alone."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        t0 = time.perf_counter()

        def run(name):
            return module_cli("run", f"tasks/{name}", "--out", f"{tmp}/{name}")

        with ThreadPoolExecutor(len(SINGLE_DEVICE_TASKS) + 1) as pool:
            info = pool.submit(module_cli, "info", "tasks/pressure_tet10.json")
            procs = dict(zip(SINGLE_DEVICE_TASKS, pool.map(run, SINGLE_DEVICE_TASKS)))
            info = info.result()
        print(f"seven `run`s at once: {time.perf_counter() - t0:.1f} s")
        for name, proc in procs.items():
            check(proc.returncode == 0, f"run {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            print(f"  {name}: " + " | ".join(proc.stdout.strip().splitlines()[-2:]))
            stem, out = name.split(".")[0], pathlib.Path(tmp) / name
            conv = json.loads((out / f"{stem}_convergence.json").read_text())
            check(conv["converged"], f"run {name} converged")
            for ext in ("_checkpoint.npz", "_final.npz", "_deformed.vtk"):
                check((out / f"{stem}{ext}").exists(), f"run {name} wrote {stem}{ext}")
            check("von_mises" in (out / f"{stem}_deformed.vtk").read_text(),
                  f"run {name}: the vtk holds von Mises")
            newton = [step["newton_iters"] for step in conv["steps"]]
            if name in REFERENCE_TASK_NEWTON:
                check(newton == REFERENCE_TASK_NEWTON[name],
                      f"run {name}: Newton counts {newton}, reference {REFERENCE_TASK_NEWTON[name]}")
        check(info.returncode == 0 and json.loads(info.stdout)["n_dof"] == 1995,
              f"info: exit {info.returncode}\n{info.stderr[-2000:]}")
        print(f"info tasks/pressure_tet10.json: {json.dumps(json.loads(info.stdout))}")
        # the mixed Kuhn task against an f64 solve of the same file
        name = "block_compression_kuhn.json"
        u = load_checkpoint(pathlib.Path(tmp) / name / "block_compression_kuhn_final.npz")["u"]
    task = load_task(REPO / "tasks" / name, device=device)
    f64 = NewtonSolver(task.mesh, task.material, task.build_bc(), task.build_forces(),
                       SolverOptions(linear="pcg_bcsr", precision="f64", n_steps=task.solver.n_steps,
                                     forcing="ew", newton_rtol=1e-10, pcg_tol=1e-12)).solve()
    check(f64.converged, "the f64 solve of the Kuhn task converged")
    u64 = f64.u.cpu().numpy()
    err = float(np.abs(u - u64).max() / np.abs(u64).max())
    print(f"  {name} (mixed, device loop) against its f64 solve: max |du| / max |u| {err:.3e} "
          f"(bound {MIXED_TASK_BOUND})")
    check(err <= MIXED_TASK_BOUND, "the mixed Kuhn task agrees with its f64 solve")
    bench = module_cli("bench", f"tasks/{name}", "--reps", "3")
    check(bench.returncode == 0, f"bench: exit {bench.returncode}\n{bench.stderr[-2000:]}")
    line = json.loads(bench.stdout.strip().splitlines()[-1])
    check(line["newton_steps"] > 0 and len(line["reps"]) == 3, "bench printed its JSON line")
    print(f"bench tasks/{name} --reps 3 ({card}): " + json.dumps(line))


def phase_f64_cli(device, card):
    print(f"== phase 7: f64 matrix-free, direct and CLI paths ({card})")
    t0 = time.perf_counter()
    matfree_full_width(device, card)
    print(f"phase 7a: {time.perf_counter() - t0:.1f} s")
    direct_runs(device, card)
    print(f"phase 7b: {time.perf_counter() - t0:.1f} s")
    cli_runs(device, card)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")

def solve_runs(label, run, timed=2):
    """A warm-up and `timed` timed solves of `run()` -> (u, ok, record):
    each converged to a reduction <= 1e-6, all bitwise equal in u with
    identical PCG lists and residual norms. Returns [(u, record, s)]."""
    runs = []
    for rep in ["warm-up"] + [f"timed {i}" for i in range(timed)]:
        t0 = time.perf_counter()
        u, ok, rec = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        red = rec.residual_norms[-1] / rec.residual_norms[0]
        print(f"  {label} {rep}: {dt:.4f} s, newton {rec.newton_iters}, pcg {rec.pcg_iters} "
              f"(total {sum(rec.pcg_iters)}), |R| {rec.residual_norms[0]:.6e} -> "
              f"{rec.residual_norms[-1]:.6e} (reduction {red:.3e}), "
              f"{dt / max(rec.newton_iters, 1):.5f} s/step")
        check(ok and red <= 1e-6, f"{label} {rep} solve converged to reduction <= 1e-6")
        runs.append((u, rec, dt))
    ua, reca, _ = runs[0]
    for u, rec, _ in runs[1:]:
        check(torch.equal(ua, u), f"{label}: every solve gives bitwise-equal u")
        check(rec.pcg_iters == reca.pcg_iters and rec.residual_norms == reca.residual_norms,
              f"{label}: every solve gives identical PCG lists and residual norms")
    check(bool(torch.isfinite(ua).all()) and ua.dim() == 2 and ua.shape[1] == 3, "finite u [N, 3]")
    return runs


def host_reduction_aos(mesh_cpu, material, bc_cpu, u, scale, r0):
    """The residual of u recomputed by the plain f64 element pass of the
    f64 paths (`_residual_fn`, the one an autodiff material runs) on the
    host CPU, over the first residual r0: (|R|, reduction)."""
    solver = NewtonSolver(mesh_cpu, material, bc_cpu, options=SolverOptions(linear="pcg"))
    _, r = solver._residual(u.cpu(), scale)
    return float(r), float(r) / r0


def mixed_phase8(label, mesh, bc, opts, mesh_cpu, card):
    """(8a, 8b) a mixed solve of bench.py's problem on `mesh` with `opts`:
    setup (host and device seconds), three solves, the lattice kernels
    launched (counts set to 0 before the setup, read after the solves),
    peak memory and the host CPU recheck. Returns (solver, summary)."""
    u0 = bench_start(mesh, bc)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup = dict(solver._coarse.setup)
    print(f"{label}: setup {t_setup:.2f} s ({setup['host_s']:.2f} s host, {setup['device_s']:.2f} s "
          f"device, inverse on the {setup['invert']})")
    check(setup["invert"] == "device", f"{label}: the coarse inverse was built on the card")
    keys = [k for k in KERNELS if k.startswith("struct_")]
    in_setup = launch_counts(keys)
    runs = solve_runs(label, lambda: solver._newton(u0, 1.0))
    launches = launch_counts(keys)
    fetches, capture_s, _ = chunk_stats(solver)
    peak = torch.cuda.max_memory_allocated()
    print(f"  kernel launches (setup {in_setup}; setup + 3 solves, eager and replayed "
          f"{launches}); peak device memory {peak} B ({peak / 2**30:.2f} GiB); PCG chunk capture "
          f"{capture_s:.3f} s, host fetches of the chunks in 3 solves {fetches}")
    check(all(v > 0 for v in launches.values()), f"every lattice kernel launched on the {label} path")
    u, rec, _ = runs[0]
    # the device loop on the same setup: its graphs over this preconditioner
    dev = with_options(solver, device_loop=True)
    dev_runs = timed_solves(f"  {label} device loop (first solve with the capture)",
                            lambda: dev._newton(u0, 1.0), 2)
    ud, recd, _ = dev_runs[1]
    du = float((ud - u).abs().max() / u.abs().max())
    print(f"  {label} device loop: capture {dev._device_loop.capture_s:.3f} s, graph nodes "
          f"{dev._device_loop.graph_nodes}, fetches {dev._device_loop.last.fetches}, "
          f"{dev_runs[1][2] / recd.newton_iters:.5f} s/step; pcg {recd.pcg_iters} (host loop "
          f"{rec.pcg_iters}); u within {du:.3e} of the host loop's")
    check(recd.newton_iters == rec.newton_iters, f"{label}: the device loop's Newton count")
    check(du <= LOOP_BOUND, f"{label}: device-loop u within {LOOP_BOUND} of the host loop's")
    loop = dev._device_loop
    check(loop.last.fetches == 1, f"{label}: a device-loop solve is one fetch")
    loop_stats = {"fetches": loop.last.fetches, "graph_nodes": loop.graph_nodes,
                  "capture_s": loop.capture_s}
    del dev, loop
    r_cpu, red_cpu = host_reduction(lambda: mesh_cpu, NeoHookean(1.0, 0.6), bench_bc, u, None, 1.0,
                                    rec.residual_norms[0])
    print(f"  host CPU f64 residual of the converged u: {r_cpu:.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, f"{label}: host-recomputed residual reduction <= 1e-6")
    time_passes(newton_pcg_passes(solver, u0, NeoHookean(1.0, 0.6), soa.soa_freeze,
                                  _residual_df_fn))
    summary = {
        "path": label, "n_dof": mesh.n_dof, "newton_iters": rec.newton_iters,
        "pcg_iters": rec.pcg_iters, "host_reduction": red_cpu,
        "s_per_step": [dt / r.newton_iters for _, r, dt in runs[1:]],
        "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup, "setup": setup,
        "peak_bytes": peak, "launches": launches, "setup_launches": in_setup, "card": card,
        "device_loop": {"pcg_iters": recd.pcg_iters, "u_vs_host_loop": du,
                        "s_per_step": dev_runs[1][2] / recd.newton_iters, **loop_stats},
    }
    return solver, summary


def host_builders_phase8(solver, k0):
    """(8c) the host coarse builders at full width on the Kuhn box: the f64
    Galerkin product of the rigid-body basis over the pooled aggregates
    (modes 6, `k0` the K0 the three-level build made) against the probed
    f32 Ac of the same aggregates, and FEA_COARSE_INVERT=host against the
    device inverse of `build_coarse_space`."""
    mesh, bc, mat = solver.mesh, solver.bc, NeoHookean(1.0, 0.6)
    coords = mesh.coords_host
    agg_size = ml.default_agg_size(mesh.n_nodes, 2500, structured=True)
    pool = make_lattice_pool(mesh.structure, max(1, mesh.n_nodes // agg_size))
    agg = pool.agg_host()
    n_agg = int(agg.max()) + 1
    cnt = np.bincount(agg, minlength=n_agg).astype(float)
    cent = np.stack([np.bincount(agg, weights=coords[:, d], minlength=n_agg) / cnt
                     for d in range(3)], axis=1)
    dvec = ml._rbm_dvec(coords, agg, cent, n_agg)
    t0 = time.perf_counter()
    host = ml._host_coarse_matrix_rbm(mesh, mat.lam, mat.mu, agg, dvec, n_agg,
                                      bc.free_mask.cpu().numpy(), k0=k0)
    t_host = time.perf_counter() - t0
    dev = mesh.device
    color, Bn, d, cm, src, dst, nc = ml._probe_plan(mesh.conn_host, agg, n_agg, 6, dvec)
    state0 = soa.soa_freeze(solver._soa, mat, torch.zeros((3, mesh.n_nodes), device=dev))
    Z = ml._probe_run(solver._soa, state0, bc.free_mask.to(torch.float32),
                      torch.as_tensor(Bn, device=dev), torch.as_tensor(d, device=dev),
                      torch.as_tensor(color[agg], device=dev), cm, 6, pool)
    Ac = ml._assemble_dense_coarse(Z.reshape(-1), torch.as_tensor(src, device=dev),
                                   torch.as_tensor(dst, device=dev), nc).cpu().numpy()
    diff = float(np.abs(Ac - host).max())
    scale = float(np.abs(host).max())
    print(f"8c host Galerkin product (modes 6, {n_agg} aggregates, dim {nc}): {t_host:.2f} s on the "
          f"host (K0 reused); probed Ac vs host Ac: max |diff| {diff:.3e} = {diff / scale:.3e} of "
          f"max |Ac| (bound {HOST_AC_BOUND})")
    check(diff <= HOST_AC_BOUND * scale, "the probed coarse matrix matches the host Galerkin product")
    spaces, inverses = {}, {}
    store = ml._store_acinv

    def keep_inverse(acinv, dtype):  # each route's f32 inverse, before its storage
        inverses[route] = acinv
        return store(acinv, dtype)

    ml._store_acinv = keep_inverse
    try:
        for route in ("device", "host"):
            if route == "host":
                os.environ["FEA_COARSE_INVERT"] = "host"
            try:
                t0 = time.perf_counter()
                spaces[route] = ml.build_coarse_space(mesh, mat, bc, modes=6, soa=solver._soa)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                os.environ.pop("FEA_COARSE_INVERT", None)
            check(spaces[route].setup["invert"] == route, f"the {route} inverse route was taken")
            print(f"  build_coarse_space, inverse on the {route}: {dt:.2f} s "
                  f"({spaces[route].setup})")
            coarse_storage(f"8c {route} route", spaces[route].acinv, TWO_LEVEL_STORAGE)
            check(torch.equal(spaces[route].acinv, store(inverses[route], torch.float32)),
                  f"8c: the {route} route stores its f32 inverse by the storage rule")
    finally:
        ml._store_acinv = store
    # the f64 inverse of the same ridged Ac: how far each f32 route is from it
    A64 = torch.as_tensor(Ac, dtype=torch.float64, device=dev)
    d64 = torch.diagonal(A64)
    A64 = A64 + torch.diag((d64 <= 0).double() + 1e-8 * max(float(d64.max()), 1.0))
    eig = torch.linalg.eigvalsh(A64)
    inv64 = torch.cholesky_inverse(torch.linalg.cholesky(A64))
    inv_scale = float(inv64.abs().max())
    a, b = inverses["host"], inverses["device"]
    err = float((a - b).abs().max()) / inv_scale
    err_host = float((a.double() - inv64).abs().max()) / inv_scale
    err_dev = float((b.double() - inv64).abs().max()) / inv_scale
    print(f"  host vs device inverse (dim {a.shape[0]}): max |diff| {err:.3e} of max (the "
          f"reference test's bound at a 3^3 box: {HOST_INV_BOUND}); against the f64 inverse: host "
          f"{err_host:.3e}, device {err_dev:.3e}; condition number of the ridged Ac "
          f"{float(eig[-1] / eig[0]):.3e}")
    check(err_host <= max(HOST_INV_BOUND, 2.0 * err_dev),
          "the host inverse is as close to the f64 inverse as the device inverse")
    return {"dim": nc, "host_product_s": t_host, "ac_rel": diff / scale,
            "inverse_rel": err, "inverse_rel_f64": {"host": err_host, "device": err_dev},
            "cond": float(eig[-1] / eig[0]), "setups": {k: v.setup for k, v in spaces.items()}}


def mooney_rivlin_phase8(device, card):
    """(8d) MooneyRivlin(1.0, 0.6) through the generic tangent on the f64
    paths: the assembled BCSR path on phase 5's problem at full width (B10
    in every PCG iteration), the direct path on the uniaxial_tension
    example's box, and the matrix-free path on a Kuhn box of depth
    MR_MATFREE_N; each with a warm-up, two timed solves and the host
    CPU recheck."""
    out = {}
    n, n_dof = FULL["bcsr"]
    mesh = box_mesh(n, n, n, element_type="tet10", device=device)
    check(mesh.n_dof == n_dof, f"8d full width is {n_dof} DOF, got {mesh.n_dof}")
    bc = bench_bc(mesh)
    u0 = bench_start(mesh, bc)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = NewtonSolver(mesh, MR, bc, options=SolverOptions(**BCSR))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    runs = solve_runs("8d MR pcg_bcsr", lambda: solver._newton(u0, 1.0))
    launches = launch_counts(["bcsr_spmv"])["bcsr_spmv"]
    total_pcg = sum(sum(r.pcg_iters) for _, r, _ in runs)
    peak = torch.cuda.max_memory_allocated()
    print(f"  bcsr_spmv launches (3 solves): {launches}, PCG iterations: {total_pcg}; setup (host "
          f"BCSR build) {t_setup:.2f} s; peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
    check(launches >= total_pcg, "B10 launched at least once per PCG iteration on the MR path")
    u, rec, _ = runs[0]
    mesh_cpu = box_mesh(n, n, n, element_type="tet10", device="cpu")
    r_cpu, red_cpu = host_reduction_aos(mesh_cpu, MR, bench_bc(mesh_cpu), u, 1.0,
                                        rec.residual_norms[0])
    print(f"  host CPU f64 residual of the converged u: {r_cpu:.6e} (reduction {red_cpu:.3e})")
    check(red_cpu <= 1e-6, "8d MR pcg_bcsr: host-recomputed residual reduction <= 1e-6")
    ue = u0[mesh.conn]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = {"element_stiffness MR (generic)": cuda_ms(lambda: element_stiffness(ue, solver.geom, MR), 3)}
    es_peak = torch.cuda.max_memory_allocated() - base
    ms["element_stiffness NH (factored)"] = cuda_ms(
        lambda: element_stiffness(ue, solver.geom, NeoHookean(1.0, 0.6)))
    print(f"  element_stiffness at u0, {mesh.n_elements} TET10: generic (MR) "
          f"{ms['element_stiffness MR (generic)']:.2f} ms (median of 3; its own peak {es_peak} B), "
          f"factored (NH) {ms['element_stiffness NH (factored)']:.2f} ms (median of 10)")
    out["bcsr"] = {"path": "8d MR pcg_bcsr", "n_dof": mesh.n_dof, "newton_iters": rec.newton_iters,
                   "pcg_iters": rec.pcg_iters, "host_reduction": red_cpu,
                   "solve_s": [dt for _, _, dt in runs], "setup_s": t_setup, "peak_bytes": peak,
                   "launches": {"bcsr_spmv": launches}, "ms": ms,
                   "element_stiffness_peak_bytes": es_peak}
    del solver, mesh, bc, u0, ue
    torch.cuda.empty_cache()
    # the direct path on examples/uniaxial_tension's box (6^3 TET4, zmax +0.2)
    mesh = box_mesh(6, 6, 6, element_type="tet4", device=device)
    mesh_cpu = box_mesh(6, 6, 6, element_type="tet4", device="cpu")

    def tension(m):
        return DirichletBuilder(m).fix("zmin").prescribe("zmax", "z", 0.2).build()

    bc = tension(mesh)
    torch.cuda.reset_peak_memory_stats()
    solver = NewtonSolver(mesh, MR, bc, options=SolverOptions(linear="direct"))

    def direct():
        res = solver.solve()
        return res.u, res.converged, res.history[-1]

    runs = solve_runs("8d MR direct", direct)
    u, rec, _ = runs[0]
    peak = torch.cuda.max_memory_allocated()
    r_cpu, red_cpu = host_reduction_aos(mesh_cpu, MR, tension(mesh_cpu), u, 1.0,
                                        rec.residual_norms[0])
    print(f"  host CPU f64 residual of the converged u: {r_cpu:.6e} (reduction {red_cpu:.3e}); "
          f"peak device memory {peak} B")
    check(red_cpu <= 1e-8, "8d MR direct: host-recomputed reduction <= 1e-8")
    top = u[torch.as_tensor(mesh.node_sets["zmax"], device=device)]
    check(abs(float(top[:, 2].mean()) - 0.2) < 1e-12 and float(u[:, 0].min()) < -1e-3,
          "8d MR direct: the prescribed stretch and a lateral contraction")
    out["direct"] = {"path": "8d MR direct", "n_dof": mesh.n_dof, "newton_iters": rec.newton_iters,
                     "host_reduction": red_cpu, "solve_s": [dt for _, _, dt in runs],
                     "peak_bytes": peak}
    # the matrix-free path on a Kuhn box of depth MR_MATFREE_N
    n = MR_MATFREE_N
    mesh = box_mesh_kuhn(n, n, n, element_type="tet10", device=device)
    mesh_cpu = box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu")
    bc = bench_bc(mesh)
    u0 = bench_start(mesh, bc)
    torch.cuda.reset_peak_memory_stats()
    solver = NewtonSolver(mesh, MR, bc, options=SolverOptions(**MATFREE))
    check(solver.bcsr is None, "the matrix-free path builds no BCSR structure")
    runs = solve_runs(f"8d MR matfree Kuhn n={n}", lambda: solver._newton(u0, 1.0))
    u, rec, dt = runs[1]
    peak = torch.cuda.max_memory_allocated()
    r_cpu, red_cpu = host_reduction_aos(mesh_cpu, MR, bench_bc(mesh_cpu), u, 1.0,
                                        rec.residual_norms[0])
    print(f"  host CPU f64 residual of the converged u: {r_cpu:.6e} (reduction {red_cpu:.3e}); "
          f"peak device memory {peak} B")
    check(red_cpu <= 1e-6, "8d MR matfree: host-recomputed residual reduction <= 1e-6")
    conn, geom, scatter, free = mesh.conn, solver.geom, solver.scatter, bc.free_mask
    v = spmv_x(mesh.n_nodes, device)
    ms = {}
    for name, mat in (("MR (generic)", MR), ("NH (factored)", NeoHookean(1.0, 0.6))):
        state, _ = TangentState.freeze(u0, conn, geom, mat)
        ms[f"masked apply_tangent {name}"] = cuda_ms(
            lambda s=state, m=mat: apply_tangent(s, v * free, conn, geom, m, scatter) * free
            + v * (1 - free))
        ms[f"TangentState.freeze {name}"] = cuda_ms(lambda m=mat: TangentState.freeze(u0, conn, geom, m))
    print("  " + ", ".join(f"{k} {t:.3f} ms" for k, t in ms.items())
          + f"; {1e3 * dt / sum(rec.pcg_iters):.3f} ms per PCG iteration over a timed solve")
    out["matfree"] = {"path": f"8d MR matfree Kuhn n={n}", "n_dof": mesh.n_dof,
                      "newton_iters": rec.newton_iters, "pcg_iters": rec.pcg_iters,
                      "host_reduction": red_cpu, "solve_s": [d for _, _, d in runs],
                      "peak_bytes": peak, "ms": ms}
    return out


def examples_phase8(card):
    """(8e) `python -m fea_large_tpu_torch.examples.<name>` on the card,
    the three started together: each exits 0 and prints OK."""
    env = {k: v for k, v in os.environ.items() if k != "FEA_PLATFORM"}

    def run(name):
        return subprocess.run([sys.executable, "-m", f"fea_large_tpu_torch.examples.{name}"],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=600)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(EXAMPLES)) as pool:
        procs = dict(zip(EXAMPLES, pool.map(run, EXAMPLES)))
    print(f"8e three examples at once ({card}): {time.perf_counter() - t0:.1f} s")
    for name, proc in procs.items():
        check(proc.returncode == 0, f"example {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        print(f"  {name}: " + " | ".join(lines[:1] + lines[-3:]))
        check(lines[0].startswith("device: cuda") and lines[-1] == "OK",
              f"example {name} ran on the card and printed OK")


def phase_more(device, card, kuhn_pcg):
    """Phase 8: the three-level and 12-mode spaces, the host coarse
    builders at full width, the autodiff material on the f64 paths, and
    the examples."""
    print(f"== phase 8: three-level and 12-mode preconditioners, host coarse builders, "
          f"Mooney-Rivlin, examples ({card})")
    t0 = time.perf_counter()
    n, n_dof = FULL["kuhn"]
    mesh = box_mesh_kuhn(n, n, n, element_type="tet10", device=device)
    check(mesh.n_dof == n_dof, f"phase 8 full width is {n_dof} DOF, got {mesh.n_dof}")
    mesh_cpu = box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu")
    bc = bench_bc(mesh)
    k0 = {}
    build_k0 = ml._host_k0_csr

    def keep_k0(*args, **kw):  # the three-level build's K0, kept for 8c
        k0["K"] = build_k0(*args, **kw)
        return k0["K"]

    ml._host_k0_csr = keep_k0
    try:
        solver, three = mixed_phase8("8a three_level", mesh, bc, THREE_LEVEL, mesh_cpu, card)
    finally:
        ml._host_k0_csr = build_k0
    sp = solver._coarse
    three.update(n_agg1=sp.n_agg1, n_agg2=sp.n_agg2, level2_dim=sp.ac2inv.shape[0],
                 coarse=coarse_storage("8a three-level, level 2", sp.ac2inv, LEVEL2_STORAGE))
    beside_f32("8a three_level", three["pcg_iters"], three["device_loop"]["s_per_step"],
                three["peak_bytes"])
    print(f"  levels: n1 = {sp.n_agg1} aggregates, n2 = {sp.n_agg2}, level-2 dim "
          f"{sp.ac2inv.shape[0]}; Newton {three['newton_iters']}, PCG {three['pcg_iters']} "
          f"(phase 3, two-level modes 6: PCG {kuhn_pcg})")
    print(f"phase 8a: {time.perf_counter() - t0:.1f} s")
    host = host_builders_phase8(solver, k0.pop("K"))
    print(f"phase 8c: {time.perf_counter() - t0:.1f} s")
    del solver, sp
    torch.cuda.empty_cache()
    solver, twelve = mixed_phase8("8b two_level modes 12", mesh, bc, TWELVE_MODES, mesh_cpu, card)
    twelve.update(n_agg=solver._coarse.n_agg, coarse_dim=solver._coarse.acinv.shape[0],
                  coarse=coarse_storage("8b modes 12", solver._coarse.acinv, TWO_LEVEL_STORAGE))
    beside_f32("8b two_level modes 12", twelve["pcg_iters"], twelve["device_loop"]["s_per_step"],
                twelve["peak_bytes"])
    print(f"  coarse: {solver._coarse.n_agg} aggregates, dim {solver._coarse.acinv.shape[0]}, "
          f"probing {twelve['setup']['device_s']:.2f} s on the card; PCG {twelve['pcg_iters']} "
          f"(phase 3, modes 6: {kuhn_pcg})")
    launches = {"8a": three["launches"], "8b": twelve["launches"]}
    print(f"phase 8b: {time.perf_counter() - t0:.1f} s")
    del solver, mesh, mesh_cpu
    torch.cuda.empty_cache()
    mr = mooney_rivlin_phase8(device, card)
    launches["8d"] = mr["bcsr"]["launches"]
    print(f"phase 8d: {time.perf_counter() - t0:.1f} s")
    examples_phase8(card)
    for out in (three, twelve, host, *mr.values()):
        print("slice: " + json.dumps({**out, "card": card}))
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return launches


def group_seconds(run, wall):
    """A process group's timeline, the slowest rank's: seconds from the
    spawn to its start (interpreter, imports, arguments), to the group's
    rendezvous, to the end of its work, and the group's wall."""
    last = {k: max(r[k] for r in run.seconds) for k in ("start", "joined", "done")}
    return (f"started {last['start']:.1f} s, joined {last['joined']:.1f} s, done "
            f"{last['done']:.1f} s after the spawn, wall {wall:.1f} s")


def sharded_launches(counts, names):
    """Launches of the kernels `names` in a rank's counts (or their sum over
    the ranks, `ShardedRun.total_launches`): {"struct": ..., "elem": ...}."""
    mod = {"struct_": "struct", "elem_": "elem", "bcsr_": "bcsr"}
    return {name: counts[next(v for k, v in mod.items() if name.startswith(k))][KERNELS[name][1]]
            for name in names}


def strip_records(history):
    """Increment records (dicts) without their wall times."""
    return [{k: v for k, v in h.items() if k != "wall_time"} for h in history]


def fetch_contract(label, history, fetches, launched):
    """The reference's fetch contract on one rank's solve: one fetch per
    Newton iteration (one per residual norm recorded), per further PCG
    chunk and per restart."""
    newton = sum(len(h["residual_norms"]) for h in history)
    check(launched["newton"] == newton and
          fetches == launched["newton"] + launched["chunk"] + launched["restart"],
          f"{label}: fetches {fetches} = Newton iterations {newton} + further chunks "
          f"{launched['chunk']} + restarts {launched['restart']} ({launched})")


def sharded_programs(label, ranks, route):
    """(9a, 9b, 9e) every rank's route, the fetch contract on each of its
    solves, and the same records, fetches and programs on every rank;
    prints rank 0's fetches per Newton iteration and per solve, its graph
    nodes and capture seconds. Returns them."""
    for rank, out in enumerate(ranks):
        check(out["route"] == route, f"9 {label}: rank {rank} runs the {route} route")
        for r in out["runs"]:
            fetch_contract(f"9 {label} rank {rank}", r["history"], r["fetches"], r["launched"])
    views = [[(strip_records(r["history"]), r["fetches"], r["launched"]) for r in out["runs"]]
             for out in ranks]
    check(all(v == views[0] for v in views[1:]),
          f"9 {label}: every rank holds the same records, fetches and programs")
    out = ranks[0]
    for i, r in enumerate(out["runs"]):
        n = r["launched"]
        print(f"  {label} solve {i} ({route}): {r['fetches']} fetches = Newton {n['newton']} + "
              f"chunks {n['chunk']} + restarts {n['restart']}, "
              f"{r['fetches'] / max(n['newton'], 1):.3f} per Newton iteration")
    print(f"  {label} programs: graph nodes {out['graph_nodes']}, capture s {out['capture_s']}")
    return {"route": route, "fetches": [r["fetches"] for r in out["runs"]],
            "launched": [r["launched"] for r in out["runs"]],
            "graph_nodes": out["graph_nodes"], "capture_s": out["capture_s"]}


def single_increment(label, mesh, bc, opts, u0):
    """The single-device solve of one increment from u0 on the card:
    (u on the host, record, setup s, solve s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    u, ok, rec = solver._newton(u0, 1.0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(ok, f"{label}: the single-device solve converged")
    print(f"  {label} single device: setup {t1 - t0:.2f} s, solve {t2 - t1:.3f} s, newton "
          f"{rec.newton_iters}, pcg {rec.pcg_iters}")
    return u.cpu().numpy(), rec, t1 - t0, t2 - t1


def sharded_job(label, build, opts, device):
    """(9a, 9b) bench.py's problem at full width: the single-device solve
    of one increment from the 5% affine start on the card, and the rank
    job of the same solve, twice (the second with the collectives' host
    time). Returns (job, single-device (u, record, setup s, solve s))."""
    from fea_large_tpu_torch.dist.launch import Problem, solve_rank

    n, n_dof = SHARDED[label]
    mesh_cpu = build(n, n, n, element_type="tet10", device="cpu")
    check(mesh_cpu.n_dof == n_dof, f"9 {label} is {n_dof} DOF, got {mesh_cpu.n_dof}")
    bc_cpu = bench_bc(mesh_cpu)
    u0 = bench_start(mesh_cpu, bc_cpu).numpy()
    mesh = build(n, n, n, element_type="tet10", device=device)
    single = single_increment(label, mesh, bench_bc(mesh), opts,
                              torch.as_tensor(u0, device=device))
    del mesh
    torch.cuda.empty_cache()
    job = (solve_rank, dict(problem=Problem.of(mesh_cpu, NeoHookean(1.0, 0.6), bc_cpu),
                            options=SolverOptions(**opts), u0=u0, increment=1.0, solves=2,
                            profile=True))
    return job, single


def sharded_check(label, job, run, single, card):
    """(9a, 9b) the sharded solves (job `job` of the ranks' `run_jobs`)
    against the single-device one: the same Newton count, u within
    SHARDED_MIXED_BOUND, the PCG lists side by side, two sharded solves
    bitwise equal with identical records, the eager route and the fetch
    contract on every rank (`sharded_programs`), and every kernel of the
    path launched (counts summed over the ranks). Returns (launches, u)."""
    u_single, rec1, setup1, solve1 = single
    out = run.result[job]
    programs = sharded_programs(label, [r[job] for r in run.results], "eager")
    a, b = out["runs"]
    rec = a["history"][0]
    print(f"  {label} sharded: {out['kind']}, setup {out['setup_s']:.2f} s (rank 0), coarse "
          f"{out['n_agg']} aggregates")
    inverses = [r[job]["coarse_inverse"] for r in run.results]
    print(f"  {label} sharded coarse inverse on every rank: {inverses}, replicated "
          f"{out['memory']['static_coarse_replicated']} B a rank")
    check(all(c == {"dtype": "bfloat16", "dim": inverses[0]["dim"]} for c in inverses),
          f"9 {label}: every rank stores the coarse inverse in bf16")
    check(out["memory"]["static_coarse_replicated"] == 2 * inverses[0]["dim"] ** 2,
          f"9 {label}: the memory report counts the bf16 inverse's bytes")
    for i, r in enumerate((a, b)):
        h = r["history"][0]
        print(f"  {label} sharded solve {i}: {r['solve_s']:.3f} s, newton {h['newton_iters']}, "
              f"pcg {h['pcg_iters']} (total {sum(h['pcg_iters'])}), "
              f"{r['solve_s'] / max(h['newton_iters'], 1):.5f} s/step, |R| "
              f"{h['residual_norms'][0]:.6e} -> {h['residual_norms'][-1]:.6e}")
    print(f"  PCG side by side: single device {rec1.pcg_iters}, sharded {rec['pcg_iters']}")
    check(a["converged"] and b["converged"], f"9 {label}: the sharded solves converged")
    check(np.array_equal(a["u"], b["u"]), f"9 {label}: two sharded solves bitwise equal")
    strip = [[{k: v for k, v in h.items() if k != "wall_time"} for h in r["history"]]
             for r in (a, b)]
    check(strip[0] == strip[1], f"9 {label}: two sharded solves give identical records")
    check(rec["newton_iters"] == rec1.newton_iters, f"9 {label}: the single-device Newton count")
    err = float(np.abs(a["u"] - u_single).max() / np.abs(u_single).max())
    print(f"  u against the single-device solve: max |du| / max |u| {err:.3e} "
          f"(bound {SHARDED_MIXED_BOUND})")
    check(np.isfinite(a["u"]).all() and a["u"].shape == u_single.shape, "finite u [N, 3]")
    check(err <= SHARDED_MIXED_BOUND, f"9 {label}: u within the mixed bound")
    coll = b["collective_s"]
    calls = b["collective_calls"]
    iters = max(sum(rec["pcg_iters"]), 1)
    print(f"  collectives of solve 1 (rank 0, host s after a device sync): hops {calls['hop']} "
          f"in {coll['hop']:.3f} s, sums {calls['sum']} in {coll['sum']:.3f} s; per PCG "
          f"iteration {(coll['hop'] + coll['sum']) / iters * 1e3:.3f} ms of "
          f"{b['solve_s'] / iters * 1e3:.3f} ms")
    launches = sharded_launches(run.total_launches(), SHARDED_KERNELS[label])
    per_rank = [sharded_launches(r, SHARDED_KERNELS[label]) for r in run.launches]
    print(f"  kernel launches, summed over the ranks: {launches}; per rank {per_rank}")
    print(f"  peak device memory of rank 0: {out['peak_bytes']} B; memory report (rank 0): "
          f"{json.dumps(out['memory'])}")
    check(all(v > 0 for v in launches.values()), f"9 {label}: every kernel of the path launched")
    summary = {
        "path": f"sharded {label}", "n_dof": SHARDED[label][1], "ranks": SHARDED_RANKS,
        "backend": run.backend, "newton_iters": rec["newton_iters"], "pcg_iters": rec["pcg_iters"],
        "single_device_pcg_iters": rec1.pcg_iters, "u_err": err,
        "s_per_step": [r["solve_s"] / r["history"][0]["newton_iters"] for r in (a, b)],
        "solve_s": [a["solve_s"], b["solve_s"]], "setup_s": out["setup_s"],
        "single_device": {"setup_s": setup1, "solve_s": solve1,
                          "s_per_step": solve1 / rec1.newton_iters},
        "collective_s": coll, "collective_calls": calls, "peak_bytes_rank0": out["peak_bytes"],
        "peak_bytes_per_rank_9ab": run.peak_bytes, "launches": launches,
        "launches_per_rank": per_rank, "programs": programs, "coarse": inverses[0],
        "card": card,
    }
    beside_f32(f"sharded {label}", rec["pcg_iters"], summary["s_per_step"], out["peak_bytes"])
    print("slice: " + json.dumps(summary))
    return launches, a["u"]


def sharded_kernel_checks(device):
    """(9a, 9b) the path's kernels at the shapes the sharded paths give
    them, against their plain versions at the phase-2 bounds: B1-B3 and B5
    on rank 0's local Kuhn box (its class grids are not cubic) and B6-B7,
    the diagonal, the nodal sum and B9 on the padded element tables of the
    rank with the most padding, built as the ranks build them."""
    from fea_large_tpu_torch.dist.partition import partition_mesh
    from fea_large_tpu_torch.dist.sharded import shard_soa
    from fea_large_tpu_torch.dist.structured import structured_partition
    from fea_large_tpu_torch.dist.structured_solver import local_box

    nh = (NeoHookean(1.0, 0.6),)
    n, _ = SHARDED["kuhn"]
    mesh = box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu")
    local = local_box(mesh, structured_partition(mesh.structure, SHARDED_RANKS), device)
    x = lattice_inputs(local)
    print(f"  9a rank 0's local box: {local.structure.cells} cells, C = {x['tb'].C}")
    calls = {k: c for k, c in lattice_calls(x, nh).items()
             if k.startswith(SHARDED_KERNELS["kuhn"])}
    errs = run_checks(calls)
    report_checks("9a shard", errs)
    n, _ = SHARDED["5tet"]
    mesh = box_mesh(n, n, n, element_type="tet10", device="cpu")
    part = partition_mesh(mesh, SHARDED_RANKS, method="slab")
    real = (part.elem_global >= 0).sum(axis=1)
    r = int(np.argmin(real))  # the rank with the most padded elements
    tables = shard_soa(mesh, part, r, device, mixed=True)
    x = element_inputs_of(tables.p32, tables.p64,
                          part.from_global(mesh.coords_host, space="local")[r])
    print(f"  9b rank {r}'s element tables: E = {x['E']} ({real[r]} real), {part.n_owned} owned "
          f"+ {part.n_halo} halo node slots")
    calls = {k: c for k, c in element_calls(x, nh).items()
             if k.startswith(SHARDED_KERNELS["5tet"])}
    errs5 = run_checks(calls)
    report_checks("9b shard", errs5)
    return {name: err for name, (err, _) in {**errs, **errs5}.items()}


def sharded_f64(device, card):
    """(9c) the structured and the generic path in f64 on a Kuhn box n=12,
    2 gloo ranks sharing the card, one increment from the 5% affine start,
    against the single-device f64 (matrix-free) solve: u within
    SHARDED_F64_BOUND, the same Newton count."""
    from fea_large_tpu_torch.dist.launch import Problem, run_jobs, run_sharded, solve_rank

    n, n_dof = SHARDED["f64"]
    mesh_cpu = box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu")
    check(mesh_cpu.n_dof == n_dof, f"9c is {n_dof} DOF")
    bc_cpu = bench_bc(mesh_cpu)
    u0 = bench_start(mesh_cpu, bc_cpu).numpy()
    mesh = box_mesh_kuhn(n, n, n, element_type="tet10", device=device)
    u_single, rec1, _, _ = single_increment("9c f64", mesh, bench_bc(mesh), SHARDED_F64,
                                            torch.as_tensor(u0, device=device))
    problem = Problem.of(mesh_cpu, NeoHookean(1.0, 0.6), bc_cpu)
    import dataclasses

    jobs = [(solve_rank, dict(problem=p, options=SolverOptions(**SHARDED_F64), u0=u0,
                              increment=1.0))
            for p in (problem, dataclasses.replace(problem, structure=None))]
    t0 = time.perf_counter()
    run = run_sharded(run_jobs, [str(device)] * 2, jobs)
    print(f"  9c: 2 ranks ({run.backend}), both paths: "
          f"{group_seconds(run, time.perf_counter() - t0)}")
    out = {}
    for res, kind in zip(run.result, ("StructuredShardedSolver", "ShardedNewtonSolver")):
        check(res["kind"] == kind, f"9c runs {kind}")
        r = res["runs"][0]
        h = r["history"][0]
        err = float(np.abs(r["u"] - u_single).max() / np.abs(u_single).max())
        print(f"  9c {kind}: newton {h['newton_iters']} (single device {rec1.newton_iters}), "
              f"pcg {h['pcg_iters']}, solve {r['solve_s']:.3f} s, u against the single-device "
              f"f64 solve {err:.3e} (bound {SHARDED_F64_BOUND})")
        check(r["converged"] and h["newton_iters"] == rec1.newton_iters,
              f"9c {kind}: converged in the single-device Newton count")
        check(err <= SHARDED_F64_BOUND, f"9c {kind}: u within the f64 bound")
        out[kind] = {"newton_iters": h["newton_iters"], "pcg_iters": h["pcg_iters"],
                     "u_err": err, "solve_s": r["solve_s"]}
    return out


def sharded_tasks_and_tools(device, card):
    """(9d) the two 8-shard task files as 8 gloo ranks on the card through
    the library (the reference's Newton counts), the distributed example,
    `dryrun_multichip(2)`, and `python -m fea_large_tpu_torch run` of an
    8-shard task on this machine, which must exit 2 where it has fewer
    than 8 cards."""
    from fea_large_tpu_torch.dist.dryrun import dryrun_multichip
    from fea_large_tpu_torch.dist.launch import Problem, run_jobs, run_sharded, solve_rank

    jobs = []
    for name in REFERENCE_SHARDED_TASKS_BF16:
        task = load_task(REPO / "tasks" / name, device="cpu")
        check(task.partition.n_shards == 8, f"{name} asks for 8 shards")
        jobs.append((solve_rank, dict(
            problem=Problem.of(task.mesh, task.material, task.build_bc(), task.build_forces()),
            options=task.solver, partition_method=task.partition.method)))
    t0 = time.perf_counter()
    run = run_sharded(run_jobs, [str(device)] * 8, jobs)
    print(f"  9d: the two task files on 8 ranks ({run.backend}): "
          f"{group_seconds(run, time.perf_counter() - t0)}")
    for name, res in zip(REFERENCE_SHARDED_TASKS_BF16, run.result):
        r = res["runs"][0]
        got = [(h["newton_iters"], h["pcg_iters"]) for h in r["history"]]
        stored = res["coarse_inverse"]["dtype"]
        ref = (REFERENCE_SHARDED_TASKS_BF16 if stored == "bfloat16"
               else REFERENCE_SHARDED_TASKS)[name]
        print(f"  {name}: {res['kind']}, setup {res['setup_s']:.2f} s, converged "
              f"{r['converged']}, {r['solve_s']:.2f} s, coarse inverse {res['coarse_inverse']}, "
              f"(newton, pcg) per increment {got}; reference, inverse stored in {stored} {ref} "
              f"(PCG equal: {[g[1] for g in got] == [x[1] for x in ref]}; stored in bf16 "
              f"{REFERENCE_SHARDED_TASKS_BF16[name]}, in f32 {REFERENCE_SHARDED_TASKS[name]})")
        check(stored == SHARDED_TASK_STORAGE[name],
              f"9d {name}: the coarse inverse is stored in {SHARDED_TASK_STORAGE[name]}")
        check(r["converged"] and [g[0] for g in got] == [x[0] for x in ref],
              f"9d {name}: the reference's Newton counts")
    check(run.result[1]["kind"] == "StructuredShardedSolver"
          and run.result[0]["kind"] == "ShardedNewtonSolver", "9d: the factory's routes")
    # the example and the 8-shard `run` in their own processes, beside the
    # dry run
    env = {k: v for k, v in os.environ.items() if k != "FEA_PLATFORM"}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool, tempfile.TemporaryDirectory() as tmp:
        example = pool.submit(
            subprocess.run, [sys.executable, "-m",
                             "fea_large_tpu_torch.examples.distributed_compression"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        cli = pool.submit(module_cli, "run", "tasks/distributed_compression_kuhn.json", "--out",
                          tmp)
        dryrun_multichip(2, devices=[str(device)] * 2)
        print(f"  dryrun_multichip(2) on one card: {time.perf_counter() - t0:.1f} s")
        proc, cli = example.result(), cli.result()
    print(f"  the example and the 8-shard run beside it: {time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0,
          f"the distributed example: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    print("  example distributed_compression: " + " | ".join(lines[1:2] + lines[-2:]))
    check(lines[-1] == "OK", "the distributed example printed OK")
    if torch.cuda.device_count() < 8:
        msg = "ERROR: task requests 8 shards but only"
        print(f"  run tasks/distributed_compression_kuhn.json on {torch.cuda.device_count()} "
              f"card(s): exit {cli.returncode}: {cli.stdout.strip().splitlines()[-1]}")
        check(cli.returncode == 2 and msg in cli.stdout,
              "an 8-shard task on fewer cards exits 2 with the reference's message")
    else:
        check(cli.returncode == 0, "an 8-shard task on 8 cards runs")
    return sharded_launches(run.total_launches(), SHARDED_KERNELS["kuhn"] + SHARDED_KERNELS["5tet"])


def sharded_nccl(card, gloo_u):
    """(9e) 9a again with one rank per card over NCCL, bitwise equal to the
    gloo run (its sums are in the same fixed order), where there are
    SHARDED_RANKS cards."""
    from fea_large_tpu_torch.dist.launch import Problem, run_sharded, solve_rank

    cards = torch.cuda.device_count()
    if cards < SHARDED_RANKS:
        print(f"  9e: NCCL not run: {cards} card(s), {SHARDED_RANKS} needed")
        return None
    n, _ = SHARDED["kuhn"]
    mesh_cpu = box_mesh_kuhn(n, n, n, element_type="tet10", device="cpu")
    bc_cpu = bench_bc(mesh_cpu)
    u0 = bench_start(mesh_cpu, bc_cpu).numpy()
    run = run_sharded(solve_rank, [f"cuda:{i}" for i in range(SHARDED_RANKS)],
                      Problem.of(mesh_cpu, NeoHookean(1.0, 0.6), bc_cpu), SolverOptions(**KUHN),
                      "slab", u0, 1.0, 2, True)
    out = run.result
    a, b = out["runs"]
    h = a["history"][0]
    check(run.backend == "nccl", "9e runs on NCCL")
    check(all(r["coarse_inverse"]["dtype"] == "bfloat16" for r in run.results),
          "9e: every rank stores the coarse inverse in bf16")
    programs = sharded_programs("9e", run.results, "captured")
    diff = float(np.abs(a["u"] - gloo_u).max())
    print(f"  9e: {SHARDED_RANKS} ranks ({run.backend}), one per card, captured: setup "
          f"{out['setup_s']:.2f} s, newton {h['newton_iters']}, pcg {h['pcg_iters']}, solves "
          f"{a['solve_s']:.3f} s and {b['solve_s']:.3f} s ({b['solve_s'] / h['newton_iters']:.5f} "
          f"s/step; the eager host loop's {NCCL_EAGER_S_PER_STEP} s/step); peak per rank "
          f"{run.peak_bytes} B; max |u - u(gloo)| {diff:.3e}")
    check(np.array_equal(a["u"], gloo_u) and np.array_equal(a["u"], b["u"]),
          "9e: NCCL bitwise equal to the gloo run")
    beside_f32("9e", h["pcg_iters"], [r["solve_s"] / h["newton_iters"] for r in (a, b)],
                run.peak_bytes)
    return {"backend": run.backend, "setup_s": out["setup_s"],
            "solve_s": [a["solve_s"], b["solve_s"]], "pcg_iters": h["pcg_iters"],
            "s_per_step": [r["solve_s"] / h["newton_iters"] for r in (a, b)],
            "peak_bytes": run.peak_bytes, "programs": programs,
            "coarse": out["coarse_inverse"]}


def one_rank_solver(cls, mesh, bc, opts, eager):
    """A one-rank sharded solver (LocalComm on the mesh's card) and its
    setup seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = cls(mesh, NeoHookean(1.0, 0.6), bc, options=opts, eager=eager)
    torch.cuda.synchronize()
    return solver, time.perf_counter() - t0


def one_rank_solve(label, solver):
    """One `solve()` of the one-rank solver: (u global on the host, the
    records as dicts, seconds), with the fetch contract checked."""
    import dataclasses

    fetches, launched = solver.fetches, dict(solver.launched)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(res.converged, f"{label}: converged")
    history = [dataclasses.asdict(h) for h in res.history]
    fetch_contract(label, history, solver.fetches - fetches,
                   {k: v - launched[k] for k, v in solver.launched.items()})
    return solver.u_global(res.u), history, dt


def one_rank_increment(label, solver, mesh, bc, single):
    """(9f) the captured one-rank solver on 9a's (9b's) increment: from the
    5% affine start to the full load, twice, against that phase's
    single-device solve `single` (u, record, setup s, solve s): the same
    Newton count, u within SHARDED_MIXED_BOUND, the two bitwise equal, the
    fetch contract. Returns its summary (s/step of the second)."""
    u_single, rec1, _, solve1 = single
    u0 = solver.u_from_global(bench_start(mesh, bc).cpu().numpy())
    runs = []
    for _ in range(2):
        fetches, launched = solver.fetches, dict(solver.launched)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, ok, rec = solver._newton(u0, 1.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(ok, f"{label}: converged")
        fetch_contract(label, [{"residual_norms": rec.residual_norms}],
                       solver.fetches - fetches,
                       {k: v - launched[k] for k, v in solver.launched.items()})
        runs.append((solver.u_global(u), rec, dt))
    (u, rec, dt1), (u2, rec2, dt2) = runs
    err = float(np.abs(u - u_single).max() / np.abs(u_single).max())
    print(f"  {label}: newton {rec.newton_iters} (single device {rec1.newton_iters}), pcg "
          f"{rec.pcg_iters} (single device {rec1.pcg_iters}); {dt1:.4f} s and {dt2:.4f} s "
          f"({dt2 / rec.newton_iters:.5f} s/step; the single device "
          f"{solve1 / rec1.newton_iters:.5f}); u against the single device {err:.3e}")
    check(rec.newton_iters == rec1.newton_iters, f"{label}: the single-device Newton count")
    check(err <= SHARDED_MIXED_BOUND, f"{label}: u within the mixed bound")
    check(np.array_equal(u, u2) and rec.pcg_iters == rec2.pcg_iters,
          f"{label}: two captured solves bitwise equal")
    return {"newton_iters": rec.newton_iters, "pcg_iters": rec.pcg_iters, "u_err": err,
            "solve_s": [dt1, dt2], "s_per_step": dt2 / rec.newton_iters,
            "single_device_s_per_step": solve1 / rec1.newton_iters}


def sharded_one_rank(device, card, singles):
    """(9f) both sharded solvers with one rank in this process (LocalComm),
    on the captured route, at 9a's and 9b's widths: a solve() of
    ONE_RANK_STEPS increments from zero (the load factor changes inside the
    captured programs), twice, against the single-device solve (the same
    Newton counts, u within SHARDED_MIXED_BOUND of max |u|) and against the
    same solver on the eager route (bitwise: u and records), the fetch
    contract, the path's kernels replayed, s/step, graph nodes, capture
    seconds and peak memory; then 9a's (9b's) one increment from its start
    (`one_rank_increment`, against `singles[label]`, that phase's
    single-device solve). Returns the launches of the captured runs."""
    import gc

    from fea_large_tpu_torch.dist import ShardedNewtonSolver, StructuredShardedSolver

    launches, out = {}, {}
    for label, build, opts, cls in (("kuhn", box_mesh_kuhn, KUHN, StructuredShardedSolver),
                                    ("5tet", box_mesh, FIVE_TET, ShardedNewtonSolver)):
        n, n_dof = SHARDED[label]
        opts = SolverOptions(**dict(opts, n_steps=ONE_RANK_STEPS))
        mesh = build(n, n, n, element_type="tet10", device=device)
        check(mesh.n_dof == n_dof, f"9f {label} is {n_dof} DOF")
        bc = bench_bc(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=opts).solve()
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        check(single.converged, f"9f {label}: the single-device solve converged")
        u_single = single.u.cpu().numpy()
        single_newton = [h.newton_iters for h in single.history]
        del single
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        solver, setup_s = one_rank_solver(cls, mesh, bc, opts, False)
        check(solver.captured, f"9f {label}: one rank on the card takes the captured route")
        storage = coarse_storage(f"9f {label} one rank", solver.coarse.acinv, TWO_LEVEL_STORAGE)
        u1, hist1, dt1 = one_rank_solve(f"9f {label} captured", solver)
        u2, hist2, dt2 = one_rank_solve(f"9f {label} captured", solver)
        peak = torch.cuda.max_memory_allocated()
        stats = solver.program_stats()  # the fallback route too, where a solve took it
        fallbacks = solver.precond_fallbacks
        launches[label] = launch_counts(SHARDED_KERNELS[label])
        replayed = {k: cuda_graphs.REPLAYED[k] for k in SHARDED_KERNELS[label]}
        newton = [h["newton_iters"] for h in hist1]
        steps = sum(newton)
        phase = "9a" if label == "kuhn" else "9b"
        increment = one_rank_increment(f"9f {label} increment of {phase}", solver, mesh, bc,
                                       singles[label])
        del solver
        gc.collect()
        torch.cuda.empty_cache()
        eager, _ = one_rank_solver(cls, mesh, bc, opts, True)
        check(not eager.captured, f"9f {label}: eager=True runs the eager route")
        u_e, hist_e, dt_e = one_rank_solve(f"9f {label} eager", eager)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        err = float(np.abs(u1 - u_single).max() / np.abs(u_single).max())
        print(f"  9f {label}: {cls.__name__}, one rank, {n_dof} DOF, setup {setup_s:.2f} s "
              f"(capture {stats['capture_s']} s), graph nodes {stats['graph_nodes']}; newton "
              f"{newton} (single device {single_newton}), pcg {[h['pcg_iters'] for h in hist1]}; "
              f"captured solves {dt1:.3f} s and {dt2:.3f} s ({dt2 / steps:.5f} s/step), eager "
              f"{dt_e:.3f} s ({dt_e / steps:.5f} s/step), single device {t_single:.3f} s with "
              f"setup; two-level -> Jacobi fallbacks {fallbacks} in two solves; a solve "
              f"{sum(len(h['residual_norms']) for h in hist1)} Newton iterations, "
              f"{sum(sum(h['pcg_iters']) for h in hist1)} CG iterations; u against the "
              f"single device {err:.3e} (bound {SHARDED_MIXED_BOUND}); peak {peak} B; kernel "
              f"launches {launches[label]}, replayed {replayed}")
        check(np.isfinite(u1).all() and u1.shape == u_single.shape, "9f: finite u [N, 3]")
        check(newton == single_newton, f"9f {label}: the single-device Newton counts")
        check(err <= SHARDED_MIXED_BOUND, f"9f {label}: u within the mixed bound")
        check(np.array_equal(u1, u2) and strip_records(hist1) == strip_records(hist2),
              f"9f {label}: two captured solves bitwise equal")
        check(np.array_equal(u1, u_e) and strip_records(hist1) == strip_records(hist_e),
              f"9f {label}: the captured route bitwise its eager run")
        check(all(v > 0 for v in replayed.values()),
              f"9f {label}: every kernel of the path replayed by the graphs")
        out[label] = {"n_dof": n_dof, "newton_iters": newton, "single_newton_iters": single_newton,
                      "pcg_iters": [h["pcg_iters"] for h in hist1], "u_err": err,
                      "solve_s": [dt1, dt2], "s_per_step": dt2 / steps,
                      "eager_s_per_step": dt_e / steps, "setup_s": setup_s,
                      "capture_s": stats["capture_s"], "graph_nodes": stats["graph_nodes"],
                      "precond_fallbacks": fallbacks, "peak_bytes": peak,
                      "launches": launches[label], "replayed": replayed,
                      "increment": increment, "coarse": storage}
        del mesh, bc
        gc.collect()
        torch.cuda.empty_cache()
    print("slice: " + json.dumps({"path": "sharded one rank, captured (9f)", **out,
                                  "card": card}))
    return {**launches["kuhn"], **launches["5tet"]}


def phase_sharded(device, card):
    """Phase 9: the sharded paths (dist/) on one card: ranks share it over
    gloo; where there are 4 cards, (a) again over NCCL."""
    print(f"== phase 9: sharded paths, ranks sharing one card over gloo ({card})")
    t0 = time.perf_counter()
    from fea_large_tpu_torch.dist.launch import run_jobs, run_sharded

    shard_errs = sharded_kernel_checks(device)
    print(f"phase 9 kernel checks at the shards' shapes: {time.perf_counter() - t0:.1f} s")
    jobs = [sharded_job("kuhn", box_mesh_kuhn, KUHN, device),
            sharded_job("5tet", box_mesh, FIVE_TET, device)]
    print(f"phase 9a, 9b single-device solves: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    run = run_sharded(run_jobs, [str(device)] * SHARDED_RANKS, [job for job, _ in jobs])
    print(f"  9a, 9b: {SHARDED_RANKS} ranks ({run.backend}) on one card, spawn, setup and 2 "
          f"solves of each: {group_seconds(run, time.perf_counter() - t1)}; peak device memory "
          f"per rank over both: {run.peak_bytes} B")
    launches = {}
    launches["9a"], u_gloo = sharded_check("kuhn", 0, run, jobs[0][1], card)
    launches["9b"], _ = sharded_check("5tet", 1, run, jobs[1][1], card)
    singles = {"kuhn": jobs[0][1], "5tet": jobs[1][1]}
    del jobs
    print(f"phase 9b: {time.perf_counter() - t0:.1f} s")
    f64 = sharded_f64(device, card)
    print(f"phase 9c: {time.perf_counter() - t0:.1f} s")
    launches["9d"] = sharded_tasks_and_tools(device, card)
    print(f"phase 9d: {time.perf_counter() - t0:.1f} s")
    launches["9f"] = sharded_one_rank(device, card, singles)
    del singles
    print(f"phase 9f: {time.perf_counter() - t0:.1f} s")
    nccl = sharded_nccl(card, u_gloo)
    print("slice: " + json.dumps({"path": "sharded f64 and NCCL", "f64": f64, "nccl": nccl,
                                  "shard_kernel_abs_err": shard_errs, "card": card}))
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return launches


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
    lib = cuda_build.load(PROBE_SOURCE, PROBE_SIGNATURES)
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
    solver, u0 = kuhn[:2]
    loops = {"kuhn": loop_iteration_ms(solver, u0, "Kuhn"),
             "5tet": loop_iteration_ms(five_tet[0], five_tet[1], "5-tet"),
             "5tet_step": span_steps(five_tet[0], five_tet[1], "5-tet"),
             "span_clock": span_clock(solver.mesh.device)}
    print("slice: " + json.dumps({"path": "loop iterations", **loops, "card": card}))
    errs = lattice_timings(solver.mesh, table, against)
    time_passes(newton_pcg_passes(solver, u0, mat, soa.soa_freeze, _residual_df_fn))
    time_passes({"f64 residual (_residual_soa_fn)": lambda: _residual_soa_fn(
        u0, 1.0, solver._soa64, mat, solver.bc, solver.f_ext)})
    resid_df_turns(solver, u0, "Kuhn")
    solver5, u05 = five_tet[:2]
    y = element_inputs(solver5.mesh)
    calls5 = element_calls(y, (mat,))
    errs5 = run_checks(calls5)
    report_checks("5tet full", errs5)
    time_calls(calls5, y["q"] * y["E"], y["npe"], table)
    table["elem_diag"]["parts"] = diag_parts(y)
    time_passes(newton_pcg_passes(solver5, u05, mat, soa.soa_freeze, _residual_df_fn))
    time_passes({"f64 residual (_residual_soa_fn)": lambda: _residual_soa_fn(
        u05, 1.0, solver5._soa64, mat, solver5.bc, solver5.f_ext)})
    resid_df_turns(solver5, u05, "5-tet")
    for name, (err, _) in {**errs, **errs5}.items():
        table[name.split("/")[0]]["max_abs_err"] = err
    solver_b, u0b = bcsr[:2]
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
    parser.add_argument("--sharded-only", action="store_true",
                        help="phases 0, 1 and 9 (the sharded paths) only; no result line")
    args = parser.parse_args()
    t0 = time.perf_counter()
    card = phase_card()
    device = torch.device("cuda", 0)
    phase_build()
    print(f"phase 1 done at {time.perf_counter() - t0:.1f} s")
    if args.sharded_only:
        phase_sharded(device, card)
        print(f"total: {time.perf_counter() - t0:.1f} s (sharded only: no result line)")
        return
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
    step_launches = {**kuhn[4], **five_tet[4], **bcsr[3]}
    kuhn_pcg = kuhn[3]
    del kuhn, five_tet, bcsr  # phases 7 and 8 hold their own peak memory
    torch.cuda.empty_cache()
    phase_f64_cli(device, card)
    more = phase_more(device, card, kuhn_pcg)
    sharded = phase_sharded(device, card)
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        t = table[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "device_ms": t["device_ms"],
            **({"library_ms_f32": t["library_ms_f32"]} if "library_ms_f32" in t else {}),
            "launches_step": step_launches.get(name, 0),
            "launches_phase8": {p: c[name] for p, c in more.items() if name in c},
            "launches_sharded": {p: c[name] for p, c in sharded.items() if name in c},
        })
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
