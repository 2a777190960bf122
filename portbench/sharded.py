"""The adapter for a cell over several cards: the window served on
persistent ranks of the program's own `dist.launch.run_sharded`, one
process per card (cuda:0 .. ranks-1, one NCCL rank each; on the CPU, gloo
ranks), each holding its part of the sharded solver (`system.ShardedSystem`).

Every rank derives the same requests from the seed, sets the solver up
once, warms up on the mix's warm-up requests and serves the window's
requests with the others (`harness.serve`), until rank 0's clock passes
`--seconds`: between requests rank 0 tells the others whether to go on,
outside any request's time. A request runs from its start on rank 0 until
every rank has its answer (`ShardedSystem.sync`). Rank 0 takes the window's
times. With `--trace 1` every rank profiles the traced requests: the
device's busy and traced seconds are the ranks' means, the rest of the
trace (kernels, breakdown) is rank 0's. Each rank reads its peak device
memory; then every sampled answer is gathered whole on rank 0, the solver
is freed on every rank, and rank 0 checks the answers against the plain
reference (`judge.judge`) on its card. So no answer is written to disk: the
ranks return their records, rank 0's numbers and its span totals, which are
loaded into this process's registry for the readers. Last, each rank looks
for JAX and the JAX package in its own modules (`harness.forbidden_modules`),
and the run reports what any rank found (`Served.forbidden`).

`MODE` is the fault or control that the ranks plant in the program
(`control.rank_patched`); the benchmark's own runs leave it "sound". `RANK`
is the function every rank runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import statistics
import sys
import time

import torch

import generator
import harness
import judge
import system
from fea_large_tpu_torch.dist.launch import run_sharded

MODE = "sound"
#: each rank's `torch.set_num_threads` on the card (the host's part of the
#: set-up: the whole mesh, the partition, the coarse plan)
THREADS = 4


def serve(cell, device, seeds: list, seconds: float, trace: bool, t_start: float) -> list:
    """A window of `seconds` for each seed in turn on the cell's ranks, set
    up once, with the traced requests after the last (`trace`): one
    `harness.Served` a seed."""
    ranks = cell.config["ranks"]
    devices = ([f"cuda:{i}" for i in range(ranks)] if device.type == "cuda"
               else [str(device)] * ranks)
    with system.kernel_builds() as built:
        out = run_sharded(RANK, devices, cell, seeds, seconds, trace, t_start, MODE,
                          threads=THREADS if device.type == "cuda" else 1)
    first = out.result
    print("portbench: rank 0's set-up, seconds from the process's start: "
          + ", ".join(f"{k} {v:.3f}" for k, v in first["phases"].items()), file=sys.stderr)
    system.load_spans(first["spans"], first["setup"])
    forbidden = sorted({m for r in out.results for m in r["modules"]})
    peak = max(r["peak"] for r in out.results)
    trace_ = first["trace"]
    if trace_ is not None:
        trace_ = dataclasses.replace(
            trace_, busy_s=statistics.fmean(r["busy"][0] for r in out.results),
            window_s=statistics.fmean(r["busy"][1] for r in out.results))
    return [harness.Served(w["records"], w["setup_s"], w["window_s"],
                           trace_ if i == len(seeds) - 1 else None, peak, first["kind"],
                           w["numbers"], built[0], forbidden)
            for i, w in enumerate(first["windows"])]


def serve_rank(comm, cell, seeds, seconds, trace, t_start, mode) -> dict:
    """The rank function of `serve` (module docstring), with `mode` planted."""
    if mode == "sound":
        planted = contextlib.nullcontext()
    else:
        import control

        planted = control.rank_patched(mode)
    with planted:
        return _serve_rank(comm, cell, seeds, seconds, trace, t_start)


def _serve_rank(comm, cell, seeds, seconds, trace, t_start) -> dict:
    phases = {"rank_started": time.perf_counter() - t_start}
    request = system.SHARDED_REQUESTS[cell.kind]
    sys_ = system.ShardedSystem(cell.config, comm)
    phases["solver_built"] = time.perf_counter() - t_start
    phases["solver_setup"] = sys_.setup_s  # a duration, ending at solver_built
    harness.warm_up(sys_, cell, request)
    phases["warmed_up"] = time.perf_counter() - t_start
    windows, rest = [], []
    for seed in seeds:
        amplitudes = generator.amplitudes(cell.mix, seed)
        sys_.sync()  # the ranks open the window together
        records, samples, t0, window_s = harness.serve(
            sys_, cell, amplitudes, seed, seconds, request,
            more=lambda elapsed: sys_.carry_on(elapsed < seconds))
        windows.append(dict(records=records, setup_s=t0 - t_start, window_s=window_s,
                            samples=samples))
        rest = amplitudes[len(records):len(records) + 1 + cell.mix["trace_requests"]]
    trace_ = harness.traced(sys_, cell, request, rest, comm.device) if trace else None
    on_card = comm.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(comm.device) if on_card else 0
    for w in windows:
        w["samples"] = [dict(s, u=sys_.u_global(s["u"])) for s in w["samples"]]
    spans, setup = sys_.spans()
    coords = sys_.coords()
    sys_.close()
    del sys_
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    busy = None if trace_ is None else (trace_.busy_s, trace_.window_s)
    if comm.rank != 0:
        return {"peak": peak, "busy": busy, "modules": harness.forbidden_modules()}
    for w in windows:
        w["numbers"] = judge.judge(cell.config, cell.kind, w.pop("samples"), coords, comm.device)
    return {"peak": peak, "busy": busy, "windows": windows, "trace": trace_, "spans": spans,
            "setup": setup, "kind": torch.cuda.get_device_name(comm.device) if on_card else "cpu",
            "phases": phases, "modules": harness.forbidden_modules()}


RANK = serve_rank
