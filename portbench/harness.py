"""One run of one cell: set-up, warm-up, the measured window, the traced
requests (`--trace 1`), the check, the metrics.

Everything that belongs to one cell is found by name: the cell in
BENCHMARK.json, its configuration in the file that BENCHMARK.json gives,
its traffic mix in traffic/<traffic>.json, and each metric's reader in
metrics/<metric>.py, a module with `read(run) -> float | None` (None: it
found nothing to read, and the metric is left out of the line). A metric
split by the end-to-end metric it moves (`pcg_iters.solve`, `pcg_iters.step`)
is read by metrics/<metric>.py where that file is there, and otherwise by
the file of the name before its first dot (metrics/pcg_iters.py).

Traffic is a closed loop with one client: each request is sent when the
previous answer is on the host. A request's time runs from its start to its
answer on the host, ending in a synchronise of the card.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time

import torch

import generator
import judge
import system
import tracing

HERE = pathlib.Path(__file__).resolve().parent
#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "fea_large_tpu")


class CellError(SystemExit):
    """A run that cannot be made (no card, an unknown cell): no result."""


class Forbidden(SystemExit):
    """A run whose ranks loaded JAX or the JAX package: no result."""


class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic mix.
    `overrides` ({"mesh": {"n": 4}}, ...) change configuration groups, and
    its "traffic" entry the mix, for CPU tests at small sizes."""

    def __init__(self, root: pathlib.Path, workload: str, overrides: dict | None = None):
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise CellError(f"portbench: no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        entry = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        self.config = json.loads((root / entry["file"]).read_text())
        overrides = dict(overrides or {})
        mix = overrides.pop("traffic", {})
        for group, changes in overrides.items():
            self.config[group] = {**self.config[group], **changes}
        self.mix = json.loads((HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.mix.update(mix)
        self.kind = self.mix["request"]

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports: its end-to-end metrics, or
        with `trace` its per-layer metrics."""
        mine = [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", (self.name,))]
        if not trace:
            return mine
        moved = {m["name"] for m in mine}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def card(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise CellError("portbench: torch.cuda.is_available() is False; the benchmark runs "
                        "on a CUDA card only")
    if torch.cuda.device_count() < chips:
        raise CellError(f"portbench: the cell needs {chips} cards, {torch.cuda.device_count()} "
                        f"visible")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class Run:
    """What the metric readers read. records: one dict a request of the
    window (amplitude, seconds, ok, newton, pcg, fetches); window_s: from
    the first request's start to the last answer; trace: the traced
    requests' `tracing.Trace`, or None."""

    cell: Cell
    records: list
    window_s: float
    setup_s: float
    trace: tracing.Trace | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def completed(self) -> list:
        return [r for r in self.records if r["ok"]]


def serve(sys_, cell: Cell, amplitudes: list, seed: int, seconds: float, request=None,
          more=None):
    """The window: requests from the list, one after another, until
    `seconds` have passed (`more(elapsed)` False, where given). Returns
    (records, samples, window start, window seconds); samples are the
    answers kept for the check (a uniform sample drawn from the seed)."""
    request = request or system.REQUESTS[cell.kind]
    more = more or (lambda elapsed: elapsed < seconds)
    keep = generator.Reservoir(cell.mix["sample"], seed)
    records, samples = [], [None] * cell.mix["sample"]
    t0 = time.perf_counter()
    end = t0
    for i, amp in enumerate(amplitudes):
        scale = generator.load_factor(cell.config, amp)
        ts = time.perf_counter()
        out = request(sys_, scale)
        end = time.perf_counter()
        records.append(dict(amplitude=amp, seconds=end - ts, ok=out.ok, newton=out.newton,
                            pcg=out.pcg, fetches=out.fetches))
        slot = keep.offer(i)
        if slot is not None:
            samples[slot] = dict(index=i, scale=scale, u=out.u.clone(), r0=out.r0)
        if not more(end - t0):
            break
    return records, [s for s in samples if s is not None], t0, end - t0


def traced(sys_, cell: Cell, request, rest: list, device) -> tracing.Trace:
    """The requests of `rest` (amplitudes) after the window, the first as
    the profiler's lead-in and the others traced (`tracing.profile`)."""
    served = [lambda a=a: request(sys_, generator.load_factor(cell.config, a)) for a in rest]
    return tracing.profile(served[0], lambda: [s() for s in served[1:]], len(served) - 1,
                           device, system.graph_launches)


def reader(name: str):
    """The module metrics/<name>.py, or metrics/<part before the first dot>.py
    where the first is not there."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare(cell: Cell, device) -> "system.System":
    """The system at the cell's configuration, warmed up on the shapes its
    traffic uses (the first request builds and captures). Its `built_s`:
    the seconds nvcc took for the program's kernels, 0 where the checkout
    already held them (every run of a cell in a checkout but its first)."""
    with system.kernel_builds() as built:
        sys_ = system.System(cell.config, device)
        warm_up(sys_, cell, system.REQUESTS[cell.kind])
    sys_.built_s = built[0]
    return sys_


def warm_up(sys_, cell: Cell, request) -> None:
    for amp in generator.warmup_amplitudes(cell.mix):
        request(sys_, generator.load_factor(cell.config, amp))


@dataclasses.dataclass
class Served:
    """A window served and checked: its records, the seconds from the
    process's start to the window's (set-up) and of the window, the traced
    requests' Trace or None, the peak device memory on the fullest card,
    the card's name, the numbers the check compared ({name: (value,
    limit)}), nvcc's seconds in the set-up and, on several cards, the
    forbidden modules (`FORBIDDEN`) that any rank held at its end."""

    records: list
    setup_s: float
    window_s: float
    trace: tracing.Trace | None
    peak: int
    kind: str
    numbers: dict
    built_s: float
    forbidden: list = dataclasses.field(default_factory=list)


def serve_here(cell: Cell, device, seed: int, seconds: float, trace: bool,
               t_start: float) -> Served:
    """The cell on one device in this process."""
    on_card = device.type == "cuda"
    sys_ = prepare(cell, device)
    request = system.REQUESTS[cell.kind]
    amplitudes = generator.amplitudes(cell.mix, seed)
    records, samples, t0, window_s = serve(sys_, cell, amplitudes, seed, seconds)
    trace_ = None
    if trace:
        rest = amplitudes[len(records):len(records) + 1 + cell.mix["trace_requests"]]
        trace_ = traced(sys_, cell, request, rest, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    coords = sys_.coords()
    built_s = sys_.built_s
    sys_.close()
    del sys_
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = judge.judge(cell.config, cell.kind, samples, coords, device)
    return Served(records, t0 - t_start, window_s, trace_, peak,
                  torch.cuda.get_device_name(device) if on_card else "cpu", numbers, built_s)


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: pathlib.Path = HERE.parent, device=None, overrides: dict | None = None) -> dict:
    """One run; returns the result line's object, with the numbers the check
    compared under "checked" (last). `device` None: the card (cards
    0..chips-1 for a cell over several), or no run. A configuration with
    `ranks` > 1 is served by the adapter for several cards (sharded.py);
    raises `Forbidden` where a rank loaded JAX or the JAX package (this
    process's own modules are run.py's to look at, last)."""
    cell = Cell(root, workload, overrides)
    device = card(cell.workload["chips"]) if device is None else torch.device(device)
    if cell.config.get("ranks", 1) > 1:
        import sharded

        (done,) = sharded.serve(cell, device, [seed], seconds, trace, t_start)
        if done.forbidden:
            raise Forbidden(f"portbench: a rank loaded {', '.join(done.forbidden)}")
    else:
        done = serve_here(cell, device, seed, seconds, trace, t_start)
    records, numbers = done.records, done.numbers
    failed = sum(not r["ok"] for r in records)
    correct = bool(records) and failed == 0 and judge.within(numbers)
    result_run = Run(cell, records, done.window_s, done.setup_s, done.trace)
    metrics = {}
    for entry in cell.metrics(trace):
        value = reader(entry["name"]).read(result_run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": done.kind,
           "count": cell.workload["chips"], "memory_peak_bytes": done.peak}
    if done.trace is not None:
        dev["busy_s"], dev["window_s"] = done.trace.busy_s, done.trace.window_s
    out = {"correct": correct, "attempted": len(records), "failed": failed, "metrics": metrics,
           "device": dev}
    if done.trace is not None:
        out["breakdown"] = done.trace.breakdown()
    # the run that built the kernels, whose setup_s holds nvcc, marked
    out["setup_built_kernels_s"] = done.built_s
    out["checked"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    out["checked"]["failed"] = {"value": failed, "limit": 0}
    return out
