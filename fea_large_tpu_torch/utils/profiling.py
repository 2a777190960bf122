"""Tracing and profiling (counterpart of `fea_large_tpu/utils/profiling.py`):

  * `PhaseTimer`: host wall-clock timers per phase, accumulated into a dict,
    that synchronise the devices of the tensors they are given before
    stopping the clock (PyTorch returns before the card finishes);
  * `trace_region`: a `torch.profiler` trace of the enclosed work (CPU and,
    where CUDA exists, the card), written as a Chrome trace;
  * the program's spans, its one way of timing its layers:
      - device spans (`stamp`, always on): each device keeps a table of
        runs and nanoseconds per span name (`SPANS`). A stamp closes the
        span open on the device and opens the next; on the card it is one
        kernel that reads `%globaltimer` (csrc/graph_kernels.cu), so it
        runs inside a captured graph as it runs eagerly, and a captured
        body that starts with one counts its runs with it. On the CPU the
        same call reads `time.perf_counter_ns()`. The table travels in the
        batched fetch each request already makes (`span_table`,
        `read_spans`), and the host adds what it read to `SPAN_TOTALS`;
      - host spans (`span`): a `torch.profiler.record_function` while the
        profiler runs, nothing otherwise;
      - set-up spans (`SETUP`, a `PhaseTimer`, always on): host seconds
        of the solver's set-up ("setup.solver", with its child
        "setup.coarse") and of its graphs' captures ("setup.capture"), each
        ending in a synchronise.

To read the span totals after a solve: `SPAN_TOTALS["pcg_iteration"]` is
[runs, nanoseconds] of every PCG iteration the process ran on any device,
as far as the fetches have read them; `SETUP.totals["setup.solver"]` is
seconds (`SETUP.counts` the count).

The reference's `compiled_cost` (XLA's cost analysis of a jitted function)
has no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict

import torch

#: the device spans, named by the work (not the route) they time:
#: freeze         the f32 tangent state (with the iterate's update, the
#:                residual gate; on a sharded rank also its block-Jacobi)
#: residual32     the f32 residual from the frozen state
#: residual64     the f64 residual (a sharded rank's head with its forcing)
#: newton_check   the Newton stop test, the records and the forcing
#: jacobi         the block-Jacobi set-up: diagonal blocks and their inverse
#: pcg_init       `device_pcg_init` (the chunk's init0 and initx)
#: pcg_iteration  one CG iteration (the device loop's cg, the chunk's step)
#: pcg_control    the chunk's arm, fin and keep
#: newton_tail    the device loop's end of a Newton iteration
#: step_refresh   a step's operand copies and its chunk's start, up to the
#:                chunk's first body
#: stiffness      the f64 element stiffness and force of the assembled path
#: assemble       the slot sums of the element blocks into BCSR values and
#:                the nodal sum of the element forces
SPANS = ("freeze", "residual32", "residual64", "newton_check", "jacobi", "pcg_init",
         "pcg_iteration", "pcg_control", "newton_tail", "step_refresh", "stiffness",
         "assemble")
_INDEX = {name: i for i, name in enumerate(SPANS)}

#: [runs, nanoseconds] of each device span, summed over the devices, as
#: the fetches have read them
SPAN_TOTALS = {name: [0, 0] for name in SPANS}


def _synchronize(tensors) -> None:
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host span for the profiler's timeline: `record_function(name)`
    while the profiler runs, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _Table:
    """One device's span table: `table` int64 [len(SPANS), 2] (runs,
    nanoseconds), `open` int64 [2] (the open span, -1 for none, and the
    clock when it opened; the CPU keeps it on the host), and the values
    the last fetch read (`seen`)."""

    def __init__(self, device: torch.device):
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a device's span table is made outside a capture: "
                               "stamp once on the device before capturing")
        self.device = device
        self.table = torch.zeros((len(SPANS), 2), dtype=torch.int64, device=device)
        self.open = torch.full((2,), -1, dtype=torch.int64, device=device)
        self.host_open = (-1, 0)
        self.seen = [0] * (2 * len(SPANS))


_TABLES: dict = {}


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _table(device) -> _Table:
    key = _key(device)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = _Table(key)
    return table


def stamp(device, name: str | None, runs: torch.Tensor | None = None, index: int = 0) -> None:
    """Close the span open on `device` and open `name` (None: none), and
    add one to runs[index] where `runs` is given. On the card: one kernel
    on the current stream (captured where the stream captures)."""
    t = _table(device)
    nxt = -1 if name is None else _INDEX[name]
    if t.device.type == "cuda":
        from fea_large_tpu_torch.ops import cuda_graphs

        cuda_graphs.stamp(t.table, t.open, nxt,
                          None if runs is None else runs.data_ptr() + index * runs.element_size())
        return
    now = time.perf_counter_ns()
    was, since = t.host_open
    if was >= 0:
        t.table[was, 0] += 1
        t.table[was, 1] += now - since
    t.host_open = (nxt, now)
    if runs is not None:
        runs[index].add_(1)


def close_span(device) -> None:
    """Close the span open on `device` (after a program's launch, and at
    the end of a warm-up: no span covers the host's time between)."""
    stamp(device, None)


def span_table(device) -> torch.Tensor:
    """`device`'s span table flattened, [runs, ns] per span: for the
    request's batched fetch, whose values go to `read_spans`."""
    return _table(device).table.view(-1)


def read_spans(device, values) -> None:
    """Add to SPAN_TOTALS what `device`'s table gained since the last
    fetch; `values` are `span_table(device)` as fetched."""
    t = _table(device)
    values = [int(v) for v in values]
    for i, name in enumerate(SPANS):
        for j in (0, 1):
            SPAN_TOTALS[name][j] += values[2 * i + j] - t.seen[2 * i + j]
    t.seen = values


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *sync):
        """Time a phase; pass tensors in `sync` whose devices to wait for
        before stopping the clock (otherwise the time is the enqueue's)."""
        t0 = time.perf_counter()
        with span(name):
            yield
        _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name]}
            for name in sorted(self.totals)
        }


#: the set-up spans: "setup.solver" (with its child "setup.coarse") and
#: "setup.capture"
SETUP = PhaseTimer()


@contextlib.contextmanager
def trace_region(out_dir):
    """Write a Chrome trace (`trace.json` under `out_dir`) of the enclosed
    work; the card's activity is in it where CUDA is available."""
    path = pathlib.Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))
