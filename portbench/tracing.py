"""The traced part of a `--trace 1` run: a few requests after the window
under torch.profiler (CPU and CUDA activity), reduced to what the per-layer
readers need.

The trace is written to a file under TMPDIR, read back and deleted. Its
window is the span "portbench.window" that the harness opens around the
requests. The profiler records each kernel node of a composed CUDA graph
(nested WHILE and IF nodes) once a launch, not each run of it, so a graph
launch's device interval is taken from CUDA events around the launch
(`system.graph_launches`): it starts at the first kernel the trace records
for that launch (the kernels of one launch share its cudaGraphLaunch's
correlation id) and lasts as long as the events say (where a launch has no
recorded kernel, every launch's time is added to the busy time unplaced).
Busy is the union of those intervals and of every other device activity
(kernels, copies, sets), clipped to the window. A kernel's calls
(`Trace.calls`, what the rooflines read) are the records the trace holds
under the graph launches, each the device time of one run; eager kernels of
the same name are left out. The idle gaps between activities are named by
the innermost host-side event that covers each gap's middle.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
#: entries of each list of the breakdown
TOP = 10
#: the breakdown's entry for the composed CUDA graphs' device time
GRAPHS = "CUDA graph launches (device loop, PCG chunk; CUDA events)"


@dataclasses.dataclass
class Trace:
    """busy_s, window_s: seconds; kernels: {name: [seconds of each
    recorded call]}, graph kernels included; in_graphs: the names of the
    kernels recorded under the window's graph launches; ops: {name: seconds} of the
    device's time in the window, each kernel outside the graphs by name and
    the graph launches as one entry (GRAPHS); gaps: the TOP longest idle
    gaps, [(seconds, what the host was doing)] longest first; requests: the
    requests traced."""

    busy_s: float
    window_s: float
    kernels: dict
    in_graphs: set
    ops: dict
    gaps: list
    requests: int

    def calls(self, match) -> dict:
        """{name: seconds of each recorded call} of the kernels recorded
        under the graph launches whose name `match` accepts."""
        return {name: secs for name, secs in self.kernels.items()
                if match(name) and name in self.in_graphs}

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda x: -x[1])
        return {"device_ops": [[n, s] for n, s in ops[:TOP]],
                "idle_gaps": [[what, s] for s, what in self.gaps]}


def _union(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def _gaps(intervals, lo, hi):
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def _name_gap(host, mid) -> str:
    """The innermost host event (shortest) that covers `mid`."""
    best = None
    for ts, te, name in host:
        if ts <= mid <= te and (best is None or te - ts < best[0]):
            best = (te - ts, name)
    return best[1] if best else "no host event"


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def reduce(events: list, requests: int, graph_s: list) -> Trace:
    """The Trace of the chrome-trace `events`; `graph_s`: the device
    seconds of each graph launch, in launch order."""
    window = next(e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    lo, hi = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    launches = {_correlation(e) for e in events
                if e.get("cat") == "cuda_runtime" and e.get("name", "").startswith("cudaGraphLaunch")
                and lo <= float(e["ts"]) < hi}
    kernels = collections.defaultdict(list)
    in_graphs = set()
    ops = collections.defaultdict(float)
    device, graph_start = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e["cat"] == "kernel" and lo <= a < hi:
            kernels[e["name"]].append(float(e["dur"]) * 1e-6)
        corr = _correlation(e)
        if corr in launches:
            graph_start[corr] = min(a, graph_start.get(corr, a))
            if e["cat"] == "kernel":
                in_graphs.add(e["name"])
            continue
        a, b = max(a, lo), min(b, hi)
        if b > a:
            device.append((a, b))
            ops[e["name"]] += (b - a) * 1e-6
    if graph_s:
        ops[GRAPHS] = sum(graph_s)
    extra = 0.0
    if len(graph_start) == len(graph_s):
        for a, secs in zip(sorted(graph_start.values()), graph_s):
            device.append((max(a, lo), min(a + secs * 1e6, hi)))
    else:  # launches without a recorded kernel: their time counts, unplaced
        extra = sum(graph_s) * 1e6
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and "dur" in e and e.get("name") != WINDOW]
    longest = sorted(_gaps(device, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    gaps = [((b - a) * 1e-6, _name_gap(host, 0.5 * (a + b))) for a, b in longest]
    return Trace(busy_s=(_union(device) + extra) * 1e-6, window_s=(hi - lo) * 1e-6,
                 kernels=dict(kernels), in_graphs=in_graphs, ops=dict(ops), gaps=gaps,
                 requests=requests)


def profile(lead_in, fn, requests: int, device, graph_launches) -> Trace:
    """Run lead_in() and then fn() (which serves `requests` requests and
    synchronises) under the profiler, with `graph_launches()` timing fn's
    graph launches, and reduce the trace of fn: the lead-in takes the
    profiler's start-up out of the window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        lead_in()
        with graph_launches() as pairs, torch.profiler.record_function(WINDOW):
            fn()
    graph_s = [start.elapsed_time(end) * 1e-3 for start, end in pairs]
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce(events, requests, graph_s)
