"""Tracing and profiling (counterpart of `fea_large_tpu/utils/profiling.py`):

  * `PhaseTimer`: host wall-clock timers per phase, accumulated into a dict,
    that synchronise the devices of the tensors they are given before
    stopping the clock (PyTorch returns before the card finishes);
  * `trace_region`: a `torch.profiler` trace of the enclosed work (CPU and,
    where CUDA exists, the card), written as a Chrome trace.

The reference's `compiled_cost` (XLA's cost analysis of a jitted function)
has no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict

import torch


def _synchronize(tensors) -> None:
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


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
        with torch.profiler.record_function(name):
            yield
        _synchronize(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name]}
            for name in sorted(self.totals)
        }


@contextlib.contextmanager
def trace_region(out_dir="bench/traces"):
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
