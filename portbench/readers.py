"""What the metric readers (metrics/<name>.py) share: counts over the
window's records and roofline shares from the trace."""

from __future__ import annotations

import statistics

import yardstick


def mean_of(run, key: str) -> float | None:
    """The mean of a record field over the window's requests."""
    values = [r[key] for r in run.records if r[key] is not None]
    return statistics.fmean(values) if values else None


def roofline(run, match, work, dtype: str) -> float | None:
    """Percent of its bound that the mean traced call, under the graph
    launches, of the kernel whose name `match` accepts reaches;
    `work(config)` -> (bytes, flops). None where no kernel matches, or more
    than one: their calls are not one operation's."""
    if run.trace is None:
        return None
    calls = run.trace.calls(match)
    if len(calls) != 1:
        return None
    (secs,) = calls.values()
    return yardstick.roofline_share(work(run.config), dtype, statistics.fmean(secs))


def idle_share(run) -> float | None:
    """Percent of the traced window in which no operation ran on the device."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
