"""The one traffic generator: a mix file's parameters and a seed give the
list of requests of a run, made before the window opens.

A mix (traffic/<name>.json) holds
  request       what a request is: a key of system.REQUESTS;
  amplitude     [low, high]: the compression amplitude's range, as a share
                of the box height;
  strata        the range cut into this many equal strata; every block of
                `strata` consecutive requests holds each stratum's midpoint
                once, in an order drawn from the seed, so every seed offers
                the same work in another order;
  length        requests in the list (more than any window completes);
  warmup        requests run before the window (the range's two ends and
                its middle, in turn), which build and capture what the
                window uses and, where there are many, carry the cards
                past their slow start;
  sample        answers of the window the check compares with the
                reference: a uniform sample drawn from the seed;
  trace_requests requests a traced run profiles after the window (after
                one more that takes the profiler's start-up).

A request's load factor is amplitude / |prescribed value| of the
configuration (bench.py prescribes 5% at load factor 1).
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one stream (0 requests, 1 the sample)."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def amplitudes(mix: dict, seed: int) -> list[float]:
    """The run's request amplitudes, in order."""
    low, high = mix["amplitude"]
    k = mix["strata"]
    levels = low + (high - low) * (np.arange(k) + 0.5) / k
    gen = rng(seed, 0)
    blocks = -(-mix["length"] // k)
    return np.concatenate([gen.permutation(levels) for _ in range(blocks)])[: mix["length"]].tolist()


def warmup_amplitudes(mix: dict) -> list[float]:
    """The warm-up requests' amplitudes: low, high, middle, low, ..."""
    low, high = mix["amplitude"]
    ends = (low, high, 0.5 * (low + high))
    return [ends[i % 3] for i in range(mix["warmup"])]


def load_factor(config: dict, amplitude: float) -> float:
    """The load factor at which the prescribed displacement is `amplitude`
    times the box height."""
    value = max(abs(s["value"]) for s in config["bc"]["prescribe"])
    return amplitude * config["mesh"].get("length", 1.0) / value


class Reservoir:
    """A uniform sample of `size` of the answers offered, drawn from the
    seed (reservoir sampling): `offer(i)` says whether answer i is kept
    and in which slot."""

    def __init__(self, size: int, seed: int):
        self.size, self.gen = size, rng(seed, 1)

    def offer(self, i: int) -> int | None:
        if i < self.size:
            return i
        j = int(self.gen.integers(0, i + 1))
        return j if j < self.size else None
