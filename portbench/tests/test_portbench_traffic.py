"""The traffic generator and the check's sample."""

import portbench_paths  # noqa: F401  (first: the paths)
import json
import pathlib

import pytest

import generator

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests_other_seed_other(name):
    mix = _mix(name)
    a = generator.amplitudes(mix, 3_000_000_007)
    assert a == generator.amplitudes(mix, 3_000_000_007)
    assert a != generator.amplitudes(mix, 3_000_000_008)
    assert len(a) == mix["length"]


@pytest.mark.parametrize("name", MIXES)
def test_every_block_offers_the_same_work(name):
    mix = _mix(name)
    k = mix["strata"]
    low, high = mix["amplitude"]
    for seed in (0, 2**31 + 5, 12345678901):
        a = generator.amplitudes(mix, seed)
        assert low <= min(a) and max(a) <= high
        blocks = [sorted(a[i:i + k]) for i in range(0, len(a) - k + 1, k)]
        assert all(b == blocks[0] for b in blocks)
    first = generator.amplitudes(mix, 1)[:k]
    assert sorted(first) == sorted(generator.amplitudes(mix, 2)[:k])


def test_load_factor_is_the_amplitude_over_the_prescribed_value():
    config = {"mesh": {"length": 1.0}, "bc": {"prescribe": [{"value": -0.05}]}}
    assert generator.load_factor(config, 0.05) == pytest.approx(1.0)
    assert generator.load_factor(config, 0.06) == pytest.approx(1.2)


def test_sample_is_uniform_and_seeded():
    def kept(seed, n=40, size=4):
        r, slots = generator.Reservoir(size, seed), [None] * size
        for i in range(n):
            s = r.offer(i)
            if s is not None:
                slots[s] = i
        return sorted(slots)

    assert kept(7) == kept(7)
    counts = [0] * 40
    for seed in range(2000):
        for i in kept(seed):
            counts[i] += 1
    assert min(counts) > 120 and max(counts) < 280  # 2000 * 4 / 40 = 200 each
