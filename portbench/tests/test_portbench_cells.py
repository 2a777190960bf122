"""Every cell end to end on the CPU at a small size, the card's look
skipped: a sound run is correct, and each fault the cells can have, and the
lower-precision control, make it not correct."""

import portbench_paths  # noqa: F401  (first: the paths)
import json
import time

import pytest

import control
import harness
from test_portbench_sharded import SMALL_SHARDED

SMALL = {"5tet-increment": 3, "5tet-step": 3}
CELLS = [w["name"] for w in json.loads((portbench_paths.PORTBENCH.parent /
                                        "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seed=3_000_000_011, trace=False):
    return harness.run(cell, seed, 3.0, trace, time.perf_counter(), device="cpu",
                       overrides={"mesh": {"n": SMALL[cell]}})


def test_every_cell_is_covered():
    # the cells over several cards run in test_portbench_sharded.py
    assert sorted(CELLS) == sorted({**SMALL, **SMALL_SHARDED})


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in harness.Cell(portbench_paths.PORTBENCH.parent, cell).metrics(False)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checked"
    assert out["setup_built_kernels_s"] == 0  # nothing to build on the CPU
    assert all(c["value"] <= c["limit"] for c in out["checked"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reports_its_counts(cell):
    out = _run(cell, trace=True)
    assert out["correct"]
    kind = "solve" if cell.endswith("increment") else "step"
    assert out["metrics"][f"host_fetches.{kind}"]["value"] >= 1
    assert out["metrics"][f"pcg_iters.{kind}"]["value"] > 0
    # no device on the CPU: the trace's device metrics find nothing to read
    assert f"tangent_apply_roofline.{kind}" not in out["metrics"]
    assert "breakdown" in out and out["device"]["window_s"] > 0


@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_each_fault_and_the_control_fail_the_check(cell, mode):
    kind = harness.Cell(portbench_paths.PORTBENCH.parent, cell).kind
    with control.patched(mode, kind):
        out = _run(cell)
    assert out["correct"] is False
