"""Every cell on one card end to end on the CPU at its small size
(cell_sizes.py), the card's look skipped: a sound run is correct, and each
fault the cells can have, and the lower-precision control, make it not
correct; a fault that plants nothing fails the run."""

import portbench_paths  # noqa: F401  (first: the paths)
import json
import time

import pytest

import cell_sizes
import control
import harness

ROOT = portbench_paths.PORTBENCH.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: the per-layer readers of the record's counters, and the least each reads
COUNTERS = {"newton_steps": 1, "pcg_iters": 1, "host_fetches": 1}


def _run(cell, seed=3_000_000_011, trace=False, fault=False):
    return harness.run(cell, seed, 3.0, trace, time.perf_counter(), device="cpu",
                       overrides=cell_sizes.overrides(cell, fault))


def test_every_cell_is_covered():
    # the cells over several cards run in test_portbench_sharded.py
    files = cell_sizes.sizes()
    missing = [str(cell_sizes.DIR.relative_to(ROOT) / f"{c}.json") for c in CELLS
               if c not in files]
    assert not missing, f"add each cell's CPU size: {', '.join(missing)}"
    stray = sorted(set(files) - set(CELLS))
    assert not stray, f"no workload in BENCHMARK.json for the CPU sizes of {', '.join(stray)}"


@pytest.mark.parametrize("cell", cell_sizes.ONE_CARD)
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in harness.Cell(ROOT, cell).metrics(False)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "checked"
    assert out["setup_built_kernels_s"] == 0  # nothing to build on the CPU
    assert all(c["value"] <= c["limit"] for c in out["checked"].values())


@pytest.mark.parametrize("cell", cell_sizes.ONE_CARD)
def test_traced_run_reports_its_counts(cell):
    out = _run(cell, trace=True)
    assert out["correct"]
    entries = harness.Cell(ROOT, cell).metrics(True)
    counters = [m["name"] for m in entries if m["name"].split(".")[0] in COUNTERS]
    assert counters
    for name in counters:
        assert out["metrics"][name]["value"] >= COUNTERS[name.split(".")[0]], name
    # no device on the CPU: the trace's device metrics find nothing to read
    assert not {m["name"] for m in entries if m["source"] == "device_trace"} & set(out["metrics"])
    assert "breakdown" in out and out["device"]["window_s"] > 0


@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", cell_sizes.ONE_CARD)
def test_each_fault_and_the_control_fail_the_check(cell, mode):
    with control.patched(mode, cell_sizes.cell(cell, fault=True)):
        out = _run(cell, fault=True)
    assert out["correct"] is False


@pytest.mark.parametrize("mode", ["control", "half"])
@pytest.mark.parametrize("linear", ["pcg_bcsr", "pcg", "direct"])
def test_a_step_of_an_f64_route_refuses_the_mixed_faults(linear, mode):
    cell = harness.Cell(ROOT, "5tet-step", {"solver": {"precision": "f64", "linear": linear}})
    with pytest.raises(ValueError, match=f"{mode} on the steps of the f64 {linear} route"):
        with control.patched(mode, cell):
            pass


def test_a_fault_that_is_never_called_fails_readings(monkeypatch):
    # half on the f64 routes' residual, which the mixed route never calls
    monkeypatch.setattr(control, "route", lambda config: "f64 pcg_bcsr")
    with pytest.raises(control.NotPlanted, match=r"_residual_fn"):
        control.readings("5tet-increment", "half", [3_000_000_019], 1.0, device="cpu",
                         overrides=cell_sizes.overrides("5tet-increment", fault=True))


def test_a_fault_that_is_never_called_fails_a_fault_run(monkeypatch):
    monkeypatch.setattr(control, "route", lambda config: "f64 direct")
    with pytest.raises(control.NotPlanted, match=r"control on the increments"):
        with control.patched("control", cell_sizes.cell("5tet-increment", fault=True)):
            _run("5tet-increment", fault=True)
