"""The cells over several cards end to end on the CPU at their small
sizes (cell_sizes.py), on gloo ranks of the program's `run_sharded`, the
card's look skipped: a sound run is correct and reports its metrics, and
each fault the cell can have, and the lower-precision control, planted
inside the ranks, make it not correct; a rank that loads the JAX package
makes the run exit 3 with no result. Also: the configuration is config
5's mesh on four ranks, and the one-card cells report what they reported
before the adapter came."""

import portbench_paths  # noqa: F401  (first: the paths)
import functools
import json
import sys
import time
import types

import pytest

import cell_sizes
import control
import harness
import run
import sharded
from test_portbench_cells import COUNTERS

PORTBENCH = portbench_paths.PORTBENCH


def _run(cell, seconds=3.0, trace=False, fault=False):
    return harness.run(cell, 3_000_000_013, seconds, trace, time.perf_counter(), device="cpu",
                       overrides=cell_sizes.overrides(cell, fault))


def rank_loading_the_jax_package(comm, *args):
    """`sharded.serve_rank`, with a module of the JAX package loaded on
    rank 1 alone."""
    if comm.rank == 1:
        sys.modules["fea_large_tpu.planted"] = types.ModuleType("fea_large_tpu.planted")
    return sharded.serve_rank(comm, *args)


def _names(cell, trace):
    return [m["name"] for m in harness.Cell(PORTBENCH.parent, cell).metrics(trace)]


@pytest.mark.parametrize("cell", cell_sizes.SHARDED)
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == set(_names(cell, False))
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "checked"
    assert out["setup_built_kernels_s"] == 0  # nothing to build on the CPU
    assert out["device"]["count"] == 4 and out["device"]["platform"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in out["checked"].values())


@pytest.mark.parametrize("cell", cell_sizes.SHARDED)
def test_traced_run_reports_its_counts(cell):
    out = _run(cell, trace=True)
    assert out["correct"]
    entries = harness.Cell(PORTBENCH.parent, cell).metrics(True)
    counters = [m["name"] for m in entries if m["name"].split(".")[0] in COUNTERS]
    assert counters
    for name in counters:
        assert out["metrics"][name]["value"] >= COUNTERS[name.split(".")[0]], name
    # rank 0's set-up, loaded into this process's registry
    assert out["metrics"]["solver_setup_s.sharded"]["value"] > 0
    # no card: the device spans and the trace's device time find nothing
    assert "pcg_iter_ms.sharded" not in out["metrics"]
    assert not {m["name"] for m in entries if m["source"] == "device_trace"} & set(out["metrics"])
    assert set(out["metrics"]) <= set(_names(cell, True))
    assert "breakdown" in out and out["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", cell_sizes.SHARDED)
def test_a_rank_that_loads_the_jax_package_exits_3_with_no_result(cell, monkeypatch, capsys):
    monkeypatch.setattr(sharded, "RANK", rank_loading_the_jax_package)
    monkeypatch.setattr(harness, "run", functools.partial(
        harness.run, device="cpu", overrides=cell_sizes.overrides(cell)))
    code = run.main(["--workload", cell, "--seed", "3000000017", "--seconds", "1",
                     "--trace", "0"])
    out, err = capsys.readouterr()
    assert code == 3 and out.strip() == ""
    assert "fea_large_tpu" in err
    assert "fea_large_tpu.planted" not in sys.modules  # rank 1's, not this process's


@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered", "exchange"])
@pytest.mark.parametrize("cell", cell_sizes.SHARDED)
def test_each_fault_and_the_control_fail_the_check(cell, mode):
    with control.patched(mode, cell_sizes.cell(cell, fault=True)):
        out = _run(cell, seconds=1.0, fault=True)
    assert out["correct"] is False


def test_the_configuration_is_config_5_on_four_ranks():
    bench = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "kuhn-sharded")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((PORTBENCH.parent / entry["file"]).read_text())
    m, ranks = config["mesh"], config["ranks"]
    nx, ny, nz = m["n"]
    assert (m["kind"], m["element"], nx, ny, nz) == ("kuhn", "tet10", 72, 75, 75)
    dof, elements = 3 * (2 * nx + 1) * (2 * ny + 1) * (2 * nz + 1), 6 * nx * ny * nz
    assert (dof, elements) == (m["dof"], m["elements"]) == (9_918_435, 2_430_000)
    assert abs(dof - 10_000_000) < 0.01 * 10_000_000  # the published 10M
    assert cell["chips"] == ranks == 4 and nx % 8 == 0 and nx % ranks == 0
    layers = nx // ranks
    plane = (2 * ny + 1) * (2 * nz + 1)
    part = config["partition"]
    assert part["x_cell_layers_per_rank"] == layers
    assert part["local_nodes"] == (2 * layers + 1) * plane
    assert part["local_dof"] == 3 * part["local_nodes"]
    assert part["halo_plane_nodes"] == plane
    assert sorted(entry["reduced"]) == sorted(config["reduced"])


def test_the_one_card_cells_report_what_they_did():
    assert _names("5tet-increment", False) == ["solve_s", "setup_s"]
    assert _names("5tet-step", False) == ["step_s", "setup_s"]
    assert _names("5tet-increment", True) == [
        "newton_steps.solve", "newton_step_s.solve", "host_fetches.solve", "pcg_iters.solve",
        "coarse_gemv_roofline.solve", "tangent_apply_roofline.solve", "device_idle_share.solve",
        "newton_head_ms.solve", "jacobi_ms.solve", "pcg_iter_ms.solve", "solver_setup_s"]
    assert _names("5tet-step", True) == [
        "host_fetches.step", "pcg_iters.step", "coarse_gemv_roofline.step",
        "tangent_apply_roofline.step", "device_idle_share.step", "jacobi_ms.step",
        "pcg_iter_ms.step", "step_prepare_ms.step", "solver_setup_s"]
