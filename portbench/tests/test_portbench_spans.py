"""The readers of the program's spans (program_spans.py and the metric
files that use it): their arithmetic, None where the program keeps no
spans or no card ran it, and each BENCHMARK.json entry's reading from a
registry filled by hand."""

import portbench_paths  # noqa: F401  (first: the paths)
import json

import pytest
import torch

import harness
import program_spans
from fea_large_tpu_torch.utils import profiling

#: the entries that read the program's spans, and what each reads from TOTALS
ENTRIES = {
    "newton_head_ms.solve": (1.0 + 2.0 + 3.0 + 4.0 + 5.0 + 6.0) / 4,
    "jacobi_ms.solve": 5.0 / 4,
    "jacobi_ms.step": 5.0 / 4,
    "pcg_iter_ms.solve": 40.0 / 50,
    "pcg_iter_ms.step": 40.0 / 50,
    "pcg_iter_ms.sharded": 40.0 / 50,
    "step_prepare_ms.step": (1.0 + 3.0 + 5.0 + 10.0) / 2,
    "solver_setup_s": 7.0 + 0.5,
    "solver_setup_s.sharded": 7.0 + 0.5,
}
#: {span: [runs, ns]}: 4 heads, 50 PCG iterations, 2 steps' set-ups
TOTALS = {"freeze": [4, 1_000_000], "residual32": [2, 2_000_000], "residual64": [3, 3_000_000],
          "newton_check": [4, 4_000_000], "jacobi": [4, 5_000_000], "pcg_init": [4, 6_000_000],
          "pcg_iteration": [50, 40_000_000], "pcg_control": [0, 0], "newton_tail": [4, 0],
          "step_refresh": [2, 10_000_000]}
SETUP = profiling.PhaseTimer()
SETUP.totals.update({"setup.solver": 7.0, "setup.coarse": 2.0, "setup.capture": 0.5})


def test_per_run_ms():
    totals = {"a": (4, 8_000_000), "b": (2, 2_000_000)}
    assert program_spans.per_run_ms(totals, ("a", "b"), "a") == pytest.approx(2.5)
    assert program_spans.per_run_ms(totals, ("a",), "c") is None
    assert program_spans.per_run_ms({"a": (0, 0)}, ("a",), "a") is None
    assert program_spans.per_run_ms(None, ("a",), "a") is None


def test_no_card_no_device_spans(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_TOTALS", TOTALS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert program_spans.device_totals() is None


def test_every_entry_reads_the_registry(monkeypatch):
    bench = json.loads((portbench_paths.PORTBENCH.parent / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert set(ENTRIES) <= names
    monkeypatch.setattr(profiling, "SPAN_TOTALS", TOTALS)
    monkeypatch.setattr(profiling, "SETUP", SETUP)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in ENTRIES.items():
        assert harness.reader(name).read(None) == pytest.approx(want), name


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "SPAN_TOTALS")
    monkeypatch.delattr(profiling, "SETUP")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ENTRIES:
        assert harness.reader(name).read(None) is None, name


def test_a_ranks_totals_load_into_this_process(monkeypatch):
    """The adapter for several cards loads rank 0's registry here
    (`system.load_spans`), where the readers read it."""
    import system

    monkeypatch.setattr(profiling, "SPAN_TOTALS", {name: [0, 0] for name in TOTALS})
    monkeypatch.setattr(profiling, "SETUP", profiling.PhaseTimer())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    system.load_spans(TOTALS, {"setup.solver": 9.0})
    assert harness.reader("pcg_iter_ms.sharded").read(None) == pytest.approx(40.0 / 50)
    assert harness.reader("solver_setup_s.sharded").read(None) == pytest.approx(9.0)
