"""The command without a card, and without the program beside it."""

import portbench_paths  # noqa: F401  (first: the paths)
import json
import shutil
import subprocess
import sys

PORTBENCH = portbench_paths.PORTBENCH
REPO = PORTBENCH.parent


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "5tet-increment", "--seed",
         "3000000001", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_card_and_prints_no_result():
    import torch

    assert not torch.cuda.is_available()  # this suite runs on the CPU
    out = _run(REPO)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_an_unknown_cell_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "no-such-cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_exits_nonzero_with_only_the_benchmark_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["portbench"]
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
