"""A new cell is files and entries alone: in a copy of the benchmark, a
configuration, a traffic mix and a per-layer metric (`tiny-gentle`), and a
cell on the f64 BCSR route (`tiny-bcsr`), each with its CPU size, run
without an edit to any file that was there; the copy's own coverage test
passes, and on the f64 route the control and each fault read not correct."""

import portbench_paths  # noqa: F401  (first: the paths)
import hashlib
import json
import os
import shutil
import subprocess
import sys

PORTBENCH = portbench_paths.PORTBENCH
REPO = PORTBENCH.parent
FAULTS = ("control", "half", "unchanged", "altered")

RUN = """
import json, pathlib, sys, time
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "portbench"), sys.argv[2]]
import torch
torch.set_num_threads(1)
import control, harness
assert pathlib.Path(harness.__file__).resolve().parent == (root / "portbench").resolve()
out = {"tiny-gentle": harness.run("tiny-gentle", 3000000021, 2.0, True, time.perf_counter(),
                                  root=root, device="cpu")}
cell = harness.Cell(root, "tiny-bcsr")
out["tiny-bcsr"] = {"sound": harness.run("tiny-bcsr", 3000000023, 2.0, False,
                                         time.perf_counter(), root=root, device="cpu")}
for mode in sys.argv[3:]:
    with control.patched(mode, cell):
        out["tiny-bcsr"][mode] = harness.run("tiny-bcsr", 3000000023, 1.0, False,
                                             time.perf_counter(), root=root, device="cpu")
print(json.dumps(out))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_cells(root):
    """The two cells' files and entries, added to the copy at `root`."""
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "kuhn-tet10-1m.json").read_text())
    config["name"] = "tiny-kuhn"
    config["mesh"] = dict(config["mesh"], n=3)
    config["material"] = dict(config["material"], lam=2.0)
    (pb / "configs" / "tiny-kuhn.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "increment.json").read_text())
    mix["amplitude"] = [0.01, 0.02]
    (pb / "traffic" / "gentle.json").write_text(json.dumps(mix))
    (pb / "metrics" / "mean_amplitude.py").write_text(
        "def read(run):\n    return sum(r['amplitude'] for r in run.records) / len(run.records)\n")
    # the upstream's config 2 route: bench.py's f64 options on the assembled
    # BCSR operator, block-Jacobi PCG, on a 5-tet TET10 box n=2
    config = json.loads((pb / "configs" / "5tet-tet10-1m.json").read_text())
    del config["coarse"]
    config["name"] = "tiny-bcsr"
    config["mesh"] = dict(config["mesh"], n=2, dof=375, elements=40)
    config["solver"] = {"linear": "pcg_bcsr", "precision": "f64", "preconditioner": "jacobi",
                        "forcing": "ew", "ew_eta_min": 0.01, "newton_rtol": 1e-6,
                        "pcg_tol": 1e-8, "pcg_maxiter": 2000}
    (pb / "configs" / "tiny-bcsr.json").write_text(json.dumps(config))
    (pb / "tests" / "cells" / "tiny-gentle.json").write_text("{}")
    (pb / "tests" / "cells" / "tiny-bcsr.json").write_text("{}")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("tiny-kuhn", "tiny-bcsr"):
        bench["configs"].append(dict(bench["configs"][0], name=name,
                                     file=f"portbench/configs/{name}.json"))
    bench["workloads"] += [
        {"name": "tiny-gentle", "config": "tiny-kuhn", "traffic": "gentle", "chips": 1,
         "why": "a test"},
        {"name": "tiny-bcsr", "config": "tiny-bcsr", "traffic": "increment", "chips": 1,
         "why": "a test"}]
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"] += ["tiny-gentle", "tiny-bcsr"]
    bench["per_layer"].append({"name": "mean_amplitude", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "traffic",
                               "moves": "solve_s", "workloads": ["tiny-gentle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_added_as_files_and_entries_runs(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    _add_cells(tmp_path)
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k.name != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k.name != "BENCHMARK.json"}
    covered = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         str(tmp_path / "portbench" / "tests" / "test_portbench_cells.py"), "-k", "covered"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})  # the program, after the copy's paths
    assert covered.returncode == 0, covered.stdout[-2000:]
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), str(REPO), *FAULTS],
                         capture_output=True, text=True, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    gentle, bcsr = result["tiny-gentle"], result["tiny-bcsr"]
    assert gentle["correct"] is True
    assert 0.01 <= gentle["metrics"]["mean_amplitude"]["value"] <= 0.02
    assert bcsr["sound"]["correct"] is True and bcsr["sound"]["attempted"] > 0
    assert set(bcsr["sound"]["metrics"]) == {"solve_s", "setup_s"}
    assert {mode: bcsr[mode]["correct"] for mode in FAULTS} == dict.fromkeys(FAULTS, False)
