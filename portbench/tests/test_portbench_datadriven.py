"""A new cell is files and entries alone: a configuration, a traffic mix and
a per-layer metric added to a copy of the benchmark run without an edit to
any file that was there."""

import portbench_paths  # noqa: F401  (first: the paths)
import hashlib
import json
import shutil
import subprocess
import sys

PORTBENCH = portbench_paths.PORTBENCH
REPO = PORTBENCH.parent

RUN = """
import json, pathlib, sys, time
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "portbench"), sys.argv[2]]
import torch
torch.set_num_threads(1)
import harness
assert pathlib.Path(harness.__file__).resolve().parent == (root / "portbench").resolve()
out = harness.run("tiny-gentle", 3000000021, 2.0, True, time.perf_counter(), root=root,
                  device="cpu")
print(json.dumps(out))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_and_entries_runs(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
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
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny-kuhn",
                                 file="portbench/configs/tiny-kuhn.json"))
    bench["workloads"].append({"name": "tiny-gentle", "config": "tiny-kuhn",
                               "traffic": "gentle", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "5tet-increment" in m["workloads"]:
            m["workloads"].append("tiny-gentle")
    bench["per_layer"].append({"name": "mean_amplitude", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "traffic",
                               "moves": "solve_s", "workloads": ["tiny-gentle"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before and k.name != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k.name != "BENCHMARK.json"}
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), str(REPO)],
                         capture_output=True, text=True, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert 0.01 <= result["metrics"]["mean_amplitude"]["value"] <= 0.02
