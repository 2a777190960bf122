"""PyTorch port: the task-file entry point (`python -m fea_large_tpu_torch
run|info|bench`) against the JAX reference's (tests/test_torch_io.py holds
the I/O, loads and post-processing it runs on).

  * `run`, then `run --resume` from the first increment's checkpoint:
    bitwise equal to the uninterrupted run; the `bench` and `info` JSON;
  * `run` on the small single-device task files on the CPU
    (FEA_PLATFORM=cpu): the reference's increments and Newton counts and
    converged u within 1e-10 relative of the reference's own `run` of the
    same file. (The mixed Kuhn task takes the reference's CPU backend many
    minutes to compile; it runs on the card in chip_smoke.py, against an
    f64 solve of the same file.)
  * a task with `partition.n_shards > 1` on a machine with fewer cards than
    shards exits 2 with the reference's message (tests/test_torch_dist.py
    runs such a task on gloo ranks), and without CUDA and without
    FEA_PLATFORM=cpu the command fails.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fea_large_tpu import cli as ref_cli

from fea_large_tpu_torch import cli
from fea_large_tpu_torch.io import export
from fea_large_tpu_torch.io.task import load_task

torch.set_num_threads(2)

TASKS = pathlib.Path(__file__).resolve().parent.parent / "tasks"
#: the single-device task files small enough for the reference's CPU run
SMALL_TASKS = ["uniaxial_tet4.json", "beam_bending.json", "gravity_column_tet10.json",
               "pressure_tet10.json"]


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("FEA_PLATFORM", "cpu")


def _run(main, argv):
    """(exit code, standard output) of a CLI `main` called in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


TINY = {
    "mesh": {"box": {"nx": 2, "ny": 2, "nz": 2}},
    "element_type": "tet4",
    "material": {"model": "neo_hookean", "E": 2.0, "nu": 0.3},
    "loading": {"n_steps": 2, "dirichlet": [
        {"set": "zmin", "components": "xyz", "value": 0.0},
        {"set": "zmax", "components": "z", "value": 0.15}]},
    "solver": {"linear": "pcg", "pcg_tol": 1e-12},
    "output": {"msh": True},
}


def test_run_resume_bit_matches_uninterrupted(tmp_path, cpu_platform):
    """`run` of a two-increment task, then `run --resume` from a checkpoint
    of its first increment (what `run` writes after it): bitwise-equal
    final u, and the convergence record stays cumulative."""
    task_file = tmp_path / "tiny.json"
    task_file.write_text(json.dumps(TINY))
    full, part = tmp_path / "full", tmp_path / "part"
    rc, text = _run(cli.main, ["run", str(task_file), "--out", str(full)])
    assert rc == 0 and "converged" in text
    for name in ("tiny_convergence.json", "tiny_checkpoint.npz", "tiny_final.npz",
                 "tiny_deformed.vtk", "tiny_deformed.msh"):
        assert (full / name).exists(), name
    conv = json.loads((full / "tiny_convergence.json").read_text())
    assert conv["converged"] and [s["load_factor"] for s in conv["steps"]] == [0.5, 1.0]
    # the interrupted run: the first increment's checkpoint and record
    task = load_task(task_file, device="cpu")
    solver = cli._solver(task)
    states = []
    solver.solve(callback=lambda rec, u: states.append((rec, u)))
    rec0, u0 = states[0]
    part.mkdir()
    export.export_npz(part / "tiny_checkpoint.npz", u0, 1, rec0.residual_norms,
                      load_factor=rec0.load_factor)
    (part / "tiny_convergence.json").write_text(json.dumps(
        {"task": "tiny", "converged": False, "steps": conv["steps"][:1]}))
    rc, text = _run(cli.main, ["run", str(task_file), "--out", str(part), "--resume"])
    assert rc == 0 and "resuming from load factor 0.5000" in text
    a = export.load_checkpoint(full / "tiny_final.npz")["u"]
    b = export.load_checkpoint(part / "tiny_final.npz")["u"]
    assert np.array_equal(a, b)
    resumed = json.loads((part / "tiny_convergence.json").read_text())
    assert [s["load_factor"] for s in resumed["steps"]] == [0.5, 1.0]


def test_bench_and_info_print_the_reference_schema(tmp_path, cpu_platform):
    task_file = tmp_path / "tiny.json"
    task_file.write_text(json.dumps(TINY))
    rc, text = _run(cli.main, ["bench", str(task_file), "--reps", "2"])
    assert rc == 0
    out = json.loads(text.strip().splitlines()[-1])
    assert sorted(out) == sorted(["task", "n_dof", "n_shards", "wall_s", "newton_steps",
                                  "s_per_newton_step", "total_pcg_iters", "reps"])
    assert out["task"] == "tiny" and out["n_shards"] == 1 and len(out["reps"]) == 2
    assert out["newton_steps"] >= 2 and out["total_pcg_iters"] > 0 and out["wall_s"] > 0
    rc, text = _run(cli.main, ["info", str(TASKS / "pressure_tet10.json")])
    _, ref_text = _run(ref_cli.main, ["info", str(TASKS / "pressure_tet10.json")])
    assert rc == 0 and json.loads(text) == json.loads(ref_text)


@pytest.mark.parametrize("name", SMALL_TASKS)
def test_run_task_file_matches_reference_run(name, tmp_path, cpu_platform):
    rc, _ = _run(cli.main, ["run", str(TASKS / name), "--out", str(tmp_path / "port")])
    ref_rc, _ = _run(ref_cli.main, ["run", str(TASKS / name), "--out", str(tmp_path / "ref")])
    assert rc == 0 and ref_rc == 0
    stem = name.split(".")[0]
    conv = json.loads((tmp_path / "port" / f"{stem}_convergence.json").read_text())
    ref_conv = json.loads((tmp_path / "ref" / f"{stem}_convergence.json").read_text())
    assert conv["converged"] and ref_conv["converged"]
    for key in ("load_factor", "newton_iters"):
        assert [s[key] for s in conv["steps"]] == [s[key] for s in ref_conv["steps"]]
    for ext in ("_checkpoint.npz", "_final.npz", "_deformed.vtk"):
        assert (tmp_path / "port" / f"{stem}{ext}").exists()
    u = export.load_checkpoint(tmp_path / "port" / f"{stem}_final.npz")["u"]
    u_ref = export.load_checkpoint(tmp_path / "ref" / f"{stem}_final.npz")["u"]
    assert np.linalg.norm(u - u_ref) <= 1e-10 * np.linalg.norm(u_ref)


@pytest.mark.parametrize("command", ["run", "bench"])
def test_sharded_task_is_not_ported(command, monkeypatch):
    """An 8-shard task on the card with one card visible: exit 2 and the
    reference's message, with no fallback to the CPU or to fewer shards."""
    monkeypatch.delenv("FEA_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, text = _run(cli.main, [command, str(TASKS / "distributed_compression.json")])
    assert rc == 2
    if command == "run":
        assert ("[distributed_compression] ERROR: task requests 8 shards but only 1 devices "
                "are visible") in text
    else:
        assert json.loads(text) == {"task": "distributed_compression",
                                    "error": "needs 8 devices, have 1"}


def test_module_entry_point_runs_on_the_card_or_fails(tmp_path):
    """`python -m fea_large_tpu_torch` runs on the CPU only where
    FEA_PLATFORM=cpu; without it the device is the card, and where CUDA is
    absent the command fails (no fallback)."""
    env = {k: v for k, v in os.environ.items() if k != "FEA_PLATFORM"}
    cmd = [sys.executable, "-m", "fea_large_tpu_torch", "info", str(TASKS / "uniaxial_tet4.json")]
    cwd = str(TASKS.parent)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=cwd, timeout=120)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr
    else:
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    proc = subprocess.run(cmd, capture_output=True, text=True, env={**env, "FEA_PLATFORM": "cpu"},
                          cwd=cwd, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["n_dof"] == 1029
