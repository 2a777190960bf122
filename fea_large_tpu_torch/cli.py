"""Command-line entry point (counterpart of `fea_large_tpu/cli.py`):
`python -m fea_large_tpu_torch ...`.

Subcommands:
  run <task> [--resume] [--out DIR]   solve a task file end to end
  info <task>                         print the parsed problem summary
  bench <task> [--reps N]             time repeated solves of a task (one
                                      JSON line, the reference's schema)

Task files are the reference's (tasks/*.json, .toml, .sexp). Everything
runs on the card; FEA_PLATFORM=cpu (the reference's own switch) selects
the CPU instead. Without CUDA and without that switch the commands fail:
there is no fallback to the CPU.

A task with partition.n_shards = S > 1 runs the sharded solver
(dist/structured_solver.py `make_sharded_solver`) on S processes, one per
shard (dist/launch.py): S gloo ranks on the CPU where FEA_PLATFORM=cpu, else
one NCCL rank per card. Fewer cards than shards is an error (exit 2), with
no fallback to the CPU or to fewer shards. Rank 0 prints and writes the
outputs.

`run` prints the convergence of each load step and writes, under the
output directory, `<task>_convergence.json`, the checkpoint
`<task>_checkpoint.npz` after every converged step (`--resume` continues
from it, bit-matching an uninterrupted run), and as the task asks
`<task>_final.npz`, `<task>_deformed.msh` and `<task>_deformed.vtk` (with
the nodal von Mises stress).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def _load(path):
    from fea_large_tpu_torch.config import task_device
    from fea_large_tpu_torch.io.task import load_task

    return load_task(path, device=task_device())


def _solver(task):
    from fea_large_tpu_torch.solvers.newton import NewtonSolver

    return NewtonSolver(task.mesh, task.material, task.build_bc(), task.build_forces(),
                        task.solver)


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _n_shards(path) -> int:
    from fea_large_tpu_torch.io.task import task_partition

    return task_partition(path).n_shards


def _shard_devices(n_shards: int):
    """The ranks' devices: n_shards CPU ranks where FEA_PLATFORM=cpu, else
    the first n_shards cards; (devices, None), or (None, cards visible)
    where there are fewer cards than shards."""
    import os

    import torch

    if os.environ.get("FEA_PLATFORM") == "cpu":
        return ["cpu"] * n_shards, None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_shards:
        return None, n
    return [f"cuda:{i}" for i in range(n_shards)], None


def _rank_threads(devices) -> int:
    """Each rank's share of this process's torch threads."""
    import torch

    return max(1, torch.get_num_threads() // len(devices))


def _header(task, n_shards, device) -> str:
    mesh = task.mesh
    return (
        f"[{task.name}] {mesh.element_type} mesh: {mesh.n_nodes} nodes, "
        f"{mesh.n_elements} elements, {mesh.n_dof} DOFs; "
        f"material={task.material.name}, linear={task.solver.linear}, "
        f"steps={task.loading.n_steps}, "
        + (f"shards={n_shards} ({task.partition.method})" if n_shards > 1 else f"device={device}")
    )


def _step_line(rec) -> str:
    line = (
        f"  step lam={rec.load_factor:.4f} newton={rec.newton_iters} "
        f"|R|={rec.residual_norms[0]:.3e}->{rec.residual_norms[-1]:.3e} "
        f"t={rec.wall_time:.3f}s"
    )
    return line + (f" pcg={rec.pcg_iters}" if rec.pcg_iters else "")


def _step_record(rec) -> dict:
    return {
        "load_factor": rec.load_factor,
        "newton_iters": rec.newton_iters,
        "residual_norms": rec.residual_norms,
        "pcg_iters": rec.pcg_iters,
        "wall_time": rec.wall_time,
    }


def _resume_records(conv_path, start) -> list:
    """The convergence record's increments up to the resumed load factor
    (it stays cumulative across resumes)."""
    if not conv_path.exists():
        return []
    prior = json.loads(conv_path.read_text())
    return [r for r in prior.get("steps", []) if r.get("load_factor", 0.0) <= start + 1e-12]


def _write_outputs(task, out_dir, u, converged, records) -> None:
    """The convergence record, and as the task asks the final npz and the
    deformed mesh (.msh, .vtk with the nodal von Mises stress)."""
    import torch

    from fea_large_tpu_torch.io.export import export_npz, export_vtk

    (out_dir / f"{task.name}_convergence.json").write_text(
        json.dumps({"task": task.name, "converged": converged, "steps": records}, indent=2))
    if task.output.npz:
        export_npz(out_dir / f"{task.name}_final.npz", u, len(records))
    if task.output.msh:
        from fea_large_tpu_torch.io.export import export_msh

        export_msh(out_dir / f"{task.name}_deformed.msh", task.mesh, u)
    if task.output.vtk:
        from fea_large_tpu_torch.postprocess import nodal_stress

        _, vm = nodal_stress(task.mesh, task.material,
                             torch.as_tensor(u, dtype=torch.float64, device=task.mesh.device))
        export_vtk(out_dir / f"{task.name}_deformed.vtk", task.mesh, u,
                   point_data={"von_mises": vm})


def _cmd_run(args) -> int:
    n_shards = _n_shards(args.task)
    if n_shards > 1:
        return _run_sharded(args, n_shards)
    from fea_large_tpu_torch.io.export import export_npz, load_checkpoint

    task = _load(args.task)
    out_dir = pathlib.Path(args.out or task.output.dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh = task.mesh
    print(_header(task, 1, mesh.device))
    solver = _solver(task)

    u0, start = None, 0.0
    ckpt = out_dir / f"{task.name}_checkpoint.npz"
    records = []
    if args.resume and ckpt.exists():
        import torch

        data = load_checkpoint(ckpt)
        u0 = torch.as_tensor(data["u"], dtype=torch.float64, device=mesh.device)
        start = float(data["load_factor"])
        print(f"[{task.name}] resuming from load factor {start:.4f}")
        records = _resume_records(out_dir / f"{task.name}_convergence.json", start)

    def on_step(rec, u):
        print(_step_line(rec))
        records.append(_step_record(rec))
        export_npz(ckpt, u, len(records), rec.residual_norms, load_factor=rec.load_factor)

    t0 = time.perf_counter()
    result = solver.solve(u0=u0, callback=on_step, start_factor=start)
    _synchronize(mesh.device)
    wall = time.perf_counter() - t0
    u = result.u.cpu().numpy()
    print(
        f"[{task.name}] {'converged' if result.converged else 'FAILED'} in "
        f"{wall:.2f}s; |u|_max={abs(u).max():.6g}"
    )
    _write_outputs(task, out_dir, u, result.converged, records)
    return 0 if result.converged else 1


def _run_sharded(args, n_shards) -> int:
    from fea_large_tpu_torch.dist.launch import run_sharded
    from fea_large_tpu_torch.io.task import load_task

    task = load_task(args.task, device="cpu")
    print(_header(task, n_shards, None), flush=True)
    devices, visible = _shard_devices(n_shards)
    if devices is None:
        print(
            f"[{task.name}] ERROR: task requests {n_shards} shards but "
            f"only {visible} devices are visible "
            "(FEA_PLATFORM=cpu for one gloo rank per shard on the CPU)"
        )
        return 2
    out_dir = pathlib.Path(args.out or task.output.dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run = run_sharded(_run_rank, devices, str(args.task), str(out_dir), bool(args.resume),
                      threads=_rank_threads(devices))
    return 0 if run.result else 1


def _run_rank(comm, path, out_dir, resume) -> bool:
    """`run` on one rank of a sharded task: every rank solves its shard;
    rank 0 prints and writes the outputs. Returns whether it converged."""
    from fea_large_tpu_torch.dist.structured_solver import make_sharded_solver
    from fea_large_tpu_torch.io.export import export_npz, load_checkpoint
    from fea_large_tpu_torch.io.task import load_task

    task = load_task(path, device="cpu")
    out_dir = pathlib.Path(out_dir)
    lead = comm.rank == 0
    solver = make_sharded_solver(task.mesh, task.material, task.build_bc(), task.build_forces(),
                                 task.solver, comm=comm, partition_method=task.partition.method)
    u0, start = None, 0.0
    ckpt = out_dir / f"{task.name}_checkpoint.npz"
    records = []
    if resume and ckpt.exists():
        data = load_checkpoint(ckpt)
        u0 = solver.u_from_global(data["u"])
        start = float(data["load_factor"])
        if lead:
            print(f"[{task.name}] resuming from load factor {start:.4f}", flush=True)
        records = _resume_records(out_dir / f"{task.name}_convergence.json", start)

    def on_step(rec, u):
        u = solver.u_global(u)  # a collective: every rank takes part
        if lead:
            print(_step_line(rec), flush=True)
            records.append(_step_record(rec))
            export_npz(ckpt, u, len(records), rec.residual_norms, load_factor=rec.load_factor)

    t0 = time.perf_counter()
    result = solver.solve(u0=u0, callback=on_step, start_factor=start)
    _synchronize(comm.device)
    wall = time.perf_counter() - t0
    u = solver.u_global(result.u)
    if lead:
        print(
            f"[{task.name}] {'converged' if result.converged else 'FAILED'} in "
            f"{wall:.2f}s; |u|_max={abs(u).max():.6g} ({comm.size} ranks, {comm.backend})",
            flush=True,
        )
        _write_outputs(task, out_dir, u, result.converged, records)
    return result.converged


def _bench_line(task, n_shards, reps, solve) -> dict:
    """A warm-up solve, then `reps` timed ones (`solve()` returns a
    SolveResult after the device is idle): the JSON line's dict."""
    res = solve()
    if not res.converged:
        return {"task": task.name, "error": "did not converge"}
    times, steps, pcg = [], 0, 0
    for _ in range(reps):
        t0 = time.perf_counter()
        res = solve()
        times.append(time.perf_counter() - t0)
        steps = res.total_newton_iters
        pcg = int(sum(sum(r.pcg_iters) for r in res.history))
    best = min(times)
    return {
        "task": task.name,
        "n_dof": task.mesh.n_dof,
        "n_shards": n_shards,
        "wall_s": round(best, 4),
        "newton_steps": steps,
        "s_per_newton_step": round(best / max(steps, 1), 4),
        "total_pcg_iters": pcg,
        "reps": [round(t, 4) for t in times],
    }


def _cmd_bench(args) -> int:
    """A warm-up solve, then `--reps` timed full solves; ONE JSON line
    (wall seconds per Newton step and totals, the reference's keys)."""
    n_shards = _n_shards(args.task)
    if n_shards > 1:
        devices, visible = _shard_devices(n_shards)
        if devices is None:
            name = pathlib.Path(args.task).stem
            print(json.dumps({"task": name,
                              "error": f"needs {n_shards} devices, have {visible}"}))
            return 2
        from fea_large_tpu_torch.dist.launch import run_sharded

        line = run_sharded(_bench_rank, devices, str(args.task), args.reps,
                           threads=_rank_threads(devices)).result
    else:
        task = _load(args.task)
        solver = _solver(task)

        def solve():
            res = solver.solve()
            _synchronize(task.mesh.device)
            return res

        line = _bench_line(task, 1, args.reps, solve)
    print(json.dumps(line))
    return 1 if "error" in line else 0


def _bench_rank(comm, path, reps) -> dict:
    """`bench` on one rank of a sharded task (rank 0's line is printed)."""
    from fea_large_tpu_torch.dist.structured_solver import make_sharded_solver
    from fea_large_tpu_torch.io.task import load_task

    task = load_task(path, device="cpu")
    solver = make_sharded_solver(task.mesh, task.material, task.build_bc(), task.build_forces(),
                                 task.solver, comm=comm, partition_method=task.partition.method)

    def solve():
        res = solver.solve()
        _synchronize(comm.device)
        return res

    return _bench_line(task, comm.size, reps, solve)


def _cmd_info(args) -> int:
    from fea_large_tpu_torch.config import task_device
    from fea_large_tpu_torch.io.task import load_task

    task = load_task(args.task, device=task_device())
    m = task.mesh
    print(
        json.dumps(
            {
                "name": task.name,
                "element_type": m.element_type,
                "n_nodes": m.n_nodes,
                "n_elements": m.n_elements,
                "n_dof": m.n_dof,
                "material": task.material.name,
                "lam": float(task.material.lam),
                "mu": float(task.material.mu),
                "n_steps": task.loading.n_steps,
                "linear": task.solver.linear,
                "node_sets": {k: int(len(v)) for k, v in m.node_sets.items()},
            },
            indent=2,
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fea_large_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="solve a task file")
    pr.add_argument("task")
    pr.add_argument("--resume", action="store_true", help="resume from checkpoint")
    pr.add_argument("--out", default=None, help="output directory override")
    pr.set_defaults(fn=_cmd_run)

    pi = sub.add_parser("info", help="print parsed task summary")
    pi.add_argument("task")
    pi.set_defaults(fn=_cmd_info)

    pb = sub.add_parser("bench", help="time repeated solves of a task file")
    pb.add_argument("task")
    pb.add_argument("--reps", type=int, default=3, help="timed repetitions")
    pb.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
