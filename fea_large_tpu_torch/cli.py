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
there is no fallback to the CPU. Domain decomposition (partition.n_shards
> 1) is not ported and raises NotImplementedError.

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

    task = load_task(path, device=task_device())
    if task.partition.n_shards > 1:
        raise NotImplementedError(
            f"task {task.name!r} asks for {task.partition.n_shards} shards: domain "
            "decomposition is not ported (ROADMAP.md A7)")
    return task


def _solver(task):
    from fea_large_tpu_torch.solvers.newton import NewtonSolver

    return NewtonSolver(task.mesh, task.material, task.build_bc(), task.build_forces(),
                        task.solver)


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cmd_run(args) -> int:
    from fea_large_tpu_torch.io.export import export_npz, export_vtk, load_checkpoint

    task = _load(args.task)
    out_dir = pathlib.Path(args.out or task.output.dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    mesh = task.mesh
    print(
        f"[{task.name}] {mesh.element_type} mesh: {mesh.n_nodes} nodes, "
        f"{mesh.n_elements} elements, {mesh.n_dof} DOFs; "
        f"material={task.material.name}, linear={task.solver.linear}, "
        f"steps={task.loading.n_steps}, device={mesh.device}"
    )
    solver = _solver(task)

    u0, start = None, 0.0
    ckpt = out_dir / f"{task.name}_checkpoint.npz"
    conv_path = out_dir / f"{task.name}_convergence.json"
    records = []
    if args.resume and ckpt.exists():
        import torch

        data = load_checkpoint(ckpt)
        u0 = torch.as_tensor(data["u"], dtype=torch.float64, device=mesh.device)
        start = float(data["load_factor"])
        print(f"[{task.name}] resuming from load factor {start:.4f}")
        # the convergence record stays cumulative across resumes
        if conv_path.exists():
            prior = json.loads(conv_path.read_text())
            records = [
                r for r in prior.get("steps", [])
                if r.get("load_factor", 0.0) <= start + 1e-12
            ]

    def on_step(rec, u):
        line = (
            f"  step lam={rec.load_factor:.4f} newton={rec.newton_iters} "
            f"|R|={rec.residual_norms[0]:.3e}->{rec.residual_norms[-1]:.3e} "
            f"t={rec.wall_time:.3f}s"
        )
        if rec.pcg_iters:
            line += f" pcg={rec.pcg_iters}"
        print(line)
        records.append(
            {
                "load_factor": rec.load_factor,
                "newton_iters": rec.newton_iters,
                "residual_norms": rec.residual_norms,
                "pcg_iters": rec.pcg_iters,
                "wall_time": rec.wall_time,
            }
        )
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
    conv_path.write_text(
        json.dumps(
            {"task": task.name, "converged": result.converged, "steps": records},
            indent=2,
        )
    )
    if task.output.npz:
        export_npz(out_dir / f"{task.name}_final.npz", u, len(records))
    if task.output.msh:
        from fea_large_tpu_torch.io.export import export_msh

        export_msh(out_dir / f"{task.name}_deformed.msh", mesh, u)
    if task.output.vtk:
        from fea_large_tpu_torch.postprocess import nodal_stress

        _, vm = nodal_stress(mesh, task.material, result.u)
        export_vtk(out_dir / f"{task.name}_deformed.vtk", mesh, u, point_data={"von_mises": vm})
    return 0 if result.converged else 1


def _cmd_bench(args) -> int:
    """A warm-up solve, then `--reps` timed full solves; ONE JSON line
    (wall seconds per Newton step and totals, the reference's keys)."""
    task = _load(args.task)
    solver = _solver(task)
    res = solver.solve()
    if not res.converged:
        print(json.dumps({"task": task.name, "error": "did not converge"}))
        return 1
    times, steps, pcg = [], 0, 0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = solver.solve()
        _synchronize(task.mesh.device)
        times.append(time.perf_counter() - t0)
        steps = res.total_newton_iters
        pcg = int(sum(sum(r.pcg_iters) for r in res.history))
    best = min(times)
    print(
        json.dumps(
            {
                "task": task.name,
                "n_dof": task.mesh.n_dof,
                "n_shards": task.partition.n_shards,
                "wall_s": round(best, 4),
                "newton_steps": steps,
                "s_per_newton_step": round(best / max(steps, 1), 4),
                "total_pcg_iters": pcg,
                "reps": [round(t, 4) for t in times],
            }
        )
    )
    return 0


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
