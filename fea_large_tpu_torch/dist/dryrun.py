"""Multi-shard dry run (counterpart of the reference's
`__graft_entry__.dryrun_multichip` and its scale runs): one full sharded
Newton step, one process per shard, on four problems, printing the
reference's lines (`pcg_ok=...`, `|R|: a -> b after 1 Newton step`, the
per-shard memory table):

  1.  the generic sharded path (indexed halo maps), f64, two-level with the
      rigid-body coarse space, on an elongated 5-tet TET10 beam at a state
      whose tangent is checked SPD (`_assert_spd`);
  1b. the structured sharded path (boundary-plane hops), same contract, on
      a Kuhn TET10 beam;
  2.  `dryrun_multichip_large`: the generic path, mixed precision, at
      >= 100k DOF, with the per-shard memory table and its extrapolation
      to 10M DOF on 8 shards;
  2b. `dryrun_structured_large`: the structured path, mixed precision, at
      >= `target_dof`.

    python -m fea_large_tpu_torch.dist.dryrun [n]   (default 2 shards)

The ranks' devices: n gloo ranks on the CPU where FEA_PLATFORM=cpu, else
one NCCL rank per card (`devices` overrides, e.g. ["cuda:0"] * n: n gloo
ranks sharing one card).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from fea_large_tpu_torch import NeoHookean
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.dist.launch import Problem, run_jobs, run_sharded, step_rank
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.solvers.newton import SolverOptions

#: prescribed x-displacement of the dry-run beams (lx=4.0): 0.5% axial
#: strain, SPD with margin (the reference's value)
_DRYRUN_COMP = 0.02
_MAT = NeoHookean(1.0, 0.6)


def default_devices(n: int) -> list:
    """n CPU ranks where FEA_PLATFORM=cpu, else the first n cards."""
    import torch

    if os.environ.get("FEA_PLATFORM") == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have} (FEA_PLATFORM=cpu for CPU ranks)")
    return [f"cuda:{i}" for i in range(n)]


def _assert_spd(mesh, bc, u_aff, label: str) -> None:
    """Dense-assemble the f64 tangent at the dry-run state (host CPU; the
    beams are <= 2.5k DOF) and assert its free-DOF block is SPD: a dry run
    on an indefinite state proves nothing about the solver."""
    import torch

    from fea_large_tpu_torch.assembly.bcsr import BCSRStructure
    from fea_large_tpu_torch.assembly.dense import assemble_dense
    from fea_large_tpu_torch.assembly.scatter import NodeScatter
    from fea_large_tpu_torch.elements.kernels import precompute_geometry

    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    K, _ = assemble_dense(torch.as_tensor(u_aff), mesh.conn, geom, _MAT,
                          BCSRStructure.build(mesh.conn_host, mesh.n_nodes, "cpu"),
                          NodeScatter.build(mesh.conn_host, mesh.n_nodes, "cpu"))
    K = K.numpy()
    free = bc.free_mask.numpy().reshape(-1) > 0
    Kff = K[np.ix_(free, free)]
    w0 = float(np.linalg.eigvalsh(0.5 * (Kff + Kff.T))[0])
    print(f"dryrun[{label}]: tangent min free-DOF eigenvalue {w0:.3e}")
    if not w0 > 0.0:
        raise AssertionError(
            f"dry-run state [{label}] has an indefinite tangent (min eig {w0:.3e})")


def _affine(mesh, axis: int, comp: float) -> np.ndarray:
    """The smooth affine compression consistent with the BCs."""
    coords = mesh.coords_host
    u = np.zeros((mesh.n_nodes, 3))
    u[:, axis] = -comp * coords[:, axis] / coords[:, axis].max()
    return u


def _beam(build, n_devices: int, label: str, min_x: int):
    """(step job, mesh) of dry-run part 1 or 1b: an f64 two-level step on a
    TET10 beam at its SPD-checked affine state."""
    mesh = build(max(2 * n_devices, min_x), 2, 2, lx=4.0, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("xmin").prescribe("xmax", "x", -_DRYRUN_COMP).build()
    u_aff = _affine(mesh, 0, _DRYRUN_COMP)
    _assert_spd(mesh, bc, u_aff, label)
    opts = SolverOptions(linear="pcg", precision="f64", preconditioner="two_level",
                         agg_size=32, coarse_modes=6, pcg_tol=1e-8, pcg_maxiter=600)
    return (step_rank, dict(problem=Problem.of(mesh, _MAT, bc), options=opts, u0=u_aff)), mesh


def _large(build, n_devices: int, target_dof: int, agg_size=None):
    """(step job, mesh) of a scale run: the smallest n^3 TET10 box of at
    least `target_dof` DOF (n a multiple of the shards on a Kuhn box), zmin
    fixed, zmax -0.05, one mixed two-level step from the affine state."""
    step = n_devices if build is box_mesh_kuhn else 1
    n = n_devices if build is box_mesh_kuhn else 4
    mesh = build(n, n, n, element_type="tet10", device="cpu")
    while mesh.n_dof < target_dof:  # mesh generation is cheap at this scale
        n += step
        mesh = build(n, n, n, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    opts = SolverOptions(linear="pcg", precision="mixed", preconditioner="two_level",
                         agg_size=agg_size, coarse_modes=6, pcg_tol=1e-6, pcg_maxiter=600)
    return (step_rank, dict(problem=Problem.of(mesh, _MAT, bc), options=opts,
                            u0=_affine(mesh, 2, 0.05))), mesh


def _memory_line(rep: dict) -> str:
    """The shard's memory report: static_* are the bytes of the tensors the
    shard holds, work_* (and so the total) are estimated from the shapes;
    node counts as counts."""
    sizes = [f"{k}={v / 1e6:.3f}MB" for k, v in rep.items()
             if k.startswith(("static", "work", "total"))]
    return (f"per-shard memory (static: held; work, total: estimated), owned_nodes="
            f"{rep['owned_nodes']}, halo_nodes={rep['halo_nodes']}: " + ", ".join(sizes))


def _report_step(label, out, mesh) -> list:
    print(
        f"dryrun[{label}]: mesh={mesh.n_nodes} nodes ({mesh.element_type}), "
        f"shards={out['n_shards']}, coarse Nc={out['n_agg']}, "
        f"pcg_iters={out['pcg_iters']}, pcg_ok={out['pcg_ok']}, lin_rel={out['lin_rel']:.1e}, "
        f"|R|: {out['norm0']:.3e} -> {out['norm']:.3e} after 1 Newton step", flush=True)
    failures = []
    if not out["pcg_ok"]:
        failures.append(f"{label}: f64 PCG did not converge (rel={out['lin_rel']})")
    if not out["norm"] < 0.2 * out["norm0"]:
        failures.append(f"{label}: Newton step did not reduce |R|: "
                        f"{out['norm0']} -> {out['norm']}")
    return failures


def _report_large(out, mesh, n_devices, t_build) -> list:
    rep = out["memory"]
    target_owned = 10_000_000 / 3 / 8
    f = target_owned / max(rep["owned_nodes"], 1)
    # the inverse's bytes as stored (bf16 on a card, f32 on the CPU), the
    # same on every shard at any scale
    repl = rep["static_coarse_replicated"]
    total_10m = (rep["total_per_shard"] - repl) * f + repl
    print(
        f"dryrun_multichip_large({n_devices}): {mesh.n_dof} DOFs "
        f"({mesh.n_nodes} nodes, {mesh.n_elements} tet10), "
        f"shards={out['n_shards']}, kmax={out['kmax']}, coarse Nc={out['n_agg']}, "
        f"pcg_iters={out['pcg_iters']}, pcg_ok={out['pcg_ok']}, "
        f"setup {t_build + out['setup_s']:.1f}s, step {out['step_s']:.1f}s")
    print(_memory_line(rep))
    print(f"extrapolated to 10M DOF / 8 shards: ~{total_10m / 1e9:.2f} GB per shard "
          f"(H100 memory 80 GB; linear in owned nodes)", flush=True)
    return [] if out["pcg_ok"] else ["large: PCG did not converge in the large dry run"]


def _report_structured_large(out, mesh, n_devices, t_build) -> list:
    print(
        f"dryrun_structured_large({n_devices}): {mesh.n_dof} DOFs "
        f"({mesh.n_nodes} nodes, {mesh.n_elements} kuhn tet10), "
        f"shards={out['n_shards']}, plane={out['plane']}, "
        f"coarse Nc={out['n_agg']} block={out['block']}, "
        f"pcg_iters={out['pcg_iters']}, pcg_ok={out['pcg_ok']}, lin_rel={out['lin_rel']:.1e}, "
        f"setup {t_build + out['setup_s']:.1f}s, step {out['step_s']:.1f}s")
    print(_memory_line(out["memory"]), flush=True)
    return [] if out["pcg_ok"] else [
        f"structured_large: structured PCG did not converge (rel={out['lin_rel']})"]


def _run(parts, devices) -> list:
    """Run the parts' step jobs in one process group; print each part's
    lines and return the failed checks (all parts are reported first)."""
    run = run_sharded(run_jobs, devices, [job for job, _ in parts])
    failures = []
    for (_, report), out in zip(parts, run.result):
        failures += report(out)
    return failures


def _raise(failures) -> None:
    if failures:
        raise AssertionError("dryrun_multichip parts failed: " + "; ".join(failures))


def dryrun_multichip(n_devices: int, devices=None, structured_dof: int = 100_000) -> None:
    """One full sharded Newton step on each of parts 1, 1b, 2 and 2b (module
    docstring) over `n_devices` ranks; every part is reported, then the
    failed checks raise together."""
    devices = default_devices(n_devices) if devices is None else list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for {n_devices} shards")
    t0 = time.perf_counter()
    parts = []
    for build, label, min_x in ((box_mesh, "unstructured", 4), (box_mesh_kuhn, "structured", 2)):
        job, mesh = _beam(build, n_devices, label, min_x)
        parts.append((job, lambda out, label=label, mesh=mesh: _report_step(label, out, mesh)))
    job, mesh = _large(box_mesh, n_devices, 100_000)
    t_build = time.perf_counter() - t0
    parts.append((job, lambda out, mesh=mesh: _report_large(out, mesh, n_devices, t_build)))
    job, kmesh = _large(box_mesh_kuhn, n_devices, structured_dof, agg_size=2000)
    parts.append((job, lambda out: _report_structured_large(out, kmesh, n_devices, t_build)))
    _raise(_run(parts, devices))


def dryrun_multichip_large(n_devices: int = 8, target_dof: int = 100_000, devices=None) -> None:
    """Part 2 alone at `target_dof`."""
    devices = default_devices(n_devices) if devices is None else list(devices)
    t0 = time.perf_counter()
    job, mesh = _large(box_mesh, n_devices, target_dof)
    t_build = time.perf_counter() - t0
    _raise(_run([(job, lambda out: _report_large(out, mesh, n_devices, t_build))], devices))


def dryrun_structured_large(n_devices: int = 8, target_dof: int = 4_000_000,
                            devices=None) -> None:
    """Part 2b alone at `target_dof` (aggregates of 2000 nodes)."""
    devices = default_devices(n_devices) if devices is None else list(devices)
    t0 = time.perf_counter()
    job, mesh = _large(box_mesh_kuhn, n_devices, target_dof, agg_size=2000)
    t_build = time.perf_counter() - t0
    _raise(_run([(job, lambda out: _report_structured_large(out, mesh, n_devices, t_build))],
                devices))


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
