"""Run a function on every shard of a sharded solve: one process per shard
(`run_sharded`), and the picklable problem and rank function of a sharded
solve (`Problem`, `solve_rank`).

`run_sharded(fn, devices, *args)` spawns len(devices) processes with the
spawn start method (CUDA cannot be initialised in a forked child), which
meet through a `FileStore` in a fresh temporary directory (no network, no
port) with a timeout on every collective. Rank r calls `fn(comm, *args)`
with its `Comm` (dist/comm.py) on devices[r]. Where a device is CUDA, the
kernels' libraries (and the graph library of the captured route) are built
in the calling process first, so that the ranks load them instead of each
starting nvcc. A rank that raises makes
`run_sharded` raise (the others are stopped); nothing is caught.

`fn` and its arguments must pickle: `fn` a function of a package module,
the arguments numpy arrays and plain data, never CUDA tensors. Each rank
builds its part on its own device.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import pickle
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fea_large_tpu_torch.dist.comm import Comm, backend_for


@dataclasses.dataclass
class ShardedRun:
    """What `run_sharded` returns: rank 0's value of `fn`, and per rank its
    value (`results`), the kernel launches (the wrappers' `LAUNCHES` plus
    the launches of the graphs it replayed, `cuda_graphs.REPLAYED`, counted
    per process), the peak device memory (bytes; 0 on the CPU) and the
    seconds from the spawn to the rank's start, to its joining the group
    and to the end of `fn` (`seconds`: {"start", "joined", "done"})."""

    result: object
    launches: list
    peak_bytes: list
    backend: str
    seconds: list
    results: list

    def total_launches(self) -> dict:
        """Launches summed over the ranks: {"struct": {...}, "elem": {...},
        "bcsr": {...}}."""
        out = {}
        for per in self.launches:
            for mod, counts in per.items():
                tot = out.setdefault(mod, {})
                for k, v in counts.items():
                    tot[k] = tot.get(k, 0) + v
        return out


def _launch_counts() -> dict:
    from fea_large_tpu_torch.ops import bcsr_kernels, cuda_graphs, elem_kernels, struct_kernels

    mods = {"struct": struct_kernels.LAUNCHES, "elem": elem_kernels.LAUNCHES,
            "bcsr": bcsr_kernels.LAUNCHES}
    return {m: {k: v + cuda_graphs.REPLAYED[f"{m}_{k}"] for k, v in c.items()}
            for m, c in mods.items()}


def build_kernels() -> None:
    """Build the libraries of the kernels the sharded paths launch (the
    lattice and the element-block sources) and of the graph composition,
    one nvcc each, together."""
    from fea_large_tpu_torch.ops import cuda_build, cuda_graphs, elem_kernels, struct_kernels

    with ThreadPoolExecutor(3) as pool:
        list(pool.map(cuda_build.build_library,
                      [struct_kernels.SOURCE, elem_kernels.SOURCE, cuda_graphs.SOURCE]))


def _rank_main(rank, devices, run_dir, backend, threads, timeout_s, t_spawn):
    import torch.distributed as dist

    with open(os.path.join(run_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    seconds = {"start": time.time() - t_spawn}
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "nccl":
        # NCCL's default brackets each captured collective with an event
        # record and an event wait node (captured and uncaptured work may
        # then mix on one communicator); a conditional node's body takes no
        # event node, and the ranks' programs hold their collectives there
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    size = len(devices)
    store = dist.FileStore(os.path.join(run_dir, "store"), size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    seconds["joined"] = time.time() - t_spawn
    out = fn(Comm(rank, size, device, backend), *args)
    seconds["done"] = time.time() - t_spawn
    record = {
        "result": out,
        "launches": _launch_counts(),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
        "seconds": seconds,
    }
    path = os.path.join(run_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(record, f)
    os.replace(path + ".tmp", path)
    # a sharded solver's captured graphs hold NCCL's captured work, and
    # NCCL's teardown waits for them; the solver sits in a reference cycle
    # (its programs' bodies call its methods), so collect it first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    dist.destroy_process_group()


def run_sharded(fn, devices, *args, threads: int = 1, timeout_s: float = 600.0) -> ShardedRun:
    """Run fn(comm, *args) on one process per device (see the module
    docstring); `threads` is each rank's `torch.set_num_threads`."""
    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = backend_for(devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        build_kernels()
    run_dir = tempfile.mkdtemp(prefix="fea_sharded_")
    try:
        # the call goes to the ranks through a file: arguments sent by the
        # spawn itself make each child's start wait for the one before it
        # (the parent's write of a large pickle blocks until the child has
        # imported its main module and read it)
        with open(os.path.join(run_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.spawn(_rank_main,
                 args=(devices, run_dir, backend, threads, timeout_s, time.time()),
                 nprocs=len(devices), join=True, start_method="spawn")
        records = []
        for r in range(len(devices)):
            with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
                records.append(pickle.load(f))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return ShardedRun(result=records[0]["result"],
                      launches=[r["launches"] for r in records],
                      peak_bytes=[r["peak_bytes"] for r in records], backend=backend,
                      seconds=[r["seconds"] for r in records],
                      results=[r["result"] for r in records])


# ---------------------------------------------------------------------------
# a sharded solve as a rank function
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Problem:
    """A solve's inputs as host arrays, picklable: the mesh (coords,
    connectivity, element type, Kuhn lattice structure or None, quadrature
    override), the material, the Dirichlet free mask and values, and the
    external force or None. Each rank rebuilds them on the CPU (`build`);
    the solver puts its shard's part on the rank's device."""

    coords: np.ndarray
    conn: np.ndarray
    element_type: str
    structure: object
    n_quad: int | None
    material: object
    free_mask: np.ndarray
    values: np.ndarray
    f_ext: np.ndarray | None = None

    @staticmethod
    def of(mesh, material, bc, f_ext=None) -> "Problem":
        return Problem(
            coords=mesh.coords_host, conn=mesh.conn_host, element_type=mesh.element_type,
            structure=mesh.structure, n_quad=mesh.n_quad, material=material,
            free_mask=bc.free_mask.cpu().numpy(), values=bc.values.cpu().numpy(),
            f_ext=None if f_ext is None else f_ext.cpu().numpy(),
        )

    def build(self):
        """(mesh, material, bc, f_ext) on the CPU."""
        from fea_large_tpu_torch.interop import dirichlet_from_numpy
        from fea_large_tpu_torch.mesh.core import Mesh

        mesh = Mesh.create(self.coords, self.conn, self.element_type, {},
                           structure=self.structure, device="cpu", n_quad=self.n_quad)
        bc = dirichlet_from_numpy(self.free_mask, self.values, device="cpu")
        f = None if self.f_ext is None else torch.as_tensor(self.f_ext, dtype=torch.float64)
        return mesh, self.material, bc, f


def _sync(comm: Comm) -> None:
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)


def _solver(comm: Comm, problem: Problem, options, partition_method: str):
    """(solver, setup seconds): the solver `make_sharded_solver` picks."""
    from fea_large_tpu_torch.dist.structured_solver import make_sharded_solver

    mesh, material, bc, f_ext = problem.build()
    _sync(comm)
    t0 = time.perf_counter()
    solver = make_sharded_solver(mesh, material, bc, f_ext, options, comm=comm,
                                 partition_method=partition_method)
    _sync(comm)
    return solver, time.perf_counter() - t0


def solve_rank(comm: Comm, problem: Problem, options, partition_method: str = "slab",
               u0=None, increment: float | None = None, solves: int = 1,
               profile: bool = False, probe_coarse: bool = False) -> dict:
    """Rank function of a sharded solve: build the solver that
    `make_sharded_solver` picks, then `solves` times either `solve()` (from
    u0, global [N, 3], or zero) or, with `increment`, one Newton increment
    at that load factor from u0. With `profile`, the last solve records the
    collectives' host seconds (`Comm.profile`). Returns the solver kind,
    the setup seconds, the memory report and per solve the global u (rank 0
    only), convergence, the increment records, the seconds, the
    collectives' seconds and counts, the host fetches and the programs
    launched (Newton iterations, further chunks, restarts: one fetch
    each), this rank's peak device memory (bytes; 0 on the CPU), its
    route ("captured" or "eager"), whether its f64 residual takes the
    fused kernel (`resid_df`), per chunk route its programs' graph
    nodes and capture seconds, and the coarse inverse's storage dtype and
    dim (None without a coarse space); with `probe_coarse`, also the probed coarse
    matrix (`probe_coarse_matrix`) and its aggregation. Every rank returns
    the same but u."""
    cuda = comm.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(comm.device)
    solver, setup_s = _solver(comm, problem, options, partition_method)
    runs = []
    for i in range(solves):
        comm.profile = profile and i == solves - 1
        comm.reset_profile()
        start = None if u0 is None else solver.u_from_global(u0)
        fetches, launched = solver.fetches, dict(solver.launched)
        _sync(comm)
        t1 = time.perf_counter()
        if increment is None:
            res = solver.solve(u0=start)
            u, converged, history = res.u, res.converged, res.history
        else:
            u, converged, rec = solver._newton(start if start is not None else solver.zero_u(),
                                               increment)
            history = [rec]
        _sync(comm)
        dt = time.perf_counter() - t1
        comm.profile = False
        ug = solver.u_global(u)
        runs.append({
            "u": ug if comm.rank == 0 else None, "converged": bool(converged),
            "history": [dataclasses.asdict(h) for h in history], "solve_s": dt,
            "collective_s": dict(comm.seconds), "collective_calls": dict(comm.calls),
            "fetches": solver.fetches - fetches,
            "launched": {k: v - launched[k] for k, v in solver.launched.items()},
        })
    stats = solver.program_stats()
    out = {"kind": type(solver).__name__, "kmax": solver.part.kmax, "setup_s": setup_s,
           "runs": runs,
           "memory": solver.memory_report(), "n_agg": solver._n_agg,
           "precond_fallbacks": solver.precond_fallbacks, "backend": comm.backend,
           "peak_bytes": torch.cuda.max_memory_allocated(comm.device) if cuda else 0,
           "route": stats["route"], "resid_df": stats["resid_df"],
           "graph_nodes": stats["graph_nodes"],
           "capture_s": stats["capture_s"],
           "coarse_inverse": None if solver.coarse is None else {
               "dtype": str(solver.coarse.acinv.dtype).removeprefix("torch."),
               "dim": solver.coarse.acinv.shape[0]}}
    if probe_coarse:
        ctx = solver._probe_ctx
        out.update(coarse_matrix=solver.probe_coarse_matrix().cpu().numpy(), agg=ctx["agg"],
                   dvec=ctx["dvec"])
    return out


def step_rank(comm: Comm, problem: Problem, options, u0, scale: float = 1.0,
              partition_method: str = "slab") -> dict:
    """Rank function of one sharded Newton step: impose the BC on u0
    (global [N, 3]) at `scale`, one chunked PCG solve of the Newton system
    (`_step_pcg`), and the residual norm before and after. Returns the
    solver, the shard counts, the PCG iterations, convergence and final
    relative residual, both norms, the seconds of setup and step, the
    memory report, the route, and the step's fetches and programs
    launched."""
    solver, setup_s = _solver(comm, problem, options, partition_method)
    u = solver._impose(solver.u_from_global(u0), scale)
    norm0 = float(solver._residual_norm(u, scale))
    fetches = solver.fetches
    _sync(comm)
    t0 = time.perf_counter()
    u_new, iters, ok, rel = solver._step_pcg(u, scale)
    _sync(comm)
    step_s = time.perf_counter() - t0
    stats = solver.program_stats()
    part = solver.part
    return {"kind": type(solver).__name__, "n_shards": part.n_shards, "kmax": part.kmax,
            "plane": getattr(getattr(solver, "spart", None), "plane_size", None),
            "n_agg": solver._n_agg,
            "block": None if getattr(solver, "_lattice_pool", None) is None
            else solver._lattice_pool.block,
            "pcg_iters": int(iters), "pcg_ok": bool(ok), "lin_rel": float(rel), "norm0": norm0,
            "norm": float(solver._residual_norm(u_new, scale)), "setup_s": setup_s,
            "step_s": step_s, "memory": solver.memory_report(), "route": stats["route"],
            "fetches": stats["fetches"] - fetches, "launched": stats["launched"]}


def run_jobs(comm: Comm, jobs) -> list:
    """Rank function running several rank functions in turn in one process
    group: jobs = [(fn, kwargs), ...]; returns their values in order."""
    return [fn(comm, **kwargs) for fn, kwargs in jobs]
