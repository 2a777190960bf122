"""The system under test, fea_large_tpu_torch, built from a configuration
file, and the requests a traffic mix sends it. With the launcher of the
ranks (sharded.py) and the faults of control.py, this is the only module of
the benchmark that imports the program.

A configuration names the mesh ("kuhn": `box_mesh_kuhn`, "5tet":
`box_mesh`), its cells (`n`: one count for every axis, or three) and
element, the material, the Dirichlet
conditions and the `SolverOptions`. A request is one load factor `scale`;
its start state is bench.py's: `scale` times the affine field that runs from
0 to each prescribed value (u_z = -0.05 z at scale 1).

`System` is the program on one device (`NewtonSolver`), served in the
harness's own process. A configuration with `ranks` > 1 runs the CLI's
sharded route instead: `ShardedSystem` is one rank's part of the program's
sharded solver, built as the CLI's ranks build it (`dist.launch.Problem`,
`make_sharded_solver`), on every rank of the program's own `run_sharded`
that the adapter for several cards (sharded.py) starts, and
`SHARDED_REQUESTS` are the requests it serves there.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.dist import launch
from fea_large_tpu_torch.materials import make_material
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import cuda_build, cuda_graphs
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions
from fea_large_tpu_torch.utils import profiling
from reference.mesh import cells_per_axis

MESHES = {"kuhn": box_mesh_kuhn, "5tet": box_mesh}


@dataclasses.dataclass
class Outcome:
    """One answered request: u [N, 3] f64 on the device (the program's
    buffer until the next request), whether the program reports it done
    (converged, or a step without breakdown), its counts, and what it
    claims (`r0`: the f64 residual norm of the start, increments only)."""

    u: torch.Tensor
    ok: bool
    newton: int | None
    pcg: int
    fetches: int
    r0: float | None = None


def _box(config: dict, device):
    """(mesh, bc, material) of the configuration, the mesh on `device`."""
    m, length = config["mesh"], config["mesh"].get("length", 1.0)
    mesh = MESHES[m["kind"]](*cells_per_axis(m["n"]), length, length, length,
                             element_type=m["element"], device=device)
    dirichlet = DirichletBuilder(mesh)
    for face in config["bc"].get("fix", ()):
        dirichlet.fix(face)
    for spec in config["bc"].get("prescribe", ()):
        dirichlet.prescribe(spec["set"], spec["component"], spec["value"])
    mat = config["material"]
    return mesh, dirichlet.build(), make_material(mat["name"], lam=mat["lam"], mu=mat["mu"])


def _unit(config: dict, mesh, device) -> torch.Tensor:
    """The start state at load factor 1, f64 [N, 3] on `device`."""
    length = config["mesh"].get("length", 1.0)
    unit = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device=device)
    for spec in config["bc"].get("prescribe", ()):
        axis, comp = "xyz".index(spec["set"][0]), "xyz".index(spec["component"])
        unit[:, comp] += spec["value"] * mesh.coords[:, axis] / length
    return unit


class System:
    """The program on one device at the configuration's full size."""

    def __init__(self, config: dict, device):
        self.mesh, self.bc, material = _box(config, device)
        self.solver = NewtonSolver(self.mesh, material, self.bc,
                                   options=SolverOptions(**config["solver"]))
        self.unit = _unit(config, self.mesh, device)
        self.device = torch.device(device)
        self.built_s = 0.0  # nvcc seconds of the set-up (harness.prepare)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def chunk_fetches(self) -> int:
        """Host fetches of the solver's PCG chunks so far (every route)."""
        return sum(c.fetches for route in self.solver._routes.values()
                   for c in route.chunks.values())

    def coords(self):
        """The program's node positions [N, 3] (host), to read its u by."""
        return self.mesh.coords_host

    def close(self) -> None:
        """Drop the solver, its graphs and buffers."""
        self.solver = self.unit = None


def increment(system: System, scale: float) -> Outcome:
    """One load increment solved to convergence (bench.py's call, and the
    one `solve()` makes per increment)."""
    fetched = system.chunk_fetches()
    u, ok, rec = system.solver._newton(scale * system.unit, scale)
    system.sync()
    loop = system.solver._device_loop
    fetches = system.chunk_fetches() - fetched + (loop.last.fetches if loop is not None else 0)
    return Outcome(u=u, ok=bool(ok), newton=rec.newton_iters, pcg=sum(rec.pcg_iters),
                   fetches=fetches, r0=rec.residual_norms[0] if rec.residual_norms else None)


def step(system: System, scale: float) -> Outcome:
    """One Newton step through the public `step_fn` (entry()'s step)."""
    fetched = system.chunk_fetches()
    u, k, ok, rnorm = system.solver.step_fn(scale * system.unit, scale)
    system.sync()
    return Outcome(u=u, ok=bool(ok) and rnorm == rnorm, newton=None, pcg=int(k),
                   fetches=system.chunk_fetches() - fetched)


REQUESTS = {"increment": increment, "step": step}


@contextlib.contextmanager
def graph_launches():
    """Time each launch of the program's composed CUDA graphs
    (`cuda_graphs.Program.launch`) with a pair of CUDA events on its
    stream, for the block: yields the list of (start, end) events, in
    launch order. The profiler records a kernel node under a WHILE or IF
    node once a launch, so the graphs' device time comes from these."""
    launch, pairs = cuda_graphs.Program.launch, []

    def timed_launch(program):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(program)
        end.record()
        pairs.append((start, end))

    cuda_graphs.Program.launch = timed_launch
    try:
        yield pairs
    finally:
        cuda_graphs.Program.launch = launch


@contextlib.contextmanager
def kernel_builds():
    """Count the seconds nvcc spends building the program's kernels
    (`cuda_build.build_library`; 0 where the checkout's build directory
    already holds them) in the block: yields a one-item list of the sum."""
    build, total = cuda_build.build_library, [0.0]

    def counted(source):
        path, seconds, log = build(source)
        total[0] += seconds
        return path, seconds, log

    cuda_build.build_library = counted
    try:
        yield total
    finally:
        cuda_build.build_library = build


class ShardedSystem:
    """One rank's part of the program's sharded solver at the
    configuration's full size, the CLI's sharded route: the whole problem on
    the host (`launch.Problem`), the solver that `make_sharded_solver`
    picks on the rank's `comm` (dist/comm.py, `launch._solver`), this rank's
    shard on its device. Its `sync` ends when every rank's device has
    finished: a synchronise, then a sum over the ranks."""

    def __init__(self, config: dict, comm):
        mesh, bc, material = _box(config, "cpu")
        self.comm, self.device = comm, comm.device
        #: host seconds of the solver's set-up, ending in a synchronise, the
        #: captures of its graphs included (on this route the constructor
        #: makes them)
        self.solver, self.setup_s = launch._solver(
            comm, launch.Problem.of(mesh, material, bc), SolverOptions(**config["solver"]), "slab")
        self.unit = self.solver.u_from_global(_unit(config, mesh, "cpu").numpy())
        self._coords = mesh.coords_host

    def agree(self, value: float) -> float:
        """The sum over the ranks of each rank's `value` (a collective)."""
        x = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device if self.comm.backend == "nccl" else "cpu")
        dist.all_reduce(x)
        return float(x)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.agree(0.0)

    def carry_on(self, go: bool) -> bool:
        """Rank 0's `go` on every rank (a collective)."""
        return self.agree(float(go) if self.comm.rank == 0 else 0.0) > 0.0

    def u_global(self, u: torch.Tensor) -> torch.Tensor:
        """The global u [N, 3] (host) of every rank's part (a collective)."""
        return torch.from_numpy(self.solver.u_global(u))

    def coords(self):
        """The program's node positions [N, 3] (host), to read its u by."""
        return self._coords

    def spans(self) -> tuple[dict, dict]:
        """This process's span totals and set-up phases: (SPAN_TOTALS,
        {"setup.solver": the solver's set-up seconds}); on this route the
        captures happen inside the solver's set-up, which opens no set-up
        phase of its own."""
        return ({name: list(v) for name, v in profiling.SPAN_TOTALS.items()},
                {"setup.solver": self.setup_s})

    def close(self) -> None:
        """Drop the solver, its graphs and buffers (its graphs hold NCCL's
        captured work, which the group's teardown waits for)."""
        self.solver = self.unit = None


def sharded_increment(system: ShardedSystem, scale: float) -> Outcome:
    """One load increment solved to convergence on every rank at once
    (`_newton`, as the sharded `solve()` makes per increment), ending when
    every rank has its answer."""
    fetched = system.solver.fetches
    u, ok, rec = system.solver._newton(scale * system.unit, scale)
    system.sync()
    return Outcome(u=u, ok=bool(ok), newton=rec.newton_iters, pcg=sum(rec.pcg_iters),
                   fetches=system.solver.fetches - fetched,
                   r0=rec.residual_norms[0] if rec.residual_norms else None)


SHARDED_REQUESTS = {"increment": sharded_increment}


def load_spans(spans: dict, setup: dict) -> None:
    """Put a rank's span totals and set-up phases (`ShardedSystem.spans`)
    into this process's registry, which the readers read: the process
    that runs the ranks runs no program of its own."""
    for name, v in spans.items():
        profiling.SPAN_TOTALS[name] = list(v)
    profiling.SETUP.totals.clear()
    profiling.SETUP.totals.update(setup)
