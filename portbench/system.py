"""The system under test, fea_large_tpu_torch, built from a configuration
file, and the requests a traffic mix sends it. This is the only module of
the benchmark that imports the program.

A configuration names the mesh ("kuhn": `box_mesh_kuhn`, "5tet":
`box_mesh`), its cells per axis and element, the material, the Dirichlet
conditions and the `SolverOptions`. A request is one load factor `scale`;
its start state is bench.py's: `scale` times the affine field that runs from
0 to each prescribed value (u_z = -0.05 z at scale 1).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import make_material
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import cuda_build, cuda_graphs
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

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


class System:
    """The program on one device at the configuration's full size."""

    def __init__(self, config: dict, device):
        m, length = config["mesh"], config["mesh"].get("length", 1.0)
        n = m["n"]
        self.mesh = MESHES[m["kind"]](n, n, n, length, length, length,
                                      element_type=m["element"], device=device)
        dirichlet = DirichletBuilder(self.mesh)
        for face in config["bc"].get("fix", ()):
            dirichlet.fix(face)
        for spec in config["bc"].get("prescribe", ()):
            dirichlet.prescribe(spec["set"], spec["component"], spec["value"])
        self.bc = dirichlet.build()
        mat = config["material"]
        material = make_material(mat["name"], lam=mat["lam"], mu=mat["mu"])
        self.solver = NewtonSolver(self.mesh, material, self.bc,
                                   options=SolverOptions(**config["solver"]))
        self.unit = torch.zeros((self.mesh.n_nodes, 3), dtype=torch.float64, device=device)
        for spec in config["bc"].get("prescribe", ()):
            axis, comp = "xyz".index(spec["set"][0]), "xyz".index(spec["component"])
            self.unit[:, comp] += spec["value"] * self.mesh.coords[:, axis] / length
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
