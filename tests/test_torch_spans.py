"""PyTorch port: the program's spans (utils/profiling.py) on the CPU's
eager route, a 5-tet TET10 box n=3 with bench.py's options:

  (a) the device loop's spans count its bodies: `pcg_iteration` runs the
      loop's CG iterations (`total_cg`, its `cg` body's runs), `jacobi`
      and `pcg_init` the heads that reached the linear solve, `freeze`
      the heads; a solve's spans sum to no more than its wall time, and
      no span is left open after it;
  (b) `step_fn`'s spans: `residual64`, `freeze`, `jacobi` and
      `step_refresh` once a step, `pcg_iteration` the chunk's step body's
      runs (`runs[3]`), one `pcg_init`; the step's spans sum to no more
      than its wall time;
  (c) `span` enters no `record_function` while the profiler is off, and
      enters one under `torch.profiler.profile`; `profiling.SETUP` times
      the solver's set-up and its coarse space;
  (d) the one host of the captured programs (`cuda_graphs.Host`) on its
      eager route: a WHILE chain and an IF chain over its bodies and a
      joined host's count each body's runs, its spans gain those runs, and
      `fetch` returns the values in order and replays nothing;
  (e) the f64 assembled route (`linear="pcg_bcsr"`, the options of the
      benchmark's cell `bcsr-increment`) over one increment: `residual64`
      once a Newton residual, `stiffness`, `assemble`, `jacobi` and
      `step_refresh` once a Newton step, `pcg_iteration` the f64 chunk's
      step body's runs (restarts included); its spans sum to no more than
      its wall time, and no span is left open after it.
"""

import time

import pytest
import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.ops import cuda_graphs
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions
from fea_large_tpu_torch.utils import profiling

torch.set_num_threads(2)

BENCH = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
             forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
             resid_df=False)
BCSR64 = dict(linear="pcg_bcsr", precision="f64", preconditioner="jacobi", forcing="ew",
              ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-8, pcg_maxiter=2000)
CPU = torch.device("cpu")


def _totals() -> dict:
    return {name: tuple(v) for name, v in profiling.SPAN_TOTALS.items()}


def _baseline() -> dict:
    """`_totals()` once the CPU's table holds nothing unread: the stamps
    that earlier work in this process left after its last fetch (an f64
    solve's converged residual, an assembly called directly) are read
    here, so that the next fetch counts only this test's."""
    profiling.read_spans(CPU, profiling.span_table(CPU))
    return _totals()


def _gained(before: dict) -> dict:
    """{span: (runs, ns)} gained since `before`."""
    return {name: (r - before[name][0], ns - before[name][1])
            for name, (r, ns) in _totals().items()}


@pytest.fixture(scope="module")
def solver():
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    setup = {k: (profiling.SETUP.counts[k], v) for k, v in profiling.SETUP.totals.items()}
    s = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**BENCH))
    s.setup_before = setup
    return s


def _start(solver, scale):
    return scale * -0.05 * solver.mesh.coords[:, 2:3] * torch.tensor([[0.0, 0.0, 1.0]],
                                                                      dtype=torch.float64)


def test_loop_spans_count_the_bodies(solver):
    before = _baseline()
    t0 = time.perf_counter_ns()
    _, ok, rec = solver._newton(_start(solver, 1.0), 1.0)
    wall = time.perf_counter_ns() - t0
    gained = _gained(before)
    loop = solver._device_loop
    assert ok and loop.last.total_cg > 0
    assert gained["pcg_iteration"][0] == loop.last.total_cg == loop.runs["cg"]
    assert gained["freeze"][0] == loop.runs["pre"] == loop.runs["post"] == loop.last.n_iters
    assert gained["jacobi"][0] == gained["pcg_init"][0] == gained["newton_check"][0] \
        == loop.runs["post"]
    assert gained["residual32"][0] == loop.runs["resid32"]
    assert gained["residual64"][0] == loop.runs["resid64"]
    assert gained["newton_tail"][0] == loop.runs["tail"]
    assert gained["step_refresh"] == gained["pcg_control"] == (0, 0)
    assert all(ns >= 0 for _, ns in gained.values())
    assert 0 < sum(ns for _, ns in gained.values()) <= wall
    assert profiling._table(CPU).host_open[0] == -1  # closed after the launch


def test_step_spans(solver):
    before = _baseline()
    t0 = time.perf_counter_ns()
    _, k, ok, _ = solver.step_fn(_start(solver, 0.8), 0.8)
    wall = time.perf_counter_ns() - t0
    gained = _gained(before)
    chunk = solver._routes["mixed"].chunk("coarse")  # made by this first step
    assert ok and k > 0
    for name in ("residual64", "freeze", "jacobi", "step_refresh", "pcg_init"):
        assert gained[name][0] == 1, name
    assert gained["pcg_iteration"][0] == k == int(chunk.runs[3])
    assert gained["pcg_control"][0] == 2  # arm, fin
    assert 0 < sum(ns for _, ns in gained.values()) <= wall
    assert profiling._table(CPU).host_open[0] == -1


def test_chunk_runs_match_the_span(solver):
    chunk = solver._routes["mixed"].chunk("coarse")
    before, runs0 = _baseline(), int(chunk.runs[3])
    solver.step_fn(_start(solver, 1.1), 1.1)
    assert _gained(before)["pcg_iteration"][0] == int(chunk.runs[3]) - runs0 > 0


def test_span_enters_record_function_only_under_the_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args, **kw):
        entered.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profiling.span("fea.test"):
        pass
    assert profiling.span("fea.test") is profiling.span("fea.other")  # one shared no-op
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("fea.test"):
            torch.ones(4).sum()
    assert entered == ["fea.test"]
    assert "fea.test" in {e.name for e in prof.events()}


def test_setup_spans(solver):
    gained = {name: (profiling.SETUP.counts[name] - solver.setup_before.get(name, (0, 0.0))[0],
                     profiling.SETUP.totals[name] - solver.setup_before.get(name, (0, 0.0))[1])
              for name in ("setup.solver", "setup.coarse")}
    assert gained["setup.solver"][0] == gained["setup.coarse"][0] == 1
    assert 0 < gained["setup.coarse"][1] <= gained["setup.solver"][1]  # a child phase


def test_host_runs_its_chains_eagerly():
    """A host of two bodies (arm, step) joined to a host of one (add), on
    the CPU: loop = arm; WHILE(more) {step; IF(odd) add} runs step for
    k = 1..5 and add for the odd k; once = IF(odd) add runs add once more."""
    k = torch.zeros((), dtype=torch.int64)
    total = torch.zeros((), dtype=torch.float64)
    more, odd = torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool)

    def arm():
        k.zero_()
        more.fill_(True)

    def step():
        k.add_(1)
        more.copy_(k < 5)
        odd.copy_(k % 2 == 1)

    def add():
        total.add_(k)

    host = cuda_graphs.Host(CPU, {"arm": arm, "step": step}, ("pcg_control", "pcg_iteration"),
                            {"more": more}, {})
    other = cuda_graphs.Host(CPU, {"add": add}, ("newton_tail",), {"odd": odd}, {})
    host.join(other, {"loop": ((None, None, "arm"),
                               ("while", "more", ((None, None, "step"), ("if", "odd", "add")))),
                      "once": (("if", "odd", "add"),)})
    replayed = dict(cuda_graphs.REPLAYED)
    before = _baseline()
    host.launch("loop")
    vals, ran = cuda_graphs.fetch((k, total, odd), host, other)
    assert vals == [5.0, 9.0, 1.0]
    assert ran == [{"arm": 1, "step": 5}, {"add": 3}]
    gained = _gained(before)
    assert (gained["pcg_control"][0], gained["pcg_iteration"][0], gained["newton_tail"][0]) \
        == (1, 5, 3)
    assert all(ns >= 0 for _, ns in gained.values())
    assert profiling._table(CPU).host_open[0] == -1  # closed after the launch
    host.launch("once")
    vals, ran = cuda_graphs.fetch((total,), host, other)
    assert vals == [14.0] and ran == [{"arm": 0, "step": 0}, {"add": 1}]
    assert host.runs.tolist() == [1, 5] and other.runs.tolist() == [4]
    assert not host.captured and host.graph_nodes == {} and host.capture_s == 0.0
    assert cuda_graphs.REPLAYED == replayed


def test_f64_assembled_route_spans():
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**BCSR64))
    # the CPU's table, not SPAN_TOTALS: the converged iteration's residual
    # is stamped after the increment's last fetch
    table = profiling.span_table(CPU)
    before = table.clone()
    t0 = time.perf_counter_ns()
    _, ok, rec = solver._newton(_start(solver, 1.0), 1.0)
    wall = time.perf_counter_ns() - t0
    gained = {name: (int(table[2 * i] - before[2 * i]), int(table[2 * i + 1] - before[2 * i + 1]))
              for i, name in enumerate(profiling.SPANS)}
    steps = rec.newton_iters
    assert ok and steps == len(rec.pcg_iters) > 0
    assert gained["residual64"][0] == len(rec.residual_norms) == steps + 1
    for name in ("stiffness", "assemble", "jacobi", "step_refresh"):
        assert gained[name][0] == steps, name
    chunk = solver._routes["pcg_bcsr"].chunk("jacobi")
    assert gained["pcg_iteration"][0] == int(chunk.runs[3]) == sum(rec.pcg_iters)
    assert gained["pcg_init"][0] == 2 * steps  # init0 and the restart's initx
    assert gained["freeze"] == gained["residual32"] == gained["newton_check"] == (0, 0)
    assert all(ns >= 0 for _, ns in gained.values())
    assert 0 < sum(ns for _, ns in gained.values()) <= wall
    assert profiling._table(CPU).host_open[0] == -1
