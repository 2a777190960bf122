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
      the solver's set-up and its coarse space.
"""

import time

import pytest
import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions
from fea_large_tpu_torch.utils import profiling

torch.set_num_threads(2)

BENCH = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
             forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
             resid_df=False)
CPU = torch.device("cpu")


def _totals() -> dict:
    return {name: tuple(v) for name, v in profiling.SPAN_TOTALS.items()}


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
    before = _totals()
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
    before = _totals()
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
    before, runs0 = _totals(), int(chunk.runs[3])
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
