"""PyTorch port: the device-resident Newton loop (`device_loop=True`,
fea_large_tpu_torch/solvers/device_loop.py) against the JAX reference's
(`_mixed_solve_fn` and its dispatch in `_newton_mixed`).

On the CPU the loop's bodies run eagerly, a Python `if` on each flag in
place of an IF node (on the card the same bodies run as replayed CUDA
graphs: the `_on_card` test, which skips here; the reference is imported
inside the tests that use it, so that it also runs where JAX is not
installed: `python -m pytest --noconftest -k on_card
tests/test_torch_device_loop.py`). Three reference solves, in one module
fixture (the reference jit-compiles its whole device loop):
  (a) tests/test_solvers.py:385's problem (TET10 5-tet box 4^3, zmax
      -0.1, two-level with 6 modes, EW, pcg_tol 1e-6, newton_rtol 1e-9):
      the reference's Newton count and PCG list exactly, u within 1e-8 of
      max |u| (the reference test's bound between its two loops), and the
      port's host loop's Newton count and PCG list;
  (f) block-Jacobi alone (coarse=None) at (a)'s load and tolerances on
      the 5-tet TET10 box 3^3, and on (a)'s 4^3 box at zmax -0.09: the
      same checks. On (a)'s own box and load the last solve's CG count is a
      knife edge (its residual hovers about its tolerance for ~20
      iterations): both of the port's loops take 31 there, both of the
      reference's 13 (`JACOBI_KNIFE_EDGE`, measured on CPU), so the
      packages' f32 sums split it, not the loops; that case holds the
      port's two loops to each other and to the reference's first ten
      counts.
Without the reference: (b) bench.py's settings on the Kuhn n=4 lattice
against the reference's device-loop counts written down in chip_smoke.py
(measured on CPU), and u within 1e-8 of the port's host loop; (c)
`device_loop_budget=5` hands over to the host loop and converges within
1e-7 of (a) (the reference test's bound); (d) a CG breakdown reported by
the device solve is continued by the host loop, with no bisection; (e)
`device_forcing` is bitwise `newton_lin_tol` on the reference test's norm
histories and on random ones; the device-state PCG against the
reference's `pcg_init`/`pcg_chunk`; the three-level and 12-mode
preconditioners and a poisoned residual on both loops; a change to the
solver's inputs builds a new loop, which solves as a fresh solver's; and
the options and task loader field for field.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from chip_smoke import REFERENCE_N4_DEVICE_LOOP
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.io.task import load_task
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.solvers import device_loop as dl
from fea_large_tpu_torch.solvers import newton as nm
from fea_large_tpu_torch.solvers.linear import DevicePCG, device_pcg_init, device_pcg_step
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

#: tests/test_solvers.py::test_device_loop_matches_host_loop's options
BASE = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
            forcing="ew", pcg_tol=1e-6, newton_rtol=1e-9, max_newton=60)
JACOBI = dict(BASE, preconditioner="jacobi")
#: case: (cells per axis of the 5-tet TET10 box, zmax displacement, options)
CASES = {"two_level": (4, -0.1, BASE), "jacobi": (3, -0.1, JACOBI),
         "jacobi_4": (4, -0.09, JACOBI)}
#: block-Jacobi on (a)'s box and load: [(newton_iters, pcg_iters)] of the
#: reference's device loop and host loop alike (measured on CPU)
JACOBI_KNIFE_EDGE = [(11, [1, 1, 1, 1, 1, 4, 7, 11, 18, 30, 13])]
BENCH = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
             forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
             resid_df=False)


def _problem(n=4, load=-0.1, device="cpu"):
    mesh = box_mesh(n, n, n, element_type="tet10", device=device)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", load).build()
    return mesh, NeoHookean(1.0, 0.6), bc


def _solve(n=4, load=-0.1, **opts):
    return NewtonSolver(*_problem(n, load), options=SolverOptions(**opts)).solve()


def _history(res):
    return [(r.newton_iters, r.pcg_iters) for r in res.history]


def _rel(u, ref):
    return float(np.abs(np.asarray(u) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def reference():
    """{case: (u, [(newton_iters, pcg_iters)])} of the reference's device loop."""
    import jax.numpy as jnp

    from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
    from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
    from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
    from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

    out = {}
    for name, (n, load, opts) in CASES.items():
        mesh = ref_box_mesh(n, n, n, element_type="tet10")
        bc = RefDirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", load).build()
        res = RefNewtonSolver(mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), bc,
                              options=RefOptions(device_loop=True, **opts)).solve()
        assert res.converged
        out[name] = (np.asarray(res.u), _history(res))
    return out


@pytest.fixture(scope="module")
def port():
    """{(case, device_loop): SolveResult} of the port (the knife edge too)."""
    cases = dict(CASES, knife_edge=(4, -0.1, JACOBI))
    return {(name, flag): _solve(n, load, device_loop=flag, **opts)
            for name, (n, load, opts) in cases.items() for flag in (True, False)}


def test_solver_options_match_reference():
    """Every field of the reference's SolverOptions, in its order, with its
    default, device_loop_budget included."""
    from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

    fields = [(f.name, f.default) for f in dataclasses.fields(SolverOptions)]
    ref = [(f.name, f.default) for f in dataclasses.fields(RefOptions)]
    assert fields == ref
    assert SolverOptions(device_loop_budget=5).device_loop_budget == 5


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_matches_reference(reference, port, case):
    """(a) and (f): the reference device loop's Newton counts and PCG lists,
    u within 1e-8 of max |u|."""
    u_ref, hist_ref = reference[case]
    res = port[(case, True)]
    assert res.converged
    assert _history(res) == hist_ref
    assert _rel(res.u.numpy(), u_ref) <= 1e-8


@pytest.mark.parametrize("case", sorted(CASES) + ["knife_edge"])
def test_device_loop_matches_host_loop(port, case):
    """The port's two loops take the same Newton sequence (the reference's
    tests/test_solvers.py::test_device_loop_matches_host_loop)."""
    dev, host = port[(case, True)], port[(case, False)]
    assert dev.converged and host.converged
    assert _history(dev) == _history(host)
    assert _rel(dev.u.numpy(), host.u.numpy()) <= 1e-8


def test_jacobi_knife_edge_splits_packages_not_loops(port):
    """Block-Jacobi on (a)'s box and load: both of the port's loops give the
    reference's first ten CG counts and one last count of their own (the
    reference's loops agree on theirs, `JACOBI_KNIFE_EDGE`)."""
    (newton_ref, pcg_ref), = JACOBI_KNIFE_EDGE
    for flag in (True, False):
        (newton, pcg), = _history(port[("knife_edge", flag)])
        assert newton == newton_ref and pcg[:-1] == pcg_ref[:-1]


def _bench_newton(**opts):
    mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**opts))
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    return solver._newton(bc.impose(u, 1.0), 1.0)


def test_kuhn_bench_device_loop_matches_reference_counts():
    """(b) bench.py's default route on the Kuhn n=4 lattice: the reference's
    device-loop counts and first residual (chip_smoke.py's constant), and u
    within 1e-8 of the port's host loop."""
    u, ok, rec = _bench_newton(**BENCH, device_loop=True)
    ref = REFERENCE_N4_DEVICE_LOOP
    assert ok and rec.newton_iters == ref["newton_iters"]
    assert rec.pcg_iters == ref["pcg_iters"]
    assert abs(rec.residual_norms[0] - ref["residual0"]) <= 1e-12 * ref["residual0"]
    u_h, ok_h, rec_h = _bench_newton(**BENCH, device_loop=False)
    assert ok_h and rec_h.newton_iters == rec.newton_iters
    assert _rel(u.numpy(), u_h.numpy()) <= 1e-8


def test_budget_hands_over_to_host_loop(port, monkeypatch):
    """(c) device_loop_budget=5: the device loop runs out of CG iterations,
    the host loop continues warm-started, and the increment converges within
    1e-7 of max |u| of the unbudgeted device loop."""
    handbacks = []
    host = NewtonSolver._newton_mixed_host

    def spy(self, u, scale, handback=None):
        handbacks.append(handback)
        return host(self, u, scale, handback)

    monkeypatch.setattr(NewtonSolver, "_newton_mixed_host", spy)
    res = _solve(device_loop=True, device_loop_budget=5, **BASE)
    assert res.converged
    assert handbacks and handbacks[0] is not None and len(handbacks[0][1]) >= 1
    full = port[("two_level", True)]
    assert _rel(res.u.numpy(), full.u.numpy()) <= 1e-7


def test_cg_breakdown_hands_back_to_host_loop(monkeypatch):
    """(d) tests/test_solvers.py:470 in the port: the device solve reports a
    CG breakdown after its second Newton iteration once; the host loop
    continues the increment, which converges with one record at load factor
    1.0 (no bisection)."""
    real = dl.DeviceLoop.solve
    fired = []

    def fake(self, u0, scale):
        out = real(self, u0, scale)
        if fired:
            return out
        fired.append(True)
        n = min(out.n_iters, 2)
        return dataclasses.replace(
            out, n_iters=n, residual_norms=out.residual_norms[:n], pcg_iters=out.pcg_iters[:n],
            converged=False, failed=True, exhausted=False, poisoned=False)

    monkeypatch.setattr(dl.DeviceLoop, "solve", fake)
    res = _solve(device_loop=True, **BASE)
    assert fired and res.converged
    assert len(res.history) == 1 and res.history[0].load_factor == 1.0


#: tests/test_solvers.py::test_device_forcing_mirrors_host_newton_lin_tol's
#: residual history
FORCING_NORMS = [1.0, 0.31, 4.1e-2, 8.3e-4, 2.7e-6, 9.9e-9]


def _forcing_pairs(opts, norms):
    """(newton_lin_tol, device_forcing) of each iteration of a history."""
    stop_n = max(opts.newton_rtol * norms[0], opts.newton_atol)
    eta_h, eta_d = 0.5, torch.tensor(0.5, dtype=torch.float64)
    f64 = dict(dtype=torch.float64)
    out = []
    for it in range(len(norms)):
        tol_h, eta_h = nm.newton_lin_tol(opts, it, norms[: it + 1], norms[0], eta_h)
        eta_d, tol_d = nm.device_forcing(
            torch.tensor(norms[it], **f64), torch.tensor(norms[it - 1] if it else 1.0, **f64),
            eta_d, torch.tensor(it == 0), opts.pcg_tol, opts.forcing == "ew", 1.2e-6,
            torch.tensor(stop_n, **f64), opts.ew_eta_min)
        out.append(((tol_h, eta_h), (float(tol_d), float(eta_d))))
    return out


@pytest.mark.parametrize("forcing,eta_min", [("ew", 0.0), ("ew", 1e-2), ("fixed", 0.0)])
def test_device_forcing_is_newton_lin_tol(forcing, eta_min):
    """(e) bitwise on the reference test's history and on 300 random
    histories (EW: lin_tol and eta; fixed: lin_tol, eta unused)."""
    rng = np.random.default_rng(0)
    histories = [FORCING_NORMS] + [
        list(np.exp(np.cumsum(rng.uniform(-6.0, 0.5, rng.integers(2, 8)))) * rng.uniform(0.1, 10))
        for _ in range(300)]
    for k, norms in enumerate(histories):
        opts = SolverOptions(forcing=forcing, precision="mixed", ew_eta_min=eta_min,
                             pcg_tol=1e-6 if k == 0 else float(rng.choice([1e-6, 1e-3])))
        for (tol_h, eta_h), (tol_d, eta_d) in _forcing_pairs(opts, norms):
            assert tol_d == tol_h
            assert forcing != "ew" or eta_d == eta_h


def test_device_pcg_matches_reference_pcg():
    """`device_pcg_init` and `device_pcg_step` while `active` against the
    reference's `pcg_init` and `pcg_chunk` (f32, from zero, block-Jacobi on
    an SPD block-tridiagonal system): the same iteration count and x within
    1e-5 of max |x| (f32 dots in another order)."""
    import jax.numpy as jnp

    from fea_large_tpu.solvers import linear as ref_linear

    rng = np.random.default_rng(3)
    n = 60
    A = np.zeros((3 * n, 3 * n), np.float32)
    for i in range(n):
        B = rng.standard_normal((3, 3)).astype(np.float32)
        A[3 * i:3 * i + 3, 3 * i:3 * i + 3] = B @ B.T + 6 * np.eye(3, dtype=np.float32)
        if i + 1 < n:
            C = 0.5 * rng.standard_normal((3, 3)).astype(np.float32)
            A[3 * i:3 * i + 3, 3 * i + 3:3 * i + 6] = C
            A[3 * i + 3:3 * i + 6, 3 * i:3 * i + 3] = C.T
    b = rng.standard_normal((n, 3)).astype(np.float32)
    inv = np.stack([np.linalg.inv(A[3 * i:3 * i + 3, 3 * i:3 * i + 3]) for i in range(n)])
    tol = np.float32(1e-5)

    def ref_mv(v):
        return (jnp.asarray(A) @ v.reshape(-1)).reshape(n, 3)

    def ref_pc(r):
        return jnp.einsum("nij,nj->ni", jnp.asarray(inv), r)

    st = ref_linear.pcg_init(ref_mv, jnp.asarray(b), ref_pc, tol=jnp.float32(tol))
    st = ref_linear.pcg_chunk(ref_mv, st, ref_pc, maxiter=500)
    At, invt = torch.tensor(A), torch.tensor(inv)
    s = DevicePCG.zeros((n, 3), torch.float32, "cpu")
    device_pcg_init(s, torch.tensor(b), lambda r: (invt * r[:, None, :]).sum(-1),
                    torch.tensor(tol), torch.tensor(500))
    while bool(s.active):
        device_pcg_step(s, lambda v: (At @ v.reshape(-1)).reshape(n, 3),
                        lambda r: (invt * r[:, None, :]).sum(-1))
    assert int(s.k) == int(st.k) and bool(s.ok) and bool(st.ok)
    assert _rel(s.x.numpy(), st.x) <= 1e-5
    assert float(torch.sqrt(s.rr)) <= float(s.stop)


@pytest.mark.parametrize("opts", [dict(preconditioner="three_level"),
                                  dict(preconditioner="two_level", coarse_modes=12)],
                         ids=["three_level", "twelve_modes"])
def test_device_loop_takes_every_preconditioner(opts):
    """The three-level space and the 12-mode two-level space on the device
    loop: the host loop's Newton sequence (tests/test_torch_three_level.py
    holds those against the reference)."""
    mesh = box_mesh(6, 6, 6, element_type="tet4", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.1).build()
    runs = [NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(
        **{**BASE, **opts}, device_loop=flag)).solve() for flag in (True, False)]
    assert all(r.converged for r in runs)
    assert _history(runs[0]) == _history(runs[1])
    assert _rel(runs[0].u.numpy(), runs[1].u.numpy()) <= 1e-8


def test_poisoned_residual_bisects_on_both_loops():
    """A non-finite residual is terminal for the increment on both loops:
    each attempt fails and bisects, max_bisections + 1 records, as the
    reference's loops do; the device loop's record keeps the NaN norm."""
    mesh, mat, bc = _problem()
    f_ext = torch.full((mesh.n_nodes, 3), float("nan"), dtype=torch.float64)
    for flag in (True, False):
        res = NewtonSolver(mesh, mat, bc, f_ext=f_ext, options=SolverOptions(
            **BASE, device_loop=flag, max_bisections=2)).solve()
        assert not res.converged and len(res.history) == 3
        scales = [r.load_factor for r in res.history]
        assert scales == [1.0, 0.5, 0.25]
        if flag:
            assert all(r.newton_iters == 1 and r.residual_norms[0] != r.residual_norms[0]
                       for r in res.history)


def test_device_loop_refuses_changed_inputs():
    """The loop is built for the solver's f64 residual route, options,
    boundary conditions and load at its first solve. After a change to any
    of them the solver builds a new loop (the reference reads its inputs
    on every call): the solve equals a fresh solver's under the changed
    inputs bitwise, and the old loop, now stale, refuses to solve."""
    mesh, mat, bc = _problem(3)
    u0 = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    f_ext = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    f_ext[:, 0] = 1e-4
    bc2 = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.08).build()
    solver = NewtonSolver(mesh, mat, bc, options=SolverOptions(**JACOBI))
    assert solver._device_solve(u0, 1.0).n_iters >= 1
    changes = [("_resid_df", True), ("options", SolverOptions(**dict(JACOBI, pcg_tol=1e-3))),
               ("f_ext", f_ext), ("bc", bc2)]
    for name, value in changes:
        old = solver._device_loop
        setattr(solver, name, value)
        assert old.stale()
        out = solver._device_solve(u0, 1.0)
        assert solver._device_loop is not old and not solver._device_loop.stale()
        with pytest.raises(RuntimeError, match="changed after its device loop was built"):
            old.solve(u0, 1.0)
        fresh = NewtonSolver(mesh, mat, solver.bc, f_ext=solver.f_ext, options=solver.options)
        fresh._resid_df = solver._resid_df
        ref = fresh._device_solve(u0, 1.0)
        assert torch.equal(out.u, ref.u) and out.pcg_iters == ref.pcg_iters
        assert out.residual_norms == ref.residual_norms


def test_task_loader_keeps_device_loop_fields(tmp_path):
    """`device_loop` and `device_loop_budget` of a task file reach the
    solver options as the reference's loader reads them."""
    from fea_large_tpu.io.task import load_task as ref_load_task

    data = json.loads((pathlib.Path(__file__).resolve().parent.parent / "tasks"
                       / "block_compression_kuhn.json").read_text())
    data["solver"].update(device_loop=False, device_loop_budget=7)
    path = tmp_path / "task.json"
    path.write_text(json.dumps(data))
    opts, ref = load_task(path, device="cpu").solver, ref_load_task(path).solver
    assert (opts.device_loop, opts.device_loop_budget) == (False, 7)
    assert dataclasses.asdict(opts) == dataclasses.asdict(ref)


def test_device_loop_replays_graphs_on_card():
    """On the card: captured once, replayed; the Newton count and u of the
    host loop (1e-7), repeats bitwise, no kernel wrapper called during a
    replayed solve, and B1-B5 launched by the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loop's graphs and kernels run on the card")
    mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device="cuda")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device="cuda")
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    u = bc.impose(u, 1.0)
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                          options=SolverOptions(**dict(BENCH, resid_df=None)))
    u_d, ok, rec = solver._newton(u, 1.0)
    ticks = dict(sk.LAUNCHES)
    replayed = dict(dl.REPLAYED)
    u_d2, ok2, rec2 = solver._newton(u, 1.0)
    assert sk.LAUNCHES == ticks
    assert all(dl.REPLAYED[f"struct_{k}"] > replayed[f"struct_{k}"] for k in sk.LAUNCHES)
    assert ok and ok2 and torch.equal(u_d, u_d2) and rec.pcg_iters == rec2.pcg_iters
    host = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                        options=SolverOptions(**dict(BENCH, resid_df=None, device_loop=False)))
    u_h, ok_h, rec_h = host._newton(u, 1.0)
    assert ok_h and rec_h.newton_iters == rec.newton_iters
    assert float((u_d - u_h).abs().max() / u_h.abs().max()) <= 1e-7
