"""PyTorch port: the device PCG chunk (`linear.DevicePCGChunk`, the
reference's `pcg_init` + `pcg_chunk`, a `lax.while_loop` whose condition
lives on the device) and the solver routes that run it, against the JAX
reference.

  (a) the chunk, its bodies run eagerly on the CPU, against the
      reference's `pcg_init` + `pcg_chunk` on a seeded SPD block system of
      201 DOF with prescribed rows, in f32 and in f64: x within 2e-5 /
      1e-12 of max |x|, k and ok equal; the stop formed as the reference
      forms it in the vectors' dtype (bitwise, given the same b.b; within
      1e-6 / 1e-14 with each package's own dot), and x0 given (r0 = b -
      A x0, x0 may be the chunk's own x);
  (b) resumability: two runs of 5 are bitwise one run of 10;
  (c) an indefinite operator breaks down (ok False) at the reference's
      iteration; a non-finite r.r ends the run as a breakdown, as the
      reference's `pcg_chunk` reports it;
  (d) `drive_chunked_pcg` over the chunk returns the best iterate, a
      clone, where the last one is worse (the chunk writes its x in place);
      one fetch per chunk; the solve and its restart (the chunk's restart
      program, `_pcg_with_restart`) against the reference's
      `_pcg_with_restart` in f64 (x within 1e-12 of max |x|), one fetch,
      the restart running no iteration where the first run spent the whole
      budget;
  (e) the routes against the reference: `_step` on `pcg_bcsr` and `pcg`
      (f64, TET10 box 2^3: u within 1e-12, the same PCG count), on the
      mixed Kuhn (n=3) and 5-tet (n=3) boxes with bench.py's step options
      (u within 2e-5 of the increment's max, the same count), `step_fn` on
      the mixed Kuhn box, and the host Newton loop (`_newton_mixed_host`,
      5-tet n=3: the Newton count and PCG list equal, u within 2e-5);
      fetches per step (the f64 steps one, the mixed step two) and per
      solve;
  (f) on the card (skips here): each route's graph chunk bitwise the
      eager chunk on the same card, one fetch per run or restart. It runs where JAX
      is not installed: `python -m pytest --noconftest -k on_card
      tests/test_torch_pcg_chunk.py`.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX: only the `_on_card` tests run there
    import jax.numpy as jnp

    from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
    from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
    from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
    from fea_large_tpu.solvers import linear as ref_linear
    from fea_large_tpu.solvers import newton as ref_newton
    from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
    from fea_large_tpu.solvers.newton import SolverOptions as RefOptions
except ImportError:
    jnp = ref_box_mesh = ref_box_mesh_kuhn = None

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import cuda_graphs
from fea_large_tpu_torch.solvers import linear
from fea_large_tpu_torch.solvers import newton as nm
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

#: the vectors' dtypes of the chunk's two uses (the mixed and the f64
#: paths): (torch dtype, jax dtype name, bound on x relative to max |x|,
#: bound on the stop across the two packages' dots)
DTYPES = {"f32": (torch.float32, "float32", 2e-5, 1e-6),
          "f64": (torch.float64, "float64", 1e-12, 1e-14)}
#: bench.py's FEA_BENCH_MODE=step options, and its solve's (forcing EW)
STEP = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
            forcing="fixed", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000)
SOLVE = dict(STEP, forcing="ew", agg_size=8, device_loop=False, resid_df=False)
#: the f64 steps' options: config 2's pcg_tol (tests/test_parity.py), so
#: that both packages' solves are converged to their rounding
F64 = dict(pcg_tol=1e-13, pcg_maxiter=500)


def _system(seed=7, n_nodes=67, indefinite=False):
    """A seeded SPD block system A = B B^T / n + I / 2 (201 DOF) masked to its
    free rows (M A M + (I - M)), b masked, and A's nodal diagonal blocks;
    `indefinite` shifts A by -1.5 times its mean eigenvalue."""
    rng = np.random.default_rng(seed)
    n = 3 * n_nodes
    B = rng.standard_normal((n, n)) / math.sqrt(n)
    A = B @ B.T + 0.5 * np.eye(n)
    if indefinite:
        A = A - 1.5 * np.trace(A) / n * np.eye(n)
    free = np.ones((n_nodes, 3))
    free[:3] = 0.0
    free[10, 2] = 0.0
    fv = free.reshape(-1)
    Am = A * fv[:, None] * fv[None, :] + np.diag(1.0 - fv)
    diag = np.stack([Am[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(n_nodes)])
    b = rng.standard_normal((n_nodes, 3)) * free
    return Am, b, free, diag


def _port_ops(Am, free, diag, dtype):
    N = free.shape[0]
    At = torch.tensor(Am, dtype=dtype)
    ft = torch.tensor(free, dtype=dtype)
    inv = linear.jacobi_inverse_blocks(torch.tensor(diag, dtype=dtype), ft)
    return (lambda v: (At @ v.reshape(-1)).reshape(N, 3),
            lambda r: linear.apply_block_jacobi(inv, ft, r))


def _ref_ops(Am, free, diag, jdt):
    N = free.shape[0]
    Aj = jnp.asarray(Am, dtype=jdt)
    fj = jnp.asarray(free, dtype=jdt)
    inv = ref_linear.jacobi_inverse_blocks(jnp.asarray(diag, dtype=jdt), fj)
    return (lambda v: (Aj @ v.reshape(-1)).reshape(N, 3),
            lambda r: ref_linear.apply_block_jacobi(inv, fj, r))


def _chunk(Am, free, diag, dtype, **kw):
    mv, pc = _port_ops(Am, free, diag, dtype)
    return linear.DevicePCGChunk(mv, pc, free.shape, dtype, "cpu", **kw)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_chunk_matches_reference(dt):
    dtype, jname, bound, stop_bound = DTYPES[dt]
    jdt = getattr(jnp, jname)
    Am, b, free, diag = _system()
    tol = 1e-5 if dt == "f32" else 1e-10
    rmv, rpc = _ref_ops(Am, free, diag, jdt)
    ref0 = ref_linear.pcg_init(rmv, jnp.asarray(b, dtype=jdt), rpc, tol=jnp.asarray(tol, jdt))
    ref = ref_linear.pcg_chunk(rmv, ref0, rpc, maxiter=500)
    chunk = _chunk(Am, free, diag, dtype)
    chunk.start(torch.tensor(b, dtype=dtype), tol)
    assert not chunk.captured and chunk.fetch().k == 0
    st = chunk.run(500)
    x_r = np.asarray(ref.x)
    assert st.k == int(ref.k) and st.ok == bool(ref.ok) and st.ok
    assert np.abs(st.x.numpy() - x_r).max() <= bound * np.abs(x_r).max()
    assert math.sqrt(st.rr) <= st.stop
    # the stop: the reference's formula in the vectors' dtype, bitwise
    # given the port's b.b, and close with the reference's own dot
    b_t = torch.tensor(b, dtype=dtype)

    def port_dot(a, c):
        pa, pc = (torch.tensor(np.asarray(t), dtype=dtype).reshape(-1) for t in (a, c))
        return jnp.asarray(torch.dot(pa, pc).numpy())

    same_dot = ref_linear.pcg_init(rmv, jnp.asarray(b, dtype=jdt), rpc,
                                   tol=jnp.asarray(tol, jdt), dot=port_dot)
    assert np.asarray(same_dot.stop).dtype == np.dtype(jname)
    assert st.stop == float(same_dot.stop)
    assert chunk.state.stop.dtype == dtype and chunk.state.stop.item() == st.stop
    assert abs(st.stop - float(ref.stop)) <= stop_bound * float(ref.stop)
    assert st.bnorm == float(torch.sqrt(torch.dot(b_t.reshape(-1), b_t.reshape(-1))))
    # from x0: r0 = b - A x0, as the reference's pcg_init with x0
    x0 = np.asarray(ref0.x) + 0.1 * np.asarray(rpc(jnp.asarray(b, dtype=jdt)))
    ref_x0 = ref_linear.pcg_chunk(rmv, ref_linear.pcg_init(
        rmv, jnp.asarray(b, dtype=jdt), rpc, x0=jnp.asarray(x0, dtype=jdt),
        tol=jnp.asarray(tol, jdt)), rpc, maxiter=500)
    chunk.start(b_t, tol, x0=torch.tensor(x0, dtype=dtype))
    st_x0 = chunk.run(500)
    assert st_x0.k == int(ref_x0.k) and st_x0.ok
    x_r = np.asarray(ref_x0.x)
    assert np.abs(st_x0.x.numpy() - x_r).max() <= bound * np.abs(x_r).max()
    # the restart from the chunk's own x: already converged, no iteration
    chunk.start(None, tol, x0=chunk.state.x)
    again = chunk.run(500)
    assert again.k == 0 and again.ok and torch.equal(again.x, st_x0.x)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_chunk_runs_resume_bitwise(dt):
    dtype = DTYPES[dt][0]
    Am, b, free, diag = _system(seed=8)
    b_t = torch.tensor(b, dtype=dtype)
    one, two = _chunk(Am, free, diag, dtype), _chunk(Am, free, diag, dtype)
    one.start(b_t, 1e-30)
    st10 = one.run(10)
    two.start(b_t, 1e-30)
    assert two.run(5).k == 5
    st5 = two.run(5)
    assert st10.k == st5.k == 10 and st10.rr == st5.rr and st10.ok and st5.ok
    for name in ("x", "r", "z", "p", "rz"):
        assert torch.equal(getattr(one.state, name), getattr(two.state, name)), name
    assert one.fetches == 1 and two.fetches == 2


def test_indefinite_operator_breaks_down_at_the_reference_iteration():
    Am, b, free, diag = _system(seed=9, indefinite=True)
    rmv, _ = _ref_ops(Am, free, diag, jnp.float64)
    ref = ref_linear.pcg_chunk(rmv, ref_linear.pcg_init(rmv, jnp.asarray(b), tol=1e-10),
                               maxiter=500)
    mv, _ = _port_ops(Am, free, diag, torch.float64)
    chunk = linear.DevicePCGChunk(mv, lambda r: r, free.shape, torch.float64, "cpu")
    chunk.start(torch.tensor(b), 1e-10)
    st = chunk.run(500)
    assert not bool(ref.ok) and not st.ok
    assert st.k == int(ref.k) < 500


def test_non_finite_rr_ends_as_a_breakdown():
    """A product that overflows f32 makes r.r NaN after one iteration: the
    run ends there with ok False (the reference's `pcg_chunk` likewise),
    and a further run runs no iteration."""
    Am, b, free, diag = _system(seed=10)
    big = 3e38
    rmv, _ = _ref_ops(Am, free, diag, jnp.float32)
    ref = ref_linear.pcg_chunk(lambda v: rmv(v) * big, ref_linear.pcg_init(
        lambda v: rmv(v) * big, jnp.asarray(b, dtype=jnp.float32),
        tol=jnp.asarray(1e-6, jnp.float32)), maxiter=50)
    mv, _ = _port_ops(Am, free, diag, torch.float32)
    chunk = linear.DevicePCGChunk(lambda v: mv(v) * big, lambda r: r, free.shape,
                                  torch.float32, "cpu")
    chunk.start(torch.tensor(b, dtype=torch.float32), 1e-6)
    st = chunk.run(50)
    assert not math.isfinite(st.rr) and not st.ok
    assert not bool(ref.ok) and st.k == int(ref.k) == 1
    assert chunk.run(50).k == 1


def _non_monotone(Am, b, dtype, maxiter=60):
    """(k_best, k_end): r.r at k_end above twice its least over 0..k_end-1,
    taken at k_best >= 1, and far above rounding, for CG without a
    preconditioner on Am (||r|| is not monotone in CG)."""
    mv, _ = _port_ops(Am, np.ones(b.shape), np.stack([np.eye(3)] * b.shape[0]), dtype)
    chunk = linear.DevicePCGChunk(mv, lambda r: r, b.shape, dtype, "cpu")
    chunk.start(torch.tensor(b, dtype=dtype), 1e-30)
    rrs = [chunk.fetch().rr] + [chunk.run(1).rr for _ in range(maxiter)]
    for k_end in range(2, maxiter + 1):
        k_best = int(np.argmin(rrs[:k_end]))
        if k_best >= 1 and rrs[k_end] > 2.0 * rrs[k_best] and rrs[k_end] > 1e-12 * rrs[0]:
            return k_best, k_end
    raise AssertionError("no non-monotone residual in this system")


def test_drive_returns_the_cloned_best_iterate():
    """`drive_chunked_pcg` over the chunk, one iteration a chunk, up to an
    iteration whose residual is worse than an earlier one: the earlier
    iterate comes back (a clone: the chunk's x is the last iterate by
    then), bitwise the chunk's iterate at that count. One fetch per chunk,
    the set-up's included."""
    rng = np.random.default_rng(12)
    n_nodes = 67
    Q, _ = np.linalg.qr(rng.standard_normal((3 * n_nodes, 3 * n_nodes)))
    A = Q @ np.diag(np.geomspace(1e-4, 1.0, 3 * n_nodes)) @ Q.T
    b = rng.standard_normal((n_nodes, 3))
    k_best, k_end = _non_monotone(A, b, torch.float64)
    mv, _ = _port_ops(A, np.ones(b.shape), np.stack([np.eye(3)] * n_nodes), torch.float64)
    chunk = linear.DevicePCGChunk(mv, lambda r: r, b.shape, torch.float64, "cpu")
    b_t = torch.tensor(b)

    def prepare(x0):
        chunk.start(b_t, 1e-30, x0=x0)
        return chunk.fetch()

    x, total, converged, rel = linear.drive_chunked_pcg(
        prepare, lambda st, n: chunk.run(n), tol=1e-30, chunk_iters=1, maxiter=k_end)
    assert total == k_end and not converged
    assert chunk.fetches == k_end + 1
    assert x is not chunk.state.x and not torch.equal(x, chunk.state.x)
    replay = linear.DevicePCGChunk(mv, lambda r: r, b.shape, torch.float64, "cpu")
    replay.start(b_t, 1e-30)
    assert replay.run(k_best).k == k_best
    assert torch.equal(x, replay.state.x)


def test_drive_fetches_once_per_chunk():
    Am, b, free, diag = _system(seed=13)
    chunk = _chunk(Am, free, diag, torch.float64)
    b_t = torch.tensor(b)

    def prepare(x0):
        chunk.start(b_t, 1e-12, x0=x0)
        return chunk.run(4) if x0 is None else chunk.fetch()

    x, total, converged, _ = linear.drive_chunked_pcg(
        prepare, lambda st, n: chunk.run(n), tol=1e-12, chunk_iters=4, maxiter=500)
    assert converged and total > 8
    assert chunk.fetches == math.ceil(total / 4)
    assert int(chunk.runs[3]) == total  # the step body ran once per iteration


#: `_pcg_with_restart` cases: (seed, indefinite, tol, pcg_maxiter); the
#: indefinite one without a preconditioner, as the breakdown test above
RESTART = {"budget_spent": (7, False, 1e-13, 7), "converged": (7, False, 1e-10, 500),
           "breakdown": (9, True, 1e-10, 500)}


@pytest.mark.parametrize("case", list(RESTART))
def test_restart_matches_reference(case):
    """The f64 steps' PCG, a solve and its restart on the chunk's restart
    program (`_pcg_with_restart`: one launch, one fetch), against the
    reference's `_pcg_with_restart`: the same iterations and converged
    flag, x within 1e-12 of max |x| and the final ||r|| within 1e-12 of
    ||b|| of the reference's. Where the first run spends the whole budget the restart
    gets none and runs no iteration: the step body runs pcg_maxiter times
    in all."""
    seed, indefinite, tol, maxiter = RESTART[case]
    Am, b, free, diag = _system(seed=seed, indefinite=indefinite)
    rmv, rpc = _ref_ops(Am, free, diag, jnp.float64)
    mv, pc = _port_ops(Am, free, diag, torch.float64)
    if indefinite:
        rpc = pc = None
    ref = ref_newton._pcg_with_restart(rmv, jnp.asarray(b), rpc, tol, maxiter)
    chunk = linear.DevicePCGChunk(mv, pc or (lambda r: r), free.shape, torch.float64, "cpu")
    x, iters, ok, rel = nm._pcg_with_restart(chunk, torch.tensor(b), tol, maxiter)
    assert iters == int(ref.iterations) and ok == bool(ref.converged)
    assert ok == (case == "converged")
    x_r = np.asarray(ref.x)
    assert np.abs(x.numpy() - x_r).max() <= 1e-12 * np.abs(x_r).max()
    rel_r = float(ref.residual_norm) / float(np.linalg.norm(b))
    assert abs(rel - rel_r) <= 1e-12  # ||r|| / ||b||: 1e-12 of ||b||
    assert chunk.fetches == 1
    runs = dict(zip(chunk.BODIES, chunk.runs.tolist()))
    assert runs["init0"] == runs["initx"] == runs["keep"] == 1 and runs["step"] == iters
    assert bool(chunk.ok1) == (case != "breakdown")  # the first run's ok
    if case == "budget_spent":
        assert iters == maxiter and int(chunk.k1) == maxiter and int(chunk.state.k) == 0


# -- the routes ----------------------------------------------------------------

def _affine(coords, comp):
    u = np.zeros(coords.shape)
    u[:, 2] = comp * coords[:, 2]
    return u


class _Pair:
    """Both packages' solvers on one TET10 box, load and options, and the
    imposed affine start (torch, jax)."""

    def __init__(self, build, ref_build, n, load, opts, comp, device="cpu"):
        self.mesh = build(n, n, n, element_type="tet10", device=device)
        bc = DirichletBuilder(self.mesh).fix("zmin").prescribe("zmax", "z", load).build()
        self.port = NewtonSolver(self.mesh, NeoHookean(1.0, 0.6), bc,
                                 options=SolverOptions(**opts))
        u = _affine(self.mesh.coords.cpu().numpy(), comp)
        self.u = self.port.bc.impose(torch.tensor(u, device=device), 1.0)
        if ref_build is None:
            return
        ref_mesh = ref_build(n, n, n, element_type="tet10")
        ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", load).build()
        self.ref = RefNewtonSolver(ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                                   options=RefOptions(**opts))
        self.u_ref = self.ref.bc.impose(jnp.asarray(u), jnp.asarray(1.0))


#: route -> (port mesh builder, reference builder name, n, load, options,
#: start compression, bound on u relative to the increment's max)
ROUTES = {
    "pcg_bcsr": (box_mesh, "box_mesh", 2, -0.2, dict(F64, linear="pcg_bcsr"), -0.2, 1e-12),
    "pcg": (box_mesh, "box_mesh", 2, -0.2, dict(F64, linear="pcg"), -0.2, 1e-12),
    "mixed_kuhn": (box_mesh_kuhn, "box_mesh_kuhn", 3, -0.05, STEP, -0.05, 2e-5),
    "mixed_5tet": (box_mesh, "box_mesh", 3, -0.05, STEP, -0.05, 2e-5),
}


def _pair(route, device="cpu", reference=True):
    build, ref_name, n, load, opts, comp, _ = ROUTES[route]
    ref_build = None
    if reference:
        ref_build = {"box_mesh": ref_box_mesh, "box_mesh_kuhn": ref_box_mesh_kuhn}[ref_name]
    return _Pair(build, ref_build, n, load, opts, comp, device)


def _fetches(solver):
    return sum(c.fetches for r in solver._routes.values() for c in r.chunks.values())


@pytest.mark.parametrize("route", list(ROUTES) + ["step_fn", "host_loop"])
def test_route_matches_reference(route):
    """Each single-device CG route on the chunk against the reference: u
    within the route's bound of the increment's max |u - u0|, the same PCG
    counts; the fetches a step (the f64 steps: one, the solve and its
    restart in one launch; the mixed step: two, the set-up's and one
    run's)."""
    if route == "host_loop":
        pair = _Pair(box_mesh, ref_box_mesh, 3, -0.05, SOLVE, -0.05)
        u_p, ok_p, rec_p = pair.port._newton_mixed_host(pair.u, 1.0)
        u_r, ok_r, rec_r = pair.ref._newton(pair.u_ref, jnp.asarray(1.0))
        assert ok_p and bool(ok_r)
        assert rec_p.newton_iters == rec_r.newton_iters
        assert rec_p.pcg_iters == [int(k) for k in rec_r.pcg_iters]
        fetches = _fetches(pair.port)
        assert 0 < fetches <= 2 * len(rec_p.pcg_iters)  # one a run of pcg_chunk
        bound = 2e-5
    elif route == "step_fn":
        pair = _pair("mixed_kuhn")
        u_r, k_r, ok_r, _ = pair.ref.step_fn(pair.u_ref, jnp.asarray(1.0))
        u_p, k_p, ok_p, _ = pair.port.step_fn(pair.u, 1.0)
        assert bool(ok_r) and ok_p and k_p == int(k_r)
        assert _fetches(pair.port) == 1
        bound = 2e-5
    else:
        pair = _pair(route)
        bound = ROUTES[route][-1]
        mixed = route.startswith("mixed")
        r_ref = pair.ref._residual(pair.u_ref, jnp.asarray(1.0))[0] if mixed else None
        u_r, k_r, ok_r, _ = pair.ref._step(pair.u_ref, jnp.asarray(1.0), r64=r_ref)
        r64 = pair.port._residual(pair.u, 1.0)[0] if mixed else None
        u_p, k_p, ok_p, rel_p = pair.port._step(pair.u, 1.0, r64=r64)
        assert bool(ok_r) and ok_p and k_p == int(k_r)
        per_step = 2 if mixed else 1
        assert _fetches(pair.port) == per_step
        again = pair.port._step(pair.u, 1.0, r64=r64)
        assert torch.equal(again[0], u_p) and again[1] == k_p
        assert _fetches(pair.port) == 2 * per_step
    u_r = np.asarray(u_r)
    x_r = u_r - np.asarray(pair.u_ref)
    assert np.abs(u_p.numpy() - u_r).max() <= bound * np.abs(x_r).max()


def test_route_rebuilds_on_changed_inputs():
    """A route is built once per solver and kept (its chunks' bodies are
    the same objects at the next step); changed options build it anew, and
    the rebuilt step is bitwise a fresh solver's."""

    pair = _pair("pcg_bcsr", reference=False)
    solver = pair.port
    first = solver._step(pair.u, 1.0)
    route = solver._routes["pcg_bcsr"]
    solver._step(pair.u, 1.0)
    assert solver._routes["pcg_bcsr"] is route
    solver.options = dataclasses.replace(solver.options, pcg_maxiter=7)
    capped = solver._step(pair.u, 1.0)
    assert solver._routes["pcg_bcsr"] is not route and capped[1] <= 7 < first[1]
    fresh = NewtonSolver(pair.mesh, NeoHookean(1.0, 0.6), solver.bc, options=solver.options)
    again = fresh._step(pair.u, 1.0)
    assert torch.equal(again[0], capped[0]) and again[1] == capped[1]


# -- on the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk's graphs run on the card")


def test_chunk_graph_is_the_eager_chunk_on_card():
    """On the card: the captured chunk (WHILE node) against its bodies run
    eagerly on the same card, f32 and f64: bitwise x, the same k, ok and
    stop, one fetch per run, and the step body's replays counted; then the
    restart program with a budget the first run spends (7 iterations, no
    restart), one fetch, bitwise the eager one's."""
    _card()
    for dtype in (torch.float32, torch.float64):
        Am, b, free, diag = _system()
        runs = []
        for capture in (True, False):
            At = torch.tensor(Am, dtype=dtype, device="cuda")
            ft = torch.tensor(free, dtype=dtype, device="cuda")
            inv = linear.jacobi_inverse_blocks(torch.tensor(diag, dtype=dtype, device="cuda"), ft)
            chunk = linear.DevicePCGChunk(
                lambda v, At=At: (At @ v.reshape(-1)).reshape(-1, 3),
                lambda r, inv=inv, ft=ft: linear.apply_block_jacobi(inv, ft, r),
                free.shape, dtype, "cuda", capture=capture)
            assert chunk.captured == capture
            b_t = torch.tensor(b, dtype=dtype, device="cuda")
            chunk.start(b_t, 1e-6)
            first = chunk.run(7)
            st = chunk.run(500)
            runs.append((first.k, st.k, st.ok, st.stop, st.x.clone(), chunk.fetches,
                         int(chunk.runs[3])))
            k1, _, again = chunk.restart(b_t, 1e-6, 7)  # the budget spent: no restart
            runs[-1] += (k1, again.k, again.x.clone(), chunk.fetches)
        (k1, k, ok, stop, x, fetches, steps, r1, r2, rx, rf), eager = runs[0], runs[1]
        assert k1 == 7 and ok and fetches == 2 and steps == k
        assert (r1, r2, rf) == (7, 0, 3)
        assert (k1, k, ok, stop, r1, r2) == (eager[:4] + eager[7:9])
        assert torch.equal(x, eager[4]) and torch.equal(rx, eager[9])


@pytest.mark.parametrize("route", list(ROUTES) + ["step_fn", "host_loop"])
def test_route_graph_is_the_eager_chunk_on_card(route):
    """On the card: each route with its chunks captured against the same
    route with the chunks' bodies run eagerly (`_capture_chunks=False`):
    bitwise u, the same counts; the graphs' kernel launches counted as
    replays, the fetches one a run (never one an iteration)."""
    _card()
    out = {}
    for capture in (None, False):
        if route == "host_loop":
            pair = _Pair(box_mesh, None, 3, -0.05, SOLVE, -0.05, device="cuda")
        else:
            pair = _pair("mixed_kuhn" if route == "step_fn" else route, "cuda", False)
        solver = pair.port
        solver._capture_chunks = capture
        before = dict(cuda_graphs.REPLAYED)
        if route == "host_loop":
            u, ok, rec = solver._newton_mixed_host(pair.u, 1.0)
            assert ok
            iters = rec.pcg_iters
        elif route == "step_fn":
            u, k, ok, _ = solver.step_fn(pair.u, 1.0)
            iters = [k]
        else:
            u, k, ok, _ = solver._step(pair.u, 1.0)
            iters = [k]
        replayed = {k: v - before[k] for k, v in cuda_graphs.REPLAYED.items() if v > before[k]}
        captured = {c.captured for r in solver._routes.values() for c in r.chunks.values()}
        out[capture] = (u, iters, replayed, _fetches(solver), captured)
    (u_g, it_g, rep_g, f_g, cap_g), (u_e, it_e, rep_e, f_e, cap_e) = out[None], out[False]
    assert cap_g == {True} and cap_e == {False}
    assert it_g == it_e and torch.equal(u_g, u_e)
    assert f_g == f_e and f_g < sum(it_g) and not rep_e
    # the matrix-free product is plain PyTorch: no kernel to replay there
    assert bool(rep_g) == (route != "pcg")
