"""PyTorch port: the sharded solvers on gloo ranks on the CPU, one process
per shard (`dist.launch.run_sharded`), against the JAX reference's sharded
solvers on the suite's virtual CPU devices and against the port's own
single-device solver (tests/test_torch_dist_partition.py holds the host and
per-shard pieces).

Bounds, relative to max |u|: 1e-10 for the f64 solves (the reference
tests' own), 1e-7 for the mixed two-level solve against the reference's
sharded mixed solve (tests/test_dist.py's), 1e-12 for one shard against
the single-device f64 solve. Newton counts and PCG lists are equal (on the
mixed path since the ranks run CG on the device, its stop tested in f32
as the reference's); the probed coarse matrix is within 5e-6 of the host
Galerkin product's largest entry (tests/test_dist.py's bound). Repeated
solves are bitwise equal. Every rank fetches once per Newton iteration,
once per further PCG chunk and once per restart, the reference's
contract, and holds the same increment records.

The CLI's sharded `run` of tasks/distributed_compression_kuhn.json cut to
2 shards is held against the reference's `run` of that copy, recorded
below (the reference's sharded mixed program takes 55-75 s to compile on
the CPU with a cold compile cache, more than this file's time allows): its
Newton counts, PCG lists, first residual, and the norm and per-component
sums of u; and its u against the port's single-device solve of the same
file (1e-6: the file's newton_rtol is 1e-8).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fea_large_tpu import NeoHookean as RefNH
from fea_large_tpu import StVenantKirchhoff as RefSVK
from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.dist.sharded import ShardedNewtonSolver as RefSharded
from fea_large_tpu.dist.structured_solver import StructuredShardedSolver as RefStructured
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.solvers import multilevel as ref_ml
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch import NeoHookean, StVenantKirchhoff, cli
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.dist import ShardedNewtonSolver, StructuredShardedSolver
from fea_large_tpu_torch.dist.comm import LocalComm
from fea_large_tpu_torch.dist.launch import Problem, run_jobs, run_sharded, solve_rank, step_rank
from fea_large_tpu_torch.io import export
from fea_large_tpu_torch.io.task import load_task
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.solvers import multilevel as ml
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

TASKS = pathlib.Path(__file__).resolve().parent.parent / "tasks"

F64 = dict(linear="pcg", n_steps=1, pcg_tol=1e-13)
MIXED = dict(linear="pcg", n_steps=1, precision="mixed", preconditioner="two_level",
             agg_size=32, forcing="ew", pcg_tol=1e-6, newton_rtol=1e-9, max_newton=60)
PROBE = dict(linear="pcg", precision="mixed", preconditioner="two_level", agg_size=16)
MAXITER = dict(linear="pcg", precision="mixed", preconditioner="jacobi", pcg_tol=1e-30,
               pcg_maxiter=7, pcg_chunk=5)

#: the reference's `run` of tasks/distributed_compression_kuhn.json with
#: partition.n_shards = 2, written to kuhn2.json: `FEA_PLATFORM=cpu
#: XLA_FLAGS=--xla_force_host_platform_device_count=8 python -m fea_large_tpu
#: run kuhn2.json`, with the reference package of commit 63c0e66 (the same
#: numbers with a cold and a warm compile cache): per increment (load
#: factor, Newton count, PCG list, first residual) ...
REFERENCE_KUHN_TASK_2 = [(0.5, 5, [1, 3, 12, 24, 35], 1.858e-01),
                         (1.0, 5, [1, 3, 11, 27, 40], 1.925e-01)]
#: ... and of the final u [N, 3] of kuhn2_final.npz: ||u||_2, the sums of
#: its x, y and z components, and the sums of their absolute values
REFERENCE_KUHN_TASK_2_U = (4.3346912568004745,
                           (-276.6597786850352, -0.6566188842854337, -0.6566189894672887),
                           (276.65977869, 11.43321983, 11.43321984))


def _case(name):
    """(port mesh, material, bc) and the same on the reference."""
    if name == "tet4":
        mesh = box_mesh(4, 2, 2, lx=4.0, element_type="tet4", device="cpu")
        ref = ref_box_mesh(4, 2, 2, lx=4.0, element_type="tet4")
        mats, comp, val = (StVenantKirchhoff(1.0, 1.0), RefSVK(jnp.asarray(1.0), jnp.asarray(1.0))), "x", 0.2
    elif name == "kuhn":
        mesh = box_mesh_kuhn(4, 2, 2, lx=4.0, element_type="tet4", device="cpu")
        ref = ref_box_mesh_kuhn(4, 2, 2, lx=4.0, element_type="tet4")
        mats, comp, val = (StVenantKirchhoff(1.0, 1.0), RefSVK(jnp.asarray(1.0), jnp.asarray(1.0))), "x", 0.15
    elif name == "kuhnnh":
        mesh = box_mesh_kuhn(4, 2, 2, lx=4.0, element_type="tet4", device="cpu")
        ref = ref_box_mesh_kuhn(4, 2, 2, lx=4.0, element_type="tet4")
        mats, comp, val = (NeoHookean(1.0, 0.6), RefNH(jnp.asarray(1.0), jnp.asarray(0.6))), "x", -0.08
    elif name == "tet4nh":
        mesh = box_mesh(4, 2, 2, lx=4.0, element_type="tet4", device="cpu")
        ref = ref_box_mesh(4, 2, 2, lx=4.0, element_type="tet4")
        mats, comp, val = (NeoHookean(1.0, 0.6), RefNH(jnp.asarray(1.0), jnp.asarray(0.6))), "x", -0.08
    else:  # "tet10"
        mesh = box_mesh(3, 2, 2, lx=3.0, element_type="tet10", device="cpu")
        ref = ref_box_mesh(3, 2, 2, lx=3.0, element_type="tet10")
        mats, comp, val = (NeoHookean(1.0, 0.6), RefNH(jnp.asarray(1.0), jnp.asarray(0.6))), "x", -0.08
    bc = DirichletBuilder(mesh).fix("xmin").prescribe("xmax", comp, val).build()
    ref_bc = RefDirichletBuilder(ref).fix("xmin").prescribe("xmax", comp, val).build()
    return (mesh, mats[0], bc), (ref, mats[1], ref_bc)


def _unstructured(problem):
    """The same problem without its lattice structure: the generic path."""
    import dataclasses

    return dataclasses.replace(problem, structure=None)


@pytest.fixture(scope="module")
def runs():
    """The port's sharded runs, two process groups: 2 ranks (TET4 box; the
    neo-Hookean Kuhn box mixed on both paths, its f64 residual through the
    fused kernel and through the plain pass) and 4 ranks (Kuhn box on both
    paths, TET4 box mixed, TET10 box coarse probes)."""
    tet4 = _case("tet4")[0]
    p4, pk, pnh, p10, pknh = (Problem.of(*_case(c)[0])
                              for c in ("tet4", "kuhn", "tet4nh", "tet10", "kuhnnh"))
    jobs2 = [
        (solve_rank, dict(problem=p4, options=SolverOptions(**F64), solves=2)),
        (step_rank, dict(problem=p4, options=SolverOptions(**MAXITER),
                         u0=np.zeros((tet4[0].n_nodes, 3)))),
    ] + [(solve_rank, dict(problem=prob, options=SolverOptions(**MIXED, resid_df=df)))
         for prob in (pknh, _unstructured(pknh)) for df in (True, False)]
    jobs4 = [
        (solve_rank, dict(problem=pk, options=SolverOptions(**F64), solves=2)),
        (solve_rank, dict(problem=_unstructured(pk), options=SolverOptions(**F64))),
        (solve_rank, dict(problem=pnh, options=SolverOptions(**MIXED), solves=2)),
        (solve_rank, dict(problem=p10, options=SolverOptions(**PROBE, coarse_modes=3),
                          solves=0, probe_coarse=True)),
        (solve_rank, dict(problem=p10, options=SolverOptions(**PROBE, coarse_modes=6),
                          solves=0, probe_coarse=True)),
    ]
    r2 = run_sharded(run_jobs, ["cpu"] * 2, jobs2, threads=1)
    r4 = run_sharded(run_jobs, ["cpu"] * 4, jobs4, threads=1)
    assert r2.backend == r4.backend == "gloo"
    return {"tet4": r2.result[0], "maxiter": r2.result[1],
            "df_structured": r2.result[2:4], "df_generic": r2.result[4:6], "kuhn": r4.result[0],
            "kuhn_generic": r4.result[1], "mixed": r4.result[2], "probe3": r4.result[3],
            "probe6": r4.result[4], "ranks2": r2.results, "ranks4": r4.results}


def _single(case, opts):
    mesh, mat, bc = _case(case)[0]
    return NewtonSolver(mesh, mat, bc, options=SolverOptions(**opts)).solve()


def _ref_sharded(case, cls, opts, n):
    ref, mat, bc = _case(case)[1]
    s = cls(ref, mat, bc, options=RefOptions(**opts), devices=jax.devices()[:n])
    res = s.solve()
    assert res.converged
    return s.u_global(res.u), res.history


def _close(u, v, bound):
    scale = np.abs(v).max()
    assert np.abs(u - v).max() <= bound * scale, np.abs(u - v).max() / scale


def _same_records(a, b):
    """Equal increment records, wall times aside."""
    def strip(run):
        return [{k: v for k, v in h.items() if k != "wall_time"} for h in run["history"]]

    return strip(a) == strip(b)


def _pcg(history):
    return [h["pcg_iters"] if isinstance(h, dict) else h.pcg_iters for h in history]


@pytest.mark.parametrize("case,key,n", [("tet4", "tet4", 2), ("kuhn", "kuhn", 4)])
def test_sharded_f64_matches_reference_and_single_device(runs, case, key, n):
    """The generic (TET4 box, 2 shards) and structured (Kuhn box, 4 shards)
    f64 solves: the reference's sharded solve and the port's single-device
    solve within 1e-10, equal Newton counts and PCG lists, and two solves
    bitwise equal."""
    out = runs[key]
    assert out["kind"] == ("StructuredShardedSolver" if case == "kuhn" else "ShardedNewtonSolver")
    a, b = out["runs"]
    assert a["converged"] and np.array_equal(a["u"], b["u"]) and _same_records(a, b)
    cls = RefStructured if case == "kuhn" else RefSharded
    u_ref, hist_ref = _ref_sharded(case, cls, F64, n)
    _close(a["u"], u_ref, 1e-10)
    assert [h["newton_iters"] for h in a["history"]] == [h.newton_iters for h in hist_ref]
    assert _pcg(a["history"]) == _pcg(hist_ref)
    single = _single(case, F64)
    _close(a["u"], single.u.numpy(), 1e-10)
    assert [h["newton_iters"] for h in a["history"]] == [h.newton_iters for h in single.history]


def test_structured_matches_generic(runs):
    """The two sharded paths (boundary-plane hops, indexed halo maps) solve
    the Kuhn box to the same u."""
    assert runs["kuhn_generic"]["kind"] == "ShardedNewtonSolver"
    _close(runs["kuhn"]["runs"][0]["u"], runs["kuhn_generic"]["runs"][0]["u"], 1e-10)


def test_sharded_mixed_two_level_matches_reference(runs):
    """Mixed precision, two-level (3 modes), Eisenstat-Walker forcing on the
    neo-Hookean TET4 box over 4 shards: the reference's sharded mixed solve
    within 1e-7 and the single-device f64 solve within 1e-7, the same
    Newton count, the reference's PCG lists, bitwise repeats."""
    out = runs["mixed"]
    a, b = out["runs"]
    assert a["converged"] and np.array_equal(a["u"], b["u"]) and _same_records(a, b)
    u_ref, hist_ref = _ref_sharded("tet4nh", RefSharded, MIXED, 4)
    _close(a["u"], u_ref, 1e-7)
    assert [h["newton_iters"] for h in a["history"]] == [h.newton_iters for h in hist_ref]
    assert _pcg(a["history"]) == _pcg(hist_ref)
    _close(a["u"], _single("tet4nh", F64).u.numpy(), 1e-7)


def _solve_jobs(runs):
    """(label, every rank's value) of each solve job of the two groups."""
    labels2 = ("tet4", "maxiter", "df_structured", "plain_structured", "df_generic",
               "plain_generic")
    labels4 = ("kuhn", "kuhn_generic", "mixed", "probe3", "probe6")
    for labels, ranks in ((labels2, runs["ranks2"]), (labels4, runs["ranks4"])):
        for j, label in enumerate(labels):
            yield label, [rank[j] for rank in ranks]


def test_sharded_fetches_follow_the_reference_contract(runs):
    """Every rank of both groups runs the eager route (gloo) and fetches
    once per Newton iteration (one per residual norm recorded), once per
    further PCG chunk and once per restart, the reference's sharded loop's
    contract (`jax.device_get` per program). The step of pcg_maxiter 7 in
    chunks of 5 is a prepare and two chunks: three fetches."""
    for label, ranks in _solve_jobs(runs):
        for out in ranks:
            assert out["route"] == "eager", label
            if label == "maxiter":
                assert out["launched"] == {"newton": 0, "chunk": 2, "restart": 1}
                assert out["fetches"] == 3
                continue
            for r in out["runs"]:
                n = r["launched"]
                assert n["newton"] == sum(len(h["residual_norms"]) for h in r["history"])
                assert r["fetches"] == n["newton"] + n["chunk"] + n["restart"] > 0, label


def test_sharded_records_identical_on_every_rank(runs):
    """Every rank holds the same increment records, fetches and programs
    launched as rank 0 (their control flow is driven by the fixed-order
    sums, bitwise the same on every rank)."""
    def rank_view(out):
        if "runs" not in out:  # the step job
            return {k: out[k] for k in ("pcg_iters", "pcg_ok", "lin_rel", "norm0", "norm",
                                        "fetches", "launched")}
        return [([{k: v for k, v in h.items() if k != "wall_time"} for h in r["history"]],
                 r["fetches"], r["launched"], r["converged"]) for r in out["runs"]]

    for label, ranks in _solve_jobs(runs):
        views = [rank_view(out) for out in ranks]
        assert all(v == views[0] for v in views[1:]), label


@pytest.mark.parametrize("path", ["structured", "generic"])
def test_sharded_fused_residual_matches_plain(runs, path, monkeypatch):
    """The mixed two-level solve of the neo-Hookean Kuhn box on 2 ranks
    with the f64 residual through the fused kernel (`resid_df=True`: on
    the CPU the wrappers run B5's and B9's plain versions) and through
    the plain f64 freeze and force: u within 1e-10, the same Newton counts
    and PCG lists, and the route reported. On one shard in this process:
    the rank's residual takes the fused kernel's plain version exactly
    where `resid_df` routes it, within 1e-12 of the plain pass; with
    `resid_df=None` on the CPU and on the f64 path it takes the plain
    pass."""
    fused, plain = runs[f"df_{path}"]
    structured = path == "structured"
    cls = StructuredShardedSolver if structured else ShardedNewtonSolver
    assert fused["kind"] == plain["kind"] == cls.__name__
    assert fused["resid_df"] is True and plain["resid_df"] is False
    a, b = fused["runs"][0], plain["runs"][0]
    assert a["converged"] and b["converged"]
    _close(a["u"], b["u"], 1e-10)
    assert [h["newton_iters"] for h in a["history"]] == [h["newton_iters"] for h in b["history"]]
    assert _pcg(a["history"]) == _pcg(b["history"])

    module, name = (sk, "struct_resid_plain") if structured else (ek, "elem_resid_plain")
    kernel, calls = getattr(module, name), []

    def counted(*args, **kwargs):
        calls.append(name)
        return kernel(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    mesh, mat, bc = _case("kuhnnh")[0]
    r = {}
    for df, opts in ((True, dict(MIXED, resid_df=True)), (False, dict(MIXED, resid_df=False)),
                     (False, dict(MIXED)), (False, dict(F64, resid_df=True))):
        s = cls(mesh, mat, bc, options=SolverOptions(**opts))
        assert s.program_stats()["resid_df"] is df
        before = len(calls)
        r.setdefault(df, s._residual64(s._impose(s.zero_u(), 1.0), 1.0).numpy())
        assert (len(calls) > before) is df
    _close(r[True], r[False], 1e-12)


@pytest.mark.parametrize("case", ["tet4", "kuhn"])
def test_one_shard_chunk_with_sharded_dot_is_the_local_dot(case):
    """At one shard (LocalComm) a `DevicePCGChunk` over the rank's operator
    with the rank's global dot (the ownership-weighted, fixed-order sum)
    is bitwise the chunk with the single-process dot: the same x, r,
    iterations and r.r."""
    from fea_large_tpu_torch.solvers.linear import DevicePCGChunk

    mesh, mat, bc = _case(case)[0]
    cls = StructuredShardedSolver if case == "kuhn" else ShardedNewtonSolver
    opts = SolverOptions(**dict(MIXED, agg_size=8))
    s = cls(mesh, NeoHookean(1.0, 0.6), bc, options=opts)
    u = s._impose(s.zero_u(), 0.5)
    s._step_pcg(u, 0.5)  # freezes the tangent at u and forms the Jacobi blocks
    matvec, precond = s._make_ops(s.coarse)
    out = []
    for dot in (s._dot, None):
        chunk = DevicePCGChunk(matvec, precond, (s.part.n_owned, 3), torch.float32, "cpu",
                               dot=dot)
        chunk.start(s._cell.b, 1e-6)
        st = chunk.run(200)
        out.append((st.x.clone(), st.r.clone(), st.k, st.rr))
    (x1, r1, k1, rr1), (x2, r2, k2, rr2) = out
    assert k1 == k2 > 3 and rr1 == rr2
    assert torch.equal(x1, x2) and torch.equal(r1, r2)


def test_fallback_route_is_block_jacobi():
    """The two-level -> Jacobi fallback route (a zero coarse inverse, made
    at its first use) solves the Newton system as the block-Jacobi solver
    does: the same iterations and x, on one shard; on the CPU neither
    route is captured."""
    mesh, mat, bc = _case("tet4nh")[0]
    two = ShardedNewtonSolver(mesh, mat, bc, options=SolverOptions(**MIXED))
    jac = ShardedNewtonSolver(mesh, mat, bc, options=SolverOptions(
        **dict(MIXED, preconditioner="jacobi")))
    assert "fallback" not in two._routes
    got = []
    for s, route in ((two, "fallback"), (jac, "main")):
        s._cell.scale.fill_(1.0)
        s._cell.u.copy_(s._impose(s.zero_u(), 1.0))
        x, iters, ok, _ = s._drive(route, 1e-6)
        got.append((x.clone(), iters, ok))
    assert set(two._routes) == {"main", "fallback"}
    assert got[0][1] == got[1][1] > 5 and got[0][2] and got[1][2]
    assert torch.equal(got[0][0], got[1][0])
    assert not any(c.captured for c in two._routes.values())
    assert two.program_stats()["graph_nodes"] == {}


@pytest.mark.parametrize("modes", [3, 6])
def test_sharded_probed_coarse_matches_host(runs, modes):
    """The coarse matrix probed through the sharded tangent action (4
    shards) against the reference's host f64 Galerkin product
    (`_host_coarse_matrix[_rbm]` of fea_large_tpu.solvers.multilevel) on
    the same aggregation, and the port's host product against it."""
    out = runs[f"probe{modes}"]
    mesh, _, bc = _case("tet10")[0]
    ref_mesh, _, ref_bc = _case("tet10")[1]
    free, ref_free = bc.free_mask.numpy(), np.asarray(ref_bc.free_mask)
    if modes == 3:
        ref = ref_ml._host_coarse_matrix(ref_mesh, 1.0, 0.6, out["agg"], out["n_agg"], ref_free)
        host = ml._host_coarse_matrix(mesh, 1.0, 0.6, out["agg"], out["n_agg"], free)
    else:
        ref = ref_ml._host_coarse_matrix_rbm(ref_mesh, 1.0, 0.6, out["agg"], out["dvec"],
                                             out["n_agg"], ref_free)
        host = ml._host_coarse_matrix_rbm(mesh, 1.0, 0.6, out["agg"], out["dvec"], out["n_agg"],
                                          free)
    assert np.abs(out["coarse_matrix"] - ref).max() < 5e-6 * np.abs(ref).max()
    assert np.abs(host - ref).max() <= 1e-12 * np.abs(ref).max()


def test_sharded_pcg_maxiter_is_a_hard_bound(runs):
    """With an unreachable tolerance and pcg_maxiter 7, not a multiple of
    pcg_chunk 5, the sharded PCG stops after exactly 7 iterations."""
    out = runs["maxiter"]
    assert out["pcg_iters"] == 7 and not out["pcg_ok"]


@pytest.mark.parametrize("case", ["tet4", "kuhn"])
def test_single_shard_matches_single_device(case):
    """One shard in this process (LocalComm): the single-device f64 solve
    within 1e-12."""
    mesh, mat, bc = _case(case)[0]
    cls = StructuredShardedSolver if case == "kuhn" else ShardedNewtonSolver
    s = cls(mesh, mat, bc, options=SolverOptions(**F64))
    res = s.solve()
    assert res.converged
    _close(s.u_global(res.u), _single(case, F64).u.numpy(), 1e-12)


def test_structured_shards_keep_the_quadrature_rule():
    """The structured solver builds its shards' local box with the mesh's
    quadrature override (the reference builds it with the default rule):
    a TET10 Kuhn box with the 5-point rule, one shard, against the
    single-device f64 solve of the same mesh within 1e-10 (the two f64
    routes converge ~1e-12 apart; the 4-point rule moves u by 1.6e-5)."""
    mesh = box_mesh_kuhn(4, 2, 2, lx=4.0, element_type="tet10", device="cpu", n_quad=5)
    bc = DirichletBuilder(mesh).fix("xmin").prescribe("xmax", "x", -0.08).build()
    mat = NeoHookean(1.0, 0.6)
    s = StructuredShardedSolver(mesh, mat, bc, options=SolverOptions(**F64))
    res = s.solve()
    single = NewtonSolver(mesh, mat, bc, options=SolverOptions(**F64)).solve()
    assert res.converged and single.converged
    _close(s.u_global(res.u), single.u.numpy(), 1e-10)


def test_poisoned_residual_bisects_on_the_sharded_solver():
    """A non-finite residual fails every increment of a one-rank sharded
    solve (a `LocalComm` on the CPU), which bisects as the single-device
    loops do (tests/test_torch_device_loop.py): max_bisections + 1
    records, at load factors 1, 1/2 and 1/4, each of one Newton launch."""
    mesh = box_mesh(2, 2, 2, element_type="tet4", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    f_ext = torch.full((mesh.n_nodes, 3), float("nan"), dtype=torch.float64)
    s = ShardedNewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, f_ext=f_ext,
                            options=SolverOptions(**MAXITER, max_bisections=2),
                            comm=LocalComm("cpu"))
    res = s.solve()
    assert not res.converged and len(res.history) == 3
    assert [r.load_factor for r in res.history] == [1.0, 0.5, 0.25]
    assert s.launched == {"newton": 3, "chunk": 0, "restart": 0}


def test_sharded_rejects_three_level():
    mesh, mat, bc = _case("tet4")[0]
    with pytest.raises(ValueError, match="two_level"):
        ShardedNewtonSolver(mesh, mat, bc, options=SolverOptions(
            linear="pcg", precision="mixed", preconditioner="three_level"))


def test_a_failing_rank_reaches_the_caller():
    """Rank 1 raises (its device, `meta`, holds no data) while rank 0 waits
    for it in a collective: run_sharded raises instead of hanging."""
    import torch.multiprocessing as mp

    problem = Problem.of(*_case("tet4")[0])
    with pytest.raises(mp.ProcessRaisedException, match="(?i)process 1 terminated"):
        run_sharded(solve_rank, ["cpu", "meta"], problem, SolverOptions(**F64), timeout_s=60)


def test_cli_sharded_run_matches_reference(tmp_path, monkeypatch):
    """`run` of tasks/distributed_compression_kuhn.json cut to 2 shards, on 2
    gloo ranks (FEA_PLATFORM=cpu): the reference's increments, Newton
    counts, PCG lists within one iteration and first residual; the
    reference's ||u|| and component sums within 1e-6 (relative to ||u||
    and to each component's sum of |u|); and u within 1e-6 of the
    single-device solve of the same file."""
    monkeypatch.setenv("FEA_PLATFORM", "cpu")
    data = json.loads((TASKS / "distributed_compression_kuhn.json").read_text())
    data["partition"]["n_shards"] = 2
    task_file = tmp_path / "kuhn2.json"
    task_file.write_text(json.dumps(data))
    assert cli.main(["run", str(task_file), "--out", str(tmp_path / "out")]) == 0
    conv = json.loads((tmp_path / "out" / "kuhn2_convergence.json").read_text())
    assert conv["converged"] and len(conv["steps"]) == len(REFERENCE_KUHN_TASK_2)
    for step, (lf, newton, pcg, r0) in zip(conv["steps"], REFERENCE_KUHN_TASK_2):
        assert step["load_factor"] == lf and step["newton_iters"] == newton
        assert len(step["pcg_iters"]) == len(pcg)
        assert all(abs(a - b) <= 1 for a, b in zip(step["pcg_iters"], pcg))
    assert abs(conv["steps"][0]["residual_norms"][0] - 1.858e-01) <= 5e-4
    u = export.load_checkpoint(tmp_path / "out" / "kuhn2_final.npz")["u"]
    norm, sums, abs_sums = REFERENCE_KUHN_TASK_2_U
    assert abs(np.linalg.norm(u) - norm) <= 1e-6 * norm
    assert np.all(np.abs(u.sum(axis=0) - sums) <= 1e-6 * np.asarray(abs_sums))
    task = load_task(task_file, device="cpu")
    ref = NewtonSolver(task.mesh, task.material, task.build_bc(), options=task.solver).solve()
    assert ref.converged
    _close(u, ref.u.numpy(), 1e-6)
