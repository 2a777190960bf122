"""PyTorch port: the routes of the sharded ranks' programs
(dist/sharded.py). A rank runs the reference's sharded programs (a Newton
iteration, a further PCG chunk, a restart: one launch and one fetch each)
captured into CUDA graphs where its comm can be captured (NCCL, or one
rank on a card), and the same bodies eagerly elsewhere (gloo; the CPU).

The CPU tests hold the route to the comm; the `_on_card` tests (skipped
without a card; the card's machine has no JAX, and this file imports none)
hold one rank's captured route to its eager route on the card, bitwise,
with the fetch contract. tests/test_torch_dist.py holds the eager route on
gloo ranks to the reference's sharded solves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.dist import ShardedNewtonSolver, StructuredShardedSolver
from fea_large_tpu_torch.dist.comm import Comm, LocalComm
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import cuda_graphs
from fea_large_tpu_torch.solvers.newton import SolverOptions

torch.set_num_threads(2)

MIXED = dict(linear="pcg", n_steps=2, precision="mixed", preconditioner="two_level",
             agg_size=16, forcing="ew", pcg_tol=1e-6, newton_rtol=1e-9, max_newton=60)
#: an unreachable tolerance with pcg_maxiter 7 in chunks of 3: a restart
#: (the prepare from zero) and three further chunks
MAXITER = dict(linear="pcg", precision="mixed", preconditioner="jacobi", pcg_tol=1e-30,
               pcg_maxiter=7, pcg_chunk=3)

SOLVERS = {"tet4": (ShardedNewtonSolver, box_mesh), "kuhn": (StructuredShardedSolver, box_mesh_kuhn)}


def _problem(case, device):
    cls, build = SOLVERS[case]
    mesh = build(4, 2, 2, lx=4.0, element_type="tet4", device=device)
    bc = DirichletBuilder(mesh).fix("xmin").prescribe("xmax", "x", -0.08).build()
    return cls, mesh, bc


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured route runs on the card")


def test_capturable_follows_the_backend():
    """NCCL and one rank can be captured; gloo ranks (host staging) cannot."""
    assert Comm(0, 4, "cpu", "nccl").capturable
    assert not Comm(0, 4, "cpu", "gloo").capturable
    assert LocalComm("cpu").capturable


@pytest.mark.parametrize("case", list(SOLVERS))
def test_the_cpu_takes_the_eager_route(case):
    """On the CPU the rank's bodies run eagerly (a one-shard LocalComm is
    capturable, but only on a card): nothing is captured or composed, as
    with `eager=True`."""
    cls, mesh, bc = _problem(case, "cpu")
    for eager in (False, True):
        s = cls(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**MIXED), eager=eager)
        stats = s.program_stats()
        assert not s.captured and stats["route"] == "eager"
        assert stats["graph_nodes"] == {} and stats["capture_s"] == {}
        assert not s._host.captured and not s._routes["main"].captured


@pytest.mark.parametrize("case", list(SOLVERS))
def test_step_fetches_once_per_restart_and_chunk(case):
    """A step of pcg_maxiter 7 in chunks of 3 on one shard: the prepare
    from zero and three chunks (3 + 3 + 1), four fetches, seven
    iterations."""
    cls, mesh, bc = _problem(case, "cpu")
    s = cls(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**MAXITER))
    u = s._impose(s.zero_u(), 1.0)
    _, iters, ok, _ = s._step_pcg(u, 1.0)
    assert iters == 7 and not ok
    assert s.launched == {"newton": 0, "chunk": 3, "restart": 1} and s.fetches == 4


def _solve(s):
    """A solve() on one rank: (global u, records without wall times, its
    fetches, its programs launched)."""
    fetches, launched = s.fetches, dict(s.launched)
    res = s.solve()
    assert res.converged
    hist = [{k: v for k, v in dataclasses.asdict(h).items() if k != "wall_time"}
            for h in res.history]
    return (s.u_global(res.u), hist, s.fetches - fetches,
            {k: v - launched[k] for k, v in s.launched.items()})


@pytest.mark.parametrize("case", list(SOLVERS))
def test_one_rank_captured_route_is_its_eager_route_on_card(case):
    """One rank on the card (LocalComm): the captured route, a solve() of
    two increments twice, gives bitwise the u and records of the same
    solver on the eager route; one fetch per Newton iteration, further
    chunk and restart; the path's kernels, the fused f64 residual (B5 on
    the Kuhn slab, B9 on the 5-tet box) included, are replayed by the
    graphs."""
    _card()
    cls, mesh, bc = _problem(case, "cuda")
    opts = SolverOptions(**MIXED)
    for k in cuda_graphs.REPLAYED:
        cuda_graphs.REPLAYED[k] = 0
    graph = cls(mesh, NeoHookean(1.0, 0.6), bc, options=opts)
    assert graph.captured and graph.program_stats()["route"] == "captured"
    assert graph.program_stats()["resid_df"] is True
    nodes = graph.program_stats()["graph_nodes"]["main"]
    assert set(nodes) == {"iter", "run", "prepare"} and all(n > 0 for n in nodes.values())
    first, second = _solve(graph), _solve(graph)
    eager = _solve(cls(mesh, NeoHookean(1.0, 0.6), bc, options=opts, eager=True))
    for u, hist, fetches, launched in (first, second, eager):
        assert np.array_equal(u, first[0]) and hist == first[1]
        assert launched["newton"] == sum(len(h["residual_norms"]) for h in hist)
        assert fetches == launched["newton"] + launched["chunk"] + launched["restart"]
    kernels = (("struct_apply", "struct_freeze", "struct_resid") if case == "kuhn"
               else ("elem_apply", "elem_freeze", "elem_resid"))
    assert all(cuda_graphs.REPLAYED[k] > 0 for k in kernels)
