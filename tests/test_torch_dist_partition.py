"""PyTorch port: the host and per-shard pieces of domain decomposition
against the JAX reference, in one process (tests/test_torch_dist.py runs
the sharded solvers on gloo ranks).

  * `partition_mesh` (slab and rcb) and `structured_partition` with its
    four plane helpers: array for array equal to the reference's, on the
    reference tests' boxes (tests/test_dist.py, tests/test_structured_dist.py);
  * `ScatterBuckets.build_stacked`: the reference's tables exactly, and
    each shard's sums against a direct sum;
  * `ShardedLatticePool`: its block choice is the reference's; its
    restrict, summed over the shards in a loop, equals the global
    `LatticePool` of `global_pool_of` (f64, 1e-12 of the largest entry:
    sums in another order), and its prolong equals the global prolong
    exactly;
  * every shard's tables (`sharded.shard_soa`: padded element sets;
    `structured_solver.local_box`: the local Kuhn box) give element forces
    that, summed over the shards into the global layout, equal the global
    SoA pass (f64, 1e-12 of the largest entry);
  * the fixed-order sum of `Comm` adds the ranks' parts in rank order;
  * `newton_lin_tol`, which the sharded Newton iteration uses for its
    forcing, equals the reference's `device_forcing` (the forcing of the
    reference's sharded loop) on a grid of inputs (f64: bitwise).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.dist import partition as ref_partition
from fea_large_tpu.dist import structured as ref_structured
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
from fea_large_tpu.ops import pooling as ref_pooling
from fea_large_tpu.ops.soa import ScatterBuckets as RefScatterBuckets
from fea_large_tpu.solvers.newton import device_forcing as ref_device_forcing

from fea_large_tpu_torch import NeoHookean
from fea_large_tpu_torch.dist import partition, structured
from fea_large_tpu_torch.dist.sharded import shard_soa
from fea_large_tpu_torch.dist.structured_solver import local_box
from fea_large_tpu_torch.dist.comm import Comm, backend_for
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import pooling
from fea_large_tpu_torch.ops.soa import ScatterBuckets, SoAProblem, soa_freeze, soa_internal_force
from fea_large_tpu_torch.solvers.newton import SolverOptions, newton_lin_tol

torch.set_num_threads(2)

PARTITION_FIELDS = ("n_shards", "n_owned", "n_halo", "n_elems", "kmax", "elem_global",
                    "local_conn", "owned_global", "own_mask", "halo_global", "send_idx",
                    "send_mask", "recv_mask")


@pytest.mark.parametrize("element_type,n_shards,cells,method", [
    ("tet4", 4, (4, 3, 3), "slab"), ("tet10", 8, (4, 3, 3), "slab"),
    ("tet4", 3, (4, 3, 3), "slab"), ("tet4", 8, (6, 6, 6), "rcb"),
    ("tet10", 4, (4, 4, 4), "rcb"),
])
def test_partition_matches_reference(element_type, n_shards, cells, method):
    lx = 4.0 if cells[0] == 4 and cells[1] == 3 else 1.0
    ref = ref_partition.partition_mesh(
        ref_box_mesh(*cells, lx=lx, element_type=element_type), n_shards, method=method)
    mesh = box_mesh(*cells, lx=lx, element_type=element_type, device="cpu")
    port = partition.partition_mesh(mesh, n_shards, method=method)
    for f in PARTITION_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    x = np.random.default_rng(3).standard_normal((mesh.n_nodes, 3))
    for space in ("owned", "local"):
        np.testing.assert_array_equal(port.from_global(x, space), ref.from_global(x, space))
    shards = port.from_global(x)
    np.testing.assert_array_equal(port.to_global(shards, len(x)), x)


STRUCT_CASES = [("tet4", (8, 3, 2), 4), ("tet10", (8, 3, 2), 4), ("tet10", (6, 2, 2), 3),
                ("tet4", (4, 2, 3), 2), ("tet10", (8, 2, 2), 4), ("tet10", (4, 3, 2), 2)]


@pytest.mark.parametrize("element_type,cells,n_shards", STRUCT_CASES)
def test_structured_partition_matches_reference(element_type, cells, n_shards):
    st = box_mesh_kuhn(*cells, element_type=element_type, device="cpu").structure
    ref = ref_structured.structured_partition(
        ref_box_mesh_kuhn(*cells, element_type=element_type).structure, n_shards)
    port = structured.structured_partition(st, n_shards)
    assert port.cells_per_shard == ref.cells_per_shard
    assert port.plane_classes == ref.plane_classes and port.plane_size == ref.plane_size
    assert dataclass_fields(port.local) == dataclass_fields(ref.local)
    np.testing.assert_array_equal(port.local_to_global, ref.local_to_global)
    np.testing.assert_array_equal(port.own_mask, ref.own_mask)
    np.testing.assert_array_equal(port.elem_global(), ref.elem_global())
    rng = np.random.default_rng(2)
    x = rng.standard_normal((st.n_nodes, 3))
    loc = port.from_global(x)
    np.testing.assert_array_equal(port.to_global(loc), x)
    pl = rng.standard_normal((port.plane_size, 3))
    for p in range(n_shards):
        v = torch.tensor(loc[p])
        for name in ("right_planes", "left_planes"):
            np.testing.assert_array_equal(
                getattr(structured, name)(port, v).numpy(),
                np.asarray(getattr(ref_structured, name)(ref, jnp.asarray(loc[p]))), err_msg=name)
        for name in ("set_left_planes", "add_right_planes"):
            got = getattr(structured, name)(port, v, torch.tensor(pl)).numpy()
            want = np.asarray(getattr(ref_structured, name)(ref, jnp.asarray(loc[p]),
                                                             jnp.asarray(pl)))
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(v.numpy(), loc[p])  # inputs unchanged
        if p > 0:  # the halo is exactly the neighbour's right plane
            np.testing.assert_array_equal(
                structured.left_planes(port, v).numpy(),
                structured.right_planes(port, torch.tensor(loc[p - 1])).numpy())


def dataclass_fields(st):
    return (st.cells, st.classes, st.class_dims, st.class_base, st.slot_class, st.slot_offset)


def test_indivisible_cell_count_rejected():
    st = box_mesh_kuhn(6, 2, 2, device="cpu").structure
    with pytest.raises(ValueError):
        structured.structured_partition(st, 4)


def test_build_stacked_matches_reference(rng):
    S, npe, El, N = 4, 10, 37, 25
    conn = rng.integers(0, N, size=(S, npe, El)).astype(np.int32)
    ref = RefScatterBuckets.build_stacked(conn, N)
    port = ScatterBuckets.build_stacked(conn, N)
    assert len(port.idx) == len(ref.idx)
    for a, b in zip(port.idx + port.mask + (port.inv,), ref.idx + ref.mask + (ref.inv,)):
        np.testing.assert_array_equal(a.numpy(), b)
    for p in range(S):
        d = rng.normal(size=(3, npe * El))
        want = np.zeros((3, N))
        for c in range(3):
            np.add.at(want[c], conn[p].reshape(-1), d[c])
        got = port.shard(p).apply(torch.tensor(d)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("element_type,cells,n_shards,target", [
    ("tet10", (8, 4, 4), 4, 16), ("tet4", (6, 5, 3), 3, 10), ("tet10", (4, 3, 3), 2, 6),
    ("tet10", (12, 3, 4), 4, 40),
])
def test_sharded_lattice_pool_matches_global_pool(element_type, cells, n_shards, target):
    st = box_mesh_kuhn(*cells, element_type=element_type, device="cpu").structure
    sp = structured.structured_partition(st, n_shards)
    pool = pooling.make_sharded_lattice_pool(st, sp.local, target)
    ref = ref_pooling.make_sharded_lattice_pool(st, sp.local, target)
    assert (pool.block, pool.nb_global, pool.nbl) == (ref.block, ref.nb_global, ref.nbl)
    glob = pooling.global_pool_of(pool, st)
    np.testing.assert_array_equal(glob.agg_host(), ref_pooling.global_pool_of(ref, st).agg_host())
    rng = np.random.default_rng(7)
    v = rng.standard_normal((st.n_nodes, 6))
    w = torch.tensor(rng.standard_normal((pool.n_agg, 6)))
    loc = sp.from_global(v) * sp.own_mask[:, :, None]
    parts = [pool.restrict(torch.tensor(loc[p]), p, lambda buf: buf) for p in range(n_shards)]
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    want = glob.restrict(torch.tensor(v)).numpy()
    np.testing.assert_allclose(total.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    full = glob.prolong(w).numpy()
    for p in range(n_shards):
        np.testing.assert_array_equal(pool.prolong(w, p).numpy(), full[sp.local_to_global[p]])


class _GatheredComm(Comm):
    """A Comm whose all-gather returns given parts (the ranks' partials)."""

    def __init__(self, parts):
        super().__init__(0, len(parts), "cpu", "gloo")
        self.parts = parts

    def _gather(self, x):
        return self.parts


@pytest.mark.parametrize("path,element_type", [("generic", "tet4"), ("generic", "tet10"),
                                                 ("structured", "tet10")])
def test_shard_tables_sum_to_the_global_pass(path, element_type):
    n_shards, mat = 3, NeoHookean(1.0, 0.6)
    build = box_mesh if path == "generic" else box_mesh_kuhn
    mesh = build(6, 3, 2, lx=2.0, element_type=element_type, device="cpu")
    u = 0.01 * np.random.default_rng(4).standard_normal((mesh.n_nodes, 3))

    def force(p, u_nodes):
        u_T = torch.tensor(np.ascontiguousarray(u_nodes.T))
        return soa_internal_force(p, soa_freeze(p, mat, u_T)).numpy().T

    want = force(SoAProblem.build(mesh, torch.float64), u)
    got = np.zeros_like(want)
    if path == "generic":
        part = partition.partition_mesh(mesh, n_shards, method="slab")
        local = part.from_global(u, space="local")
        for p in range(n_shards):
            f = force(shard_soa(mesh, part, p, "cpu", mixed=False).p64, local[p])
            gid = np.concatenate([part.owned_global[p], part.halo_global[p]])
            np.add.at(got, gid[gid >= 0], f[gid >= 0])
    else:
        sp = structured.structured_partition(mesh.structure, n_shards)
        p64 = SoAProblem.build(local_box(mesh, sp, "cpu"), torch.float64)
        local = sp.from_global(u)
        for p in range(n_shards):
            np.add.at(got, sp.local_to_global[p], force(p64, local[p]))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_fixed_order_sum_adds_in_rank_order():
    parts = [torch.tensor([1e16, 1.0]), torch.tensor([1.0, 1e16]), torch.tensor([-1e16, -1e16])]
    out = _GatheredComm(parts).all_sum(parts[0])
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(out, want)
    assert out.tolist() == [0.0, 0.0]  # the rounding of that order, not the exact sum (1.0, 1.0)
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"


def test_device_forcing_matches_reference():
    """The reference's sharded loop takes its forcing from `device_forcing`
    (the norms of this and the previous iteration, the previous eta, the
    Newton stop and the precision floor as arguments); the port's takes it
    from `newton_lin_tol`. Both give the same lin_tol, and with EW the same
    eta (without EW, eta is unused)."""
    norms = [3.0e-1, 2.0e-3, 5.0e-9, 1.0e-12]
    for norm, prev, eta_prev, first, use_ew, precision, stop, eta_min in itertools.product(
            norms, [1.0, 4.0e-2], [0.5, 0.2, 1e-3], [True, False], [True, False],
            ["mixed", "f64"], [1e-12, 1e-8], [0.0, 1e-2]):
        norm0 = norm if first else 1.0
        floor = 1.2e-6 if precision == "mixed" else min(2.2e-14 * norm0 / norm, 0.1)
        ref_eta, ref_tol = ref_device_forcing(
            jnp.float64(norm), jnp.float64(prev), jnp.float64(eta_prev), jnp.bool_(first),
            jnp.float64(1e-6), use_ew, jnp.float64(floor), jnp.float64(stop), eta_min)
        opts = SolverOptions(pcg_tol=1e-6, forcing="ew" if use_ew else "fixed",
                             precision=precision, ew_eta_min=eta_min, newton_rtol=0.0,
                             newton_atol=stop)
        lin_tol, eta = newton_lin_tol(opts, 0 if first else 1, [prev, norm], norm0,
                                      0.5 if first else eta_prev)
        assert lin_tol == float(ref_tol)
        if use_ew:
            assert eta == float(ref_eta)
