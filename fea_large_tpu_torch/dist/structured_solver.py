"""Structured domain-decomposed solver: config 5 without indexed halo maps
(counterpart of `fea_large_tpu/dist/structured_solver.py`).

`ShardedNewtonSolver` (dist/sharded.py) distributes any mesh with indexed
halo maps. On a Kuhn lattice box the single-device path already runs the
lattice passes on the class grids; this solver extends that to the shards:

  * slab partition of the CELL lattice (dist/structured.py): every shard's
    local region is itself a Kuhn box, so each shard runs the SAME lattice
    passes on its local class grids: on the card the lattice kernels B1
    (tangent action), B2 (freeze) and B3 (block-Jacobi diagonal);
  * the slot-compressed geometry tables are the same on every shard (the
    lattice is translation-invariant), a few KB;
  * the halo exchange is ONE boundary-plane hop per direction (the left
    plane of shard p is the right plane of shard p - 1): static slices,
    no index maps;
  * PCG dot products weight by the ownership mask and sum over the shards;
  * the two-level coarse transfer is LATTICE-BLOCK POOLED (ops/pooling.py,
    `ShardedLatticePool`).

Vector convention ("consistent" layout): every local nodal array holds the
TRUE global value at every local slot, the shared boundary planes included
(held by both touching shards). Element passes produce PARTIAL sums at both
boundary planes; `_reduce_gather` (one backward hop adding left-plane
partials into the owner's right plane, one forward hop refreshing the
non-owned left planes) restores consistency. Dots weight by the ownership
mask so that shared plane slots count once.

The loop and its programs are `ShardedNewtonSolver`'s: this class swaps
the partition, the exchange and the coarse transfer only, so the two
sharded paths cannot drift in solver semantics; the boundary-plane hops
run inside the programs' bodies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.dist.comm import Comm, LocalComm
from fea_large_tpu_torch.dist.sharded import (
    ShardedNewtonSolver,
    ShardedSoA,
    _centroid_arms,
    _check_options,
    _coarse_modes,
    _nbytes,
)
from fea_large_tpu_torch.dist.structured import (
    StructuredPartition,
    add_right_planes,
    left_planes,
    right_planes,
    set_left_planes,
    structured_partition,
)
from fea_large_tpu_torch.ops.soa import SoAProblem
from fea_large_tpu_torch.solvers.newton import SolverOptions


@dataclasses.dataclass(frozen=True)
class StructData:
    """This rank's nodal data in the local CLASS-GRID layout, consistent
    (true values at the boundary-plane slots of both touching shards)."""

    own_mask: torch.Tensor  # f64 [N_loc] 1 where this shard owns the node
    own_left: torch.Tensor  # f64 [plane] 1 where the left-plane slot is owned
    free_mask: torch.Tensor  # f64 [N_loc, 3]
    bc_values: torch.Tensor  # f64 [N_loc, 3]
    f_ext: torch.Tensor  # f64 [N_loc, 3]


@dataclasses.dataclass(frozen=True)
class _StructShim:
    """The partition interface the shared host loop reads from `self.part`,
    backed by a StructuredPartition (the local layout has no [owned | halo]
    split: ownership is the mask, `n_owned` the local layout's size)."""

    sp: StructuredPartition

    @property
    def n_shards(self) -> int:
        return self.sp.n_shards

    @property
    def n_owned(self) -> int:
        return self.sp.n_local

    @property
    def n_halo(self) -> int:
        return self.sp.plane_size

    @property
    def kmax(self) -> int:
        return 1

    @property
    def own_mask(self) -> np.ndarray:
        return self.sp.own_mask

    def to_global(self, u_shards: np.ndarray, n_nodes: int) -> np.ndarray:
        return self.sp.to_global(u_shards)

    def from_global(self, x: np.ndarray) -> np.ndarray:
        return self.sp.from_global(x)


def structured_shardable(mesh, n_shards: int) -> bool:
    """True when `mesh` can take the structured sharded path: it carries a
    BoxStructure whose x cell count divides by n_shards, and its coordinates
    are the undeformed uniform lattice (the shared geometry tables assume
    translation invariance)."""
    st = getattr(mesh, "structure", None)
    if st is None or st.cells[0] % n_shards != 0:
        return False
    from fea_large_tpu_torch.mesh.structure import class_coords

    coords = mesh.coords_host
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    expect = class_coords(st, *(hi - lo)) + lo
    return bool(np.max(np.abs(coords - expect)) <= 1e-12 * max(np.max(hi - lo), 1.0))


def local_box(mesh, sp, device):
    """Every shard's local Kuhn box, on `device`, with the mesh's element
    type and quadrature rule. It is the same on every shard and the
    lattice is translation-invariant: one slot-compressed table set serves
    all."""
    from fea_large_tpu_torch.mesh.generators import box_mesh_kuhn

    coords = mesh.coords_host
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    nx, ny, nz = mesh.structure.cells
    local_mesh = box_mesh_kuhn(
        sp.cells_per_shard, ny, nz, lx=(hi[0] - lo[0]) * sp.cells_per_shard / nx,
        ly=hi[1] - lo[1], lz=hi[2] - lo[2], element_type=mesh.element_type,
        device=device, n_quad=mesh.n_quad,
    )
    assert local_mesh.n_nodes == sp.n_local
    return local_mesh


def make_sharded_solver(mesh, material, bc, f_ext=None, options: SolverOptions | None = None,
                        comm: Comm | None = None, partition_method: str = "slab"):
    """The structured sharded solver where the mesh allows it (Kuhn lattice,
    divisible slab count, undeformed lattice coordinates) and the options
    are in its program matrix, else the general ShardedNewtonSolver: same
    constructor surface, same result."""
    opts = options or SolverOptions()
    size = 1 if comm is None else comm.size
    if (
        partition_method == "slab"
        and opts.linear == "pcg"
        and opts.precision in ("f64", "mixed")
        and opts.preconditioner in ("jacobi", "two_level")
        and opts.coarse_modes in (3, 6)
        and structured_shardable(mesh, size)
    ):
        return StructuredShardedSolver(mesh, material, bc, f_ext=f_ext, options=opts, comm=comm)
    return ShardedNewtonSolver(mesh, material, bc, f_ext=f_ext, options=opts, comm=comm,
                               partition_method=partition_method)


class StructuredShardedSolver(ShardedNewtonSolver):
    """Sharded solver for Kuhn lattice boxes (see the module docstring):
    `ShardedNewtonSolver`'s loop, programs and shard arithmetic on the
    boundary-plane exchange; `eager` as there."""

    def __init__(self, mesh, material, bc, f_ext=None, options: SolverOptions | None = None,
                 comm: Comm | None = None, eager: bool = False):
        self.mesh = mesh
        self.material = material
        self.options = options or SolverOptions()
        _check_options(self.options)
        self.comm = comm or LocalComm(mesh.device)
        self.precond_fallbacks = 0
        S, p = self.comm.size, self.comm.rank
        if not structured_shardable(mesh, S):
            raise ValueError(
                "mesh is not structured-shardable (no BoxStructure, "
                "nx % n_shards != 0, or deformed lattice coords) — use "
                "make_sharded_solver / ShardedNewtonSolver"
            )
        self.spart = sp = structured_partition(mesh.structure, S)
        self.part = _StructShim(sp)
        self._pcg_dtype = torch.float32 if self.options.precision == "mixed" else torch.float64
        dev = self.comm.device
        l2g = sp.local_to_global[p]

        def put(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)

        own = put(sp.own_mask[p])
        fext = np.zeros((mesh.n_nodes, 3)) if f_ext is None else np.asarray(f_ext.cpu())
        # consistent layout: ownership enters through the weighted dots,
        # not by masking the data
        self.data = StructData(
            own_mask=own, own_left=left_planes(sp, own[:, None])[:, 0],
            free_mask=put(bc.free_mask.cpu().numpy()[l2g]),
            bc_values=put(bc.values.cpu().numpy()[l2g]), f_ext=put(fext[l2g]),
        )
        self._n_local = sp.n_local

        local_mesh = local_box(mesh, sp, dev)
        mixed = self.options.precision == "mixed"
        self.soa = ShardedSoA(
            p64=SoAProblem.build(local_mesh, torch.float64),
            p32=SoAProblem.build(local_mesh, torch.float32) if mixed else None,
        )
        self._build_coarse_structured()
        self._run_coarse_probe()
        self._init_programs(eager)

    # ------------------------------------------------------------------
    def _build_coarse_structured(self):
        """Coarse space by LATTICE-BLOCK pooling (ops/pooling.py): the
        aggregates are slab-aligned cell blocks, so restrict and prolong are
        per-class reshape-sums and broadcasts at the slab offset. The same
        probing plan as the generic path on the pool's aggregate ids; the
        restrict masks by ownership (`valid`), and the prolong is
        consistent by construction."""
        self.coarse = None
        self._probe_ctx = None
        self._n_agg = 0
        self._lattice_pool = None
        if self.options.preconditioner == "jacobi":
            return
        from fea_large_tpu_torch.ops.pooling import global_pool_of, make_sharded_lattice_pool
        from fea_large_tpu_torch.solvers.multilevel import _probe_plan, default_agg_size

        modes = _coarse_modes(self.options)
        sp, p = self.spart, self.comm.rank
        coords = self.mesh.coords_host
        agg_size = self.options.agg_size or default_agg_size(
            self.mesh.n_nodes, target_coarse=5000 if modes == 3 else 2500, structured=True)
        spool = make_sharded_lattice_pool(self.mesh.structure, sp.local,
                                          max(1, self.mesh.n_nodes // agg_size))
        self._lattice_pool = spool
        agg = global_pool_of(spool, self.mesh.structure).agg_host()
        n_agg = int(agg.max()) + 1
        assert n_agg == spool.n_agg
        dvec_np = _centroid_arms(coords, agg, n_agg, modes)
        color, Bn, _, cm, zsrc, dst, nc = _probe_plan(
            self.mesh.conn_host, agg, n_agg, modes, dvec_np)
        l2g = sp.local_to_global[p]
        self._n_agg = n_agg
        self._set_coarse(
            spool, valid=sp.own_mask[p],
            dvec=dvec_np[l2g] if modes == 6 else None, Bn=Bn[l2g], color_own=color[agg][l2g],
            plan=(cm, zsrc, dst, nc), host=(agg, dvec_np, modes))

    def _probe_tables(self, agg, color, Bn):
        l2g = self.spart.local_to_global[self.comm.rank]
        return Bn[l2g], color[agg][l2g]

    # ------------------------------------------------------------------
    # the exchange (boundary planes)
    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Refresh the non-owned left-plane slots of a local field from the
        neighbour's (complete) right plane: one forward hop."""
        sp = self.spart
        recv = self.comm.hop(right_planes(sp, x), 1)
        ol = self.data.own_left.to(x.dtype).view(-1, *((1,) * (x.dim() - 1)))
        return set_left_planes(sp, x, ol * left_planes(sp, x) + (1.0 - ol) * recv)

    def _reduce_gather(self, y: torch.Tensor) -> torch.Tensor:
        """Element-pass output (partial at both boundary planes) ->
        consistent: return the left-plane partials to the owner's right
        plane (backward hop), then refresh the left planes (forward hop).
        Shard 0's left plane is its own: it sends zeros and keeps its
        values."""
        sp = self.spart
        ol = self.data.own_left.to(y.dtype).view(-1, *((1,) * (y.dim() - 1)))
        y = add_right_planes(sp, y, self.comm.hop(left_planes(sp, y) * (1.0 - ol), -1))
        return self._gather(y)

    def _expand_u(self, u: torch.Tensor) -> torch.Tensor:
        return self._gather(u)

    def _expand_v(self, v: torch.Tensor) -> torch.Tensor:
        return v  # PCG vectors are consistent

    def _assemble(self, y_loc: torch.Tensor) -> torch.Tensor:
        return self._reduce_gather(y_loc)

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Ownership-weighted global dot: boundary-plane slots are held by
        two shards and count once."""
        own = self.data.own_mask.to(a.dtype).view(-1, *((1,) * (a.dim() - 1)))
        return self.comm.all_sum(torch.dot((a * own).reshape(-1), b.reshape(-1)))

    def _restrict(self, coarse, t: torch.Tensor) -> torch.Tensor:
        """The pooled P^T of the owner-masked t, summed over the shards."""
        return coarse.transfer.restrict(t, self.comm.rank, self.comm.all_sum)

    def _prolong(self, coarse, xc: torch.Tensor) -> torch.Tensor:
        return coarse.transfer.prolong(xc, self.comm.rank)

    # ------------------------------------------------------------------
    def memory_report(self) -> dict:
        """This shard's device-memory budget (bytes), by the categories of
        `ShardedNewtonSolver.memory_report`: the geometry tables are the
        slot-compressed ones (KB, the same on every shard); the nodal
        arrays scale with the local grid."""
        sp = self.spart
        q = self.soa.p64.tables.q
        El = sp.local.n_tets * sp.local.n_cells
        return {"n_shards": sp.n_shards, "owned_nodes": int(sp.own_mask.sum() / sp.n_shards),
                "halo_nodes": sp.plane_size, "elements": El,
                **self._memory(_nbytes(self.soa), sp.n_local, El, q)}
