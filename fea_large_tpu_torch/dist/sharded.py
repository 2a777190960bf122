"""Domain-decomposed solver, one process per shard (counterpart of
`fea_large_tpu/dist/sharded.py`; config 5 of the reference).

The reference runs one `shard_map` program over a 1-D device mesh. Here
each shard is a process of a `torch.distributed` group (dist/launch.py),
and the solver object lives on every rank, holding that rank's shard. The
ranks communicate through exactly three collectives of `Comm`
(dist/comm.py):

  * halo GATHER: ring hops k = 1..kmax delivering owned values to the
    shards whose elements touch them (element-pass inputs);
  * halo REDUCE: the reverse hops returning partial element sums at halo
    nodes to their owners;
  * the fixed-order sum over ranks: dot products, residual norms and the
    coarse restriction (the coarse residual is summed, solved on every
    shard with the same explicit inverse, and prolonged locally).

The element passes, the tangent action and PCG are the single-device
functions (`ops.soa`, `solvers.linear`) applied to the shard's local
problem, so the f32 passes of a shard run the same kernels on the card:
the element-block kernels B6 (tangent action) and B7 (freeze) here, the
lattice kernels B1-B3 on the structured path (dist/structured_solver.py).
Both precisions run the same loop:

  precision="f64"    f64 residual + f64 tangent and PCG (parity path)
  precision="mixed"  f64 residual + f32 tangent and PCG

The f64 residual takes the route `NewtonSolver` takes on one card
(`residual.resid_df_route`, `residual.internal_force64`): on the mixed
path, where the element is supported and `resid_df` allows (None: on a
CUDA device), the fused residual kernel, B5 on a structured slab
(the f64 pair-cache gather, B5, the pair scatter) and B9 on a generic
shard (the f64 conn gather, B9, the fixed-order nodal sum); else the
plain f64 freeze and force, as in the reference. `program_stats()`
reports the route (`resid_df`).

Each rank runs the reference's sharded programs (its `newton_iter_body`,
`chunk_body` and `prepare_body`) on persistent tensors (`RankState`) and a
`linear.DevicePCGChunk` whose dot is the global one:

  iter     head (u += x_prev, the f64 residual and its norm, the forcing
           with the precision floor, the flag `work`); IF(work) {frz
           (freeze, block-Jacobi diagonal and inverse); init0; arm;
           WHILE(active) step; fin}
  run      arm; WHILE(active) step; fin (a further chunk)
  prepare  resid (the f64 residual); frz; initx (a restart from x0)

head, resid and frz are the rank's bodies, the others the chunk's. The
reference's prepare refreshes a structured shard's x0 with a forward hop
(it accepts owner-only layouts); here x0 is always a CG iterate of the
chunk, consistent on the boundary planes already, so initx takes it as
it is.

`work` is clear where the norm meets the Newton stop, on the last allowed
iteration and on a NaN norm: the reference runs its chunk there at tol
1e30 and the host discards it. A Newton iteration is one launch and one
batched fetch of (norm, eta, lin_tol, work, k, rr, ok, stop), a further
chunk and a restart one launch and one fetch each.

The rank's bodies are on a `cuda_graphs.Host` of their own, joined to
each route's chunk, whose host runs the programs (ops/cuda_graphs.py).
The route follows from the comm: on a CUDA device with `comm.capturable`
(NCCL, or one rank) the bodies are captured once per solver and route and
the programs composed of them when the route is made, collectives inside;
elsewhere (gloo: ranks on the CPU or sharing a card) the same bodies run
eagerly, a Python test of each flag in place of its node. A failed capture
or launch raises. `eager=True` runs the bodies eagerly on the card too (a
comparison, never a fallback). The two-level -> Jacobi fallback is a
second route (a zero coarse inverse), made at its first use; it shares
the rank bodies with the first.

Every flag a program tests comes out of the fixed-order sum, bitwise the
same on every rank, so the ranks run the same trip counts and issue the
same collectives; a rank that disagreed would hang, and `run_sharded`'s
timeout would raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from fea_large_tpu_torch.dist.comm import Comm, LocalComm
from fea_large_tpu_torch.dist.partition import partition_mesh
from fea_large_tpu_torch.ops import cuda_graphs
from fea_large_tpu_torch.ops.residual import internal_force64, resid_df_route
from fea_large_tpu_torch.ops.soa import (
    ScatterBuckets,
    SoAProblem,
    _np_inv_det_3x3,
    soa_apply_tangent,
    soa_diag_blocks,
    soa_freeze,
)
from fea_large_tpu_torch.solvers.linear import (
    DevicePCGChunk,
    apply_block_jacobi,
    drive_chunked_pcg,
    jacobi_inverse_blocks,
)
from fea_large_tpu_torch.solvers.newton import (
    IncrementRecord,
    SolveResult,
    SolverOptions,
    device_forcing,
    step_load,
)

#: the span each rank body (head, resid, frz: every route shares them)
#: opens (utils/profiling.py; frz's holds the rank's block-Jacobi set-up)
RANK_SPANS = ("residual64", "residual64", "freeze")
#: a route's programs, chains of (kind, flag, body) items
#: (`cuda_graphs.Host`) over the rank bodies and the chunk's
PROGRAMS = {
    "iter": ((None, None, "head"),
             ("if", "work", ((None, None, "frz"), (None, None, "init0")) + DevicePCGChunk.RUN)),
    "run": DevicePCGChunk.RUN,
    "prepare": ((None, None, "resid"), (None, None, "frz"), (None, None, "initx")),
}


@dataclasses.dataclass(frozen=True)
class ShardedData:
    """This rank's shard: the ring-hop maps (k = 1..kmax) and the nodal data
    on its owned nodes [No] (padded slots carry zero masks)."""

    send_idx: torch.Tensor  # int64 [kmax, Hl] owned slots sent at hop k
    send_mask: torch.Tensor  # f64 [kmax, Hl]
    recv_mask: torch.Tensor  # f64 [kmax, Hl] halo slots received at hop k
    own_mask: torch.Tensor  # f64 [No]
    free_mask: torch.Tensor  # f64 [No, 3]
    bc_values: torch.Tensor  # f64 [No, 3]
    f_ext: torch.Tensor  # f64 [No, 3]
    #: per hop, the (owned slot, halo slot) pairs of `send_mask` == 1: the
    #: halo reduce adds each returned partial into its owned slot (one pair
    #: per owned slot and hop, so the sum has a fixed order)
    reduce_maps: tuple


@dataclasses.dataclass(frozen=True)
class ShardedSoA:
    """The shard's local SoA problems over its [owned | halo] node space:
    f64 for the residual, and f32 for the mixed path's tangent (None on
    the f64 path). They share the conn_T and bucket maps."""

    p64: SoAProblem
    p32: SoAProblem | None


@dataclasses.dataclass(frozen=True)
class ShardedCoarse:
    """The two-level coarse correction on one shard: restrict locally, sum
    over the shards, solve with the explicit inverse (the same on every
    rank), prolong locally. Translations (modes 3) or the rigid-body modes
    (modes 6)."""

    #: the shard's aggregation: an `AggregateTransfer` over its owned nodes
    #: (generic), a `ShardedLatticePool` (structured)
    transfer: object
    valid: torch.Tensor  # [n] 1 on the nodes this shard restricts (owned)
    dvec: torch.Tensor | None  # [n, 3] normalized rotational arm (modes 6)
    acinv: torch.Tensor  # [modes*Nc, modes*Nc], stored as `multilevel._store_acinv` says
    n_agg: int
    modes: int


@dataclasses.dataclass(frozen=True)
class ShardedProbe:
    """Transient tables of the coarse-operator probing (freed after setup):
    the sweep runs through the sharded tangent action, so each rank holds
    only its shard's rows."""

    Bn_own: torch.Tensor  # f32 [n, 3, modes] per-node basis columns
    color_own: torch.Tensor  # int64 [n] aggregate color (-1 at padding)


@dataclasses.dataclass
class RankState:
    """The tensors of a rank's programs, written in place (a capture holds
    their addresses). The host sets the inputs before an `iter` launch and
    reads the outputs in its one fetch; `frozen` and `inv_blocks` are the
    outputs of the body frz (a captured body's outputs keep their
    addresses)."""

    u: torch.Tensor  # f64 [n, 3]: the iterate
    x_prev: torch.Tensor  # pdt [n, 3]: the direction applied by the next head
    b: torch.Tensor  # pdt [n, 3]: the masked residual, CG's right-hand side
    scale: torch.Tensor  # f64 0-d load factor
    prev_norm: torch.Tensor  # f64 0-d inputs of the forcing
    norm0: torch.Tensor
    eta_prev: torch.Tensor
    stop_newton: torch.Tensor
    first: torch.Tensor  # bool 0-d: the increment's first iteration
    last: torch.Tensor  # bool 0-d: the last allowed iteration
    norm: torch.Tensor  # f64 0-d outputs of head
    eta: torch.Tensor
    lin_tol: torch.Tensor
    tol: torch.Tensor  # pdt 0-d: CG's tolerance, shared with the routes' chunks
    work: torch.Tensor  # bool 0-d: the tangent work runs
    frozen: object = None
    inv_blocks: torch.Tensor | None = None

    @staticmethod
    def zeros(n: int, dtype, device) -> "RankState":
        f64 = torch.float64

        def scalar(dt=f64):
            return torch.zeros((), dtype=dt, device=device)

        return RankState(
            u=torch.zeros((n, 3), dtype=f64, device=device),
            x_prev=torch.zeros((n, 3), dtype=dtype, device=device),
            b=torch.zeros((n, 3), dtype=dtype, device=device),
            **{k: scalar() for k in ("scale", "prev_norm", "norm0", "eta_prev", "stop_newton",
                                     "norm", "eta", "lin_tol")},
            first=scalar(torch.bool), last=scalar(torch.bool), tol=scalar(dtype),
            work=scalar(torch.bool))


def _host_geometry(mesh, part, p: int):
    """Shard p's padded (gradN [El, q, npe, 3], detJxW [El, q]) in host f64;
    padded elements keep zeros (they contribute nothing)."""
    elem = mesh.element
    coords, conn = mesh.coords_host, mesh.conn_host
    dN = np.asarray(elem.shape_grad)  # [q, npe, 3]
    w = np.asarray(elem.quad_weights)
    real = part.elem_global[p] >= 0
    J = np.einsum("eai,qaj->eqij", coords[conn[part.elem_global[p][real]]], dN)
    detJ, Jinv = _np_inv_det_3x3(J)
    q, npe = dN.shape[0], conn.shape[1]
    g = np.zeros((part.n_elems, q, npe, 3))
    v = np.zeros((part.n_elems, q))
    g[real] = np.einsum("qaj,eqji->eqai", dN, Jinv)
    v[real] = detJ * w[None, :]
    return g, v


def shard_soa(mesh, part, p: int, device, mixed: bool) -> ShardedSoA:
    """Shard p's SoA problems (element axis last, ops/soa.py) on `device`:
    the f64 one, and the f32 one where `mixed`. The valence buckets of the
    nodal sums come from `build_stacked`, so every shard's tables have one
    shape, as in the reference."""
    gradN, detJxW = _host_geometry(mesh, part, p)
    n_local = part.n_owned + part.n_halo
    conn_T = np.transpose(part.local_conn, (0, 2, 1))  # [S, npe, El]
    buckets = ScatterBuckets.build_stacked(conn_T, n_local).shard(p, device)
    g = np.ascontiguousarray(np.transpose(gradN, (1, 2, 3, 0)))  # [q, npe, 3, El]
    v = np.ascontiguousarray(detJxW.T)  # [q, El]
    conn = torch.as_tensor(np.ascontiguousarray(conn_T[p]), dtype=torch.int64, device=device)
    conn32 = conn.to(torch.int32)

    def problem(dtype):
        return SoAProblem(n_nodes=n_local, gradN=torch.as_tensor(g, dtype=dtype, device=device),
                          detJxW=torch.as_tensor(v, dtype=dtype, device=device),
                          conn_T=conn, buckets=buckets, conn32=conn32)

    return ShardedSoA(p64=problem(torch.float64),
                      p32=problem(torch.float32) if mixed else None)


def _check_options(opts: SolverOptions) -> None:
    if opts.linear != "pcg":
        raise ValueError("sharded solver supports linear='pcg' only")
    if opts.precision not in ("f64", "mixed"):
        raise ValueError(f"unknown precision {opts.precision!r}")
    if opts.preconditioner not in ("jacobi", "two_level"):
        raise ValueError(
            f"sharded preconditioner must be 'jacobi' or 'two_level', "
            f"got {opts.preconditioner!r}"
        )


def _coarse_modes(opts: SolverOptions) -> int:
    if opts.coarse_modes not in (3, 6):
        raise NotImplementedError(
            f"sharded coarse supports modes 3 or 6, got {opts.coarse_modes}")
    return opts.coarse_modes


def _centroid_arms(coords, agg, n_agg, modes):
    """The rotational arms of the rigid-body coarse basis (modes 6), else
    None."""
    if modes != 6:
        return None
    from fea_large_tpu_torch.solvers.multilevel import _rbm_dvec

    cnt = np.bincount(agg, minlength=n_agg).astype(float)
    cent = np.stack([np.bincount(agg, weights=coords[:, d], minlength=n_agg) / cnt
                     for d in range(3)], axis=1)
    return _rbm_dvec(coords, agg, cent, n_agg)


def _nbytes(*objs) -> int:
    """Bytes of the tensors in (nested) dataclasses, tuples and tensors."""
    total = 0
    for x in objs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += _nbytes(*x)
        elif dataclasses.is_dataclass(x):
            total += _nbytes(*(getattr(x, f.name) for f in dataclasses.fields(x)))
    return total


class ShardedNewtonSolver:
    """The distributed counterpart of `solvers.newton.NewtonSolver` on the
    matrix-free SoA PCG route, built on every rank of `comm` (a one-shard
    `LocalComm` on the mesh's device by default). The mesh and BC may lie
    on the CPU: each rank puts its shard on `comm.device`. The host loop
    (incremental loading, Eisenstat-Walker forcing, chunked PCG, the
    two-level -> Jacobi fallback, bisection) is the reference's, over the
    programs of the module docstring, captured on a CUDA device with a
    capturable comm unless `eager`."""

    def __init__(self, mesh, material, bc, f_ext=None, options: SolverOptions | None = None,
                 comm: Comm | None = None, partition_method: str = "slab", eager: bool = False):
        self.mesh = mesh
        self.material = material
        self.options = options or SolverOptions()
        _check_options(self.options)
        self.comm = comm or LocalComm(mesh.device)
        #: two-level -> Jacobi fallbacks taken (see `_newton`)
        self.precond_fallbacks = 0
        S, p = self.comm.size, self.comm.rank
        self.part = part = partition_mesh(mesh, S, method=partition_method)
        self._pcg_dtype = torch.float32 if self.options.precision == "mixed" else torch.float64
        dev = self.comm.device

        def put(x, dtype=torch.float64):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        own = part.own_mask[p][:, None]
        free = part.from_global(bc.free_mask.cpu().numpy())[p] * own
        vals = part.from_global(bc.values.cpu().numpy())[p] * own
        fext = (np.zeros((part.n_owned, 3)) if f_ext is None
                else part.from_global(np.asarray(f_ext.cpu()))[p] * own)
        reduce_maps = []
        for k in range(part.kmax):
            sel = np.nonzero(part.send_mask[p, k] > 0)[0]
            reduce_maps.append((put(part.send_idx[p, k, sel], torch.int64),
                                put(sel, torch.int64)))
        self.data = ShardedData(
            send_idx=put(part.send_idx[p], torch.int64), send_mask=put(part.send_mask[p]),
            recv_mask=put(part.recv_mask[p]), own_mask=put(part.own_mask[p]),
            free_mask=put(free), bc_values=put(vals), f_ext=put(fext),
            reduce_maps=tuple(reduce_maps),
        )
        self._n_local = part.n_owned + part.n_halo
        self.soa = shard_soa(mesh, part, p, dev, self.options.precision == "mixed")
        self._build_coarse()
        # the coarse operator is probed THROUGH the sharded tangent action
        self._run_coarse_probe()
        self._init_programs(eager)

    # ------------------------------------------------------------------
    # setup
    def _build_coarse(self):
        """Host-side coarse maps of the two-level preconditioner (None for
        block-Jacobi): geometric aggregation, rotational arms, the
        distance-2 probing plan, and this shard's node tables. The coarse
        OPERATOR is probed through the sharded tangent action afterwards
        (`_run_coarse_probe`)."""
        self.coarse = None
        self._probe_ctx = None
        self._n_agg = 0
        if self.options.preconditioner == "jacobi":
            return
        from fea_large_tpu_torch.solvers.multilevel import (
            AggregateTransfer,
            _probe_plan,
            aggregate_nodes,
            default_agg_size,
        )

        modes = _coarse_modes(self.options)
        part, p, dev = self.part, self.comm.rank, self.comm.device
        coords = self.mesh.coords_host
        agg_size = self.options.agg_size or default_agg_size(
            self.mesh.n_nodes, target_coarse=5000 if modes == 3 else 2500)
        agg = aggregate_nodes(coords, agg_size)
        n_agg = int(agg.max()) + 1
        dvec_np = _centroid_arms(coords, agg, n_agg, modes)
        color, Bn, dv, cm, zsrc, dst, nc = _probe_plan(
            self.mesh.conn_host, agg, n_agg, modes, dvec_np)
        real = part.owned_global[p] >= 0
        gid = part.owned_global[p][real]
        agg_own = np.zeros(part.n_owned, np.int64)
        agg_own[real] = agg[gid]
        color_own = np.full(part.n_owned, -1, np.int64)
        color_own[real] = color[agg[gid]]
        self._n_agg = n_agg
        self._set_coarse(
            AggregateTransfer(agg=torch.as_tensor(agg_own, device=dev),
                              buckets=ScatterBuckets.from_flat(agg_own, n_agg, dev)),
            valid=real.astype(float), dvec=part.from_global(dv)[p] if modes == 6 else None,
            Bn=part.from_global(Bn)[p], color_own=color_own, plan=(cm, zsrc, dst, nc),
            host=(agg, dvec_np, modes))

    def _set_coarse(self, transfer, valid, dvec, Bn, color_own, plan, host):
        """The ShardedCoarse (its inverse filled by `_run_coarse_probe`) and
        the probing context; `host` is kept for `probe_coarse_matrix`."""
        dev, pdt = self.comm.device, self._pcg_dtype
        cm, zsrc, dst, nc = plan
        agg, dvec_np, modes = host

        def f32(x):  # the reference keeps these tables in f32
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        self.coarse = ShardedCoarse(
            transfer=transfer, valid=torch.as_tensor(valid, dtype=pdt, device=dev),
            dvec=None if dvec is None else f32(dvec).to(pdt),
            acinv=torch.empty(0, dtype=pdt, device=dev),  # set by _run_coarse_probe
            n_agg=self._n_agg, modes=modes,
        )
        self._probe_ctx = {
            "cm": cm, "zsrc": zsrc, "dst": dst, "nc": nc,
            "tables": ShardedProbe(Bn_own=f32(Bn),
                                   color_own=torch.as_tensor(color_own, device=dev)),
            "agg": agg, "dvec": dvec_np, "modes": modes,
        }

    # ------------------------------------------------------------------
    # the exchange (generic: indexed halo maps)
    def _halo_gather(self, x_own: torch.Tensor) -> torch.Tensor:
        """[No, ...] owned -> [Hl, ...] halo values pulled from their owners."""
        d = self.data
        h = x_own.new_zeros((self.part.n_halo, *x_own.shape[1:]))
        for k in range(self.part.kmax):
            tail = (1,) * (x_own.dim() - 1)
            buf = x_own[d.send_idx[k]] * d.send_mask[k].to(x_own.dtype).view(-1, *tail)
            buf = self.comm.hop(buf, k + 1)
            h = h + buf * d.recv_mask[k].to(h.dtype).view(-1, *tail)
        return h

    def _halo_reduce(self, partials: torch.Tensor) -> torch.Tensor:
        """[Hl, ...] partial sums at halo slots -> [No, ...] at their owners."""
        d = self.data
        y = partials.new_zeros((self.part.n_owned, *partials.shape[1:]))
        tail = (1,) * (partials.dim() - 1)
        for k in range(self.part.kmax):
            buf = partials * d.recv_mask[k].to(partials.dtype).view(-1, *tail)
            buf = self.comm.hop(buf, -(k + 1))
            own_idx, slot = d.reduce_maps[k]
            y[own_idx] = y[own_idx] + buf[slot]
        return y

    def _expand_u(self, u: torch.Tensor) -> torch.Tensor:
        """The shard's nodal field (owned) -> its element passes' input
        (owned | halo)."""
        return torch.cat([u, self._halo_gather(u)], 0)

    def _expand_v(self, v: torch.Tensor) -> torch.Tensor:
        return self._expand_u(v)

    def _assemble(self, y_loc: torch.Tensor) -> torch.Tensor:
        """An element pass's local sums (owned | halo) -> complete owned sums."""
        No = self.part.n_owned
        return y_loc[:No] + self._halo_reduce(y_loc[No:])

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Global dot product: the local one, summed over the shards."""
        return self.comm.all_sum(torch.dot(a.reshape(-1), b.reshape(-1)))

    def _restrict(self, coarse, t: torch.Tensor) -> torch.Tensor:
        """P^T t [n, C] -> [n_agg, C]: per-aggregate sums of the owned rows
        (padded slots carry zeros), summed over the shards."""
        return self.comm.all_sum(coarse.transfer.restrict(t))

    def _prolong(self, coarse, xc: torch.Tensor) -> torch.Tensor:
        return coarse.transfer.prolong(xc)

    # ------------------------------------------------------------------
    # the shard's arithmetic (the reference's program bodies)
    def _p(self, dtype) -> SoAProblem:
        return self.soa.p64 if dtype == torch.float64 else self.soa.p32

    def _impose(self, u: torch.Tensor, scale) -> torch.Tensor:
        """u with the prescribed values at `scale` (a float or a 0-d tensor,
        which a captured body reads at each run)."""
        d = self.data
        return d.free_mask * u + (1.0 - d.free_mask) * (scale * d.bc_values)

    def _residual64(self, u: torch.Tensor, scale) -> torch.Tensor:
        """The f64 residual at u on the route of `self._resid_df` (the
        module docstring)."""
        d = self.data
        f_int = internal_force64(self.soa.p64, self.material, self._expand_u(u).T.contiguous(),
                                 fused=self._resid_df)
        f = self._assemble(f_int.T)
        return (scale * d.f_ext - f) * d.free_mask

    def _residual_norm(self, u: torch.Tensor, scale) -> torch.Tensor:
        r = self._residual64(u, scale)
        return torch.sqrt(torch.clamp(self._dot(r, r), min=0.0))

    def _coarse_apply(self, coarse: ShardedCoarse, r: torch.Tensor) -> torch.Tensor:
        """Additive two-level coarse correction: restrict (summed over the
        shards), the explicit inverse's matvec, prolong locally."""
        rp = r * coarse.valid[:, None]
        if coarse.modes == 6:
            # rotation mode 3+k = sum (d_n x r_n)_k
            rp = torch.cat([rp, torch.linalg.cross(coarse.dvec, rp, dim=1)], 1)
        rc = self._restrict(coarse, rp)
        xc = (coarse.acinv @ rc.reshape(-1).to(coarse.acinv.dtype)).reshape(
            coarse.n_agg, coarse.modes).to(r.dtype)
        za = self._prolong(coarse, xc)
        if coarse.modes == 6:
            # (P xc)_n = t_A + omega_A x d_n
            return za[:, :3] + torch.linalg.cross(za[:, 3:], coarse.dvec, dim=1)
        return za

    def _make_ops(self, coarse):
        """The masked tangent action and the preconditioner (block-Jacobi,
        plus the coarse term where `coarse`), reading the frozen state and
        the Jacobi inverse that frz last wrote."""
        p, cell, freeN = self._p(self._pcg_dtype), self._cell, self._freeN

        def matvec(v):
            vm = v * freeN
            y = self._assemble(soa_apply_tangent(p, cell.frozen, self._expand_v(vm).T.contiguous()).T)
            return y * freeN + (v - vm)

        def precond(r):
            z = apply_block_jacobi(cell.inv_blocks, freeN, r)
            if coarse is not None:
                z = z + freeN * self._coarse_apply(coarse, r)
            return z

        return matvec, precond

    # ------------------------------------------------------------------
    # the programs (the reference's fused bodies)
    def _init_programs(self, eager: bool) -> None:
        """The rank's state, its bodies' host (captured now on the captured
        route, after their warm-up and `Comm.warm`) and the first route."""
        dev = self.comm.device
        self.captured = dev.type == "cuda" and self.comm.capturable and not eager
        #: the f64 residual takes the fused kernel (`resid_df_route`)
        self._resid_df = resid_df_route(self.soa.p64, self.material, self.options, dev)
        self._freeN = self.data.free_mask.to(self._pcg_dtype)
        self._cell = RankState.zeros(self.part.n_owned, self._pcg_dtype, dev)
        self._host = cuda_graphs.Host(dev, self._rank_bodies(), RANK_SPANS,
                                      {"work": self._cell.work}, {})
        self._routes = {}  # route -> DevicePCGChunk
        #: programs launched: Newton iterations, further chunks, restarts
        self.launched = {"newton": 0, "chunk": 0, "restart": 0}
        if self.captured:
            with self._no_profile():
                self._host.capture(then=self.comm.warm)
        self._route("main")

    def _rank_bodies(self) -> dict:
        """head, resid and frz on the rank's state (module docstring)."""
        cell, opts, pdt = self._cell, self.options, self._pcg_dtype
        use_ew = opts.forcing == "ew"
        p = self._p(pdt)

        def head():
            cell.u.add_(cell.x_prev.to(torch.float64))
            r64 = self._residual64(cell.u, cell.scale)
            norm = torch.sqrt(torch.clamp_min(self._dot(r64, r64), 0.0))
            norm0 = torch.where(cell.first, norm, cell.norm0)
            if pdt == torch.float32:
                floor = 1.2e-6
            else:
                floor = torch.clamp_max(2.2e-14 * norm0 / torch.clamp_min(norm, 1e-300), 0.1)
            eta, lin_tol = device_forcing(norm, cell.prev_norm, cell.eta_prev, cell.first,
                                          opts.pcg_tol, use_ew, floor, cell.stop_newton,
                                          opts.ew_eta_min)
            cell.norm.copy_(norm)
            cell.eta.copy_(eta)
            cell.lin_tol.copy_(lin_tol)
            cell.tol.copy_(lin_tol.to(pdt))
            cell.work.copy_(~(norm <= cell.stop_newton) & ~cell.last & (norm == norm))
            cell.b.copy_(r64.to(pdt))

        def resid():
            cell.b.copy_(self._residual64(cell.u, cell.scale).to(pdt))

        def frz():
            state = soa_freeze(p, self.material, self._expand_u(cell.u).to(pdt).T.contiguous())
            diag = self._assemble(soa_diag_blocks(p, state).permute(2, 0, 1))
            cell.frozen = state
            cell.inv_blocks = jacobi_inverse_blocks(diag, self._freeN)

        return {"head": head, "resid": resid, "frz": frz}

    @contextlib.contextmanager
    def _no_profile(self):
        """The comm's host timing off (a capture takes no host step)."""
        profile, self.comm.profile = self.comm.profile, False
        try:
            yield
        finally:
            self.comm.profile = profile

    def _route(self, name: str) -> DevicePCGChunk:
        """The chunk of route `name` ("main": the solver's preconditioner;
        "fallback": the same with a zero coarse inverse, whose coarse term
        is exactly zero), made at its first use, with the rank's host joined
        to its host; on the captured route its bodies are captured then and
        the route's programs composed of them and of the rank bodies. (On
        the main route the chunk's warm-up reads frz's captured outputs
        before a replay has written them: values it discards, as init0 and
        initx set the state.)"""
        chunk = self._routes.get(name)
        if chunk is not None:
            return chunk
        coarse = self.coarse
        if name == "fallback":
            coarse = dataclasses.replace(coarse, acinv=torch.zeros_like(coarse.acinv))
        matvec, precond = self._make_ops(coarse)
        cell = self._cell
        with self._no_profile():
            chunk = DevicePCGChunk(matvec, precond, (self.part.n_owned, 3), self._pcg_dtype,
                                   self.comm.device, capture=self.captured, dot=self._dot,
                                   b=cell.b, tol=cell.tol)
            chunk.host.join(self._host, PROGRAMS)
            if self.captured:
                for prog in PROGRAMS:
                    chunk.host.compose(prog)
        self._routes[name] = chunk
        return chunk

    def _launch(self, route: str, prog: str) -> DevicePCGChunk:
        """Run the program `prog` of `route` on its chunk's host. No fetch.
        Returns the route's chunk."""
        chunk = self._route(route)
        chunk.host.launch(prog)
        return chunk

    def _newton_iter(self, route, prev_norm, norm0_prev, eta_prev, first_it, stop_newton,
                     last_it):
        """One sharded Newton iteration, the reference's fused program (the
        `iter` program on `route`): one launch and one fetch. Returns (the
        first chunk's state, or None where the tangent work was skipped,
        norm, eta, lin_tol)."""
        cell, opts = self._cell, self.options
        for t, v in ((cell.prev_norm, prev_norm), (cell.norm0, norm0_prev),
                     (cell.eta_prev, eta_prev), (cell.stop_newton, stop_newton),
                     (cell.first, first_it), (cell.last, last_it)):
            t.fill_(v)
        self._route(route).n.fill_(min(opts.pcg_chunk, opts.pcg_maxiter))
        chunk = self._launch(route, "iter")
        self.launched["newton"] += 1
        st, (norm, eta, lin_tol, work) = chunk.fetch_with(
            (cell.norm, cell.eta, cell.lin_tol, cell.work))
        return (st if work > 0.0 else None), norm, eta, lin_tol

    def _drive(self, route, tol, first=None):
        """`drive_chunked_pcg` on `route` at `tol`, from `first` (the
        Newton iteration's first chunk, fetched) or from a `prepare` from
        zero; restarts are `prepare` from x0. Returns (x, iterations,
        converged, rel); x may be the chunk's buffer."""
        chunk = self._route(route)
        opts = self.options

        def prepare(x0):
            if x0 is None and first is not None:
                return first
            if x0 is None:
                chunk.state.x.zero_()
            else:
                chunk.state.x.copy_(x0)
            self._cell.tol.fill_(tol)
            self._launch(route, "prepare")
            self.launched["restart"] += 1
            return chunk.fetch()

        def run(st, n):
            chunk.n.fill_(min(opts.pcg_chunk, int(n)))
            self._launch(route, "run")
            self.launched["chunk"] += 1
            return chunk.fetch()

        return drive_chunked_pcg(prepare, run, tol=tol, chunk_iters=opts.pcg_chunk,
                                 maxiter=opts.pcg_maxiter)

    @property
    def fetches(self) -> int:
        """Host fetches so far, over the routes."""
        return sum(c.fetches for c in self._routes.values())

    @property
    def capture_s(self) -> dict:
        """The seconds of the captures on the captured route: the rank
        bodies' ("rank"), and per route its chunk bodies' and the
        compositions of its programs."""
        if not self.captured:
            return {}
        return {"rank": self._host.capture_s,
                **{r: c.capture_s for r, c in self._routes.items()}}

    def program_stats(self) -> dict:
        """The route ("captured" or "eager"), whether the f64 residual takes
        the fused kernel (`resid_df`), the fetches and the programs
        launched so far, and on the captured route the graph nodes of each
        route's programs and the capture seconds (`capture_s`)."""
        return {"route": "captured" if self.captured else "eager",
                "resid_df": self._resid_df, "fetches": self.fetches,
                "launched": dict(self.launched),
                "graph_nodes": {r: dict(c.graph_nodes) for r, c in self._routes.items()
                                if c.captured},
                "capture_s": self.capture_s}

    # ------------------------------------------------------------------
    # the coarse operator
    def _probe_sweep(self, tables: ShardedProbe, cm) -> torch.Tensor:
        """Coarse-operator probing through the sharded tangent action: per
        (color, mode) probe, the masked probe vector from this shard's
        tables, the u=0 tangent with the halo exchange, and the restriction
        per aggregate summed over the shards. Returns the response stack
        Z [n_probes, n_agg, modes], the same on every rank."""
        pdt = self._pcg_dtype
        coarse = self.coarse
        freeN = self.data.free_mask.to(pdt)
        p = self._p(pdt)
        state0 = soa_freeze(p, self.material,
                            torch.zeros((3, self._n_local), dtype=pdt, device=self.comm.device))
        Bn = tables.Bn_own.to(pdt)
        out = []
        for c, m in np.asarray(cm).tolist():
            v = (tables.color_own == c).to(pdt)[:, None] * Bn[:, :, m]
            vm = v * freeN
            y = self._assemble(
                soa_apply_tangent(p, state0, self._expand_v(vm).T.contiguous()).T) * freeN
            t = y * coarse.valid[:, None]
            if coarse.modes == 6:
                t = torch.cat([t, torch.linalg.cross(coarse.dvec, t, dim=1)], 1)
            out.append(self._restrict(coarse, t))
        return torch.stack(out)

    def _assemble_coarse(self, Z, ctx, dtype) -> torch.Tensor:
        from fea_large_tpu_torch.solvers.multilevel import _assemble_dense_coarse

        dev = self.comm.device
        return _assemble_dense_coarse(
            Z.reshape(-1).to(dtype), torch.as_tensor(ctx["zsrc"], device=dev),
            torch.as_tensor(ctx["dst"], device=dev), ctx["nc"])

    def _run_coarse_probe(self):
        """Probe the coarse operator (every rank), then on rank 0 assemble
        the dense Ac, ridge, factor and invert it, store it by the
        single-device rule (`multilevel._store_acinv`: bf16 on the card
        where that copy stays positive definite), and send the f32 inverse
        and that choice to the other ranks, which round it the same way:
        gloo never sends bf16, and every rank applies the same bits. Frees
        the probe tables."""
        if self.coarse is None:
            return
        from fea_large_tpu_torch.solvers.multilevel import (
            _invert_factor,
            _ridge_and_factor,
            _store_acinv,
        )

        ctx = self._probe_ctx
        pdt = self._pcg_dtype
        Z = self._probe_sweep(ctx["tables"], ctx["cm"])
        acinv = stored = bf16 = None
        if self.comm.rank == 0:
            acinv = _invert_factor(_ridge_and_factor(self._assemble_coarse(Z, ctx, pdt)))
            stored = _store_acinv(acinv, pdt)
            bf16 = torch.tensor([int(stored.dtype == torch.bfloat16)], dtype=torch.int32,
                                device=self.comm.device)
        nc = ctx["nc"]
        acinv = self.comm.broadcast(acinv, (nc, nc), pdt)
        bf16 = bool(self.comm.broadcast(bf16, (1,), torch.int32))
        if stored is None:
            stored = acinv.to(torch.bfloat16) if bf16 else acinv
        del acinv
        self.coarse = dataclasses.replace(self.coarse, acinv=stored)
        self._probe_ctx = {k: v for k, v in ctx.items() if k in ("agg", "dvec", "modes")}

    def _probe_tables(self, agg, color, Bn):
        """This shard's (Bn, color) probe rows for `probe_coarse_matrix`."""
        part, p = self.part, self.comm.rank
        real = part.owned_global[p] >= 0
        color_own = np.full(part.n_owned, -1, np.int64)
        color_own[real] = color[agg[part.owned_global[p][real]]]
        return part.from_global(Bn)[p], color_own

    def probe_coarse_matrix(self) -> torch.Tensor:
        """The probed (pre-ridge) dense coarse matrix Ac in f32, on every
        rank: the test hook for the check against the host Galerkin product
        (`multilevel._host_coarse_matrix[_rbm]` on the same aggregation)."""
        from fea_large_tpu_torch.solvers.multilevel import _probe_plan

        ctx = self._probe_ctx
        agg, dvec, modes = ctx["agg"], ctx["dvec"], ctx["modes"]
        color, Bn, _, cm, zsrc, dst, nc = _probe_plan(
            self.mesh.conn_host, agg, self._n_agg, modes, dvec)
        Bn_own, color_own = self._probe_tables(agg, color, Bn)
        dev = self.comm.device
        tables = ShardedProbe(Bn_own=torch.as_tensor(np.asarray(Bn_own, np.float32), device=dev),
                              color_own=torch.as_tensor(color_own, device=dev))
        Z = self._probe_sweep(tables, cm)
        return self._assemble_coarse(Z, {"zsrc": zsrc, "dst": dst, "nc": nc}, torch.float32)

    # ------------------------------------------------------------------
    def _step_pcg(self, u, scale, lin_tol=None):
        """One chunked PCG solve of the Newton system at u (from zero), on
        the shared control loop (`linear.drive_chunked_pcg`): (u + du,
        iterations, converged, final relative residual)."""
        opts = self.options
        tol = opts.pcg_tol if lin_tol is None else lin_tol
        self._cell.scale.fill_(float(scale))
        self._cell.u.copy_(u)
        x, total, converged, rel = self._drive("main", tol)
        return u + x.to(u.dtype), total, converged, rel

    # ------------------------------------------------------------------
    def _memory(self, soa_bytes: int, n_nodes: int, El: int, q: int) -> dict:
        pdt_size = torch.empty((), dtype=self._pcg_dtype).element_size()
        state_b = (3 * 9 + 2) * q * El * pdt_size  # F, S, A + alpha, beta
        pcg_b = 4 * n_nodes * 3 * pdt_size  # x, r, z, p
        jacobi_b = n_nodes * 9 * pdt_size
        coarse_sharded = coarse_replicated = 0
        if self.coarse is not None:
            coarse_replicated = _nbytes(self.coarse.acinv)
            coarse_sharded = _nbytes(self.coarse) - coarse_replicated
        static = _nbytes(self.data)
        return {
            "static_partition_bc": static,
            "static_soa_tables": soa_bytes,
            "static_coarse_maps": coarse_sharded,
            "static_coarse_replicated": coarse_replicated,
            "work_frozen_state": state_b,
            "work_pcg_vectors": pcg_b,
            "work_jacobi_blocks": jacobi_b,
            "total_per_shard": (static + soa_bytes + coarse_sharded + coarse_replicated
                                + state_b + pcg_b + jacobi_b),
        }

    def memory_report(self) -> dict:
        """This shard's device-memory budget (bytes) by category: static
        tables (partition maps and BC data, SoA element tables, coarse maps,
        the replicated coarse inverse) and the per-solve working set
        (frozen tangent state, PCG vectors, Jacobi blocks), the
        reference's categories."""
        q, El = self.soa.p64.gradN.shape[0], self.soa.p64.gradN.shape[-1]
        return {"n_shards": self.part.n_shards, "owned_nodes": self.part.n_owned,
                "halo_nodes": self.part.n_halo, "elements": El,
                **self._memory(_nbytes(self.soa), self.part.n_owned, El, q)}

    def zero_u(self) -> torch.Tensor:
        return torch.zeros((self.part.n_owned, 3), dtype=torch.float64, device=self.comm.device)

    def u_global(self, u: torch.Tensor) -> np.ndarray:
        """The global [N, 3] from every shard's u (gathered in rank order)."""
        shards = np.stack([x.cpu().numpy() for x in self.comm.gather(u)])
        return self.part.to_global(shards, self.mesh.n_nodes)

    def u_from_global(self, u) -> torch.Tensor:
        """Global [N, 3] -> this shard's owned layout (checkpoint resume)."""
        p = self.comm.rank
        local = self.part.from_global(np.asarray(u))[p] * self.part.own_mask[p][:, None]
        return torch.as_tensor(local, dtype=torch.float64, device=self.comm.device)

    def _newton(self, u, scale):
        """Newton iteration at the load factor `scale`, the reference's
        sharded loop: one `iter` program per iteration (the direction of
        the previous iteration is applied at the start of the next), the
        first CG chunk continued by `drive_chunked_pcg`, and the two-level
        -> Jacobi fallback. Returns (u, converged, record)."""
        opts = self.options
        t0 = time.perf_counter()
        scale = float(scale)
        cell = self._cell
        cell.scale.fill_(scale)
        cell.u.copy_(self._impose(u, cell.scale))
        cell.x_prev.zero_()
        norms, pcg_iters = [], []
        norm0 = None
        stop_n = None
        eta = 0.5  # Eisenstat-Walker initial forcing
        prev_norm = 1.0
        # two-level -> Jacobi fallback: on near-critical states the coarse
        # space can aim the preconditioner at a negative tangent direction
        # and break CG down where block-Jacobi still converges. The rest of
        # the increment runs the "fallback" route, whose zero coarse
        # inverse makes the coarse term exactly zero.
        route = "main"
        for it in range(opts.max_newton):
            stop_dev = opts.newton_atol if norm0 is None else stop_n
            st0, norm, eta_v, tol_v = self._newton_iter(
                route, prev_norm, norm0 or 1.0, eta, norm0 is None, stop_dev,
                it == opts.max_newton - 1)
            if norm != norm:  # NaN: poisoned state; fail -> bisection
                break
            norms.append(norm)
            if norm0 is None:
                norm0 = max(norm, 1e-300)
                stop_n = max(opts.newton_rtol * norm0, opts.newton_atol)
            if norm <= stop_n:
                rec = IncrementRecord(scale, it, norms, pcg_iters, time.perf_counter() - t0)
                return cell.u.clone(), True, rec
            if st0 is None:
                # the final allowed iteration: its direction could never be
                # applied (the update is deferred to the next iteration)
                break
            prev_norm = norm
            eta = eta_v
            x, lin_iters, lin_ok, lin_rel = self._drive(route, tol_v, first=st0)
            pcg_iters.append(int(lin_iters))
            cell.x_prev.copy_(x)
            # inexact Newton: accept a stagnated step that made substantial
            # progress; an early breakdown at rel ~ O(1) aborts -> bisection
            accepted = bool(lin_ok) or float(lin_rel) <= 1e-3
            if not lin_ok and self.coarse is not None and route == "main":
                # the first two-level breakdown of this increment: Jacobi
                # alone for the rest of it, and where the broken-down
                # direction was not acceptable, this solve again
                route = "fallback"
                self.precond_fallbacks += 1
                if not accepted:
                    x, fb_iters, lin_ok, lin_rel = self._drive(route, tol_v)
                    pcg_iters[-1] += int(fb_iters)
                    cell.x_prev.copy_(x)
                    accepted = bool(lin_ok) or float(lin_rel) <= 1e-3
            if not accepted:
                break
        rec = IncrementRecord(scale, len(norms), norms, pcg_iters, time.perf_counter() - t0)
        return cell.u.clone(), False, rec

    def solve(self, u0=None, callback=None, start_factor: float = 0.0) -> SolveResult:
        """Incremental loading from `start_factor` to 1 in `n_steps`
        increments, with bisection on Newton failure (`step_load`);
        `callback(record, u)` after each converged increment, on every
        rank. u is this shard's."""
        return step_load(self, self.zero_u() if u0 is None else u0, callback, start_factor)
