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
Both precisions run the same host loop:

  precision="f64"    f64 residual + f64 tangent and PCG (parity path)
  precision="mixed"  f64 residual + f32 tangent and PCG

The f64 residual is the plain f64 element pass, as in the reference.

Every rank runs the same host loop on the same scalars (every scalar the
loop reads comes out of the fixed-order sum), so the ranks take the same
branches and issue the same collectives.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fea_large_tpu_torch.dist.comm import Comm, LocalComm
from fea_large_tpu_torch.dist.partition import partition_mesh
from fea_large_tpu_torch.ops.soa import (
    ScatterBuckets,
    SoAProblem,
    _np_inv_det_3x3,
    soa_apply_tangent,
    soa_diag_blocks,
    soa_freeze,
    soa_internal_force,
)
from fea_large_tpu_torch.solvers.linear import (
    apply_block_jacobi,
    drive_chunked_pcg,
    jacobi_inverse_blocks,
    pcg_chunk,
    pcg_init,
)
from fea_large_tpu_torch.solvers.newton import (
    IncrementRecord,
    SolveResult,
    SolverOptions,
    newton_lin_tol,
)


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
    acinv: torch.Tensor  # [modes*Nc, modes*Nc]
    n_agg: int
    modes: int


@dataclasses.dataclass(frozen=True)
class ShardedProbe:
    """Transient tables of the coarse-operator probing (freed after setup):
    the sweep runs through the sharded tangent action, so each rank holds
    only its shard's rows."""

    Bn_own: torch.Tensor  # f32 [n, 3, modes] per-node basis columns
    color_own: torch.Tensor  # int64 [n] aggregate color (-1 at padding)


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

    def problem(dtype):
        return SoAProblem(n_nodes=n_local, gradN=torch.as_tensor(g, dtype=dtype, device=device),
                          detJxW=torch.as_tensor(v, dtype=dtype, device=device),
                          conn_T=conn, buckets=buckets)

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
    two-level -> Jacobi fallback, bisection) is the reference's."""

    def __init__(self, mesh, material, bc, f_ext=None, options: SolverOptions | None = None,
                 comm: Comm | None = None, partition_method: str = "slab"):
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

    def _x0(self, x0: torch.Tensor) -> torch.Tensor:
        return x0

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
        d = self.data
        return d.free_mask * u + (1.0 - d.free_mask) * (float(scale) * d.bc_values)

    def _residual64(self, u: torch.Tensor, scale) -> torch.Tensor:
        d, p64 = self.data, self.soa.p64
        state = soa_freeze(p64, self.material, self._expand_u(u).T.contiguous())
        f = self._assemble(soa_internal_force(p64, state).T)
        return (float(scale) * d.f_ext - f) * d.free_mask

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

    def _make_ops(self, coarse, state, inv_blocks, freeN):
        p = self._p(self._pcg_dtype)

        def matvec(v):
            vm = v * freeN
            y = self._assemble(soa_apply_tangent(p, state, self._expand_v(vm).T.contiguous()).T)
            return y * freeN + (v - vm)

        def precond(r):
            z = apply_block_jacobi(inv_blocks, freeN, r)
            if coarse is not None:
                z = z + freeN * self._coarse_apply(coarse, r)
            return z

        return matvec, precond

    def _prepare_common(self, coarse, u, r64, tol, x0):
        """Freeze, block-Jacobi and PCG init from a computed residual."""
        pdt = self._pcg_dtype
        freeN = self.data.free_mask.to(pdt)
        p = self._p(pdt)
        state = soa_freeze(p, self.material, self._expand_u(u).to(pdt).T.contiguous())
        diag = self._assemble(soa_diag_blocks(p, state).permute(2, 0, 1))
        inv_blocks = jacobi_inverse_blocks(diag, freeN)
        matvec, precond = self._make_ops(coarse, state, inv_blocks, freeN)
        st = pcg_init(matvec, r64.to(pdt), precond, x0=None if x0 is None else self._x0(x0),
                      tol=float(tol), dot=self._dot)
        return st, state, inv_blocks, matvec, precond

    def _prepare(self, coarse, u, scale, tol, x0):
        """Residual, then `_prepare_common` from x0 (a restart)."""
        r64 = self._residual64(u, scale)
        st, state, inv_blocks, _, _ = self._prepare_common(
            coarse, u, r64, tol, x0.to(self._pcg_dtype))
        return st, state, inv_blocks

    def _chunk(self, coarse, st, state, inv_blocks, n):
        freeN = self.data.free_mask.to(self._pcg_dtype)
        matvec, precond = self._make_ops(coarse, state, inv_blocks, freeN)
        return pcg_chunk(matvec, st, precond, dot=self._dot,
                         maxiter=min(self.options.pcg_chunk, int(n)))

    def _newton_iter(self, coarse, u, x_prev, scale, prev_norm, norm0_prev, eta_prev,
                     first_it, stop_newton, last_it):
        """One sharded Newton iteration (the reference's fused program):
        apply the previous direction, the f64 residual and its norm, the
        forcing (`newton_lin_tol`: Eisenstat-Walker with the precision
        floor), then freeze,
        block-Jacobi and the first CG chunk. The tangent work is skipped
        (st None) where the iteration cannot take a step: the residual
        already meets the stop, or this is the last allowed iteration."""
        opts = self.options
        u = u + x_prev.to(u.dtype)
        r64 = self._residual64(u, scale)
        norm = float(torch.sqrt(torch.clamp(self._dot(r64, r64), min=0.0)))
        if norm <= stop_newton or last_it or norm != norm:
            return u, None, None, None, norm, eta_prev, None
        norm0 = norm if first_it else norm0_prev
        lin_tol, eta = newton_lin_tol(opts, 0 if first_it else 1, [prev_norm, norm], norm0,
                                      eta_prev)
        st, state, inv_blocks, matvec, precond = self._prepare_common(
            coarse, u, r64, lin_tol, None)
        st = pcg_chunk(matvec, st, precond, dot=self._dot,
                       maxiter=min(opts.pcg_chunk, opts.pcg_maxiter))
        return u, st, state, inv_blocks, norm, eta, lin_tol

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
        the dense Ac, ridge, factor and invert it, and send the inverse to
        the other ranks: every rank applies the same bits. Frees the probe
        tables."""
        if self.coarse is None:
            return
        from fea_large_tpu_torch.solvers.multilevel import _invert_factor, _ridge_and_factor

        ctx = self._probe_ctx
        pdt = self._pcg_dtype
        Z = self._probe_sweep(ctx["tables"], ctx["cm"])
        acinv = None
        if self.comm.rank == 0:
            acinv = _invert_factor(_ridge_and_factor(self._assemble_coarse(Z, ctx, pdt)))
        nc = ctx["nc"]
        acinv = self.comm.broadcast(acinv, (nc, nc), pdt)
        self.coarse = dataclasses.replace(self.coarse, acinv=acinv)
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
        cell = {}

        def prepare(x0):
            x0 = torch.zeros_like(u) if x0 is None else x0.to(u.dtype)
            st, cell["state"], cell["inv_blocks"] = self._prepare(self.coarse, u, scale, tol, x0)
            return st

        def chunk(st, n):
            return self._chunk(self.coarse, st, cell["state"], cell["inv_blocks"], n)

        x, total, converged, rel = drive_chunked_pcg(
            prepare, chunk, tol=tol, chunk_iters=opts.pcg_chunk, maxiter=opts.pcg_maxiter)
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
        sharded loop: one `_newton_iter` per iteration (the direction of
        the previous iteration is applied at the start of the next), the
        first CG chunk continued by `drive_chunked_pcg`, and the two-level
        -> Jacobi fallback. Returns (u, converged, record)."""
        opts = self.options
        t0 = time.perf_counter()
        scale = float(scale)
        u = self._impose(u, scale)
        norms, pcg_iters = [], []
        norm0 = None
        stop_n = None
        eta = 0.5  # Eisenstat-Walker initial forcing
        prev_norm = 1.0
        # two-level -> Jacobi fallback: on near-critical states the coarse
        # space can aim the preconditioner at a negative tangent direction
        # and break CG down where block-Jacobi still converges. `coarse` is
        # swapped for a copy with a zero inverse, whose coarse term is
        # exactly zero.
        coarse = self.coarse
        x_prev = torch.zeros((self.part.n_owned, 3), dtype=self._pcg_dtype,
                             device=self.comm.device)
        for it in range(opts.max_newton):
            stop_dev = opts.newton_atol if norm0 is None else stop_n
            u, st0, state, inv_blocks, norm, eta_v, tol_v = self._newton_iter(
                coarse, u, x_prev, scale, prev_norm, norm0 or 1.0, eta, norm0 is None,
                stop_dev, it == opts.max_newton - 1)
            if norm != norm:  # NaN: poisoned state; fail -> bisection
                break
            norms.append(norm)
            if norm0 is None:
                norm0 = max(norm, 1e-300)
                stop_n = max(opts.newton_rtol * norm0, opts.newton_atol)
            if norm <= stop_n:
                rec = IncrementRecord(scale, it, norms, pcg_iters, time.perf_counter() - t0)
                return u, True, rec
            if st0 is None:
                # the final allowed iteration: its direction could never be
                # applied (the update is deferred to the next iteration)
                break
            prev_norm = norm
            eta = eta_v
            cell = {"state": state, "inv_blocks": inv_blocks}

            def prepare(x0, _u=u, _tol=tol_v, _coarse=coarse):
                if x0 is None:
                    return st0
                st, cell["state"], cell["inv_blocks"] = self._prepare(
                    _coarse, _u, scale, _tol, x0.to(torch.float64))
                return st

            def chunk(st, n, _coarse=coarse):
                return self._chunk(_coarse, st, cell["state"], cell["inv_blocks"], n)

            x, lin_iters, lin_ok, lin_rel = drive_chunked_pcg(
                prepare, chunk, tol=tol_v, chunk_iters=opts.pcg_chunk,
                maxiter=opts.pcg_maxiter)
            pcg_iters.append(int(lin_iters))
            x_prev = x
            # inexact Newton: accept a stagnated step that made substantial
            # progress; an early breakdown at rel ~ O(1) aborts -> bisection
            accepted = bool(lin_ok) or float(lin_rel) <= 1e-3
            if not lin_ok and coarse is not None and coarse is self.coarse:
                # the first two-level breakdown of this increment: Jacobi
                # alone for the rest of it, and where the broken-down
                # direction was not acceptable, this solve again
                coarse = dataclasses.replace(self.coarse,
                                             acinv=torch.zeros_like(self.coarse.acinv))
                self.precond_fallbacks += 1
                if not accepted:

                    def prepare_fb(x0, _u=u, _tol=tol_v, _c=coarse):
                        xx = torch.zeros_like(_u) if x0 is None else x0.to(torch.float64)
                        st, cell["state"], cell["inv_blocks"] = self._prepare(
                            _c, _u, scale, _tol, xx)
                        return st

                    x, fb_iters, lin_ok, lin_rel = drive_chunked_pcg(
                        prepare_fb,
                        lambda st, n, _c=coarse: self._chunk(
                            _c, st, cell["state"], cell["inv_blocks"], n),
                        tol=tol_v, chunk_iters=opts.pcg_chunk, maxiter=opts.pcg_maxiter)
                    pcg_iters[-1] += int(fb_iters)
                    x_prev = x
                    accepted = bool(lin_ok) or float(lin_rel) <= 1e-3
            if not accepted:
                break
        rec = IncrementRecord(scale, len(norms), norms, pcg_iters, time.perf_counter() - t0)
        return u, False, rec

    def solve(self, u0=None, callback=None, start_factor: float = 0.0) -> SolveResult:
        """Incremental loading from `start_factor` to 1 in `n_steps`
        increments, with bisection on Newton failure; `callback(record, u)`
        after each converged increment, on every rank. u is this shard's."""
        opts = self.options
        u = self.zero_u() if u0 is None else u0
        history = []
        lam = float(start_factor)
        dlam_nominal = 1.0 / opts.n_steps
        dlam = dlam_nominal
        bisections = 0
        while lam < 1.0 - 1e-12:
            target = min(lam + dlam, 1.0)
            u_try, ok, rec = self._newton(u, target)
            history.append(rec)
            if ok:
                u, lam = u_try, target
                if callback is not None:
                    callback(rec, u)
                dlam = min(2.0 * dlam, dlam_nominal, 1.0 - lam)
                if dlam <= 0.0:
                    dlam = 1.0 - lam
                bisections = 0
            else:
                bisections += 1
                if bisections > opts.max_bisections:
                    return SolveResult(u=u, converged=False, history=history)
                dlam *= 0.5
        return SolveResult(u=u, converged=True, history=history)
