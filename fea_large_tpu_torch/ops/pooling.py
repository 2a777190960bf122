"""Lattice-block coarse aggregation: pooled restrict/prolong, no indexed ops
(counterpart of `fea_large_tpu/ops/pooling.py`).

On a Kuhn box the two-level aggregates are BLOCKS of the cell lattice.
Every node class is a regular grid, so a node's aggregate is an affine
function of its grid index (block = index // block_size, the trailing
boundary plane clamped into the last block). Restrict is then a per-class
reshape-sum over block windows, with the clamped boundary layer folded
into the last block, and prolong its exact transpose, a broadcast and a
slice. Same aggregate assignment as an indexed transfer (`agg_host`).

The same holds on the slab-sharded lattice (`ShardedLatticePool`): each
shard pools its local class grids, the x axis with one OVERFLOW block so
that the owned right boundary plane lands in the next slab's first block,
places the pooled blocks into the global coarse grid at its slab offset,
and a sum over the shards (passed in: the solver's fixed-order sum)
assembles the global coarse residual on every shard.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from fea_large_tpu_torch.mesh.structure import BoxStructure


def _pool_axis(g: torch.Tensor, ax: int, b: int, nb: int) -> torch.Tensor:
    """Sum windows of `b` along axis `ax` into `nb` blocks. g.shape[ax] may
    be nb*b (exact), less (zero-padded: missing nodes add nothing) or more
    (the clamped trailing boundary layer, added into the last block)."""
    size = g.shape[ax]
    core_len = nb * b
    extra = None
    if size > core_len:
        core = g.narrow(ax, 0, core_len)
        extra = g.narrow(ax, core_len, size - core_len)
    elif size < core_len:
        pad = [0, 0] * (g.ndim - 1 - ax) + [0, core_len - size]
        core = Fn.pad(g, pad)
    else:
        core = g
    if b == 1:
        pooled = core
    else:
        shape = core.shape[:ax] + (nb, b) + core.shape[ax + 1:]
        pooled = core.reshape(shape).sum(ax + 1)
    if extra is not None:
        pooled = torch.cat(
            [
                pooled.narrow(ax, 0, nb - 1),
                pooled.narrow(ax, nb - 1, 1) + extra.sum(ax, keepdim=True),
            ],
            ax,
        )
    return pooled


def _unpool_axis(w: torch.Tensor, ax: int, b: int, size: int) -> torch.Tensor:
    """Exact transpose of `_pool_axis`: broadcast each block value over its
    `b`-window (the clamped boundary layer reads the last block; padded
    positions are cut off)."""
    nb = w.shape[ax]
    core_len = nb * b
    if b == 1:
        rep = w
    else:
        rep = w.unsqueeze(ax + 1).expand(
            w.shape[: ax + 1] + (b,) + w.shape[ax + 1:]
        ).reshape(w.shape[:ax] + (core_len,) + w.shape[ax + 1:])
    if size > core_len:
        last = w.narrow(ax, nb - 1, 1)
        rep = torch.cat([rep] + [last] * (size - core_len), ax)
    elif size < core_len:
        rep = rep.narrow(ax, 0, size)
    return rep


@dataclasses.dataclass(frozen=True)
class LatticePool:
    """Lattice-block aggregation of a Kuhn box's nodes.

    block  (bx, by, bz) cells per aggregate block
    nb     (nbx, nby, nbz) = ceil(cells / block) blocks per axis; the node
           at class-grid index (i, j, k) belongs to aggregate
           ravel(min(i//bx, nbx-1), ..., nb)
    """

    structure: BoxStructure
    block: tuple
    nb: tuple

    @property
    def n_agg(self) -> int:
        return self.nb[0] * self.nb[1] * self.nb[2]

    def agg_host(self) -> np.ndarray:
        """i64[N] aggregate id per node (host-side: feeds the centroids,
        rotational arms and the probing plan)."""
        st = self.structure
        out = []
        for k in range(len(st.classes)):
            gx, gy, gz = st.class_dims[k]
            i, j, kz = np.meshgrid(
                np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij"
            )
            bi = np.minimum(i // self.block[0], self.nb[0] - 1)
            bj = np.minimum(j // self.block[1], self.nb[1] - 1)
            bk = np.minimum(kz // self.block[2], self.nb[2] - 1)
            out.append(((bi * self.nb[1] + bj) * self.nb[2] + bk).ravel())
        return np.concatenate(out).astype(np.int64)

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        """[N, C] -> [n_agg, C]: per-class pooled block sums, summed over
        classes in class order (channel-first internally)."""
        st = self.structure
        vT = v.T
        out = None
        for k in range(len(st.classes)):
            gx, gy, gz = st.class_dims[k]
            b0 = st.class_base[k]
            g = vT[:, b0: b0 + gx * gy * gz].reshape(-1, gx, gy, gz)
            for ax in range(3):
                g = _pool_axis(g, ax + 1, self.block[ax], self.nb[ax])
            out = g if out is None else out + g
        return out.reshape(out.shape[0], self.n_agg).T

    def prolong(self, w: torch.Tensor) -> torch.Tensor:
        """[n_agg, C] -> [N, C]: each node reads its block's value."""
        st = self.structure
        wg = w.T.reshape(-1, *self.nb)
        parts = []
        for k in range(len(st.classes)):
            dims = st.class_dims[k]
            g = wg
            for ax in range(3):
                g = _unpool_axis(g, ax + 1, self.block[ax], dims[ax])
            parts.append(g.reshape(g.shape[0], -1))
        return torch.cat(parts, 1).T


def _best_block(cells, target_agg: int, bx_choices=None) -> tuple:
    """Per-axis block sizes whose aggregate count is closest (log ratio) to
    `target_agg`, weighed against block anisotropy, tie-breaking toward
    larger blocks; bx from `bx_choices` where given."""
    best = None
    for bx in bx_choices or range(1, min(cells[0], 16) + 1):
        for by in range(1, min(cells[1], 16) + 1):
            for bz in range(1, min(cells[2], 16) + 1):
                nb = tuple(-(-c // b) for c, b in zip(cells, (bx, by, bz)))
                n_agg = nb[0] * nb[1] * nb[2]
                miss = abs(math.log(n_agg / max(target_agg, 1)))
                aspect = max(bx, by, bz) / min(bx, by, bz)
                key = (miss + 0.3 * math.log(aspect), -bx * by * bz)
                if best is None or key < best[0]:
                    best = (key, (bx, by, bz))
    return best[1]


def make_lattice_pool(st: BoxStructure, target_agg: int) -> LatticePool:
    """Pick a near-cubic block size hitting ~`target_agg` aggregates."""
    block = _best_block(st.cells, target_agg)
    nb = tuple(-(-c // bb) for c, bb in zip(st.cells, block))
    return LatticePool(structure=st, block=block, nb=nb)


@dataclasses.dataclass(frozen=True)
class ShardedLatticePool:
    """Slab-sharded lattice pooling (dist/structured_solver.py): shard p holds
    the local box (cp, ny, nz) = slab p of the global lattice; its x-block
    range is [p*nbl, p*nbl + nbl], with one OVERFLOW block (nbl) for the
    owned right boundary plane, which belongs to the NEXT slab's first block
    (or, on the last shard, clamps into the global last block, folded after
    the sum). Requires bx | cp, so that blocks never straddle shards.

    The pair is the exact global transpose: the caller masks `restrict`'s
    input by ownership (each node summed once); `prolong` reads the summed
    coarse solution, and the two shards that share a boundary plane read the
    same block, so prolonged fields are consistent (dist/structured.py)."""

    local: BoxStructure  # the per-shard local sub-box
    block: tuple
    nb_global: tuple  # (NBx, NBy, NBz) over the GLOBAL lattice
    nbl: int  # local x blocks = cells_per_shard // bx

    @property
    def n_agg(self) -> int:
        return self.nb_global[0] * self.nb_global[1] * self.nb_global[2]

    def _local_nb(self) -> tuple:
        return (self.nbl + 1, self.nb_global[1], self.nb_global[2])

    def restrict(self, v: torch.Tensor, p: int, psum) -> torch.Tensor:
        """Owner-masked local field [N_loc, C] of shard p -> [n_agg, C],
        summed over the shards by `psum` (a callable; the identity returns
        this shard's part, placed in the global block grid)."""
        st = self.local
        nb = self._local_nb()
        vT = v.T
        out = None
        for k in range(len(st.classes)):
            gx, gy, gz = st.class_dims[k]
            b0 = st.class_base[k]
            g = vT[:, b0: b0 + gx * gy * gz].reshape(-1, gx, gy, gz)
            for ax in range(3):
                g = _pool_axis(g, ax + 1, self.block[ax], nb[ax])
            out = g if out is None else out + g
        NBx = self.nb_global[0]
        buf = out.new_zeros((out.shape[0], NBx + 1) + tuple(out.shape[2:]))
        buf[:, p * self.nbl: p * self.nbl + self.nbl + 1] = out
        buf = psum(buf)
        # the global clamp: block NBx only receives the last shard's
        # trailing boundary plane, which belongs to block NBx - 1
        rc = torch.cat([buf[:, : NBx - 1], buf[:, NBx - 1: NBx] + buf[:, NBx:]], 1)
        return rc.reshape(rc.shape[0], self.n_agg).T

    def prolong(self, w: torch.Tensor, p: int) -> torch.Tensor:
        """[n_agg, C] (the same on every shard) -> shard p's local
        consistent field [N_loc, C]."""
        NBx, NBy, NBz = self.nb_global
        wg = w.T.reshape(-1, NBx, NBy, NBz)
        # the last x-block once more: the last shard's overflow block reads
        # it (the global clamp, transpose of the fold above)
        wg = torch.cat([wg, wg[:, NBx - 1: NBx]], 1)
        loc = wg[:, p * self.nbl: p * self.nbl + self.nbl + 1]
        st = self.local
        parts = []
        for k in range(len(st.classes)):
            dims = st.class_dims[k]
            g = loc
            for ax in range(3):
                g = _unpool_axis(g, ax + 1, self.block[ax], dims[ax])
            parts.append(g.reshape(g.shape[0], -1))
        return torch.cat(parts, 1).T


def make_sharded_lattice_pool(global_st: BoxStructure, local_st: BoxStructure,
                              target_agg: int) -> ShardedLatticePool:
    """Block choice for the slab-sharded lattice: near-cubic toward
    ~`target_agg` aggregates, with bx a divisor of the slab depth."""
    cells = global_st.cells
    cp = local_st.cells[0]
    block = _best_block(cells, target_agg,
                        bx_choices=[d for d in range(1, cp + 1) if cp % d == 0])
    nb = tuple(-(-c // bb) for c, bb in zip(cells, block))
    return ShardedLatticePool(local=local_st, block=block, nb_global=nb, nbl=cp // block[0])


def global_pool_of(sp: ShardedLatticePool, global_st: BoxStructure) -> LatticePool:
    """The single-lattice pool with the SAME global aggregate assignment as
    `sp` (host-side aggregate ids for the arms, centroids and probing plan):
    global block g // bx with g = p*cp + i equals p*nbl + i // bx (bx | cp),
    and both clamp the global trailing plane into block NBx - 1."""
    return LatticePool(structure=global_st, block=sp.block, nb=sp.nb_global)
