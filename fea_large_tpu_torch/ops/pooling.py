"""Lattice-block coarse aggregation: pooled restrict/prolong, no indexed ops
(counterpart of the single-lattice part of `fea_large_tpu/ops/pooling.py`).

On a Kuhn box the two-level aggregates are BLOCKS of the cell lattice.
Every node class is a regular grid, so a node's aggregate is an affine
function of its grid index (block = index // block_size, the trailing
boundary plane clamped into the last block). Restrict is then a per-class
reshape-sum over block windows, with the clamped boundary layer folded
into the last block, and prolong its exact transpose, a broadcast and a
slice. Same aggregate assignment as an indexed transfer (`agg_host`).
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


def _best_block(cells, target_agg: int) -> tuple:
    """Per-axis block sizes whose aggregate count is closest (log ratio) to
    `target_agg`, weighed against block anisotropy, tie-breaking toward
    larger blocks."""
    best = None
    for bx in range(1, min(cells[0], 16) + 1):
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
