"""Structured slab partition of a Kuhn box (counterpart of
`fea_large_tpu/dist/structured.py`): the distributed path without indexed
halo maps.

Slab-cut the CELL lattice along x into S contiguous slabs of equal cell
count (nx % S == 0; any other mesh takes the general `dist.partition`
path). Each shard's local region, its own cells plus every node they
touch, is itself a Kuhn box, so each shard carries a local `BoxStructure`
and runs the single-device lattice passes (ops/soa.py) on it.

Ownership follows `dist.partition`'s rule (the lowest-numbered touching
shard owns): node classes with x-extent (d[0] == 1) live strictly inside
one slab; classes without (d[0] == 0) have one shared plane per slab
boundary, owned by the LOWER shard. Hence:

  * a shard's halo is exactly its LEFT boundary plane (local x-index 0 of
    each d[0] == 0 class), owned by shard p - 1 (none on shard 0);
  * halo GATHER = one ring hop carrying each shard's RIGHT plane (local
    x-index cp, a static slice) to shard p + 1;
  * halo REDUCE = the reverse hop returning LEFT-plane partial element sums
    to their owner's right plane (a static slice add).

Local node numbering is the local CLASS-GRID order (what the lattice
passes require), not [owned | halo]: ownership is a mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.mesh.structure import (
    BoxStructure,
    build_box_structure,
)


@dataclasses.dataclass(frozen=True)
class StructuredPartition:
    """Host-side structured slab partition of a Kuhn box (numpy and static
    metadata; each rank puts its rows on its device in the solver).

    Every shard has the IDENTICAL local box (cp = nx/S cells along x), so
    the local `BoxStructure` and all static slice geometry are shared;
    only the data (coords-derived tables, masks, global ids) vary by
    shard.
    """

    n_shards: int
    cells_per_shard: int  # cp: x cell layers per shard
    local: BoxStructure  # the per-shard local sub-box (same on all shards)
    global_structure: BoxStructure
    local_to_global: np.ndarray  # i64[S, N_loc] global node id of each local node
    own_mask: np.ndarray  # f64[S, N_loc] 1 where this shard owns the node
    #: classes with d[0]==0, i.e. the ones with a shared boundary plane
    #: (class index into local.classes; the plane of class k is the static
    #: x-slice of its local grid)
    plane_classes: tuple

    @property
    def n_local(self) -> int:
        return self.local.n_nodes

    @property
    def plane_size(self) -> int:
        """Total nodes in one exchange plane (sum over plane classes)."""
        return sum(
            self.local.class_dims[k][1] * self.local.class_dims[k][2]
            for k in self.plane_classes
        )

    def from_global(self, x: np.ndarray) -> np.ndarray:
        """Global nodal array [N, ...] -> shard-local class-grid layout
        [S, N_loc, ...] (halo slots carry the true global values)."""
        return x[self.local_to_global]

    def to_global(self, x_shards: np.ndarray) -> np.ndarray:
        """Owned shard values [S, N_loc, ...] -> global [N, ...] (each
        global node taken from its unique owner)."""
        N = self.global_structure.n_nodes
        out = np.zeros((N, *x_shards.shape[2:]), x_shards.dtype)
        for p in range(self.n_shards):
            own = self.own_mask[p] > 0
            out[self.local_to_global[p][own]] = x_shards[p][own]
        return out

    def elem_global(self) -> np.ndarray:
        """i64[S, El] global element ids of each shard's elements, in the
        LOCAL element order (tet-slot-major over the local cell lattice) —
        elements partition exactly (no padding, no overlap)."""
        st, lo = self.global_structure, self.local
        nynz = st.cells[1] * st.cells[2]
        C, Cl = st.n_cells, lo.n_cells
        out = np.empty((self.n_shards, lo.n_tets * Cl), np.int64)
        for p in range(self.n_shards):
            x0 = p * self.cells_per_shard
            for t in range(st.n_tets):
                out[p, t * Cl : (t + 1) * Cl] = (
                    t * C + x0 * nynz + np.arange(Cl)
                )
        return out


def structured_partition(st: BoxStructure, n_shards: int) -> StructuredPartition:
    """Slab-cut the Kuhn box `st` along x into `n_shards` equal cell slabs.

    Raises ValueError when nx % n_shards != 0 (callers fall back to the
    general `dist.partition.partition_mesh`)."""
    nx, ny, nz = st.cells
    S = n_shards
    if S < 1 or nx % S != 0:
        raise ValueError(
            f"structured slab partition needs nx % n_shards == 0 "
            f"(nx={nx}, n_shards={S})"
        )
    cp = nx // S
    # element_type is recoverable from the class count (1 = tet4, 8 = tet10)
    element_type = "tet4" if len(st.classes) == 1 else "tet10"
    local = build_box_structure(cp, ny, nz, element_type)
    assert local.classes == st.classes  # same numbering convention

    N_loc = local.n_nodes
    l2g = np.empty((S, N_loc), np.int64)
    own = np.ones((S, N_loc))
    plane_classes = []
    for k, d in enumerate(local.classes):
        lgx, lgy, lgz = local.class_dims[k]
        ggx, gy, gz = st.class_dims[k]
        assert (lgy, lgz) == (gy, gz)
        if d[0] == 0:
            plane_classes.append(k)
        i, j, kz = np.meshgrid(
            np.arange(lgx), np.arange(lgy), np.arange(lgz), indexing="ij"
        )
        lidx = local.class_base[k] + ((i * lgy + j) * lgz + kz).ravel()
        for p in range(S):
            x0 = p * cp
            gidx = st.class_base[k] + (((i + x0) * gy + j) * gz + kz).ravel()
            l2g[p, lidx] = gidx
            if d[0] == 0 and p > 0:
                # left boundary plane is the shared plane owned by p-1
                own[p, lidx[(i.ravel() == 0)]] = 0.0
    return StructuredPartition(
        n_shards=S,
        cells_per_shard=cp,
        local=local,
        global_structure=st,
        local_to_global=l2g,
        own_mask=own,
        plane_classes=tuple(plane_classes),
    )


# ---------------------------------------------------------------------------
# boundary-plane slices (the halo gather and reduce of the structured solver;
# static slices only, on torch tensors)


def _class_grid(sp: StructuredPartition, v, k: int):
    """View class k of a local nodal field v [N_loc, ...] as its grid
    [gx, gy, gz, ...]."""
    gx, gy, gz = sp.local.class_dims[k]
    b = sp.local.class_base[k]
    return v[b: b + gx * gy * gz].reshape(gx, gy, gz, *v.shape[1:])


def right_planes(sp: StructuredPartition, v: torch.Tensor) -> torch.Tensor:
    """[plane_size, ...]: the concatenated x == cp planes of the d[0] == 0
    classes of a local field v [N_loc, ...] (the values shard p + 1 needs
    as its halo)."""
    return torch.cat([_class_grid(sp, v, k)[-1].reshape(-1, *v.shape[1:])
                      for k in sp.plane_classes], 0)


def left_planes(sp: StructuredPartition, v: torch.Tensor) -> torch.Tensor:
    """[plane_size, ...]: the concatenated x == 0 planes (the halo slots of
    this shard, or the partial sums owed to shard p - 1)."""
    return torch.cat([_class_grid(sp, v, k)[0].reshape(-1, *v.shape[1:])
                      for k in sp.plane_classes], 0)


def _plane_rows(sp: StructuredPartition, last: bool):
    """(first row, rows, offset into the plane stack) per plane class: the
    x == 0 plane, or the x == cp plane where `last`."""
    out, off = [], 0
    for k in sp.plane_classes:
        gx, gy, gz = sp.local.class_dims[k]
        n = gy * gz
        out.append((sp.local.class_base[k] + ((gx - 1) * n if last else 0), n, off))
        off += n
    return out


def set_left_planes(sp: StructuredPartition, v: torch.Tensor, planes: torch.Tensor
                    ) -> torch.Tensor:
    """v with its x == 0 planes of the d[0] == 0 classes replaced by
    `planes` ([plane_size, ...] in `left_planes` order); v is not changed."""
    out = v.clone()
    for b, n, off in _plane_rows(sp, last=False):
        out[b: b + n] = planes[off: off + n]
    return out


def add_right_planes(sp: StructuredPartition, v: torch.Tensor, planes: torch.Tensor
                     ) -> torch.Tensor:
    """v with `planes` added into its x == cp planes (the halo reduce's
    target: partial sums returned from shard p + 1); v is not changed."""
    out = v.clone()
    for b, n, off in _plane_rows(sp, last=True):
        out[b: b + n] = out[b: b + n] + planes[off: off + n]
    return out
