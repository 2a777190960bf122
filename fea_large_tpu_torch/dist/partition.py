"""Host-side mesh partitioning for domain decomposition (counterpart of
`fea_large_tpu/dist/partition.py`; host numpy, run once per mesh).

Strategy: **slab partition**: elements sorted by centroid along the
longest bounding-box axis, split into equal-count contiguous slabs, or
`method="rcb"`, recursive coordinate bisection. The shards form a 1-D ring;
slab adjacency means each shard's halo is owned by ring predecessors
(usually exactly shard - 1), so halo traffic is ring hops (`kmax` is
typically 1).

Ownership rule: a node is owned by the LOWEST-numbered shard whose elements
touch it. Hence every halo node of shard p is owned by some shard q < p,
and the halo exchange decomposes into ring hops k = p - q (index maps and
masks; see `dist.sharded` for the exchange).

All per-shard arrays are padded to uniform sizes: padded elements carry
zero quadrature weight (their contributions vanish), padded node slots
zero masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fea_large_tpu_torch.mesh.core import Mesh


@dataclasses.dataclass(frozen=True)
class Partition:
    """Host-side partition description (all numpy; each rank puts its
    shard's rows on its device in `dist.sharded`). Leading axis of every
    array is the shard axis S."""

    n_shards: int
    n_owned: int  # No: padded owned-node count per shard
    n_halo: int  # Hl: padded halo-node count per shard
    n_elems: int  # El: padded element count per shard
    kmax: int  # max ring distance of any halo dependency

    elem_global: np.ndarray  # i64[S, El] global element id (-1 padding)
    local_conn: np.ndarray  # i32[S, El, npe] into local space [0, No+Hl)
    owned_global: np.ndarray  # i64[S, No] global node id (-1 padding)
    own_mask: np.ndarray  # f64[S, No] 1 for real owned nodes
    halo_global: np.ndarray  # i64[S, Hl] global node id (-1 padding)

    # ring-hop exchange maps, k = 1..kmax (see module docstring):
    # shard p sends, at hop k, values of its owned slots send_idx[p, k-1, :]
    # to shard p+k, which receives them in ITS halo-slot order; masks select
    # the subset of halo slots of p+k actually owned by p.
    send_idx: np.ndarray  # i32[S, kmax, Hl] indices into owned space
    send_mask: np.ndarray  # f64[S, kmax, Hl]
    recv_mask: np.ndarray  # f64[S, kmax, Hl] recv_mask[p,k-1] = send_mask[(p-k)%S, k-1]

    @property
    def n_local(self) -> int:
        return self.n_owned + self.n_halo

    def to_global(self, u_shards: np.ndarray, n_nodes: int) -> np.ndarray:
        """Reassemble a global nodal array [N, ...] from owned shard values
        [S, No, ...]."""
        out = np.zeros((n_nodes, *u_shards.shape[2:]), u_shards.dtype)
        for p in range(self.n_shards):
            real = self.owned_global[p] >= 0
            out[self.owned_global[p][real]] = u_shards[p][real]
        return out

    def from_global(self, x: np.ndarray, space: str = "owned") -> np.ndarray:
        """Scatter a global nodal array [N, ...] to shard-local layout
        [S, No, ...] (space='owned') or [S, No+Hl, ...] (space='local')."""
        S = self.n_shards
        if space == "owned":
            gids = self.owned_global
        elif space == "local":
            gids = np.concatenate([self.owned_global, self.halo_global], axis=1)
        else:
            raise ValueError(space)
        out = np.zeros((S, gids.shape[1], *x.shape[1:]), x.dtype)
        for p in range(S):
            real = gids[p] >= 0
            out[p][real] = x[gids[p][real]]
        return out


def _rcb_sets(centroids: np.ndarray, ids: np.ndarray, n_parts: int) -> list:
    """Recursive coordinate bisection: split along the longest axis into
    two element sets sized proportionally, recurse. Returns n_parts id
    arrays ordered by recursion path (neighboring parts stay close in id,
    keeping ring-hop distances small)."""
    if n_parts == 1:
        return [ids]
    n_lo = n_parts // 2
    pts = centroids[ids]
    axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
    order = ids[np.argsort(pts[:, axis], kind="stable")]
    cut = len(ids) * n_lo // n_parts
    return _rcb_sets(centroids, order[:cut], n_lo) + _rcb_sets(
        centroids, order[cut:], n_parts - n_lo
    )


def partition_mesh(
    mesh: Mesh, n_shards: int, axis: int | None = None, method: str = "slab"
) -> Partition:
    """Partition `mesh` into `n_shards` element sets with halo maps.

    method="slab" (default): contiguous slabs along one axis: halos are
    neighbor hops (kmax=1) on the 1-D ring of shards. method="rcb":
    recursive coordinate bisection — smaller interfaces on compact meshes,
    at the cost of multi-hop halo exchanges (the ring-hop machinery handles
    any kmax)."""
    coords = mesh.coords_host
    conn = mesh.conn_host.astype(np.int64)
    E, npe = conn.shape
    N = coords.shape[0]
    S = n_shards

    centroids = coords[conn[:, :4]].mean(axis=1)  # geometric vertices suffice
    if method == "rcb":
        elem_sets = _rcb_sets(centroids, np.arange(E), S)
    elif method == "slab":
        if axis is None:
            extent = coords.max(axis=0) - coords.min(axis=0)
            axis = int(np.argmax(extent))
        order = np.argsort(centroids[:, axis], kind="stable")
        elem_sets = np.array_split(order, S)
    else:
        raise ValueError(f"unknown partition method {method!r}")

    # ownership: lowest-numbered touching shard
    owner = np.full(N, S, np.int64)
    for p in range(S - 1, -1, -1):
        owner[np.unique(conn[elem_sets[p]])] = p

    owned_lists, halo_lists = [], []
    for p in range(S):
        touched = np.unique(conn[elem_sets[p]])
        own = touched[owner[touched] == p]
        halo = touched[owner[touched] != p]
        # halo sorted by (owner hop, global id) for compact hop maps
        hop = (p - owner[halo]) % S
        halo = halo[np.lexsort((halo, hop))]
        owned_lists.append(own)
        halo_lists.append(halo)

    No = max(len(o) for o in owned_lists)
    Hl = max(max((len(h) for h in halo_lists), default=0), 1)
    El = max(len(e) for e in elem_sets)

    owned_global = np.full((S, No), -1, np.int64)
    own_mask = np.zeros((S, No))
    halo_global = np.full((S, Hl), -1, np.int64)
    elem_global = np.full((S, El), -1, np.int64)
    local_conn = np.zeros((S, El, npe), np.int32)

    # local index of a global node within shard p
    for p in range(S):
        own, halo, elems = owned_lists[p], halo_lists[p], elem_sets[p]
        owned_global[p, : len(own)] = own
        own_mask[p, : len(own)] = 1.0
        halo_global[p, : len(halo)] = halo
        elem_global[p, : len(elems)] = elems
        lidx = np.zeros(N, np.int64)
        lidx[own] = np.arange(len(own))
        lidx[halo] = No + np.arange(len(halo))
        local_conn[p, : len(elems)] = lidx[conn[elems]].astype(np.int32)
        # padded elements keep conn=0; their quadrature weights are zeroed
        # in dist.sharded so they contribute nothing.

    hops = (np.arange(S)[:, None] - owner[np.where(halo_global >= 0, halo_global, 0)]) % S
    hops = np.where(halo_global >= 0, hops, 0)
    kmax = int(hops.max()) if (halo_global >= 0).any() else 1
    kmax = max(kmax, 1)

    # owned-slot lookup per shard
    owned_slot = np.zeros((S, N), np.int64)
    for p in range(S):
        real = owned_global[p] >= 0
        owned_slot[p, owned_global[p][real]] = np.nonzero(real)[0]

    send_idx = np.zeros((S, kmax, Hl), np.int32)
    send_mask = np.zeros((S, kmax, Hl))
    recv_mask = np.zeros((S, kmax, Hl))
    for p in range(S):
        for k in range(1, kmax + 1):
            q = (p + k) % S  # the shard that receives p's values at hop k
            # halo slots of q owned by p
            hg = halo_global[q]
            sel = (hg >= 0) & (owner[np.where(hg >= 0, hg, 0)] == p) & ((q - p) % S == k)
            send_idx[p, k - 1, sel] = owned_slot[p, hg[sel]]
            send_mask[p, k - 1, sel] = 1.0
            recv_mask[q, k - 1] = send_mask[p, k - 1]
    return Partition(
        n_shards=S,
        n_owned=No,
        n_halo=Hl,
        n_elems=El,
        kmax=kmax,
        elem_global=elem_global,
        local_conn=local_conn,
        owned_global=owned_global,
        own_mask=own_mask,
        halo_global=halo_global,
        send_idx=send_idx,
        send_mask=send_mask,
        recv_mask=recv_mask,
    )
