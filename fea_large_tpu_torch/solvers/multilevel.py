"""Two-level additive preconditioner (counterpart of
`fea_large_tpu/solvers/multilevel.py`, modes 3 and 6, probing assembly):

    M^-1 r = Jacobi(r) + P Ac^-1 P^T r

  * P: per aggregate the 3 translations (modes=3), plus the 3 rotations
    about the aggregate centroid with a normalized arm (modes=6, the
    rigid-body modes). On a Kuhn lattice the aggregates are lattice blocks
    and the transfer is pooled (ops/pooling.py, no indexed ops); on an
    unstructured mesh they are geometric bins of the nodes
    (`aggregate_nodes`), P^T sums through `ScatterBuckets` over the
    aggregate ids (fixed order) and P is the row gather xc[agg].
  * Ac = P^T (M K0 M) P at the reference state u = 0, assembled on the
    device by probing: one masked f32 tangent action per (color of the
    distance-2 aggregate coloring, mode), restricted per aggregate and set
    into the dense matrix. Ridged, Cholesky-factored, and inverted
    explicitly (symmetric) once; every apply is one dense f32 matvec.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.ops.pooling import LatticePool, make_lattice_pool
from fea_large_tpu_torch.ops.soa import ScatterBuckets, soa_apply_tangent, soa_freeze


@dataclasses.dataclass(frozen=True)
class CoarseSpace:
    """Aggregation transfer + explicit coarse inverse.

    acinv  f32[modes*Nc, modes*Nc] symmetric explicit inverse of Ac
    dvec   f32[N, 3] normalized rotational arm (modes=6), else None
    pool   the transfer: a `LatticePool` on Kuhn lattices, an
           `AggregateTransfer` on unstructured meshes
    """

    acinv: torch.Tensor
    dvec: torch.Tensor | None
    n_agg: int
    modes: int
    pool: "LatticePool | AggregateTransfer"

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """P^T r: [N, 3] -> [Nc, modes]; rotation mode 3+k of aggregate A
        is sum_{n in A} (d_n x r_n)_k."""
        t = r
        if self.modes == 6:
            t = torch.cat([r, torch.linalg.cross(self.dvec.to(r.dtype), r)], 1)
        return self.pool.restrict(t)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        """P xc: [Nc, modes] -> [N, 3], (P xc)_n = t_A + omega_A x d_n."""
        za = self.pool.prolong(xc)
        if self.modes == 6:
            return za[:, :3] + torch.linalg.cross(za[:, 3:6], self.dvec.to(xc.dtype))
        return za

    def coarse_solve(self, rc: torch.Tensor) -> torch.Tensor:
        """Ac^-1 rc as one dense matvec with the explicit inverse."""
        x = self.acinv @ rc.reshape(-1).to(self.acinv.dtype)
        return x.reshape(rc.shape).to(rc.dtype)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Coarse correction P Ac^-1 P^T r."""
        return self.prolong(self.coarse_solve(self.restrict(r)))


def default_agg_size(n_nodes: int, target_coarse: int = 5000,
                     structured: bool = False) -> int:
    """Aggregate size targeting ~`target_coarse` aggregates, the target
    scaling as sqrt(N) beyond the 1M-DOF calibration mesh (342,361 nodes),
    times 0.56 on structured lattices, and the aggregate floored at 60
    nodes. The constants are the reference's."""
    ref_nodes = 342_361
    scale = max(1.0, float(n_nodes) / ref_nodes) ** 0.5
    if structured:
        scale *= 0.56
    target = int(target_coarse * scale)
    return int(np.clip(n_nodes // target, 60, 4096))


@dataclasses.dataclass(frozen=True)
class AggregateTransfer:
    """Aggregation of an unstructured mesh's nodes by an explicit map:
    restrict sums each aggregate's rows through `ScatterBuckets` over the
    aggregate ids (fixed order, no atomics), prolong is the row gather
    w[agg]. The same interface as `LatticePool`."""

    agg: torch.Tensor  # int64 [N] aggregate id per node
    buckets: ScatterBuckets

    @staticmethod
    def build(agg: np.ndarray, device) -> "AggregateTransfer":
        return AggregateTransfer(
            agg=torch.as_tensor(agg, device=device),
            buckets=ScatterBuckets.build(agg[None, :], int(agg.max()) + 1, device),
        )

    def agg_host(self) -> np.ndarray:
        return self.agg.cpu().numpy()

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        """[N, C] -> [n_agg, C] per-aggregate sums."""
        return self.buckets.apply(v.T).T

    def prolong(self, w: torch.Tensor) -> torch.Tensor:
        """[n_agg, C] -> [N, C]: each node reads its aggregate's value."""
        return w[self.agg]


def aggregate_nodes(coords: np.ndarray, agg_size: int = 512) -> np.ndarray:
    """Geometric aggregation: bin the nodes into a uniform grid with
    ~agg_size nodes per bin, labels compacted. Host-side, O(N)."""
    coords = np.asarray(coords)
    n_cells = max(1, coords.shape[0] // agg_size)
    per_axis = max(1, round(n_cells ** (1.0 / 3.0)))
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    ijk = np.minimum((per_axis * (coords - lo) / span).astype(np.int64), per_axis - 1)
    raw = (ijk[:, 0] * per_axis + ijk[:, 1]) * per_axis + ijk[:, 2]
    _, agg = np.unique(raw, return_inverse=True)
    return agg.astype(np.int64)


def _rbm_dvec(coords: np.ndarray, agg: np.ndarray, cent: np.ndarray,
              n_agg: int) -> np.ndarray:
    """Rotational arm d_n = (x_n - centroid)/s_A with s_A the aggregate's
    RMS arm length: a column rescaling of P that brings the rotation and
    translation blocks of Ac to the same scale."""
    d = coords - cent[agg]
    cnt = np.maximum(np.bincount(agg, minlength=n_agg), 1)
    s = np.sqrt(np.bincount(agg, weights=(d * d).sum(1), minlength=n_agg) / cnt)
    return d / np.maximum(s, 1e-30)[agg, None]


def _aggregate_adjacency(conn: np.ndarray, agg: np.ndarray, n_agg: int):
    """Aggregate pairs (A, B), A != B, that share an element, as CSR
    (indptr, indices), self-pairs excluded."""
    agg_e = agg[conn]
    npe = agg_e.shape[1]
    pa, pb = np.triu_indices(npe, k=1)
    A = agg_e[:, pa].reshape(-1)
    B = agg_e[:, pb].reshape(-1)
    sel = A != B
    A, B = A[sel], B[sel]
    keys = np.unique(np.concatenate([A * n_agg + B, B * n_agg + A]))
    rows = keys // n_agg
    cols = keys % n_agg
    indptr = np.zeros(n_agg + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_agg), out=indptr[1:])
    return indptr, cols


def _color_square_graph(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Greedy first-fit distance-2 coloring of the aggregate graph:
    same-color aggregates share no neighbor, so one probe vector carries
    one basis column per same-color aggregate without mixing."""
    import scipy.sparse as sp

    n = len(indptr) - 1
    A = sp.csr_matrix((np.ones(len(indices), np.int8), indices, indptr), shape=(n, n))
    A2 = ((A @ A) + A).tocsr()
    color = np.full(n, -1, np.int64)
    for v in range(n):
        used = color[A2.indices[A2.indptr[v]: A2.indptr[v + 1]]]
        used = used[used >= 0]
        if used.size == 0:
            color[v] = 0
            continue
        mark = np.zeros(used.max() + 2, bool)
        mark[used] = True
        color[v] = int(np.argmin(mark))
    return color


def _probe_plan(conn, agg, n_agg, modes, dvec):
    """Host-side probing plan: the distance-2 coloring, per-node basis
    columns Bn [N, 3, modes] (translations + e_k x d), the (color, mode)
    probe schedule cm [n_probes, 2], and the flat indices that place probe
    responses Z[c*modes + m, B, n] into Ac[modes*B + n, modes*A + m], A the
    unique same-color aggregate seen from B. Returns
    (color, Bn, d, cm, src, dst, nc) as numpy arrays and ints."""
    N = len(agg)
    indptr, indices = _aggregate_adjacency(conn, agg, n_agg)
    color = _color_square_graph(indptr, indices)
    n_colors = int(color.max()) + 1
    attr = np.full((n_agg, n_colors), -1, np.int64)
    attr[np.arange(n_agg), color] = np.arange(n_agg)
    src = np.repeat(np.arange(n_agg), np.diff(indptr))
    attr[indices, color[src]] = src

    Bn = np.zeros((N, 3, modes), np.float32)
    Bn[:, 0, 0] = Bn[:, 1, 1] = Bn[:, 2, 2] = 1.0
    d = np.zeros((N, 3), np.float32)
    if modes == 6:
        d = np.asarray(dvec, np.float32)
        Bn[:, 1, 3], Bn[:, 2, 3] = -d[:, 2], d[:, 1]
        Bn[:, 0, 4], Bn[:, 2, 4] = d[:, 2], -d[:, 0]
        Bn[:, 0, 5], Bn[:, 1, 5] = -d[:, 1], d[:, 0]
    cm = np.stack(
        [np.repeat(np.arange(n_colors), modes), np.tile(np.arange(modes), n_colors)],
        axis=1,
    )
    nc = modes * n_agg
    mm = np.arange(modes)
    dst_l, src_l = [], []
    for c in range(n_colors):
        Bsel = np.nonzero(attr[:, c] >= 0)[0]
        if len(Bsel) == 0:
            continue
        A = attr[Bsel, c]
        rows = modes * Bsel[:, None, None] + mm[None, :, None]
        cols = modes * A[:, None, None] + mm[None, None, :]
        dst_l.append((rows * nc + cols).reshape(-1))
        zsrc = ((c * modes + mm[None, None, :]) * n_agg + Bsel[:, None, None]) * modes \
            + mm[None, :, None]
        src_l.append(zsrc.reshape(-1))
    return color, Bn, d, cm, np.concatenate(src_l), np.concatenate(dst_l), nc


def _probe_run(soa, state0, free32, Bn, dvec, color_node, cm, modes, pool):
    """Probe sweep on the device: for each (color, mode) build the probe
    from the per-node tables, apply the masked frozen tangent action, and
    restrict per aggregate. Returns Z [n_probes, n_agg, modes]."""
    out = []
    for c, m in cm.tolist():
        v = (color_node == c).to(Bn.dtype)[:, None] * Bn[:, :, m]
        vm_T = (v * free32).T.contiguous()
        y = soa_apply_tangent(soa, state0, vm_T).T * free32
        t = y if modes == 3 else torch.cat([y, torch.linalg.cross(dvec, y)], 1)
        out.append(pool.restrict(t))
    return torch.stack(out)


def _assemble_dense_coarse(z_flat, src, dst, nc: int):
    """Set probe responses into the dense [nc, nc] coarse matrix and
    symmetrize. Every entry is written by exactly one probe (distance-2
    coloring), so this is an index set, not an accumulation."""
    flat = torch.zeros(nc * nc, dtype=z_flat.dtype, device=z_flat.device)
    flat[dst] = z_flat[src]
    Ac = flat.reshape(nc, nc)
    return 0.5 * (Ac + Ac.T)


def _ridge_and_factor(Ac):
    """Unit diagonal on empty (fully fixed) rows, a 1e-8 relative ridge,
    and the lower Cholesky factor."""
    d = torch.diagonal(Ac)
    fix = (d <= 0.0).to(Ac.dtype)
    ridge = fix + 1e-8 * torch.clamp(d.max(), min=1.0)
    return torch.linalg.cholesky(Ac + torch.diag(ridge))


def _invert_factor(chol):
    """Explicit Ac^-1 = L^-T L^-1 from the Cholesky factor, symmetrized
    (CG needs a symmetric preconditioner). Full f32 (TF32 is off)."""
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    acinv = linv.T @ linv
    return 0.5 * (acinv + acinv.T)


def build_coarse_space(mesh, material, bc, agg_size: int | None = None,
                       modes: int = 3, soa=None) -> CoarseSpace:
    """Assemble and invert the coarse operator at the reference state u=0,
    where both hyperelastic tangents reduce to isotropic linear elasticity.
    Needs the f32 SoAProblem `soa` (the probing assembly); the reference's
    host builders (soa=None) are not ported."""
    if modes not in (3, 6, 12):
        raise ValueError(f"coarse modes must be 3, 6 or 12, got {modes}")
    if modes == 12:
        raise NotImplementedError("coarse modes=12 is not ported (3 or 6)")
    if soa is None:
        raise NotImplementedError("the host coarse builders are not ported: pass soa")
    st = mesh.structure
    dev = mesh.device
    coords = mesh.coords_host
    if agg_size is None:
        agg_size = default_agg_size(
            mesh.n_nodes, target_coarse={3: 5000, 6: 2500}[modes], structured=st is not None
        )
    if st is not None:
        pool = make_lattice_pool(st, max(1, mesh.n_nodes // agg_size))
    else:
        pool = AggregateTransfer.build(aggregate_nodes(coords, agg_size), dev)
    agg = pool.agg_host()
    n_agg = int(agg.max()) + 1
    dvec_np = None
    if modes == 6:
        cnt = np.bincount(agg, minlength=n_agg).astype(float)
        cent = np.stack(
            [np.bincount(agg, weights=coords[:, d], minlength=n_agg) / cnt for d in range(3)],
            axis=1,
        )
        dvec_np = _rbm_dvec(coords, agg, cent, n_agg)
    color, Bn, d, cm, src, dst, nc = _probe_plan(mesh.conn_host, agg, n_agg, modes, dvec_np)
    free32 = bc.free_mask.to(torch.float32)
    state0 = soa_freeze(soa, material, torch.zeros((3, mesh.n_nodes), dtype=torch.float32, device=dev))
    Z = _probe_run(
        soa, state0, free32, torch.as_tensor(Bn, device=dev),
        torch.as_tensor(d, device=dev), torch.as_tensor(color[agg], device=dev),
        cm, modes, pool,
    )
    Ac = _assemble_dense_coarse(
        Z.reshape(-1), torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev), nc
    )
    return CoarseSpace(
        acinv=_invert_factor(_ridge_and_factor(Ac)),
        dvec=None if dvec_np is None else torch.as_tensor(dvec_np, dtype=torch.float32, device=dev),
        n_agg=n_agg,
        modes=modes,
        pool=pool,
    )
