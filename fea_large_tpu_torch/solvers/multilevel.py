"""Two- and three-level additive preconditioners (counterpart of
`fea_large_tpu/solvers/multilevel.py`):

    M^-1 r = Jacobi(r) + P Ac^-1 P^T r

  * P: per aggregate the 3 translations (modes=3), plus the 3 rotations
    about the aggregate centroid with a normalized arm (modes=6, the
    rigid-body modes), plus the 6 linear strain fields (modes=12, all
    piecewise-linear displacements). On a Kuhn lattice the aggregates are
    lattice blocks and the transfer is pooled (ops/pooling.py, no indexed
    ops); on an unstructured mesh they are geometric bins of the nodes
    (`aggregate_nodes`), P^T sums through `ScatterBuckets` over the
    aggregate ids (fixed order) and P is the row gather xc[agg].
  * Ac = P^T (M K0 M) P at the reference state u = 0, where both
    hyperelastic tangents are isotropic linear elasticity. Two assemblies:
    on the device by probing (`soa` given: one masked f32 tangent action
    per (color of the distance-2 aggregate coloring, mode), restricted per
    aggregate and set into the dense matrix), or on the host as the f64
    Galerkin product of scipy sparse matrices (`soa=None`, modes 3 and 6:
    `_host_k0_csr`, `_prolongator_csr`). Either way Ac is ridged,
    Cholesky-factored and inverted explicitly (symmetric) once, on the
    mesh's device, or on the host (`_host_invert_coarse`: where the device
    build runs out of memory, or FEA_COARSE_INVERT=host); every apply is
    one dense matvec. On the card the inverse is stored in bf16, as the
    reference stores it on its accelerator (`_store_acinv`); on the CPU it
    stays f32.

The three-level space (`build_multilevel_space`) adds a large middle level
solved by its 3x3 block diagonal, telescoped onto a small dense level:

    M_c r = P1 [Dc1^-1 + P2 Ac2^-1 P2^T] P1^T r.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from fea_large_tpu_torch.ops.pooling import LatticePool, make_lattice_pool
from fea_large_tpu_torch.ops.soa import (
    ScatterBuckets,
    _np_inv_det_3x3,
    soa_apply_tangent,
    soa_freeze,
)


class _SetupClock:
    """Seconds of a setup split into host and device work: `lap(key)`
    adds the time since the last lap to `seconds[key]`, after waiting for
    the device where the key is "device_s"."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {"host_s": 0.0, "device_s": 0.0}
        self.t = time.perf_counter()

    def lap(self, key: str):
        if key == "device_s" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.seconds[key] += t - self.t
        self.t = t


@dataclasses.dataclass(frozen=True)
class CoarseSpace:
    """Aggregation transfer + explicit coarse inverse.

    acinv  [modes*Nc, modes*Nc] symmetric explicit inverse of Ac, bf16 on
           the card and f32 on the CPU (`_store_acinv`)
    dvec   f32[N, 3] normalized arm (modes 6 and 12), else None
    dvec_T f32[3, N] the same, component-first (`apply_T`)
    pool   the transfer: a `LatticePool` on Kuhn lattices, an
           `AggregateTransfer` on unstructured meshes
    setup  what the build measured: host and device seconds, and the
           route of the inverse ("device", "host", or "host after device
           out of memory")
    """

    acinv: torch.Tensor
    dvec: torch.Tensor | None
    n_agg: int
    modes: int
    pool: "LatticePool | AggregateTransfer"
    dvec_T: torch.Tensor | None = None
    setup: dict = dataclasses.field(default_factory=dict, compare=False)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """P^T r: [N, 3] -> [Nc, modes]; rotation mode 3+k of aggregate A
        is sum_{n in A} (d_n x r_n)_k, strain modes 6..11 the moments
        S(d_n)^T r_n (`_strain_restrict`)."""
        t = r
        if self.modes >= 6:
            d = self.dvec.to(r.dtype)
            t = torch.cat([r, torch.linalg.cross(d, r)], 1)
            if self.modes == 12:
                t = torch.cat([t, _strain_restrict(d, r)], 1)
        return self.pool.restrict(t)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        """P xc: [Nc, modes] -> [N, 3], (P xc)_n = t_A + omega_A x d_n
        [+ S(d_n) eps_A for modes=12]."""
        za = self.pool.prolong(xc)
        if self.modes >= 6:
            d = self.dvec.to(xc.dtype)
            out = za[:, :3] + torch.linalg.cross(za[:, 3:6], d)
            if self.modes == 12:
                out = out + _strain_prolong(d, za[:, 6:12])
            return out
        return za

    def coarse_solve(self, rc: torch.Tensor) -> torch.Tensor:
        """Ac^-1 rc as one dense matvec with the explicit inverse, in its
        storage dtype: rc rounded to it, the product accumulated in f32 and
        rounded to it once (config.py), the result cast back to rc's dtype."""
        x = self.acinv @ rc.reshape(-1).to(self.acinv.dtype)
        return x.reshape(rc.shape).to(rc.dtype)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Coarse correction P Ac^-1 P^T r."""
        return self.prolong(self.coarse_solve(self.restrict(r)))

    def apply_T(self, r_T: torch.Tensor) -> torch.Tensor:
        """Component-first coarse correction: r_T [3, N] -> [3, N]. With 6
        modes on an unstructured mesh (bucket maps) it restricts, solves
        and prolongs in [C, N] layout; otherwise it delegates to `apply`,
        as the reference does. The PCG of the solver stays on `apply`."""
        if self.modes != 6 or not isinstance(self.pool, AggregateTransfer):
            return self.apply(r_T.T).T
        d = self.dvec_T.to(r_T.dtype)
        t = torch.cat([r_T, _cross_T(d, r_T)], 0)  # [6, N]
        rc = self.pool.buckets.apply(t)  # [6, Nc]
        xc = (self.acinv @ rc.T.reshape(-1).to(self.acinv.dtype)).reshape(self.n_agg, 6)
        za_T = xc.to(r_T.dtype)[self.pool.agg].T  # [6, N]
        return za_T[:3] + _cross_T(za_T[3:], d)


def _strain_restrict(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """S(d)^T r [N, 6]: the six linear-strain moments of r at the arm d
    (engineering shears, order xx, yy, zz, xy, xz, yz); the exact
    transpose of `_strain_prolong`."""
    return torch.stack(
        (
            d[:, 0] * r[:, 0],
            d[:, 1] * r[:, 1],
            d[:, 2] * r[:, 2],
            d[:, 1] * r[:, 0] + d[:, 0] * r[:, 1],
            d[:, 2] * r[:, 0] + d[:, 0] * r[:, 2],
            d[:, 2] * r[:, 1] + d[:, 1] * r[:, 2],
        ),
        1,
    )


def _strain_prolong(d: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """S(d) eps [N, 3]: the displacement u_i = eps_ij d_j of the linear
    strain field eps (engineering shears) at the arm d."""
    return torch.stack(
        (
            d[:, 0] * eps[:, 0] + d[:, 1] * eps[:, 3] + d[:, 2] * eps[:, 4],
            d[:, 1] * eps[:, 1] + d[:, 0] * eps[:, 3] + d[:, 2] * eps[:, 5],
            d[:, 2] * eps[:, 2] + d[:, 0] * eps[:, 4] + d[:, 1] * eps[:, 5],
        ),
        1,
    )


def _cross_T(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of component-first [3, N] operands."""
    return torch.stack(
        (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])
    )


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
    columns Bn [N, 3, modes] (translations, e_k x d, and for modes=12 the
    strain fields of `_strain_prolong`), the (color, mode)
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
    if modes >= 6:
        d = np.asarray(dvec, np.float32)
        Bn[:, 1, 3], Bn[:, 2, 3] = -d[:, 2], d[:, 1]
        Bn[:, 0, 4], Bn[:, 2, 4] = d[:, 2], -d[:, 0]
        Bn[:, 0, 5], Bn[:, 1, 5] = -d[:, 1], d[:, 0]
    if modes == 12:
        Bn[:, 0, 6] = d[:, 0]
        Bn[:, 1, 7] = d[:, 1]
        Bn[:, 2, 8] = d[:, 2]
        Bn[:, 0, 9], Bn[:, 1, 9] = d[:, 1], d[:, 0]
        Bn[:, 0, 10], Bn[:, 2, 10] = d[:, 2], d[:, 0]
        Bn[:, 1, 11], Bn[:, 2, 11] = d[:, 2], d[:, 1]
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
        t = y
        if modes >= 6:
            t = torch.cat([y, torch.linalg.cross(dvec, y)], 1)
            if modes == 12:
                t = torch.cat([t, _strain_restrict(dvec, y)], 1)
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


def _host_invert_coarse(Ac_np: np.ndarray, device, clock: _SetupClock | None = None
                        ) -> torch.Tensor:
    """Ridge, Cholesky and explicit inverse with the factor on the host:
    LAPACK potrf and trtri in f32 (the triangular inverse, n^3/3), then the
    Gram product L^-T L^-1 on `device` (n^3, ~3 [nc, nc] buffers there),
    symmetrized. The same ridge and Gram form as the device build; the setup
    route where that build runs out of device memory, or where
    FEA_COARSE_INVERT=host asks for it. `clock` laps the host part."""
    import scipy.linalg as sla
    from scipy.linalg import lapack

    A = np.asarray(Ac_np, np.float32)
    d = np.diagonal(A)
    fix = (d <= 0.0).astype(A.dtype)
    A = A + np.diag(fix + np.float32(1e-8) * max(float(d.max()), 1.0))
    L = sla.cholesky(A, lower=True)
    del A
    linv, info = lapack.strtri(L, lower=1, overwrite_c=1)
    if info != 0:  # singular or ill-conditioned: the slow, robust form
        linv = sla.solve_triangular(L, np.eye(L.shape[0], dtype=np.float32), lower=True)
    del L
    if clock is not None:
        clock.lap("host_s")
    m = torch.as_tensor(linv, device=device)
    acinv = m.T @ m
    return 0.5 * (acinv + acinv.T)


def _coarse_entry_chunks(mesh, lam, mu, agg, free_mask, chunk=65536):
    """Yield (slot_agg [e, nslots], blk [e, s, t, 3, 3], pair_valid) chunks
    of the aggregated masked linear-elastic tangent at u=0, in factored
    form through the per-(element, aggregate) sums
    w_A[i,J] = sum_{a in A} m[a,i] g_a[J]:

      Ac[A,i,B,k] += sum_q V [lam w_A[i,i] w_B[k,k]
                             + mu d_ik sum_J w_A[i,J] w_B[k,J]
                             + mu w_A[i,k] w_B[k,i]]

    Host numpy, f64 (the reference's, kept as its oracle pair)."""
    elem = mesh.element
    coords, conn = mesh.coords_host, mesh.conn_host
    dN = np.asarray(elem.shape_grad)  # [q, npe, 3]
    wq = np.asarray(elem.quad_weights)
    E, npe = conn.shape
    nq = dN.shape[0]
    for s0 in range(0, E, chunk):
        c = conn[s0: s0 + chunk]
        e = len(c)
        J = np.einsum("eai,qaj->eqij", coords[c], dN)
        detJ, Jinv = _np_inv_det_3x3(J)
        g = np.einsum("qaj,eqji->eqai", dN, Jinv)  # [e, q, npe, 3]
        V = detJ * wq[None, :]  # [e, q]
        m = free_mask[c]  # [e, npe, 3]

        agg_e = agg[c]  # local aggregate slots per element
        sidx = np.argsort(agg_e, axis=1, kind="stable")
        sa = np.take_along_axis(agg_e, sidx, 1)
        newgrp = np.ones_like(sa, bool)
        newgrp[:, 1:] = sa[:, 1:] != sa[:, :-1]
        slot_sorted = np.cumsum(newgrp, axis=1) - 1
        nslots = int(slot_sorted.max()) + 1
        slot_of_a = np.empty_like(slot_sorted)
        np.put_along_axis(slot_of_a, sidx, slot_sorted, 1)
        rows = np.arange(e)
        slot_agg = np.zeros((e, nslots), np.int64)
        valid = np.zeros((e, nslots), bool)
        slot_agg[rows[:, None], slot_of_a] = agg_e
        valid[rows[:, None], slot_of_a] = True

        w = np.zeros((e, nslots, nq, 3, 3))  # w[e, s, q, i, J]
        for a in range(npe):
            w[rows, slot_of_a[:, a]] += m[:, a, None, :, None] * g[:, :, a, None, :]
        Vw = w * V[:, None, :, None, None]
        wd = np.einsum("esqii->esqi", w)
        Vwd = np.einsum("esqii->esqi", Vw)
        blk = (lam * np.einsum("esqi,etqk->estik", Vwd, wd)
               + mu * np.einsum("esqik,etqki->estik", Vw, w))
        d2 = mu * np.einsum("esqiJ,etqiJ->esti", Vw, w)
        ii = np.arange(3)
        blk[..., ii, ii] += d2
        pair_valid = valid[:, :, None] & valid[:, None, :]
        blk = blk * pair_valid[..., None, None]
        yield slot_agg, blk, pair_valid


def _element_k0(mesh, c, lam, mu, free_mask):
    """Masked linear-elastic element tangents at u=0 of the elements `c`:
    Ke [e, npe, 3, npe, 3] f64 (both hyperelastic tangents reduce to it)."""
    elem = mesh.element
    dN = np.asarray(elem.shape_grad)  # [q, npe, 3]
    w = np.asarray(elem.quad_weights)
    J = np.einsum("eai,qaj->eqij", mesh.coords_host[c], dN)
    detJ, Jinv = _np_inv_det_3x3(J)
    g = np.einsum("qaj,eqji->eqai", dN, Jinv)  # [e, q, npe, 3]
    gV = g * (detJ * w[None, :])[:, :, None, None]
    gg = np.einsum("eqai,eqbi->eab", gV, g)
    Ke = (lam * np.einsum("eqai,eqbk->eaibk", gV, g)
          + mu * np.einsum("eab,ik->eaibk", gg, np.eye(3))
          + mu * np.einsum("eqak,eqbi->eaibk", gV, g))
    m = free_mask[c]  # [e, npe, 3]
    Ke *= m[:, :, :, None, None] * m[:, None, None, :, :]
    return Ke


def _host_k0_csr(mesh, lam, mu, free_mask, chunk=32768):
    """The masked global linear-elastic stiffness at u=0 as a scipy CSR
    matrix (f64 data, int32 indices), summed chunk by chunk of elements
    (peak host memory: one chunk's COO triplets and the running CSR)."""
    import scipy.sparse as sp

    conn = mesh.conn_host
    E, npe = conn.shape
    n3 = 3 * mesh.n_nodes
    K = sp.csr_matrix((n3, n3))
    for s in range(0, E, chunk):
        c = conn[s: s + chunk]
        e = len(c)
        Ke = _element_k0(mesh, c, lam, mu, free_mask)
        dof = (3 * c[:, :, None] + np.arange(3)).reshape(e, 3 * npe)
        rows = np.broadcast_to(dof[:, :, None], (e, 3 * npe, 3 * npe)).reshape(-1).astype(np.int32)
        cols = np.broadcast_to(dof[:, None, :], (e, 3 * npe, 3 * npe)).reshape(-1).astype(np.int32)
        K = K + sp.coo_matrix((Ke.reshape(-1), (rows, cols)), shape=(n3, n3)).tocsr()
    return K


def _prolongator_csr(coords, agg, n_agg, modes, dvec=None):
    """Sparse prolongator P [3N, modes*Nc]: per node the 3 x modes block
    B_n = I (modes=3) or [I | cross-matrix(d_n)] (modes=6, d_n the
    normalized arm `_rbm_dvec`)."""
    import scipy.sparse as sp

    N = len(agg)
    node = np.arange(N)
    rows = [3 * node, 3 * node + 1, 3 * node + 2]
    cols = [modes * agg, modes * agg + 1, modes * agg + 2]
    vals = [np.ones(N), np.ones(N), np.ones(N)]
    if modes == 6:
        d = dvec
        for i, m, v in ((1, 3, -d[:, 2]), (2, 3, d[:, 1]), (0, 4, d[:, 2]),
                        (2, 4, -d[:, 0]), (0, 5, -d[:, 1]), (1, 5, d[:, 0])):
            rows.append(3 * node + i)
            cols.append(6 * agg + m)
            vals.append(v)
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(3 * N, modes * n_agg),
    ).tocsr()


def _host_coarse_matrix_rbm(mesh, lam, mu, agg, dvec, n_agg, free_mask, k0=None):
    """Dense [6Nc, 6Nc] Galerkin coarse matrix P^T (M K0 M) P of the
    rigid-body basis (normalized arms `dvec`), f64, by sparse products;
    `k0` is `_host_k0_csr`'s matrix where the caller already has it."""
    K = _host_k0_csr(mesh, lam, mu, free_mask) if k0 is None else k0
    P = _prolongator_csr(mesh.coords_host, agg, n_agg, 6, dvec)
    return np.asarray((P.T @ (K @ P)).todense())


def _host_coarse_matrix(mesh, lam, mu, agg, n_agg, free_mask, chunk=65536):
    """Dense [3Nc, 3Nc] Galerkin coarse matrix P^T (M K0 M) P of the
    translations, f64, by sparse products."""
    K = _host_k0_csr(mesh, lam, mu, free_mask, chunk=chunk)
    P = _prolongator_csr(mesh.coords_host, agg, n_agg, 3)
    return np.asarray((P.T @ (K @ P)).todense())


def _host_coarse_matrix_reference(mesh, lam, mu, agg, n_agg, free_mask, chunk=8192):
    """Direct (unfactored) assembly of the translations' coarse matrix: the
    test oracle of `_host_coarse_matrix`."""
    conn = mesh.conn_host
    npe = conn.shape[1]
    nc3 = 3 * n_agg
    Ac = np.zeros(nc3 * nc3)
    for s in range(0, len(conn), chunk):
        c = conn[s: s + chunk]
        Ke = _element_k0(mesh, c, lam, mu, free_mask)
        cdof = (3 * agg[c][:, :, None] + np.arange(3)).reshape(len(c), 3 * npe)
        keys = (cdof[:, :, None] * nc3 + cdof[:, None, :]).reshape(-1)
        Ac += np.bincount(keys, weights=Ke.reshape(-1), minlength=nc3 * nc3)
    return Ac.reshape(nc3, nc3)


def _device_invert(Ac: torch.Tensor, clock: _SetupClock):
    """(explicit inverse, route) of the device-resident f32 Ac, built on its
    device; where that runs out of device memory, on the host
    (`_host_invert_coarse`), with one line on stderr."""
    try:
        return _invert_factor(_ridge_and_factor(Ac)), "device"
    except torch.cuda.OutOfMemoryError:
        print(f"[setup] coarse inverse: device out of memory at dim {Ac.shape[0]}; "
              f"building it on the host (_host_invert_coarse)", file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
        clock.lap("device_s")
        return (_host_invert_coarse(Ac.cpu().numpy(), Ac.device, clock),
                "host after device out of memory")


def _store_acinv(acinv: torch.Tensor, dtype) -> torch.Tensor:
    """The explicit coarse inverse in its storage dtype: bf16 where it is
    f32, the PCG's `dtype` is f32 and it lives on the card (unless its bf16
    copy is not positive definite: `_bf16_where_definite`), else unchanged
    (the CPU and the f64 path keep full precision), the reference's rule
    for its accelerator (`fea_large_tpu/solvers/multilevel.py:584`). Every
    CG iteration streams the inverse once, so its bytes bound the apply;
    bf16 rounding (~4e-3 relative, symmetry kept entry by entry) changes
    the preconditioner M, never the CG fixed point."""
    if acinv.dtype == torch.float32 and dtype == torch.float32 and acinv.device.type == "cuda":
        return _bf16_where_definite(acinv)
    return acinv


def _bf16_where_definite(acinv: torch.Tensor) -> torch.Tensor:
    """acinv rounded to bf16 where the rounded copy is still positive
    definite (its f32 Cholesky succeeds), else acinv as it is, with one
    line on stderr. Where the coarse operator is ill-conditioned, the
    rounding can exceed the inverse's smallest eigenvalue and make M
    indefinite, and CG stalls: on tasks/distributed_compression_kuhn.json
    (dim 432, condition 8.2e3) the bf16 copy has 6 negative eigenvalues,
    and the reference, which stores it all the same, runs pcg_maxiter
    (5,000) CG iterations and the block-Jacobi fallback in a Newton step."""
    stored = acinv.to(torch.bfloat16)
    if int(torch.linalg.cholesky_ex(stored.float()).info) == 0:
        return stored
    print(f"[setup] coarse inverse: its bf16 copy is not positive definite at dim "
          f"{acinv.shape[0]}; stored in f32", file=sys.stderr, flush=True)
    return acinv


def build_coarse_space(mesh, material, bc, agg_size: int | None = None,
                       modes: int = 3, soa=None) -> CoarseSpace:
    """Assemble and invert the coarse operator at the reference state u=0,
    where both hyperelastic tangents reduce to isotropic linear elasticity:
    with the f32 SoAProblem `soa`, by probing its tangent action on the
    device; without it (modes 3 and 6), on the host as the f64 sparse
    Galerkin product (the oracle of the probing, and the sharded
    builder's). Aggregates: `agg_size` nodes each, or the default target
    of 5,000, 2,500 or 1,250 aggregates for 3, 6 or 12 modes (the dense
    factor's size held at ~15k), scaled as in `default_agg_size`.
    FEA_COARSE_INVERT=host builds the inverse on the host. Every route
    stores the inverse by `_store_acinv`."""
    if modes not in (3, 6, 12):
        raise ValueError(f"coarse modes must be 3, 6 or 12, got {modes}")
    if modes == 12 and soa is None:
        raise ValueError(
            "coarse_modes=12 (the rigid-body + linear-strain basis) is assembled by "
            "on-device probing only: pass soa"
        )
    st = mesh.structure
    dev = mesh.device
    clock = _SetupClock(dev)
    coords = mesh.coords_host
    if agg_size is None:
        agg_size = default_agg_size(
            mesh.n_nodes, target_coarse={3: 5000, 6: 2500, 12: 1250}[modes],
            structured=st is not None,
        )
    if st is not None:
        pool = make_lattice_pool(st, max(1, mesh.n_nodes // agg_size))
    else:
        pool = AggregateTransfer.build(aggregate_nodes(coords, agg_size), dev)
    agg = pool.agg_host()
    n_agg = int(agg.max()) + 1
    dvec_np = None
    if modes >= 6:
        cnt = np.bincount(agg, minlength=n_agg).astype(float)
        cent = np.stack(
            [np.bincount(agg, weights=coords[:, d], minlength=n_agg) / cnt for d in range(3)],
            axis=1,
        )
        dvec_np = _rbm_dvec(coords, agg, cent, n_agg)
    if soa is not None:
        color, Bn, d, cm, src, dst, nc = _probe_plan(mesh.conn_host, agg, n_agg, modes, dvec_np)
        clock.lap("host_s")
        free32 = bc.free_mask.to(torch.float32)
        state0 = soa_freeze(soa, material, torch.zeros((3, mesh.n_nodes), dtype=torch.float32,
                                                       device=dev))
        Z = _probe_run(
            soa, state0, free32, torch.as_tensor(Bn, device=dev),
            torch.as_tensor(d, device=dev), torch.as_tensor(color[agg], device=dev),
            cm, modes, pool,
        )
        Ac = _assemble_dense_coarse(
            Z.reshape(-1), torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev), nc
        )
        clock.lap("device_s")
    else:
        free_mask = bc.free_mask.cpu().numpy()
        lam, mu = float(material.lam), float(material.mu)
        if modes == 3:
            Ac = _host_coarse_matrix(mesh, lam, mu, agg, n_agg, free_mask)
        else:
            Ac = _host_coarse_matrix_rbm(mesh, lam, mu, agg, dvec_np, n_agg, free_mask)
    if os.environ.get("FEA_COARSE_INVERT") == "host":
        Ac_np = Ac.cpu().numpy() if isinstance(Ac, torch.Tensor) else Ac
        clock.lap("host_s")
        acinv, route = _host_invert_coarse(Ac_np, dev, clock), "host"
    elif isinstance(Ac, torch.Tensor):
        acinv, route = _device_invert(Ac, clock)
    else:
        d_ = np.diagonal(Ac)
        Ac = Ac + np.diag((d_ <= 0.0).astype(Ac.dtype) + 1e-8 * max(d_.max(), 1.0))
        clock.lap("host_s")
        acinv = _invert_factor(torch.linalg.cholesky(torch.as_tensor(Ac, dtype=torch.float32,
                                                                     device=dev)))
        route = "device"
    clock.lap("device_s")
    return CoarseSpace(
        acinv=_store_acinv(acinv, torch.float32),
        dvec=None if dvec_np is None else torch.as_tensor(dvec_np, dtype=torch.float32, device=dev),
        n_agg=n_agg,
        modes=modes,
        pool=pool,
        dvec_T=None if dvec_np is None else torch.as_tensor(
            np.ascontiguousarray(dvec_np.T), dtype=torch.float32, device=dev),
        setup={**clock.seconds, "invert": route},
    )


@dataclasses.dataclass(frozen=True)
class MultilevelSpace:
    """Three-level additive (BPX-style) correction

        M_c r = P1 [Dc1^-1 + P2 Ac2^-1 P2^T] P1^T r

    with a large middle level (aggregates of ~16 nodes) solved by its 3x3
    block diagonal and a small dense level (Nc2 ~ thousands) solved by its
    explicit inverse: fixed SPD operators, so CG theory holds.

    t1     node -> level-1 aggregate transfer (`AggregateTransfer`)
    dinv1  f32[Nc1, 3, 3] masked inverse diagonal blocks of P1^T K0 P1
    t2     level-1 -> level-2 aggregate transfer
    ac2inv f32[3 Nc2, 3 Nc2] explicit inverse of Ac2 = P2^T A1 P2 (f32 on
           the card too: the reference does not store it in bf16)
    setup  host and device seconds of the build, and the inverse's route
    """

    t1: "AggregateTransfer"
    dinv1: torch.Tensor
    t2: "AggregateTransfer"
    ac2inv: torch.Tensor
    n_agg1: int
    n_agg2: int
    setup: dict = dataclasses.field(default_factory=dict, compare=False)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, 3]; every sum through the transfers' valence
        buckets (fixed order)."""
        rc1 = self.t1.restrict(r)
        z1 = (self.dinv1.to(r.dtype) * rc1[:, None, :]).sum(-1)
        rc2 = self.t2.restrict(rc1)
        x2 = (self.ac2inv @ rc2.reshape(-1).to(self.ac2inv.dtype)).reshape(self.n_agg2, 3)
        return self.t1.prolong(z1 + self.t2.prolong(x2.to(r.dtype)))


def build_multilevel_space(mesh, material, bc, agg_size1: int = 16,
                           target_coarse2: int = 2500) -> MultilevelSpace:
    """The three-level hierarchy at the reference state u=0. On the host:
    level-1 aggregates of `agg_size1` nodes (`aggregate_nodes`), level-2
    aggregates of their centroids toward `target_coarse2`, A1 = P1^T (M K0
    M) P1 by sparse products over `_host_k0_csr`, its masked inverse 3x3
    diagonal blocks, and Ac2 = P2^T A1 P2; on the mesh's device the ridged
    Cholesky and explicit inverse of Ac2."""
    dev = mesh.device
    clock = _SetupClock(dev)
    coords = mesh.coords_host
    free_mask = bc.free_mask.cpu().numpy()
    lam, mu = float(material.lam), float(material.mu)
    agg1 = aggregate_nodes(coords, agg_size1)
    n1 = int(agg1.max()) + 1
    cent = np.zeros((n1, 3))
    cnt = np.bincount(agg1, minlength=n1).astype(float)
    for d in range(3):
        cent[:, d] = np.bincount(agg1, weights=coords[:, d], minlength=n1) / cnt
    agg2 = aggregate_nodes(cent, max(1, n1 // max(target_coarse2, 1)))
    n2 = int(agg2.max()) + 1

    K = _host_k0_csr(mesh, lam, mu, free_mask)
    P1 = _prolongator_csr(coords, agg1, n1, 3)
    A1 = (P1.T @ (K @ P1)).tocsr()
    diag1 = np.zeros((n1, 3, 3))
    for i in range(3):
        sub = A1[3 * np.arange(n1) + i]
        for j in range(3):
            diag1[:, i, j] = np.asarray(sub[np.arange(n1), 3 * np.arange(n1) + j]).reshape(-1)
    P2 = _prolongator_csr(cent, agg2, n2, 3)
    Ac2 = np.asarray((P2.T @ (A1 @ P2)).todense())
    # rows and columns of fully fixed components become identity before
    # the 3x3 inversion
    ii = np.arange(3)
    active = np.einsum("nii->ni", diag1) > 0.0
    masked = diag1 * (active[:, :, None] & active[:, None, :]).astype(diag1.dtype)
    masked[:, ii, ii] += (~active).astype(diag1.dtype)
    dinv1 = np.linalg.inv(masked)
    d2 = np.diagonal(Ac2)
    Ac2 = Ac2 + np.diag((d2 <= 0.0).astype(Ac2.dtype) + 1e-8 * max(d2.max(), 1.0))
    t1, t2 = AggregateTransfer.build(agg1, dev), AggregateTransfer.build(agg2, dev)
    clock.lap("host_s")
    ac2inv = _invert_factor(torch.linalg.cholesky(torch.as_tensor(Ac2, dtype=torch.float32,
                                                                  device=dev)))
    space = MultilevelSpace(
        t1=t1, dinv1=torch.as_tensor(dinv1, dtype=torch.float32, device=dev), t2=t2,
        ac2inv=ac2inv, n_agg1=n1, n_agg2=n2,
    )
    clock.lap("device_s")
    space.setup.update(clock.seconds, invert="device")
    return space


def two_level_preconditioner(coarse, jacobi_apply, free_mask):
    """Additive two-level apply r -> jacobi_apply(r) + M coarse.apply(r)
    (M = free_mask: the identity-compatible masked system; both terms SPD
    on the free subspace)."""

    def apply(r):
        return jacobi_apply(r) + free_mask * coarse.apply(r)

    return apply
