"""Element passes of the mixed-precision path (counterpart of
`fea_large_tpu/ops/soa.py`), on Kuhn lattices and on unstructured meshes.

Per-element data keeps the reference's SoA layout, element axis last: the
frozen state is F, S, A [q, 3, 3, E] and alpha, beta [q, E].

Kuhn lattices (`mesh.structure` set): E = T*C tet-slot-major, so the
[q*9*T, C] rows of the lattice passes are a free view. Each pass gathers
the (class, offset) pair cache, runs the per-cell math, and scatters pair
rows back to nodes (ops/struct_kernels.py). Routing is by the tensors'
dtype and device:
  * f32 on CUDA: the hand-written kernel (`struct_*`);
  * f32 or f64 on the CPU: the plain version (the wrappers choose it for
    CPU tensors);
  * f64 on CUDA: the plain f64 pass (the f64 residual's kernel is
    ops/residual.py, chosen by `residual.resid_df_route` from the
    options' `resid_df`: NewtonSolver and the sharded ranks call it).

Unstructured meshes: full per-element tables gradN [q, npe, 3, E] and
detJxW [q, E], a conn_T gather, the element-block pass, and a
deterministic nodal sum in the fixed order of the valence buckets of
`ScatterBuckets`. The freeze, force, tangent action and block-Jacobi
diagonal route as on a lattice, to the element-block kernels (`ek.elem_*`,
ops/elem_kernels.py) for f32 on CUDA. On the card the tangent action's
kernel gathers its nodal values itself (int32 `conn32`), and every nodal
sum, f32 and f64, is a kernel (`ek.nodal_sum`) walking each node's slots
in the buckets' order (`ScatterBuckets.csr`); on the CPU the gather and
the buckets' padded sums (`ScatterBuckets.apply`) are plain PyTorch, as
in the reference. The nodal-sum kernels and the diagonal's (`ek.elem_diag`:
an element pass and a nodal sum) have no counterpart in the reference,
which sums through the buckets and forms this diagonal in plain jnp.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk


# ---------------------------------------------------------------------------
# deterministic nodal sums on unstructured meshes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScatterBuckets:
    """Scatter-as-gather maps: for each node, the flat (a-major) element
    slot positions that hit it, padded within power-of-two VALENCE BUCKETS.
    A nodal sum is then one padded gather and a masked sum per bucket, in a
    fixed order: deterministic on every device, with no atomics and no
    `index_add_` (whose float sums are not reproducible on CUDA).

    idx   per bucket int64 [nb, cap] positions into the flat [npe*E] data
    mask  per bucket float32 [nb, cap], 1 for real entries
    inv   int64 [N] node -> row of the concatenated buckets
    """

    idx: tuple
    mask: tuple
    inv: torch.Tensor

    @staticmethod
    def caps_for(cmax: int) -> list:
        caps, cap = [], 1
        while cap < max(cmax, 1):
            cap *= 2
            caps.append(cap)
        return caps or [1]

    @staticmethod
    def host_build(flat: np.ndarray, n_nodes: int, caps: list, nb_min: list | None = None):
        """(idx list, mask list, inv) in numpy, one entry per cap (possibly
        0-row); the reference's host build. `nb_min[b]` pads bucket b with
        dummy rows (idx 0, mask 0) up to that many, so that per-shard
        buckets stack on a shard axis (`build_stacked`)."""
        counts = np.bincount(flat, minlength=n_nodes)
        order = np.argsort(flat, kind="stable").astype(np.int64)
        starts = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        idx_t, mask_t = [], []
        inv = np.zeros(n_nodes, np.int64)
        off = 0
        lo = -1  # the first bucket also takes unreferenced (count 0) nodes
        for cap in caps:
            sel = np.nonzero((counts > lo) & (counts <= cap))[0]
            lo = cap
            c = counts[sel]
            span = np.minimum(np.arange(cap)[None, :], np.maximum(c - 1, 0)[:, None])
            pos = np.minimum(starts[sel][:, None] + span, max(len(order) - 1, 0))
            idx = order[pos]
            mask = (np.arange(cap)[None, :] < c[:, None]).astype(np.float32)
            inv[sel] = off + np.arange(len(sel))
            if nb_min is not None and len(sel) < nb_min[len(idx_t)]:
                pad = nb_min[len(idx_t)] - len(sel)
                idx = np.concatenate([idx, np.zeros((pad, cap), np.int64)])
                mask = np.concatenate([mask, np.zeros((pad, cap), np.float32)])
            off += idx.shape[0]
            idx_t.append(idx)
            mask_t.append(mask)
        return idx_t, mask_t, inv

    @staticmethod
    def build(conn_T: np.ndarray, n_nodes: int, device) -> "ScatterBuckets":
        """Buckets of the flat (a-major) slots of conn_T [npe, E] on `device`."""
        return ScatterBuckets.from_flat(np.asarray(conn_T).reshape(-1), n_nodes, device)

    @staticmethod
    def from_flat(flat: np.ndarray, n_out: int, device) -> "ScatterBuckets":
        """Buckets of a flat map entry -> output row (any int array) on
        `device`: entry j is summed into row flat[j], in the order of j."""
        flat = np.asarray(flat)
        cmax = int(np.bincount(flat, minlength=n_out).max()) if n_out else 1
        idx_t, mask_t, inv = ScatterBuckets.host_build(
            flat, n_out, ScatterBuckets.caps_for(cmax))
        keep = [b for b in range(len(idx_t)) if idx_t[b].shape[0] > 0]
        return ScatterBuckets(
            idx=tuple(torch.as_tensor(idx_t[b], device=device) for b in keep),
            mask=tuple(torch.as_tensor(mask_t[b], device=device) for b in keep),
            inv=torch.as_tensor(inv, device=device),
        )

    @staticmethod
    def build_stacked(conn_T_shards: np.ndarray, n_nodes: int, device="cpu") -> "ScatterBuckets":
        """Buckets of every shard's local connectivity conn_T_shards [S, npe,
        El] (padded elements included: they sum zero data), with a leading
        shard axis: idx and mask [S, nb, cap], inv [S, N]. The cap list and
        the rows per bucket are unified across shards, so that the shards'
        tables have one shape; `shard(p)` is shard p's ScatterBuckets."""
        conn_T_shards = np.asarray(conn_T_shards)
        S = conn_T_shards.shape[0]
        flats = [conn_T_shards[p].reshape(-1) for p in range(S)]
        cmax = max(int(np.bincount(f, minlength=n_nodes).max()) for f in flats) if n_nodes else 1
        caps = ScatterBuckets.caps_for(cmax)
        nb = [0] * len(caps)
        for f in flats:
            counts = np.bincount(f, minlength=n_nodes)
            lo = -1
            for bi, cap in enumerate(caps):
                nb[bi] = max(nb[bi], int(((counts > lo) & (counts <= cap)).sum()))
                lo = cap
        keep = [b for b in range(len(caps)) if nb[b] > 0]
        per = [ScatterBuckets.host_build(f, n_nodes, caps, nb_min=nb) for f in flats]
        return ScatterBuckets(
            idx=tuple(torch.as_tensor(np.stack([per[p][0][b] for p in range(S)]), device=device)
                      for b in keep),
            mask=tuple(torch.as_tensor(np.stack([per[p][1][b] for p in range(S)]), device=device)
                       for b in keep),
            inv=torch.as_tensor(np.stack([per[p][2] for p in range(S)]), device=device),
        )

    def shard(self, p: int, device=None) -> "ScatterBuckets":
        """Shard p of stacked buckets (`build_stacked`), on `device` (default:
        where they are)."""
        dev = self.inv.device if device is None else device
        return ScatterBuckets(
            idx=tuple(x[p].to(dev) for x in self.idx),
            mask=tuple(x[p].to(dev) for x in self.mask),
            inv=self.inv[p].to(dev),
        )

    @functools.cached_property
    def csr(self) -> tuple:
        """(offsets int32 [N + 1], ids int32 [M], span) on the buckets'
        device: output row n sums the flat entries ids[offsets[n]:offsets[n +
        1]], its bucket row's real entries in the order `apply` takes them
        (mask-0 padding, and rows that no output names, left out); span is
        the largest id + 1. The nodal-sum kernels walk it
        (ops/elem_kernels.py). Built on the host at its first use; one
        shard's buckets only (a 1-D `inv`)."""
        inv = self.inv.cpu().numpy()
        if inv.ndim != 1:
            raise ValueError("the table is built for one shard's buckets: take shard(p) first")
        live = [m.cpu().numpy() != 0 for m in self.mask]
        counts = np.concatenate([m.sum(1) for m in live])[inv]
        offsets = np.zeros(len(inv) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        ids = np.zeros(offsets[-1], np.int64)
        row0 = 0
        for idx, m in zip(self.idx, live):
            nodes = np.nonzero((inv >= row0) & (inv < row0 + m.shape[0]))[0]
            rows = inv[nodes] - row0
            keep = m[rows]
            pos = offsets[nodes][:, None] + np.cumsum(keep, 1) - 1
            ids[pos[keep]] = idx.cpu().numpy()[rows][keep]
            row0 += m.shape[0]
        span = int(ids.max()) + 1 if len(ids) else 0
        if max(offsets[-1], span) >= 2**31:
            raise ValueError("the nodal table's int32 ids cannot hold this many slots")
        dev = self.inv.device
        return (torch.as_tensor(offsets.astype(np.int32), device=dev),
                torch.as_tensor(ids.astype(np.int32), device=dev), span)

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        """d [n, npe*E] flat per-slot values -> [n, N] nodal sums."""
        parts = [(d[:, idx] * mask.to(d.dtype)).sum(2) for idx, mask in zip(self.idx, self.mask)]
        return torch.cat(parts, 1)[:, self.inv]

    def apply_rows(self, d: torch.Tensor) -> torch.Tensor:
        """d [M, ...] per-entry values, entry axis first -> [N, ...] sums."""
        tail = (1,) * (d.dim() - 1)
        parts = [(d[idx] * mask.to(d.dtype).view(*mask.shape, *tail)).sum(1)
                 for idx, mask in zip(self.idx, self.mask)]
        return torch.cat(parts, 0)[self.inv]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SoAProblem:
    """Geometry of one mesh for the element passes, in one dtype, on the
    mesh's device.

    gradN      [q, npe, 3, T] on a Kuhn lattice (per tet slot, the same
               for every cell), [q, npe, 3, E] on an unstructured mesh
    detJxW     [q, T] / [q, E]
    structure  the lattice's BoxStructure, None on unstructured meshes
    tables     the lattice's `StructTables` (gradN, detJxW, pair map)
    conn_T     int64 [npe, E] (unstructured)
    buckets    `ScatterBuckets` of conn_T (unstructured)
    conn32     conn_T in int32, B6's (unstructured; made from conn_T
               unless given)

    An unstructured problem builds conn32 and its buckets' nodal table
    (`ScatterBuckets.csr`) at construction, so that no kernel call, nor a
    captured body, builds them.
    """

    n_nodes: int
    gradN: torch.Tensor
    detJxW: torch.Tensor
    structure: object | None = None
    tables: sk.StructTables | None = None
    conn_T: torch.Tensor | None = None
    buckets: ScatterBuckets | None = None
    conn32: torch.Tensor | None = None

    def __post_init__(self):
        if self.conn_T is not None and self.conn32 is None:
            object.__setattr__(self, "conn32", self.conn_T.to(torch.int32).contiguous())
        if self.buckets is not None:
            self.buckets.csr  # noqa: B018 (built here, once)

    @property
    def dtype(self) -> torch.dtype:
        return self.gradN.dtype

    @staticmethod
    def build(mesh, dtype=torch.float32, share_maps_from: "SoAProblem | None" = None
              ) -> "SoAProblem":
        """Host-side build from a Mesh. On a Kuhn lattice all cells of a tet
        slot are congruent, so the per-element tables collapse to per-slot
        constants (checked numerically). `share_maps_from` reuses the index
        maps of a SoAProblem already built for the same mesh (they do not
        depend on the dtype)."""
        elem = mesh.element
        coords, conn = mesh.coords_host, mesh.conn_host
        dN = np.asarray(elem.shape_grad)  # [q, npe, 3]
        w = np.asarray(elem.quad_weights)
        J = np.einsum("eai,qaj->eqij", coords[conn], dN)
        detJ, Jinv = _np_inv_det_3x3(J)
        gradN = np.einsum("qaj,eqji->eqai", dN, Jinv)  # [E, q, npe, 3]
        gradN_T = np.transpose(gradN, (1, 2, 3, 0))  # [q, npe, 3, E]
        detJxW_T = (detJ * w[None, :]).T  # [q, E]
        dev = mesh.device
        st = mesh.structure
        if st is not None:
            T, C = st.n_tets, st.n_cells
            g5 = gradN_T.reshape(*gradN_T.shape[:3], T, C)
            v3 = detJxW_T.reshape(len(w), T, C)
            g_slot = np.ascontiguousarray(g5[..., 0])
            v_slot = np.ascontiguousarray(v3[..., 0])
            tol = 1e-12
            if not (
                np.max(np.abs(g5 - g_slot[..., None])) <= tol * np.max(np.abs(g_slot))
                and np.max(np.abs(v3 - v_slot[..., None])) <= tol * np.max(np.abs(v_slot))
            ):
                raise NotImplementedError("the lattice's cells are not uniform")
            tables = sk.StructTables.build(st, g_slot, v_slot, dtype, dev)
            return SoAProblem(n_nodes=int(mesh.n_nodes), gradN=tables.gN,
                              detJxW=tables.dV, structure=st, tables=tables)
        if share_maps_from is not None:
            maps = dict(conn_T=share_maps_from.conn_T, conn32=share_maps_from.conn32,
                        buckets=share_maps_from.buckets)
        else:
            conn_np = np.ascontiguousarray(conn.T)  # [npe, E]
            maps = dict(
                conn_T=torch.as_tensor(conn_np, device=dev),
                buckets=ScatterBuckets.build(conn_np, int(mesh.n_nodes), dev),
            )
        return SoAProblem(
            n_nodes=int(mesh.n_nodes),
            gradN=torch.as_tensor(gradN_T, dtype=dtype, device=dev).contiguous(),
            detJxW=torch.as_tensor(detJxW_T, dtype=dtype, device=dev).contiguous(),
            **maps,
        )


def _np_inv_det_3x3(J: np.ndarray):
    """(det, inverse) of a [..., 3, 3] stack via the adjugate closed form."""
    a = J[..., 0, 0]; b = J[..., 0, 1]; c = J[..., 0, 2]  # noqa: E702
    d = J[..., 1, 0]; e = J[..., 1, 1]; f = J[..., 1, 2]  # noqa: E702
    g = J[..., 2, 0]; h = J[..., 2, 1]; i = J[..., 2, 2]  # noqa: E702
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = np.empty_like(J)
    adj[..., 0, 0] = A
    adj[..., 0, 1] = c * h - b * i
    adj[..., 0, 2] = b * f - c * e
    adj[..., 1, 0] = B
    adj[..., 1, 1] = a * i - c * g
    adj[..., 1, 2] = c * d - a * f
    adj[..., 2, 0] = C
    adj[..., 2, 1] = b * g - a * h
    adj[..., 2, 2] = a * e - b * d
    return det, adj / det[..., None, None]


@dataclasses.dataclass(frozen=True)
class SoAState:
    """Frozen tangent state at u: [q, 3, 3, E] / [q, E]."""

    F: torch.Tensor
    S: torch.Tensor
    A: torch.Tensor  # iso-tangent factor matrix (I for SVK, C^-1 for NH)
    alpha: torch.Tensor
    beta: torch.Tensor

    @staticmethod
    def from_rows(q: int, F, S, A, alpha, beta) -> "SoAState":
        """From the passes' rows: F, S, A [q*9*T, C] or [q*9, E], alpha,
        beta [q*T, C] or [q, E] (contiguous)."""
        E = alpha.numel() // q
        return SoAState(F=F.view(q, 3, 3, E), S=S.view(q, 3, 3, E),
                        A=A.view(q, 3, 3, E), alpha=alpha.view(q, E),
                        beta=beta.view(q, E))

    def rows(self, tb: sk.StructTables):
        """(F, S, A, alpha, beta) as the lattice passes' [rows, C] views."""
        q9t, qt = tb.q * 9 * tb.T, tb.q * tb.T
        return (
            self.F.view(q9t, tb.C), self.S.view(q9t, tb.C),
            self.A.view(q9t, tb.C), self.alpha.view(qt, tb.C),
            self.beta.view(qt, tb.C),
        )


# ---------------------------------------------------------------------------
# gather and scatter (unstructured)
# ---------------------------------------------------------------------------


def soa_gather(p: SoAProblem, v_T: torch.Tensor) -> torch.Tensor:
    """v_T [n, N] -> per-element nodal values [n, npe, E] (one conn_T
    gather). Lattices gather pair caches instead (`sk.gather_cache`)."""
    return v_T[:, p.conn_T]


def soa_scatter(p: SoAProblem, fe: torch.Tensor) -> torch.Tensor:
    """Per-element nodal values fe [n, npe, E] -> nodal sums [n, N] in the
    valence buckets' fixed order: the nodal-sum kernel on the card (n = 3,
    f32 or f64), the buckets' sum on the CPU (`ek.nodal_sum`)."""
    return ek.nodal_sum(fe.reshape(fe.shape[0], -1).contiguous(), p.buckets)


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


def _route(p: SoAProblem, x: torch.Tensor, kernel, plain):
    """The kernel wrapper (which runs the plain version on CPU tensors), or
    the plain pass for f64: the f64 kernels are the fused residuals of
    ops/residual.py (B5, B9), chosen by `residual.resid_df_route`."""
    if x.dtype != p.dtype:
        raise TypeError(f"{x.dtype} tensor given to a {p.dtype} SoAProblem")
    return plain if x.dtype == torch.float64 else kernel


def _soa_material(material):
    """The SoA passes take the registered isotropic materials (the factored
    tangent and a kernel code); any other raises, as the reference's SoA
    material dispatch does."""
    if material.kind not in (0, 1, 2):
        raise NotImplementedError(
            f"SoA kernels support the registered isotropic materials; got "
            f"{type(material).__name__} (use the AoS path)"
        )


def soa_freeze(p: SoAProblem, material, u_T: torch.Tensor) -> SoAState:
    """Kinematics + constitutive state at u (u_T [3, N])."""
    _soa_material(material)
    if p.structure is None:
        q, npe, gradN, _ = ek.flat_tables(p)
        fn = _route(p, u_T, ek.elem_freeze, ek.elem_freeze_plain)
        return SoAState.from_rows(q, *fn(ek._gather_flat(p, u_T), gradN, material, npe=npe, q=q))
    tb = p.tables
    cache = sk.gather_cache(p.structure, tb.pairs, u_T)
    fn = _route(p, u_T, sk.struct_freeze, sk.struct_freeze_plain)
    return SoAState.from_rows(tb.q, *fn(tb, cache, material))


def soa_internal_force(p: SoAProblem, state: SoAState) -> torch.Tensor:
    """f_int [3, N] from the frozen state: f_a = sum_q V (F S) g_a."""
    if p.structure is None:
        q, npe, gradN, detJxW = ek.flat_tables(p)
        F, S = ek.flatten_state(state)[:2]
        fn = _route(p, F, ek.elem_force, ek.elem_force_plain)
        return soa_scatter(p, fn(gradN, detJxW, F, S, npe=npe, q=q).view(3, npe, -1))
    tb = p.tables
    F, S = state.rows(tb)[:2]
    fn = _route(p, F, sk.struct_force, sk.struct_force_plain)
    return sk.scatter_pairs(p.structure, tb.pairs, fn(tb, F, S), 3)


def soa_apply_tangent(p: SoAProblem, state: SoAState, v_T: torch.Tensor) -> torch.Tensor:
    """(K v) [3, N]: consistent-tangent action, material + geometric."""
    if p.structure is None:
        q, npe, gradN, detJxW = ek.flat_tables(p)
        fn = _route(p, v_T, ek.elem_apply, ek._apply_plain)
        out = fn(v_T.contiguous(), p.conn32, gradN, detJxW, *ek.flatten_state(state), npe=npe,
                 q=q)
        return soa_scatter(p, out.view(3, npe, -1))
    tb = p.tables
    cache = sk.gather_cache(p.structure, tb.pairs, v_T)
    fn = _route(p, v_T, sk.struct_apply, sk.struct_apply_plain)
    return sk.scatter_pairs(p.structure, tb.pairs, fn(tb, cache, *state.rows(tb)), 3)


def soa_diag_blocks(p: SoAProblem, state: SoAState) -> torch.Tensor:
    """Nodal 3x3 diagonal blocks [3, 3, N] for block-Jacobi."""
    if p.structure is None:
        q, npe, gradN, detJxW = ek.flat_tables(p)
        rows = ek.flatten_state(state)
        fn = _route(p, rows[0], ek.elem_diag, ek.elem_diag_plain)
        return fn(gradN, detJxW, *rows, p.buckets, npe=npe, q=q)
    tb = p.tables
    rows = state.rows(tb)
    fn = _route(p, rows[0], sk.struct_diag, sk.struct_diag_plain)
    out = sk.scatter_pairs(p.structure, tb.pairs, fn(tb, *rows), 9)
    return out.reshape(3, 3, p.n_nodes)
