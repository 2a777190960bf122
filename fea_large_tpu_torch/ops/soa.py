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
    ops/residual.py, chosen by the solver's `resid_df`).

Unstructured meshes: full per-element tables gradN [q, npe, 3, E] and
detJxW [q, E], a conn_T gather, the element-block pass, and a
deterministic nodal sum through the valence buckets of `ScatterBuckets`.
The freeze, force and tangent action route as on a lattice, to the
element-block kernels (`ek.elem_*`, ops/elem_kernels.py) for f32 on CUDA;
the diagonal has no kernel in the reference and stays plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.ops.smallmat import mm3


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
    def host_build(flat: np.ndarray, n_nodes: int, caps: list):
        """(idx list, mask list, inv) in numpy, one entry per cap (possibly
        0-row); the reference's host build."""
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
            idx_t.append(order[pos])
            mask_t.append((np.arange(cap)[None, :] < c[:, None]).astype(np.float32))
            inv[sel] = off + np.arange(len(sel))
            off += len(sel)
        return idx_t, mask_t, inv

    @staticmethod
    def build(conn_T: np.ndarray, n_nodes: int, device) -> "ScatterBuckets":
        """Buckets of the flat (a-major) slots of conn_T [npe, E] on `device`."""
        flat = np.asarray(conn_T).reshape(-1)
        cmax = int(np.bincount(flat, minlength=n_nodes).max()) if n_nodes else 1
        idx_t, mask_t, inv = ScatterBuckets.host_build(
            flat, n_nodes, ScatterBuckets.caps_for(cmax))
        keep = [b for b in range(len(idx_t)) if idx_t[b].shape[0] > 0]
        return ScatterBuckets(
            idx=tuple(torch.as_tensor(idx_t[b], device=device) for b in keep),
            mask=tuple(torch.as_tensor(mask_t[b], device=device) for b in keep),
            inv=torch.as_tensor(inv, device=device),
        )

    def apply(self, d: torch.Tensor) -> torch.Tensor:
        """d [n, npe*E] flat per-slot values -> [n, N] nodal sums."""
        parts = [(d[:, idx] * mask.to(d.dtype)).sum(2) for idx, mask in zip(self.idx, self.mask)]
        return torch.cat(parts, 1)[:, self.inv]


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
    """

    n_nodes: int
    gradN: torch.Tensor
    detJxW: torch.Tensor
    structure: object | None = None
    tables: sk.StructTables | None = None
    conn_T: torch.Tensor | None = None
    buckets: ScatterBuckets | None = None

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
            maps = dict(conn_T=share_maps_from.conn_T, buckets=share_maps_from.buckets)
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
    """Per-element nodal values fe [n, npe, E] -> nodal sums [n, N] through
    the valence buckets (fixed order)."""
    return p.buckets.apply(fe.reshape(fe.shape[0], -1))


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


def _route(p: SoAProblem, x: torch.Tensor, kernel, plain):
    """The kernel wrapper (which runs the plain version on CPU tensors), or
    the plain pass for f64: the Kuhn lattice's f64 kernel is the fused
    residual (ops/residual.py); the unstructured one (B9) is not ported."""
    if x.dtype != p.dtype:
        raise TypeError(f"{x.dtype} tensor given to a {p.dtype} SoAProblem")
    return plain if x.dtype == torch.float64 else kernel


def soa_freeze(p: SoAProblem, material, u_T: torch.Tensor) -> SoAState:
    """Kinematics + constitutive state at u (u_T [3, N])."""
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
        fn = _route(p, v_T, ek.elem_apply, ek.elem_apply_plain)
        out = fn(ek._gather_flat(p, v_T), gradN, detJxW, *ek.flatten_state(state), npe=npe, q=q)
        return soa_scatter(p, out.view(3, npe, -1))
    tb = p.tables
    cache = sk.gather_cache(p.structure, tb.pairs, v_T)
    fn = _route(p, v_T, sk.struct_apply, sk.struct_apply_plain)
    return sk.scatter_pairs(p.structure, tb.pairs, fn(tb, cache, *state.rows(tb)), 3)


def soa_diag_blocks(p: SoAProblem, state: SoAState) -> torch.Tensor:
    """Nodal 3x3 diagonal blocks [3, 3, N] for block-Jacobi."""
    if p.structure is None:
        return soa_scatter(p, _elem_diag_plain(p, state)).reshape(3, 3, p.n_nodes)
    tb = p.tables
    rows = state.rows(tb)
    fn = _route(p, rows[0], sk.struct_diag, sk.struct_diag_plain)
    out = sk.scatter_pairs(p.structure, tb.pairs, fn(tb, *rows), 9)
    return out.reshape(3, 3, p.n_nodes)


def _elem_diag_plain(p: SoAProblem, state: SoAState) -> torch.Tensor:
    """Per-element 3x3 diagonal blocks [9, npe, E] (rows 3i + k):
    sum_q V [(alpha + beta/2) s_a s_a^T + (beta/2) B G_aa + (g_a.S.g_a) I]
    with FA = F A, B = FA F^T, s_a = FA g_a, G_aa = g_a.A.g_a. The
    reference has no kernel for this pass on unstructured meshes. Written
    as broadcast multiplies and sums (`mm3`): as batched matrix products
    the per-element 3x3 blocks run as millions of tiny GEMMs."""
    def pts(x):  # [q, 3, 3, E] -> [q, E, 1, 3, 3]
        return x.permute(0, 3, 1, 2)[:, :, None]

    F, S, A = pts(state.F), pts(state.S), pts(state.A)
    g = p.gradN.permute(0, 3, 1, 2)  # [q, E, npe, 3]
    gJ = g[..., None, :]  # [q, E, npe, 1, 3]
    FA = mm3(F, A)
    B = mm3(FA, F.transpose(-1, -2))
    s = (FA * gJ).sum(-1)  # [q, E, npe, 3]
    G = (g * (A * gJ).sum(-1)).sum(-1)  # [q, E, npe]
    geo = (g * (S * gJ).sum(-1)).sum(-1) * p.detJxW[..., None]
    w1 = ((state.alpha + 0.5 * state.beta) * p.detJxW)[..., None, None, None]
    w2 = (0.5 * state.beta * p.detJxW)[..., None, None, None]
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    term = (
        w1 * s[..., :, None] * s[..., None, :]
        + w2 * B * G[..., None, None]
        + geo[..., None, None] * eye
    )  # [q, E, npe, 3, 3]
    return term.sum(0).permute(2, 3, 1, 0).reshape(9, p.gradN.shape[1], -1)
