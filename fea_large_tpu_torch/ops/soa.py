"""Element passes of the mixed-precision path on structured lattices
(counterpart of the structured parts of `fea_large_tpu/ops/soa.py`).

Per-element data keeps the reference's SoA layout, element axis last: the
frozen state is F, S, A [q, 3, 3, E] and alpha, beta [q, E], with
E = T*C tet-slot-major, so the [q*9*T, C] rows of the element passes are a
free view. Each pass gathers the (class, offset) pair cache, runs the
per-cell math, and scatters pair rows back to nodes
(ops/struct_kernels.py).

Routing is by the tensors' dtype and device, not by a backend probe:
  * f32 on CUDA: the hand-written kernel (`struct_*`);
  * f32 or f64 on the CPU: the plain version (the wrappers choose it for
    CPU tensors);
  * f64 on CUDA: the plain f64 pass. That is the mixed path's residual,
    which has no kernel yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.ops import struct_kernels as sk


@dataclasses.dataclass(frozen=True)
class SoAProblem:
    """Geometry of one uniform Kuhn lattice for the element passes: the
    per-tet-slot tables (`StructTables`: gradN [q, npe, 3, T], detJxW
    [q, T], the pair map) on the mesh's device, in one dtype."""

    n_nodes: int
    structure: object
    tables: sk.StructTables

    @property
    def gradN(self) -> torch.Tensor:
        return self.tables.gN

    @property
    def detJxW(self) -> torch.Tensor:
        return self.tables.dV

    @property
    def dtype(self) -> torch.dtype:
        return self.tables.gN.dtype

    @staticmethod
    def build(mesh, dtype=torch.float32) -> "SoAProblem":
        """Host-side build from a Kuhn-lattice Mesh. All cells of a tet slot
        are congruent, so the per-element tables collapse to per-slot
        constants; that is checked numerically."""
        st = mesh.structure
        if st is None:
            raise NotImplementedError(
                "the port's element passes run on structured Kuhn lattices only"
            )
        elem = mesh.element
        coords, conn = mesh.coords_host, mesh.conn_host
        dN = np.asarray(elem.shape_grad)  # [q, npe, 3]
        w = np.asarray(elem.quad_weights)
        J = np.einsum("eai,qaj->eqij", coords[conn], dN)
        detJ, Jinv = _np_inv_det_3x3(J)
        gradN = np.einsum("qaj,eqji->eqai", dN, Jinv)  # [E, q, npe, 3]
        T, C = st.n_tets, st.n_cells
        g5 = np.transpose(gradN, (1, 2, 3, 0)).reshape(*gradN.shape[1:], T, C)
        v3 = (detJ * w[None, :]).T.reshape(len(w), T, C)
        g_slot = np.ascontiguousarray(g5[..., 0])
        v_slot = np.ascontiguousarray(v3[..., 0])
        tol = 1e-12
        if not (
            np.max(np.abs(g5 - g_slot[..., None])) <= tol * np.max(np.abs(g_slot))
            and np.max(np.abs(v3 - v_slot[..., None])) <= tol * np.max(np.abs(v_slot))
        ):
            raise NotImplementedError("the lattice's cells are not uniform")
        return SoAProblem(
            n_nodes=int(mesh.n_nodes),
            structure=st,
            tables=sk.StructTables.build(st, g_slot, v_slot, dtype, mesh.device),
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

    def rows(self, tb: sk.StructTables):
        """(F, S, A, alpha, beta) as the passes' [rows, C] views."""
        q9t, qt = tb.q * 9 * tb.T, tb.q * tb.T
        return (
            self.F.view(q9t, tb.C), self.S.view(q9t, tb.C),
            self.A.view(q9t, tb.C), self.alpha.view(qt, tb.C),
            self.beta.view(qt, tb.C),
        )


def _route(p: SoAProblem, x: torch.Tensor, kernel, plain):
    """The kernel wrapper, or the plain pass for f64 (no f64 kernel yet)."""
    if x.dtype != p.dtype:
        raise TypeError(f"{x.dtype} tensor given to a {p.dtype} SoAProblem")
    return plain if x.dtype == torch.float64 else kernel


def soa_freeze(p: SoAProblem, material, u_T: torch.Tensor) -> SoAState:
    """Kinematics + constitutive state at u (u_T [3, N])."""
    tb = p.tables
    cache = sk.gather_cache(p.structure, tb.pairs, u_T)
    fn = _route(p, u_T, sk.struct_freeze, sk.struct_freeze_plain)
    F, S, A, al, be = fn(tb, cache, material)
    q, E = tb.q, tb.T * tb.C
    return SoAState(
        F=F.view(q, 3, 3, E), S=S.view(q, 3, 3, E), A=A.view(q, 3, 3, E),
        alpha=al.view(q, E), beta=be.view(q, E),
    )


def soa_internal_force(p: SoAProblem, state: SoAState) -> torch.Tensor:
    """f_int [3, N] from the frozen state: f_a = sum_q V (F S) g_a."""
    tb = p.tables
    F, S = state.rows(tb)[:2]
    fn = _route(p, F, sk.struct_force, sk.struct_force_plain)
    return sk.scatter_pairs(p.structure, tb.pairs, fn(tb, F, S), 3)


def soa_apply_tangent(p: SoAProblem, state: SoAState, v_T: torch.Tensor) -> torch.Tensor:
    """(K v) [3, N]: consistent-tangent action, material + geometric."""
    tb = p.tables
    cache = sk.gather_cache(p.structure, tb.pairs, v_T)
    fn = _route(p, v_T, sk.struct_apply, sk.struct_apply_plain)
    return sk.scatter_pairs(p.structure, tb.pairs, fn(tb, cache, *state.rows(tb)), 3)


def soa_diag_blocks(p: SoAProblem, state: SoAState) -> torch.Tensor:
    """Nodal 3x3 diagonal blocks [3, 3, N] for block-Jacobi."""
    tb = p.tables
    rows = state.rows(tb)
    fn = _route(p, rows[0], sk.struct_diag, sk.struct_diag_plain)
    out = sk.scatter_pairs(p.structure, tb.pairs, fn(tb, *rows), 9)
    return out.reshape(3, 3, p.n_nodes)
