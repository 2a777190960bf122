"""Batched element kernels of the f64 paths: geometry, internal force,
consistent tangent and its nodal diagonal blocks (counterpart of
`fea_large_tpu/elements/kernels.py`).

Layout kept from the reference (element axis first):
  gradN    [E, q, npe, 3]      material shape-function gradients
  detJxW   [E, q]              det(J_iso) * w_q
  ue       [E, npe, 3]         gathered nodal displacements u[conn]
  F, S     [E, q, 3, 3]
  fe       [E, npe, 3]         fe[a,i] = sum_q V (F S)_iJ gradN[a,J]
  Ke       [E, npe, 3, npe, 3]

The tangent has two branches, as in the reference. The registered
materials give the factored tangent CC = alpha A (x) A + beta II_A
(`Material.iso_tangent_factors`), and the stiffness is formed from its
factors: every product over the 3x3 and npe axes is a broadcast multiply
and sum, and the stiffness is accumulated one quadrature point at a time
into one [E, npe, 3, npe, 3] buffer with in-place `addcmul_` (as batched
matrix products the per-element blocks would run as millions of tiny
GEMMs, and summed over q in one expression each term would hold q times
the size of Ke: 6.7 GB in f64 for the TET10 box n=36). A material without
the factors (an autodiff material, materials/autodiff.py) takes the
generic branch: the probes D[a,i] = F_iI g_a[J] (`_tangent_probe`) go
through the material's `tangent_apply` (`_tangent_contract`) and are
contracted with D, over element chunks of `GENERIC_CHUNK`: D and Y are
[E, q, npe, 3, 3, 3], 2.0 GB each in f64 for that box, and the vmapped
tangent's transients ~20 times Y. Each element's blocks are computed
within one chunk and the chunks are fixed, so repeats are bitwise equal.

On the card the assembled route does not call `element_stiffness`: for an
f64 u, a registered material and a kernel's element, `assemble_bcsr`
(assembly/bcsr.py) runs the element pass of ops/assembly_kernels.py, the
same factored form per stored upper block, and these functions serve the
CPU, the generic branch and the other callers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from fea_large_tpu_torch.ops.smallmat import inv_det3, mm3


class ElementGeometry(NamedTuple):
    """Per-element, per-point material gradients and volumes."""

    gradN: torch.Tensor  # [E, q, npe, 3]
    detJxW: torch.Tensor  # [E, q]


def precompute_geometry(coords: torch.Tensor, conn: torch.Tensor, elem) -> ElementGeometry:
    """J[i,j] = sum_a X[a,i] dN_a/dxi_j; gradN[a,i] = dN_a/dxi_j (J^-1)[j,i];
    detJxW = det(J) w_q. On the device of `coords`."""
    Xe = coords[conn]  # [E, npe, 3]
    dN = torch.as_tensor(elem.shape_grad, dtype=coords.dtype, device=coords.device)  # [q, npe, 3]
    J = (Xe[:, None, :, :, None] * dN[None, :, :, None, :]).sum(2)  # [E, q, 3, 3]
    Jinv, detJ = inv_det3(J)
    gradN = (dN[None, :, :, :, None] * Jinv[:, :, None, :, :]).sum(3)  # [E, q, npe, 3]
    w = torch.as_tensor(elem.quad_weights, dtype=coords.dtype, device=coords.device)
    return ElementGeometry(gradN=gradN, detJxW=detJ * w)


def deformation_gradient(ue: torch.Tensor, gradN: torch.Tensor) -> torch.Tensor:
    """F = I + sum_a u_a (x) gradN_a: [E, q, 3, 3] from ue [E, npe, 3]."""
    F = (ue[:, None, :, :, None] * gradN[:, :, :, None, :]).sum(2)
    return F + torch.eye(3, dtype=ue.dtype, device=ue.device)


#: elements per chunk of the generic tangent branch: D and Y of a TET10
#: chunk are 283 MB each in f64, and the vmapped tangent's transients ~20
#: times Y (measured on the CPU)
GENERIC_CHUNK = 32768


def _stress_state(ue, gradN, material):
    """(F, C, S, state) at every point: the material's `pk2_and_state`."""
    F = deformation_gradient(ue, gradN)
    C = mm3(F.transpose(-1, -2), F)
    S, state = material.pk2_and_state(C)
    return F, C, S, state


def _nodal(PV: torch.Tensor, gradN: torch.Tensor) -> torch.Tensor:
    """sum_q PV_iJ gradN[a,J] for weighted PV [E, q, 3, 3] -> [E, npe, 3]."""
    return (PV[:, :, None, :, :] * gradN[:, :, :, None, :]).sum((1, 4))


def element_internal_force(ue: torch.Tensor, geom: ElementGeometry, material) -> torch.Tensor:
    """fe [E, npe, 3]: fe[a,i] = sum_q V_q (F S)_iJ gradN[a,J]."""
    F, _, S, _ = _stress_state(ue, geom.gradN, material)
    return _nodal(mm3(F, S) * geom.detJxW[..., None, None], geom.gradN)


def _gMg(g: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """g_a . M . g_b: [E, q, npe, npe]."""
    gM = (g[..., :, None] * M[:, :, None, :, :]).sum(-2)  # [E, q, npe, 3]
    return (gM[:, :, :, None, :] * g[:, :, None, :, :]).sum(-1)


def _tangent_probe(F: torch.Tensor, gradN: torch.Tensor) -> torch.Tensor:
    """D[e,q,a,i,I,J] = F_iI gradN[a,J]: dE for a unit displacement of
    (node a, component i) is sym(D[a,i])."""
    return F[:, :, None, :, :, None] * gradN[:, :, :, None, None, :]


def _tangent_contract(material, state, D: torch.Tensor) -> torch.Tensor:
    """Y[e,q,a,i] = CC : sym(D[a,i]) without forming the rank-4 CC: the
    material's `tangent_apply` over the [E, q] batch of `state`, vmapped
    over the probe axes (a, i) as in the reference, so the state's own
    computation runs once and only the tangents carry the probe axis."""
    E, q, npe = D.shape[:3]
    Dm = D.movedim((2, 3), (0, 1)).reshape(npe * 3, E, q, 3, 3)
    Y = vmap(lambda X: material.tangent_apply(state, X))(Dm)
    return Y.reshape(npe, 3, E, q, 3, 3).movedim((0, 1), (2, 3))


def _generic_blocks(F, g, V, material, state, diag: bool) -> torch.Tensor:
    """The generic branch's material term, chunk by chunk of elements:
    Ke_mat [E, npe, 3, npe, 3], or its nodal diagonal [E, npe, 3, 3].
    `state` is the autodiff materials' state, C [E, q, 3, 3]."""
    E, _, npe = g.shape[:3]
    shape = (E, npe, 3, 3) if diag else (E, npe, 3, npe, 3)
    out = F.new_empty(shape)
    for s0 in range(0, E, GENERIC_CHUNK):
        sl = slice(s0, s0 + GENERIC_CHUNK)
        D = _tangent_probe(F[sl], g[sl])
        Y = _tangent_contract(material, state[sl], D)
        DV = D * V[sl, :, None, None, None, None]
        out[sl] = torch.einsum("eqaiIJ,eqakIJ->eaik" if diag else "eqaiIJ,eqbkIJ->eaibk", DV, Y)
    return out


def element_stiffness(ue: torch.Tensor, geom: ElementGeometry, material):
    """(Ke [E, npe, 3, npe, 3], fe [E, npe, 3]): the consistent tangent,
    material and geometric, and the internal force. With s[a,i] = (F A
    g_a)_i, B = F A F^T, G_ab = g_a.A.g_b and Gs_ab = g_a.S.g_b:

      Ke[a,i,b,k] = sum_q V [alpha s_ai s_bk + beta/2 (B_ik G_ab + s_ak s_bi)
                             + Gs_ab delta_ik]

    Without the factors (the generic branch), the material term is
    sum_q V D[a,i] : Y[b,k] with Y[b,k] = CC : sym(D[b,k]).
    """
    g, V = geom.gradN, geom.detJxW
    F, C, S, state = _stress_state(ue, g, material)
    fe = _nodal(mm3(F, S) * V[..., None, None], g)
    factors = material.iso_tangent_factors(state, C)
    if factors is None:
        Ke = _generic_blocks(F, g, V, material, state, diag=False)
        Gs = (V[..., None, None] * _gMg(g, S)).sum(1)  # [E, npe, npe]
        eye = torch.eye(3, dtype=ue.dtype, device=ue.device)
        return Ke + Gs[:, :, None, :, None] * eye[:, None, :], fe
    alpha, A, beta = factors
    FA = mm3(F, A)
    s = (FA[:, :, None, :, :] * g[:, :, :, None, :]).sum(-1)  # [E, q, npe, 3]
    B = mm3(FA, F.transpose(-1, -2))  # [E, q, 3, 3]

    G, Gs = _gMg(g, A), _gMg(g, S)
    wa = V * alpha.expand(V.shape)
    wb = 0.5 * V * beta.expand(V.shape)
    E, q, npe = g.shape[:3]
    eye = torch.eye(3, dtype=ue.dtype, device=ue.device)
    Ke = ue.new_zeros((E, npe, 3, npe, 3))
    for k in range(q):
        sk = s[:, k]  # [E, npe, 3]
        ka, kb = wa[:, k, None, None], wb[:, k, None, None]
        Ke.addcmul_((ka * sk)[:, :, :, None, None], sk[:, None, None, :, :])
        Ke.addcmul_((kb * B[:, k])[:, None, :, None, :], G[:, k][:, :, None, :, None])
        Ke.addcmul_((kb * sk)[:, :, None, None, :], sk.transpose(1, 2)[:, None, :, :, None])
        Ke.addcmul_((V[:, k, None, None] * Gs[:, k])[:, :, None, :, None], eye[:, None, :])
    return Ke, fe


def element_diag_blocks(ue: torch.Tensor, geom: ElementGeometry, material) -> torch.Tensor:
    """Per-element nodal diagonal blocks Ke[a, :, a, :] -> [E, npe, 3, 3],
    the block-Jacobi preconditioner of the matrix-free path without
    assembling K (the nodal sums go through `NodeScatter`). The diagonal of
    `element_stiffness`'s factored form, with G_aa = g_a.A.g_a and
    Gs_aa = g_a.S.g_a:

      D[a,i,k] = sum_q V [(alpha + beta/2) s_ai s_ak + beta/2 B_ik G_aa
                          + Gs_aa delta_ik]

    Without the factors (the generic branch) the material term is
    sum_q V D[a,i] : Y[a,k].
    """
    g, V = geom.gradN, geom.detJxW
    F, C, S, state = _stress_state(ue, g, material)
    eye = torch.eye(3, dtype=ue.dtype, device=ue.device)

    def gMg(M):  # g_a . M . g_a: [E, q, npe]
        return ((g[..., :, None] * M[:, :, None, :, :]).sum(-2) * g).sum(-1)

    factors = material.iso_tangent_factors(state, C)
    if factors is None:
        gs = (V[..., None] * gMg(S)).sum(1)  # [E, npe]
        return _generic_blocks(F, g, V, material, state, diag=True) + gs[..., None, None] * eye
    alpha, A, beta = factors
    FA = mm3(F, A)
    s = (FA[:, :, None, :, :] * g[:, :, :, None, :]).sum(-1)  # [E, q, npe, 3]
    B = mm3(FA, F.transpose(-1, -2))  # [E, q, 3, 3]
    wss = (V * (alpha + 0.5 * beta))[..., None, None, None]
    wb = (0.5 * V * beta)[..., None] * gMg(A)  # [E, q, npe]
    D = (wss * s[..., :, None] * s[..., None, :]).sum(1)
    D = D + (wb[..., None, None] * B[:, :, None]).sum(1)
    gs = (V[..., None] * gMg(S)).sum(1)  # [E, npe]
    return D + gs[..., None, None] * eye
