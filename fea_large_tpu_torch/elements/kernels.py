"""Batched element kernels of the f64 assembled path: geometry, internal
force and consistent tangent (counterpart of
`fea_large_tpu/elements/kernels.py`).

Layout kept from the reference (element axis first):
  gradN    [E, q, npe, 3]      material shape-function gradients
  detJxW   [E, q]              det(J_iso) * w_q
  ue       [E, npe, 3]         gathered nodal displacements u[conn]
  F, S     [E, q, 3, 3]
  fe       [E, npe, 3]         fe[a,i] = sum_q V (F S)_iJ gradN[a,J]
  Ke       [E, npe, 3, npe, 3]

Every registered material returns the factored tangent CC = alpha A (x) A
+ beta II_A (materials/base.py), so the stiffness is the reference's
factored branch only. The reference writes it as batched einsums; here
every product over the 3x3 and npe axes is a broadcast multiply and sum,
and the stiffness is accumulated one quadrature point at a time into one
[E, npe, 3, npe, 3] buffer with in-place `addcmul_`: as batched matrix
products the per-element blocks would run as millions of tiny GEMMs, and
summed over q in one expression each term would hold q times the size of
Ke (6.7 GB in f64 for the TET10 box n=36).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def _stress_state(ue, gradN, material):
    """(F, S, alpha, A, beta) at every point."""
    F = deformation_gradient(ue, gradN)
    S, alpha, A, beta = material.stress_and_factors(mm3(F.transpose(-1, -2), F))
    return F, S, alpha, A, beta


def _nodal(PV: torch.Tensor, gradN: torch.Tensor) -> torch.Tensor:
    """sum_q PV_iJ gradN[a,J] for weighted PV [E, q, 3, 3] -> [E, npe, 3]."""
    return (PV[:, :, None, :, :] * gradN[:, :, :, None, :]).sum((1, 4))


def element_internal_force(ue: torch.Tensor, geom: ElementGeometry, material) -> torch.Tensor:
    """fe [E, npe, 3]: fe[a,i] = sum_q V_q (F S)_iJ gradN[a,J]."""
    F, S = _stress_state(ue, geom.gradN, material)[:2]
    return _nodal(mm3(F, S) * geom.detJxW[..., None, None], geom.gradN)


def element_stiffness(ue: torch.Tensor, geom: ElementGeometry, material):
    """(Ke [E, npe, 3, npe, 3], fe [E, npe, 3]): the consistent tangent,
    material and geometric, and the internal force. With s[a,i] = (F A
    g_a)_i, B = F A F^T, G_ab = g_a.A.g_b and Gs_ab = g_a.S.g_b:

      Ke[a,i,b,k] = sum_q V [alpha s_ai s_bk + beta/2 (B_ik G_ab + s_ak s_bi)
                             + Gs_ab delta_ik]
    """
    g, V = geom.gradN, geom.detJxW
    F, S, alpha, A, beta = _stress_state(ue, g, material)
    fe = _nodal(mm3(F, S) * V[..., None, None], g)
    FA = mm3(F, A)
    s = (FA[:, :, None, :, :] * g[:, :, :, None, :]).sum(-1)  # [E, q, npe, 3]
    B = mm3(FA, F.transpose(-1, -2))  # [E, q, 3, 3]

    def gMg(M):  # g_a . M . g_b: [E, q, npe, npe]
        gM = (g[..., :, None] * M[:, :, None, :, :]).sum(-2)  # [E, q, npe, 3]
        return (gM[:, :, :, None, :] * g[:, :, None, :, :]).sum(-1)

    G, Gs = gMg(A), gMg(S)
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
