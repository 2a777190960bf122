"""Stress recovery and derived fields (counterpart of
`fea_large_tpu/postprocess.py`), once per converged load step:

  * per-point 2nd Piola-Kirchhoff S and Cauchy stress sigma = J^-1 F S F^T
    (push-forward to the deformed configuration),
  * nodal averages (volume-weighted over adjacent quadrature points) for
    visualization, summed through `NodeScatter` (fixed order, no atomics),
  * von Mises equivalent stress.
"""

from __future__ import annotations

import torch

from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements.kernels import (
    ElementGeometry,
    deformation_gradient,
    precompute_geometry,
)
from fea_large_tpu_torch.ops.smallmat import det3, mm3


def quad_point_stress(u, conn, geom: ElementGeometry, material):
    """(S [E,q,3,3], sigma [E,q,3,3], J [E,q]) at every quadrature point."""
    F = deformation_gradient(u[conn], geom.gradN)
    S = material.pk2(mm3(F.transpose(-1, -2), F))
    J = det3(F)
    sigma = mm3(mm3(F, S), F.transpose(-1, -2)) / J[..., None, None]
    return S, sigma, J


def von_mises(sigma):
    """Equivalent (von Mises) stress of [..., 3, 3] Cauchy tensors."""
    tr = sigma.diagonal(dim1=-2, dim2=-1).sum(-1)
    dev = sigma - (tr / 3.0)[..., None, None] * torch.eye(3, dtype=sigma.dtype,
                                                         device=sigma.device)
    return torch.sqrt(1.5 * (dev * dev).sum((-2, -1)))


def _nodal_average(values_eq, detJxW, conn, scatter: NodeScatter):
    """Volume-weighted average of per-point values [E, q, ...] onto the
    nodes through the elements' nodes."""
    extra = (1,) * (values_eq.ndim - 2)
    w = detJxW.reshape(detJxW.shape + extra)
    ve = (w * values_eq).sum(1) / detJxW.sum(1).reshape((-1,) + extra)
    npe = conn.shape[1]
    num = scatter(ve[:, None].expand(ve.shape[0], npe, *ve.shape[1:]))
    den = scatter(torch.ones((conn.shape[0], npe), dtype=ve.dtype, device=ve.device))
    return num / den.reshape(den.shape + (1,) * (num.ndim - 1))


def nodal_stress(mesh, material, u):
    """Nodal-averaged Cauchy stress [N, 3, 3] and von Mises [N] of a
    displacement u [N, 3] on the mesh's device."""
    geom = precompute_geometry(mesh.coords, mesh.conn, mesh.element)
    scatter = NodeScatter.build(mesh.conn_host, mesh.n_nodes, mesh.device)
    _, sigma, _ = quad_point_stress(u, mesh.conn, geom, material)
    sig_n = _nodal_average(sigma, geom.detJxW, mesh.conn, scatter)
    return sig_n, von_mises(sig_n)
