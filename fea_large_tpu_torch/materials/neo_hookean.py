"""Compressible neo-Hookean materials (counterpart of
`fea_large_tpu/materials/neo_hookean.py`): the Ciarlet form (default) and
the volumetric-split variant.

Ciarlet:
  W  = mu/2 (I_C - 3) - mu ln J + lam/2 (ln J)^2,      J^2 = det C
  S  = mu (I - C^-1) + lam ln J C^-1
  CC = lam C^-1 (x) C^-1 + 2 (mu - lam ln J) II_{C^-1}
Volumetric split (kappa = lam):
  W  = mu/2 (I_C - 3) - mu ln J + kappa/2 (J - 1)^2
  S  = mu (I - C^-1) + kappa J (J - 1) C^-1
  CC = kappa J (2J - 1) C^-1 (x) C^-1 + 2 (mu - kappa J (J - 1)) II_{C^-1}
"""

from __future__ import annotations

import dataclasses

import torch

from fea_large_tpu_torch.materials.base import Material, register_material
from fea_large_tpu_torch.ops.smallmat import eye3, inv_det3


@register_material("neo_hookean", aliases=("neohookean", "nh", "neo-hookean"))
@dataclasses.dataclass(frozen=True)
class NeoHookean(Material):
    kind = 1

    def stress_and_factors(self, C):
        Cinv, detC = inv_det3(C)
        lnJ = 0.5 * torch.log(detC)
        S = self.mu * (eye3(C) - Cinv) + self.lam * lnJ[..., None, None] * Cinv
        return S, self.lam * torch.ones_like(lnJ), Cinv, 2.0 * (self.mu - self.lam * lnJ)


@register_material(
    "neo_hookean_vol", aliases=("nh_vol", "neo-hookean-vol", "a1")
)
@dataclasses.dataclass(frozen=True)
class NeoHookeanVolumetric(Material):
    kind = 2

    def stress_and_factors(self, C):
        Cinv, detC = inv_det3(C)
        J = torch.sqrt(detC)
        vol = self.lam * J * (J - 1.0)
        S = self.mu * (eye3(C) - Cinv) + vol[..., None, None] * Cinv
        return S, self.lam * J * (2.0 * J - 1.0), Cinv, 2.0 * (self.mu - vol)
