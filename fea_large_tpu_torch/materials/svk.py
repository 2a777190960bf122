"""St. Venant-Kirchhoff material (counterpart of
`fea_large_tpu/materials/svk.py`).

  W  = lam/2 tr(E)^2 + mu E:E,          E = (C - I)/2
  S  = lam tr(E) I + 2 mu E
  CC = lam I (x) I + 2 mu II            (alpha = lam, A = I, beta = 2 mu)
"""

from __future__ import annotations

import dataclasses

import torch

from fea_large_tpu_torch.materials.base import Material, register_material
from fea_large_tpu_torch.ops.smallmat import eye3


@register_material("svk", aliases=("st_venant_kirchhoff", "a5"))
@dataclasses.dataclass(frozen=True)
class StVenantKirchhoff(Material):
    kind = 0

    def stress_and_factors(self, C):
        I = eye3(C)
        trE = 0.5 * (C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2] - 3.0)
        S = self.lam * trE[..., None, None] * I + self.mu * (C - I)
        one = torch.ones_like(trE)
        return S, self.lam * one, I, 2.0 * self.mu * one
