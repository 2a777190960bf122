"""Materials defined by their strain energy alone (counterpart of
`fea_large_tpu/materials/autodiff.py`). Subclass `AutodiffMaterial`,
implement `energy(C)`, and the stress and the tangent action come from
`torch.func`:

    S       = 2 sym(dW/dC)        (grad under vmap)
    CC : dE = dS along dC = 2 dE  (jvp through S)

They have no factored tangent (`iso_tangent_factors` is None), so the
element passes take their generic branch, and no kernel code (`kind` -1):
they run on the f64 paths (direct, matrix-free and assembled PCG). The
mixed path's SoA passes reject them, as the reference's do.

`MooneyRivlin` (compressible, two-term) is provided, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import grad, jvp, vmap

from fea_large_tpu_torch.materials.base import Material, register_material
from fea_large_tpu_torch.ops.smallmat import det3, mm3


class AutodiffMaterial(Material):
    """Base: implement `energy(C)` ([..., 3, 3] -> [...]); S and the
    tangent action are derived."""

    def stress_and_factors(self, C):
        raise NotImplementedError(f"{type(self).__name__} has no factored tangent")

    def _energy_single(self, C):
        return self.energy(C[None])[0]

    def pk2(self, C):
        batch = C.shape[:-2]
        g = vmap(grad(self._energy_single))(C.reshape(-1, 3, 3))
        return (g + g.transpose(-1, -2)).reshape(*batch, 3, 3)

    def pk2_and_state(self, C):
        return self.pk2(C), C

    def tangent_apply(self, state, X):
        """CC : sym(X) = d/dt S(C + 2 t sym(X)) at t = 0 (dE = dC / 2)."""
        C = state
        Xs = 0.5 * (X + X.transpose(-1, -2))
        return jvp(self.pk2, (C,), (2.0 * Xs.expand(C.shape),))[1]

    def iso_tangent_factors(self, state, C):
        return None


@register_material("mooney_rivlin", aliases=("mooney-rivlin", "mr"))
@dataclasses.dataclass(frozen=True)
class MooneyRivlin(AutodiffMaterial):
    """Compressible two-term Mooney-Rivlin with an isochoric/volumetric
    split:

      W = c10 (I1_bar - 3) + c01 (I2_bar - 3) + kappa/2 (J - 1)^2,
      I1_bar = J^-2/3 tr C,  I2_bar = J^-4/3 ((tr C)^2 - tr(C^2)) / 2,

    from the Lame constants: c10 + c01 = mu/2 (the small-strain shear
    modulus) split by c01 = BETA mu/2, and kappa = lam + 2 mu/3 (the
    small-strain bulk modulus)."""

    BETA = 0.3  # c01 fraction of mu/2

    def energy(self, C):
        mu, lam = self.mu, self.lam
        c01 = 0.5 * mu * self.BETA
        c10 = 0.5 * mu - c01
        kappa = lam + 2.0 * mu / 3.0
        J = torch.sqrt(det3(C))
        I1 = C.diagonal(dim1=-2, dim2=-1).sum(-1)
        I2 = 0.5 * (I1**2 - mm3(C, C).diagonal(dim1=-2, dim2=-1).sum(-1))
        I1b = J ** (-2.0 / 3.0) * I1
        I2b = J ** (-4.0 / 3.0) * I2
        return c10 * (I1b - 3.0) + c01 * (I2b - 3.0) + 0.5 * kappa * (J - 1.0) ** 2
