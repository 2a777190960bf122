"""Hyperelastic material interface (counterpart of
`fea_large_tpu/materials/base.py`).

A material is defined in the total-Lagrangian frame by the 2nd
Piola-Kirchhoff stress S(C) and the consistent tangent CC = 2 dS/dC, over
batches of right Cauchy-Green tensors C [..., 3, 3]. The interface is the
reference's, contraction-based, so the element passes never form the
rank-4 tangent:

  pk2(C)                      S
  pk2_and_state(C)            (S, state): what `tangent_apply` needs, once
                              per point
  tangent_apply(state, X)     CC : sym(X)
  iso_tangent_factors(state, C)  (alpha, A, beta) of the factored tangent
                              CC : X = alpha (A:X) A + beta A sym(X) A, or
                              None where the tangent has no such form
  tangent_full(C)             the rank-4 CC, by probing (tests only)

Every registered closed-form material has the factored tangent and defines
only `stress_and_factors(C)` -> (S, alpha, A, beta); the base class derives
the interface from it (its state is the factors). The element passes and
the matrix-free product take the factored branch where
`iso_tangent_factors` gives the factors and the generic one (probes through
`tangent_apply`) where it gives None, as the autodiff materials do
(materials/autodiff.py). The Lame constants are Python floats; the
computation takes the dtype of C, so one material object serves the f64
residual and the f32 tangent.

`kind` is the material code of the freeze and residual kernels (0 SVK, 1
neo-Hookean Ciarlet, 2 neo-Hookean volumetric); -1 for a material the
kernels do not take.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fea_large_tpu_torch.ops.smallmat import mm3


def factored_product(alpha, A, beta, Xs):
    """alpha (A:Xs) A + beta A Xs A for a symmetric Xs [..., 3, 3]."""
    AX = (A * Xs).sum((-2, -1))
    return (alpha * AX)[..., None, None] * A + beta[..., None, None] * mm3(mm3(A, Xs), A)


@dataclasses.dataclass(frozen=True)
class Material:
    """Lame-parameterized hyperelastic material."""

    lam: float
    mu: float

    name = "base"
    kind = -1

    def stress_and_factors(self, C: torch.Tensor):
        """(S [..., 3, 3], alpha [...], A [..., 3, 3], beta [...]) of a
        material with the factored tangent."""
        raise NotImplementedError

    def energy(self, C: torch.Tensor) -> torch.Tensor:
        """Strain-energy density W(C) over the batch of C [..., 3, 3]."""
        raise NotImplementedError

    def pk2(self, C: torch.Tensor) -> torch.Tensor:
        """2nd Piola-Kirchhoff stress S(C) [..., 3, 3]."""
        return self.pk2_and_state(C)[0]

    def pk2_and_state(self, C: torch.Tensor):
        """(S, state): the state carries what `tangent_apply` needs."""
        S, alpha, A, beta = self.stress_and_factors(C)
        return S, (alpha, A, beta)

    def tangent_apply(self, state, X: torch.Tensor) -> torch.Tensor:
        """CC : sym(X) for X [..., 3, 3] given `pk2_and_state`'s state; X's
        batch may extend the state's."""
        alpha, A, beta = state
        return factored_product(alpha, A, beta, 0.5 * (X + X.transpose(-1, -2)))

    def iso_tangent_factors(self, state, C: torch.Tensor):
        """(alpha [...], A [..., 3, 3], beta [...]) of the factored tangent,
        or None where it has no such form."""
        return state

    def tangent_full(self, C: torch.Tensor) -> torch.Tensor:
        """Rank-4 CC [..., I, J, K, L] = 2 dS/dC by probing `tangent_apply`
        with the basis matrices (tests only). Minor symmetry in (K, L) makes
        CC : sym(e_K e_L^T) = CC[..., K, L]."""
        _, state = self.pk2_and_state(C)
        basis = torch.eye(9, dtype=C.dtype, device=C.device).reshape(9, 3, 3)
        cols = torch.stack([self.tangent_apply(state, b.expand(C.shape)) for b in basis])
        cc = cols.reshape(3, 3, *C.shape[:-2], 3, 3)  # [K, L, ..., I, J]
        return torch.movedim(cc, (0, 1), (-2, -1))


def lame_from_E_nu(E: float, nu: float) -> tuple[float, float]:
    """Lame parameters (lambda, mu) from Young's modulus / Poisson ratio."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


MATERIAL_REGISTRY: dict[str, Callable[..., Material]] = {}


def register_material(name: str, aliases: tuple[str, ...] = ()):
    def deco(cls):
        MATERIAL_REGISTRY[name] = cls
        for a in aliases:
            MATERIAL_REGISTRY[a] = cls
        cls.name = name
        return cls

    return deco


def make_material(
    name: str,
    *,
    lam: float | None = None,
    mu: float | None = None,
    E: float | None = None,
    nu: float | None = None,
) -> Material:
    """Create a registered material from either Lame or (E, nu) constants."""
    if (lam is None) != (mu is None):
        raise ValueError("give both lam and mu, or neither")
    if lam is None:
        if E is None or nu is None:
            raise ValueError("give (lam, mu) or (E, nu)")
        lam, mu = lame_from_E_nu(E, nu)
    cls = MATERIAL_REGISTRY[name.lower()]
    return cls(float(lam), float(mu))
