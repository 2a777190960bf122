"""Hyperelastic material interface (counterpart of
`fea_large_tpu/materials/base.py`).

A material is defined in the total-Lagrangian frame by the 2nd
Piola-Kirchhoff stress S(C) and the consistent tangent CC = 2 dS/dC. Every
registered material has the factored isotropic tangent

    CC : X = alpha (A:X) A + beta A sym(X) A,     A symmetric,

which is all the element passes need: `stress_and_factors(C)` returns
(S, alpha, A, beta) for a batch of right Cauchy-Green tensors C [..., 3, 3].
The Lame constants are Python floats; the computation takes the dtype of C,
so one material object serves the f64 residual and the f32 tangent.

`kind` is the material code of the structured freeze kernel
(0 SVK, 1 neo-Hookean Ciarlet, 2 neo-Hookean volumetric).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Material:
    """Lame-parameterized hyperelastic material."""

    lam: float
    mu: float

    name = "base"
    kind = -1

    def stress_and_factors(self, C: torch.Tensor):
        """(S [..., 3, 3], alpha [...], A [..., 3, 3], beta [...])."""
        raise NotImplementedError


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
