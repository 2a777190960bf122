"""Matrix-free tangent operator of the f64 matrix-free path (counterpart of
`fea_large_tpu/assembly/matfree.py`).

K is never formed. Per Newton iterate `TangentState.freeze` evaluates the
per-point state (F, S and the tangent factors) once; each PCG iteration then
applies

    (K v)_e[a,i] = sum_q V_q dP_iJ g_a[J],
    dP = dF S + F dS,   dF = sum_b v_b (x) g_b,   dE = sym(F^T dF),
    dS = CC : dE

where a material with the factored tangent (materials/base.py) gives dS =
alpha (A:dE) A + beta A dE A from the frozen factors (dE is symmetric, so
A sym(dE) A = A dE A), and any other (an autodiff material) its
`tangent_apply` on its frozen state, as the reference calls it. Memory is
O(E q), and the nodal sums go through `NodeScatter` (fixed order, no
atomics).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements.kernels import (
    ElementGeometry,
    _nodal,
    _stress_state,
    element_diag_blocks,
)
from fea_large_tpu_torch.materials.base import factored_product
from fea_large_tpu_torch.ops.smallmat import mm3


class TangentState(NamedTuple):
    """Frozen per-point state of the consistent tangent at a displacement."""

    F: torch.Tensor  # [E, q, 3, 3]
    S: torch.Tensor  # [E, q, 3, 3]
    #: the factors (alpha [E, q], A [E, q, 3, 3], beta [E, q]) of a material
    #: with the factored tangent, else the material's `pk2_and_state` state
    mat_state: object

    @staticmethod
    def freeze(u: torch.Tensor, conn: torch.Tensor, geom: ElementGeometry,
               material) -> tuple["TangentState", torch.Tensor]:
        """(state, fe [E, npe, 3]) at u [N, 3]: the kinematics and the
        constitutive update once per Newton iterate, and the element
        internal force from the same F and S."""
        F, C, S, mat_state = _stress_state(u[conn], geom.gradN, material)
        fe = _nodal(mm3(F, S) * geom.detJxW[..., None, None], geom.gradN)
        factors = material.iso_tangent_factors(mat_state, C)
        return TangentState(F=F, S=S, mat_state=mat_state if factors is None else factors), fe


def apply_tangent(state: TangentState, v: torch.Tensor, conn: torch.Tensor,
                  geom: ElementGeometry, material, scatter: NodeScatter) -> torch.Tensor:
    """K(u) v [N, 3] without forming K: the exact consistent tangent,
    material and geometric."""
    g = geom.gradN
    dF = (v[conn][:, None, :, :, None] * g[:, :, :, None, :]).sum(2)  # [E, q, 3, 3]
    FtdF = mm3(state.F.transpose(-1, -2), dF)
    dE = 0.5 * (FtdF + FtdF.transpose(-1, -2))
    factors = material.iso_tangent_factors(state.mat_state, None)
    if factors is None:
        dS = material.tangent_apply(state.mat_state, dE)
    else:
        dS = factored_product(*factors, dE)
    dP = mm3(dF, state.S) + mm3(state.F, dS)
    return scatter(_nodal(dP * geom.detJxW[..., None, None], g))


class MatFreeOperator(NamedTuple):
    """Matrix-free K(u): the product, the internal force, the nodal
    diagonal blocks (block-Jacobi) and the frozen state the product reads.
    Built afresh per Newton iterate."""

    matvec: Callable[[torch.Tensor], torch.Tensor]
    f_int: torch.Tensor  # [N, 3]
    diag_blocks: torch.Tensor  # [N, 3, 3]
    state: TangentState


def make_operator(u: torch.Tensor, conn: torch.Tensor, geom: ElementGeometry, material,
                  scatter: NodeScatter) -> MatFreeOperator:
    """Freeze the tangent state at u [N, 3] and return the operator."""
    state, fe = TangentState.freeze(u, conn, geom, material)
    diag = scatter(element_diag_blocks(u[conn], geom, material))

    def matvec(v):
        return apply_tangent(state, v, conn, geom, material, scatter)

    return MatFreeOperator(matvec=matvec, f_int=scatter(fe), diag_blocks=diag, state=state)
