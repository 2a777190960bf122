"""The f64 residual of the mixed path as one kernel pass (counterpart of
`fea_large_tpu/ops/pallas_residual.py`).

The reference runs this pass in double-word f32 arithmetic because Pallas
on the TPU is f32-only. Hopper has native f64, so here it is the plain f64
pass (`soa_freeze` + `soa_internal_force` on the f64 problem) fused into
one kernel:
  * Kuhn lattices: B5 (`struct_kernels.struct_resid`) between the f64
    pair-cache gather and the f64 pair-row scatter;
  * unstructured meshes: B9 (`elem_kernels.elem_resid`) between the f64
    conn gather and the f64 valence-bucket scatter (`soa_scatter`).
Both agree with the plain f64 pass to rounding (~1e-15 relative), not to
the double-word pass's ~1e-13. The reference routes its unstructured
variant nowhere (its double-word form measured slower than the f64 pass on
the TPU); here it computes the same function in f64 and is routed.
"""

from __future__ import annotations

import torch

from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.ops.soa import soa_scatter


def resid_df_supported(p, material) -> bool:
    """True where the fused residual applies: a registered isotropic
    material on a Kuhn lattice whose (q, npe, T) B5 is built for, or on an
    unstructured mesh whose (q, npe) B9 is built for."""
    if material.kind not in (0, 1, 2):
        return False
    tb = p.tables
    if tb is not None:
        return (tb.q, tb.npe, tb.T) in sk.SUPPORTED
    return p.structure is None and tuple(p.gradN.shape[:2]) in ek.SUPPORTED


def soa_internal_force_df(p64, material, u_T64: torch.Tensor) -> torch.Tensor:
    """f_int [3, N] f64 from u_T64 [3, N] f64 on the f64 SoAProblem `p64`."""
    if not resid_df_supported(p64, material):
        raise NotImplementedError(
            "the fused residual takes the registered materials on the kernels' elements")
    if u_T64.dtype != torch.float64 or p64.dtype != torch.float64:
        raise TypeError("the fused residual takes an f64 problem and f64 u")
    if p64.structure is None:
        q, npe, gradN, detJxW = ek.flat_tables(p64)
        fe = ek.elem_resid(ek._gather_flat(p64, u_T64), gradN, detJxW, material, npe=npe, q=q)
        return soa_scatter(p64, fe.view(3, npe, -1))
    tb = p64.tables
    cache = sk.gather_cache(p64.structure, tb.pairs, u_T64)
    return sk.scatter_pairs(p64.structure, tb.pairs, sk.struct_resid(tb, cache, material), 3)
