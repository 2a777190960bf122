"""The f64 residual of the mixed path as one kernel pass on Kuhn lattices
(counterpart of the structured part of `fea_large_tpu/ops/pallas_residual.py`).

The reference runs this pass in double-word f32 arithmetic because Pallas
on the TPU is f32-only. Hopper has native f64, so here it is the plain f64
pass (`soa_freeze` + `soa_internal_force` on the f64 problem) fused into
one kernel, B5 (`struct_kernels.struct_resid`): f64 pair-cache gather,
the kernel, f64 pair-row scatter. It agrees with the plain f64 pass to
rounding (~1e-15 relative), not to the double-word pass's ~1e-13.
"""

from __future__ import annotations

import torch

from fea_large_tpu_torch.ops import struct_kernels as sk


def resid_df_supported(p, material) -> bool:
    """True where the fused residual applies: a Kuhn lattice whose
    (q, npe, T) the kernel is built for, with a registered isotropic
    material. The reference's `struct_resid_supported` and
    `resid_df_supported` are this one test: its unstructured residual
    kernel (B9) is routed nowhere."""
    tb = p.tables
    return (
        tb is not None and (tb.q, tb.npe, tb.T) in sk.SUPPORTED
        and material.kind in (0, 1, 2)
    )


def soa_internal_force_df(p64, material, u_T64: torch.Tensor) -> torch.Tensor:
    """f_int [3, N] f64 from u_T64 [3, N] f64 on the f64 SoAProblem `p64`
    of a Kuhn lattice."""
    if not resid_df_supported(p64, material):
        raise NotImplementedError("the fused residual runs on Kuhn lattices only")
    if u_T64.dtype != torch.float64 or p64.dtype != torch.float64:
        raise TypeError("the fused residual takes an f64 problem and f64 u")
    tb = p64.tables
    cache = sk.gather_cache(p64.structure, tb.pairs, u_T64)
    return sk.scatter_pairs(p64.structure, tb.pairs, sk.struct_resid(tb, cache, material), 3)
