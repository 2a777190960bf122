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

`resid_df_route` is the one rule that picks the fused pass or the plain
one, and `internal_force64` the one f64 internal force on the [3, N]
layout: `NewtonSolver` (solvers/newton.py) and the sharded ranks
(dist/sharded.py) both go through them.
"""

from __future__ import annotations

import torch

from fea_large_tpu_torch.ops import elem_kernels as ek
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.ops.soa import soa_freeze, soa_internal_force, soa_scatter


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


def resid_df_route(p64, material, options, device: torch.device) -> bool:
    """Whether the f64 residual on `p64` takes the fused kernel: only on
    the mixed path (the f64 parity path keeps the plain pass; `NewtonSolver`
    asks only on the mixed path, the sharded solvers on both) and where
    `resid_df_supported`; then `options.resid_df` None = on where `device`
    is CUDA, True / False as given."""
    if options.precision != "mixed" or not resid_df_supported(p64, material):
        return False
    if options.resid_df is None:
        return device.type == "cuda"
    return bool(options.resid_df)


def internal_force64(p64, material, u_T64: torch.Tensor, *, fused: bool) -> torch.Tensor:
    """f_int [3, N] f64 from u_T64 [3, N] f64 on the f64 SoAProblem `p64`:
    the fused residual kernel where `fused` (`resid_df_route`), else the
    plain f64 freeze and force. The sharded ranks' `_residual64` holds the
    route as a value and passes it; `NewtonSolver` picks between its two
    named residuals once (`_residual_df_fn`, `_residual_soa_fn`), each of
    which calls this with its branch fixed."""
    if fused:
        return soa_internal_force_df(p64, material, u_T64)
    return soa_internal_force(p64, soa_freeze(p64, material, u_T64))
