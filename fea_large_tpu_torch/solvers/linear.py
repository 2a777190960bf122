"""Preconditioned conjugate gradients and block-Jacobi (counterpart of
`fea_large_tpu/solvers/linear.py`, mixed-path parts).

PCG runs as a host loop over device tensors, resumable across chunks
(`PCGState`). The vector arithmetic stays on the device; the loop fetches
(p.q, r.r) once per iteration to test the stop and breakdown conditions.
Self-dots are clamped at zero at the source (r.r, r.z and ||b|| are
non-negative by mathematics; a rounded negative would turn sqrt into NaN).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fea_large_tpu_torch.ops.smallmat import inv3


def jacobi_inverse_blocks(diag_blocks: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """Inverted nodal 3x3 diagonal blocks [N, 3, 3]. Rows and columns of
    prescribed DOFs are replaced by the identity before the inversion, so
    the preconditioner acts as the identity there."""
    outer = free_mask[:, :, None] * free_mask[:, None, :]
    eye = torch.eye(3, dtype=diag_blocks.dtype, device=diag_blocks.device)
    return inv3(diag_blocks * outer + (eye - eye * outer))


def apply_block_jacobi(inv_blocks, free_mask, r):
    """z_n = M (B_n^-1 (M r)_n) for r [N, 3]."""
    return (inv_blocks * (r * free_mask)[:, None, :]).sum(-1) * free_mask


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass
class PCGState:
    """Exact CG state, resumable across chunks. Vectors and rz are device
    tensors; rr, k, ok and stop are host values read by the control loop."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor  # 0-d, clamped r.z
    rr: float  # clamped r.r
    k: int  # iterations so far
    ok: bool  # no breakdown
    stop: float  # max(tol * ||b||, atol)


def pcg_init(matvec, b, preconditioner=None, x0=None, tol=1e-10, atol=0.0,
             dot=None) -> PCGState:
    preconditioner = preconditioner or (lambda r: r)
    dot = dot or _dot
    b_norm = math.sqrt(max(float(dot(b, b)), 0.0))
    stop = max(tol * b_norm, atol)
    if x0 is None:
        # from-zero start: r0 = b exactly, no matvec of zeros
        x0, r0 = torch.zeros_like(b), b
    else:
        r0 = b - matvec(x0)
    z0 = preconditioner(r0)
    return PCGState(
        x=x0, r=r0, z=z0, p=z0, rz=torch.clamp(dot(r0, z0), min=0.0),
        rr=max(float(dot(r0, r0)), 0.0), k=0, ok=True, stop=stop,
    )


def pcg_chunk(matvec, state: PCGState, preconditioner=None, dot=None,
              maxiter=100) -> PCGState:
    """Up to `maxiter` further CG iterations (stops early on convergence or
    breakdown); an exact continuation of the Krylov recurrence."""
    preconditioner = preconditioner or (lambda r: r)
    dot = dot or _dot
    s = dataclasses.replace(state)
    k_end = s.k + maxiter
    while s.ok and s.k < k_end and math.sqrt(s.rr) > s.stop and math.isfinite(s.rr):
        q = matvec(s.p)
        pq = dot(s.p, q)
        pos = pq > 0.0  # breakdown guard: K must be SPD
        alpha = torch.where(pos, s.rz / pq, torch.zeros_like(pq)).to(s.p.dtype)
        x = s.x + alpha * s.p
        r = s.r - alpha * q
        z = preconditioner(r)
        rz_new = torch.clamp(dot(r, z), min=0.0)
        rr_new = torch.clamp(dot(r, r), min=0.0)
        beta = torch.where(s.rz != 0.0, rz_new / s.rz, torch.zeros_like(rz_new)).to(s.p.dtype)
        p = z + beta * s.p
        pos_h, rr_h = torch.stack([pos.to(rr_new.dtype), rr_new]).tolist()
        s = PCGState(x, r, z, p, rz_new, rr_h, s.k + 1, s.ok and pos_h > 0.0, s.stop)
    # a non-finite rr (overflow from a near-breakdown alpha) ends the loop
    # with ok still set: report it as a breakdown
    s.ok = s.ok and math.isfinite(s.rr)
    return s


def drive_chunked_pcg(prepare, chunk, *, tol, chunk_iters, maxiter):
    """Chunked PCG control loop (the reference's `drive_chunked_pcg`).

    `prepare(x0)` (re)builds the Krylov state (x0=None: from zero);
    `chunk(st, n)` runs up to n further iterations.
      * up to 2 restarts on a rounding-level breakdown (rel <= 1e-2): the
        state is rebuilt from the best iterate with a fresh residual;
        an early breakdown at rel ~O(1) means an indefinite operator and
        is the caller's load-step-bisection case;
      * best-iterate tracking at chunk boundaries: the best iterate is
        returned when the final one is worse (NaN-safe).
    Returns (x, total_iters, converged, rel)."""
    st = prepare(None)
    done_iters = 0
    restarts = 0
    bnorm = None
    best = None
    while True:
        if bnorm is None:  # pcg_init: stop = tol * ||b||
            bnorm = st.stop / tol
        k = done_iters + st.k
        rnorm = math.sqrt(st.rr)
        rel = rnorm / max(bnorm, 1e-300)
        if best is None or rel < best[0]:
            best = (rel, st.x)
        if (st.ok and rnorm <= st.stop) or k >= maxiter:
            break
        if not st.ok:
            if restarts >= 2 or rel > 1e-2:
                break
            restarts += 1
            done_iters = k
            st = prepare(best[1])
            continue
        st = chunk(st, min(chunk_iters, maxiter - k))
    converged = st.ok and rnorm <= st.stop
    total = done_iters + st.k
    x = st.x
    if best is not None and not (rel <= best[0]):
        rel, x = best
    return x, total, converged, rel

