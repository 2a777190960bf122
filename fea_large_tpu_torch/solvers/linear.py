"""Dense Cholesky, preconditioned conjugate gradients and block-Jacobi
(counterpart of `fea_large_tpu/solvers/linear.py`).

Two forms of PCG:
  * `PCGState`, `pcg_init`, `pcg_chunk`: a host loop over device tensors,
    resumable across chunks. The vector arithmetic stays on the device; the
    loop fetches (p.q, r.r) once per iteration and tests the stop and
    breakdown conditions in Python f64. The host Newton loop, the f64
    paths and the sharded solvers run it.
  * `DevicePCG`, `device_pcg_init`, `device_pcg_step`: every scalar of the
    recurrence, the stop test and the flags in 0-d device tensors, updated
    in place, so that an iteration can be captured in a CUDA graph and
    replayed under an IF node on `active` (solvers/device_loop.py). The
    stop test runs on the device in the vectors' dtype, as the reference's
    `pcg_chunk` while-loop condition does.
Self-dots are clamped at zero at the source (r.r, r.z and ||b|| are
non-negative by mathematics; a rounded negative would turn sqrt into NaN).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fea_large_tpu_torch.ops.smallmat import inv3


def dense_cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD system A x = b ([n, n], [n]) by Cholesky, in A's dtype:
    the direct path's solve, `cho_factor` and `cho_solve` in the reference.
    Where A is not positive definite x is all NaN, as the reference's
    factor is (a NaN Newton residual then bisects the load step), with no
    host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L).squeeze(1)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


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


def apply_block_jacobi_T(inv_blocks, free_T, r_T):
    """`apply_block_jacobi` on component-first vectors: r_T, free_T
    [3, N], inv_blocks [N, 3, 3] -> [3, N]."""
    return torch.einsum("nij,jn->in", inv_blocks, r_T * free_T) * free_T


def block_jacobi_preconditioner(diag_blocks: torch.Tensor, free_mask: torch.Tensor):
    """The block-Jacobi apply r -> z (see `jacobi_inverse_blocks`)."""
    inv_blocks = jacobi_inverse_blocks(diag_blocks, free_mask)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return apply_block_jacobi(inv_blocks, free_mask, r)

    return apply


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass
class PCGResult:
    x: torch.Tensor  # solution [N, 3]
    iterations: int
    residual_norm: float  # final ||r|| of the recurrence
    converged: bool


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


def pcg(matvec, b, preconditioner=None, x0=None, tol=1e-10, atol=0.0, maxiter=1000,
        dot=None) -> PCGResult:
    """Preconditioned CG: `pcg_init`, then up to `maxiter` iterations.
    `matvec` is the masked operator (identity on prescribed DOFs) and `b`
    masked, so the iterates stay in the free subspace. Stops at ||r|| <=
    max(tol ||b||, atol), or on the breakdown p.Kp <= 0."""
    state = pcg_init(matvec, b, preconditioner, x0=x0, tol=tol, atol=atol, dot=dot)
    state = pcg_chunk(matvec, state, preconditioner, dot=dot, maxiter=maxiter)
    r_norm = math.sqrt(state.rr)
    return PCGResult(x=state.x, iterations=state.k, residual_norm=r_norm,
                     converged=state.ok and r_norm <= state.stop)


@dataclasses.dataclass
class DevicePCG:
    """CG state of the device-resident Newton loop: vectors [N, 3] and 0-d
    tensors, all on one device, written in place by `device_pcg_init` and
    `device_pcg_step` (the addresses a captured graph reads stay fixed).

    rz, rr   clamped r.z and r.r            bnorm   clamped ||b||
    stop     max(tol ||b||, 0)               k, cap  iterations, their cap
    ok       no breakdown (p.Kp > 0)         active  the loop condition"""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    bnorm: torch.Tensor
    stop: torch.Tensor
    k: torch.Tensor
    cap: torch.Tensor
    ok: torch.Tensor
    active: torch.Tensor

    @staticmethod
    def zeros(shape, dtype, device) -> "DevicePCG":
        def vec():
            return torch.zeros(shape, dtype=dtype, device=device)

        def scalar(dt=dtype):
            return torch.zeros((), dtype=dt, device=device)

        return DevicePCG(x=vec(), r=vec(), z=vec(), p=vec(), rz=scalar(), rr=scalar(),
                         bnorm=scalar(), stop=scalar(), k=scalar(torch.int64),
                         cap=scalar(torch.int64), ok=scalar(torch.bool),
                         active=scalar(torch.bool))


def _set_active(s: DevicePCG) -> None:
    """The reference's `pcg_chunk` loop condition: no breakdown, under the
    cap, ||r|| above the stop and r.r finite, all on the device."""
    s.active.copy_(s.ok & (s.k < s.cap) & (torch.sqrt(s.rr) > s.stop) & torch.isfinite(s.rr))


def device_pcg_init(s: DevicePCG, b, preconditioner, tol, cap) -> None:
    """`pcg_init` from x0 = 0 into `s`: r0 = b, z0 = p0 = M^-1 b, with the
    stop max(tol ||b||, 0) in b's dtype; `tol` and `cap` are 0-d tensors
    (the forcing term and the iteration cap of this solve)."""
    s.x.zero_()
    s.r.copy_(b)
    s.z.copy_(preconditioner(b))
    s.p.copy_(s.z)
    s.rz.copy_(torch.clamp_min(_dot(s.r, s.z), 0.0))
    rr = torch.clamp_min(_dot(b, b), 0.0)
    s.rr.copy_(rr)
    s.bnorm.copy_(torch.sqrt(rr))
    s.stop.copy_(torch.clamp_min(tol * s.bnorm, 0.0))
    s.k.zero_()
    s.cap.copy_(cap)
    s.ok.fill_(True)
    _set_active(s)


def device_pcg_step(s: DevicePCG, matvec, preconditioner) -> None:
    """One CG iteration of `pcg_chunk`'s body on `s`, in place, then the
    loop condition for the next. The caller runs it only while `s.active`
    (an IF node in a graph, a Python `if` on the CPU)."""
    q = matvec(s.p)
    pq = _dot(s.p, q)
    pos = pq > 0.0  # breakdown guard: K must be SPD
    alpha = torch.where(pos, s.rz / pq, torch.zeros_like(pq))
    s.x.add_(alpha * s.p)
    s.r.sub_(alpha * q)
    s.z.copy_(preconditioner(s.r))
    rz_new = torch.clamp_min(_dot(s.r, s.z), 0.0)
    beta = torch.where(s.rz != 0.0, rz_new / s.rz, torch.zeros_like(rz_new))
    s.p.mul_(beta).add_(s.z)
    s.rz.copy_(rz_new)
    s.rr.copy_(torch.clamp_min(_dot(s.r, s.r), 0.0))
    s.k.add_(1)
    s.ok.logical_and_(pos)
    _set_active(s)


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

