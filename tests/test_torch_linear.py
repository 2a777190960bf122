"""PyTorch port: PCG, its chunked driver and block-Jacobi against the JAX
reference (`fea_large_tpu/solvers/linear.py`), in f64 on small SPD block
systems. Iterates agree to 1e-12 relative: the two frameworks differ only
in the summation order of the dot products, and the systems are well
conditioned (A = B B^T + n I)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.solvers import linear as ref_linear
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions
from fea_large_tpu.solvers.newton import newton_lin_tol as ref_newton_lin_tol

from fea_large_tpu_torch.solvers import linear
from fea_large_tpu_torch.solvers.newton import SolverOptions, newton_lin_tol

torch.set_num_threads(2)

RTOL = 1e-12


def _system(seed=11, n_nodes=40):
    rng = np.random.default_rng(seed)
    n = 3 * n_nodes
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    b = rng.standard_normal((n_nodes, 3))
    free = np.ones((n_nodes, 3))
    free[:4] = 0.0
    free[7, 1] = 0.0
    return A, b * free, free


def _both(A, free):
    """(ref matvec, ref precond, port matvec, port precond) of the masked
    system M A M + (I - M) with block-Jacobi from A's diagonal blocks."""
    N = free.shape[0]
    Am = A * free.reshape(-1)[:, None] * free.reshape(-1)[None, :]
    Am = Am + np.diag(1.0 - free.reshape(-1))
    diag = np.stack([Am[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(N)])
    r_inv = ref_linear.jacobi_inverse_blocks(jnp.asarray(diag), jnp.asarray(free))
    p_inv = linear.jacobi_inverse_blocks(torch.tensor(diag), torch.tensor(free))
    rA, pA = jnp.asarray(Am), torch.tensor(Am)
    return (
        lambda v: (rA @ v.reshape(-1)).reshape(N, 3),
        lambda r: ref_linear.apply_block_jacobi(r_inv, jnp.asarray(free), r),
        lambda v: (pA @ v.reshape(-1)).reshape(N, 3),
        lambda r: linear.apply_block_jacobi(p_inv, torch.tensor(free), r),
    )


def test_jacobi_blocks_match_reference():
    rng = np.random.default_rng(2)
    B = rng.standard_normal((30, 3, 3))
    diag = np.einsum("nij,nkj->nik", B, B) + 3 * np.eye(3)
    free = (rng.random((30, 3)) > 0.3).astype(np.float64)
    ref = np.asarray(ref_linear.jacobi_inverse_blocks(jnp.asarray(diag), jnp.asarray(free)))
    port = linear.jacobi_inverse_blocks(torch.tensor(diag), torch.tensor(free))
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())
    r = rng.standard_normal((30, 3))
    np.testing.assert_allclose(
        linear.apply_block_jacobi(port, torch.tensor(free), torch.tensor(r)).numpy(),
        np.asarray(ref_linear.apply_block_jacobi(jnp.asarray(ref), jnp.asarray(free), jnp.asarray(r))),
        rtol=RTOL, atol=RTOL,
    )


def test_pcg_chunks_match_reference_iterates():
    A, b, free = _system()
    rmv, rpc, pmv, ppc = _both(A, free)
    rst = ref_linear.pcg_init(rmv, jnp.asarray(b), preconditioner=rpc, tol=1e-11)
    pst = linear.pcg_init(pmv, torch.tensor(b), preconditioner=ppc, tol=1e-11)
    assert math.isclose(pst.stop, float(rst.stop), rel_tol=RTOL)
    for _ in range(20):
        rst = ref_linear.pcg_chunk(rmv, rst, preconditioner=rpc, maxiter=4)
        pst = linear.pcg_chunk(pmv, pst, preconditioner=ppc, maxiter=4)
        assert pst.k == int(rst.k) and pst.ok == bool(rst.ok)
        x_ref = np.asarray(rst.x)
        np.testing.assert_allclose(pst.x.numpy(), x_ref, rtol=RTOL, atol=RTOL * np.abs(x_ref).max())
        if math.sqrt(pst.rr) <= pst.stop:
            break
    assert math.sqrt(pst.rr) <= pst.stop and 4 < pst.k < 80
    np.testing.assert_allclose(
        pst.x.numpy().reshape(-1),
        np.linalg.solve(A * free.reshape(-1)[:, None] * free.reshape(-1) + np.diag(1 - free.reshape(-1)),
                        b.reshape(-1)),
        rtol=1e-9, atol=1e-9,
    )


def test_drive_chunked_pcg_matches_reference():
    A, b, free = _system(seed=4)
    rmv, rpc, pmv, ppc = _both(A, free)
    tol = 1e-10

    ref = ref_linear.drive_chunked_pcg(
        lambda x0: ref_linear.pcg_init(rmv, jnp.asarray(b), preconditioner=rpc, x0=x0, tol=tol),
        lambda st, n: ref_linear.pcg_chunk(rmv, st, preconditioner=rpc, maxiter=n),
        tol=tol, chunk_iters=5, maxiter=500,
    )
    port = linear.drive_chunked_pcg(
        lambda x0: linear.pcg_init(pmv, torch.tensor(b), preconditioner=ppc, x0=x0, tol=tol),
        lambda st, n: linear.pcg_chunk(pmv, st, preconditioner=ppc, maxiter=n),
        tol=tol, chunk_iters=5, maxiter=500,
    )
    assert port[1] == int(ref[1]) and port[2] == bool(ref[2])
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(ref[0])).max())
    assert math.isclose(port[3], float(ref[3]), rel_tol=1e-6)


def test_pcg_negative_selfdot_clamped():
    """Analogue of the reference's test: a dot product that rounds a
    self-dot to a tiny NEGATIVE value near the recurrence floor must not
    turn sqrt(r.r) into NaN; the clamped floor noise reads as exact zero,
    so the solve reports convergence."""
    A, b, _ = _system(seed=9)
    N = b.shape[0]
    At = torch.tensor(A)
    noise = 1e-20  # sign noise above the requested stop^2

    def noisy_dot(a, c):
        return torch.dot(a.reshape(-1), c.reshape(-1)) - noise

    def mv(v):
        return (At @ v.reshape(-1)).reshape(N, 3)

    st = linear.pcg_init(mv, torch.tensor(b), tol=1e-14, dot=noisy_dot)
    st = linear.pcg_chunk(mv, st, dot=noisy_dot, maxiter=2000)
    assert math.isfinite(st.rr)
    assert st.ok and math.sqrt(st.rr) <= st.stop  # clamped floor noise => exact-zero rr
    np.testing.assert_allclose(st.x.numpy().reshape(-1), np.linalg.solve(A, b.reshape(-1)),
                               rtol=1e-8, atol=1e-8)


def test_pcg_breakdown_guard_matches_reference():
    """An indefinite operator breaks CG down (p.Kp <= 0): both packages stop
    at the same iteration with ok False."""
    n_nodes = 6
    d = np.linspace(1.0, 2.0, 3 * n_nodes)
    d[5] = -3.0
    b = np.ones((n_nodes, 3))
    rst = ref_linear.pcg_chunk(
        lambda v: (jnp.asarray(d) * v.reshape(-1)).reshape(n_nodes, 3),
        ref_linear.pcg_init(lambda v: v, jnp.asarray(b), tol=1e-12), maxiter=100,
    )
    pst = linear.pcg_chunk(
        lambda v: (torch.tensor(d) * v.reshape(-1)).reshape(n_nodes, 3),
        linear.pcg_init(lambda v: v, torch.tensor(b), tol=1e-12), maxiter=100,
    )
    assert not pst.ok and not bool(rst.ok)
    assert pst.k == int(rst.k)


@pytest.mark.parametrize("forcing,eta_min", [("ew", 1e-2), ("ew", 0.0), ("fixed", 0.0)])
def test_newton_lin_tol_matches_reference(forcing, eta_min):
    kw = dict(forcing=forcing, ew_eta_min=eta_min, precision="mixed", newton_rtol=1e-6,
              pcg_tol=1e-6)
    ref_opts, opts = RefOptions(**kw), SolverOptions(**kw)
    norms = [1.4e-2, 3.1e-3, 2.2e-4, 1.9e-6, 4.0e-9]
    eta_r = eta_p = 0.5
    for it in range(len(norms)):
        tol_r, eta_r = ref_newton_lin_tol(ref_opts, it, norms[: it + 1], norms[0], eta_r)
        tol_p, eta_p = newton_lin_tol(opts, it, norms[: it + 1], norms[0], eta_p)
        assert (tol_p, eta_p) == (tol_r, eta_r)


@pytest.mark.parametrize("forcing,pcg_tol", [("ew", 1e-8), ("fixed", 1e-13)])
def test_newton_lin_tol_f64_floor_matches_reference(forcing, pcg_tol):
    """The f64 path floors the PCG tolerance at 100 eps64 ||R0|| / ||R||
    (at most 0.1), not at the mixed path's 1.2e-6."""
    kw = dict(forcing=forcing, ew_eta_min=1e-2, precision="f64", newton_rtol=1e-10,
              pcg_tol=pcg_tol)
    ref_opts, opts = RefOptions(**kw), SolverOptions(**kw)
    norms = [1.4e-2, 3.1e-3, 2.2e-4, 1.9e-6, 4.0e-9, 3.0e-13]
    eta_r = eta_p = 0.5
    for it in range(len(norms)):
        tol_r, eta_r = ref_newton_lin_tol(ref_opts, it, norms[: it + 1], norms[0], eta_r)
        tol_p, eta_p = newton_lin_tol(opts, it, norms[: it + 1], norms[0], eta_p)
        assert (tol_p, eta_p) == (float(tol_r), float(eta_r))
    if forcing == "fixed":
        assert newton_lin_tol(opts, 0, norms[:1], norms[0], 0.5)[0] == pcg_tol


def test_pcg_and_block_jacobi_preconditioner_match_reference():
    A, b, free = _system(seed=5)
    N = free.shape[0]
    Am = A * free.reshape(-1)[:, None] * free.reshape(-1)[None, :] + np.diag(1.0 - free.reshape(-1))
    diag = np.stack([A[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(N)])
    rA, pA = jnp.asarray(Am), torch.tensor(Am)
    rpc = ref_linear.block_jacobi_preconditioner(jnp.asarray(diag), jnp.asarray(free))
    ppc = linear.block_jacobi_preconditioner(torch.tensor(diag), torch.tensor(free))
    ref = ref_linear.pcg(lambda v: (rA @ v.reshape(-1)).reshape(N, 3), jnp.asarray(b),
                         preconditioner=rpc, tol=1e-11, maxiter=200)
    port = linear.pcg(lambda v: (pA @ v.reshape(-1)).reshape(N, 3), torch.tensor(b),
                      preconditioner=ppc, tol=1e-11, maxiter=200)
    assert port.iterations == int(ref.iterations) and port.converged == bool(ref.converged)
    assert port.converged and math.isclose(port.residual_norm, float(ref.residual_norm),
                                           rel_tol=1e-6)
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(port.x.numpy(), x_ref, rtol=RTOL, atol=RTOL * np.abs(x_ref).max())
    short = linear.pcg(lambda v: (pA @ v.reshape(-1)).reshape(N, 3), torch.tensor(b),
                       preconditioner=ppc, tol=1e-11, maxiter=3)
    assert short.iterations == 3 and not short.converged
