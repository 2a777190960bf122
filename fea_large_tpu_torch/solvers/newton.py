"""Newton driver with incremental load stepping (counterpart of
`fea_large_tpu/solvers/newton.py`): the host-loop mixed-precision path and
the three f64 paths (assembled BCSR, matrix-free, dense direct).

Mixed precision (`precision="mixed"`, `linear="pcg"`), per Newton
iteration:
  * the residual R = M (scale f_ext - f_int(u)): in f64, or, while
    ||R|| > 3e-2 ||R0|| under Eisenstat-Walker forcing, in f32 from the
    frozen tangent state (the `resid32` gate); the converging iterations
    always use f64. The f64 pass is the fused residual kernel, B5 on Kuhn
    lattices and B9 on unstructured meshes, when `resid_df` routes it
    (`_residual_df_fn`), else the plain f64 element pass
    (`_residual_soa_fn`);
  * the f32 tangent state (freeze), the block-Jacobi blocks (diag), and a
    PCG solve of the masked f32 tangent system (tangent action),
    preconditioned by block-Jacobi plus the optional two- or three-level
    coarse correction (solvers/multilevel.py). On the card the f32 freeze,
    tangent action and force are the lattice kernels on Kuhn lattices and
    the element-block kernels (ops/elem_kernels.py) on unstructured
    meshes;
  * the forcing term (Eisenstat-Walker choice 2 with the lower cap
    `ew_eta_min`, the termination safeguard and the f32 floor).
Two loops run it. `device_loop=True` (the default, the reference's
`_mixed_solve_fn`): the whole increment on the device
(solvers/device_loop.py), the forcing by `device_forcing` and the CG stop
test in f32 on the device; on the card, CUDA graphs captured once per
solver and replayed, the host reading flags only. It hands a solve that
runs out of its CG budget (`device_loop_budget`) or breaks down to the
host loop, which continues the same Newton sequence. The host loop
(`device_loop=False`, `NewtonSolver._newton_mixed_host`): the forcing by
`newton_lin_tol`, chunked PCG with its stop test in Python f64 and
rounding-breakdown restarts; a solve with a coarse correction that breaks
down is retried with block-Jacobi alone.

f64 (`precision="f64"`), per Newton iteration (`NewtonSolver._newton`):
the f64 residual of the element pass (`_residual_fn`), then one step
(`_step`) on the masked system:
  * `linear="pcg_bcsr"` (config 2 of the reference): the element stiffness
    assembled into BCSR (assembly/bcsr.py) and block-Jacobi PCG with one
    restart from the final iterate (`_pcg_with_restart`), whose product is
    the BCSR kernel B10 on the card (ops/bcsr_kernels.py);
  * `linear="pcg"` (matrix-free, bench.py's FEA_BENCH_PRECISION=f64): the
    frozen tangent state, the scattered element diagonal blocks and the
    same PCG on the tangent action (assembly/matfree.py), plain PyTorch;
  * `linear="direct"` (config 1): the dense K (assembly/dense.py) and a
    Cholesky solve; one "iteration" per step, no forcing term.
The matrix-free and direct routes are plain PyTorch: the reference runs
them as XLA-fused einsums and `cho_solve`, outside any Pallas kernel.

One step alone (`_step`, bench.py's FEA_BENCH_MODE=step; `step_fn`, the
step of entry.py): on the f64 routes the step above; on the
mixed path (`_step_mixed`) the plain f64 residual, the f32 freeze,
block-Jacobi plus the coarse correction and chunked f32 PCG
(`drive_chunked_pcg`), with no fallback to block-Jacobi alone, as the
reference's step.

`solve` steps the load factor to 1 with bisection on Newton failure.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.dense import assemble_dense, mask_dense_system
from fea_large_tpu_torch.assembly.matfree import make_operator
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements.kernels import element_internal_force, precompute_geometry
from fea_large_tpu_torch.ops.residual import resid_df_supported, soa_internal_force_df
from fea_large_tpu_torch.ops.soa import (
    SoAProblem,
    soa_apply_tangent,
    soa_diag_blocks,
    soa_freeze,
    soa_internal_force,
)
from fea_large_tpu_torch.solvers.linear import (
    PCGResult,
    apply_block_jacobi,
    block_jacobi_preconditioner,
    dense_cholesky_solve,
    drive_chunked_pcg,
    jacobi_inverse_blocks,
    pcg,
    pcg_chunk,
    pcg_init,
)
from fea_large_tpu_torch.solvers.multilevel import (
    build_coarse_space,
    build_multilevel_space,
    two_level_preconditioner,
)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver configuration: the reference's fields and defaults. The port
    runs four routes; `NewtonSolver` raises ValueError on any other
    combination:
      * linear="pcg", precision="mixed", preconditioner "jacobi",
        "two_level" (coarse_modes 3, 6 or 12; any other value is a
        ValueError, as in the reference) or "three_level" (aggregates of
        agg_size or 16 nodes); any other name is block-Jacobi, as in the
        reference. device_loop=True runs each increment on the device
        loop, which hands over to the host loop after `device_loop_budget`
        CG iterations in all (None: max(50, min(1000, 2.3e8 / elements)),
        the reference's rule) or on a CG breakdown; device_loop=False runs
        the host loop alone;
      * precision="f64" with linear="pcg_bcsr" (assembled BCSR),
        linear="pcg" (matrix-free) or linear="direct" (dense Cholesky).
        Block-Jacobi on the PCG routes; the mixed-path fields
        preconditioner, coarse_modes, agg_size, device_loop,
        device_loop_budget and resid_df have no effect there, as in the
        reference.

    pallas    accepted for parity with the reference, and without effect:
              there it picks the Pallas element-block passes over the XLA
              ones; here the f32 passes of every mesh run their kernels on
              the card (ops/soa.py), and plain PyTorch only on the CPU
    resid_df  the mixed path's f64 residual through the fused kernel, B5
              on Kuhn lattices and B9 on unstructured meshes: None = on
              for CUDA tensors where supported, True = on where supported
              (the plain version on CPU tensors), False = off. Both compute
              in f64, so the reference's margin-guarded f64 confirmation
              (and its `_DF_ERR_REL`) has nothing to guard and is not
              ported. The reference routes its unstructured kernel
              nowhere; here it is routed like B5."""

    linear: str = "pcg"
    n_steps: int = 1
    newton_rtol: float = 1e-10
    newton_atol: float = 1e-12
    max_newton: int = 30
    pcg_tol: float = 1e-12
    pcg_maxiter: int = 5000
    pcg_chunk: int = 250
    max_bisections: int = 5
    preconditioner: str = "jacobi"
    agg_size: int | None = None
    coarse_modes: int = 3
    forcing: str = "fixed"
    ew_eta_min: float = 0.0
    pallas: bool = False
    device_loop: bool = True
    device_loop_budget: int | None = None
    resid_df: bool | None = None
    precision: str = "f64"


@dataclasses.dataclass
class IncrementRecord:
    """Convergence record of one load increment."""

    load_factor: float
    newton_iters: int
    residual_norms: list
    pcg_iters: list
    wall_time: float


@dataclasses.dataclass
class SolveResult:
    u: torch.Tensor  # [N, 3] f64
    converged: bool
    history: list  # list[IncrementRecord]

    @property
    def total_newton_iters(self) -> int:
        return sum(h.newton_iters for h in self.history)


def _check_options(opts: SolverOptions) -> None:
    """Raise ValueError on options no route runs: where the reference
    raises, and on a `precision` other than "f64" and "mixed" (the
    reference runs its f64 route for any other string)."""
    if opts.linear not in ("direct", "pcg", "pcg_bcsr"):
        raise ValueError(f"unknown linear solver {opts.linear!r}")
    if opts.precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed', got {opts.precision!r}")
    if opts.pallas and opts.precision != "mixed":
        raise ValueError("pallas=True requires precision='mixed'")
    if opts.precision == "f64":
        return
    if opts.linear != "pcg":
        raise ValueError("precision='mixed' requires linear='pcg'")
    if opts.preconditioner == "two_level" and opts.coarse_modes not in (3, 6, 12):
        raise ValueError(f"coarse modes must be 3, 6 or 12, got {opts.coarse_modes}")


def newton_lin_tol(opts, it, norms, norm0, eta):
    """(lin_tol, eta') for Newton iteration `it`: Eisenstat-Walker choice-2
    forcing (gamma 0.9, alpha 2, safeguard) when opts.forcing == "ew", the
    lower cap `ew_eta_min`, the termination safeguard (never solve tighter
    than half the reduction the Newton stop still needs), then the
    precision floor: ~10 eps32 on the mixed path (its f32 system is
    rebuilt from the residual every step), 100 eps64 ||R0|| / ||R|| (at
    most 0.1) on the f64 path (its absolute rounding level is that of the
    first residual)."""
    lin_tol = opts.pcg_tol
    if opts.forcing == "ew":
        if it > 0:
            # squares as products: Python's ** goes through libm pow, which
            # misrounds about one square in a thousand; a product is
            # correctly rounded, as the device forcing's square is
            ratio = norms[-1] / norms[-2]
            cand = 0.9 * (ratio * ratio)
            safe = 0.9 * (eta * eta)
            eta = max(cand, safe) if safe > 0.1 else cand
        eta = max(eta, opts.ew_eta_min)
        stop_n = max(opts.newton_rtol * norm0, opts.newton_atol)
        eta = max(eta, 0.5 * stop_n / max(norms[-1], 1e-300))
        eta = min(max(eta, opts.pcg_tol), 0.5)
        lin_tol = eta
    if opts.precision == "mixed":
        floor = 1.2e-6
    else:
        floor = min(2.2e-14 * norm0 / norms[-1], 0.1)
    return max(lin_tol, floor), eta


def device_forcing(norm, prev_norm, eta_prev, first_it, pcg_tol, use_ew, floor,
                   stop_newton, eta_min=0.0):
    """`newton_lin_tol` on 0-d f64 tensors, for the device loop (the
    reference's `device_forcing`): the same operations in the same order,
    so bitwise the same (eta, lin_tol). `first_it` is a 0-d bool (it == 0:
    eta 0.5), `use_ew` a Python bool, `floor` the precision floor (1.2e-6
    on the mixed path), `stop_newton` the Newton stop target; `pcg_tol`
    and `eta_min` are floats. Without EW forcing eta is 0.5 and lin_tol
    max(pcg_tol, floor)."""
    if not use_ew:
        return torch.full_like(norm, 0.5), torch.clamp_min(torch.full_like(norm, pcg_tol), floor)
    ratio = norm / torch.clamp_min(prev_norm, 1e-300)
    cand = 0.9 * (ratio * ratio)
    safe = 0.9 * (eta_prev * eta_prev)
    eta = torch.where(safe > 0.1, torch.maximum(cand, safe), cand)
    eta = torch.where(first_it, torch.full_like(eta, 0.5), eta)
    eta = torch.clamp_min(eta, eta_min)
    eta = torch.maximum(eta, 0.5 * stop_newton / torch.clamp_min(norm, 1e-300))
    eta = torch.clamp(eta, pcg_tol, 0.5)
    return eta, torch.clamp_min(eta, floor)


def _residual_fn(u, scale, conn, geom, material, bc, f_ext, scatter):
    """f64 residual (r [N, 3], ||r||) from the f64 element pass of the
    assembled path."""
    r = bc.project(scale * f_ext - scatter(element_internal_force(u[conn], geom, material)))
    return r, torch.linalg.norm(r)


def _pcg_with_restart(matvec, r, precond, pcg_tol, pcg_maxiter) -> PCGResult:
    """PCG, then one unconditional restart from its final iterate with the
    remaining budget. A p.Kp <= 0 breakdown near stagnation can be
    rounding in the recurrence; the restart rebuilds it from the true
    residual. After a converged solve it costs one product and one
    preconditioner apply, and runs no iteration."""
    res = pcg(matvec, r, preconditioner=precond, tol=pcg_tol, maxiter=pcg_maxiter)
    res2 = pcg(matvec, r, preconditioner=precond, x0=res.x, tol=pcg_tol,
               maxiter=max(pcg_maxiter - res.iterations, 0))
    return PCGResult(x=res2.x, iterations=res.iterations + res2.iterations,
                     residual_norm=res2.residual_norm, converged=res2.converged)


def _step_direct_fn(u, scale, conn, geom, material, bc, f_ext, scatter, structure):
    """One f64 Newton step by the dense Cholesky solve of the masked
    system: (u + du, 1, True, 0.0), the PCG routes' tuple."""
    K, f_int = assemble_dense(u, conn, geom, material, structure, scatter)
    A, b = mask_dense_system(K, bc.project(scale * f_ext - f_int), bc.free_mask)
    return u + dense_cholesky_solve(A, b).reshape(u.shape), 1, True, 0.0


def _pcg_step(u, r, product, diag_blocks, bc, pcg_tol, pcg_maxiter):
    """(u + du, PCG iterations, converged, final relative PCG residual):
    block-Jacobi PCG with one restart on the masked system M K M + (I - M)
    du = r, given K v = product(v) and K's nodal diagonal blocks."""
    precond = block_jacobi_preconditioner(diag_blocks, bc.free_mask)

    def matvec(v):
        vm = bc.project(v)
        return bc.project(product(vm)) + (v - vm)

    res = _pcg_with_restart(matvec, r, precond, pcg_tol, pcg_maxiter)
    rel = res.residual_norm / max(float(torch.linalg.norm(r)), 1e-300)
    return u + res.x, res.iterations, res.converged, rel


def _step_matfree_fn(u, scale, conn, geom, material, bc, f_ext, scatter, pcg_tol, pcg_maxiter):
    """One f64 Newton step on the matrix-free tangent (`_pcg_step`)."""
    op = make_operator(u, conn, geom, material, scatter)
    r = bc.project(scale * f_ext - op.f_int)
    return _pcg_step(u, r, op.matvec, op.diag_blocks, bc, pcg_tol, pcg_maxiter)


def _step_bcsr_fn(u, scale, conn, geom, material, bc, f_ext, scatter, structure, pcg_tol,
                  pcg_maxiter):
    """One f64 Newton step on the assembled BCSR system (`_pcg_step`)."""
    K, f_int = assemble_bcsr(u, conn, geom, material, structure, scatter)
    r = bc.project(scale * f_ext - f_int)
    return _pcg_step(u, r, K.matvec, K.block_diagonal(), bc, pcg_tol, pcg_maxiter)


def _residual_soa_fn(u, scale, soa64, material, bc, f_ext):
    """f64 residual (r [N, 3], ||r||) from the f64 element pass."""
    state = soa_freeze(soa64, material, u.T.contiguous())
    f_int = soa_internal_force(soa64, state).T
    r = bc.project(scale * f_ext - f_int)
    return r, torch.linalg.norm(r)


def _residual_df_fn(u, scale, soa64, material, bc, f_ext):
    """f64 residual (r [N, 3], ||r||) from the fused residual kernel B5
    (ops/residual.py): the same pass as `_residual_soa_fn`, in one kernel."""
    f_int = soa_internal_force_df(soa64, material, u.T.contiguous()).T
    r = bc.project(scale * f_ext - f_int)
    return r, torch.linalg.norm(r)


def _to_f32(x: float) -> float:
    """x rounded to f32 (the mixed path's PCG tolerance, as the
    reference's f32 scalar)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _mixed_matvec(soa, state, free32_T, v):
    """Masked f32 tangent action M K M v + (I - M) v; v [N, 3]."""
    vm_T = (v.T * free32_T).contiguous()
    y_T = soa_apply_tangent(soa, state, vm_T) * free32_T
    return y_T.T + (v - vm_T.T)


def _mixed_precond(inv_blocks, free32, coarse):
    """Block-Jacobi, plus the coarse correction of `coarse` when given (a
    two-level `CoarseSpace` or a three-level `MultilevelSpace`) through
    `two_level_preconditioner`."""

    def jacobi(r):
        return apply_block_jacobi(inv_blocks, free32, r)

    if coarse is None:
        return jacobi
    return two_level_preconditioner(coarse, jacobi, free32)


class NewtonSolver:
    """Total-Lagrangian quasi-static solver for one mesh/material/BC setup
    on the mesh's device. The mixed path builds the f32 and f64 SoA
    element geometry and, for "two_level", the coarse space (host setup +
    device probing), for "three_level" the multilevel space (host Galerkin
    products + a device inverse); the f64 paths build their element
    geometry and node scatter at first use, and the BCSR structure where
    they sum into it (linear="pcg_bcsr" and "direct"; the matrix-free path
    has none)."""

    def __init__(self, mesh, material, bc, f_ext=None, options=None):
        self.options = options or SolverOptions()
        _check_options(self.options)
        self.mesh = mesh
        self.material = material
        self.bc = bc
        #: coarse-corrected -> block-Jacobi fallbacks taken on CG breakdown
        self.precond_fallbacks = 0
        self.f_ext = (
            torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device=mesh.device)
            if f_ext is None else f_ext
        )
        self._geom = None
        self._scatter = None
        self.bcsr = None
        self._resid_df = False
        self._coarse = None
        self._device_loop = None
        if self.options.precision == "f64":
            if self.options.linear in ("pcg_bcsr", "direct"):
                self.bcsr = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, mesh.device)
            return
        self._soa = SoAProblem.build(mesh, torch.float32)
        self._soa64 = SoAProblem.build(mesh, torch.float64, share_maps_from=self._soa)
        supported = resid_df_supported(self._soa64, material)
        if self.options.resid_df is None:
            self._resid_df = mesh.device.type == "cuda" and supported
        else:
            self._resid_df = bool(self.options.resid_df) and supported
        if self.options.preconditioner == "two_level":
            self._coarse = build_coarse_space(
                mesh, material, bc, agg_size=self.options.agg_size,
                modes=self.options.coarse_modes, soa=self._soa,
            )
        elif self.options.preconditioner == "three_level":
            self._coarse = build_multilevel_space(
                mesh, material, bc, agg_size1=self.options.agg_size or 16,
            )

    @property
    def geom(self):
        """f64 element geometry of the assembled path (built at first use)."""
        if self._geom is None:
            self._geom = precompute_geometry(self.mesh.coords, self.mesh.conn, self.mesh.element)
        return self._geom

    @property
    def scatter(self):
        """Node scatter of the assembled path (built at first use)."""
        if self._scatter is None:
            self._scatter = NodeScatter.build(self.mesh.conn_host, self.mesh.n_nodes,
                                              self.mesh.device)
        return self._scatter

    def _residual(self, u, scale):
        """f64 residual (r [N, 3], ||r||): the plain SoA element pass on the
        mixed path, the assembled path's element pass on the f64 paths."""
        if self.options.precision == "mixed":
            return _residual_soa_fn(u, scale, self._soa64, self.material, self.bc, self.f_ext)
        return _residual_fn(u, scale, self.mesh.conn, self.geom, self.material, self.bc,
                            self.f_ext, self.scatter)

    def _step(self, u, scale, lin_tol=None, r64=None):
        """One Newton step on the route of `options` (bench.py's step mode):
        (u + du, PCG iterations, converged, final relative PCG residual).
        `lin_tol` replaces pcg_tol; `r64`, the f64 residual at u, is used
        by the mixed step only."""
        opts = self.options
        if opts.precision == "mixed":
            return self._step_mixed(u, scale, lin_tol, r64=r64)
        args = (u, scale, self.mesh.conn, self.geom, self.material, self.bc, self.f_ext,
                self.scatter)
        if opts.linear == "direct":
            return _step_direct_fn(*args, self.bcsr)
        tol = opts.pcg_tol if lin_tol is None else lin_tol
        if opts.linear == "pcg":
            return _step_matfree_fn(*args, tol, opts.pcg_maxiter)
        return _step_bcsr_fn(*args, self.bcsr, tol, opts.pcg_maxiter)

    def _mixed_prepare(self, u, scale, r64=None):
        """The mixed step's set-up at u (the reference's
        `_mixed_prepare_fn`): the f64 residual `r64` (the plain f64 SoA
        pass when not given), the f32 freeze, block-Jacobi and the
        preconditioner. Returns (matvec, precond, b32)."""
        if r64 is None:
            r64, _ = _residual_soa_fn(u, scale, self._soa64, self.material, self.bc, self.f_ext)
        free32 = self.bc.free_mask.to(torch.float32)
        free32_T = free32.T.contiguous()
        state = self._freeze(u)
        diag = soa_diag_blocks(self._soa, state).permute(2, 0, 1)
        precond = _mixed_precond(jacobi_inverse_blocks(diag, free32), free32, self._coarse)

        def matvec(v):
            return _mixed_matvec(self._soa, state, free32_T, v)

        return matvec, precond, r64.to(torch.float32)

    def _step_mixed(self, u, scale, lin_tol=None, r64=None):
        """One mixed-precision Newton step: `_mixed_prepare`, then
        `_chunked_pcg` from zero at `lin_tol` (else pcg_tol) rounded to
        f32, its first chunk after the set-up (the zero start is the first
        best iterate), as the reference's step; a breakdown restart
        rebuilds only the Krylov state. No fallback to block-Jacobi alone."""
        tol = _to_f32(self.options.pcg_tol if lin_tol is None else lin_tol)
        matvec, precond, b = self._mixed_prepare(u, scale, r64)
        x, iters, ok, rel = self._chunked_pcg(matvec, precond, b, tol, first_chunk=False)
        return u + x.to(u.dtype), iters, ok, rel

    def step_fn(self, u, scale):
        """One Newton step as a plain function of (u, scale) (the step of
        entry.py): on the mixed path `_mixed_prepare` and
        one PCG chunk of at most pcg_chunk iterations at pcg_tol in f32,
        returning (u + x, iterations, no breakdown, ||r||); on every other
        route `_step`."""
        opts = self.options
        if opts.precision != "mixed":
            return self._step(u, scale)
        matvec, precond, b = self._mixed_prepare(u, scale)
        st = pcg_chunk(matvec, pcg_init(matvec, b, precond, tol=_to_f32(opts.pcg_tol)), precond,
                       maxiter=opts.pcg_chunk)
        return u + st.x.to(u.dtype), st.k, st.ok, math.sqrt(st.rr)

    def _freeze(self, u):
        """f32 tangent state at u [N, 3]."""
        return soa_freeze(self._soa, self.material, u.to(torch.float32).T.contiguous())

    def _chunked_pcg(self, matvec, precond, b, tol, first_chunk):
        """Chunked PCG from zero on the masked f32 tangent system through
        `drive_chunked_pcg`, in chunks of pcg_chunk up to pcg_maxiter
        iterations (`first_chunk`: the first chunk runs with the set-up).
        Returns (x, iterations, converged, rel)."""
        opts = self.options

        def prepare(x0):
            st = pcg_init(matvec, b, precond, x0=x0, tol=tol)
            if x0 is None and first_chunk:
                st = pcg_chunk(matvec, st, precond, maxiter=min(opts.pcg_chunk, opts.pcg_maxiter))
            return st

        def chunk(st, n):
            return pcg_chunk(matvec, st, precond, maxiter=n)

        return drive_chunked_pcg(prepare, chunk, tol=tol, chunk_iters=opts.pcg_chunk,
                                 maxiter=opts.pcg_maxiter)

    def _linear_solve(self, state, inv_blocks, b, lin_tol, free32, free32_T):
        """Chunked PCG on the masked f32 tangent system; a preconditioner with
        a coarse correction falls back to block-Jacobi alone when its solve
        is not accepted. Returns (x, iterations, accepted)."""

        def matvec(v):
            return _mixed_matvec(self._soa, state, free32_T, v)

        def run(coarse, first_chunk):
            return self._chunked_pcg(matvec, _mixed_precond(inv_blocks, free32, coarse), b,
                                     lin_tol, first_chunk)

        x, iters, ok, rel = run(self._coarse, True)
        accept = ok or rel <= 1e-3
        if not accept and self._coarse is not None:
            x_fb, it_fb, ok_fb, rel_fb = run(None, False)
            self.precond_fallbacks += 1
            iters += it_fb
            accept = ok_fb or rel_fb <= 1e-3
            if accept:
                x = x_fb
        return x, iters, accept

    def _device_solve(self, u, scale):
        """One increment on the device loop (solvers/device_loop.py). The
        loop is built at first use and kept, so its graphs are captured
        once per solver; where the solver's f64 residual route, coarse
        space, options, boundary conditions or load are no longer the
        objects it was built with, it is built anew (and recaptured).
        Returns a `DeviceLoopResult`."""
        if self._device_loop is None or self._device_loop.stale():
            from fea_large_tpu_torch.solvers.device_loop import DeviceLoop

            self._device_loop = None  # release the old graphs before the capture
            self._device_loop = DeviceLoop(self)
        return self._device_loop.solve(u, scale)

    def _newton_mixed(self, u, scale):
        """The mixed path's Newton loop at the load factor `scale`: the
        device loop, with the host loop taking over where it hands back
        (the reference's dispatch), or the host loop alone."""
        opts = self.options
        if not opts.device_loop:
            return self._newton_mixed_host(u, scale)
        t0 = time.perf_counter()
        scale = float(scale)
        out = self._device_solve(u, scale)
        n_it = out.n_iters
        if out.converged or out.poisoned or not (out.exhausted or out.failed):
            # terminal: converged, a non-finite residual (-> bisection) or
            # max_newton reached; the last iteration's solve ran 0
            # iterations (converged) or was never applied (max_newton)
            pcg = out.pcg_iters[:n_it]
            if out.converged or n_it >= opts.max_newton:
                pcg = pcg[:-1]
            rec = IncrementRecord(scale, n_it - 1 if out.converged else n_it,
                                  out.residual_norms[:n_it], pcg, time.perf_counter() - t0)
            return out.u, out.converged, rec
        # out of the CG budget, or a CG breakdown: the host loop redoes the
        # last device iteration (its partial solve is dropped; `eta` is the
        # forcing value from before it) and continues the Newton sequence
        n_use = max(n_it - 1, 0)
        return self._newton_mixed_host(out.u, scale, handback=(
            t0, out.residual_norms[:n_use], out.pcg_iters[:n_use], out.eta))

    def _newton_mixed_host(self, u, scale, handback=None):
        """The host loop from the start of the increment, or warm-started
        by `handback` = (t0, norms, pcg_iters, eta) of a device-loop solve
        that ran len(norms) accepted iterations (u is then the iterate
        whose residual comes next, already under the increment's BCs)."""
        opts = self.options
        scale = float(scale)
        if handback is None:
            t0, norms, pcg_iters, eta = time.perf_counter(), [], [], 0.5
            u = self.bc.impose(u, scale)
        else:
            t0, norms, pcg_iters, eta = handback
            norms, pcg_iters = list(norms), list(pcg_iters)
        it0 = len(norms)
        free32 = self.bc.free_mask.to(torch.float32)
        free32_T = free32.T.contiguous()
        f_ext32 = self.f_ext.to(torch.float32)
        use_ew = opts.forcing == "ew"
        norm0 = stop_n = None
        if norms:
            norm0 = max(norms[0], 1e-300)
            stop_n = max(opts.newton_rtol * norm0, opts.newton_atol)
        x_prev = None
        for it in range(it0, opts.max_newton):
            if x_prev is not None:
                u = u + x_prev.to(u.dtype)
            state = None
            # f32 residual only while far above the f32 rounding floor; the
            # iterations that decide convergence take the f64 pass
            if use_ew and norm0 is not None and norms[-1] > 3e-2 * norm0:
                state = self._freeze(u)
                f_int_T = soa_internal_force(self._soa, state)
                b = (scale * f_ext32 - f_int_T.T) * free32
                norm = float(torch.linalg.norm(b))
            else:
                resid = _residual_df_fn if self._resid_df else _residual_soa_fn
                b64, norm_t = resid(u, scale, self._soa64, self.material, self.bc, self.f_ext)
                b = b64.to(torch.float32)
                norm = float(norm_t)
            if norm != norm:  # NaN: poisoned state; fail -> bisection
                break
            norms.append(norm)
            if norm0 is None:
                norm0 = max(norm, 1e-300)
                stop_n = max(opts.newton_rtol * norm0, opts.newton_atol)
            if norm <= stop_n:
                rec = IncrementRecord(scale, it, norms, pcg_iters, time.perf_counter() - t0)
                return u, True, rec
            if it == opts.max_newton - 1:
                break  # this iteration's direction could never be applied
            lin_tol, eta = newton_lin_tol(opts, it, norms, norm0, eta)
            if state is None:
                state = self._freeze(u)
            diag = soa_diag_blocks(self._soa, state).permute(2, 0, 1)
            inv_blocks = jacobi_inverse_blocks(diag, free32)
            x_prev, lin_iters, accept = self._linear_solve(
                state, inv_blocks, b, lin_tol, free32, free32_T
            )
            pcg_iters.append(int(lin_iters))
            if not accept:
                break
        rec = IncrementRecord(scale, len(norms), norms, pcg_iters, time.perf_counter() - t0)
        return u, False, rec

    def _newton(self, u, scale):
        """Newton iteration at the fixed load factor `scale`:
        (u, converged, IncrementRecord)."""
        opts = self.options
        if opts.precision == "mixed":
            return self._newton_mixed(u, scale)
        t0 = time.perf_counter()
        scale = float(scale)
        u = self.bc.impose(u, scale)
        norms, pcg_iters = [], []
        norm0 = None
        eta = 0.5
        lin_failed = False
        for it in range(opts.max_newton):
            _, norm_t = self._residual(u, scale)
            norm = float(norm_t)
            if norm != norm:  # NaN: poisoned state; fail -> bisection
                break
            norms.append(norm)
            if norm0 is None:
                norm0 = max(norm, 1e-300)
            if norm <= max(opts.newton_rtol * norm0, opts.newton_atol):
                rec = IncrementRecord(scale, it, norms, pcg_iters, time.perf_counter() - t0)
                return u, True, rec
            # a self-reported PCG failure aborts only when its direction
            # also made no real progress (the Newton residual is the arbiter)
            if lin_failed and norm > 0.5 * norms[-2]:
                break
            lin_tol = None  # the direct solve takes no forcing term
            if opts.linear != "direct":
                lin_tol, eta = newton_lin_tol(opts, it, norms, norm0, eta)
            u, lin_iters, lin_ok, lin_rel = self._step(u, scale, lin_tol)
            pcg_iters.append(int(lin_iters))
            # inexact Newton: a direction that reduced the linear residual
            # by 1e-3 is usable even short of the requested tolerance
            lin_failed = not (lin_ok or lin_rel <= 1e-3)
        rec = IncrementRecord(scale, len(norms), norms, pcg_iters, time.perf_counter() - t0)
        return u, False, rec

    def solve(self, u0=None, callback=None, start_factor: float = 0.0) -> SolveResult:
        """Incremental loading from `start_factor` to 1 in `n_steps`
        increments, with bisection on Newton failure. `callback(record, u)`
        fires after each converged increment."""
        opts = self.options
        u = (
            torch.zeros((self.mesh.n_nodes, 3), dtype=torch.float64, device=self.mesh.device)
            if u0 is None else u0
        )
        history: list[IncrementRecord] = []
        lam = float(start_factor)
        dlam_nominal = 1.0 / opts.n_steps
        dlam = dlam_nominal
        bisections = 0
        while lam < 1.0 - 1e-12:
            target = min(lam + dlam, 1.0)
            u_try, ok, rec = self._newton(u, target)
            history.append(rec)
            if ok:
                u, lam = u_try, target
                if callback is not None:
                    callback(rec, u)
                dlam = min(2.0 * dlam, dlam_nominal, 1.0 - lam)
                if dlam <= 0.0:
                    dlam = 1.0 - lam
                bisections = 0
            else:
                bisections += 1
                if bisections > opts.max_bisections:
                    return SolveResult(u=u, converged=False, history=history)
                dlam *= 0.5
        return SolveResult(u=u, converged=True, history=history)
