"""Newton driver with incremental load stepping (counterpart of
`fea_large_tpu/solvers/newton.py`): the host-loop mixed-precision path and
the f64 assembled path.

Mixed precision (`precision="mixed"`, `linear="pcg"`), per Newton
iteration (`NewtonSolver._newton_mixed`):
  * the residual R = M (scale f_ext - f_int(u)): in f64, or, while
    ||R|| > 3e-2 ||R0|| under Eisenstat-Walker forcing, in f32 from the
    frozen tangent state (the `resid32` gate); the converging iterations
    always use f64. The f64 pass is the fused residual kernel, B5 on Kuhn
    lattices and B9 on unstructured meshes, when `resid_df` routes it
    (`_residual_df_fn`), else the plain f64 element pass
    (`_residual_soa_fn`);
  * the f32 tangent state (freeze), the block-Jacobi blocks (diag), and a
    chunked PCG solve of the masked f32 tangent system (tangent action),
    preconditioned by block-Jacobi plus the optional two-level coarse
    correction (solvers/multilevel.py); a two-level solve that breaks down
    is retried with block-Jacobi alone. On the card the f32 freeze, tangent
    action and force are the lattice kernels on Kuhn lattices and the
    element-block kernels (ops/elem_kernels.py) on unstructured meshes;
  * the forcing term `newton_lin_tol` (Eisenstat-Walker choice 2 with the
    lower cap `ew_eta_min`, the termination safeguard and the f32 floor).

f64 assembled (`precision="f64"`, `linear="pcg_bcsr"`, config 2 of the
reference), per Newton iteration (`NewtonSolver._newton`): the f64
residual of the element pass (`_residual_fn`), the element stiffness
assembled into BCSR (assembly/bcsr.py), and block-Jacobi PCG on the masked
system with one restart from the final iterate (`_pcg_with_restart`),
whose product is the BCSR kernel B10 on the card (ops/bcsr_kernels.py).

`solve` steps the load factor to 1 with bisection on Newton failure.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
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
    drive_chunked_pcg,
    jacobi_inverse_blocks,
    pcg,
    pcg_chunk,
    pcg_init,
)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver configuration: the reference's fields and defaults, less the
    device-loop budget. The port runs two paths; `NewtonSolver` raises on
    any other combination:
      * linear="pcg", precision="mixed", device_loop=False,
        preconditioner "jacobi" or "two_level" with coarse_modes 3 or 6;
      * linear="pcg_bcsr", precision="f64" (block-Jacobi; the mixed-path
        fields preconditioner, coarse_modes, agg_size, device_loop and
        resid_df have no effect there, as in the reference).

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


def _unsupported(opts: SolverOptions) -> str | None:
    """What of `opts` is not ported (NotImplementedError), or None. Raises
    ValueError where the reference does."""
    if opts.linear not in ("direct", "pcg", "pcg_bcsr"):
        raise ValueError(f"unknown linear solver {opts.linear!r}")
    if opts.pallas and opts.precision != "mixed":
        raise ValueError("pallas=True requires precision='mixed'")
    if opts.linear == "direct":
        return "linear='direct' (the dense Cholesky path)"
    if opts.precision == "f64":
        return None if opts.linear == "pcg_bcsr" else "precision='f64' with the matrix-free PCG"
    if opts.precision != "mixed":
        return f"precision={opts.precision!r}"
    if opts.linear != "pcg":
        raise ValueError("precision='mixed' requires linear='pcg'")
    if opts.device_loop:
        return "device_loop=True (the device-resident Newton loop)"
    if opts.preconditioner not in ("jacobi", "two_level"):
        return f"preconditioner={opts.preconditioner!r}"
    if opts.preconditioner == "two_level" and opts.coarse_modes not in (3, 6):
        return f"coarse_modes={opts.coarse_modes}"
    return None


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
            cand = 0.9 * (norms[-1] / norms[-2]) ** 2
            safe = 0.9 * eta**2
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


def _step_bcsr_fn(u, scale, conn, geom, material, bc, f_ext, scatter, structure, pcg_tol,
                  pcg_maxiter):
    """One f64 Newton step on the assembled system: (u + du, PCG
    iterations, converged, final relative PCG residual)."""
    K, f_int = assemble_bcsr(u, conn, geom, material, structure, scatter)
    r = bc.project(scale * f_ext - f_int)
    precond = block_jacobi_preconditioner(K.block_diagonal(), bc.free_mask)

    def matvec(v):
        vm = bc.project(v)
        return bc.project(K.matvec(vm)) + (v - vm)

    res = _pcg_with_restart(matvec, r, precond, pcg_tol, pcg_maxiter)
    rel = res.residual_norm / max(float(torch.linalg.norm(r)), 1e-300)
    return u + res.x, res.iterations, res.converged, rel


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


def _mixed_matvec(soa, state, free32_T, v):
    """Masked f32 tangent action M K M v + (I - M) v; v [N, 3]."""
    vm_T = (v.T * free32_T).contiguous()
    y_T = soa_apply_tangent(soa, state, vm_T) * free32_T
    return y_T.T + (v - vm_T.T)


def _mixed_precond(inv_blocks, free32, coarse):
    """Block-Jacobi, plus the two-level coarse correction when `coarse`."""

    def apply(r):
        z = apply_block_jacobi(inv_blocks, free32, r)
        if coarse is not None:
            z = z + free32 * coarse.apply(r)
        return z

    return apply


class NewtonSolver:
    """Total-Lagrangian quasi-static solver for one mesh/material/BC setup
    on the mesh's device. The mixed path builds the f32 and f64 SoA
    element geometry and, for "two_level", the coarse space (host setup +
    device probing); the f64 path builds the BCSR structure, and its
    element geometry and node scatter at first use."""

    def __init__(self, mesh, material, bc, f_ext=None, options=None):
        self.options = options or SolverOptions()
        why = _unsupported(self.options)
        if why is not None:
            raise NotImplementedError(f"{why} is not ported (see ROADMAP.md)")
        self.mesh = mesh
        self.material = material
        self.bc = bc
        #: two-level -> block-Jacobi fallbacks taken on CG breakdown
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
        if self.options.precision == "f64":
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
            from fea_large_tpu_torch.solvers.multilevel import build_coarse_space

            self._coarse = build_coarse_space(
                mesh, material, bc, agg_size=self.options.agg_size,
                modes=self.options.coarse_modes, soa=self._soa,
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
        return _residual_fn(u, scale, self.mesh.conn, self.geom, self.material, self.bc,
                            self.f_ext, self.scatter)

    def _step(self, u, scale, lin_tol=None):
        tol = self.options.pcg_tol if lin_tol is None else lin_tol
        return _step_bcsr_fn(u, scale, self.mesh.conn, self.geom, self.material, self.bc,
                             self.f_ext, self.scatter, self.bcsr, tol, self.options.pcg_maxiter)

    def _freeze(self, u):
        """f32 tangent state at u [N, 3]."""
        return soa_freeze(self._soa, self.material, u.to(torch.float32).T.contiguous())

    def _linear_solve(self, state, inv_blocks, b, lin_tol, free32, free32_T):
        """Chunked PCG on the masked f32 tangent system; the two-level
        preconditioner falls back to block-Jacobi alone when its solve is
        not accepted. Returns (x, iterations, accepted)."""
        opts = self.options

        def matvec(v):
            return _mixed_matvec(self._soa, state, free32_T, v)

        def run(coarse, first_chunk):
            precond = _mixed_precond(inv_blocks, free32, coarse)

            def prepare(x0):
                st = pcg_init(matvec, b, precond, x0=x0, tol=lin_tol)
                if x0 is None and first_chunk:
                    st = pcg_chunk(matvec, st, precond,
                                   maxiter=min(opts.pcg_chunk, opts.pcg_maxiter))
                return st

            def chunk(st, n):
                return pcg_chunk(matvec, st, precond, maxiter=n)

            return drive_chunked_pcg(
                prepare, chunk, tol=lin_tol, chunk_iters=opts.pcg_chunk,
                maxiter=opts.pcg_maxiter,
            )

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

    def _newton_mixed(self, u, scale):
        opts = self.options
        t0 = time.perf_counter()
        scale = float(scale)
        u = self.bc.impose(u, scale)
        free32 = self.bc.free_mask.to(torch.float32)
        free32_T = free32.T.contiguous()
        f_ext32 = self.f_ext.to(torch.float32)
        use_ew = opts.forcing == "ew"
        norms, pcg_iters = [], []
        norm0 = stop_n = None
        eta = 0.5
        x_prev = None
        for it in range(opts.max_newton):
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
