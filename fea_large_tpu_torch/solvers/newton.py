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
    (`_residual_df_fn`; the rule is `residual.resid_df_route`, which the
    sharded ranks share), else the plain f64 element pass
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
solver and composed into one program of nested WHILE and IF nodes, one
launch and one fetch an increment. It hands a solve that
runs out of its CG budget (`device_loop_budget`) or breaks down to the
host loop, which continues the same Newton sequence. The host loop
(`device_loop=False`, `NewtonSolver._newton_mixed_host`): the forcing by
`newton_lin_tol`, then chunked PCG (`drive_chunked_pcg` over a device
chunk, below) with rounding-breakdown restarts; a solve with a coarse
correction that breaks down is retried with block-Jacobi alone, on a
second chunk.

Every single-device CG outside the device loop runs the reference's
`pcg_init` + `pcg_chunk` as a `linear.DevicePCGChunk`: on the card a
chunk of n iterations is one replay of captured CUDA graphs (the CG
iteration under a WHILE node on the device's loop condition) and one
batched fetch of (k, rr, ok, stop); on the CPU the same bodies run
eagerly. The stop max(tol ||b||, atol) and the loop's test are formed in
the vectors' dtype, f32 on the mixed path, as the reference's. Each route
of a solver (`_ChunkRoute`: "mixed", "pcg_bcsr", "pcg") captures its
chunks once, at first use, over persistent copies of the operands its
product and preconditioner read (the frozen state, the BCSR values, the
inverse Jacobi blocks), which each solve overwrites in place; where the
solver's options, `bc`, `f_ext`, coarse space, mesh or material are no
longer the objects it was built with, the route is built anew. The
chunks serve the mixed step, `step_fn`, the host loop (one chunk of
pcg_chunk iterations per fetch) and the f64 steps (a run of pcg_maxiter
and its restart in one launch, one fetch a step).

f64 (`precision="f64"`), per Newton iteration (`NewtonSolver._newton`):
the f64 residual of the element pass (`_residual_fn`), then one step
(`_step`) on the masked system:
  * `linear="pcg_bcsr"` (config 2 of the reference): the element stiffness
    assembled into BCSR (assembly/bcsr.py) and block-Jacobi PCG with one
    restart from the final iterate (`_pcg_with_restart`, on the route's
    chunk), whose product is the BCSR kernel B10 on the card
    (ops/bcsr_kernels.py);
  * `linear="pcg"` (matrix-free, bench.py's FEA_BENCH_PRECISION=f64): the
    frozen tangent state, the scattered element diagonal blocks and the
    same PCG on the tangent action (assembly/matfree.py), plain PyTorch;
  * `linear="direct"` (config 1): the dense K (assembly/dense.py) and a
    Cholesky solve; one "iteration" per step, no forcing term.
The matrix-free and direct routes are plain PyTorch: the reference runs
them as XLA-fused einsums and `cho_solve`, outside any Pallas kernel.
The device spans of an f64 Newton iteration (utils/profiling.py):
`residual64`, closed before the host reads its norm; on the PCG routes
`jacobi` and `step_refresh` up to the chunk's own spans; on the assembled
routes `stiffness` and `assemble` (assembly/bcsr.py).

One step alone (`_step`, bench.py's FEA_BENCH_MODE=step; `step_fn`, the
step of entry.py): on the f64 routes the step above; on the
mixed path (`_step_mixed`) the plain f64 residual, the f32 freeze,
block-Jacobi plus the coarse correction and chunked f32 PCG
(`drive_chunked_pcg` over the mixed route's chunk), with no fallback to
block-Jacobi alone, as the reference's step.

`solve` steps the load factor to 1 with bisection on Newton failure.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from fea_large_tpu_torch.assembly.bcsr import BCSRStructure, assemble_bcsr
from fea_large_tpu_torch.assembly.dense import assemble_dense, mask_dense_system
from fea_large_tpu_torch.assembly.matfree import apply_tangent, make_operator
from fea_large_tpu_torch.assembly.scatter import NodeScatter
from fea_large_tpu_torch.elements.kernels import element_internal_force, precompute_geometry
from fea_large_tpu_torch.ops.bcsr_kernels import bcsr_spmv
from fea_large_tpu_torch.ops.residual import internal_force64, resid_df_route
from fea_large_tpu_torch.ops.soa import (
    SoAProblem,
    soa_apply_tangent,
    soa_diag_blocks,
    soa_freeze,
    soa_internal_force,
)
from fea_large_tpu_torch.solvers.linear import (
    DevicePCGChunk,
    apply_block_jacobi,
    dense_cholesky_solve,
    drive_chunked_pcg,
    jacobi_inverse_blocks,
)
from fea_large_tpu_torch.solvers.multilevel import (
    build_coarse_space,
    build_multilevel_space,
    two_level_preconditioner,
)
from fea_large_tpu_torch.utils import profiling


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
              on Kuhn lattices and B9 on unstructured meshes (on one card
              and on the sharded solvers' ranks): None = on
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


def _pcg_with_restart(chunk, r, pcg_tol, pcg_maxiter):
    """PCG on `chunk` (a `DevicePCGChunk` over the masked system) from
    zero, then one unconditional restart from its final iterate with the
    remaining budget (`DevicePCGChunk.restart`: one launch and one fetch,
    as the reference's one dispatch). A p.Kp <= 0 breakdown near
    stagnation can be rounding in the recurrence; the restart rebuilds it
    from the true residual. After a converged solve, or one that used the
    whole budget, it costs one product and one preconditioner apply, and
    runs no iteration. Returns (x, iterations, converged, final ||r|| of
    the recurrence over ||r||); x is the chunk's buffer."""
    k1, _, st = chunk.restart(r, pcg_tol, pcg_maxiter)
    rnorm = math.sqrt(st.rr)
    return st.x, k1 + st.k, st.ok and rnorm <= st.stop, rnorm / max(st.bnorm, 1e-300)


def _step_direct_fn(u, scale, conn, geom, material, bc, f_ext, scatter, structure):
    """One f64 Newton step by the dense Cholesky solve of the masked
    system: (u + du, 1, True, 0.0), the PCG routes' tuple."""
    K, f_int = assemble_dense(u, conn, geom, material, structure, scatter)
    A, b = mask_dense_system(K, bc.project(scale * f_ext - f_int), bc.free_mask)
    return u + dense_cholesky_solve(A, b).reshape(u.shape), 1, True, 0.0


def _step_matfree_fn(u, scale, conn, geom, material, bc, f_ext, scatter, pcg_step):
    """One f64 Newton step on the matrix-free tangent: the operator at u,
    then `pcg_step(u, r, tangent state, diagonal blocks)`
    (`NewtonSolver._f64_pcg_step`), in the span `jacobi` from the
    inversion of the blocks."""
    op = make_operator(u, conn, geom, material, scatter)
    r = bc.project(scale * f_ext - op.f_int)
    profiling.stamp(u.device, "jacobi")
    return pcg_step(u, r, op.state, op.diag_blocks)


def _step_bcsr_fn(u, scale, conn, geom, material, bc, f_ext, scatter, structure, pcg_step):
    """One f64 Newton step on the assembled BCSR system: K at u (its spans
    `stiffness` and `assemble`), then `pcg_step(u, r, K's values, K's
    diagonal blocks)` in the span `jacobi` from the gather of the
    blocks."""
    K, f_int = assemble_bcsr(u, conn, geom, material, structure, scatter)
    r = bc.project(scale * f_ext - f_int)
    profiling.stamp(u.device, "jacobi")
    return pcg_step(u, r, K.data, K.block_diagonal())


def _clone_tree(x):
    """A copy of x: a tensor, or a dataclass or tuple (named or not) of
    them, as the operands of the PCG routes are (`SoAState`,
    `TangentState`, the iso-tangent factors)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone_tree(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if hasattr(x, "_fields"):
        return type(x)(*(_clone_tree(v) for v in x))
    return tuple(_clone_tree(v) for v in x)


def _copy_tree(dst, src) -> None:
    """Copy the tensors of `src` into those of `dst` (a `_clone_tree` of an
    operand of the same shapes and dtypes) in place."""
    if isinstance(dst, torch.Tensor):
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError("a refreshed operand must keep its shape and dtype")
        dst.copy_(src)
        return
    if dataclasses.is_dataclass(dst):  # not astuple: it deep-copies the tensors
        names = [f.name for f in dataclasses.fields(dst)]
        dst, src = ([getattr(x, n) for n in names] for x in (dst, src))
    for a, b in zip(dst, src, strict=True):
        _copy_tree(a, b)


class _ChunkRoute:
    """The PCG chunks of one route of one solver ("mixed", "pcg_bcsr",
    "pcg"): the operands their bodies read (the frozen tangent state, the
    BCSR values, the inverse Jacobi blocks) in persistent copies that
    `refresh` overwrites in place before each solve (a captured graph holds
    their addresses), and one `DevicePCGChunk` per preconditioner
    (`chunk(key)`, built, and captured on the card, at first use).
    `make(operands, key)` gives a chunk's (matvec, preconditioner). It
    serves the solver's inputs as they were at construction (`stale`)."""

    def __init__(self, solver, operands, make, dtype):
        self._fixed = _route_inputs(solver)
        self.operands = _clone_tree(operands)
        self._make = make
        self._dtype = dtype
        self._shape = (solver.mesh.n_nodes, 3)
        self._device = solver.mesh.device
        self._capture = solver._capture_chunks
        self.chunks = {}

    def stale(self, solver) -> bool:
        return any(a is not b for a, b in zip(_route_inputs(solver), self._fixed))

    def refresh(self, operands) -> None:
        _copy_tree(self.operands, operands)

    def chunk(self, key: str) -> DevicePCGChunk:
        if key not in self.chunks:
            matvec, precond = self._make(self.operands, key)
            self.chunks[key] = DevicePCGChunk(matvec, precond, self._shape, self._dtype,
                                              self._device, capture=self._capture)
        return self.chunks[key]


def _route_inputs(solver) -> tuple:
    return (solver.options, solver.bc, solver.f_ext, solver._coarse, solver.mesh,
            solver.material)


def _residual_soa_fn(u, scale, soa64, material, bc, f_ext):
    """f64 residual (r [N, 3], ||r||) from the plain f64 element pass
    (`residual.internal_force64`)."""
    f_int = internal_force64(soa64, material, u.T.contiguous(), fused=False).T
    r = bc.project(scale * f_ext - f_int)
    return r, torch.linalg.norm(r)


def _residual_df_fn(u, scale, soa64, material, bc, f_ext):
    """f64 residual (r [N, 3], ||r||) from the fused residual kernel, B5 or
    B9 (`residual.internal_force64`): the same pass as `_residual_soa_fn`,
    in one kernel."""
    f_int = internal_force64(soa64, material, u.T.contiguous(), fused=True).T
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
        #: the PCG chunks of each route (`_ChunkRoute`), built at first use
        self._routes = {}
        #: None: the chunks are captured on the card and run eagerly on the
        #: CPU; False: eagerly wherever the tensors are (a comparison on the
        #: card, never a fallback)
        self._capture_chunks = None
        with profiling.SETUP.phase("setup.solver", self.f_ext):
            self._build()

    def _build(self) -> None:
        """The set-up of the route of `options` (the class docstring)."""
        mesh, material, bc = self.mesh, self.material, self.bc
        if self.options.precision == "f64":
            if self.options.linear in ("pcg_bcsr", "direct"):
                self.bcsr = BCSRStructure.build(mesh.conn_host, mesh.n_nodes, mesh.device)
            return
        self._soa = SoAProblem.build(mesh, torch.float32)
        self._soa64 = SoAProblem.build(mesh, torch.float64, share_maps_from=self._soa)
        self._resid_df = resid_df_route(self._soa64, material, self.options, mesh.device)
        if self.options.preconditioner == "two_level":
            with profiling.SETUP.phase("setup.coarse", self.f_ext):
                self._coarse = build_coarse_space(
                    mesh, material, bc, agg_size=self.options.agg_size,
                    modes=self.options.coarse_modes, soa=self._soa,
                )
        elif self.options.preconditioner == "three_level":
            with profiling.SETUP.phase("setup.coarse", self.f_ext):
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
            return _step_matfree_fn(*args, self._f64_pcg_step(tol))
        return _step_bcsr_fn(*args, self.bcsr, self._f64_pcg_step(tol))

    def _route(self, name, operands, make, dtype) -> _ChunkRoute:
        """The chunks of route `name` with their operands refreshed to
        `operands`: the route built at first use and kept, so its graphs are
        captured once per solver; built anew (and recaptured) where the
        solver's inputs changed since."""
        route = self._routes.get(name)
        if route is not None and not route.stale(self):
            route.refresh(operands)
            return route
        self._routes.pop(name, None)  # release the old graphs before the capture
        route = self._routes[name] = _ChunkRoute(self, operands, make, dtype)
        return route

    def _f64_pcg_step(self, tol):
        """`pcg_step(u, r, operand, diag_blocks)` of the f64 PCG steps:
        block-Jacobi PCG with one restart (`_pcg_with_restart`) on the
        masked system M K M + (I - M) of this solver's route, K v the BCSR
        product of the values `operand` (B10) or the matrix-free tangent
        action of the state `operand`, at `tol` and pcg_maxiter. Returns
        (u + du, PCG iterations, converged, final relative PCG residual).
        Its device span `step_refresh` runs from the inverse blocks to the
        chunk's first body (the operand copies)."""
        opts, bc = self.options, self.bc
        free = bc.free_mask
        if opts.linear == "pcg_bcsr":
            structure = self.bcsr

            def product(data):
                return lambda v: bcsr_spmv(structure, data, v)
        else:
            conn, geom, material, scatter = self.mesh.conn, self.geom, self.material, self.scatter

            def product(state):
                return lambda v: apply_tangent(state, v, conn, geom, material, scatter)

        def make(operands, key):
            operand, inv_blocks = operands
            apply = product(operand)

            def matvec(v):  # M K M v + (I - M) v
                vm = bc.project(v)
                return bc.project(apply(vm)) + (v - vm)

            return matvec, lambda r: apply_block_jacobi(inv_blocks, free, r)

        def pcg_step(u, r, operand, diag_blocks):
            inv_blocks = jacobi_inverse_blocks(diag_blocks, free)
            profiling.stamp(u.device, "step_refresh")
            route = self._route(opts.linear, (operand, inv_blocks), make, r.dtype)
            x, iters, ok, rel = _pcg_with_restart(route.chunk("jacobi"), r, tol, opts.pcg_maxiter)
            return u + x, iters, ok, rel

        return pcg_step

    def _mixed_route(self, state, inv_blocks) -> _ChunkRoute:
        """The mixed routes' chunks (the step, `step_fn`, the host loop)
        with their operands refreshed to the frozen state and inverse
        Jacobi blocks: chunk "coarse" over block-Jacobi plus the coarse
        correction (where the solver has a coarse space), "jacobi" over
        block-Jacobi alone."""
        soa, coarse = self._soa, self._coarse
        free32 = self.bc.free_mask.to(torch.float32)
        free32_T = free32.T.contiguous()

        def make(operands, key):
            frozen, inv = operands
            return (lambda v: _mixed_matvec(soa, frozen, free32_T, v),
                    _mixed_precond(inv, free32, coarse if key == "coarse" else None))

        return self._route("mixed", (state, inv_blocks), make, torch.float32)

    def _mixed_key(self) -> str:
        return "jacobi" if self._coarse is None else "coarse"

    def _mixed_prepare(self, u, scale, r64=None):
        """The mixed step's set-up at u (the reference's
        `_mixed_prepare_fn`): the f64 residual `r64` (the plain f64 SoA
        pass when not given), the f32 freeze and block-Jacobi. Returns the
        mixed route's chunk (`_mixed_route`) over the solver's
        preconditioner, its operands refreshed, and b32. Its device spans:
        `residual64` (where it computes r64), `freeze`, `jacobi`, then
        `step_refresh` (the operand copies and the chunk's start, up to the
        chunk's first body)."""
        device = self.mesh.device
        with profiling.span("fea.step.prepare"):
            if r64 is None:
                profiling.stamp(device, "residual64")
                r64, _ = _residual_soa_fn(u, scale, self._soa64, self.material, self.bc,
                                          self.f_ext)
            free32 = self.bc.free_mask.to(torch.float32)
            profiling.stamp(device, "freeze")
            state = self._freeze(u)
            profiling.stamp(device, "jacobi")
            diag = soa_diag_blocks(self._soa, state).permute(2, 0, 1)
            inv_blocks = jacobi_inverse_blocks(diag, free32)
            profiling.stamp(device, "step_refresh")
            route = self._mixed_route(state, inv_blocks)
            return route.chunk(self._mixed_key()), r64.to(torch.float32)

    def _step_mixed(self, u, scale, lin_tol=None, r64=None):
        """One mixed-precision Newton step: `_mixed_prepare`, then
        `_chunked_pcg` from zero at `lin_tol` (else pcg_tol) rounded to
        f32, its first chunk after the set-up (the zero start is the first
        best iterate), as the reference's step; a breakdown restart
        rebuilds only the Krylov state. No fallback to block-Jacobi alone."""
        tol = _to_f32(self.options.pcg_tol if lin_tol is None else lin_tol)
        chunk, b = self._mixed_prepare(u, scale, r64)
        x, iters, ok, rel = self._chunked_pcg(chunk, b, tol, first_chunk=False)
        return u + x.to(u.dtype), iters, ok, rel

    def step_fn(self, u, scale):
        """One Newton step as a plain function of (u, scale) (the step of
        entry.py): on the mixed path `_mixed_prepare` and one run of the
        chunk, at most pcg_chunk iterations at pcg_tol in f32, returning
        (u + x, iterations, no breakdown, ||r||); on every other route
        `_step`."""
        opts = self.options
        with profiling.span("fea.step"):
            if opts.precision != "mixed":
                return self._step(u, scale)
            chunk, b = self._mixed_prepare(u, scale)
            chunk.start(b, _to_f32(opts.pcg_tol))
            st = chunk.run(opts.pcg_chunk)
            return u + st.x.to(u.dtype), st.k, st.ok, math.sqrt(st.rr)

    def _freeze(self, u):
        """f32 tangent state at u [N, 3]."""
        return soa_freeze(self._soa, self.material, u.to(torch.float32).T.contiguous())

    def _chunked_pcg(self, chunk, b, tol, first_chunk):
        """Chunked PCG from zero on `chunk` (the masked f32 tangent system)
        through `drive_chunked_pcg`: runs of pcg_chunk iterations up to
        pcg_maxiter, one fetch each (`first_chunk`: the first run follows
        the set-up before the first fetch). Returns (x, iterations,
        converged, rel); x may be the chunk's buffer."""
        opts = self.options

        def prepare(x0):
            chunk.start(b, tol, x0=x0)
            if x0 is None and first_chunk:
                return chunk.run(min(opts.pcg_chunk, opts.pcg_maxiter))
            return chunk.fetch()

        return drive_chunked_pcg(prepare, lambda st, n: chunk.run(n), tol=tol,
                                 chunk_iters=opts.pcg_chunk, maxiter=opts.pcg_maxiter)

    def _linear_solve(self, state, inv_blocks, b, lin_tol):
        """Chunked PCG on the masked f32 tangent system; a preconditioner with
        a coarse correction falls back to block-Jacobi alone (the route's
        second chunk) when its solve is not accepted. Returns (x,
        iterations, accepted)."""
        route = self._mixed_route(state, inv_blocks)
        x, iters, ok, rel = self._chunked_pcg(route.chunk(self._mixed_key()), b, lin_tol, True)
        accept = ok or rel <= 1e-3
        if not accept and self._coarse is not None:
            x_fb, it_fb, ok_fb, rel_fb = self._chunked_pcg(route.chunk("jacobi"), b, lin_tol,
                                                           False)
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
            x_prev, lin_iters, accept = self._linear_solve(state, inv_blocks, b, lin_tol)
            pcg_iters.append(int(lin_iters))
            if not accept:
                break
        rec = IncrementRecord(scale, len(norms), norms, pcg_iters, time.perf_counter() - t0)
        return u, False, rec

    def _newton(self, u, scale):
        """Newton iteration at the fixed load factor `scale`:
        (u, converged, IncrementRecord)."""
        with profiling.span("fea.increment"):
            return self._newton_route(u, scale)

    def _newton_route(self, u, scale):
        """`_newton` on the route of `options`."""
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
            profiling.stamp(u.device, "residual64")
            _, norm_t = self._residual(u, scale)
            profiling.close_span(u.device)  # before the host reads the norm
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
        increments, with bisection on Newton failure (`step_load`).
        `callback(record, u)` fires after each converged increment."""
        u = (
            torch.zeros((self.mesh.n_nodes, 3), dtype=torch.float64, device=self.mesh.device)
            if u0 is None else u0
        )
        return step_load(self, u, callback, start_factor)


def step_load(solver, u, callback, start_factor: float) -> SolveResult:
    """The load stepping of `NewtonSolver.solve` and the sharded solvers'
    `solve`: from u at `start_factor` to 1 in increments of 1 / n_steps,
    each `solver._newton(u, target)` (looked up at each increment); a
    failed increment is halved, up to max_bisections times in a row, and
    after a converged one the step doubles back up to the nominal one.
    `callback(record, u)` fires after each converged increment."""
    opts = solver.options
    history: list[IncrementRecord] = []
    lam = float(start_factor)
    dlam_nominal = 1.0 / opts.n_steps
    dlam = dlam_nominal
    bisections = 0
    while lam < 1.0 - 1e-12:
        target = min(lam + dlam, 1.0)
        u_try, ok, rec = solver._newton(u, target)
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
