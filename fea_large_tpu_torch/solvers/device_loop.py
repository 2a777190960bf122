"""The device-resident Newton loop of the mixed path (counterpart of the
reference's `_mixed_solve_fn`, fea_large_tpu/solvers/newton.py:517-689,
which runs a whole load increment as one XLA program).

Every quantity of the loop lives in persistent tensors on the solver's
device (`LoopState`): the iterate, the CG vectors and scalars
(`linear.DevicePCG`), the Newton scalars and flags, the counters, and the
per-iteration records `norms` and `cgs`, indexed with the device `it`.
Six bodies write them in place:

  pre      u += x (the previous direction), the f32 freeze (B2 / B7), and
           the residual gate use32 = it > 0 and ||R_prev|| > 3e-2 ||R0||
           under EW forcing (the reference's `use32`);
  resid32  the f32 residual from the frozen state (B4 / B8);
  resid64  the f64 residual (B5 / B9 where `resid_df` routes it, the
           plain f64 pass otherwise);
  post     norm0, the Newton stop, the flags conv, bad, skip and discard
           (the last allowed iteration: tol 1e30), the forcing
           (`newton.device_forcing`), block-Jacobi (B3, or the plain
           unstructured diagonal) and `device_pcg_init`, with CG capped at
           min(pcg_maxiter, budget - total CG);
  cg       one CG iteration (`device_pcg_step`: B1 / B6 and the
           preconditioner), which also updates the loop condition `active`;
  tail     rel, lin_ok, hit_budget, accept, failed, done and the forcing
           value handed on (eta is kept on a hand-back), as the
           reference's body ends.

They form one program, the reference's `while_loop(lambda c: ~c[9], ...)`
over a Newton iteration with the CG `while_loop` nested in it:

  solve = WHILE(running) {pre; IF(use32) resid32; IF(use64) resid64; post;
                          WHILE(active) cg; tail}

`running` is set before the launch (the flag is tested first, as the
reference's loop tests ~done) and `tail` writes ~done into it. `solve`
launches it once and makes one batched fetch of the results: no host
arithmetic and no host read enters the trajectory.

On the card each body is captured once per solver into a CUDA graph of
its own (ops/cuda_graphs.py) after one eager warm-up of every body on a
side stream and on a scratch state (which builds the kernel libraries and
runs both residual branches), and the program is composed from them with
nested WHILE and IF nodes. A failed capture, composition or launch raises:
no body runs eagerly on the card unless the loop is built with
`capture=False` (a comparison, never a fallback). On the CPU the same
bodies run eagerly, a Python `while` or `if` on each flag in place of its
node; that is the only difference between the routes.

The kernel wrappers count launches when they are called, that is at
warm-up here (a capture takes its counts back, ops/cuda_graphs.py);
`REPLAYED` counts what the graphs launch: the launches of each body's
capture times the runs of that body, which the bodies count on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from fea_large_tpu_torch.ops import cuda_graphs
from fea_large_tpu_torch.ops.soa import soa_diag_blocks, soa_freeze, soa_internal_force
from fea_large_tpu_torch.solvers.linear import (
    DevicePCG,
    device_pcg_init,
    device_pcg_step,
    jacobi_inverse_blocks,
)
from fea_large_tpu_torch.solvers.newton import (
    _mixed_matvec,
    _mixed_precond,
    _residual_df_fn,
    _residual_soa_fn,
    device_forcing,
)

#: the bodies in order, and the programs composed of them: chains of
#: (kind, flag, what), kind None (run once), "if" or "while" on the
#: `LoopState` bool `flag`, `what` a body or a chain; "solve" is the one the
#: solves launch, "head" (a Newton iteration up to `pcg_init`) and "cg" (a
#: CG run) are composed on first `replay` only (phase 6's timings)
BODIES = ("pre", "resid32", "resid64", "post", "cg", "tail")
HEAD = ((None, None, "pre"), ("if", "use32", "resid32"), ("if", "use64", "resid64"),
        (None, None, "post"))
CG = (("while", "active", "cg"),)
PROGRAMS = {
    "solve": (("while", "running", HEAD + CG + ((None, None, "tail"),)),),
    "head": HEAD,
    "cg": CG,
}

#: kernel launches made by replayed graphs (per capture x runs), by name:
#: the device loop's and the PCG chunks' (ops/cuda_graphs.py)
REPLAYED = cuda_graphs.REPLAYED


@dataclasses.dataclass
class DeviceLoopResult:
    """One device-loop solve (the reference's `_mixed_solve_fn` outputs):
    u, the residual norm and CG iterations of each of the n_iters Newton
    iterations run, the terminal flags, the forcing value handed on, the CG
    iterations in all, and the host fetches the solve made: one, the batched
    fetch of these (the eager route also reads each flag it tests)."""

    u: torch.Tensor
    residual_norms: list
    pcg_iters: list
    n_iters: int
    converged: bool
    failed: bool
    exhausted: bool
    poisoned: bool
    eta: float
    total_cg: int
    fetches: int


@dataclasses.dataclass
class LoopState:
    """The loop's tensors on one device (see the module docstring). `frozen`
    and `inv_blocks` are the outputs of `pre` and `post` (a captured body's
    outputs keep their addresses); every other field is written in place."""

    u: torch.Tensor  # f64 [N, 3]
    b: torch.Tensor  # f32 [N, 3]: the masked residual, the CG right-hand side
    pcg: DevicePCG
    scale: torch.Tensor  # f64 0-d load factor
    scale32: torch.Tensor
    norm: torch.Tensor  # f64 0-d
    norm0: torch.Tensor
    stop_n: torch.Tensor
    prev_norm: torch.Tensor
    eta: torch.Tensor
    eta_n: torch.Tensor
    it: torch.Tensor  # int64 0-d
    total_cg: torch.Tensor
    norms: torch.Tensor  # f64 [max_newton]
    cgs: torch.Tensor  # int64 [max_newton]
    use32: torch.Tensor  # bool 0-d
    use64: torch.Tensor
    conv: torch.Tensor
    bad: torch.Tensor
    skip: torch.Tensor
    failed: torch.Tensor
    exhausted: torch.Tensor
    done: torch.Tensor
    running: torch.Tensor  # the increment's loop condition, ~done after `tail`
    runs: torch.Tensor  # int64 [len(BODIES)]: runs of each body
    frozen: object = None
    inv_blocks: torch.Tensor | None = None

    @staticmethod
    def zeros(n_nodes: int, max_newton: int, device) -> "LoopState":
        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=device)

        f64, i64, b = torch.float64, torch.int64, torch.bool
        return LoopState(
            u=torch.zeros((n_nodes, 3), dtype=f64, device=device),
            b=torch.zeros((n_nodes, 3), dtype=torch.float32, device=device),
            pcg=DevicePCG.zeros((n_nodes, 3), torch.float32, device),
            scale=scalar(f64), scale32=scalar(torch.float32),
            **{k: scalar(f64) for k in ("norm", "norm0", "stop_n", "prev_norm", "eta", "eta_n")},
            it=scalar(i64), total_cg=scalar(i64),
            norms=torch.zeros(max_newton, dtype=f64, device=device),
            cgs=torch.zeros(max_newton, dtype=i64, device=device),
            **{k: scalar(b) for k in ("use32", "use64", "conv", "bad", "skip", "failed",
                                      "exhausted", "done", "running")},
            runs=torch.zeros(len(BODIES), dtype=i64, device=device),
        )

    def flag(self, name: str) -> torch.Tensor:
        return self.pcg.active if name == "active" else getattr(self, name)


class DeviceLoop:
    """The device loop of one `NewtonSolver` (mixed path): its state, its
    bodies and, on the card, their graphs (captured at construction unless
    `capture=False`, which runs the bodies eagerly on the card: a
    comparison). `solve(u0, scale)` runs one increment: one launch and one
    fetch on the card. `capture_s`, `graph_nodes` (of each program
    composed) and `per_capture` (each body's kernel launches) describe the
    capture;
    `last` (its `DeviceLoopResult`) and `runs` (of each body) the last
    solve. It is built for the solver's f64 residual route, coarse space,
    options, boundary conditions and load as they are at its first solve;
    where any of them changed since (`stale`), the solver builds a loop
    anew (`NewtonSolver._device_solve`), and `solve` refuses to run."""

    def __init__(self, solver, capture=None):
        self.solver = solver
        opts = solver.options
        self._fixed = self._inputs()
        self._resid64 = _residual_df_fn if solver._resid_df else _residual_soa_fn
        self.device = solver.mesh.device
        # CG iterations one solve may take in all: the option, or the
        # reference's rule for the budget of one device call
        self.budget = opts.device_loop_budget or max(
            50, min(1000, int(2.3e8 / max(solver.mesh.n_elements, 1))))
        self.max_newton = opts.max_newton
        self.free32 = solver.bc.free_mask.to(torch.float32)
        self.free32_T = self.free32.T.contiguous()
        self.f_ext32 = solver.f_ext.to(torch.float32)
        n = solver.mesh.n_nodes
        self.state = LoopState.zeros(n, opts.max_newton, self.device)
        self._graphs = None
        self.capture_s = 0.0
        self.graph_nodes = {}
        self.per_capture = {}
        if (self.device.type == "cuda") if capture is None else capture:
            self._capture(n)

    def _inputs(self) -> tuple:
        s = self.solver
        return (bool(s._resid_df), s._coarse, s.options, s.bc, s.f_ext)

    def stale(self) -> bool:
        """Whether any of the solver's inputs is no longer the object the
        loop was built with."""
        return any(a is not b for a, b in zip(self._inputs(), self._fixed))

    def _on_device(self):
        """The solver's card as the current CUDA device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- the bodies --------------------------------------------------------
    def _bodies(self, st: LoopState) -> dict:
        """The six bodies, bound to the state `st`."""
        s = self.solver
        opts = s.options
        use_ew = opts.forcing == "ew"
        soa, soa64, material, coarse = s._soa, s._soa64, s.material, s._coarse
        free32, free32_T = self.free32, self.free32_T

        def pre():
            st.runs[0].add_(1)
            st.u.add_(st.pcg.x.to(torch.float64))
            st.frozen = soa_freeze(soa, material, st.u.to(torch.float32).T.contiguous())
            use32 = (st.it > 0) & (st.prev_norm > 3e-2 * st.norm0)
            st.use32.copy_(use32 if use_ew else torch.zeros_like(use32))
            st.use64.copy_(~st.use32)

        def resid32():
            st.runs[1].add_(1)
            f_int_T = soa_internal_force(soa, st.frozen)
            b = (st.scale32 * self.f_ext32 - f_int_T.T) * free32
            st.b.copy_(b)
            st.norm.copy_(torch.linalg.norm(b).to(torch.float64))

        def resid64():
            st.runs[2].add_(1)
            b64, norm = self._resid64(st.u, st.scale, soa64, material, s.bc, s.f_ext)
            st.b.copy_(b64)
            st.norm.copy_(norm)

        def post():
            st.runs[3].add_(1)
            first = st.it == 0
            st.norm0.copy_(torch.where(first, st.norm, st.norm0))
            st.stop_n.copy_(torch.clamp_min(opts.newton_rtol * st.norm0, opts.newton_atol))
            st.norms.index_copy_(0, st.it.view(1), st.norm.view(1))
            st.bad.copy_(~torch.isfinite(st.norm))
            st.conv.copy_((st.norm <= st.stop_n) & ~st.bad)
            eta_n, lin_tol = device_forcing(
                st.norm, st.prev_norm, st.eta, first, opts.pcg_tol, use_ew, 1.2e-6, st.stop_n,
                opts.ew_eta_min)
            st.eta_n.copy_(eta_n)
            st.skip.copy_(st.conv | st.bad)
            # the last allowed iteration's direction could never be applied
            discard = (st.it + 1 >= self.max_newton) & ~st.skip
            tol = torch.where(st.skip | discard, 1e30, lin_tol).to(torch.float32)
            diag = soa_diag_blocks(soa, st.frozen).permute(2, 0, 1)
            st.inv_blocks = jacobi_inverse_blocks(diag, free32)
            cap = torch.clamp_max(self.budget - st.total_cg, opts.pcg_maxiter)
            device_pcg_init(st.pcg, st.b, _mixed_precond(st.inv_blocks, free32, coarse), tol, cap)

        def cg():
            st.runs[4].add_(1)
            device_pcg_step(
                st.pcg, lambda v: _mixed_matvec(soa, st.frozen, free32_T, v),
                _mixed_precond(st.inv_blocks, free32, coarse))

        def tail():
            st.runs[5].add_(1)
            p = st.pcg
            ok = p.ok & torch.isfinite(p.rr)
            st.total_cg.add_(p.k)
            rnorm = torch.sqrt(p.rr)
            rel = (rnorm / torch.clamp_min(p.bnorm, 1e-30)).to(torch.float64)
            lin_ok = ok & (rnorm <= p.stop)
            # out of this call's budget short of the tolerance (not of
            # pcg_maxiter): the host loop takes the solve over
            hit = ~st.skip & ~lin_ok & ok & (st.total_cg >= self.budget) & (p.k < opts.pcg_maxiter)
            accept = lin_ok | (rel <= 1e-3)
            failed = ~st.skip & ~accept & ~hit
            st.cgs.index_copy_(0, st.it.view(1), p.k.view(1))
            st.it.add_(1)
            st.done.copy_(st.skip | failed | hit | (st.it >= self.max_newton))
            st.eta.copy_(torch.where(hit | failed, st.eta, st.eta_n))
            st.prev_norm.copy_(st.norm)
            st.failed.copy_(failed)
            st.exhausted.copy_(hit)
            st.running.copy_(~st.done)

        return {"pre": pre, "resid32": resid32, "resid64": resid64, "post": post, "cg": cg,
                "tail": tail}

    # -- capture (card) ----------------------------------------------------
    def _capture(self, n_nodes: int) -> None:
        """Warm every body up once on a scratch state on a side stream, then
        capture each body and compose the solve program."""
        t0 = time.perf_counter()
        cuda_graphs.collect_garbage()
        with self._on_device():
            scratch = LoopState.zeros(n_nodes, self.max_newton, self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for fn in self._bodies(scratch).values():
                    fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            del scratch
            self._kept = {name: cuda_graphs.Body(fn) for name, fn in self._bodies(self.state).items()}
            self.per_capture = {name: body.launches for name, body in self._kept.items()}
            self._graphs = {}
            self._compose("solve")
            torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    def _items(self, chain) -> list:
        """`cuda_graphs.Program` items of a chain of `PROGRAMS`."""
        out = []
        for kind, flag, what in chain:
            what = self._kept[what] if isinstance(what, str) else self._items(what)
            cond = None if kind is None else self.state.flag(flag)
            out.append((what, cuda_graphs.While(cond) if kind == "while" else cond))
        return out

    def _compose(self, prog: str) -> None:
        self._graphs[prog] = cuda_graphs.Program(self._items(PROGRAMS[prog]))
        self.graph_nodes[prog] = self._graphs[prog].nodes

    # -- the host side -----------------------------------------------------
    def replay(self, prog: str) -> None:
        """Launch the captured program `prog` ("solve", "head" or "cg";
        composed at its first replay) on the card's current stream (the
        card only)."""
        if self._graphs is None:
            raise RuntimeError("the device loop has graphs on the card only")
        with self._on_device():
            if prog not in self._graphs:
                self._compose(prog)
            self._graphs[prog].launch()

    def _run_eager(self, chain, eager: dict) -> None:
        """A chain of `PROGRAMS` with its bodies run eagerly, a Python
        `while` or `if` on each flag in place of its node."""
        for kind, flag, what in chain:
            while kind is None or bool(self.state.flag(flag)):
                if isinstance(what, str):
                    eager[what]()
                else:
                    self._run_eager(what, eager)
                if kind != "while":
                    break

    def solve(self, u0: torch.Tensor, scale: float) -> DeviceLoopResult:
        """One increment from u0 at the load factor `scale`."""
        if self.stale():  # NewtonSolver._device_solve builds a new loop instead
            raise RuntimeError("the solver's inputs changed after its device loop was built")
        st = self.state
        st.u.copy_(self.solver.bc.impose(u0, scale))
        st.pcg.x.zero_()
        st.scale.fill_(scale)
        st.scale32.fill_(scale)
        for t in (st.it, st.total_cg, st.norms, st.cgs, st.runs):
            t.zero_()
        st.prev_norm.fill_(1.0)
        st.eta.fill_(0.5)
        st.norm0.fill_(1.0)
        for t in (st.done, st.conv, st.bad, st.failed, st.exhausted):
            t.fill_(False)
        st.running.fill_(True)
        if self._graphs is not None:
            self.replay("solve")
        else:
            self._run_eager(PROGRAMS["solve"], self._bodies(st))
        f64 = torch.float64
        flags = torch.stack([t.to(f64) for t in (st.it, st.conv, st.failed, st.exhausted, st.bad,
                                                 st.eta, st.total_cg)])
        vals = torch.cat([st.norms, st.cgs.to(f64), flags, st.runs.to(f64)]).tolist()
        m = self.max_newton
        n_it, conv, failed, exhausted, bad, eta, total = vals[2 * m: 2 * m + 7]
        runs = dict(zip(BODIES, (int(v) for v in vals[2 * m + 7:])))
        cuda_graphs.tally(self.per_capture, runs)
        self.runs = runs
        n_it = int(n_it)
        self.last = DeviceLoopResult(
            u=st.u.clone(), residual_norms=vals[:n_it], pcg_iters=[int(v) for v in vals[m:m + n_it]],
            n_iters=n_it, converged=bool(conv), failed=bool(failed), exhausted=bool(exhausted),
            poisoned=bool(bad), eta=eta, total_cg=int(total), fetches=1)
        return self.last
