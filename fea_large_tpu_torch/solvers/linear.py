"""Dense Cholesky, preconditioned conjugate gradients and block-Jacobi
(counterpart of `fea_large_tpu/solvers/linear.py`).

Three forms of PCG:
  * `DevicePCGChunk` (the reference's `pcg_init` + `pcg_chunk`, a
    `lax.while_loop` whose condition lives on the device): every
    single-device CG of the solvers runs it (solvers/newton.py: the mixed
    step, `step_fn`, the host Newton loop's solves and its block-Jacobi
    fallback, the f64 BCSR and matrix-free steps). On the card one chunk
    of n iterations is one launch of a CUDA graph that runs the captured
    CG iteration under a WHILE node on `active`, then one batched fetch
    of (k, rr, ok, stop), and an f64 step's solve and its restart one
    launch and one fetch; on the CPU the same bodies run eagerly, a Python
    test of `active` in place of the WHILE node.
  * `DevicePCG`, `device_pcg_init`, `device_pcg_step`: the state and the
    bodies both the chunk and the device-resident Newton loop
    (solvers/device_loop.py, under nested WHILE and IF nodes) are made
    of. Every scalar of the recurrence, the stop test and the flags live
    in 0-d device tensors, updated in place (the addresses a captured
    graph reads stay fixed). The stop max(tol ||b||, atol) and the loop condition are
    formed in the vectors' dtype, f32 on the mixed path, as the
    reference's are.
  * `PCGState`, `pcg_init`, `pcg_chunk`: a host loop over device tensors
    that fetches (p.q, r.r) once per iteration and tests the stop in
    Python f64, for the sharded ranks only (dist/sharded.py: their dots
    are collectives, which a graph does not capture).
`drive_chunked_pcg` is the chunked control loop (restarts, best iterate,
budget) over either chunked form.
Self-dots are clamped at zero at the source (r.r, r.z and ||b|| are
non-negative by mathematics; a rounded negative would turn sqrt into NaN).
"""

from __future__ import annotations

import dataclasses
import math
import time

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
    tensors; rr, k, ok and stop are host values read by the control loop
    (the host loop's state, and the fetch of a `DevicePCGChunk`, whose
    vectors are then its buffers and whose bnorm is set)."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor  # 0-d, clamped r.z
    rr: float  # clamped r.r
    k: int  # iterations so far
    ok: bool  # no breakdown
    stop: float  # max(tol * ||b||, atol)
    bnorm: float | None = None  # clamped ||b|| (a chunk's fetch)


def pcg_init(matvec, b, preconditioner=None, x0=None, tol=1e-10, atol=0.0,
             dot=None) -> PCGState:
    """The host loop's `pcg_init` (the sharded ranks'; see the module
    docstring): ||b||, the stop and r0 . r0 fetched to the host."""
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
    breakdown); an exact continuation of the Krylov recurrence. The host
    loop: one fetch of (p.q > 0, r.r) per iteration and the stop test in
    Python f64. Only the sharded ranks run it (dist/sharded.py); every
    single-device solve runs `DevicePCGChunk`."""
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
    """Preconditioned CG on the host loop: `pcg_init`, then up to
    `maxiter` iterations (the solvers run `DevicePCGChunk`).
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


def device_pcg_init(s: DevicePCG, b, preconditioner, tol, cap, *, matvec=None, x0=None,
                    atol=0.0) -> None:
    """The reference's `pcg_init` into `s`: from x0 = 0 (r0 = b exactly, no
    product) or, given `x0` and `matvec`, from x0 with r0 = b - A x0 (`x0`
    may be `s.x` itself: the restart from the last iterate); z0 = p0 = M^-1
    r0, and the stop max(tol ||b||, atol) in b's dtype. `tol` and `cap` are
    0-d tensors (the forcing term and the iteration cap of this solve),
    `atol` a float."""
    if x0 is None:
        s.x.zero_()
        s.r.copy_(b)
    else:
        if x0 is not s.x:
            s.x.copy_(x0)
        s.r.copy_(b - matvec(s.x))
    s.z.copy_(preconditioner(s.r))
    s.p.copy_(s.z)
    s.rz.copy_(torch.clamp_min(_dot(s.r, s.z), 0.0))
    bb = torch.clamp_min(_dot(b, b), 0.0)
    s.rr.copy_(bb if x0 is None else torch.clamp_min(_dot(s.r, s.r), 0.0))
    s.bnorm.copy_(torch.sqrt(bb))
    s.stop.copy_(torch.clamp_min(tol * s.bnorm, atol))
    s.k.zero_()
    s.cap.copy_(cap)
    s.ok.fill_(True)
    _set_active(s)


def device_pcg_step(s: DevicePCG, matvec, preconditioner) -> None:
    """One CG iteration of `pcg_chunk`'s body on `s`, in place, then the
    loop condition for the next. The caller runs it only while `s.active`
    (a WHILE node in a graph, a Python test on the CPU)."""
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


class DevicePCGChunk:
    """The reference's `pcg_init` and `pcg_chunk` on one operator: a
    `DevicePCG` state, the right-hand side `b` and the 0-d `tol` and `n`
    in persistent tensors, and six bodies that update them in place:

      init0  `device_pcg_init` from zero      initx  from the state's own x
      arm    cap = k + n, the loop condition  step   one CG iteration
      fin    ok &= isfinite(rr): a non-finite r.r ends the loop as a
             breakdown, as the reference's `pcg_chunk` reports it
      keep   k1, ok1 = k, ok (the first run's) and n = max(n - k, 0)

    `start(b, tol, x0)` runs init0 or initx; `run(n)` runs arm, step while
    `active`, fin, then `fetch()`: ONE batched fetch of (k, rr, ok, stop,
    ||b||), the reference's per-chunk contract. `restart(b, tol, n)` is
    the reference's `_pcg_with_restart` in one launch: a run of n from
    zero, then one from its x with the rest of the budget (none where the
    first run used it all), then one fetch. The stop test is in the
    vectors' dtype on the device. `matvec` and `preconditioner` must read
    only tensors that outlive the chunk (the caller refreshes them in place
    between solves: a capture holds their addresses).

    On the card (`capture`, the default there) the bodies are warmed up
    once on a side stream and captured into CUDA graphs at construction,
    and four programs are composed of them (ops/cuda_graphs.py): init0,
    initx, run = arm -> WHILE(active) {step} -> fin, and restart = init0 ->
    run -> keep -> initx -> run. A chunk of n iterations, or a solve and
    its restart, is then one launch and one fetch. `capture=False` runs the
    bodies eagerly wherever the tensors are, with a Python test of `active`
    in place of the WHILE node (the CPU's route; on the card, a
    comparison). A failed capture or launch raises. `fetches` counts the
    fetches, `runs` (on the device) the runs of each body; the replays'
    kernel launches go to `cuda_graphs.REPLAYED` at each fetch."""

    BODIES = ("init0", "initx", "arm", "step", "fin", "keep")
    RUN = (("arm", None), ("step", "while"), ("fin", None))
    PROGRAMS = {"init0": (("init0", None),), "initx": (("initx", None),), "run": RUN,
                "restart": (("init0", None),) + RUN + (("keep", None), ("initx", None)) + RUN}

    def __init__(self, matvec, preconditioner, shape, dtype, device, *, capture=None, atol=0.0):
        self.device = torch.device(device)
        self.matvec, self.preconditioner, self.atol = matvec, preconditioner, float(atol)
        self.state = DevicePCG.zeros(shape, dtype, self.device)
        self.b = torch.zeros(shape, dtype=dtype, device=self.device)
        self.tol = torch.zeros((), dtype=dtype, device=self.device)
        self.n = torch.zeros((), dtype=torch.int64, device=self.device)
        self.k1 = torch.zeros((), dtype=torch.int64, device=self.device)
        self.ok1 = torch.zeros((), dtype=torch.bool, device=self.device)
        self.runs = torch.zeros(len(self.BODIES), dtype=torch.int64, device=self.device)
        self._seen = [0] * len(self.BODIES)
        self._bodies = self._make_bodies()
        self.fetches = 0
        self.capture_s = 0.0
        self.per_capture = {}
        self.graph_nodes = {}
        self._graphs = None
        if (self.device.type == "cuda") if capture is None else capture:
            self._capture()
            self.runs.zero_()  # the warm-up's runs were eager

    def _make_bodies(self) -> dict:
        # the bodies hold the tensors, not the chunk: no reference cycle, so
        # a chunk and its graphs go when its last reference does
        s, matvec, precond = self.state, self.matvec, self.preconditioner
        b, tol, n, runs, atol = self.b, self.tol, self.n, self.runs, self.atol
        k1, ok1 = self.k1, self.ok1

        def count(i):
            runs[i].add_(1)

        def init0():
            count(0)
            device_pcg_init(s, b, precond, tol, n, atol=atol)

        def initx():
            count(1)
            device_pcg_init(s, b, precond, tol, n, matvec=matvec, x0=s.x, atol=atol)

        def arm():
            count(2)
            s.cap.copy_(s.k + n)
            _set_active(s)

        def step():
            count(3)
            device_pcg_step(s, matvec, precond)

        def fin():
            count(4)
            s.ok.logical_and_(torch.isfinite(s.rr))

        def keep():
            count(5)
            k1.copy_(s.k)
            ok1.copy_(s.ok)
            n.copy_(torch.clamp_min(n - s.k, 0))

        return {"init0": init0, "initx": initx, "arm": arm, "step": step, "fin": fin,
                "keep": keep}

    def _capture(self) -> None:
        """Warm every body up once on a side stream, then capture each body
        and compose the programs."""
        from fea_large_tpu_torch.ops import cuda_graphs

        t0 = time.perf_counter()
        cuda_graphs.collect_garbage()
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for fn in self._bodies.values():
                    fn()
            current.wait_stream(side)
            torch.cuda.synchronize(self.device)
            bodies = {name: cuda_graphs.Body(fn) for name, fn in self._bodies.items()}
            self.per_capture = {name: b.launches for name, b in bodies.items()}
            active = cuda_graphs.While(self.state.active)
            self._graphs = {
                prog: cuda_graphs.Program([(bodies[body], None if cond is None else active)
                                           for body, cond in items])
                for prog, items in self.PROGRAMS.items()
            }
            self._kept = bodies  # the programs replay the bodies' graphs
            self.graph_nodes = {prog: g.nodes for prog, g in self._graphs.items()}
            torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0

    @property
    def captured(self) -> bool:
        return self._graphs is not None

    def _launch(self, prog: str) -> None:
        if self._graphs is not None:
            with torch.cuda.device(self.device):
                self._graphs[prog].launch()
            return
        for body, cond in self.PROGRAMS[prog]:
            if cond is None:
                self._bodies[body]()
            else:
                while bool(self.state.active):
                    self._bodies[body]()

    def start(self, b, tol, x0=None) -> None:
        """`pcg_init`: b (None: the last one) and the tolerance `tol` (a
        float, rounded to the vectors' dtype), from zero or from `x0`
        (which may be `state.x`). No fetch."""
        if b is not None:
            self.b.copy_(b)
        self.tol.fill_(tol)
        if x0 is None:
            self._launch("init0")
            return
        if x0 is not self.state.x:
            self.state.x.copy_(x0)
        self._launch("initx")

    def run(self, n: int) -> PCGState:
        """`pcg_chunk`: up to n further iterations (stops early on
        convergence or breakdown), then `fetch()`."""
        self.n.fill_(int(n))
        self._launch("run")
        return self.fetch()

    def restart(self, b, tol, n: int) -> tuple[int, bool, PCGState]:
        """The reference's `_pcg_with_restart` (solvers/newton.py there): up
        to n iterations from zero on b at `tol`, then one unconditional
        restart from their x with max(n - k1, 0) iterations, k1 the first
        run's; one launch and one fetch. Returns (k1, the first run's ok,
        the restart's state as `fetch()` gives it)."""
        self.b.copy_(b)
        self.tol.fill_(tol)
        self.n.fill_(int(n))
        self._launch("restart")
        st, k1, ok1 = self._fetch()
        return k1, ok1, st

    def fetch(self) -> PCGState:
        """The one batched fetch of (k, rr, ok, stop, ||b||) and the bodies'
        run counters: the state as `PCGState`, its vectors the chunk's
        buffers (valid until the next `start`)."""
        return self._fetch()[0]

    def _fetch(self) -> tuple[PCGState, int, bool]:
        s = self.state
        f64 = torch.float64
        scalars = (s.k, s.rr, s.ok, s.stop, s.bnorm, self.k1, self.ok1)
        vals = torch.cat([torch.stack([t.to(f64) for t in scalars]),
                          self.runs.to(f64)]).tolist()
        self.fetches += 1
        runs = [int(v) for v in vals[len(scalars):]]
        if self._graphs is not None:
            from fea_large_tpu_torch.ops import cuda_graphs

            cuda_graphs.tally(self.per_capture, {
                name: r - seen for name, r, seen in zip(self.BODIES, runs, self._seen)})
        self._seen = runs
        k, rr, ok, stop, bnorm, k1, ok1 = vals[:len(scalars)]
        return (PCGState(x=s.x, r=s.r, z=s.z, p=s.p, rz=s.rz, rr=rr, k=int(k), ok=ok > 0.0,
                         stop=stop, bnorm=bnorm), int(k1), ok1 > 0.0)


def drive_chunked_pcg(prepare, chunk, *, tol, chunk_iters, maxiter):
    """Chunked PCG control loop (the reference's `drive_chunked_pcg`).

    `prepare(x0)` (re)builds the Krylov state (x0=None: from zero);
    `chunk(st, n)` runs up to n further iterations.
      * up to 2 restarts on a rounding-level breakdown (rel <= 1e-2): the
        state is rebuilt from the best iterate with a fresh residual;
        an early breakdown at rel ~O(1) means an indefinite operator and
        is the caller's load-step-bisection case;
      * best-iterate tracking at chunk boundaries: the best iterate is
        returned when the final one is worse (NaN-safe). It is cloned when
        recorded: a `DevicePCGChunk` writes its x in place, so the state's
        x at a later boundary is the same tensor;
      * a chunk that runs no iteration ends the loop (the chunk's stop test
        in the vectors' dtype can pass where the host's f64 one does not:
        sqrt(rr) rounded to f32 equal to the stop).
    One fetch per chunk: `prepare` and `chunk` return the fetched state.
    Returns (x, total_iters, converged, rel); x may be the chunk's buffer,
    valid until its next `start`."""
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
            best = (rel, st.x.clone())
        if (st.ok and rnorm <= st.stop) or k >= maxiter:
            break
        if not st.ok:
            if restarts >= 2 or rel > 1e-2:
                break
            restarts += 1
            done_iters = k
            st = prepare(best[1])
            continue
        k_before = st.k
        st = chunk(st, min(chunk_iters, maxiter - k))
        if st.k == k_before and st.ok:
            rnorm = math.sqrt(st.rr)
            rel = rnorm / max(bnorm, 1e-300)
            break
    converged = st.ok and rnorm <= st.stop
    total = done_iters + st.k
    x = st.x
    if best is not None and not (rel <= best[0]):
        rel, x = best
    return x, total, converged, rel

