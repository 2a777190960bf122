"""The check's control and the faults it must catch, planted in the program
for a run; not used by the benchmark's own runs.

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds 1,2,3 --seconds 5

prints, for each seed, the numbers the check compares and whether the run
would be correct, from one process that sets the cell up once. Modes:

  sound      the program as it is (the lower readings of the limits);
  control    the nearest lower precision, as the program's own paths give
             it: increments compute every f64 residual in f32, for every
             Newton iteration (the mixed route: the f32 SoA element pass
             of the resid32 path; the f64 routes, `pcg_bcsr`, `pcg` and
             `direct`: their own element pass with u, the element
             geometry and the material's arithmetic in f32); steps of the
             mixed route round the frozen tangent state (F, S, A, alpha,
             beta) to bf16;
  unchanged  a request returns its start state;
  half       half of the work left out: the second half of the nodes'
             residual rows set to zero (increments: every f64 residual;
             steps of the mixed route: the right-hand side);
  altered    the answer altered where it is produced: one free node's u_z
             moved by 1e-3 of the answer's largest entry;
  exchange   (cells over several cards) the exchange between the cards
             left out: the boundary-plane hops of the sharded solver's
             gather and reduce (the fixed-order sums stay, so the ranks
             still agree on every flag).

A step of an f64 route has no frozen f32 state and no mixed set-up:
`control` and `half` there raise a ValueError that names the route. Every
replacement a mode sets counts its calls, and a run in which none of them
was called raises `NotPlanted` at the end of the `patched` block (on a
cell over several cards, in each rank): a fault that planted nothing
cannot read as caught.

On a cell over several cards every mode is planted inside each rank
(`rank_patched`), and nothing in this process: the control computes the
f64 residual of the rank bodies (`_residual64`, in `head` and `resid`) by
the f32 element pass; `half` zeroes the second half of each rank's
residual rows; `unchanged` and `altered` act on `_newton`'s answer
(altered: on rank 0's part).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import generator  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402
import sharded  # noqa: E402
from fea_large_tpu_torch.elements.kernels import (  # noqa: E402
    ElementGeometry, element_internal_force)
from fea_large_tpu_torch.ops.soa import soa_freeze, soa_internal_force  # noqa: E402
from fea_large_tpu_torch.solvers import device_loop, newton  # noqa: E402
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions  # noqa: E402

MODES = ("sound", "control", "unchanged", "half", "altered", "exchange")
#: the f64 residuals of the mixed route's Newton loops (device and host)
MIXED_RESIDUALS = [(m, name) for m in (device_loop, newton)
                   for name in ("_residual_df_fn", "_residual_soa_fn")]
#: the f64 residual of the f64 routes' Newton loop (`NewtonSolver._residual`)
F64_RESIDUAL = (newton, "_residual_fn")


class NotPlanted(RuntimeError):
    """A mode none of whose replacements was called during the run."""


@contextlib.contextmanager
def _patched(*triples):
    """Set (owner, attribute, value) for the block, then restore."""
    saved = [(o, a, getattr(o, a)) for o, a, _ in triples]
    try:
        for o, a, v in triples:
            setattr(o, a, v)
        yield
    finally:
        for o, a, v in saved:
            setattr(o, a, v)


@contextlib.contextmanager
def _planted(what: str, plants, keep=()):
    """`_patched` of `plants` and `keep`, each replacement of `plants`
    counting its calls; raises `NotPlanted` at the block's end where none
    was called."""
    calls = {f"{getattr(o, '__name__', o)}.{a}": 0 for o, a, _ in plants}

    def counted(key, replacement):
        def call(*args, **kwargs):
            calls[key] += 1
            return replacement(*args, **kwargs)
        return call

    with _patched(*keep, *[(o, a, counted(key, v)) for (o, a, v), key in zip(plants, calls)]):
        yield
    if not any(calls.values()):
        raise NotPlanted(f"{what}: none of {', '.join(calls)} was called")


def route(config: dict) -> str:
    """The route of `NewtonSolver` that the configuration's options run:
    "mixed", or "f64 <linear>" ("f64 pcg_bcsr", "f64 pcg", "f64 direct")."""
    opts = SolverOptions(**config["solver"])
    return "mixed" if opts.precision == "mixed" else f"f64 {opts.linear}"


def _f32_soa_residual(f32: dict):
    """The mixed route's f64 residual computed by the f32 element pass of
    the solver whose f64 SoA problem it is given (`f32`: id of the f64
    problem -> the f32)."""
    def residual(u, scale, soa64, material, bc, f_ext):
        soa32 = f32[id(soa64)]
        state = soa_freeze(soa32, material, u.to(torch.float32).T.contiguous())
        r = bc.project(scale * f_ext - soa_internal_force(soa32, state).T.to(torch.float64))
        return r, torch.linalg.norm(r)
    return residual


def _f32_element_residual(f32: dict):
    """The f64 routes' residual computed by their element pass in f32: u,
    the element geometry and the material's arithmetic in f32, the nodal
    sum too, the result returned in f64. The f32 geometry is made once a
    solver (`f32`: id of the f64 geometry -> (it, the f32))."""
    def residual(u, scale, conn, geom, material, bc, f_ext, scatter):
        if id(geom) not in f32:
            f32[id(geom)] = (geom, ElementGeometry(*(t.to(torch.float32) for t in geom)))
        fe = element_internal_force(u.to(torch.float32)[conn], f32[id(geom)][1], material)
        r = bc.project(scale * f_ext - scatter(fe).to(torch.float64))
        return r, torch.linalg.norm(r)
    return residual


def _half_rows(x):
    n = x.shape[0]
    return torch.cat([x[: n // 2], torch.zeros_like(x[n // 2:])])


def _half_residual(original):
    def residual(*args):
        r, _ = original(*args)
        r = _half_rows(r)
        return r, torch.linalg.norm(r)
    return residual


def _alter(u):
    u = u.clone()
    u[u.shape[0] // 2, 2] += 1e-3 * float(u.abs().max())
    return u


@contextlib.contextmanager
def patched(mode: str, cell):
    """A context manager that plants `mode` in the program for a run of
    `cell` (a `harness.Cell`): inside each rank of a cell over several
    cards (`sharded.MODE`, `rank_patched`), else in this process. Raises
    ValueError where the cell's requests and route cannot take the mode,
    and `NotPlanted` where none of its replacements was called."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if cell.config.get("ranks", 1) > 1:
        with _patched((sharded, "MODE", mode)):
            yield
        return
    with _here(mode, cell.kind, route(cell.config)):
        yield


def _here(mode: str, kind: str, route_name: str):
    """`mode` planted in this process's program for requests of `kind`
    ("increment" or "step") on the route `route_name` (`route`)."""
    if mode == "sound":
        return contextlib.nullcontext()
    what = f"{mode} on the {kind}s of the {route_name} route"
    if mode == "exchange":
        raise ValueError(f"{what}: one card has no exchange to leave out")
    mixed = route_name == "mixed"
    if kind == "step" and mode in ("control", "half") and not mixed:
        raise ValueError(f"{what}: a step there has no f32 tangent state to round and no "
                         f"mixed set-up to halve; nothing would be planted")
    init, newton_fn, step_fn = NewtonSolver.__init__, NewtonSolver._newton, NewtonSolver.step_fn
    prepare, freeze = NewtonSolver._mixed_prepare, NewtonSolver._freeze
    residuals = MIXED_RESIDUALS if mixed else [F64_RESIDUAL]
    if mode == "control" and kind == "increment" and mixed:
        f32 = {}

        def init_keep(self, *args, **kwargs):
            init(self, *args, **kwargs)
            if hasattr(self, "_soa64"):
                f32[id(self._soa64)] = self._soa
        return _planted(what, [(m, n, _f32_soa_residual(f32)) for m, n in residuals],
                        keep=[(NewtonSolver, "__init__", init_keep)])
    if mode == "control" and kind == "increment":
        return _planted(what, [(*F64_RESIDUAL, _f32_element_residual({}))])
    if mode == "control":
        def freeze_bf16(self, u):
            st = freeze(self, u)
            return dataclasses.replace(st, **{f: getattr(st, f).to(torch.bfloat16).float()
                                              for f in ("F", "S", "A", "alpha", "beta")})
        return _planted(what, [(NewtonSolver, "_freeze", freeze_bf16)])
    if mode == "unchanged" and kind == "increment":
        def newton_same(self, u, scale):
            _, ok, rec = newton_fn(self, u, scale)
            return u, ok, rec
        return _planted(what, [(NewtonSolver, "_newton", newton_same)])
    if mode == "unchanged":
        def step_same(self, u, scale):
            _, k, ok, r = step_fn(self, u, scale)
            return u, k, ok, r
        return _planted(what, [(NewtonSolver, "step_fn", step_same)])
    if mode == "half" and kind == "increment":
        return _planted(what, [(m, n, _half_residual(getattr(m, n))) for m, n in residuals])
    if mode == "half":
        def prepare_half(self, u, scale, r64=None):
            chunk, b = prepare(self, u, scale, r64)
            return chunk, _half_rows(b)
        return _planted(what, [(NewtonSolver, "_mixed_prepare", prepare_half)])
    if mode == "altered" and kind == "increment":
        def newton_altered(self, u, scale):
            u, ok, rec = newton_fn(self, u, scale)
            return _alter(u), ok, rec
        return _planted(what, [(NewtonSolver, "_newton", newton_altered)])
    def step_altered(self, u, scale):
        u, k, ok, r = step_fn(self, u, scale)
        return _alter(u), k, ok, r
    return _planted(what, [(NewtonSolver, "step_fn", step_altered)])


def rank_patched(mode: str):
    """A context manager that plants `mode` in a rank's sharded solver (the
    module docstring), before the rank builds it: its captured graphs then
    hold what is planted. Each rank raises `NotPlanted` at the block's end
    where none of the mode's replacements was called there (a replacement
    inside a captured graph is called at its capture)."""
    from fea_large_tpu_torch.dist.sharded import ShardedNewtonSolver
    from fea_large_tpu_torch.dist.structured_solver import StructuredShardedSolver

    newton_fn, residual = ShardedNewtonSolver._newton, ShardedNewtonSolver._residual64
    what = f"{mode} on a rank"
    if mode == "control":
        def residual32(self, u, scale):
            d, p32 = self.data, self.soa.p32
            state = soa_freeze(p32, self.material,
                               self._expand_u(u).to(torch.float32).T.contiguous())
            f = self._assemble(soa_internal_force(p32, state).T.to(torch.float64))
            return (scale * d.f_ext - f) * d.free_mask
        return _planted(what, [(ShardedNewtonSolver, "_residual64", residual32)])
    if mode == "unchanged":
        def newton_same(self, u, scale):
            _, ok, rec = newton_fn(self, u, scale)
            return u, ok, rec
        return _planted(what, [(ShardedNewtonSolver, "_newton", newton_same)])
    if mode == "half":
        def residual_half(self, u, scale):
            return _half_rows(residual(self, u, scale))
        return _planted(what, [(ShardedNewtonSolver, "_residual64", residual_half)])
    if mode == "altered":
        def newton_altered(self, u, scale):
            u, ok, rec = newton_fn(self, u, scale)
            return (_alter(u) if self.comm.rank == 0 else u), ok, rec
        return _planted(what, [(ShardedNewtonSolver, "_newton", newton_altered)])
    if mode == "exchange":
        return _planted(what, [(StructuredShardedSolver, "_gather", lambda self, x: x),
                               (StructuredShardedSolver, "_reduce_gather", lambda self, y: y)])
    raise ValueError(f"unknown mode {mode!r}")


def readings(workload: str, mode: str, seeds, seconds: float, device=None,
             overrides: dict | None = None) -> list:
    """[(seed, correct, {name: (value, limit)})] of short windows of the
    cell with `mode` planted, the cell set up once."""
    cell = harness.Cell(HERE.parent, workload, overrides)
    device = harness.card(cell.workload["chips"]) if device is None else torch.device(device)
    if cell.config.get("ranks", 1) > 1:
        with patched(mode, cell):
            served = sharded.serve(cell, device, seeds, seconds, False, time.perf_counter())
        return [(seed, sum(not r["ok"] for r in w.records) == 0 and judge.within(w.numbers),
                 w.numbers, len(w.records), sum(not r["ok"] for r in w.records))
                for seed, w in zip(seeds, served)]
    out = []
    with patched(mode, cell):
        sys_ = harness.prepare(cell, device)
        coords = sys_.coords()
        for seed in seeds:
            amps = generator.amplitudes(cell.mix, seed)
            records, samples, _, _ = harness.serve(sys_, cell, amps, seed, seconds)
            numbers = judge.judge(cell.config, cell.kind, samples, coords, device)
            failed = sum(not r["ok"] for r in records)
            out.append((seed, failed == 0 and judge.within(numbers), numbers, len(records),
                        failed))
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=MODES, required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    for seed, correct, numbers, attempted, failed in readings(args.workload, args.mode, seeds,
                                                              args.seconds):
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": correct, "attempted": attempted, "failed": failed,
                          "numbers": {k: v for k, (v, _) in numbers.items()}}), flush=True)
    print(f"{args.workload} {args.mode}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
