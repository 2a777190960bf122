"""The check's control and the faults it must catch, planted in the program
for a run; not used by the benchmark's own runs.

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds 1,2,3 --seconds 5

prints, for each seed, the numbers the check compares and whether the run
would be correct, from one process that sets the cell up once. Modes:

  sound      the program as it is (the lower readings of the limits);
  control    the nearest lower precision, as the program's own paths give
             it: increments compute every f64 residual in f32 (the f32
             element pass of the resid32 path, for every Newton
             iteration); steps round the frozen tangent state (F, S, A,
             alpha, beta) to bf16;
  unchanged  a request returns its start state;
  half       half of the work left out: the second half of the nodes'
             residual rows set to zero (increments: every f64 residual;
             steps: the right-hand side);
  altered    the answer altered where it is produced: one free node's u_z
             moved by 1e-3 of the answer's largest entry;
  exchange   (cells over several cards) the exchange between the cards
             left out: the boundary-plane hops of the sharded solver's
             gather and reduce (the fixed-order sums stay, so the ranks
             still agree on every flag).

On a cell over several cards every mode is planted inside each rank
(`rank_patched`): the control computes the f64 residual of the rank
bodies (`_residual64`, in `head` and `resid`) by the f32 element pass;
`half` zeroes the second half of each rank's residual rows; `unchanged`
and `altered` act on `_newton`'s answer (altered: on rank 0's part).
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
from fea_large_tpu_torch.ops.soa import soa_freeze, soa_internal_force  # noqa: E402
from fea_large_tpu_torch.solvers import device_loop, newton  # noqa: E402
from fea_large_tpu_torch.solvers.newton import NewtonSolver  # noqa: E402

MODES = ("sound", "control", "unchanged", "half", "altered", "exchange")


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


def _residual_patches(wrap):
    """Every f64 residual of the Newton loops (device and host) through
    wrap(original) -> replacement."""
    return [(m, name, wrap(getattr(m, name))) for m in (device_loop, newton)
            for name in ("_residual_df_fn", "_residual_soa_fn")]


def _f32_residual(f32: dict):
    """The f64 residual computed by the f32 element pass of the solver whose
    f64 SoA problem it is given (`f32`: id of the f64 problem -> the f32)."""
    def wrap(original):
        def residual(u, scale, soa64, material, bc, f_ext):
            soa32 = f32[id(soa64)]
            state = soa_freeze(soa32, material, u.to(torch.float32).T.contiguous())
            r = bc.project(scale * f_ext - soa_internal_force(soa32, state).T.to(torch.float64))
            return r, torch.linalg.norm(r)
        return residual
    return wrap


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
def patched(mode: str, kind: str):
    """A context manager that plants `mode` in the program for requests of
    `kind` ("increment" or "step"): in this process, and on the ranks of a
    cell over several cards (`sharded.MODE`)."""
    with _patched((sharded, "MODE", mode)), _here(mode, kind):
        yield


def _here(mode: str, kind: str):
    """`mode` planted in this process's program (none for "exchange": one
    card exchanges nothing)."""
    if mode in ("sound", "exchange"):
        return contextlib.nullcontext()
    init, newton_fn, step_fn = NewtonSolver.__init__, NewtonSolver._newton, NewtonSolver.step_fn
    prepare, freeze = NewtonSolver._mixed_prepare, NewtonSolver._freeze
    if mode == "control" and kind == "increment":
        f32 = {}

        def init_keep(self, *args, **kwargs):
            init(self, *args, **kwargs)
            f32[id(self._soa64)] = self._soa
        return _patched((NewtonSolver, "__init__", init_keep),
                        *_residual_patches(_f32_residual(f32)))
    if mode == "control":
        def freeze_bf16(self, u):
            st = freeze(self, u)
            return dataclasses.replace(st, **{f: getattr(st, f).to(torch.bfloat16).float()
                                              for f in ("F", "S", "A", "alpha", "beta")})
        return _patched((NewtonSolver, "_freeze", freeze_bf16))
    if mode == "unchanged" and kind == "increment":
        def newton_same(self, u, scale):
            _, ok, rec = newton_fn(self, u, scale)
            return u, ok, rec
        return _patched((NewtonSolver, "_newton", newton_same))
    if mode == "unchanged":
        def step_same(self, u, scale):
            _, k, ok, r = step_fn(self, u, scale)
            return u, k, ok, r
        return _patched((NewtonSolver, "step_fn", step_same))
    if mode == "half" and kind == "increment":
        return _patched(*_residual_patches(_half_residual))
    if mode == "half":
        def prepare_half(self, u, scale, r64=None):
            chunk, b = prepare(self, u, scale, r64)
            return chunk, _half_rows(b)
        return _patched((NewtonSolver, "_mixed_prepare", prepare_half))
    if mode == "altered" and kind == "increment":
        def newton_altered(self, u, scale):
            u, ok, rec = newton_fn(self, u, scale)
            return _alter(u), ok, rec
        return _patched((NewtonSolver, "_newton", newton_altered))
    if mode == "altered":
        def step_altered(self, u, scale):
            u, k, ok, r = step_fn(self, u, scale)
            return _alter(u), k, ok, r
        return _patched((NewtonSolver, "step_fn", step_altered))
    raise ValueError(f"unknown mode {mode!r}")


def rank_patched(mode: str):
    """A context manager that plants `mode` in a rank's sharded solver (the
    module docstring), before the rank builds it: its captured graphs then
    hold what is planted."""
    from fea_large_tpu_torch.dist.sharded import ShardedNewtonSolver
    from fea_large_tpu_torch.dist.structured_solver import StructuredShardedSolver

    newton_fn, residual = ShardedNewtonSolver._newton, ShardedNewtonSolver._residual64
    if mode == "control":
        def residual32(self, u, scale):
            d, p32 = self.data, self.soa.p32
            state = soa_freeze(p32, self.material,
                               self._expand_u(u).to(torch.float32).T.contiguous())
            f = self._assemble(soa_internal_force(p32, state).T.to(torch.float64))
            return (scale * d.f_ext - f) * d.free_mask
        return _patched((ShardedNewtonSolver, "_residual64", residual32))
    if mode == "unchanged":
        def newton_same(self, u, scale):
            _, ok, rec = newton_fn(self, u, scale)
            return u, ok, rec
        return _patched((ShardedNewtonSolver, "_newton", newton_same))
    if mode == "half":
        def residual_half(self, u, scale):
            return _half_rows(residual(self, u, scale))
        return _patched((ShardedNewtonSolver, "_residual64", residual_half))
    if mode == "altered":
        def newton_altered(self, u, scale):
            u, ok, rec = newton_fn(self, u, scale)
            return (_alter(u) if self.comm.rank == 0 else u), ok, rec
        return _patched((ShardedNewtonSolver, "_newton", newton_altered))
    if mode == "exchange":
        return _patched((StructuredShardedSolver, "_gather", lambda self, x: x),
                        (StructuredShardedSolver, "_reduce_gather", lambda self, y: y))
    raise ValueError(f"unknown mode {mode!r}")


def readings(workload: str, mode: str, seeds, seconds: float, device=None,
             overrides: dict | None = None) -> list:
    """[(seed, correct, {name: (value, limit)})] of short windows of the
    cell with `mode` planted, the cell set up once."""
    cell = harness.Cell(HERE.parent, workload, overrides)
    device = harness.card(cell.workload["chips"]) if device is None else torch.device(device)
    if cell.config.get("ranks", 1) > 1:
        with patched(mode, cell.kind):
            served = sharded.serve(cell, device, seeds, seconds, False, time.perf_counter())
        return [(seed, sum(not r["ok"] for r in w.records) == 0 and judge.within(w.numbers),
                 w.numbers, len(w.records), sum(not r["ok"] for r in w.records))
                for seed, w in zip(seeds, served)]
    if mode == "exchange":
        raise ValueError(f"{workload} runs on one card: it has no exchange to leave out")
    out = []
    with patched(mode, cell.kind):
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
