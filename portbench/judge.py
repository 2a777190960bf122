"""Whether the answers of a window are correct: each sampled answer judged
by the plain f64 reference (reference/), which reads the program's u only to
judge it.

The program's u is read by its node positions, which must map one to one
onto the benchmark's own mesh of the configuration (reference.mesh); the
reference then works out everything else itself: its mesh, quadrature,
material, prescribed values and the request's start state.

  increment  reduction: ||R(u)|| / ||R(u_start)||, with u's prescribed
             entries set to the reference's own values (a wrong prescribed
             value then shows as a residual at the boundary); limited by the
             configuration's newton_rtol, the tolerance the program is asked
             to converge to.
             r0_gap: |the program's claimed ||R(u_start)|| - the reference's|
             / the reference's: the program's f64 residual pass at the start.
  step       rel_lin: ||b - A du|| / ||b|| in f64, with du = u - u_start,
             b = R(u_start) and A = M K M + (I - M) the masked tangent
             system at u_start that the step solves (M the free mask).
A number that is not finite is over its limit.
"""

from __future__ import annotations

import math

import torch

from reference.fem import Problem
from reference.mesh import BoxMesh


def reference_problem(config: dict, device) -> Problem:
    m, mat = config["mesh"], config["material"]
    mesh = BoxMesh(m["kind"], m["n"], m.get("length", 1.0))
    return Problem(mesh, mat["lam"], mat["mu"], config["bc"], device)


def _worst(values) -> float:
    """The largest value; NaN if any is NaN (an answer that is not finite)."""
    out = 0.0
    for v in values:
        if v != v:
            return math.nan
        out = max(out, v)
    return out


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.norm(x))


def increment_numbers(prob: Problem, on_grid, samples) -> dict:
    reductions, gaps = [], []
    for s in samples:
        start = prob.affine_start(s["scale"])
        r0 = _norm(prob.residual(start))
        u = prob.impose(on_grid(s["u"]), s["scale"])
        reductions.append(_norm(prob.residual(u)) / r0)
        claimed = s["r0"]
        gaps.append(math.nan if claimed is None else abs(claimed - r0) / r0)
    return {"reduction": _worst(reductions), "r0_gap": _worst(gaps)}


def step_numbers(prob: Problem, on_grid, samples) -> dict:
    rels = []
    for s in samples:
        start = prob.affine_start(s["scale"])
        b = prob.residual(start)
        du = on_grid(s["u"]) - start
        Adu = prob.free * prob.tangent_apply(start, prob.free * du) + (1.0 - prob.free) * du
        rels.append(_norm(b - Adu) / _norm(b))
    return {"rel_lin": _worst(rels)}


NUMBERS = {"increment": increment_numbers, "step": step_numbers}


def limits(config: dict, kind: str) -> dict:
    """The limit of each number of a request kind: the configuration's own
    tolerance where it states one, else the configuration's `limits`."""
    out = dict(config["limits"][kind])
    if kind == "increment":
        out["reduction"] = config["solver"]["newton_rtol"]
    return out


def judge(config: dict, kind: str, samples: list, coords, device) -> dict:
    """{name: (value, limit)} over the sampled answers; `coords` are the
    program's node positions [N, 3] (host) that its u rows belong to."""
    prob = reference_problem(config, device)
    idx = torch.as_tensor(prob.mesh.locate(coords), device=device)

    def on_grid(u):
        g = prob.zeros()
        g[idx] = u.to(device=device, dtype=torch.float64)
        return g

    with torch.no_grad():
        values = NUMBERS[kind](prob, on_grid, samples)
    lim = limits(config, kind)
    return {name: (values[name], lim[name]) for name in values}


def within(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())
