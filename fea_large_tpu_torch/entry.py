"""Entry points of the port (counterpart of the repository root's
`__graft_entry__.py`).

`entry(device=None)` returns (fn, args): one Newton step u -> u' of the
flagship problem (a TET10 box 4^3, neo-Hookean (1.0, 0.6), zmin fixed,
zmax pushed -0.2 in z; the f64 matrix-free route, block-Jacobi PCG at
pcg_tol 1e-10) through `NewtonSolver.step_fn`, and its arguments (u = 0,
load factor 1). The device is the card unless `device` or FEA_PLATFORM=cpu
asks for the CPU; without CUDA the card raises (no fallback).

`dryrun_multichip(n)`, `dryrun_multichip_large` and
`dryrun_structured_large` are the sharded dry runs of dist/dryrun.py.

    python -m fea_large_tpu_torch.entry [n]   (default 2 shards)

runs fn(*args), prints its shape and dtype, then `dryrun_multichip(n)`.
"""

from __future__ import annotations

import sys

import torch

from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.config import as_device, task_device
from fea_large_tpu_torch.dist.dryrun import (  # noqa: F401
    dryrun_multichip,
    dryrun_multichip_large,
    dryrun_structured_large,
)
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions


def entry(device=None):
    """(fn, args): fn(u, scale) is one f64 Newton step u -> u' of the
    flagship TET10 neo-Hookean problem; args = (zeros [N, 3] f64, 1.0)."""
    dev = task_device() if device is None else as_device(device)
    mesh = box_mesh(4, 4, 4, element_type="tet10", device=dev)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.2).build()
    solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                          options=SolverOptions(linear="pcg", pcg_tol=1e-10, pcg_maxiter=500))

    def newton_step(u, scale):
        return solver.step_fn(u, scale)[0]

    u0 = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64, device=dev)
    return newton_step, (u0, 1.0)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    fn, args = entry()
    out = fn(*args)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    print(f"entry(): ran, out shape {tuple(out.shape)} dtype {out.dtype}")
    dryrun_multichip(n)
