"""Config 5 in small: domain-decomposed neo-Hookean block compression, one
process per shard with ring-hop halo exchange in assembly and PCG, dot
products summed over the shards, mixed precision and the two-level coarse
correction (counterpart of `examples/distributed_compression.py`).

    python -m fea_large_tpu_torch.examples.distributed_compression [shards]

On the card: one NCCL rank per card (all of them by default). With
FEA_PLATFORM=cpu: gloo ranks on the CPU (2 by default). The sharded result
is checked against the single-device solve (1e-6 of max |u|).
"""

import sys
import time

import numpy as np
import torch

from fea_large_tpu_torch import NeoHookean
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.config import task_device
from fea_large_tpu_torch.dist.launch import Problem, run_sharded, solve_rank
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions


def main(n_shards=None, device=None):
    t0 = time.perf_counter()
    device = task_device() if device is None else torch.device(device)
    if n_shards is None:
        n_shards = torch.cuda.device_count() if device.type == "cuda" else 2
    devices = [f"cuda:{i}" for i in range(n_shards)] if device.type == "cuda" \
        else ["cpu"] * n_shards
    mesh = box_mesh(12, 4, 4, lx=3.0, element_type="tet10", device="cpu")
    print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_elements} TET10, {mesh.n_dof} DOFs")
    mat = NeoHookean(1.0, 0.6)
    bc = DirichletBuilder(mesh).fix("xmin").prescribe("xmax", "x", -0.15).build()
    opts = SolverOptions(
        linear="pcg", n_steps=2, precision="mixed", preconditioner="two_level",
        agg_size=64, pcg_tol=1e-6, newton_rtol=1e-9, max_newton=60,
    )
    run = run_sharded(solve_rank, devices, Problem.of(mesh, mat, bc), opts)
    out = run.result
    mem = out["memory"]
    print(f"{len(devices)} ranks ({run.backend}) on {devices[0]}: {out['kind']}, "
          f"{mem['owned_nodes']} owned / {mem['halo_nodes']} halo nodes per shard (padded), "
          f"kmax={out['kmax']} ring hops", flush=True)
    res = out["runs"][0]
    print(f"converged: {res['converged']} in {time.perf_counter() - t0:.1f}s")
    for rec in res["history"]:
        print(f"  lam={rec['load_factor']:.2f} newton={rec['newton_iters']} "
              f"pcg={rec['pcg_iters']}")
    u = res["u"]

    # cross-check against the single-device solver
    mesh_d = box_mesh(12, 4, 4, lx=3.0, element_type="tet10", device=device)
    bc_d = DirichletBuilder(mesh_d).fix("xmin").prescribe("xmax", "x", -0.15).build()
    ref = NewtonSolver(mesh_d, mat, bc_d, options=opts).solve().u.cpu().numpy()
    err = np.abs(u - ref).max() / np.abs(ref).max()
    print(f"max relative difference vs single-device solve: {err:.2e}")
    assert res["converged"] and err < 1e-6
    print("OK")
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else None)
