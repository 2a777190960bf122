"""Config 2: neo-Hookean block compression (30%), TET10 5-tet box n^3,
block-Jacobi PCG on the assembled BCSR stiffness, 4 increments
(counterpart of `examples/block_compression.py`).

    python -m fea_large_tpu_torch.examples.block_compression [n]   (default 4)
"""

import sys
import time

import numpy as np
import torch

from fea_large_tpu_torch import NeoHookean
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.config import task_device
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions


def main(n=4, device=None):
    t0 = time.perf_counter()
    device = task_device() if device is None else torch.device(device)
    print(f"device: {device}", flush=True)
    mesh = box_mesh(n, n, n, element_type="tet10", device=device)
    print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_elements} TET10, {mesh.n_dof} DOFs")
    mat = NeoHookean(1.0, 0.6)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.3).build()
    solver = NewtonSolver(mesh, mat, bc,
                          options=SolverOptions(linear="pcg_bcsr", n_steps=4, pcg_tol=1e-12))
    res = solver.solve()
    print(f"converged: {res.converged}  total {time.perf_counter() - t0:.1f}s")
    for rec in res.history:
        print(f"  lam={rec.load_factor:.2f} newton={rec.newton_iters} "
              f"pcg={rec.pcg_iters} |R|end={rec.residual_norms[-1]:.2e}")
    u = res.u.cpu().numpy()
    print(f"max |u| = {np.abs(u).max():.4f}  (30% compression prescribed)")
    # volume is conserved only approximately: a barrel-shaped bulge
    assert res.converged
    assert u[:, 0].max() > 0.01  # lateral bulge
    print("OK")
    return res


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
