"""Config 1: uniaxial tension of a unit cube, St. Venant-Kirchhoff, TET4
6^3, one load step, dense direct solve (counterpart of
`examples/uniaxial_tension.py`).

    python -m fea_large_tpu_torch.examples.uniaxial_tension

Prints the convergence table and checks the physics: the prescribed
top-face stretch, the Poisson lateral contraction, and convergence.
"""

import time

import torch

from fea_large_tpu_torch import StVenantKirchhoff
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.config import task_device
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions


def main(device=None):
    t0 = time.perf_counter()
    device = task_device() if device is None else torch.device(device)
    print(f"device: {device}", flush=True)
    mesh = box_mesh(6, 6, 6, element_type="tet4", device=device)
    print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_elements} TET4 elements, {mesh.n_dof} DOFs",
          flush=True)
    mat = StVenantKirchhoff(1.2, 0.8)
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", 0.2).build()
    solver = NewtonSolver(mesh, mat, bc, options=SolverOptions(linear="direct"))
    print(f"setup: {time.perf_counter() - t0:.1f}s", flush=True)

    res = solver.solve()
    print(f"converged: {res.converged}  total {time.perf_counter() - t0:.1f}s")
    for rec in res.history:
        norms = " -> ".join(f"{n:.3e}" for n in rec.residual_norms)
        print(f"  lam={rec.load_factor:.3f} newton={rec.newton_iters}  |R|: {norms}")

    u = res.u.cpu().numpy()
    top = u[mesh.node_sets["zmax"]]
    print(f"top-face uz (prescribed 0.2): mean={top[:, 2].mean():.6f}")
    print(f"lateral contraction ux: [{u[:, 0].min():.4f}, {u[:, 0].max():.4f}]")
    assert res.converged
    assert abs(top[:, 2].mean() - 0.2) < 1e-12
    assert u[:, 0].min() < -1e-3 and u[:, 0].max() > 1e-3  # Poisson effect
    print("OK")
    return res


if __name__ == "__main__":
    main()
