"""Config 3: a cantilever beam (TET4 10x2x2 over 5 x 1 x 1, St.
Venant-Kirchhoff E=100, nu=0.3) bent by an end load in 5 increments, f64
matrix-free PCG, with convergence tracking per increment (counterpart of
`examples/beam_bending.py`).

    python -m fea_large_tpu_torch.examples.beam_bending
"""

import time

import torch

from fea_large_tpu_torch import StVenantKirchhoff
from fea_large_tpu_torch.bc import DirichletBuilder, nodal_forces
from fea_large_tpu_torch.config import task_device
from fea_large_tpu_torch.mesh.generators import box_mesh
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions


def main(device=None):
    t0 = time.perf_counter()
    device = task_device() if device is None else torch.device(device)
    print(f"device: {device}", flush=True)
    mesh = box_mesh(10, 2, 2, lx=5.0, element_type="tet4", device=device)
    mat = StVenantKirchhoff(57.7, 38.5)  # E=100, nu=0.3
    bc = DirichletBuilder(mesh).fix("xmin").build()
    f = nodal_forces(mesh, {"xmax": [0.0, 0.0, -0.15]})
    solver = NewtonSolver(mesh, mat, bc, f_ext=f,
                          options=SolverOptions(linear="pcg", n_steps=5, pcg_tol=1e-12))
    res = solver.solve()
    print(f"converged: {res.converged}  total {time.perf_counter() - t0:.1f}s")
    print("convergence tracking (per increment):")
    for rec in res.history:
        norms = " -> ".join(f"{x:.2e}" for x in rec.residual_norms)
        print(f"  lam={rec.load_factor:.2f} newton={rec.newton_iters}  |R|: {norms}")
    tip = res.u.cpu().numpy()[mesh.node_sets["xmax"]]
    print(f"tip deflection: mean uz = {tip[:, 2].mean():.4f}")
    assert res.converged and tip[:, 2].mean() < -0.05
    print("OK")
    return res


if __name__ == "__main__":
    main()
