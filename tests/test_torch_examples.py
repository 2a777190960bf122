"""PyTorch port: the examples (`fea_large_tpu_torch/examples/`) against the
reference's `examples/*.py`.

Each runs as `python -m fea_large_tpu_torch.examples.<name>` on the CPU
(FEA_PLATFORM=cpu), exits 0 and prints `OK`; called in-process, its u
matches the reference package's solve of the same problem within 1e-10 of
max|u| (both f64), in the reference's increments and Newton counts.
Without CUDA and without FEA_PLATFORM=cpu an example fails (no fallback).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
from fea_large_tpu.bc import nodal_forces as ref_nodal_forces
from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
from fea_large_tpu.materials.svk import StVenantKirchhoff as RefSVK
from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

from fea_large_tpu_torch.examples import beam_bending, block_compression, uniaxial_tension

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
U_BOUND = 1e-10


def _uniaxial():
    mesh = ref_box_mesh(6, 6, 6, element_type="tet4")
    bc = RefDirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", 0.2).build()
    return RefNewtonSolver(mesh, RefSVK(jnp.asarray(1.2), jnp.asarray(0.8)), bc,
                           options=RefOptions(linear="direct")).solve()


def _beam():
    mesh = ref_box_mesh(10, 2, 2, lx=5.0, element_type="tet4")
    bc = RefDirichletBuilder(mesh).fix("xmin").build()
    f = ref_nodal_forces(mesh, {"xmax": [0.0, 0.0, -0.15]})
    return RefNewtonSolver(mesh, RefSVK(jnp.asarray(57.7), jnp.asarray(38.5)), bc, f_ext=f,
                           options=RefOptions(linear="pcg", n_steps=5, pcg_tol=1e-12)).solve()


def _block():
    mesh = ref_box_mesh(4, 4, 4, element_type="tet10")
    bc = RefDirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.3).build()
    return RefNewtonSolver(mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), bc,
                           options=RefOptions(linear="pcg_bcsr", n_steps=4, pcg_tol=1e-12)).solve()


EXAMPLES = {
    "uniaxial_tension": (uniaxial_tension, _uniaxial),
    "beam_bending": (beam_bending, _beam),
    "block_compression": (block_compression, _block),
}


def _run(name, **env):
    env = {**{k: v for k, v in os.environ.items() if k != "FEA_PLATFORM"}, "OMP_NUM_THREADS": "2",
           **env}
    return subprocess.run([sys.executable, "-m", f"fea_large_tpu_torch.examples.{name}"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_as_a_module_on_the_cpu(name):
    proc = _run(name, FEA_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "device: cpu" and lines[-1] == "OK"


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_matches_reference(name, capsys):
    module, reference = EXAMPLES[name]
    res = module.main(device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"
    ref = reference()
    assert res.converged and ref.converged
    assert [(r.load_factor, r.newton_iters) for r in res.history] == [
        (r.load_factor, r.newton_iters) for r in ref.history]
    u_r = np.asarray(ref.u)
    assert np.abs(res.u.numpy() - u_r).max() <= U_BOUND * np.abs(u_r).max()


def test_example_needs_the_card_or_the_cpu_switch():
    if torch.cuda.is_available():
        pytest.skip("checks that a machine without CUDA gets no fallback")
    proc = _run("uniaxial_tension")
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert "OK" not in proc.stdout
