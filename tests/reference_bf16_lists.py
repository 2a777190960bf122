"""The JAX reference's PCG lists with the storage of the explicit coarse
inverse it uses on its accelerator (bf16), measured on the CPU: the
reference's `fea_large_tpu.solvers.multilevel._store_acinv` is patched to
its bf16 branch in this process; no file of the reference is edited.

    FEA_PLATFORM=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/reference_bf16_lists.py [f32]

Prints, as JSON on its last line, chip_smoke.py's REFERENCE_N4_BF16,
REFERENCE_N4_DEVICE_LOOP_BF16, REFERENCE_5TET_N4_BF16 and
REFERENCE_5TET_N4_DEVICE_LOOP_BF16 (TET10 Kuhn and 5-tet boxes n=4 at
bench.py's settings with resid_df=False, the host and the device loop,
each with the inverse's dtype), and REFERENCE_SHARDED_TASKS_BF16 (the
reference's `run` of the two 8-shard task files on 8 virtual CPU devices:
per increment, the Newton count and PCG list). With `f32` it runs the same
without the patch, which gives the f32 constants beside them (names
without _BF16). The Kuhn device loop's compile takes minutes on the CPU;
the whole run took 473 s on 8 cores.
"""

import json
import os
import pathlib
import sys
import tempfile

os.environ.setdefault("FEA_PLATFORM", "cpu")

import jax.numpy as jnp  # noqa: E402

from fea_large_tpu.bc import DirichletBuilder  # noqa: E402
from fea_large_tpu.cli import main as cli_main  # noqa: E402
from fea_large_tpu.materials.neo_hookean import NeoHookean  # noqa: E402
from fea_large_tpu.mesh.generators import box_mesh, box_mesh_kuhn  # noqa: E402
from fea_large_tpu.solvers import multilevel  # noqa: E402
from fea_large_tpu.solvers.newton import NewtonSolver, SolverOptions  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
             forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
             resid_df=False)
TASKS = ("distributed_compression.json", "distributed_compression_kuhn.json")


def bf16_branch(acinv, dtype):
    """The reference's `_store_acinv` as it runs on its accelerator."""
    if acinv.dtype == jnp.float32 and dtype == jnp.float32:
        return acinv.astype(jnp.bfloat16)
    return acinv


def n4_lists(tag: str) -> dict:
    """{constant name + tag: {dtype, newton_iters, pcg_iters, residual0}}
    of the n=4 runs."""
    out = {}
    for name, build, extra in (("N4", box_mesh_kuhn, {}),
                               ("5TET_N4", box_mesh, {"agg_size": 100})):
        for loop, suffix in ((False, ""), (True, "_DEVICE_LOOP")):
            mesh = build(4, 4, 4, element_type="tet10")
            bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
            solver = NewtonSolver(mesh, NeoHookean(jnp.asarray(1.0), jnp.asarray(0.6)), bc,
                                  options=SolverOptions(device_loop=loop, **BENCH, **extra))
            u0 = jnp.zeros((mesh.n_nodes, 3)).at[:, 2].set(-0.05 * mesh.coords_host[:, 2])
            _, ok, rec = solver._newton(bc.impose(u0, jnp.asarray(1.0)), jnp.asarray(1.0))
            if not bool(ok):
                raise RuntimeError(f"{name}{suffix}: the reference's solve did not converge")
            out[f"REFERENCE_{name}{suffix}{tag}"] = {
                "dtype": str(solver._coarse.acinv.dtype),
                "newton_iters": int(rec.newton_iters),
                "pcg_iters": [int(k) for k in rec.pcg_iters],
                "residual0": float(rec.residual_norms[0])}
    return out


def task_lists() -> dict:
    """{task file: [(newton_iters, pcg_iters)] per increment} of the
    reference's `run` of the 8-shard task files."""
    out = {}
    for name in TASKS:
        with tempfile.TemporaryDirectory() as tmp:
            if cli_main(["run", str(REPO / "tasks" / name), "--out", tmp]) != 0:
                raise RuntimeError(f"the reference's run of {name} failed")
            conv = json.loads((pathlib.Path(tmp) / (pathlib.Path(name).stem
                                                    + "_convergence.json")).read_text())
        out[name] = [(s["newton_iters"], s["pcg_iters"]) for s in conv["steps"]]
    return out


if __name__ == "__main__":
    tag = "" if sys.argv[1:] == ["f32"] else "_BF16"
    if tag:
        multilevel._store_acinv = bf16_branch
    print(json.dumps({**n4_lists(tag), f"REFERENCE_SHARDED_TASKS{tag}": task_lists()}))
