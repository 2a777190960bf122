"""PyTorch port: the one-step entry points against the JAX reference.

  (a) `NewtonSolver._step` on the mixed path with bench.py's step mode
      (FEA_BENCH_MODE=step: mixed, two-level with 6 modes, forcing
      "fixed", pcg_tol 1e-6) from the 5% affine start, given the f64
      residual, on a Kuhn TET10 n=4 lattice and a 5-tet TET10 box n=3:
      the PCG count within one of the reference's (measured on CPU: equal,
      58 and 38), the increment within 1e-4 of max |x_ref| (measured
      7.7e-7 Kuhn, 1.9e-6 5-tet), and the f64 residual after the step,
      recomputed by the reference's pass, within 1e-3 of the reference's
      (measured 2.1e-6, 1.1e-6);
  (b) `_step` on a mixed solver is `_step_mixed` (the same count, x
      bitwise) and never the f64 matrix-free step;
  (c) `step_fn` against the reference's: the mixed route on the Kuhn
      lattice (one prepare and one chunk: the same count, x within 1e-4;
      measured 1.3e-6) and the f64 `pcg` and `pcg_bcsr` routes (x within
      1e-10 of max |u|; measured 2.3e-12, 8.2e-13);
  (d) `entry.entry()` against `__graft_entry__.entry()` at its own
      arguments (u = 0, a zero residual: both return 0) and at the 20%
      affine compression its BCs prescribe (1e-10; measured 1.4e-12),
      shape, dtype, finiteness and a bitwise repeat;
  (e) `two_level_preconditioner`, `apply_block_jacobi_T`, `adjugate3` and
      `sym3` against the reference's on f64 inputs (1e-12);
  (f) on the card (skips here): the mixed step on a Kuhn n=4 lattice
      through B1-B3, against the CPU's step. It runs where JAX is not
      installed: `python -m pytest --noconftest -k on_card
      tests/test_torch_step.py`.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX: only the `_on_card` test runs there
    import jax.numpy as jnp

    from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
    from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
    from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
    from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
    from fea_large_tpu.solvers.newton import SolverOptions as RefOptions
except ImportError:
    jnp = ref_box_mesh = ref_box_mesh_kuhn = None

from fea_large_tpu_torch import entry as port_entry
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import cuda_graphs
from fea_large_tpu_torch.ops import struct_kernels as sk
from fea_large_tpu_torch.ops.smallmat import adjugate3, sym3
from fea_large_tpu_torch.solvers import newton as nm
from fea_large_tpu_torch.solvers.linear import apply_block_jacobi, apply_block_jacobi_T
from fea_large_tpu_torch.solvers.multilevel import two_level_preconditioner
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

torch.set_num_threads(2)

#: bench.py's FEA_BENCH_MODE=step options
STEP = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
            forcing="fixed", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000)
#: `__graft_entry__.entry`'s problem: (zmax load, options)
ENTRY = (-0.2, dict(linear="pcg", pcg_tol=1e-10, pcg_maxiter=500))
MESHES = {"kuhn": (box_mesh_kuhn, ref_box_mesh_kuhn, 4), "5tet": (box_mesh, ref_box_mesh, 3)}


def _pcg_close(port, ref):
    assert abs(int(port) - int(ref)) <= 1, f"PCG port {port} vs reference {ref}"


def _affine(coords, comp):
    u = np.zeros(coords.shape)
    u[:, 2] = comp * coords[:, 2]
    return u


class _Pair:
    """Both packages' solvers on one mesh, load and options, and the
    imposed affine start state (numpy, torch, jax)."""

    def __init__(self, build, ref_build, n, load, opts, comp):
        self.ref_mesh = ref_build(n, n, n, element_type="tet10")
        self.mesh = build(n, n, n, element_type="tet10", device="cpu")
        ref_bc = RefDirichletBuilder(self.ref_mesh).fix("zmin").prescribe("zmax", "z", load).build()
        bc = DirichletBuilder(self.mesh).fix("zmin").prescribe("zmax", "z", load).build()
        self.ref = RefNewtonSolver(self.ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)),
                                   ref_bc, options=RefOptions(**opts))
        self.port = NewtonSolver(self.mesh, NeoHookean(1.0, 0.6), bc,
                                 options=SolverOptions(**opts))
        u = _affine(self.mesh.coords.numpy(), comp)
        self.u = self.port.bc.impose(torch.tensor(u), 1.0)
        self.u_ref = self.ref.bc.impose(jnp.asarray(u), jnp.asarray(1.0))


@pytest.fixture(scope="module", params=list(MESHES))
def stepped(request):
    """(pair, reference step, port step, port r64) of bench.py's step mode."""
    build, ref_build, n = MESHES[request.param]
    pair = _Pair(build, ref_build, n, -0.05, STEP, -0.05)
    r_ref, _ = pair.ref._residual(pair.u_ref, jnp.asarray(1.0))
    ref = pair.ref._step(pair.u_ref, jnp.asarray(1.0), r64=r_ref)
    r64, _ = pair.port._residual(pair.u, 1.0)
    assert float((r64 - torch.tensor(np.asarray(r_ref))).abs().max()) <= (
        1e-12 * float(np.abs(np.asarray(r_ref)).max()))
    port = pair.port._step(pair.u, 1.0, r64=r64)
    return pair, ref, port, r64


def test_mixed_step_matches_reference(stepped):
    pair, (u_r, it_r, ok_r, rel_r), (u_p, it_p, ok_p, rel_p), _ = stepped
    assert bool(ok_r) and ok_p and rel_p <= 1e-6
    _pcg_close(it_p, it_r)
    x_r = np.asarray(u_r) - np.asarray(pair.u_ref)
    x_p = (u_p - pair.u).numpy()
    assert np.abs(x_p - x_r).max() <= 1e-4 * np.abs(x_r).max()
    norm_r = float(pair.ref._residual(u_r, jnp.asarray(1.0))[1])
    norm_p = float(pair.ref._residual(jnp.asarray(u_p.numpy()), jnp.asarray(1.0))[1])
    norm0 = float(pair.ref._residual(pair.u_ref, jnp.asarray(1.0))[1])
    assert norm_p < 0.1 * norm0
    assert abs(norm_p - norm_r) <= 1e-3 * norm_r


def test_mixed_step_is_not_the_f64_step(stepped, monkeypatch):
    """`_step` on a mixed solver runs the mixed step, not the f64
    matrix-free one (whose preconditioner and precision differ)."""
    pair, _, (u_p, it_p, ok_p, rel_p), r64 = stepped

    def f64_step(*args, **kwargs):
        raise AssertionError("the mixed path ran the f64 matrix-free step")

    monkeypatch.setattr(nm, "_step_matfree_fn", f64_step)
    u_m, it_m, ok_m, rel_m = pair.port._step_mixed(pair.u, 1.0, r64=r64)
    assert it_m == it_p and ok_m == ok_p and rel_m == rel_p
    assert torch.equal(u_m, u_p)
    u_s, it_s, _, _ = pair.port._step(pair.u, 1.0, r64=r64)
    assert it_s == it_m and torch.equal(u_s, u_m)


@pytest.mark.parametrize("stepped", ["kuhn"], indirect=True)
def test_mixed_step_fn_matches_reference(stepped):
    """One prepare (its own f64 residual) and one chunk of at most
    pcg_chunk iterations at pcg_tol: the same count as the reference's
    step_fn, u within 1e-4 of the increment's max, ||r|| under the stop."""
    pair, _, _, r64 = stepped
    u_r, k_r, ok_r, _ = pair.ref.step_fn(pair.u_ref, jnp.asarray(1.0))
    u_p, k_p, ok_p, r_p = pair.port.step_fn(pair.u, 1.0)
    assert int(k_r) == k_p and bool(ok_r) and ok_p
    x_r = np.asarray(u_r) - np.asarray(pair.u_ref)
    assert np.abs(u_p.numpy() - np.asarray(u_r)).max() <= 1e-4 * np.abs(x_r).max()
    assert r_p <= 1e-6 * float(torch.linalg.norm(r64.to(torch.float32)))


@pytest.mark.parametrize("linear", ["pcg", "pcg_bcsr"])
def test_f64_step_fn_matches_reference(linear):
    """`step_fn` on the f64 routes is `_step`: entry's options on a TET10
    box 2^3 at the 20% affine compression its BCs prescribe."""
    pair = _Pair(box_mesh, ref_box_mesh, 2, ENTRY[0], dict(ENTRY[1], linear=linear), -0.2)
    u_r, k_r, ok_r, _ = pair.ref.step_fn(pair.u_ref, jnp.asarray(1.0))
    u_p, k_p, ok_p, _ = pair.port.step_fn(pair.u, 1.0)
    u_r = np.asarray(u_r)
    assert bool(ok_r) and ok_p and k_p > 0
    assert np.abs(u_p.numpy() - u_r).max() <= 1e-10 * np.abs(u_r).max()


def test_entry_matches_reference():
    import __graft_entry__ as graft

    fn_r, args_r = graft.entry()
    fn_p, args_p = port_entry.entry(device="cpu")
    assert args_p[0].shape == tuple(args_r[0].shape) and args_p[0].dtype == torch.float64
    out_p = fn_p(*args_p)
    assert out_p.shape == args_p[0].shape and out_p.dtype == torch.float64
    assert bool(torch.isfinite(out_p).all())
    assert torch.equal(out_p, fn_p(*args_p))
    assert np.abs(out_p.numpy() - np.asarray(fn_r(*args_r))).max() == 0.0
    # a state with a residual: the 20% affine compression its BCs prescribe
    pair = _Pair(box_mesh, ref_box_mesh, 4, ENTRY[0], ENTRY[1], -0.2)
    out_r = np.asarray(fn_r(pair.u_ref, jnp.asarray(1.0)))
    out_p = fn_p(pair.u, 1.0)
    assert torch.equal(out_p, fn_p(pair.u, 1.0))
    assert np.abs(out_p.numpy() - out_r).max() <= 1e-10 * np.abs(out_r).max()


class _DenseCoarse:
    """A coarse correction r -> reshape(A vec(r)) on f64 inputs."""

    def __init__(self, a):
        self.a = a

    def apply(self, r):
        return (self.a @ r.reshape(-1)).reshape(r.shape)


def test_helpers_match_reference():
    from fea_large_tpu.ops.smallmat import adjugate3 as ref_adjugate3
    from fea_large_tpu.ops.smallmat import sym3 as ref_sym3
    from fea_large_tpu.solvers.linear import apply_block_jacobi as ref_bj
    from fea_large_tpu.solvers.linear import apply_block_jacobi_T as ref_bj_T
    from fea_large_tpu.solvers.multilevel import two_level_preconditioner as ref_two_level

    rng = np.random.default_rng(20261017)
    n = 40
    inv = rng.standard_normal((n, 3, 3))
    free = (rng.random((n, 3)) > 0.2).astype(np.float64)
    r = rng.standard_normal((n, 3))
    a = rng.standard_normal((3 * n, 3 * n))

    def close(p, q):
        q = np.asarray(q)
        assert np.abs(np.asarray(p) - q).max() <= 1e-12 * np.abs(q).max()

    t = {k: torch.tensor(v) for k, v in dict(inv=inv, free=free, r=r, a=a).items()}
    j = {k: jnp.asarray(v) for k, v in dict(inv=inv, free=free, r=r, a=a).items()}
    close(apply_block_jacobi_T(t["inv"], t["free"].T, t["r"].T).T,
          ref_bj_T(j["inv"], j["free"].T, j["r"].T).T)
    close(apply_block_jacobi_T(t["inv"], t["free"].T, t["r"].T).T,
          apply_block_jacobi(t["inv"], t["free"], t["r"]))
    port = two_level_preconditioner(_DenseCoarse(t["a"]),
                                    lambda v: apply_block_jacobi(t["inv"], t["free"], v), t["free"])
    ref = ref_two_level(_DenseCoarse(j["a"]), lambda v: ref_bj(j["inv"], j["free"], v),
                        j["free"])
    close(port(t["r"]), ref(j["r"]))
    m = rng.standard_normal((5, 7, 3, 3))
    close(adjugate3(torch.tensor(m)), ref_adjugate3(jnp.asarray(m)))
    close(sym3(torch.tensor(m)), ref_sym3(jnp.asarray(m)))
    # the adjugate is det times the inverse
    close(adjugate3(torch.tensor(m)), np.linalg.det(m)[..., None, None] * np.linalg.inv(m))


def test_mixed_step_on_card():
    """On the card: the mixed step on a Kuhn n=4 lattice runs B1-B3 (B1
    once per PCG iteration at least), its count within one of the CPU's,
    u within 1e-4 of the increment's max, and a repeat bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's kernels run on the card")
    runs = {}
    for dev in ("cpu", "cuda"):
        mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device=dev)
        bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
        solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**STEP))
        u = bc.impose(torch.tensor(_affine(mesh.coords.cpu().numpy(), -0.05), device=dev), 1.0)
        before = dict(sk.LAUNCHES)
        replayed = {k: cuda_graphs.REPLAYED[f"struct_{k}"] for k in sk.LAUNCHES}
        out = solver._step(u, 1.0)
        # eager launches and, on the card, those of the PCG chunk's graphs
        launched = {k: sk.LAUNCHES[k] - before[k] + cuda_graphs.REPLAYED[f"struct_{k}"]
                    - replayed[k] for k in sk.LAUNCHES}
        again = solver._step(u, 1.0)
        runs[dev] = (u, out, launched, again)
    u, (u_c, it_c, ok_c, _), _, _ = runs["cpu"]
    _, (u_g, it_g, ok_g, _), launched, (u_g2, it_g2, _, _) = runs["cuda"]
    assert ok_c and ok_g and abs(it_g - it_c) <= 1
    assert launched["apply"] >= it_g and launched["freeze"] >= 1 and launched["diag"] >= 1
    assert torch.equal(u_g, u_g2) and it_g == it_g2
    x_c = u_c - u
    assert float((u_g.cpu() - u_c).abs().max()) <= 1e-4 * float(x_c.abs().max())
