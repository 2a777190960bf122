"""PyTorch port: the storage of the explicit coarse inverse
(`multilevel._store_acinv`) against the JAX reference's
(`fea_large_tpu/solvers/multilevel.py::_store_acinv`).

The rule: bf16 where the inverse is f32, the PCG dtype is f32 and the
inverse lives on the accelerator (the reference: on the TPU; the port: on
a CUDA device); f32 and f64 stay as they are elsewhere, so on the CPU both
packages keep full precision. The port keeps f32 also where the bf16 copy
is not positive definite (`_bf16_where_definite`; ROADMAP C1), where the
reference's two-level preconditioner becomes indefinite. The bf16 branch
is reached here by patching each package's `_store_acinv` to it
(`_ref_bf16`, `_port_bf16`); the reference's files are not touched.

Tolerances: the applies with a bf16-stored inverse, the same bits in both
packages, within 2^-8 of the largest entry of the result. rc is rounded to
bf16 and the product accumulated in f32 and rounded to bf16 once in both;
the f32 sums of the transfers and of the product run in another order, so
an entry that lies at a rounding boundary of bf16 may round one way in one
package and the other way in the other. The Kuhn n=4 solve at bench.py's
settings with both packages' storage patched: the reference's Newton count
and PCG list, and u within 1e-7 of max |u| of the reference's (chip_smoke's
LOOP_BOUND, the reference's bound for its budget hand-over,
tests/test_solvers.py): at bench.py's newton_rtol 1e-6 the reference's own
two loops differ by 1.4e-8 there (1.1e-8 with f32 storage), and the port's
loops from the reference's host loop by 1.0e-8 (1.6e-8 with f32 storage),
so the 1e-8 of the tighter tests (newton_rtol 1e-9) does not apply. The
one-rank sharded solver's coarse apply is bitwise the single-device apply
on the same bits.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX: only the `_on_card` test runs there
    import jax.numpy as jnp

    from fea_large_tpu.bc import DirichletBuilder as RefDirichletBuilder
    from fea_large_tpu.materials.neo_hookean import NeoHookean as RefNH
    from fea_large_tpu.mesh.generators import box_mesh as ref_box_mesh
    from fea_large_tpu.mesh.generators import box_mesh_kuhn as ref_box_mesh_kuhn
    from fea_large_tpu.ops.soa import SoAProblem as RefSoAProblem
    from fea_large_tpu.solvers import multilevel as ref_ml
except ImportError:
    jnp = ref_ml = None

from chip_smoke import REFERENCE_N4_BF16, REFERENCE_N4_DEVICE_LOOP_BF16
from fea_large_tpu_torch import interop
from fea_large_tpu_torch.bc import DirichletBuilder
from fea_large_tpu_torch.dist import ShardedNewtonSolver
from fea_large_tpu_torch.materials import NeoHookean
from fea_large_tpu_torch.mesh.generators import box_mesh, box_mesh_kuhn
from fea_large_tpu_torch.ops import pooling
from fea_large_tpu_torch.solvers import multilevel as ml
from fea_large_tpu_torch.solvers.newton import NewtonSolver, SolverOptions

torch.set_num_threads(2)

#: the bound of the bf16-stored applies, relative to the largest entry
BF16_BOUND = 2.0**-8
#: u of the Kuhn n=4 solves against the reference's, relative to max |u|
U_BOUND = 1e-7
#: bench.py's solver options on the CPU's route (resid_df False: no kernel)
BENCH = dict(linear="pcg", precision="mixed", preconditioner="two_level", coarse_modes=6,
             forcing="ew", ew_eta_min=1e-2, newton_rtol=1e-6, pcg_tol=1e-6, pcg_maxiter=2000,
             resid_df=False)


def _ref_bf16(acinv, dtype):
    """The reference's `_store_acinv` as it runs on its accelerator."""
    if acinv.dtype == jnp.float32 and dtype == jnp.float32:
        return acinv.astype(jnp.bfloat16)
    return acinv


def _port_bf16(acinv, dtype):
    """The port's `_store_acinv` as it runs on the card."""
    if acinv.dtype == torch.float32 and dtype == torch.float32:
        return ml._bf16_where_definite(acinv)
    return acinv


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_store_rule_keeps_full_precision_on_the_cpu_as_the_reference(dtype):
    """On the CPU both packages keep the inverse as it is, f32 and f64."""
    a = np.random.default_rng(1).standard_normal((12, 12)).astype(dtype)
    ref = ref_ml._store_acinv(jnp.asarray(a), jnp.dtype(dtype))
    port = ml._store_acinv(torch.tensor(a), getattr(torch, dtype))
    assert ref.dtype == jnp.dtype(dtype) and port.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert ml._store_acinv(torch.tensor(a), torch.float64).dtype == getattr(torch, dtype)


def test_store_rule_stores_bf16_on_card():
    """On the card an f32 inverse of the f32 PCG is stored in bf16 (its
    values rounded once to nearest); f64, the f64 PCG's f32, and an
    inverse whose bf16 copy is not positive definite stay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 storage is the card's")
    b = torch.randn(64, 64, device="cuda")
    a = b @ b.T + 64 * torch.eye(64, device="cuda")
    got = ml._store_acinv(a, torch.float32)
    assert got.dtype == torch.bfloat16 and got.device == a.device
    assert torch.equal(got, a.to(torch.bfloat16))
    assert ml._store_acinv(-a, torch.float32).dtype == torch.float32
    assert ml._store_acinv(a, torch.float64) is a
    assert ml._store_acinv(a.double(), torch.float64).dtype == torch.float64
    space = interop.coarse_space_from_numpy(np.arange(8) % 2, None, a[:6, :6].cpu().numpy(), 3,
                                            device="cuda")
    assert space.acinv.dtype == torch.bfloat16


def _kuhn_case():
    ref_mesh = ref_box_mesh_kuhn(4, 4, 4, element_type="tet10")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device="cpu")
    return ref_mesh, ref_bc, mesh, {}


def _unstructured_case():
    ref_mesh = ref_box_mesh(3, 3, 3, element_type="tet10")
    ref_bc = RefDirichletBuilder(ref_mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    return ref_mesh, ref_bc, mesh, {"agg_size": 40}


@pytest.fixture(scope="module")
def reference_spaces():
    """{(case, modes): (the reference's bf16-stored CoarseSpace, its mesh,
    free mask)}: Kuhn n=4 (the lattice pool) with 3, 6 and 12 modes, and a
    5-tet box 3^3 with 6 modes (its bucket maps: the component-first
    route of `apply_T`)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ml, "_store_acinv", _ref_bf16)
        for case, make, modes_list in (("kuhn", _kuhn_case, (3, 6, 12)),
                                       ("5tet", _unstructured_case, (6,))):
            ref_mesh, ref_bc, mesh, kw = make()
            soa = RefSoAProblem.build(ref_mesh, jnp.float32)
            for modes in modes_list:
                space = ref_ml.build_coarse_space(
                    ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc, modes=modes,
                    soa=soa, **kw)
                assert space.acinv.dtype == jnp.bfloat16
                out[case, modes] = (space, mesh, np.asarray(ref_bc.free_mask))
    return out


def _carried(ref, mesh, transfer, monkeypatch):
    """The reference's bf16 inverse carried across by `interop`, with the
    port's storage on its bf16 branch: the aggregate transfer, or the
    port's lattice pool over the same aggregates."""
    monkeypatch.setattr(ml, "_store_acinv", _port_bf16)
    dvec = None if ref.dvec is None else np.asarray(ref.dvec)
    space = interop.coarse_space_from_numpy(np.asarray(ref.agg), dvec, np.asarray(ref.acinv),
                                            ref.modes, device="cpu")
    if transfer == "lattice pool":
        pool = pooling.make_lattice_pool(mesh.structure, ref.n_agg)
        np.testing.assert_array_equal(pool.agg_host(), np.asarray(ref.agg))
        space = dataclasses.replace(space, pool=pool)
    return space


def _close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_BOUND * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("case,modes,transfer", [
    ("kuhn", 3, "lattice pool"), ("kuhn", 6, "lattice pool"), ("kuhn", 12, "lattice pool"),
    ("kuhn", 3, "aggregate transfer"), ("kuhn", 6, "aggregate transfer"),
    ("kuhn", 12, "aggregate transfer"), ("5tet", 6, "aggregate transfer"),
])
def test_bf16_stored_applies_match_reference(reference_spaces, monkeypatch, case, modes,
                                             transfer):
    """`coarse_solve`, `apply` and `apply_T` with the reference's bf16
    inverse carried across bit for bit, against the reference's
    CoarseSpace holding the same bits: within 2^-8 of max |x|."""
    ref, mesh, free = reference_spaces[case, modes]
    port = _carried(ref, mesh, transfer, monkeypatch)
    assert port.acinv.dtype == torch.bfloat16
    assert torch.equal(port.acinv.view(torch.int16),
                       torch.tensor(np.asarray(ref.acinv).view(np.int16)))
    rng = np.random.default_rng(modes)
    rc = rng.standard_normal((ref.n_agg, modes)).astype(np.float32)
    r = (rng.standard_normal((mesh.n_nodes, 3)) * free).astype(np.float32)
    r_T = np.ascontiguousarray(r.T)
    xc = port.coarse_solve(torch.tensor(rc))
    assert xc.dtype == torch.float32
    _close(xc, ref.coarse_solve(jnp.asarray(rc)))
    _close(port.apply(torch.tensor(r)), ref.apply(jnp.asarray(r)))
    _close(port.apply_T(torch.tensor(r_T)), ref.apply_T(jnp.asarray(r_T)))


def test_coarse_solve_rounds_once_to_the_storage_dtype(reference_spaces, monkeypatch):
    """The product of the stored inverse with rc rounded to bf16 is the
    exact (f64) product of the same bf16 inputs rounded once to bf16,
    within 2^-8 of max |x|, then cast to rc's dtype."""
    ref, mesh, _ = reference_spaces["kuhn", 6]
    port = _carried(ref, mesh, "lattice pool", monkeypatch)
    rc = torch.tensor(np.random.default_rng(2).standard_normal((ref.n_agg, 6)), dtype=torch.float32)
    exact = (port.acinv.double() @ rc.reshape(-1).to(torch.bfloat16).double()).to(torch.bfloat16)
    got = port.coarse_solve(rc)
    assert got.dtype == torch.float32
    err = float((got.reshape(-1) - exact.float()).abs().max())
    assert err <= BF16_BOUND * float(exact.float().abs().max())


def _bench_start(mesh, bc):
    u = torch.zeros((mesh.n_nodes, 3), dtype=torch.float64)
    u[:, 2] = -0.05 * mesh.coords[:, 2]
    return bc.impose(u, 1.0)


@pytest.fixture(scope="module")
def kuhn_bf16_solves():
    """Bench.py's Kuhn n=4 solve with both packages' storage on its bf16
    branch: {"reference": (u, record)} of the reference's host loop (its
    device loop compiles for minutes on the CPU: its counts are
    chip_smoke.py's REFERENCE_N4_DEVICE_LOOP_BF16, measured by
    tests/reference_bf16_lists.py) and {"device", "host"}: (u, ok, record)
    of the port's two loops."""
    from fea_large_tpu.solvers.newton import NewtonSolver as RefNewtonSolver
    from fea_large_tpu.solvers.newton import SolverOptions as RefOptions

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ml, "_store_acinv", _ref_bf16)
        mp.setattr(ml, "_store_acinv", _port_bf16)
        ref_mesh, ref_bc, mesh, _ = _kuhn_case()
        ref = RefNewtonSolver(ref_mesh, RefNH(jnp.asarray(1.0), jnp.asarray(0.6)), ref_bc,
                              options=RefOptions(device_loop=False, **BENCH))
        assert ref._coarse.acinv.dtype == jnp.bfloat16
        u0 = jnp.asarray(mesh.coords_host[:, 2])
        u_ref = ref_bc.impose(jnp.zeros((mesh.n_nodes, 3)).at[:, 2].set(-0.05 * u0),
                              jnp.asarray(1.0))
        u, ok, rec = ref._newton(u_ref, jnp.asarray(1.0))
        assert bool(ok)
        out["reference"] = (np.asarray(u), rec)
        bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
        solver = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc, options=SolverOptions(**BENCH))
        assert solver._coarse.acinv.dtype == torch.bfloat16
        out["device"] = solver._newton(_bench_start(mesh, bc), 1.0)
        host = NewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                            options=SolverOptions(**BENCH, device_loop=False))
        out["host"] = host._newton(_bench_start(mesh, bc), 1.0)
    return out


@pytest.mark.parametrize("loop", ["device", "host"])
def test_kuhn_bf16_solve_matches_reference(kuhn_bf16_solves, loop):
    """Each of the port's loops with bf16 storage against the reference's
    loop of the same kind with its accelerator storage: the Newton count,
    the PCG list and first residual of chip_smoke.py's bf16 constants (the
    reference's host loop here reproduces its own), u within U_BOUND of
    max |u| of the reference's host loop, and the port's two loops bitwise
    equal."""
    u_ref, rec_ref = kuhn_bf16_solves["reference"]
    want = {"device": REFERENCE_N4_DEVICE_LOOP_BF16, "host": REFERENCE_N4_BF16}[loop]
    assert rec_ref.newton_iters == REFERENCE_N4_BF16["newton_iters"]
    assert [int(k) for k in rec_ref.pcg_iters] == REFERENCE_N4_BF16["pcg_iters"]
    u, ok, rec = kuhn_bf16_solves[loop]
    assert ok and rec.newton_iters == want["newton_iters"] == rec_ref.newton_iters
    assert rec.pcg_iters == want["pcg_iters"]
    assert abs(rec.residual_norms[0] - want["residual0"]) <= 1e-12 * want["residual0"]
    err = np.abs(u.numpy() - u_ref).max() / np.abs(u_ref).max()
    assert err <= U_BOUND, err
    assert torch.equal(u, kuhn_bf16_solves["host" if loop == "device" else "device"][0])


def test_one_rank_sharded_coarse_apply_is_the_single_device_apply(monkeypatch):
    """One shard in this process (LocalComm) with the bf16 branch: the rank
    stores its inverse in bf16, and its coarse apply (restrict, the sum
    over one rank, the stored product, prolong) is bitwise the
    single-device `CoarseSpace.apply` over the same aggregates and the
    same bits."""
    monkeypatch.setattr(ml, "_store_acinv", _port_bf16)
    mesh = box_mesh(3, 3, 3, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    s = ShardedNewtonSolver(mesh, NeoHookean(1.0, 0.6), bc,
                            options=SolverOptions(**dict(BENCH, agg_size=40)))
    coarse, ctx = s.coarse, s._probe_ctx
    assert coarse.acinv.dtype == torch.bfloat16 and coarse.modes == 6
    assert s._memory(0, 1, 1, 1)["static_coarse_replicated"] == 2 * coarse.acinv.numel()
    single = interop.coarse_space_from_numpy(ctx["agg"], ctx["dvec"], coarse.acinv.float().numpy(),
                                             6, device="cpu")
    assert torch.equal(single.acinv, coarse.acinv)
    rng = np.random.default_rng(6)
    r = (rng.standard_normal((mesh.n_nodes, 3)) * bc.free_mask.numpy()).astype(np.float32)
    r_own = torch.tensor(s.part.from_global(r)[0])
    got = s.u_global(s._coarse_apply(coarse, r_own))
    assert np.array_equal(got, single.apply(torch.tensor(r)).numpy())


def test_bf16_copy_kept_only_where_positive_definite():
    """ROADMAP C1: on tasks/distributed_compression_kuhn.json's coarse space
    (6 modes on a slender 16x6x6 lattice, dim 432) the f32 inverse is
    positive definite and its bf16 copy is not, so the reference's
    accelerator storage makes the two-level preconditioner indefinite; the
    port's card branch keeps f32 there, and stores bf16 on bench.py's Kuhn
    n=4 space, whose copy stays definite."""
    from fea_large_tpu_torch.io.task import load_task
    from fea_large_tpu_torch.ops.soa import SoAProblem

    task = load_task(pathlib.Path(__file__).resolve().parent.parent / "tasks"
                     / "distributed_compression_kuhn.json", device="cpu")
    opts = task.solver
    space = ml.build_coarse_space(task.mesh, task.material, task.build_bc(),
                                  agg_size=opts.agg_size, modes=opts.coarse_modes,
                                  soa=SoAProblem.build(task.mesh, torch.float32))
    assert space.acinv.dtype == torch.float32 and space.acinv.shape[0] == 432
    assert float(torch.linalg.eigvalsh(space.acinv.double())[0]) > 0
    assert float(torch.linalg.eigvalsh(space.acinv.to(torch.bfloat16).double())[0]) < 0
    assert _ref_bf16(jnp.asarray(space.acinv.numpy()), jnp.float32).dtype == jnp.bfloat16
    assert _port_bf16(space.acinv, torch.float32) is space.acinv
    mesh = box_mesh_kuhn(4, 4, 4, element_type="tet10", device="cpu")
    bc = DirichletBuilder(mesh).fix("zmin").prescribe("zmax", "z", -0.05).build()
    kuhn = ml.build_coarse_space(mesh, NeoHookean(1.0, 0.6), bc, modes=6,
                                 soa=SoAProblem.build(mesh, torch.float32))
    assert _port_bf16(kuhn.acinv, torch.float32).dtype == torch.bfloat16
