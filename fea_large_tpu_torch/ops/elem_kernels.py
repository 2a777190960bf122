"""Element-block passes on unstructured meshes: the four Hopper kernels and
their plain PyTorch versions (counterpart of
`fea_large_tpu/ops/pallas_kernels.py` and of the unstructured part of
`fea_large_tpu/ops/pallas_residual.py`).

Layout, kept from the reference: every operand is [rows, E], element axis
last, in the flattened SoA form

    ve, ue     [3*npe, E]      gathered nodal values, rows 3a + i
    gradN      [q*npe*3, E]    rows (k*npe + a)*3 + J
    detJxW     [q, E]
    F, S, A    [q*9, E]        rows k*9 + 3i + j (the [q, 3, 3, E] state)
    alpha, beta [q, E]
    out        [3*npe, E]      per-element nodal result, rows i*npe + a

The residual pass writes its nodal force in the same rows i*npe + a, so
every output of this module is a free [3, npe, E] view for the nodal sum
(the reference's residual kernel writes rows 3a + i instead).

As on the TPU, the gather (v[conn]) and the nodal scatter stay outside the
kernels (ops/soa.py), and the kernels do the dense element math.

Each pass has a kernel (csrc/elem_kernels.cu, CUDA C++ for sm_90a: f32
for the tangent passes, f64 for the residual) and a plain version here
(`*_plain`, any float dtype). A wrapper (`elem_apply`, `elem_freeze`,
`elem_force`, `elem_resid`) runs the plain version when its tensors lie on
the CPU; on a CUDA tensor it launches the kernel or raises. The
unstructured f32 passes of ops/soa.py go through the first three
wrappers; the f64 residual of the mixed path goes through `elem_resid`
(ops/residual.py). `LAUNCHES` counts kernel launches per pass.
"""

from __future__ import annotations

import ctypes

import torch

from fea_large_tpu_torch.ops import cuda_build
from fea_large_tpu_torch.ops.smallmat import mm3

#: kernel launches per pass since the last reset (the wrappers increment
#: these where they launch their kernel, and nowhere else)
LAUNCHES = {"apply": 0, "freeze": 0, "force": 0, "resid": 0}

#: (q, npe) the kernels are instantiated for: TET10 with the 4-point rule
#: and TET4 with the 1-point rule
SUPPORTED = ((4, 10), (1, 4))

#: threads (elements) per block of the kernels
BLOCK = 128

SOURCE = cuda_build.CSRC / "elem_kernels.cu"


# ---------------------------------------------------------------------------
# plain versions (any float dtype, any device)
# ---------------------------------------------------------------------------


def _points(rows: torch.Tensor, q: int) -> torch.Tensor:
    """[q*9, E] state rows -> [q, E, 3, 3] view."""
    return rows.view(q, 3, 3, -1).permute(0, 3, 1, 2)


def _g(gradN: torch.Tensor, q: int, npe: int) -> torch.Tensor:
    """[q*npe*3, E] -> [q, E, npe, 3] view."""
    return gradN.view(q, npe, 3, -1).permute(0, 3, 1, 2)


def _grad(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_a v_a (x) g_a per point: v [3*npe, E] rows 3a + i, g [q, E,
    npe, 3] -> [q, E, 3, 3]."""
    npe = g.shape[2]
    return torch.einsum("aie,qeaj->qeij", v.view(npe, 3, -1), g)


def _nodal(PV: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_q PV g_a for weighted stress-like PV [q, E, 3, 3] -> [3*npe, E]
    rows i*npe + a."""
    npe = g.shape[2]
    return torch.einsum("qeiJ,qeaJ->iae", PV, g).reshape(3 * npe, -1)


def _rows(x: torch.Tensor, q: int) -> torch.Tensor:
    """[q, E, 3, 3] -> contiguous [q*9, E] rows."""
    return x.permute(0, 2, 3, 1).reshape(q * 9, -1).contiguous()


def elem_freeze_plain(ue, gradN, material, *, npe: int, q: int):
    """F = I + sum_a u_a (x) g_a, C = F^T F, and the material's (S, alpha,
    A, beta). Returns (F, S, A [q*9, E]; alpha, beta [q, E])."""
    grad = _grad(ue, _g(gradN, q, npe))
    F = grad + torch.eye(3, dtype=grad.dtype, device=grad.device)
    S, alpha, A, beta = material.stress_and_factors(mm3(F.transpose(-1, -2), F))
    E = F.shape[1]
    return (
        _rows(F, q), _rows(S.expand(F.shape), q), _rows(A.expand(F.shape), q),
        alpha.expand(q, E).contiguous(), beta.expand(q, E).contiguous(),
    )


def elem_apply_plain(ve, gradN, detJxW, F, S, A, alpha, beta, *, npe: int, q: int):
    """Tangent action per element: dF = sum_a v_a (x) g_a, dE = sym(F^T dF),
    dS = alpha (A:dE) A + beta A dE A, dP = dF S + F dS; V dP g_a summed
    into [3*npe, E] rows i*npe + a."""
    g = _g(gradN, q, npe)
    F, S, A = _points(F, q), _points(S, q), _points(A, q)
    al, be = alpha[..., None, None], beta[..., None, None]
    dF = _grad(ve, g)
    FtdF = mm3(F.transpose(-1, -2), dF)
    dE = 0.5 * (FtdF + FtdF.transpose(-1, -2))
    AdE = (A * dE).sum((-2, -1), keepdim=True)
    dS = al * AdE * A + be * mm3(mm3(A, dE), A)
    return _nodal((mm3(dF, S) + mm3(F, dS)) * detJxW[..., None, None], g)


def elem_force_plain(gradN, detJxW, F, S, *, npe: int, q: int):
    """Internal force f_a = sum_q V (F S) g_a from the frozen state:
    [3*npe, E] rows i*npe + a."""
    PV = mm3(_points(F, q), _points(S, q)) * detJxW[..., None, None]
    return _nodal(PV, _g(gradN, q, npe))


def elem_resid_plain(ue, gradN, detJxW, material, *, npe: int, q: int):
    """Internal force f_a = sum_q V (F S) g_a at u, kinematics and stress
    included (the freeze followed by the force, keeping no state):
    [3*npe, E] rows i*npe + a. The f64 residual pass of an unstructured
    mesh."""
    F, S = elem_freeze_plain(ue, gradN, material, npe=npe, q=q)[:2]
    return elem_force_plain(gradN, detJxW, F, S, npe=npe, q=q)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _library():
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load(SOURCE, {
        "fea_elem_freeze_f32": [P] * 7 + [I] * 5 + [Fl, Fl, P],
        "fea_elem_apply_f32": [P] * 9 + [I] * 4 + [P],
        "fea_elem_force_f32": [P] * 5 + [I] * 4 + [P],
        "fea_elem_resid_f64": [P] * 4 + [I] * 5 + [ctypes.c_double] * 2 + [P],
    })


def _check(named: dict, shapes: dict, npe: int, q: int, block: int,
           dtype: torch.dtype = torch.float32):
    """Raise unless every tensor is a contiguous `dtype` tensor on one CUDA
    device with the expected shape, for a supported element and block."""
    if (q, npe) not in SUPPORTED:
        raise ValueError(f"no element kernel for (q, npe) = {(q, npe)}")
    if not (0 < block <= 256 and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 up to 256, got {block}")
    dev = next(iter(named.values())).device
    for name, x in named.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(x.shape)}")


def _launch(fn: str, device, *args, suffix: str = "f32"):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), f"fea_elem_{fn}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"element {fn} kernel launch failed: CUDA error {err}")
    LAUNCHES[fn] += 1


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def elem_freeze(ue, gradN, material, *, npe: int, q: int, block: int = BLOCK):
    """B7 (`pallas_kernels.py::_freeze_kernel`): see `elem_freeze_plain`."""
    if ue.device.type == "cpu":
        return elem_freeze_plain(ue, gradN, material, npe=npe, q=q)
    kind = _material_kind(material)
    E = ue.shape[-1]
    _check({"ue": ue, "gradN": gradN}, {"ue": (3 * npe, E), "gradN": (q * npe * 3, E)},
           npe, q, block)
    F, S, A = (ue.new_empty((q * 9, E)) for _ in range(3))
    al, be = (ue.new_empty((q, E)) for _ in range(2))
    _launch("freeze", ue.device, _ptr(ue), _ptr(gradN), _ptr(F), _ptr(S), _ptr(A),
            _ptr(al), _ptr(be), E, q, npe, block, kind,
            ctypes.c_float(material.lam), ctypes.c_float(material.mu))
    return F, S, A, al, be


def elem_apply(ve, gradN, detJxW, F, S, A, alpha, beta, *, npe: int, q: int,
               block: int = BLOCK):
    """B6 (`pallas_kernels.py::_apply_kernel`): see `elem_apply_plain`."""
    if ve.device.type == "cpu":
        return elem_apply_plain(ve, gradN, detJxW, F, S, A, alpha, beta, npe=npe, q=q)
    E = ve.shape[-1]
    named = {"ve": ve, "gradN": gradN, "detJxW": detJxW, "F": F, "S": S, "A": A,
             "alpha": alpha, "beta": beta}
    rq, rp = (q * 9, E), (q, E)
    _check(named, {"ve": (3 * npe, E), "gradN": (q * npe * 3, E), "detJxW": rp,
                   "F": rq, "S": rq, "A": rq, "alpha": rp, "beta": rp}, npe, q, block)
    out = ve.new_empty((3 * npe, E))
    _launch("apply", ve.device, *(_ptr(x) for x in named.values()), _ptr(out),
            E, q, npe, block)
    return out


def elem_force(gradN, detJxW, F, S, *, npe: int, q: int, block: int = BLOCK):
    """B8 (`pallas_kernels.py::_force_kernel`): see `elem_force_plain`."""
    if gradN.device.type == "cpu":
        return elem_force_plain(gradN, detJxW, F, S, npe=npe, q=q)
    E = gradN.shape[-1]
    named = {"gradN": gradN, "detJxW": detJxW, "F": F, "S": S}
    _check(named, {"gradN": (q * npe * 3, E), "detJxW": (q, E), "F": (q * 9, E),
                   "S": (q * 9, E)}, npe, q, block)
    out = gradN.new_empty((3 * npe, E))
    _launch("force", gradN.device, *(_ptr(x) for x in named.values()), _ptr(out),
            E, q, npe, block)
    return out


def elem_resid(ue, gradN, detJxW, material, *, npe: int, q: int, block: int = BLOCK):
    """B9 (`pallas_residual.py::_resid_kernel_unstr`), in f64: see
    `elem_resid_plain`."""
    if ue.device.type == "cpu":
        return elem_resid_plain(ue, gradN, detJxW, material, npe=npe, q=q)
    kind = _material_kind(material)
    E = ue.shape[-1]
    named = {"ue": ue, "gradN": gradN, "detJxW": detJxW}
    _check(named, {"ue": (3 * npe, E), "gradN": (q * npe * 3, E), "detJxW": (q, E)},
           npe, q, block, torch.float64)
    out = ue.new_empty((3 * npe, E))
    _launch("resid", ue.device, *(_ptr(x) for x in named.values()), _ptr(out),
            E, q, npe, block, kind, ctypes.c_double(material.lam),
            ctypes.c_double(material.mu), suffix="f64")
    return out


# ---------------------------------------------------------------------------
# SoA helpers (the unstructured passes of ops/soa.py call the wrappers)
# ---------------------------------------------------------------------------


def _material_kind(material) -> int:
    """Material code of the freeze and residual kernels (0 SVK, 1
    neo-Hookean Ciarlet, 2 neo-Hookean volumetric)."""
    if material.kind not in (0, 1, 2):
        raise NotImplementedError(
            f"the element kernels take the registered isotropic materials; "
            f"got {type(material).__name__}"
        )
    return material.kind


def flatten_state(state):
    """SoAState -> the kernels' (F, S, A [q*9, E], alpha, beta [q, E]) views."""
    q, E = state.alpha.shape
    return (state.F.view(q * 9, E), state.S.view(q * 9, E), state.A.view(q * 9, E),
            state.alpha, state.beta)


def _gather_flat(p, v_T):
    """v_T [3, N] -> [3*npe, E] rows 3a + i (`soa_gather`, transposed)."""
    from fea_large_tpu_torch.ops.soa import soa_gather

    ve = soa_gather(p, v_T)  # [3, npe, E]
    return ve.transpose(0, 1).reshape(-1, ve.shape[-1])


def flat_tables(p):
    """(q, npe, gradN [q*npe*3, E], detJxW [q, E]) of an unstructured
    SoAProblem."""
    q, npe, _, E = p.gradN.shape
    return q, npe, p.gradN.view(q * npe * 3, E), p.detJxW
