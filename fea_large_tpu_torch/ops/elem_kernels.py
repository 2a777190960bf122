"""Element-block passes on unstructured meshes: the four Hopper kernels and
their plain PyTorch versions (counterpart of
`fea_large_tpu/ops/pallas_kernels.py` and of the unstructured part of
`fea_large_tpu/ops/pallas_residual.py`).

Layout, kept from the reference: every operand is [rows, E], element axis
last, in the flattened SoA form

    v          [3, N]          nodal values, with conn [npe, E] (B6)
    ve, ue     [3*npe, E]      gathered nodal values, rows 3a + i
    gradN      [q*npe*3, E]    rows (k*npe + a)*3 + J
    detJxW     [q, E]
    F, S, A    [q*9, E]        rows k*9 + 3i + j (the [q, 3, 3, E] state)
    alpha, beta [q, E]
    out        [3*npe, E]      per-element nodal result, rows i*npe + a

The residual pass writes its nodal force in the same rows i*npe + a, so
every output of this module is a free [3, npe, E] view for the nodal sum
(the reference's residual kernel writes rows 3a + i instead).

The tangent action's kernel (B6) gathers its nodal values itself: it
reads v [3, N] at the int32 connectivity (`SoAProblem.conn32`), where the
TPU's kernel takes them gathered by XLA; its plain version takes them
gathered (`_gather_flat`), as the freeze and the residual do on the card.
Every element pass's output is summed into nodes in a fixed order by
`nodal_sum` (ops/soa.py `soa_scatter`): a kernel on the card, f32 and f64,
that walks each node's slots (`ScatterBuckets.csr`); the valence buckets'
plain sum (`ScatterBuckets.apply`) on the CPU.

Each pass has a kernel (csrc/elem_kernels.cu, CUDA C++ for sm_90a: f32
for the tangent passes, f64 for the residual) and a plain version here
(`*_plain`, any float dtype). A wrapper (`elem_apply`, `elem_freeze`,
`elem_force`, `elem_resid`, `elem_diag`, `nodal_sum`) runs the plain
version when its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises. The unstructured f32 passes of ops/soa.py go through
`elem_freeze`, `elem_apply`, `elem_force` and `elem_diag`; the f64
residual of the mixed path goes through `elem_resid` (ops/residual.py).
`LAUNCHES` counts kernel launches per pass.

The block-Jacobi diagonal (`elem_diag`) has no TPU kernel in the
reference: its element pass writes per-slot sums, and a second kernel sums
them into nodal blocks, walking the same table as `nodal_sum` in the
valence buckets' fixed order. Its plain version ends in the buckets' sum
(ops/soa.py `ScatterBuckets`), so both return the [3, 3, N] blocks.
"""

from __future__ import annotations

import ctypes

import torch

from fea_large_tpu_torch.ops import cuda_build
from fea_large_tpu_torch.ops.smallmat import mm3

#: kernel launches per pass since the last reset (the wrappers increment
#: these where they launch their kernel, and nowhere else)
#: ("diag" counts a call of `elem_diag`: its element pass and nodal sum)
LAUNCHES = {"apply": 0, "freeze": 0, "force": 0, "resid": 0, "diag": 0, "nodal_sum": 0}

#: (q, npe) the kernels are instantiated for: TET10 with the 4-point and
#: the 5-point rule and TET4 with the 1-point rule
SUPPORTED = ((4, 10), (5, 10), (1, 4))

#: threads (elements) per block of the kernels
BLOCK = 128

SOURCE = cuda_build.CSRC / "elem_kernels.cu"

#: floats per element slot of the diagonal's scratch (six sums, padded to
#: one 32-byte sector)
SLOT_PAD = 8

#: channels of `nodal_sum`'s kernel (a nodal vector's three components)
SUM_CHANNELS = 3


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


def elem_diag_plain(gradN, detJxW, F, S, A, alpha, beta, buckets, *, npe: int, q: int):
    """Nodal 3x3 block-Jacobi diagonal [3, 3, N] (rows 3i + k): per
    element slot sum_q V [(alpha + beta/2) s_a s_a^T + (beta/2) B G_aa +
    (g_a.S.g_a) I] with FA = F A, B = FA F^T, s_a = FA g_a, G_aa =
    g_a.A.g_a, summed into nodes by `buckets` (a `ScatterBuckets` of the
    flat a-major slots). Written as broadcast multiplies and sums (`mm3`):
    as batched matrix products the per-element 3x3 blocks run as millions
    of tiny GEMMs."""
    g = _g(gradN, q, npe)  # [q, E, npe, 3]
    gJ = g[..., None, :]  # [q, E, npe, 1, 3]
    F, S, A = (_points(x, q)[:, :, None] for x in (F, S, A))  # [q, E, 1, 3, 3]
    FA = mm3(F, A)
    B = mm3(FA, F.transpose(-1, -2))
    s = (FA * gJ).sum(-1)  # [q, E, npe, 3]
    G = (g * (A * gJ).sum(-1)).sum(-1)  # [q, E, npe]
    geo = (g * (S * gJ).sum(-1)).sum(-1) * detJxW[..., None]
    w1 = ((alpha + 0.5 * beta) * detJxW)[..., None, None, None]
    w2 = (0.5 * beta * detJxW)[..., None, None, None]
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    term = (
        w1 * s[..., :, None] * s[..., None, :]
        + w2 * B * G[..., None, None]
        + geo[..., None, None] * eye
    )  # [q, E, npe, 3, 3]
    slots = term.sum(0).permute(2, 3, 1, 0).reshape(9, -1)  # [9, npe*E], a-major
    return buckets.apply(slots).view(3, 3, -1)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _library():
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load(SOURCE, {
        "fea_elem_freeze_f32": [P] * 7 + [I] * 5 + [Fl, Fl, P],
        "fea_elem_apply_f32": [P] * 10 + [I] * 5 + [P],
        "fea_elem_force_f32": [P] * 5 + [I] * 4 + [P],
        "fea_elem_resid_f64": [P] * 4 + [I] * 5 + [ctypes.c_double] * 2 + [P],
        "fea_elem_diag_f32": [P] * 8 + [I] * 4 + [P],
        "fea_elem_diag_sum_f32": [P] * 4 + [I] * 2 + [P],
        "fea_elem_nodal_sum_f32": [P] * 4 + [I] * 4 + [P],
        "fea_elem_nodal_sum_f64": [P] * 4 + [I] * 4 + [P],
    })


def _check(named: dict, shapes: dict, npe: int, q: int, block: int,
           dtype: torch.dtype = torch.float32):
    """Raise unless every tensor is a contiguous `dtype` tensor on one CUDA
    device with the expected shape, for a supported element and block."""
    if (q, npe) not in SUPPORTED:
        raise ValueError(f"no element kernel for (q, npe) = {(q, npe)}")
    _check_block(block)
    _check_tensors(named, shapes, dtype)


def _check_block(block: int, most: int = 256):
    if not (0 < block <= most and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 up to {most}, got {block}")


def _check_tensors(named: dict, shapes: dict, dtype: torch.dtype, device=None):
    """Raise unless every tensor is a contiguous `dtype` tensor on one CUDA
    device (`device` where given) with the expected shape."""
    dev = next(iter(named.values())).device if device is None else device
    for name, x in named.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(x.shape)}")


def _call(fn: str, device, *args, suffix: str = "f32"):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), f"fea_elem_{fn}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"element {fn} kernel launch failed: CUDA error {err}")


def _launch(fn: str, device, *args, suffix: str = "f32"):
    _call(fn, device, *args, suffix=suffix)
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


def elem_apply(v, conn, gradN, detJxW, F, S, A, alpha, beta, *, npe: int, q: int,
               block: int = BLOCK):
    """B6 (`pallas_kernels.py::_apply_kernel`) with the gather before it:
    the nodal values of v [3, N] at conn [npe, E] (int32 on the card), then
    `elem_apply_plain`. Every conn entry must be a node of v."""
    if v.device.type == "cpu":
        return _apply_plain(v, conn, gradN, detJxW, F, S, A, alpha, beta, npe=npe, q=q)
    E, N = conn.shape[-1], v.shape[-1]
    named = {"v": v, "gradN": gradN, "detJxW": detJxW, "F": F, "S": S, "A": A,
             "alpha": alpha, "beta": beta}
    rq, rp = (q * 9, E), (q, E)
    _check(named, {"v": (3, N), "gradN": (q * npe * 3, E), "detJxW": rp,
                   "F": rq, "S": rq, "A": rq, "alpha": rp, "beta": rp}, npe, q, block)
    _check_tensors({"conn": conn}, {"conn": (npe, E)}, torch.int32, v.device)
    out = v.new_empty((3 * npe, E))
    _launch("apply", v.device, _ptr(v), _ptr(conn),
            *(_ptr(x) for x in (gradN, detJxW, F, S, A, alpha, beta)), _ptr(out), E, N, q, npe,
            block)
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


def _table(buckets, device, n_in: int):
    """(offsets, ids, N) of `buckets.csr`, raised on unless it lies on
    `device` and indexes no slot at or past `n_in`."""
    offsets, ids, span = buckets.csr
    _check_tensors({"offsets": offsets, "ids": ids},
                   {"offsets": tuple(offsets.shape), "ids": tuple(ids.shape)}, torch.int32, device)
    if offsets.dim() != 1 or span > n_in:
        raise ValueError(f"the nodal table takes [N + 1] offsets and {span} or more slots, "
                         f"got {tuple(offsets.shape)} and {n_in}")
    return offsets, ids, offsets.shape[0] - 1


def nodal_sum(d, buckets, *, block: int = BLOCK):
    """The fixed-order nodal sum of per-slot values d [3, M] (M = npe*E flat
    a-major slots; f32 or f64) -> [3, N]: each node's slots summed in the
    valence buckets' order, walking `buckets.csr`; no atomics, repeats
    bitwise equal. On CPU tensors `buckets.apply` (any channel count)."""
    if d.device.type == "cpu":
        return buckets.apply(d)
    _check_block(block)
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"d: the nodal sum takes float32 or float64, got {d.dtype}")
    C, M = d.shape
    if C != SUM_CHANNELS:
        raise ValueError(f"d: the nodal sum's kernel takes {SUM_CHANNELS} channels, got {C}")
    _check_tensors({"d": d}, {"d": (C, M)}, d.dtype)
    offsets, ids, N = _table(buckets, d.device, M)
    out = d.new_empty((C, N))
    _launch("nodal_sum", d.device, _ptr(d), _ptr(offsets), _ptr(ids), _ptr(out), C, M, N, block,
            suffix="f32" if d.dtype == torch.float32 else "f64")
    return out


def diag_slots(gradN, detJxW, F, S, A, alpha, beta, *, npe: int, q: int, block: int = BLOCK):
    """The diagonal's element pass (counted by `elem_diag`, not here): the
    six upper-triangle sums of every slot, [npe*E, SLOT_PAD] a-major.
    Blocks of at most 128 threads (its launch bounds)."""
    _check_block(block, 128)
    E = gradN.shape[-1]
    named = {"gradN": gradN, "detJxW": detJxW, "F": F, "S": S, "A": A, "alpha": alpha,
             "beta": beta}
    rq, rp = (q * 9, E), (q, E)
    _check(named, {"gradN": (q * npe * 3, E), "detJxW": rp, "F": rq, "S": rq, "A": rq,
                   "alpha": rp, "beta": rp}, npe, q, block)
    slots = gradN.new_empty((npe * E, SLOT_PAD))
    _call("diag", gradN.device, *(_ptr(x) for x in named.values()), _ptr(slots), E, q, npe, block)
    return slots


def diag_sum(slots, buckets, *, block: int = BLOCK):
    """The diagonal's nodal sum (counted by `elem_diag`, not here): the
    slots' sums in the buckets' fixed order (`buckets.csr`, as
    `nodal_sum`), [3, 3, N]."""
    _check_block(block)
    _check_tensors({"slots": slots}, {"slots": (slots.shape[0], SLOT_PAD)}, torch.float32)
    offsets, ids, N = _table(buckets, slots.device, slots.shape[0])
    out = slots.new_empty((3, 3, N))
    _call("diag_sum", slots.device, _ptr(slots), _ptr(offsets), _ptr(ids), _ptr(out), N, block)
    return out


def elem_diag(gradN, detJxW, F, S, A, alpha, beta, buckets, *, npe: int, q: int,
              block: int = BLOCK):
    """The block-Jacobi diagonal (no TPU kernel): the element pass
    (`diag_slots`) and the nodal sum (`diag_sum`), one count of
    `LAUNCHES["diag"]`. See `elem_diag_plain`."""
    if gradN.device.type == "cpu":
        return elem_diag_plain(gradN, detJxW, F, S, A, alpha, beta, buckets, npe=npe, q=q)
    out = diag_sum(diag_slots(gradN, detJxW, F, S, A, alpha, beta, npe=npe, q=q, block=block),
                   buckets, block=block)
    LAUNCHES["diag"] += 1
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


def _gather_rows(v_T, conn_T):
    """v_T [3, N] at conn_T [npe, E] -> [3*npe, E] rows 3a + i."""
    ve = v_T[:, conn_T]  # [3, npe, E]
    return ve.transpose(0, 1).reshape(-1, ve.shape[-1])


def _apply_plain(v_T, conn_T, *args, **kw):
    """`elem_apply_plain` on the nodal values of v_T at conn_T: what
    `elem_apply` runs on the CPU, and the f64 tangent action."""
    return elem_apply_plain(_gather_rows(v_T, conn_T), *args, **kw)


def _gather_flat(p, v_T):
    """v_T [3, N] -> [3*npe, E] rows 3a + i (`soa_gather`, transposed)."""
    return _gather_rows(v_T, p.conn_T)


def flat_tables(p):
    """(q, npe, gradN [q*npe*3, E], detJxW [q, E]) of an unstructured
    SoAProblem."""
    q, npe, _, E = p.gradN.shape
    return q, npe, p.gradN.view(q * npe * 3, E), p.detJxW
