"""The f64 assembly of the global BCSR stiffness on the card: the element
pass and the slot sum of `assembly/bcsr.py::assemble_bcsr`, the two
kernels of csrc/assembly_kernels.cu and their plain PyTorch versions.

No TPU kernel is replaced: the reference assembles in plain jnp
(`fea_large_tpu/elements/kernels.py`, `fea_large_tpu/assembly/bcsr.py`).
The kernels were added because the plain f64 pass (broadcast [E, npe, 3,
npe, 3] temporaries, then padded bucket sums) took ~39 ms of every Newton
step on the 1M-DOF TET10 box, where its least traffic takes 0.27 ms.

Layout:
    u          [N, 3]            f64 nodal displacements
    conn32     [E, npe]          int32 (`BCSRStructure.conn32`)
    gradN      [E, q, npe, 3]    `ElementGeometry`, element axis first
    detJxW     [E, q]
    blocks     [E, P, 3, 3]      each element's upper blocks Ke[a, :, b, :],
                                 a <= b, P = npe (npe + 1) / 2, in the
                                 row-major order of (a, b) (`pairs`)
    fe         [3, E*npe]        fe[i, e*npe + a]: the flat e-major slots
                                 that `NodeScatter`'s table indexes
    data       [nnzb, 3, 3]      the BCSR values

The stiffness is symmetric, Ke[a,i,b,k] = Ke[b,k,a,i], so only the upper
blocks are stored: a block with a > b is the (b, a) block transposed. The
slot sum walks `SlotTable`: slot s sums codes[offsets[s]:offsets[s + 1]]
in the plain path's (e, a, b) order (`BCSRStructure.perm`), each code
2 (e*P + p) + t naming stored block p of element e, transposed where t is
1. Each slot's entries are summed one after another in that order, by the
kernel and by its plain version alike, with no atomics: two launches are
bitwise equal, and equal to the plain version's sum of the same blocks.

`element_blocks` and `slot_sum` launch the kernels on CUDA tensors (or
raise on what they do not take) and run the plain versions on CPU tensors;
`assemble_bcsr` routes by `supported`. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.ops import cuda_build
from fea_large_tpu_torch.ops.elem_kernels import SUPPORTED
from fea_large_tpu_torch.ops.smallmat import mm3

SOURCE = cuda_build.CSRC / "assembly_kernels.cu"

#: kernel launches since the last reset (the wrappers increment these where
#: they launch their kernel, and nowhere else)
LAUNCHES = {"stiffness": 0, "slot_sum": 0}

#: the material codes the element pass computes (`material_point`)
KINDS = (0, 1, 2)


def pairs(npe: int) -> tuple[np.ndarray, np.ndarray]:
    """(a, b) of each stored block p, a <= b, in row-major order."""
    a, b = np.triu_indices(npe)
    return a, b


def supported(device, dtype, q: int, npe: int, material) -> bool:
    """Whether `assemble_bcsr` takes the kernels for u on `device` in
    `dtype` and an element of q points and npe nodes: a CUDA device, f64, a
    material the element pass computes and an element it is built for.
    Everything else takes the plain `element_stiffness` and
    `BCSRStructure.assemble_blocks`."""
    return (torch.device(device).type == "cuda" and dtype == torch.float64
            and material.kind in KINDS and (q, npe) in SUPPORTED)


@dataclasses.dataclass(frozen=True)
class SlotTable:
    """The slot sum's walk: offsets int32 [nnzb + 1], codes int32 [M] (see
    the module docstring), and the E*P stored blocks the codes name."""

    offsets: torch.Tensor
    codes: torch.Tensor
    n_blocks: int

    @staticmethod
    def build(perm: np.ndarray, segment_ids: np.ndarray, nnzb: int, npe: int,
              device) -> "SlotTable":
        """From `BCSRStructure`'s sorted map: the entries (e, a, b) = perm
        in slot order, and the slot of each (segment_ids)."""
        perm = np.asarray(perm, dtype=np.int64)
        P = npe * (npe + 1) // 2
        if 2 * (len(perm) // (npe * npe)) * P >= 2**31:
            raise ValueError("the slot table codes its blocks in int32")
        e, rest = np.divmod(perm, npe * npe)
        a, b = np.divmod(rest, npe)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        p = lo * npe - lo * (lo - 1) // 2 + hi - lo
        codes = 2 * (e * P + p) + (a > b)
        offsets = np.zeros(nnzb + 1, np.int64)
        np.cumsum(np.bincount(segment_ids, minlength=nnzb), out=offsets[1:])
        return SlotTable(torch.as_tensor(offsets, dtype=torch.int32, device=device),
                         torch.as_tensor(codes, dtype=torch.int32, device=device),
                         len(perm) // (npe * npe) * P)


# ---------------------------------------------------------------------------
# plain versions (f64 or any float dtype, any device)
# ---------------------------------------------------------------------------


def element_blocks_plain(u, conn, gradN, detJxW, material):
    """(blocks [E, P, 3, 3], fe [3, E*npe]) at u [N, 3]: the stored blocks
    of `element_stiffness`'s factored form and its force, each summed over
    the points in order,

      Ke[a,i,b,k] = sum_q V [alpha s_ai s_bk + beta/2 (B_ik G_ab + s_ak s_bi)
                             + Gs_ab delta_ik],

    s_b = F A g_b, B = F A F^T, G_ab = g_a.(A g_b), Gs_ab = g_a.(S g_b);
    fe[i, e*npe + a] = sum_q (V F S g_a)_i. As broadcast multiplies and
    sums (`mm3`): the per-element blocks as batched matrix products would
    run as millions of tiny GEMMs."""
    E, q, npe, _ = gradN.shape
    g, V = gradN, detJxW
    ue = u[conn.long()]  # [E, npe, 3]
    F = (ue[:, None, :, :, None] * g[:, :, :, None, :]).sum(2)
    F = F + torch.eye(3, dtype=u.dtype, device=u.device)
    S, alpha, A, beta = material.stress_and_factors(mm3(F.transpose(-1, -2), F))
    A = A.expand(F.shape)
    FA = mm3(F, A)
    B = mm3(FA, F.transpose(-1, -2))  # [E, q, 3, 3]

    def rows(M):  # M g_b: [E, q, npe, 3]
        return (M[:, :, None] * g[:, :, :, None, :]).sum(-1)

    s, Ag, Sg = rows(FA), rows(A), rows(S.expand(F.shape))
    a, b = (torch.as_tensor(x, device=u.device) for x in pairs(npe))
    sa, sb = s[:, :, a], s[:, :, b]  # [E, q, P, 3]
    G = (g[:, :, a] * Ag[:, :, b]).sum(-1)  # [E, q, P]
    Gs = (g[:, :, a] * Sg[:, :, b]).sum(-1)
    wa = (V * alpha.expand(V.shape))[..., None, None, None]
    wb = (0.5 * V * beta.expand(V.shape))[..., None, None, None]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    term = (wa * sa[..., :, None] * sb[..., None, :]
            + wb * (B[:, :, None] * G[..., None, None] + sb[..., :, None] * sa[..., None, :])
            + (V[..., None] * Gs)[..., None, None] * eye)  # [E, q, P, 3, 3]
    PV = mm3(F, S) * V[..., None, None]
    force = (PV[:, :, None] * g[:, :, :, None, :]).sum(-1)  # [E, q, npe, 3]
    blocks, fe = term[:, 0].contiguous(), force[:, 0]
    for k in range(1, q):
        blocks, fe = blocks + term[:, k], fe + force[:, k]
    return blocks, fe.permute(2, 0, 1).reshape(3, E * npe)


def slot_sum_plain(blocks: torch.Tensor, table: SlotTable) -> torch.Tensor:
    """data [nnzb, 3, 3]: slot s the sum of its table entries, one after
    another in the table's order (each slot's first entry, then its
    second, ...), the stored blocks read transposed where coded so."""
    flat = blocks.reshape(-1, 3, 3)
    codes = table.codes.long()
    ent = flat[codes >> 1]
    ent = torch.where((codes & 1).bool()[:, None, None], ent.transpose(1, 2), ent)
    start = table.offsets[:-1].long()
    counts = table.offsets[1:].long() - start
    data = flat.new_zeros((counts.shape[0], 3, 3))
    for j in range(int(counts.max()) if counts.numel() else 0):
        live = (counts > j)[:, None, None]
        data = data + torch.where(live, ent[(start + j).clamp(max=max(len(codes) - 1, 0))], 0.0)
    return data


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _library():
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return cuda_build.load(SOURCE, {
        "fea_asm_stiffness_f64": [P] * 6 + [I] * 4 + [D, D, P],
        "fea_asm_slot_sum_f64": [P] * 4 + [I, P],
    })


def _check(named: dict, shapes: dict, dtypes: dict, device):
    """Raise unless every tensor is a contiguous tensor of its dtype, on
    `device` (a CUDA device), with its shape."""
    for name, x in named.items():
        if x.device != device or x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {x.device}")
        if x.dtype != dtypes[name]:
            raise TypeError(f"{name}: the kernel takes {dtypes[name]}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(x.shape)}")


def _launch(fn: str, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), f"fea_asm_{fn}_f64")(*args, stream)
    if err != 0:
        raise RuntimeError(f"assembly {fn} kernel launch failed: CUDA error {err}")
    LAUNCHES[fn] += 1


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def element_blocks(u, conn32, gradN, detJxW, material, out=None):
    """(blocks [E, P, 3, 3], fe [3, E*npe]): see `element_blocks_plain`.
    On CUDA tensors the element pass `stiffness_kernel`, writing the blocks
    into `out` where given (a buffer kept across calls). Every conn32 entry
    must be a node of u."""
    if u.device.type == "cpu":
        return element_blocks_plain(u, conn32, gradN, detJxW, material)
    if material.kind not in KINDS:
        raise NotImplementedError(f"the element pass takes the material codes {KINDS}; got "
                                  f"{type(material).__name__}")
    E, q, npe, _ = gradN.shape
    if (q, npe) not in SUPPORTED:
        raise ValueError(f"no assembly kernel for (q, npe) = {(q, npe)}")
    P = npe * (npe + 1) // 2
    blocks = u.new_empty((E, P, 3, 3)) if out is None else out
    f64, i32 = torch.float64, torch.int32
    named = {"u": u, "conn32": conn32, "gradN": gradN, "detJxW": detJxW, "out": blocks}
    _check(named, {"u": (u.shape[0], 3), "conn32": (E, npe), "gradN": (E, q, npe, 3),
                   "detJxW": (E, q), "out": (E, P, 3, 3)},
           {"u": f64, "conn32": i32, "gradN": f64, "detJxW": f64, "out": f64}, u.device)
    fe = u.new_empty((3, E * npe))
    _launch("stiffness", u.device, *(_ptr(x) for x in named.values()), _ptr(fe), E, q, npe,
            material.kind, ctypes.c_double(material.lam), ctypes.c_double(material.mu))
    return blocks, fe


def slot_sum(blocks: torch.Tensor, table: SlotTable) -> torch.Tensor:
    """data [nnzb, 3, 3]: see `slot_sum_plain`. On CUDA tensors
    `slot_sum_kernel`, a thread a slot."""
    if blocks.device.type == "cpu":
        return slot_sum_plain(blocks, table)
    nnzb, M = table.offsets.shape[0] - 1, table.codes.shape[0]
    i32 = torch.int32
    _check({"blocks": blocks, "offsets": table.offsets, "codes": table.codes},
           {"blocks": tuple(blocks.shape), "offsets": (nnzb + 1,), "codes": (M,)},
           {"blocks": torch.float64, "offsets": i32, "codes": i32}, blocks.device)
    if (blocks.dim() != 4 or blocks.shape[2:] != (3, 3) or nnzb <= 0
            or blocks.shape[0] * blocks.shape[1] != table.n_blocks):
        raise ValueError(f"blocks: expected the table's {table.n_blocks} blocks [E, P, 3, 3] "
                         f"and its slots, got {tuple(blocks.shape)} and {nnzb} slots")
    data = blocks.new_empty((nnzb, 3, 3))
    _launch("slot_sum", blocks.device, _ptr(blocks), _ptr(table.offsets), _ptr(table.codes),
            _ptr(data), nnzb)
    return data
