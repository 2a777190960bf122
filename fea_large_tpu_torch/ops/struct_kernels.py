"""Structured-lattice element passes: the four Hopper kernels and their
plain PyTorch versions (counterpart of `fea_large_tpu/ops/pallas_structured.py`).

Decomposition, kept from the reference:

  * the gather of nodal values into the (class, offset) PAIR CACHE
    [n_comp*P, C] (`gather_cache`) and the scatter of pair rows back to
    nodes (`scatter_pairs`) are plain tensor slicing and slice-adds on the
    class grids of the `BoxStructure`: no indices, fixed order;
  * the per-cell element math between them is one pass over the cell axis
    C, on `[rows, C]` tensors. State rows are r = (k*9 + 3i + j)*T + t
    (the free [q, 3, 3, T, C] view of the [q, 3, 3, E] state, E = T*C
    tet-slot-major); per-point scalars are rows k*T + t; output rows are
    n_comp*pair + comp.

Each pass has a kernel (csrc/struct_kernels.cu, CUDA C++ for sm_90a: the
four f32 passes, and the f64 residual) and a plain version in this module
(`*_plain`, any float dtype). A wrapper (`struct_apply`, `struct_freeze`,
`struct_diag`, `struct_force`, `struct_resid`) runs the plain version when
its tensors lie on the CPU; on a CUDA tensor it launches the kernel or
raises. There is no fallback from a failed build or launch. `LAUNCHES`
counts kernel launches per pass.

The kernels keep a warp's lanes along the cell axis, so every row access
is coalesced, and are bound by memory traffic (B5 as much by its f64
arithmetic). All five run one thread per (tet slot, cell) in blocks of 32
cells. B2 stores the state rows of its slot straight from registers. B1
(every PCG iteration), B3, B4 and B5 sum their nodal contributions over the
points in registers (B1, B4 and B5 npe x 3, B5 in double; B3 the upper
triangle of its symmetric 3x3 blocks, npe x 6), and each block then sums
the slots of every pair through shared memory in the t-major order of
`StructTables.slot_table` (the order of `_pair_rows`) and writes each
output row once. No atomics; repeats are bitwise equal.

The kernels are built with nvcc at first use (ops/cuda_build.py) and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from fea_large_tpu_torch.ops import cuda_build
from fea_large_tpu_torch.ops.smallmat import mm3

#: kernel launches per pass since the last reset (the wrappers increment
#: these where they launch their kernel, and nowhere else)
LAUNCHES = {"freeze": 0, "apply": 0, "diag": 0, "force": 0, "resid": 0}

#: (q, npe, T) lattices the kernels are instantiated for: TET10 with the
#: 4-point and the 5-point rule and TET4 with the 1-point rule, on the
#: 6-tet Kuhn cell
SUPPORTED = ((4, 10, 6), (5, 10, 6), (1, 4, 6))

SOURCE = cuda_build.CSRC / "struct_kernels.cu"


# ---------------------------------------------------------------------------
# (class, offset) pairs, gather and scatter
# ---------------------------------------------------------------------------


def struct_pairs(st):
    """Ordered distinct (class, offset) pairs of the lattice connectivity
    and the per-(tet-slot, node-slot) pair index (P = 27 for TET10 Kuhn,
    8 for TET4)."""
    pairs, index = [], {}
    pair_of = [[None] * st.npe for _ in range(st.n_tets)]
    for t in range(st.n_tets):
        for a in range(st.npe):
            key = (st.slot_class[t][a], st.slot_offset[t][a])
            if key not in index:
                index[key] = len(pairs)
                pairs.append(key)
            pair_of[t][a] = index[key]
    return pairs, pair_of


def _pair_slice(st, v: torch.Tensor, key) -> torch.Tensor:
    """v [n, N] -> [n, C] node values of one (class, offset) pair: reshape
    the class grid and take the offset slice."""
    nx, ny, nz = st.cells
    kc, o = key
    gx, gy, gz = st.class_dims[kc]
    b = st.class_base[kc]
    g = v[:, b : b + gx * gy * gz].reshape(v.shape[0], gx, gy, gz)
    return g[:, o[0] : o[0] + nx, o[1] : o[1] + ny, o[2] : o[2] + nz].reshape(
        v.shape[0], -1
    )


def gather_cache(st, pairs, v_T: torch.Tensor) -> torch.Tensor:
    """[n_comp, N] -> [n_comp*P, C] stacked pair slices (rows n_comp*pi + i)."""
    n = v_T.shape[0]
    return torch.stack([_pair_slice(st, v_T, key) for key in pairs]).reshape(
        len(pairs) * n, st.n_cells
    )


def scatter_pairs(st, pairs, out: torch.Tensor, n_comp: int) -> torch.Tensor:
    """[n_comp*P, C] pair-row cell sums -> [n_comp, N] nodal sums: each
    pair's cell block is added into its class grid at the pair's offset,
    in pair order (the transpose of `gather_cache`)."""
    nx, ny, nz = st.cells
    rows = out.reshape(len(pairs), n_comp, nx, ny, nz)
    grids = [
        torch.zeros((n_comp, *dims), dtype=out.dtype, device=out.device)
        for dims in st.class_dims
    ]
    for pi, (kc, o) in enumerate(pairs):
        grids[kc][:, o[0] : o[0] + nx, o[1] : o[1] + ny, o[2] : o[2] + nz] += rows[pi]
    return torch.cat([g.reshape(n_comp, -1) for g in grids], 1)


# ---------------------------------------------------------------------------
# per-slot geometry tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StructTables:
    """Per-tet-slot geometry of a uniform lattice, on one device.

    gN        [q, npe, 3, T] shape-function gradients (same for every cell)
    dV        [q, T] quadrature weight x det J
    pair_of   int32 [T, npe] pair index of each (tet slot, node slot)
    slot_rows int64 [P, T] the (t*npe + a) slots of each pair in t-major
              order (at most T: a pair is a node of a tet at most once),
              padded with T*npe (a zero row) — the plain versions'
              fixed-order pair sums
    slot_table int32 copy of slot_rows for the kernels B1, B3, B4 and B5,
              whose blocks sum each pair row over these slots in this order
    """

    q: int
    npe: int
    T: int
    C: int
    pairs: tuple
    gN: torch.Tensor
    dV: torch.Tensor
    pair_of: torch.Tensor
    slot_rows: torch.Tensor
    slot_table: torch.Tensor

    @property
    def P(self) -> int:
        return len(self.pairs)

    @staticmethod
    def build(st, gN: np.ndarray, dV: np.ndarray, dtype, device) -> "StructTables":
        pairs, pair_of = struct_pairs(st)
        T, npe = st.n_tets, st.npe
        slots = [[] for _ in pairs]
        for t in range(T):
            for a in range(npe):
                slots[pair_of[t][a]].append(t * npe + a)
        slot_rows = np.full((len(pairs), T), T * npe, np.int64)
        for pi, s in enumerate(slots):
            slot_rows[pi, : len(s)] = s
        return StructTables(
            q=gN.shape[0], npe=npe, T=T, C=st.n_cells, pairs=tuple(pairs),
            gN=torch.as_tensor(gN, dtype=dtype, device=device).contiguous(),
            dV=torch.as_tensor(dV, dtype=dtype, device=device).contiguous(),
            pair_of=torch.as_tensor(np.asarray(pair_of), dtype=torch.int32,
                                    device=device),
            slot_rows=torch.as_tensor(slot_rows, device=device),
            slot_table=torch.as_tensor(slot_rows, dtype=torch.int32, device=device),
        )


# ---------------------------------------------------------------------------
# plain versions (any float dtype, any device)
# ---------------------------------------------------------------------------


def _state(tb: StructTables, rows: torch.Tensor) -> torch.Tensor:
    """[q*9*T, C] state rows -> [q, T, C, 3, 3] view."""
    return rows.view(tb.q, 3, 3, tb.T, tb.C).permute(0, 3, 4, 1, 2)


def _point(tb: StructTables, rows: torch.Tensor) -> torch.Tensor:
    """[q*T, C] per-point rows -> [q, T, C, 1, 1] view."""
    return rows.view(tb.q, tb.T, tb.C)[..., None, None]


def _g(tb: StructTables) -> torch.Tensor:
    """gN as [q, T, npe, 3]."""
    return tb.gN.permute(0, 3, 1, 2)


def _slot_values(tb: StructTables, cache: torch.Tensor, n: int) -> torch.Tensor:
    """[n*P, C] pair cache -> [T, npe, n, C] per-slot nodal values."""
    idx = tb.pair_of.long()
    return cache.view(tb.P, n, tb.C)[idx]


def _grad(tb: StructTables, cache: torch.Tensor) -> torch.Tensor:
    """sum_a v_a (x) g_a at every point: [q, T, C, 3, 3]."""
    return torch.einsum("taic,qtaj->qtcij", _slot_values(tb, cache, 3), _g(tb))


def _pair_rows(tb: StructTables, contrib: torch.Tensor) -> torch.Tensor:
    """[T, npe, n, C] per-slot sums -> [n*P, C] pair rows (fixed order)."""
    T, npe, n, C = contrib.shape
    flat = torch.cat([contrib.reshape(T * npe, n, C), contrib.new_zeros(1, n, C)])
    return flat[tb.slot_rows].sum(1).reshape(tb.P * n, C)


def _nodal(tb: StructTables, PV: torch.Tensor) -> torch.Tensor:
    """sum_q PV g_a for weighted stress-like PV [q, T, C, 3, 3] -> pair rows."""
    return _pair_rows(tb, torch.einsum("qtciJ,qtaJ->taic", PV, _g(tb)))


def struct_freeze_plain(tb: StructTables, cache: torch.Tensor, material):
    """F = I + sum_a u_a (x) g_a, C = F^T F, and the material's (S, alpha,
    A, beta). Returns rows (F, S, A [q*9*T, C]; alpha, beta [q*T, C])."""
    grad = _grad(tb, cache)
    F = grad + torch.eye(3, dtype=grad.dtype, device=grad.device)
    S, alpha, A, beta = material.stress_and_factors(mm3(F.transpose(-1, -2), F))

    def rows(x):  # [q, T, C, 3, 3] -> [q*9*T, C]
        return x.expand(F.shape).permute(0, 3, 4, 1, 2).reshape(-1, tb.C)

    return (
        rows(F), rows(S), rows(A),
        alpha.expand(F.shape[:3]).reshape(-1, tb.C),
        beta.expand(F.shape[:3]).reshape(-1, tb.C),
    )


def struct_force_plain(tb: StructTables, F: torch.Tensor, S: torch.Tensor):
    """Internal force f_a = sum_q V (F S) g_a from the frozen state: [3P, C]."""
    V = tb.dV[:, :, None, None, None]
    return _nodal(tb, mm3(_state(tb, F), _state(tb, S)) * V)


def struct_apply_plain(tb: StructTables, cache, F, S, A, alpha, beta):
    """Tangent action per cell: dF = sum_a v_a (x) g_a, dE = sym(F^T dF),
    dS = alpha (A:dE) A + beta A dE A, dP = dF S + F dS; V dP g_a summed
    into pair rows [3P, C]."""
    F, S, A = _state(tb, F), _state(tb, S), _state(tb, A)
    al, be = _point(tb, alpha), _point(tb, beta)
    V = tb.dV[:, :, None, None, None]
    dF = _grad(tb, cache)
    FtdF = mm3(F.transpose(-1, -2), dF)
    dE = 0.5 * (FtdF + FtdF.transpose(-1, -2))
    AdE = (A * dE).sum((-2, -1), keepdim=True)
    dS = al * AdE * A + be * mm3(mm3(A, dE), A)
    return _nodal(tb, (mm3(dF, S) + mm3(F, dS)) * V)


def struct_diag_plain(tb: StructTables, F, S, A, alpha, beta):
    """Nodal 3x3 block-Jacobi diagonal per cell:
    sum_q V [(alpha + beta/2) s_a s_a^T + (beta/2) B G_aa + (g_a.S.g_a) I]
    with FA = F A, B = FA F^T, s_a = FA g_a, G_aa = g_a.A.g_a. Pair rows
    [9P, C], row 9*pair + 3i + k."""
    F, S, A = _state(tb, F), _state(tb, S), _state(tb, A)
    al, be = _point(tb, alpha)[..., 0], _point(tb, beta)[..., 0]  # [q,T,C,1]
    V = tb.dV[:, :, None, None]
    g = _g(tb)  # [q, T, npe, 3]
    FA = mm3(F, A)
    B = mm3(FA, F.transpose(-1, -2))
    s = torch.einsum("qtciJ,qtaJ->qtcai", FA, g)  # [q, T, C, npe, 3]
    G = torch.einsum("qtcIJ,qtaJ,qtaI->qtca", A, g, g)  # [q, T, C, npe]
    geo = V * torch.einsum("qtcIJ,qtaJ,qtaI->qtca", S, g, g)
    w1 = ((al + 0.5 * be) * V)[..., None, None]
    w2 = (0.5 * be * V)[..., None, None]
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    term = (
        w1 * s[..., :, None] * s[..., None, :]
        + w2 * B[:, :, :, None] * G[..., None, None]
        + geo[..., None, None] * eye
    )  # [q, T, C, npe, 3, 3]
    contrib = term.sum(0).permute(0, 2, 3, 4, 1).reshape(tb.T, tb.npe, 9, tb.C)
    return _pair_rows(tb, contrib)


def struct_resid_plain(tb: StructTables, cache: torch.Tensor, material):
    """Internal force f_a = sum_q V (F S(C)) g_a straight from the pair
    cache of u: the freeze followed by the force, [3P, C]."""
    F, S = struct_freeze_plain(tb, cache, material)[:2]
    return struct_force_plain(tb, F, S)


# ---------------------------------------------------------------------------
# kernel library
# ---------------------------------------------------------------------------


def _library():
    P, I, Fl, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    return cuda_build.load(SOURCE, {
        "fea_struct_freeze_f32": [P] * 8 + [I] * 5 + [Fl, Fl, P],
        "fea_struct_apply_f32": [P] * 11 + [I] * 5 + [P],
        "fea_struct_diag_f32": [P] * 10 + [I] * 5 + [P],
        "fea_struct_force_f32": [P] * 7 + [I] * 5 + [P],
        "fea_struct_resid_f64": [P] * 6 + [I] * 6 + [D, D, P],
    })


def _check(tb: StructTables, named: dict, shapes: dict, dtype=torch.float32):
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype` on
    the tables' device with the expected shape, on a supported lattice."""
    if (tb.q, tb.npe, tb.T) not in SUPPORTED:
        raise ValueError(f"no kernel for (q, npe, T) = {(tb.q, tb.npe, tb.T)}")
    dev = tb.gN.device
    for name, x in {**named, "gN": tb.gN, "dV": tb.dV}.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on {dev}, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(named[name].shape)}")


def _launch(fn: str, *args, suffix="f32"):
    stream = torch.cuda.current_stream(torch.cuda.current_device()).cuda_stream
    err = getattr(_library(), f"fea_struct_{fn}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"struct {fn} kernel launch failed: CUDA error {err}")
    LAUNCHES[fn] += 1


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _dims(tb: StructTables, *extra):
    return (tb.C, tb.q, tb.npe, tb.T, *extra)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def struct_freeze(tb: StructTables, cache: torch.Tensor, material):
    """B2 (`_freeze_kernel`): see `struct_freeze_plain`."""
    if cache.device.type == "cpu":
        return struct_freeze_plain(tb, cache, material)
    if material.kind not in (0, 1, 2):
        raise ValueError(f"no freeze kernel for material {type(material).__name__}")
    rq, rp = tb.q * 9 * tb.T, tb.q * tb.T
    _check(tb, {"cache": cache}, {"cache": (3 * tb.P, tb.C)})
    F, S, A = (cache.new_empty((rq, tb.C)) for _ in range(3))
    al, be = (cache.new_empty((rp, tb.C)) for _ in range(2))
    with torch.cuda.device(cache.device):
        _launch(
            "freeze", _ptr(cache), _ptr(tb.gN), _ptr(tb.pair_of), _ptr(F),
            _ptr(S), _ptr(A), _ptr(al), _ptr(be), *_dims(tb, material.kind),
            ctypes.c_float(material.lam), ctypes.c_float(material.mu),
        )
    return F, S, A, al, be


def struct_apply(tb: StructTables, cache, F, S, A, alpha, beta):
    """B1 (`_apply_kernel`): see `struct_apply_plain`."""
    if cache.device.type == "cpu":
        return struct_apply_plain(tb, cache, F, S, A, alpha, beta)
    rq, rp = (tb.q * 9 * tb.T, tb.C), (tb.q * tb.T, tb.C)
    named = {"cache": cache, "F": F, "S": S, "A": A, "alpha": alpha, "beta": beta}
    _check(tb, named, {"cache": (3 * tb.P, tb.C), "F": rq, "S": rq, "A": rq,
                       "alpha": rp, "beta": rp})
    out = cache.new_empty((3 * tb.P, tb.C))
    with torch.cuda.device(cache.device):
        _launch(
            "apply", _ptr(cache), _ptr(F), _ptr(S), _ptr(A), _ptr(alpha),
            _ptr(beta), _ptr(tb.gN), _ptr(tb.dV), _ptr(tb.pair_of),
            _ptr(tb.slot_table), _ptr(out), *_dims(tb, tb.P),
        )
    return out


def struct_diag(tb: StructTables, F, S, A, alpha, beta):
    """B3 (`_diag_kernel`): see `struct_diag_plain`."""
    if F.device.type == "cpu":
        return struct_diag_plain(tb, F, S, A, alpha, beta)
    rq, rp = (tb.q * 9 * tb.T, tb.C), (tb.q * tb.T, tb.C)
    named = {"F": F, "S": S, "A": A, "alpha": alpha, "beta": beta}
    _check(tb, named, {"F": rq, "S": rq, "A": rq, "alpha": rp, "beta": rp})
    out = F.new_empty((9 * tb.P, tb.C))
    with torch.cuda.device(F.device):
        _launch(
            "diag", _ptr(F), _ptr(S), _ptr(A), _ptr(alpha), _ptr(beta),
            _ptr(tb.gN), _ptr(tb.dV), _ptr(tb.pair_of), _ptr(tb.slot_table),
            _ptr(out), *_dims(tb, tb.P),
        )
    return out


def struct_force(tb: StructTables, F, S):
    """B4 (`_force_kernel`): see `struct_force_plain`."""
    if F.device.type == "cpu":
        return struct_force_plain(tb, F, S)
    rq = (tb.q * 9 * tb.T, tb.C)
    _check(tb, {"F": F, "S": S}, {"F": rq, "S": rq})
    out = F.new_empty((3 * tb.P, tb.C))
    with torch.cuda.device(F.device):
        _launch(
            "force", _ptr(F), _ptr(S), _ptr(tb.gN), _ptr(tb.dV),
            _ptr(tb.pair_of), _ptr(tb.slot_table), _ptr(out), *_dims(tb, tb.P),
        )
    return out


def struct_resid(tb: StructTables, cache: torch.Tensor, material):
    """B5 (`pallas_residual.py::_resid_kernel`), in f64: see
    `struct_resid_plain`."""
    if cache.device.type == "cpu":
        return struct_resid_plain(tb, cache, material)
    if material.kind not in (0, 1, 2):
        raise ValueError(f"no residual kernel for material {type(material).__name__}")
    _check(tb, {"cache": cache}, {"cache": (3 * tb.P, tb.C)}, torch.float64)
    out = cache.new_empty((3 * tb.P, tb.C))
    with torch.cuda.device(cache.device):
        _launch(
            "resid", _ptr(cache), _ptr(tb.gN), _ptr(tb.dV), _ptr(tb.pair_of),
            _ptr(tb.slot_table), _ptr(out), *_dims(tb, tb.P, material.kind),
            ctypes.c_double(material.lam), ctypes.c_double(material.mu),
            suffix="f64",
        )
    return out
