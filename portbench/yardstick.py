"""The benchmark's yardstick for kernels: the card's published peaks and the
work of each operation counted from the configuration's shapes.

Work is counted once per call from the shapes and storage types the
configuration states, never from the program's tensors, so a later change to
a kernel, its storage or its fusion is measured against the same work. Bytes:
each input read once and each output written once (the byte arithmetic of
chip_smoke.py's `bound` and `nbytes`). A call's bound is the larger of its
bytes over HBM's rate and its arithmetic over the peak rate of its type.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, at its 700 W power limit: HBM3 bytes/s and
#: dense FLOP/s (f32 and f64 outside the tensor cores, bf16 on them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
ITEM_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}

#: TET10 with the 4-point rule: quadrature points and nodes a tet; the
#: 6-tet Kuhn cell: tets a cell, and the distinct (node class, lattice
#: offset) pairs its TET10 nodes fall in (the rows of the lattice kernels'
#: gathered cache)
TET10_Q, TET10_NPE = 4, 10
KUHN_T, KUHN_PAIRS = 6, 27


def apply_point_flops(npe: int) -> int:
    """Arithmetic of the tangent action a quadrature point, counted from the
    kernels' sources (a multiply-add is 2): two nodal contractions of 18*npe
    each and 360 for the linearized stress."""
    return 36 * npe + 360


def tangent_apply_work(config: dict) -> tuple[int, int]:
    """(bytes, flops) of one f32 tangent action on the configuration's mesh.

    Kuhn lattice (B1): the gathered cache [3P, C], the state F, S, A
    [q*9*T, C] and alpha, beta [q*T, C], the cell tables gN [q, npe, 3, T],
    dV [q, T], pair_of [T, npe] and slot_table [P, T], the pair rows out
    [3P, C]; C = n^3 cells. Unstructured (B6): per element the gathered
    values [3*npe], gradN [q*npe*3], detJxW [q], F, S, A [3 * q*9], alpha,
    beta [2q] and the nodal result [3*npe]; E = 5 n^3 tets."""
    m = config["mesh"]
    n, q, npe = m["n"], TET10_Q, TET10_NPE
    f32 = ITEM_BYTES["float32"]
    if m["kind"] == "kuhn":
        C, T, P = n ** 3, KUHN_T, KUHN_PAIRS
        rows = 2 * 3 * P + 3 * q * 9 * T + 2 * q * T
        tables = q * npe * 3 * T + q * T + T * npe + P * T
        return f32 * (rows * C + tables), q * T * C * apply_point_flops(npe)
    E = 5 * n ** 3
    per_element = 2 * 3 * npe + q * npe * 3 + q + 3 * q * 9 + 2 * q
    return f32 * per_element * E, q * E * apply_point_flops(npe)


def coarse_gemv_work(config: dict) -> tuple[int, int]:
    """(bytes, flops) of one product with the stored coarse inverse: the
    dim x dim inverse, the restricted vector in and the product out, all in
    the storage type the configuration states."""
    c = config["coarse"]
    dim, item = c["dim"], ITEM_BYTES[c["storage"]]
    return item * (dim * dim + 2 * dim), 2 * dim * dim


def bound_s(work: tuple[int, int], dtype: str) -> float:
    """The least seconds the card could take for (bytes, flops) in `dtype`."""
    nbytes, flops = work
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])


def roofline_share(work: tuple[int, int], dtype: str, seconds_per_call: float) -> float:
    """Percent of the bound that a call of `seconds_per_call` reaches."""
    return 100.0 * bound_s(work, dtype) / seconds_per_call
