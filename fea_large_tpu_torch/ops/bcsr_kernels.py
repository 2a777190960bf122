"""Block-CSR product y = K x: the Hopper kernel B10 and its plain PyTorch
version (counterpart of `fea_large_tpu/ops/pallas_kernels.py`'s
`bcsr_spmv_pallas`).

Operands (assembly/bcsr.py): block-row pointers indptr [N+1], block
columns indices [nnzb] (int64 for the plain version, their int32 copies
indptr32 and indices32 for the kernel), blocks data [nnzb, 3, 3], x and y
[N, 3], f64 on the assembled path; the kernel also takes f32.

The TPU kernel does only the per-block 3x3 products, with the gather
x[indices] and the sorted row sum left to XLA around it. The kernel here
(csrc/bcsr_kernels.cu) does all three: a warp owns a block row, lane l of
its L = 32 takes the row's slots l, l + L, ... (whole 3x3 products into
three register sums, two slots' loads in flight), so the warp reads L
neighbouring blocks of one contiguous span per step; the L partial sums
are combined by a fixed tree of warp shuffles and y is written once. No
atomics; the summation order depends on the row's length only, so repeats
are bitwise equal. What bounds it is memory
traffic: every block (72 B in f64) and its 4 B column read once. The plain
version is the reference's per-block product followed by the row sum
through the structure's valence buckets (`row_buckets`), in slot order:
the kernel agrees with it to rounding, not bitwise.

`bcsr_spmv` runs the plain version on CPU tensors; on CUDA tensors it
launches the kernel or raises. `LAUNCHES["spmv"]` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from fea_large_tpu_torch.ops import cuda_build

#: kernel launches since the last reset (incremented where the kernel is
#: launched, and nowhere else)
LAUNCHES = {"spmv": 0}

#: threads per CUDA block; a block holds BLOCK / LANES block rows
BLOCK = 128

#: lanes that share a block row (csrc/bcsr_kernels.cu's kLanes: one warp)
LANES = 32

SOURCE = cuda_build.CSRC / "bcsr_kernels.cu"

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def bcsr_spmv_plain(structure, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [N, 3] = K x: per-block products, then the row sums in slot order."""
    contrib = (data * x[structure.indices][:, None, :]).sum(-1)  # [nnzb, 3]
    return structure.row_buckets.apply_rows(contrib)


def _library():
    P, I = ctypes.c_void_p, ctypes.c_int
    sig = [P] * 5 + [I] * 2 + [P]
    return cuda_build.load(SOURCE, {f"fea_bcsr_spmv_{s}": sig for s in _SUFFIX.values()})


def bcsr_spmv(structure, data: torch.Tensor, x: torch.Tensor,
              block: int = BLOCK) -> torch.Tensor:
    """B10 (`pallas_kernels.py::_spmv_kernel` with the gather and row sum
    around it): see `bcsr_spmv_plain`."""
    if x.device.type == "cpu":
        return bcsr_spmv_plain(structure, data, x)
    N, nnzb = structure.n_nodes, structure.nnzb
    if data.dtype not in _SUFFIX or x.dtype != data.dtype:
        raise TypeError(f"the kernel takes f64 or f32 data and x of one dtype, "
                        f"got {data.dtype} and {x.dtype}")
    if not (0 < block <= 256 and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 up to 256, got {block}")
    named = {"indptr32": structure.indptr32, "indices32": structure.indices32, "data": data,
             "x": x}
    shapes = {"indptr32": (N + 1,), "indices32": (nnzb,), "data": (nnzb, 3, 3), "x": (N, 3)}
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name}: expected a tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
    if structure.indptr32.dtype != torch.int32 or structure.indices32.dtype != torch.int32:
        raise TypeError("indptr32 and indices32 must be int32")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_library(), f"fea_bcsr_spmv_{_SUFFIX[data.dtype]}")(
            *(ctypes.c_void_p(t.data_ptr()) for t in (*named.values(), y)), N, block, stream)
    if err != 0:
        raise RuntimeError(f"BCSR SpMV kernel launch failed: CUDA error {err}")
    LAUNCHES["spmv"] += 1
    return y
