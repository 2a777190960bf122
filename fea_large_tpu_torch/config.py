"""Numeric configuration of the PyTorch port.

The mixed-precision path computes residuals in f64 and the tangent, its
preconditioners and PCG in f32. Two dense products sit on that path: the
Gram product that forms the explicit coarse inverse, which must run in
full f32, so TF32 is switched off explicitly for matrix products and
convolutions instead of relying on PyTorch's defaults; and the coarse
apply `acinv @ rc` (solvers/multilevel.py), which on the card reads the
inverse stored in bf16 (`multilevel._store_acinv`, the reference's
accelerator storage). Its products must accumulate in f32 and round the
result to bf16 once, as the reference's bf16 dot does, so cuBLAS's
reduced-precision reduction is switched off too.

There is no global device: every builder takes a `device` argument, and
tensors carry it from there. The command-line entry point (cli.py) runs on
the card, or on the CPU where FEA_PLATFORM=cpu, the reference's own switch
(`task_device`).
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

#: dtype of residuals, coordinates and the converged displacement (the
#: frozen tangent, its preconditioners and PCG are float32).
DTYPE = torch.float64

#: dtype of index tensors.
INDEX_DTYPE = torch.int64


def as_device(device) -> torch.device:
    """`torch.device` for `device`; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def task_device() -> torch.device:
    """The command-line entry point's device: the CPU where the environment
    sets FEA_PLATFORM=cpu, else the card (raises where CUDA is absent)."""
    return as_device("cpu" if os.environ.get("FEA_PLATFORM") == "cpu" else "cuda")
