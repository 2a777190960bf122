"""Numeric configuration of the PyTorch port.

The mixed-precision path computes residuals in f64 and the tangent, its
preconditioners and PCG in f32. Two dense f32 products sit on that path:
the Gram product that forms the explicit coarse inverse and the coarse
apply `acinv @ rc` (solvers/multilevel.py). Both must run in full f32, so
TF32 is switched off explicitly for matrix products and convolutions
instead of relying on PyTorch's defaults.

There is no global device: every builder takes a `device` argument, and
tensors carry it from there.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

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
