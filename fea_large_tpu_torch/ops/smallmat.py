"""Closed-form 3x3 helpers over [..., 3, 3] tensors (counterpart of
`fea_large_tpu/ops/smallmat.py`).

Products are written as broadcast multiplies and sums, not `torch.matmul`:
batched 3x3 products are elementwise work, and this form sums in a fixed
order on every device.
"""

from __future__ import annotations

import torch


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for [..., 3, 3] operands."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def inv_det3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(adjugate / det, det) of [..., 3, 3]: the explicit cofactors of the
    structured freeze kernel (`_freeze_kernel`), det expanded along row 0."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        -2,
    )
    return adj * (1.0 / det)[..., None, None], det


def inv3(a: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] via the adjugate."""
    return inv_det3(a)[0]


def eye3(like: torch.Tensor) -> torch.Tensor:
    """Identity broadcast to `like`'s shape [..., 3, 3], dtype and device."""
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)
