"""Deterministic node scatter-add (counterpart of
`fea_large_tpu/assembly/scatter.py`).

Sums per-element nodal values [E, npe, ...] into nodal arrays [N, ...] in
a fixed order on every device: the (element, local node) entries are
grouped by node once at setup into the valence buckets of
`ops.soa.ScatterBuckets`, and each sum is a padded gather and a masked
sum. No atomics and no `index_add_`, whose float sums on CUDA change from
run to run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fea_large_tpu_torch.ops.soa import ScatterBuckets


@dataclasses.dataclass(frozen=True)
class NodeScatter:
    """Scatter map from element-local nodal values [E, npe, ...] to nodal
    sums [n_nodes, ...]. Entries are summed in (e, a) order."""

    buckets: ScatterBuckets
    n_nodes: int

    @staticmethod
    def build(conn: np.ndarray, n_nodes: int, device) -> "NodeScatter":
        """From the host connectivity [E, npe], on `device`."""
        flat = np.asarray(conn).reshape(-1)
        return NodeScatter(ScatterBuckets.from_flat(flat, int(n_nodes), device), int(n_nodes))

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        """values [E, npe, ...] -> summed [n_nodes, ...]."""
        return self.buckets.apply_rows(values.reshape(-1, *values.shape[2:]))
