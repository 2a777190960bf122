"""Timers and traces (counterpart of `fea_large_tpu/utils/`; its
`compiled_cost` has no PyTorch counterpart)."""

from fea_large_tpu_torch.utils.profiling import PhaseTimer, trace_region  # noqa: F401
