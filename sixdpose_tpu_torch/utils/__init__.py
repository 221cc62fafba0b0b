"""Utilities: timing and profiling."""

from sixdpose_tpu_torch.utils.timing import StageTimer, block, device_trace

__all__ = ["StageTimer", "block", "device_trace"]
