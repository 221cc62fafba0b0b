"""Utilities: timing, profiling and the program's stage spans."""

from sixdpose_tpu_torch.utils.timing import StageTimer, frame_entry, span

__all__ = ["StageTimer", "frame_entry", "span"]
