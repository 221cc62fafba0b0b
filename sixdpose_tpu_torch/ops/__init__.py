"""Ops of the matching pipeline: quantize -> spread -> response maps ->
similarity -> top-K/NMS, and the CUDA kernels with their build."""
