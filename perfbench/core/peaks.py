"""Published peaks of the card the benchmark runs on.

NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without sparsity, at its
700 W power limit): the rates that a roofline share or a share of peak is
taken against.  Each run writes the card's name and power limit beside its
numbers, since a card set below 700 W reaches less.
"""

from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_ops_per_s": 67e12,  # outside the tensor cores; integer adds run at this rate too
    "tf32_ops_per_s": 495e12,
    "bf16_ops_per_s": 989e12,
}
