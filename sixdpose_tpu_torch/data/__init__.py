"""Dataset I/O and registry (reference: pysixd/inout.py, params/dataset_params.py).

Numpy copies of the JAX package's ``data``; ``yaml`` and ``PIL`` load only
when a function needs them."""

from sixdpose_tpu_torch.data import inout
from sixdpose_tpu_torch.data.datasets import get_dataset_params

__all__ = ["inout", "get_dataset_params"]
