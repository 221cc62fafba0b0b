"""sixdpose_tpu_torch — the PyTorch and CUDA port of ``sixdpose_tpu``.

It sits beside the JAX package, mirrors its layout, and imports nothing of
it (nor JAX).  Entry points run on the GPU unless the caller passes
``device="cpu"``.  Ported so far: the single-class template matcher
(``models.detector``) with its ops, and the fused detect -> refine ->
verify frame (``models.pipeline``, with batched ICP and verification in
``models.refine``); the Pallas local-refine kernels are one hand-written
CUDA kernel (``csrc/local_refine.cu``).
"""

__version__ = "0.1.0"
