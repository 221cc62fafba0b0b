"""sixdpose_tpu_torch — the PyTorch and CUDA port of ``sixdpose_tpu``.

It sits beside the JAX package, mirrors its layout, and imports nothing of
it (nor JAX).  Entry points run on the GPU unless the caller passes
``device="cpu"``.  Ported so far: the template matcher for one class, every
class of a bank and every proposed depth (``models.detector``,
``models.multiclass``, ``models.multiscale``) with its ops; the fused
detect -> refine -> verify frames (``models.pipeline``, with batched ICP and
verification in ``models.refine``); the rasterizer (``geometry``),
render-trained banks (``models.train``), the pose-error metrics
(``eval``), the serving entry point (``serving.PoseEstimationService``) and
the synthetic accuracy benchmark (``benchmark``), the Latent-Class Hough
Forest path (``lchf``: patch features, forest training and prediction,
Hough voting, bin decoding, ICP; its tool twin ``lchf.pipeline``) and the
dataset I/O (``data``, ``utils.artifacts``).  The Pallas local-refine
kernels are one hand-written CUDA kernel (``csrc/local_refine.cu``).
"""

__version__ = "0.1.0"
