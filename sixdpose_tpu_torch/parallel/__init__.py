"""Multi-device matching on ``torch.distributed``: the port of the JAX
package's ``parallel``.

- ``data``     — the frame batch splits over ranks (no communication).
- ``template`` — the template bank splits over ranks; each shard's top K
  merge with one ``all_gather`` and a re-top-K.
- ``tile``     — the frame's rows split over ranks, with a halo of raw
  pixels exchanged between neighbours.

Entry points: ``sharded_detect`` (data x template), ``tiled_detect``
(``tiled_match``) and ``sharded_multiscale_detect`` match; over ``data``,
``sharded_detect_refine`` runs ``sharded_detect`` then ICP of every
candidate, ``fused_multiclass_over_data`` the fused multi-class detect ->
refine -> verify frame and ``multiscale_multiclass_over_data`` the
multi-scale multi-class frame, each on this rank's frames
(``parallel/fused.py``).

Each mesh position is a process; ``parallel.distributed`` makes the process
group and starts the ranks of one host.
"""

from sixdpose_tpu_torch.parallel.fused import (
    fused_multiclass_over_data,
    multiscale_multiclass_over_data,
    sharded_detect_refine,
)
from sixdpose_tpu_torch.parallel.mesh import make_mesh
from sixdpose_tpu_torch.parallel.sharded_match import (
    pad_templates,
    sharded_detect,
    sharded_multiscale_detect,
)

__all__ = [
    "make_mesh",
    "sharded_detect",
    "sharded_multiscale_detect",
    "pad_templates",
    "sharded_detect_refine",
    "fused_multiclass_over_data",
    "multiscale_multiclass_over_data",
]
