"""Multi-device matching on ``torch.distributed``: the port of the JAX
package's ``parallel``.

- ``data``     — the frame batch splits over ranks (no communication).
- ``template`` — the template bank splits over ranks; each shard's top K
  merge with one ``all_gather`` and a re-top-K.
- ``tile``     — the frame's rows split over ranks, with a halo of raw
  pixels exchanged between neighbours.

Each mesh position is a process; ``parallel.distributed`` makes the process
group and starts the ranks of one host.
"""

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
]
