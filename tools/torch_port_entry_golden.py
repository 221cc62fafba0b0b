"""Record the JAX package's entry program, ``__graft_entry__.entry()``, as the
golden the PyTorch port's ``sixdpose_tpu_torch.entry.entry()`` is held to.

``entry()`` builds a 16-template synthetic class (``_toy_bank``, size0 32),
passes its bank to ``detect_frame_core`` as the (kernels, nfeats, whs)
triple alone (the dense-kernel route: the coarse dense conv and the
grouped-conv ``similarity_local`` refinement) and returns it with a VGA
frame drawn from ``default_rng(1)``.  The script runs it once under
``jax.jit`` and writes ``sixdpose_tpu_torch/testdata/entry_golden.npz``:
the five (top_k,) outputs (tid, x, y, score, keep), the settings, and
digests of the frame (sums and the first row) so the port's draw can be
checked against the one recorded.

Run from the repository root on the CPU (XLA compiles the VGA program for
a few minutes):

    JAX_PLATFORMS=cpu python tools/torch_port_entry_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from __graft_entry__ import entry  # noqa: E402

OUT = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata", "entry_golden.npz")
FIELDS = ("tid", "x", "y", "score", "keep")


def main() -> int:
    fn, (rgb, depth) = entry()
    out = [np.asarray(a) for a in jax.block_until_ready(jax.jit(fn)(rgb, depth))]
    rgb, depth = np.asarray(rgb), np.asarray(depth)
    live = int((out[3] >= 0).sum())
    print(f"entry: {live} live of {len(out[3])}; scores {np.round(out[3][:8], 3).tolist()}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(
        OUT,
        threshold=np.float32(50.0),
        t_at_level=np.array([4, 8], np.int32),
        top_k=np.int32(32),
        num_templates=np.int32(16),
        size0=np.int32(32),
        rgb_sum=np.int64(rgb.astype(np.int64).sum()),
        depth_sum=np.int64(depth.astype(np.int64).sum()),
        rgb_row0=rgb[0],
        depth_row0=depth[0],
        **dict(zip(FIELDS, out)),
    )
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
