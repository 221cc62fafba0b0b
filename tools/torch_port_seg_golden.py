"""Record the JAX package's segmentation path at a cut size, as the golden
the PyTorch port is held to.

The frame is the port's bin-picking scene (``synthetic.bin_picking_scene``:
the nine meshes of the synthetic benchmark placed by ``make_scene`` with
seed 0, 450-600 mm away, over a tilted floor) at 320 x 240 and f = 272.5,
the VGA frame of the port's chip run at half size.  The script runs the JAX
package's ``seg`` on it on the CPU, with ``DaspConfig`` and
``pose_estimation`` defaults:

- ``pixel_stage``, ``floyd_steinberg_seeds``, ``alic_iterate`` (seed count
  padded to 128) and ``convex_grouping``, as ``convex_cloud_seg`` chains
  them;
- for each object, ``pose_estimation`` (``method="auto"``) of the segment
  covering most of its visible mask, in mm, against 2048 points drawn on
  its mesh's surface.

and writes ``sixdpose_tpu_torch/testdata/seg_golden.npz`` (compressed,
under 1 MB): the frame, the pixel normals (the one pixel-stage output the
port does not reproduce to the bit: XLA's CPU reciprocal square root), the
seeds, the ALIC indices and superpixel means, the segments, and per object
the segment, its point count, T and lcp.

Run from the repository root on the CPU (about a minute):

    JAX_PLATFORMS=cpu python tools/torch_port_seg_golden.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sixdpose_tpu.seg import DaspConfig, alic_iterate, convex_grouping, floyd_steinberg_seeds, pixel_stage  # noqa: E402
from sixdpose_tpu.seg import pose_estimation  # noqa: E402
from sixdpose_tpu_torch.synthetic import bin_picking_scene  # noqa: E402

IM = (320, 240)
FOCAL = 272.5
SEED_PAD = 128
OUT = os.path.join(ROOT, "sixdpose_tpu_torch", "testdata", "seg_golden.npz")


def covering_segment(segments: np.ndarray, mask: np.ndarray) -> int:
    """The segment covering most of a visible mask (-1 when none does)."""
    ids = segments[mask]
    ids = ids[ids >= 0]
    return int(np.bincount(ids).argmax()) if len(ids) else -1


def main() -> None:
    t0 = time.time()
    sc = bin_picking_scene(IM, FOCAL, device="cpu")
    K = sc["K"]
    cfg = DaspConfig(focal_px=float(K[0, 0]), cx=float(K[0, 2]), cy=float(K[1, 2]))
    px = pixel_stage(jnp.asarray(sc["rgb"]), jnp.asarray(sc["depth"]), cfg)
    seeds = floyd_steinberg_seeds(np.asarray(px["density"]))
    n = len(seeds)
    s_pad = -(-n // SEED_PAD) * SEED_PAD
    seed_xy = np.zeros((s_pad, 2), np.float32)
    seed_xy[:n] = seeds
    seed_valid = np.arange(s_pad) < n
    indices, sp = alic_iterate(px, jnp.asarray(seed_xy), jnp.asarray(seed_valid), cfg, s_pad)
    indices = np.asarray(indices)
    sp = {k: np.asarray(v) for k, v in sp.items()}
    segments = convex_grouping(indices, sp["world"], sp["normal"], sp["num"], cfg)
    world = np.asarray(px["world"])
    reg = {"segment": [], "points": [], "T": [], "lcp": []}
    for i, mask in enumerate(sc["masks"]):
        s = covering_segment(segments, mask)
        cloud = world[segments == s] * 1000.0
        T, lcp = pose_estimation(cloud, sc["model_points"][i])
        reg["segment"].append(s)
        reg["points"].append(len(cloud))
        reg["T"].append(np.asarray(T, np.float64))
        reg["lcp"].append(float(lcp))
        print(sc["obj_ids"][i], "segment", s, "points", len(cloud), "lcp", lcp, flush=True)
    np.savez_compressed(
        OUT, rgb=sc["rgb"], depth=sc["depth"], K=K, obj_ids=np.array(sc["obj_ids"]),
        px_normal=np.asarray(px["normal"]), seeds=seeds.astype(np.float32), seed_pad=SEED_PAD, indices=indices.astype(np.int16),
        **{f"sp_{k}": v for k, v in sp.items()}, segments=segments.astype(np.int16),
        **{f"reg_{k}": np.asarray(v) for k, v in reg.items()},
    )
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes, {n} seeds, {segments.max() + 1} segments, "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
