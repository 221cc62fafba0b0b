"""Configuration dataclasses of the template matcher and of ICP.

A copy of the knobs from the JAX package's ``config.py`` (the port imports
nothing of that package).  The defaults follow the reference:
ColorGradient(10, 63, 55) and DepthNormal(2000, 50, 63, 2) at
linemodLevelup.cpp:645-650 and :968-974, the T-pyramid {5, 8} at
:1663-1672, Detector(150, [4, 8]) in linemod_and_levelup_test.py:19, and
poseRefine's 0.01 m gate (cpp:31).  The configurations of later stages
(rendering, VSD, mesh) arrive with the modules that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ColorGradientConfig:
    """Color-gradient modality (reference: linemodLevelup.cpp:645-650)."""

    weak_threshold: float = 10.0     # gradient magnitude gate for quantization
    strong_threshold: float = 55.0   # magnitude gate for template features
    num_features: int = 63           # features per template at level 0


@dataclasses.dataclass(frozen=True)
class DepthNormalConfig:
    """Depth-normal modality (reference: linemodLevelup.cpp:968-974)."""

    distance_threshold: int = 2000    # ignore depth beyond this (mm)
    difference_threshold: int = 50    # bilateral depth-difference gate (mm)
    num_features: int = 63
    extract_threshold: int = 2        # distance-transform score gate
    focal: float = 1150.0             # reference hard-codes 1150 (cpp:781-783)
    lut_parity: bool = False          # emulate NORMAL_LUT's 20-grid
    #                                   truncation bit-exactly (default:
    #                                   continuous azimuth)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Template-matching detector.

    ``t_at_level`` is the sampling step per pyramid level, coarse level last
    (reference T_at_level, linemodLevelup.cpp:1663-1672).
    """

    t_at_level: Tuple[int, ...] = (4, 8)
    max_features: int = 63           # per modality per template at level 0
    color: ColorGradientConfig = ColorGradientConfig()
    depth: DepthNormalConfig = DepthNormalConfig()
    use_color: bool = True
    use_depth: bool = True
    top_k: int = 128                 # candidates kept after coarse scoring
    nms_iou: float = 0.5             # box-NMS IoU for final dedupe
    # Response LUT: "levelup" (exact bit -> 4, 45 deg -> 1, cpp:1121) or
    # "stock" (LINEMOD's 4,3,2,1 taper, cpp:1112) or "binary45".
    response_lut: str = "levelup"

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_at_level)

    @property
    def num_modalities(self) -> int:
        return int(self.use_color) + int(self.use_depth)


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Batched point-to-plane ICP (reference: poseRefine, cpp:27-170)."""

    max_iters: int = 20
    corr_dist: float = 0.01          # correspondence gate, meters (cpp:31)
    num_model_points: int = 1024     # fixed sample of model points
    voxel_size: float = 0.0025       # reference voxel downsample (cpp:106)
    dilate_px: int = 4               # model mask dilation (cpp:45-46)
    anchor_window: float = 0.4       # scene-centroid depth window, m (cpp:93)
    coarse_gate_mult: float = 3.0    # gate schedule: starts at mult*corr_dist,
    #                                  decays geometrically to corr_dist by the
    #                                  last iteration (coarse->fine re-gating)
    color_weight: float = 0.1        # colored-ICP term weight (0 disables);
    #                                  engages when model clouds carry colors
    chroma_scale: float = 0.05       # meters per unit chroma residual
    point_weight: float = 0.2        # point-to-point blend (pins the
    #                                  in-plane null space of projective
    #                                  point-to-plane; flat over [0.05,0.5])
    lm_damping: float = 1e-3         # Levenberg-Marquardt diagonal damping
    bilinear_iters: int = 8          # final iterations with bilinear
    #                                  association (earlier: nearest-tap)
    coarse_points: int = 256         # strided cloud subset for the early
    #                                  nearest-tap phase (full cloud after)
