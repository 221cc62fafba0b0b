"""Driver of the matchers: every class of a bank matched in one pass, the
matches read back (``Detector.match``'s result form).  A configuration with
``num_scales`` takes the multi-scale matcher (``MultiScaleMultiClass``:
depth-histogram proposals, the scaled coarse sweep, scaled refinement);
one without takes ``MultiClassMatcher`` at the templates' own scale.

The check compares, for each checked frame, the kept matches (class,
template, x, y, and for the multi-scale matcher the proposal's depth and
scale) and their scores with the reference's on the same bank and frame.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from perfbench.core.generate import detector_config
from perfbench.drivers.served import port_detector
from perfbench.reference import matcher as ref
from perfbench.reference.scale_proposal import bin_centers

BINS = (100, 400, 2000)  # the matchers' default depth histogram (bin, lo, hi mm)


def _multiscale(cfg: dict) -> bool:
    return int(cfg.get("num_scales", 0)) > 0


class Program:
    def __init__(self, cfg: dict, mix: dict, wl, device):
        from sixdpose_tpu_torch.models.multiclass import MultiClassMatcher
        from sixdpose_tpu_torch.models.multiscale import MultiScaleMultiClass

        det = port_detector(cfg, wl, device, with_infos=False)
        if _multiscale(cfg):
            self.matcher = MultiScaleMultiClass(det, float(cfg["train_depth_mm"]), num_scales=int(cfg["num_scales"]),
                                                device=device)
        else:
            self.matcher = MultiClassMatcher(det, device=device)
        self.threshold = float(cfg["threshold"])

    def step(self, rgb, depth, keep: bool):
        matches = self.matcher.match(rgb, depth, self.threshold)
        return matches if keep else None

    def stages(self) -> dict:
        return {}


def _key(m) -> tuple:
    return (m.class_id, m.template_id, m.x, m.y, round(getattr(m, "depth_mm", 0.0), 3), round(getattr(m, "scale", 1.0), 6))


def host_outputs(kept) -> list:
    return [(_key(m), m.similarity) for m in kept]


def reference_frames(cfg: dict, wl, frame_ids, device) -> dict:
    """The reference's kept matches of each checked frame: (key, score)."""
    det_cfg = detector_config(cfg)
    threshold = float(cfg["threshold"])
    if _multiscale(cfg):
        train = float(cfg["train_depth_mm"])
        bin_scales_np = (train / bin_centers(*BINS)).astype(np.float32)
        bank = ref.multiscale_bank(wl.templates, float(bin_scales_np.max()), det_cfg.t_at_level[-1], device)
        bin_scales = torch.from_numpy(bin_scales_np).to(device)
    else:
        bank = ref.bank_from_templates(wl.templates, device)
    out = {}
    for f in frame_ids:
        rgb, depth = wl.frames[f]
        rgb_t, dep_t = torch.from_numpy(rgb).to(device), torch.from_numpy(depth.astype(np.int32)).to(device)
        if _multiscale(cfg):
            res = ref.multiscale_multiclass_core(rgb_t, dep_t, bank, bin_scales, det_cfg, threshold,
                                                 int(cfg["num_scales"]), det_cfg.top_k, True, BINS)
            tid, x, y, score, keep, dmm, scale = (a.to(torch.float64).cpu().numpy() for a in res)
        else:
            pyr = [p[0] for p in ref._build_response_pyramid(rgb_t[None], dep_t[None], det_cfg)]
            res = ref.match_multiclass_core(pyr, bank, tuple(det_cfg.t_at_level), threshold, det_cfg.top_k,
                                            det_cfg.nms_iou)
            tid, x, y, score, keep = (a.to(torch.float64).cpu().numpy() for a in res)
            dmm, scale = np.zeros_like(score), np.ones_like(score)
        matches = []
        for ci, cid in enumerate(wl.class_ids):
            for i in range(tid.shape[1]):
                if keep[ci, i] and score[ci, i] >= 0:
                    key = (cid, int(tid[ci, i]), int(x[ci, i]), int(y[ci, i]), round(float(dmm[ci, i]), 3),
                           round(float(scale[ci, i]), 6))
                    matches.append((key, float(score[ci, i])))
        out[f] = matches
    return out


def compare(prog: dict, refs: dict) -> dict:
    """``mismatches``: kept matches found on one side only, over every kept
    run of every checked frame; ``score_gap``: the widest score gap of the
    matches found on both."""
    mism, gap = 0, 0.0
    for f, runs in prog.items():
        r_keys, r_score = Counter(k for k, _ in refs[f]), dict(refs[f])
        for p in runs:
            p_keys = Counter(k for k, _ in p)
            mism += sum(((p_keys - r_keys) + (r_keys - p_keys)).values())
            gaps = [abs(s - r_score[k]) for k, s in p if k in r_score]
            if gaps:
                gap = max(gap, max(gaps))
    return {"mismatches": mism, "score_gap": gap}
