"""Driver of the served fused frame: ``PoseEstimationService.process_frame``
over a bank whose templates carry refine infos, so every frame takes the
fused multi-class path (match, ICP of ``max_refine`` hypotheses a class,
verification, one readback, dedupe, publish).

The check compares, for each checked frame, every class's hypothesis slots
(template, x, y, liveness and score), each live hypothesis's ICP pose,
fitness and verification score, and the published estimates, with the
reference's fused frame (``reference/matcher.py``) on the same bank and
frame.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from perfbench.core.generate import detector_config
from perfbench.reference import matcher as ref
from perfbench.reference.config import IcpConfig as RefIcpConfig


def _port_config(cfg: dict):
    from sixdpose_tpu_torch.config import ColorGradientConfig, DepthNormalConfig, DetectorConfig

    d = cfg["detector"]
    return DetectorConfig(t_at_level=tuple(d["t_at_level"]), top_k=int(d["top_k"]),
                          color=ColorGradientConfig(num_features=int(d["color_features"])),
                          depth=DepthNormalConfig(num_features=int(d["depth_features"])))


def port_detector(cfg: dict, wl, device, with_infos: bool):
    """The program's ``Detector`` holding every class of the workload."""
    from sixdpose_tpu_torch.models.detector import Detector
    from sixdpose_tpu_torch.models.templates import TemplateLevel

    det = Detector(_port_config(cfg), device=device)
    for cid, templates, infos in zip(wl.class_ids, wl.templates, wl.infos):
        for levels, info in zip(templates, infos):
            port_levels = [TemplateLevel(features=t.features, width=t.width, height=t.height,
                                         pyramid_level=t.pyramid_level) for t in levels]
            det.bank.add_template_levels(cid, port_levels, info if with_infos else None)
    return det


class _Recorder:
    """Stands in for the service's fused pipeline: calls it and keeps the
    device tensors it returns while ``keep`` is set (no copy, no wait)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.keep = False
        self.kept = None

    def __call__(self, *args, **kwargs):
        out = self.pipe(*args, **kwargs)
        if self.keep:
            self.kept = out
        return out


class Program:
    def __init__(self, cfg: dict, mix: dict, wl, device):
        from sixdpose_tpu_torch.config import IcpConfig
        from sixdpose_tpu_torch.serving import PoseEstimationService

        s = cfg["serving"]
        det = port_detector(cfg, wl, device, with_infos=True)
        self.svc = PoseEstimationService(det, wl.meshes, wl.K, threshold=float(cfg["threshold"]),
                                         max_refine=int(s["max_refine"]), icp=IcpConfig(max_iters=int(s["icp_iters"])),
                                         icp_seeds=int(s["icp_seeds"]), device=device)
        self.recorder = None

    def step(self, rgb, depth, keep: bool):
        """One served frame; with ``keep`` its fused results are kept for
        the check.  Returns what the check reads after the window."""
        if self.recorder is None and self.svc._fused_mc is not None:
            self.recorder = self.svc._fused_mc = _Recorder(self.svc._fused_mc)
        if self.recorder is not None:
            self.recorder.keep = keep
        published = self.svc.process_frame(rgb, depth)
        if not keep:
            return None
        if self.recorder is None or self.recorder.kept is None:
            raise RuntimeError("the served frame did not take the fused multi-class path")
        raw, self.recorder.kept = self.recorder.kept, None
        return {"raw": raw, "published": published}

    def stages(self) -> dict:
        """The service's own stage timers: name -> (total s, count)."""
        t = self.svc.metrics.timer
        return {name: (t.totals[name], t.counts[name]) for name in t.totals}


def host_outputs(kept) -> dict:
    """A kept result as numpy (after the window)."""
    raw = [a.detach().to("cpu").numpy() for a in kept["raw"]]
    pub = [(e.class_id, e.template_id, e.x, e.y) for e in kept["published"]]
    return {"raw": raw, "published": pub}


def reference_frames(cfg: dict, wl, frame_ids, device) -> dict:
    """The reference's fused frame and published estimates of each checked
    frame, on the same bank and frames."""
    det_cfg = detector_config(cfg)
    s = cfg["serving"]
    icp = RefIcpConfig(max_iters=int(s["icp_iters"]))
    bank = ref.bank_from_templates(wl.templates, device)
    fields = [ref.refine_bank_fields(infos, min(icp.num_model_points, 512)) for infos in wl.infos]
    cat = [np.concatenate([f[0][i] for f in fields]) for i in range(6)]
    win = (max(f[1][0] for f in fields), max(f[1][1] for f in fields))
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)  # noqa: E731
    rb = ref.RefineBank(clouds=up(cat[0], np.float32), valids=up(cat[1], np.bool_), chroma=up(cat[2], np.float32),
                        src_c=up(cat[3], np.float32), bbox_wh=up(cat[4], np.int32), base_T=up(cat[5], np.float32),
                        win=win)
    vp = [ref.verify_points_from_mesh(wl.meshes[c]) for c in wl.class_ids]
    v_pts, v_valid, v_col = ref.multiclass_verify_points([p for p, _ in vp], [c for _, c in vp], device)
    K = torch.from_numpy(np.asarray(wl.K, np.float32)).to(device)
    out = {}
    for f in frame_ids:
        rgb, depth = wl.frames[f]
        res = ref.detect_refine_multiclass_core(
            torch.from_numpy(rgb).to(device), torch.from_numpy(depth.astype(np.int32)).to(device), bank, det_cfg,
            float(cfg["threshold"]), rb, icp, K, int(s["max_refine"]), v_pts, v_valid, v_col,
            icp_seeds=int(s["icp_seeds"]),
        )
        raw = [a.to("cpu").numpy() for a in res]
        pub = [(e.class_id, e.template_id, e.x, e.y) for e in ref.published(wl.class_ids, raw)]
        out[f] = {"raw": raw, "published": pub}
    return out


def _rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """The angle between rotations, from the Frobenius norm of their
    difference (2 asin(|Ra - Rb| / 2 sqrt 2)): exactly 0 for equal
    matrices, and steady near 0 where the trace's arccos is not."""
    d = np.linalg.norm((Ra.astype(np.float64) - Rb.astype(np.float64)).reshape(*Ra.shape[:-2], 9), axis=-1)
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def compare(prog: dict, refs: dict) -> dict:
    """The numbers the check compares, over every kept run of every checked
    frame: ``mismatches`` counts hypothesis slots whose (template, x, y,
    liveness) differ plus published estimates found on one side only;
    the gaps are the widest over the slots live on both sides."""
    mism, score, t_gap, r_gap, fit, ver = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    for f, runs in prog.items():
        r = refs[f]
        tid_r, x_r, y_r, s_r, R_r, t_r, fit_r, ver_r, act_r = r["raw"]
        for p in runs:
            tid_p, x_p, y_p, s_p, R_p, t_p, fit_p, ver_p, act_p = p["raw"]
            same = (act_p == act_r) & (~act_r | ((tid_p == tid_r) & (x_p == x_r) & (y_p == y_r)))
            mism += int((~same).sum())
            both = same & act_r
            if both.any():
                score = max(score, float(np.abs(s_p[both] - s_r[both]).max()))
                t_gap = max(t_gap, float(np.linalg.norm(t_p[both] - t_r[both], axis=-1).max()))
                r_gap = max(r_gap, float(_rot_deg(R_p[both], R_r[both]).max()))
                fit = max(fit, float(np.abs(fit_p[both] - fit_r[both]).max()))
                ver = max(ver, float(np.abs(ver_p[both] - ver_r[both]).max()))
            diff = Counter(p["published"]) - Counter(r["published"]) + (Counter(r["published"]) - Counter(p["published"]))
            mism += sum(diff.values())
    return {"mismatches": mism, "score_gap": score, "t_gap_mm": t_gap, "r_gap_deg": r_gap, "fitness_gap": fit,
            "verify_gap": ver}
