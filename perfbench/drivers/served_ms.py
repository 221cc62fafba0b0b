"""Driver of the service's multi-scale host route:
``PoseEstimationService(...)``, then ``enable_multiscale(train depth,
num_scales)``, then ``process_frame`` on every frame (the service's own
camera loop, after linemod_ros/detect.py serving at unknown distance):
the multi-scale match with box NMS off, up to ``max_refine`` hypotheses a
matched class through host-built clouds, batched ICP, verification a
matched class, dedupe, publish.

The check compares, for each checked frame, the hypothesis slots sent to
ICP (class, template, x, y, scale) and their scores, each one's ICP pose,
fitness and verification score, and the published estimates, with the
reference's host route (``reference/served_ms.py``) on the same bank and
frame.

Every view's infos gain ``anchor_depth`` (the depth a hypothesis's seed
falls back to where its window holds none; the port's training writes it):
the training depth, where the generator's views stand.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import Counter

import numpy as np

from perfbench.core.generate import detector_config
from perfbench.drivers.served import _rot_deg, port_detector
from perfbench.reference import served_ms as ref
from perfbench.reference.config import IcpConfig as RefIcpConfig


def _anchored(cfg: dict, wl):
    """The workload with every view's infos carrying ``anchor_depth``."""
    z = float(cfg["train_depth_mm"])
    return dataclasses.replace(wl, infos=[[{**info, "anchor_depth": z} for info in infos] for infos in wl.infos])


class Program:
    def __init__(self, cfg: dict, mix: dict, wl, device):
        from sixdpose_tpu_torch.config import IcpConfig
        from sixdpose_tpu_torch.serving import PoseEstimationService

        s = cfg["serving"]
        det = port_detector(cfg, _anchored(cfg, wl), device, with_infos=True)
        self.svc = PoseEstimationService(det, wl.meshes, wl.K, threshold=float(cfg["threshold"]),
                                         max_refine=int(s["max_refine"]), icp=IcpConfig(max_iters=int(s["icp_iters"])),
                                         icp_seeds=int(s["icp_seeds"]), device=device)
        self.svc.enable_multiscale(float(cfg["train_depth_mm"]), num_scales=int(cfg["num_scales"]))
        self.keep, self.kept = False, None
        self._last: dict = {}  # the service's counters at the last reading of ``stages``
        refine = self.svc._refine

        def keeping(rgb, depth, hyps):
            # The route's per-hypothesis results, kept (host arrays, no copy)
            # while ``keep`` is set.
            out = refine(rgb, depth, hyps)
            if self.keep:
                self.kept = (hyps.meta, out)
            return out

        self.svc._refine = keeping

    def step(self, rgb, depth, keep: bool):
        """One served frame; with ``keep`` its hypotheses, their results and
        the published estimates are kept for the check."""
        self.keep, self.kept = keep, None
        published = self.svc.process_frame(rgb, depth)
        if not keep:
            return None
        meta, out = self.kept if self.kept is not None else ([], None)
        return {"meta": meta, "out": out, "published": published}

    def stages(self) -> dict:
        """The service's own stage timers, name -> (total s, count), and
        beside them its counter ``hypotheses`` as ``hypotheses.count`` ->
        (hypotheses, frames).  Also prints the hypotheses and matches a frame
        since the last reading on standard error."""
        t, c = self.svc.metrics.timer, self.svc.metrics.counters
        now = {k: c.get(k, 0) for k in ("hypotheses", "matches", "frames")}
        new = {k: now[k] - self._last.get(k, 0) for k in now}
        if new["frames"]:
            print(f"served_ms: {new['hypotheses'] / new['frames']!r} hypotheses and "
                  f"{new['matches'] / new['frames']!r} matches a frame over {new['frames']} frames", file=sys.stderr)
        self._last = now
        out = {name: (t.totals[name], t.counts[name]) for name in t.totals}
        out["hypotheses.count"] = (now["hypotheses"], now["frames"])
        return out


def host_outputs(kept) -> dict:
    """A kept result in the reference's form (after the window)."""
    meta, out = kept["meta"], kept["out"]
    res = {"slots": [(m.class_id, m.template_id, m.x, m.y, round(m.scale, 6)) for m in meta],
           "scores": np.array([m.similarity for m in meta]),
           "published": [(e.class_id, e.template_id, e.x, e.y) for e in kept["published"]]}
    if out is None:
        res.update(R=np.zeros((0, 3, 3)), t=np.zeros((0, 3)), fitness=np.zeros(0), verify=np.zeros(0))
    else:
        R, t, fit, ver = out
        res.update(R=np.asarray(R), t=np.asarray(t).reshape(-1, 3), fitness=np.asarray(fit), verify=np.asarray(ver))
    return res


def reference_frames(cfg: dict, wl, frame_ids, device) -> dict:
    """The reference's host route on each checked frame, on the same bank
    and frames."""
    s = cfg["serving"]
    wl = _anchored(cfg, wl)
    route = ref.build_route(wl.class_ids, wl.templates, wl.infos, wl.meshes, wl.K, float(cfg["train_depth_mm"]),
                            detector_config(cfg), float(cfg["threshold"]), int(cfg["num_scales"]),
                            int(s["max_refine"]), RefIcpConfig(max_iters=int(s["icp_iters"])), int(s["icp_seeds"]),
                            device)
    return {f: ref.served_frame(route, *wl.frames[f], device) for f in frame_ids}


def compare(prog: dict, refs: dict) -> dict:
    """The numbers the check compares, over every kept run of every checked
    frame: ``mismatches`` counts hypothesis slots and published estimates
    found on one side only; the gaps are the widest over the slots found on
    both."""
    mism, score, t_gap, r_gap, fit, ver = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    for f, runs in prog.items():
        r = refs[f]
        r_at = {k: i for i, k in enumerate(r["slots"])}
        for p in runs:
            p_slots = Counter(p["slots"])
            r_slots = Counter(r["slots"])
            mism += sum(((p_slots - r_slots) + (r_slots - p_slots)).values())
            pairs = [(i, r_at[k]) for i, k in enumerate(p["slots"]) if k in r_at]
            if pairs:
                a, b = (np.array(x) for x in zip(*pairs))
                score = max(score, float(np.abs(p["scores"][a] - r["scores"][b]).max()))
                t_gap = max(t_gap, float(np.linalg.norm(p["t"][a] - r["t"][b], axis=-1).max()))
                r_gap = max(r_gap, float(_rot_deg(p["R"][a], r["R"][b]).max()))
                fit = max(fit, float(np.abs(p["fitness"][a] - r["fitness"][b]).max()))
                ver = max(ver, float(np.abs(p["verify"][a] - r["verify"][b]).max()))
            p_pub, r_pub = Counter(p["published"]), Counter(r["published"])
            mism += sum(((p_pub - r_pub) + (r_pub - p_pub)).values())
    return {"mismatches": mism, "score_gap": score, "t_gap_mm": t_gap, "r_gap_deg": r_gap, "fitness_gap": fit,
            "verify_gap": ver}
