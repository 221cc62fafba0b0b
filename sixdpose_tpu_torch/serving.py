"""Live pose-estimation service: the linemod_ros node, re-designed.

Port of the JAX package's ``serving.py``.  Reference: linemod_ros/detect.py:
28-170 — per frame: match (threshold 65) -> box NMS -> per-match depth
render + poseRefine -> translation-space dedupe (``nms_norms``,
detect.py:41-50) -> publish.

A frame takes the fused path when every class's templates carry the
train-time refine fields (``icp_points``, ``cam_R_w2c``, ``cam_t_w2c``,
``render_bbox``; ``models/train.py`` writes them): one fused multi-class
frame (``FusedMultiClassPipeline``) or one fused single-class frame
(``FusedPipeline``), read back once.  Otherwise, and for multi-scale
matching, the host orchestrates match -> cloud build -> batched ICP ->
verification.  The fallback is decided by those fields alone: a shape or
device error raises, it never sends a frame down the host path.  Everything
runs on the service's device, CUDA by default.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sixdpose_tpu_torch.config import IcpConfig
from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.render import render, subdivide_mesh
from sixdpose_tpu_torch.models.detector import Detector
from sixdpose_tpu_torch.models.multiscale import MultiScaleDetector, MultiScaleMultiClass
from sixdpose_tpu_torch.models.pipeline import FusedMultiClassPipeline, FusedPipeline, _inplane_seed_transforms
from sixdpose_tpu_torch.models.refine import (
    backproject,
    icp_batch,
    sample_model_points,
    scene_chroma,
    scene_normals,
    verify_poses,
)
from sixdpose_tpu_torch.utils.timing import StageTimer, frame_entry, span, stage

# The template infos the fused pipelines read.
FUSED_FIELDS = ("icp_points", "cam_R_w2c", "cam_t_w2c", "render_bbox")


class ServiceMetrics:
    """Structured per-stage serving metrics (the reference's analog is
    ad-hoc chrono prints in test.cpp:125-130 and rostopic latencies; here a
    JSON-able snapshot any scraper can poll).

    Stage wall times are host-observed (dispatch + device + readback for
    whatever the stage awaits): operational latencies, not pure device
    compute."""

    def __init__(self):
        self.timer = StageTimer()
        self.counters: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def snapshot(self) -> dict:
        stages = {
            name: {
                "mean_ms": round(self.timer.mean_ms(name), 3),
                "total_s": round(self.timer.totals[name], 4),
                "count": self.timer.counts[name],
            }
            for name in self.timer.totals
        }
        return {"stages": stages, "counters": dict(self.counters)}


@dataclasses.dataclass
class PoseEstimate:
    class_id: str
    template_id: int
    x: int
    y: int
    similarity: float
    R: np.ndarray          # (3, 3)
    t: np.ndarray          # (3, 1) mm
    fitness: float
    verify: float = -1.0   # depth-consistency of the refined pose


def nms_norms(
    estimates: List[PoseEstimate],
    radius_mm: float = 40.0,
    key: str = "fitness",
) -> List[PoseEstimate]:
    """Greedy translation-space dedupe (linemod_ros/detect.py:41-50): keep
    the best estimate within each ``radius_mm`` ball, per class (estimates
    of different classes never suppress each other).

    ``key``: 'fitness' ranks by ICP fitness, 'similarity' by match
    similarity, 'verify' by verification (then fitness, then similarity)."""
    keys = {
        "fitness": lambda e: (-e.fitness, -e.similarity),
        "similarity": lambda e: (-e.similarity, -e.fitness),
        "verify": lambda e: (-e.verify, -e.fitness, -e.similarity),
    }
    rank = keys[key]
    kept: List[PoseEstimate] = []
    for e in sorted(estimates, key=rank):
        if all(k.class_id != e.class_id or np.linalg.norm(e.t - k.t) > radius_mm for k in kept):
            kept.append(e)
    return kept


def _readback(out) -> List[np.ndarray]:
    """The fused outputs (tid, x, y, score, R, t, fitness, verify, active),
    each with the same leading axes, in one device-to-host copy (int32,
    float32 and bool are exact in float64), back in their own dtypes."""
    lead = out[0].shape
    flat = torch.cat([a.reshape(*lead, -1).to(torch.float64) for a in out], dim=-1).cpu().numpy()
    parts, s = [], 0
    for a, dtype in zip(out, (np.int32, np.int32, np.int32, np.float32, np.float32, np.float32, np.float32,
                              np.float32, bool)):
        n = int(np.prod(a.shape[len(lead):], dtype=np.int64))
        parts.append(flat[..., s : s + n].reshape(a.shape).astype(dtype))
        s += n
    return parts


class PoseEstimationService:
    """Detection + refinement for a stream of RGB-D frames, on ``device``:
    CUDA by default, raising when there is none; pass ``device="cpu"`` for
    the CPU."""

    def __init__(
        self,
        detector: Detector,
        models: Dict[str, dict],
        K: np.ndarray,
        threshold: float = 65.0,
        max_refine: int = 8,
        icp: Optional[IcpConfig] = None,
        dedupe_radius_mm: float = 40.0,
        min_fitness: float = 0.5,
        min_verify: float = 0.0,
        verify_tau: float = 15.0,
        verify_color_weight: float = 0.5,
        verify_color_zscore: bool = False,
        rank_key: str = "verify",
        prefer_fused: bool = True,
        icp_seeds: int = 1,
        seed_flip: bool = False,
        device=None,
    ):
        """Args:
        detector: trained detector whose template infos carry the render
          pose (cam_K/cam_R_w2c/cam_t_w2c, models/train.py).
        models: class_id -> mesh dict (mm) for verification points and
          depth renders.
        K: scene camera intrinsics.
        icp_seeds, seed_flip: in-plane ICP seed fan per hypothesis (1 = the
          template pose as-is; with seed_flip the last slot is a 180-deg
          seed, for near-symmetric shapes).
        prefer_fused: False forces the host-orchestrated path (A/B accuracy
          comparisons).
        """
        self.device = resolve_device(device)
        self.det = detector
        self.models = models
        self.K = np.asarray(K, np.float64)
        self.threshold = threshold
        self.max_refine = max_refine
        self.icp = icp or IcpConfig()
        self.dedupe_radius_mm = dedupe_radius_mm
        self.min_fitness = min_fitness
        self.min_verify = min_verify
        self.verify_tau = verify_tau
        self.verify_color_weight = verify_color_weight
        self.verify_color_zscore = bool(verify_color_zscore)
        self.rank_key = rank_key
        self.icp_seeds = int(icp_seeds)
        self.seed_flip = bool(seed_flip)
        self.prefer_fused = prefer_fused
        self._render_cache: Dict[tuple, np.ndarray] = {}
        self.metrics = ServiceMetrics()
        self._multiscale = None
        self._fused: Dict[str, FusedPipeline] = {}
        self._fused_mc: Optional[FusedMultiClassPipeline] = None
        self._fused_mc_key: Optional[tuple] = None
        self._vpts: Dict[str, tuple] = {}

    def _has_fused_fields(self, class_id: str) -> bool:
        """Every template of the class carries the infos the fused
        pipelines read (banks imported from the reference store features
        only)."""
        infos = self.det.bank.infos.get(class_id, [])
        return len(infos) == self.det.num_templates(class_id) and all(
            all(k in info for k in FUSED_FIELDS) for info in infos
        )

    @stage("seed")
    def _template_render(self, class_id: str, template_id: int, im_size) -> Optional[np.ndarray]:
        key = (class_id, template_id, im_size)
        if key not in self._render_cache:
            info = self.det.bank.infos[class_id][template_id]
            if "cam_R_w2c" not in info:
                return None
            d = render(
                self.models[class_id], im_size, info.get("cam_K", self.K), info["cam_R_w2c"], info["cam_t_w2c"],
                mode="depth", device=self.device,
            )
            self._render_cache[key] = d.cpu().numpy()
        return self._render_cache[key]

    def enable_multiscale(self, train_depth: float, num_scales: int = 5, **kwargs) -> None:
        """Switch detection to the depth-histogram multi-scale matcher
        (models/multiscale.py) over the same bank: templates trained at
        ``train_depth`` mm match at histogram-proposed scene depths.  The
        per-match ``scale`` rescales the ICP seed bbox.

        Multi-class banks get ``MultiScaleMultiClass`` (every class in one
        pass); single-class banks ``MultiScaleDetector``.  ``kwargs`` reach
        the matcher: its bins (``bin_mm``, ``lo_mm``, ``hi_mm``), which the
        port's proposals use too.  There is no ``table_budget_bytes``: the
        port builds the coarse weights per frame."""
        cls = MultiScaleMultiClass if len(self.det.class_ids()) > 1 else MultiScaleDetector
        self._multiscale = cls(self.det, train_depth, num_scales=num_scales, device=self.device, **kwargs)

    def _fused_pipeline(self, class_id: str) -> Optional[FusedPipeline]:
        """Build (or fetch) the fused pipeline for a class; None when its
        bank lacks the train-time refine fields."""
        if not self._has_fused_fields(class_id):
            return None
        if class_id not in self._fused:
            vp, vc = self._verify_points_np(class_id)
            self._fused[class_id] = FusedPipeline(
                self.det,
                class_id,
                self.K,
                icp=self.icp,
                max_refine=self.max_refine,
                num_points=min(self.icp.num_model_points, 512),
                verify_pts=vp,
                verify_colors=vc,
                verify_tau=self.verify_tau,
                verify_color_weight=self.verify_color_weight,
                verify_color_zscore=self.verify_color_zscore,
                icp_seeds=self.icp_seeds,
                seed_flip=self.seed_flip,
                device=self.device,
            )
        return self._fused[class_id]

    def _fused_multiclass(self, cids: Sequence[str]) -> Optional[FusedMultiClassPipeline]:
        """Build (or fetch) the fused multi-class pipeline; None when any
        class lacks the train-time refine fields."""
        if not all(self._has_fused_fields(c) for c in cids):
            return None
        key = tuple(cids)
        if self._fused_mc_key != key:
            vps, vcs = {}, {}
            for cid in cids:
                vps[cid], vcs[cid] = self._verify_points_np(cid)
            self._fused_mc = FusedMultiClassPipeline(
                self.det,
                self.K,
                class_ids=list(cids),
                icp=self.icp,
                max_refine=self.max_refine,
                num_points=min(self.icp.num_model_points, 512),
                verify_pts=vps,
                verify_colors=vcs,
                verify_tau=self.verify_tau,
                verify_color_weight=self.verify_color_weight,
                verify_color_zscore=self.verify_color_zscore,
                icp_seeds=self.icp_seeds,
                seed_flip=self.seed_flip,
                device=self.device,
            )
            self._fused_mc_key = key
        return self._fused_mc

    def _estimates(self, cid: str, out, rows) -> List[PoseEstimate]:
        tid, x, y, score, R, t, fit, ver, active = out
        ests = []
        for i in rows:
            if not active[i] or fit[i] < self.min_fitness:
                continue
            if ver[i] >= 0 and ver[i] < self.min_verify:
                continue
            ests.append(
                PoseEstimate(
                    class_id=cid,
                    template_id=int(tid[i]),
                    x=int(x[i]),
                    y=int(y[i]),
                    similarity=float(score[i]),
                    R=R[i].astype(np.float64),
                    t=t[i].reshape(3, 1).astype(np.float64),
                    fitness=float(fit[i]),
                    verify=float(ver[i]),
                )
            )
        return ests

    def process_frame_fused(self, rgb: np.ndarray, depth: np.ndarray) -> Optional[List[PoseEstimate]]:
        """One fused detect+refine+verify frame: ``FusedPipeline`` for one
        class, ``FusedMultiClassPipeline`` for several (every class in one
        pass), read back once.  Returns None when a class lacks the fused
        fields (the caller falls back to the host-orchestrated path)."""
        cids = [c for c in self.det.class_ids() if c in self.models]
        if not cids:
            return None
        pipe = self._fused_multiclass(cids) if len(cids) > 1 else self._fused_pipeline(cids[0])
        if pipe is None:
            return None
        with self.metrics.timer("fused_dispatch"):
            out = pipe(rgb, depth, self.threshold)
        with self.metrics.timer("fused_readback"):
            out = _readback(out)
        ests: List[PoseEstimate] = []
        if len(cids) > 1:
            for ci, cid in enumerate(cids):
                ests += self._estimates(cid, [a[ci] for a in out], range(out[0].shape[1]))
        else:
            ests = self._estimates(cids[0], out, range(len(out[0])))
        self.metrics.count("frames")
        self.metrics.count("estimates", len(ests))
        kept = nms_norms(ests, self.dedupe_radius_mm, key=self.rank_key)
        self.metrics.count("published", len(kept))
        return kept

    @frame_entry
    def process_frame(self, rgb: np.ndarray, depth: np.ndarray) -> List[PoseEstimate]:
        """Detect -> batched refine -> dedupe for one frame.

        Prefers the fused path (``process_frame_fused``) when the banks
        carry train-time clouds; otherwise, and with multi-scale matching,
        orchestrates match -> cloud build -> batched ICP -> verify from the
        host."""
        h, w = depth.shape
        ms = self._multiscale
        if ms is None and self.prefer_fused:
            fused = self.process_frame_fused(rgb, depth)
            if fused is not None:
                return fused
        with self.metrics.timer("match"):
            if ms is not None:
                # NMS off: hypothesis selection below keeps rival VIEWS at
                # the same peak alive through ICP so verification picks the
                # pose, the same (template, location) pool as the fused
                # cores.
                if isinstance(ms, MultiScaleMultiClass):
                    matches = ms.match(rgb, depth, self.threshold, apply_nms=False)
                else:
                    matches = []
                    for cid in self.det.class_ids():
                        matches.extend(ms.match(rgb, depth, self.threshold, cid, apply_nms=False))
                    matches.sort(key=lambda m: -m.similarity)
            else:
                matches = self.det.match(rgb, depth, self.threshold)
        self.metrics.count("frames")
        self.metrics.count("matches", len(matches))
        # Keep max_refine hypotheses PER CLASS (parity with the fused
        # multi-class pipeline).  Within a class, dedupe on (template,
        # location).  Tiered budget: pass 1 admits each template's FIRST
        # occurrence (rival views), pass 2 fills leftover budget with
        # same-template peaks at DISTANT locations (repeat instances).
        per_class_kept: Dict[str, list] = {}
        seen_tid: Dict[str, set] = {}
        for m in matches:
            ks = per_class_kept.setdefault(m.class_id, [])
            st = seen_tid.setdefault(m.class_id, set())
            if len(ks) >= self.max_refine or m.template_id in st:
                continue
            ks.append(m)
            st.add(m.template_id)
        for m in matches:
            ks = per_class_kept[m.class_id]
            if len(ks) >= self.max_refine or m in ks:
                continue
            bw_m, bh_m = self._match_bbox_px(m)
            dup = any(
                k.template_id == m.template_id and abs(k.x - m.x) * 2 <= bw_m and abs(k.y - m.y) * 2 <= bh_m
                for k in ks
            )
            if not dup:
                ks.append(m)
        matches = [m for ks in per_class_kept.values() for m in ks]
        matches.sort(key=lambda m: -m.similarity)
        if not matches:
            return []

        clouds, valids, init_Ts, meta, colors, srcs = [], [], [], [], [], []
        npts = self.icp.num_model_points
        for m in matches:
            if m.class_id not in self.models:
                continue
            info = self.det.bank.infos[m.class_id][m.template_id]

            col_m = None
            if "icp_points" in info:
                # Train-time cloud + bbox (no serve-time render).
                pts_m = np.asarray(info["icp_points"], np.float32)
                if "icp_colors" in info:
                    col_m = np.asarray(info["icp_colors"], np.float32)
                bx0, by0, bx1, by1 = np.asarray(info["render_bbox"])
                z_anchor = float(info["anchor_depth"]) / 1000.0
                src_c = pts_m.mean(0)
                bw, bh = int(bx1 - bx0), int(by1 - by0)
            else:
                dimg = self._template_render(m.class_id, m.template_id, (w, h))
                if dimg is None:
                    continue
                ys, xs = np.nonzero(dimg > 0)
                if len(ys) == 0:
                    continue
                pts_all, val_all = sample_model_points(dimg.astype(np.uint16), info.get("cam_K", self.K), npts)
                pts_m = pts_all[val_all]
                src_c = pts_m.mean(0)
                z_anchor = float(np.median(dimg[dimg > 0])) / 1000.0
                bw, bh = int(xs.max() - xs.min()), int(ys.max() - ys.min())

            # Multi-scale matches carry the applied template scale: the
            # scene-space bbox of the object is the render bbox rescaled.
            scl = float(getattr(m, "scale", 1.0) or 1.0)
            if scl != 1.0:
                bw = int(round(bw * scl))
                bh = int(round(bh * scl))

            # Seed translation: move the template cloud to the detected
            # position (centroid shift, as poseRefine's initial guess,
            # linemodLevelup.cpp:60-104).
            zs = depth[
                np.clip(m.y, 0, h - 1) : np.clip(m.y + bh + 1, 1, h),
                np.clip(m.x, 0, w - 1) : np.clip(m.x + bw + 1, 1, w),
            ]
            zs_nz = zs[zs > 0]
            z_med = float(np.median(zs_nz)) / 1000.0 if len(zs_nz) else z_anchor
            u = m.x + bw / 2.0
            v = m.y + bh / 2.0
            target = np.array(
                [
                    (u - self.K[0, 2]) / self.K[0, 0] * z_med,
                    (v - self.K[1, 2]) / self.K[1, 1] * z_med,
                    z_med,
                ]
            )
            T0 = np.eye(4, dtype=np.float32)
            T0[:3, 3] = target - src_c
            pad = npts - len(pts_m)
            if pad > 0:
                cloud = np.concatenate([pts_m, np.zeros((pad, 3), np.float32)])
                valid = np.concatenate([np.ones(len(pts_m), bool), np.zeros(pad, bool)])
                if col_m is not None:
                    col_m = np.concatenate([col_m, np.zeros((pad, 3), np.float32)])
            else:
                sel = np.linspace(0, len(pts_m) - 1, npts).astype(np.int64)
                cloud = pts_m[sel]
                valid = np.ones(npts, bool)
                if col_m is not None:
                    col_m = col_m[sel]
            clouds.append(cloud)
            valids.append(valid)
            init_Ts.append(T0)
            meta.append(m)
            colors.append(col_m)
            srcs.append(src_c.astype(np.float32))

        if not clouds:
            return []

        dev = self.device
        up = lambda a, dtype=np.float32: torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype))).to(dev)  # noqa: E731
        # The ICP seeds and the scene maps, on the device: the ``seed`` span
        # (the fused frame counts them in its ``icp`` span).
        with span("seed"):
            K_t = up(self.K)
            depth_t = up(depth, np.int32)
            sp = backproject(depth_t, K_t)
            sn = scene_normals(sp)
            # Colored ICP when every candidate cloud carries colors.
            use_color = self.icp.color_weight > 0.0 and rgb is not None and all(c is not None for c in colors)
            # In-plane seed fan (parity with the fused cores): each candidate
            # refines from icp_seeds in-plane rotations (last slot a 180-deg
            # flip when seed_flip) and keeps its best-VERIFIED seed below.
            s_n = max(1, self.icp_seeds)
            clouds_a = np.stack(clouds)
            valids_a = np.stack(valids)
            init_T_a = up(np.stack(init_Ts))
            if s_n > 1:
                init_T_a = _inplane_seed_transforms(init_T_a, up(np.stack(srcs)), s_n, flip=self.seed_flip)
                clouds_a = np.repeat(clouds_a, s_n, axis=0)
                valids_a = np.repeat(valids_a, s_n, axis=0)
            rgb_t = up(rgb, np.uint8) if rgb is not None else None
            if use_color:
                col = np.stack(colors).astype(np.float32)
                chroma = col[..., :2] / np.maximum(col.sum(-1, keepdims=True), 1e-6)
                if s_n > 1:
                    chroma = np.repeat(chroma, s_n, axis=0)
                chroma_k = up(chroma)
                chroma_maps = scene_chroma(rgb_t)
            else:
                chroma_k = None
                chroma_maps = None
        with self.metrics.timer("icp"):
            Ts, fits, _rmse = icp_batch(
                up(clouds_a),
                up(valids_a, bool),
                sp,
                sn,
                K_t,
                init_T_a,
                self.icp.corr_dist,
                self.icp.max_iters,
                self.icp.coarse_gate_mult,
                model_chroma=chroma_k,
                chroma_maps=chroma_maps,
                color_weight=self.icp.color_weight,
                chroma_scale=self.icp.chroma_scale,
                point_weight=self.icp.point_weight,
                lm_damping=self.icp.lm_damping,
                bilinear_iters=self.icp.bilinear_iters,
                coarse_points=self.icp.coarse_points,
            )
            Ts = Ts.cpu().numpy().astype(np.float64)
            fits = fits.cpu().numpy()

        # Compose EVERY refined seed with its template pose, verify all of
        # them, then reduce each hypothesis to its best-verified seed
        # (verify rank, fitness tiebreaker; parity with the fused cores).
        n_c = len(meta)
        bases = np.stack([self._template_base(m) for m in meta])
        if s_n > 1:
            bases = np.repeat(bases, s_n, axis=0)
        results = Ts @ bases  # (n_c*s_n, 4, 4)
        ver_all = np.full(len(results), -1.0)

        by_class: Dict[str, List[int]] = {}
        for i in range(len(results)):
            by_class.setdefault(meta[i // s_n].class_id, []).append(i)
        with self.metrics.timer("verify"):
            for cid, idxs in by_class.items():
                pts, vcolors = self._verify_points(cid)
                scores = verify_poses(
                    pts,
                    up(results[idxs, :3, :3]),
                    up(results[idxs, :3, 3] * 1000.0),
                    depth_t,
                    K_t,
                    tau_mm=self.verify_tau,
                    model_colors=vcolors,
                    rgb=rgb_t if vcolors is not None else None,
                    color_weight=self.verify_color_weight,
                    color_zscore=self.verify_color_zscore,
                )
                ver_all[idxs] = scores.cpu().numpy()

        rank = np.where(ver_all >= 0, ver_all * 100.0 + np.maximum(fits, 0.0), fits)
        best = rank.reshape(n_c, s_n).argmax(axis=1) + np.arange(n_c) * s_n
        out = []
        for i, m in enumerate(meta):
            j = int(best[i])
            if fits[j] < self.min_fitness or ver_all[j] < self.min_verify:
                continue
            out.append(
                PoseEstimate(
                    class_id=m.class_id,
                    template_id=m.template_id,
                    x=m.x,
                    y=m.y,
                    similarity=m.similarity,
                    R=results[j, :3, :3],
                    t=results[j, :3, 3:4] * 1000.0,
                    fitness=float(fits[j]),
                    verify=float(ver_all[j]),
                )
            )
        self.metrics.count("estimates", len(out))
        kept = nms_norms(out, self.dedupe_radius_mm, key=self.rank_key)
        self.metrics.count("published", len(kept))
        return kept

    def _template_base(self, m) -> np.ndarray:
        """Template pose as a 4x4 (z mm -> m, the reference quirk at
        linemodLevelup.cpp:37)."""
        info = self.det.bank.infos[m.class_id][m.template_id]
        base = np.eye(4)
        base[:3, :3] = info["cam_R_w2c"]
        base[:3, 3] = np.asarray(info["cam_t_w2c"]).flatten()
        base[2, 3] /= 1000.0
        return base

    def _match_bbox_px(self, m) -> tuple:
        """Scene-space template bbox (w, h) px of a match, for the
        (template, location) hypothesis dedupe."""
        info = self.det.bank.infos[m.class_id][m.template_id]
        scl = float(getattr(m, "scale", 1.0) or 1.0)
        if "render_bbox" in info:
            bx0, by0, bx1, by1 = np.asarray(info["render_bbox"])
            return max(float(bx1 - bx0) * scl, 8.0), max(float(by1 - by0) * scl, 8.0)
        return 32.0, 32.0

    def _verify_points_np(self, class_id: str):
        """Dense surface-point sample of a model (mm) and its per-point
        colors (or None), as numpy float32, cached.

        Colors are barycentrically interpolated through the subdivision;
        texture-mapped models sample the texture at the interpolated UVs (a
        textured mesh's vertex 'colors' are a flat fallback, and verifying
        a textured object with flat gray destroys the color evidence that
        separates geometric twins)."""
        if class_id not in self._vpts:
            model = self.models[class_id]
            pts = np.asarray(model["pts"], np.float64)
            faces = np.asarray(model["faces"], np.int64)
            has_colors = model.get("colors") is not None
            has_tex = model.get("texture") is not None and "texture_uv" in model
            attrs = []
            if has_colors:
                attrs.append(np.asarray(model["colors"], np.float64))
            if has_tex:
                attrs.append(np.asarray(model["texture_uv"], np.float64))
            attr = np.concatenate(attrs, axis=1) if attrs else None

            extent = float(np.linalg.norm(pts, axis=1).max())
            out = subdivide_mesh(pts, faces, max_edge=max(extent / 12, 2.0), attrs=attr)
            if attr is not None:
                pts2, faces2, attr2 = out
            else:
                pts2, faces2 = out
                attr2 = None
            # face centroids + vertices = dense surface cover
            surf = np.concatenate([pts2, pts2[faces2].mean(1)], 0)
            if attr2 is not None:
                attr_s = np.concatenate([attr2, attr2[faces2].mean(1)], 0)
            if len(surf) > 2048:
                sel = np.linspace(0, len(surf) - 1, 2048).astype(np.int64)
                surf = surf[sel]
                if attr2 is not None:
                    attr_s = attr_s[sel]
            colors = None
            if has_tex:
                uv = attr_s[:, -2:]
                tex = np.asarray(model["texture"], np.float64)
                if tex.max() <= 1.0:
                    tex = tex * 255.0
                th, tw = tex.shape[:2]
                # reference UV convention (render_textured): v flips rows
                ui = np.clip((uv[:, 0] * (tw - 1)).round(), 0, tw - 1)
                vi = np.clip(((1.0 - uv[:, 1]) * (th - 1)).round(), 0, th - 1)
                colors = tex[vi.astype(np.int64), ui.astype(np.int64), :3].astype(np.float32)
            elif has_colors:
                colors = attr_s[:, :3].astype(np.float32)
            self._vpts[class_id] = (surf.astype(np.float32), colors)
        return self._vpts[class_id]

    def _verify_points(self, class_id: str):
        """``_verify_points_np`` as tensors on the service's device."""
        pts, colors = self._verify_points_np(class_id)
        up = lambda a: torch.from_numpy(a).to(self.device) if a is not None else None  # noqa: E731
        return up(pts), up(colors)

    def run(self, frames, callback: Callable[[List[PoseEstimate]], None]) -> None:
        """Process an iterable of (rgb, depth) frames (the ROS
        subscribe/publish loop, detect.py:151-170)."""
        for rgb, depth in frames:
            callback(self.process_frame(rgb, depth))
