"""LCHF vote bins -> full 6D poses -> batched ICP -> ADD/ADI.

Port of the JAX package's ``lchf/pose.py``.  The reference's LCHF driver
stops at printing the top-10 Hough vote bins (LCHF_test.py:343-405); this
module finishes the pipeline: each top vote bin is decoded into a 6D pose
hypothesis from its SUPPORTING votes, all hypotheses refine together
through the batched projective point-to-plane ICP (models/refine.icp_batch),
and the result is scored with the SIXD ADD/ADI protocol.

Decoding a bin (the inverse of voting.accumulate_votes):
  center (u, v)  = weighted mean of each supporter's precise vote point
                   roi_xy - t_offset * (train_radius / patch_depth)
  depth z        = weighted mean of the supporters' patch depths — a
                   surface depth; the centroid-shift is ICP's job
  rotation       = weighted CIRCULAR mean of the supporters' rpy labels
                   (each angle is binned mod 2pi; a plain mean would
                   tear at the wrap)
  t (mm)         = z * K^-1 [u, v, 1]
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.geometry.transform import euler_matrix


def _circular_mean(angles: np.ndarray, weights: np.ndarray) -> float:
    s = float(np.sum(weights * np.sin(angles)))
    c = float(np.sum(weights * np.cos(angles)))
    return float(np.arctan2(s, c))


def decode_bin_poses(
    bins: np.ndarray,            # (B, 5) top vote bins
    roi_xy: np.ndarray,          # (V, 2) assemble_votes output
    roi_depth: np.ndarray,       # (V,)
    offsets: np.ndarray,         # (V, 3)
    rpys: np.ndarray,            # (V, 3)
    weights: np.ndarray,         # (V,)
    K: np.ndarray,
    train_radius: float,
    steps: int = 10,
    num_angle_bins: int = 10,
    depth_offset: float = 0.0,
) -> List[Dict[str, np.ndarray]]:
    """Aggregate each bin's supporting votes into a 6D pose hypothesis
    (numpy, as in the JAX package).

    Returns a list of {"R" (3,3), "t" (3,) mm, "weight", "center_px"}
    aligned with ``bins`` (bins with no supporters are skipped).
    """
    if len(roi_xy) == 0 or len(bins) == 0:
        return []
    # The supporters are binned in float32, as the JAX package bins them
    # here (divisions in order; see voting.accumulate_votes for the votes'
    # own binning).
    scale32 = (
        np.float32(train_radius)
        / np.maximum(roi_depth.astype(np.float32), np.float32(1.0))
    )
    off_x32 = offsets[:, 0].astype(np.float32) * scale32
    off_y32 = offsets[:, 1].astype(np.float32) * scale32
    bx = (
        (roi_xy[:, 0].astype(np.float32) - off_x32) / np.float32(steps)
    ).astype(np.int64)
    by = (
        (roi_xy[:, 1].astype(np.float32) - off_y32) / np.float32(steps)
    ).astype(np.int64)
    th = (
        rpys.astype(np.float32) / np.float32(2.0) / np.float32(3.14)
        * np.float32(num_angle_bins)
    ).astype(np.int64) % num_angle_bins
    # The pose aggregation itself stays float64.
    scale = train_radius / np.maximum(roi_depth.astype(np.float64), 1.0)
    ux = roi_xy[:, 0].astype(np.float64) - offsets[:, 0] * scale
    uy = roi_xy[:, 1].astype(np.float64) - offsets[:, 1] * scale

    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    out: List[Dict[str, np.ndarray]] = []
    for b in np.asarray(bins):
        sup = (
            (bx == b[0]) & (by == b[1])
            & (th[:, 0] == b[2]) & (th[:, 1] == b[3]) & (th[:, 2] == b[4])
        )
        if not sup.any():
            continue
        w = weights[sup]
        wsum = w.sum()
        u = float(np.sum(w * ux[sup]) / wsum)
        v = float(np.sum(w * uy[sup]) / wsum)
        # Patch depths are SURFACE depths; the pose t is the object
        # CENTER.  depth_offset (train_radius - mean train-patch depth)
        # measures the model's surface-to-center distance from the very
        # patches that voted, correcting a systematic half-extent bias.
        z = float(np.sum(w * roi_depth[sup]) / wsum) + depth_offset
        rpy = np.array(
            [_circular_mean(rpys[sup, i], w) for i in range(3)], np.float64
        )
        R = np.asarray(euler_matrix(*rpy))[:3, :3]
        t = z * (Kinv @ np.array([u, v, 1.0]))
        out.append(
            {
                "R": R.astype(np.float64),
                "t": t.astype(np.float64),
                "weight": float(wsum),
                "center_px": np.array([u, v]),
            }
        )
    return out


def lchf_vote_bins(
    model_l,
    rgb: np.ndarray,
    depth: np.ndarray,
    train_radius: float,
    cfg=None,
    stride: int = 5,
    steps: int = 10,
    num_angle_bins: int = 10,
    top_k: int = 10,
    leaf_modes=None,
    on_device: bool = False,
    device=None,
) -> dict:
    """The front half of ``lchf_pose_hypotheses``: dense ROIs, whole-scene
    response crops, forest leaves, the vote tensor and its top bins with
    positive score.  Returns {"rois", "leaves", "votes" (numpy),
    "bins", "vote_arrays" (assemble_votes' five arrays)}, or None when
    there are no ROIs or no votes."""
    from sixdpose_tpu_torch.lchf.feature import LchfConfig
    from sixdpose_tpu_torch.lchf.model import predict_scene, scene_roi_set
    from sixdpose_tpu_torch.lchf.voting import accumulate_votes, assemble_votes, dense_rois, top_bins

    cfg = cfg or LchfConfig()
    device = resolve_device(device)
    h, w = depth.shape
    rois = dense_rois(depth, stride=stride, device=device)
    if len(rois) == 0:
        return None
    roi_set = scene_roi_set(rgb, depth, rois, cfg, device)
    leaves = predict_scene(model_l, roi_set, cfg, on_device=on_device, device=device)
    arrays = assemble_votes(leaves, model_l.leaf_feats_map(), rois, model_l.rpy, model_l.t, leaf_modes)
    if len(arrays[0]) == 0:
        return None
    vote_shape = (w // steps, h // steps, num_angle_bins, num_angle_bins, num_angle_bins)
    votes = accumulate_votes(
        *arrays, float(train_radius), vote_shape, steps, num_angle_bins, device
    ).cpu().numpy()
    bins, scores = top_bins(votes, top_k)
    bins = bins[scores > 0]
    return {"rois": rois, "leaves": leaves, "votes": votes, "bins": bins, "vote_arrays": arrays}


def lchf_pose_hypotheses(
    model_l,
    rgb: np.ndarray,
    depth: np.ndarray,
    K: np.ndarray,
    train_radius: float,
    cfg=None,
    stride: int = 5,
    steps: int = 10,
    num_angle_bins: int = 10,
    top_k: int = 10,
    leaf_modes=None,
    on_device: bool = False,
    device=None,
) -> List[Dict[str, np.ndarray]]:
    """Full LCHF inference to 6D pose hypotheses: dense ROIs -> whole-scene
    response crops -> forest -> Hough vote -> bin decoding."""
    # Surface-to-center depth correction from the training patches'
    # recorded center depths (see decode_bin_poses).
    cds = [p.center_dep for p in getattr(model_l, "patches", []) or []]
    depth_offset = float(train_radius - np.mean(cds)) if cds else 0.0
    front = lchf_vote_bins(
        model_l, rgb, depth, train_radius, cfg, stride, steps, num_angle_bins, top_k, leaf_modes,
        on_device, device,
    )
    if front is None:
        return []
    return decode_bin_poses(
        front["bins"], *front["vote_arrays"], K, train_radius, steps,
        num_angle_bins, depth_offset=depth_offset,
    )


def refine_lchf_poses(
    hypotheses: Sequence[Dict[str, np.ndarray]],
    mesh_model: dict,
    depth: np.ndarray,
    K: np.ndarray,
    icp=None,
    num_points: int = 512,
    icp_seeds: int = 1,
    seed_step_deg: float = 24.0,
    device=None,
):
    """Batched ICP over all LCHF hypotheses at once, on ``device``.

    Hough angle bins are 36 deg wide, so a decoded rotation is up to a
    half-bin off.  ``icp_seeds`` expands every hypothesis into an in-plane
    fan (models/pipeline.py) and each hypothesis keeps its best-VERIFIED
    seed (verify_poses depth consistency).

    Returns numpy (R (B, 3, 3), t_mm (B, 3), fitness (B,), verify (B,))
    aligned with ``hypotheses``.  Model cloud = subdivided mesh surface
    (mm -> m); init_T = the decoded pose; scene = back-projected depth.
    """
    from sixdpose_tpu_torch.config import IcpConfig
    from sixdpose_tpu_torch.geometry.render import subdivide_mesh
    from sixdpose_tpu_torch.models.pipeline import _inplane_seed_transforms
    from sixdpose_tpu_torch.models.refine import backproject, icp_batch, scene_normals, verify_poses

    icp = icp or IcpConfig()
    b = len(hypotheses)
    if b == 0:
        z = np.zeros
        return z((0, 3, 3)), z((0, 3)), z((0,)), z((0,))
    device = resolve_device(device)
    pts = np.asarray(mesh_model["pts"], np.float64)
    faces = np.asarray(mesh_model["faces"], np.int64)
    pts_d, _faces_d = subdivide_mesh(pts, faces, max_edge=6.0)
    if len(pts_d) > num_points:
        sel = np.linspace(0, len(pts_d) - 1, num_points).astype(np.int64)
        pts_d = pts_d[sel]
    cloud = (pts_d / 1000.0).astype(np.float32)       # mm -> m

    init_T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i, hyp in enumerate(hypotheses):
        init_T[i, :3, :3] = hyp["R"]
        init_T[i, :3, 3] = np.asarray(hyp["t"], np.float64) / 1000.0  # m

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    s_n = max(1, int(icp_seeds))
    centroids = np.tile(cloud.mean(0)[None], (b, 1)).astype(np.float32)
    init_Tj = _inplane_seed_transforms(dev(init_T), dev(centroids), s_n, seed_step_deg)
    bs = b * s_n
    clouds = dev(cloud).expand(bs, len(cloud), 3).contiguous()
    valids = torch.ones((bs, len(cloud)), dtype=torch.bool, device=device)

    Kt = dev(np.asarray(K, np.float32))
    depth_t = dev(np.asarray(depth).astype(np.int32))
    sp = backproject(depth_t, Kt)
    sn = scene_normals(sp)
    Ts, fits, _ = icp_batch(
        clouds, valids, sp, sn, Kt, init_Tj,
        icp.corr_dist, icp.max_iters, icp.coarse_gate_mult,
        point_weight=icp.point_weight, lm_damping=icp.lm_damping,
    )
    R_all = Ts[:, :3, :3]
    t_all = Ts[:, :3, 3] * 1000.0
    vscore = verify_poses(dev((cloud * 1000.0).astype(np.float32)), R_all, t_all, depth_t, Kt, tau_mm=8.0)
    R_all, t_all, fits, vscore = (x.cpu().numpy() for x in (R_all, t_all, fits, vscore))
    if s_n > 1:
        rank = (vscore * 100.0 + np.maximum(fits, 0.0)).reshape(b, s_n)
        best = rank.argmax(1)
        idx = np.arange(b) * s_n + best
        R_all, t_all, fits, vscore = (
            R_all[idx], t_all[idx], fits[idx], vscore[idx]
        )
    return R_all, t_all, fits, vscore


def evaluate_pose_recall(
    model_l,
    mesh_model: dict,
    K: np.ndarray,
    im_size: Tuple[int, int],
    views: Sequence[dict],
    train_radius: float,
    cfg=None,
    stride: int = 5,
    top_k: int = 10,
    adi_frac: float = 0.1,
    icp=None,
    icp_seeds: int = 5,
    leaf_modes=None,
    on_device: bool = False,
    use_adi: bool = True,
    device=None,
) -> Dict[str, object]:
    """Render views, run LCHF to refined 6D poses, score ADD/ADI@0.1d.

    A view counts as a hit when the best (highest-fitness) refined
    hypothesis has ADD(-S) < ``adi_frac`` x model diameter
    (tools/eval_loc.py:213-216 semantics).
    """
    from sixdpose_tpu_torch.eval import pose_error
    from sixdpose_tpu_torch.eval.misc import model_diameter
    from sixdpose_tpu_torch.geometry.render import render

    device = resolve_device(device)
    dia = model_diameter(np.asarray(mesh_model["pts"]))
    err_fn = pose_error.adi if use_adi else pose_error.add
    err_kw = {"max_pts": 1024} if use_adi else {}
    records = []
    hits = 0
    for view in views:
        rgb, depth = render(
            mesh_model, im_size, K, view["R"], view["t"], mode="rgb+depth", device=device
        )
        rgb = rgb.cpu().numpy()
        depth = depth.cpu().numpy().astype(np.uint16)
        hyps = lchf_pose_hypotheses(
            model_l, rgb, depth, K, train_radius, cfg=cfg, stride=stride,
            top_k=top_k, leaf_modes=leaf_modes, on_device=on_device, device=device,
        )
        if not hyps:
            records.append({"hit": False, "reason": "no hypotheses"})
            continue
        R_r, t_r, fits, vscore = refine_lchf_poses(
            hyps, mesh_model, depth, K, icp, icp_seeds=icp_seeds, device=device
        )
        best = int(np.argmax(vscore * 100.0 + np.maximum(fits, 0.0)))
        err = float(
            err_fn(
                R_r[best], t_r[best].reshape(3, 1),
                np.asarray(view["R"]), np.asarray(view["t"]).reshape(3, 1),
                mesh_model, device=device, **err_kw,
            )
        )
        hit = err < adi_frac * dia
        hits += hit
        records.append(
            {
                "hit": bool(hit),
                "err_mm": err,
                "fitness": float(fits[best]),
                "verify": float(vscore[best]),
                "n_hyps": len(hyps),
            }
        )
    n = len(records)
    return {
        "recall": hits / max(n, 1),
        "n_views": n,
        "diameter_mm": float(dia),
        "threshold_mm": float(adi_frac * dia),
        "metric": "adi" if use_adi else "add",
        "records": records,
    }
