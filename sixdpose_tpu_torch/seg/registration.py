"""Global registration of a segment cloud to a model: batched RANSAC.

Port of the JAX package's ``seg/registration.py``.  Reference:
cxx_3d_seg::pose_estimation (cxx_3d_seg.cpp:52-100) wraps Super4PCS and
accepts the result when the LCP (largest common pointset) score exceeds
0.5, returning the model -> scene transform as 4x4 (zeros otherwise).

Two hypothesis generators, every hypothesis scored at once on the device:

- congruent triangles (``_ransac_core``): random scene and model triangles
  matched by their sorted side lengths, one rigid fit per pair;
- planar 4-point bases (``_fourpcs_core``): a coplanar scene base drawn on
  the host (``_coplanar_base``), model pairs whose length matches a
  diagonal, pairs of pairs whose intersection points coincide.

Host steps are copies of the JAX package's and draw from
``np.random.default_rng(seed)`` in its order.  The rigid fits
(``kabsch``) are not a batched SVD: Horn's quaternion method, the top
eigenvector of the 4 x 4 matrix N(H) by the power method (repeated
squaring), in float64 with elementwise tensor ops in a fixed order only,
so the card and the CPU give the same bits and nothing waits for the
device.  It finds the same rotation as the
SVD solution whenever that rotation is unique.  Ties are broken as JAX
breaks them: the triangle's vertex order by a stable sort, ``top_k`` by
the lowest index, ``argmin`` / ``argmax`` by the first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sixdpose_tpu_torch.device import resolve_device
from sixdpose_tpu_torch.ops.sqrt import sqrt32, sqrt64
from sixdpose_tpu_torch.seg.dasp import _fma, _sum3_sq

# Elements per block of the pairwise distance tensors (hypotheses x points
# x scene points, pairs x pairs): about 130 MB of float64 on the card; on
# the CPU small blocks that stay in cache run faster.  Each row is computed
# alone, so the blocking changes no bit.
_LCP_BLOCK = 1 << 24
_LCP_BLOCK_CPU = 1 << 18
# Squarings of the shifted Horn matrix: its 65,536th power.
_SQUARINGS = 16


def _block(t: torch.Tensor) -> int:
    return _LCP_BLOCK if t.is_cuda else _LCP_BLOCK_CPU


def _subsample(pts: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    pts = np.asarray(pts, np.float32)
    if len(pts) >= n:
        idx = np.linspace(0, len(pts) - 1, n).astype(np.int64)
        return pts[idx]
    reps = -(-n // len(pts))
    return np.tile(pts, (reps, 1))[:n]


def _sq32(v) -> float:
    """v * v in float32: the JAX cores take ``delta`` as a float32 value."""
    v = np.float32(v)
    return float(v * v)


def _norm3(d: torch.Tensor) -> torch.Tensor:
    return sqrt32(_sum3_sq(d))


def _top_eigenvector(n: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of each symmetric (B, 4, 4)
    float64 matrix, by repeated squaring of the matrix shifted to be
    positive semi-definite (the power method, 2^_SQUARINGS steps): the
    column of the power with the largest diagonal entry.  Every product is
    summed in a fixed order, so every device gives the same bits.  A zero
    matrix gives (1, 0, 0, 0), the identity rotation, as the SVD of a zero
    cross-covariance does."""
    b = n.shape[0]
    eye = torch.eye(4, dtype=n.dtype, device=n.device)
    a = torch.abs(n)
    # The largest absolute row sum bounds every eigenvalue's magnitude.
    sigma = (((a[..., 0] + a[..., 1]) + a[..., 2]) + a[..., 3]).amax(dim=1)
    m = n + sigma[:, None, None] * eye
    one = torch.ones((b, 1, 1), dtype=n.dtype, device=n.device)
    for _ in range(_SQUARINGS):
        scale = torch.abs(m).amax(dim=(1, 2), keepdim=True)
        m = m / torch.where(scale > 0, scale, one)
        m = ((m[:, :, 0:1] * m[:, 0:1, :] + m[:, :, 1:2] * m[:, 1:2, :]) + m[:, :, 2:3] * m[:, 2:3, :]) \
            + m[:, :, 3:4] * m[:, 3:4, :]
    top = torch.argmax(torch.diagonal(m, dim1=1, dim2=2), dim=1)
    v = torch.gather(m, 2, top[:, None, None].expand(b, 4, 1))[..., 0]
    norm = sqrt64(((v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]) + v[:, 3] * v[:, 3])
    return torch.where((norm > 0)[:, None], v / torch.where(norm > 0, norm, one[:, 0, 0])[:, None],
                       eye[0].expand(b, 4))


def kabsch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Rigid transforms aligning (B, P, 3) src points onto dst: (B, 4, 4)
    float32.  The rotation maximising sum (R src_i) . dst_i about the
    centroids (Horn's quaternion), in float64."""
    src = src.double()
    dst = dst.double()
    cs = src.mean(1)
    cd = dst.mean(1)
    xs = src - cs[:, None]
    xd = dst - cd[:, None]
    h = (xs[:, :, :, None] * xd[:, :, None, :]).sum(1)  # (B, 3, 3): S_ab = sum src_a dst_b
    sxx, sxy, sxz = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    syx, syy, syz = h[:, 1, 0], h[:, 1, 1], h[:, 1, 2]
    szx, szy, szz = h[:, 2, 0], h[:, 2, 1], h[:, 2, 2]
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)
    qv = _top_eigenvector(n)
    w, x, y, z = qv.unbind(-1)
    r = torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)
    t = cd - (r * cs[:, None, :]).sum(-1)
    out = torch.zeros((src.shape[0], 4, 4), dtype=torch.float32, device=src.device)
    out[:, :3, :3] = r.float()
    out[:, :3, 3] = t.float()
    out[:, 3, 3] = 1.0
    return out


def _transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) float32 transforms of (N, 3) points: (B, N, 3), each
    coordinate's products added in order with contracted multiply-adds."""
    r, t = T[:, :3, :3], T[:, :3, 3]
    p = pts[None, :, None, 0] * r[:, None, :, 0]
    p = _fma(pts[None, :, None, 1], r[:, None, :, 1], p)
    p = _fma(pts[None, :, None, 2], r[:, None, :, 2], p)
    return p + t[:, None, :]


def _lcp_scores(T: torch.Tensor, model_eval: torch.Tensor, scene: torch.Tensor, delta: float) -> torch.Tensor:
    """LCP score per hypothesis: fraction of transformed model_eval points
    within ``delta`` of any scene point, (B,) float32.

    The squared distances XLA compares are float32 sums with contracted
    multiply-adds (``_sum3_sq``); forming all B x Ne x Ns of them is slow,
    so each point's nearest squared distance is first taken in float64 as
    |p|^2 + |s|^2 - 2 p.s (one matrix product), whose error is far below the
    float32 rounding, and only the points whose nearest distance lies
    within 2^-20 of the gate are decided again with the contracted sums.
    """
    b, ne, ns = T.shape[0], model_eval.shape[0], scene.shape[0]
    gate = _sq32(delta)
    p = _transform(T, model_eval)  # (B, Ne, 3) float32, as XLA forms it
    p64, s64 = p.double(), scene.double()
    pp = (p64 * p64).sum(-1)
    ss = (s64 * s64).sum(-1)
    per = max(1, _block(T) // max(1, ne * ns))
    near = torch.cat([
        torch.baddbmm(ss.expand(min(per, b - h0), 1, ns), p64[h0: h0 + per], s64.T.expand(min(per, b - h0), 3, ns),
                      alpha=-2.0).amin(dim=2)
        for h0 in range(0, b, per)]) + pp
    # float64 error of the expansion plus float32 rounding of the sums.
    slack = gate * 2.0**-20 + (pp.max() + ss.max()) * 2.0**-48
    inl = near < gate - slack
    hb, he = torch.nonzero((near >= gate - slack) & (near < gate + slack), as_tuple=True)
    if hb.numel():
        exact = _sum3_sq(p[hb, he][:, None, :] - scene[None, :, :]).amin(dim=1)
        inl[hb, he] = exact < torch.full_like(exact, gate)
    # The mean as XLA compiles it: the count times the folded 1 / Ne.
    return inl.to(torch.float32).sum(1) * float(np.float32(1.0) / np.float32(ne))


def _side_lengths(tri: torch.Tensor) -> torch.Tensor:
    """(H, 3, 3) triangles -> (H, 3) side lengths |v0 v1|, |v1 v2|, |v2 v0|."""
    return torch.stack([_norm3(tri[:, 0] - tri[:, 1]), _norm3(tri[:, 1] - tri[:, 2]), _norm3(tri[:, 2] - tri[:, 0])], 1)


def _ransac_core(scene, model, model_eval, tri_scene, tri_model, delta: float):
    """Congruent-triangle RANSAC over every hypothesis at once: the best
    one's (T (4, 4), lcp ())."""
    s_tri = scene[tri_scene]  # (H, 3, 3)
    m_tri = model[tri_model]
    ss, sm = _side_lengths(s_tri), _side_lengths(m_tri)
    ds = torch.sort(ss, dim=1).values
    dm = torch.sort(sm, dim=1).values
    # Match every scene triangle to the closest model triangle by sides.
    diff = _sum3_sq(ds[:, None, :] - dm[None, :, :])  # (H, H)
    match = torch.argmin(diff, dim=1)
    match_err = torch.gather(diff, 1, match[:, None])[:, 0]

    def order_tri(tri, sides):
        # Vertices sorted by their opposite side, stably (JAX's argsort).
        opp = sides[:, [1, 2, 0]]
        idx = torch.argsort(opp, dim=1, stable=True)
        return torch.gather(tri, 1, idx[..., None].expand(-1, -1, 3))

    s_ord = order_tri(s_tri, ss)
    m_ord = order_tri(m_tri[match], sm[match])
    T = kabsch(m_ord, s_ord)  # model -> scene
    lcp = _lcp_scores(T, model_eval, scene, delta)
    gate = torch.full((), _sq32(np.float32(delta) * np.float32(4.0)), dtype=torch.float32, device=T.device)
    lcp = torch.where(match_err < gate, lcp, torch.zeros_like(lcp))
    best = torch.argmax(lcp)
    return T[best], lcp[best]


def _coplanar_base(scene: np.ndarray, rng, delta: float, trials: int = 48):
    """Extract a wide coplanar 4-point base from the scene cloud with
    intersecting diagonals (Super4PCS TryQuadrilateral semantics); a copy
    of the JAX package's host step.

    Returns (pair1 (2,3), pair2 (2,3), r1, r2) or None.
    """
    n = len(scene)
    if n < 8:
        return None
    for _ in range(trials):
        idx = rng.choice(n, 3, replace=False)
        a, b, c = scene[idx]
        nrm = np.cross(b - a, c - a)
        nn = np.linalg.norm(nrm)
        if nn < 1e-9:
            continue
        nrm = nrm / nn
        dist = np.abs((scene - a) @ nrm)
        mask = dist < delta
        mask[idx] = False
        cand = np.nonzero(mask)[0]
        if len(cand) == 0:
            continue
        cen = (a + b + c) / 3.0
        d4 = cand[np.argmax(np.linalg.norm(scene[cand] - cen, axis=1))]
        quad = scene[np.concatenate([idx, [d4]])]
        for (i, j, k, l) in ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2)):
            p1, p2, p3, p4 = quad[i], quad[j], quad[k], quad[l]
            u = p2 - p1
            v = p4 - p3
            w0 = p1 - p3
            aa, bb, cc = u @ u, u @ v, v @ v
            dd, ee = u @ w0, v @ w0
            den = aa * cc - bb * bb
            if abs(den) < 1e-9:
                continue
            s = (bb * ee - cc * dd) / den
            t = (aa * ee - bb * dd) / den
            if not (0.05 <= s <= 0.95 and 0.05 <= t <= 0.95):
                continue
            e1 = p1 + s * u
            e2 = p3 + t * v
            if np.linalg.norm(e1 - e2) < delta:
                return (
                    np.stack([p1, p2]),
                    np.stack([p3, p4]),
                    float(s),
                    float(t),
                )
    return None


def _fourpcs_core(scene, model, model_eval, pairs_i, pairs_j, base1, base2, r1: float, r2: float, delta: float,
                  top_hyp: int = 256):
    """Congruent-4-point matching (4PCS): model pairs whose length matches a
    scene diagonal give an intersection-point estimate; the ``top_hyp``
    pairs of pairs whose estimates coincide best are fitted and scored.
    Returns (T (K, 4, 4), lcp (K,))."""
    dev = scene.device
    pa = model[pairs_i]
    pb = model[pairs_j]
    lens = _norm3(pb - pa)
    d1 = _norm3(base1[1] - base1[0])
    d2 = _norm3(base2[1] - base2[0])
    dl = float(np.float32(delta))
    ok1 = torch.abs(lens - d1) < dl
    ok2 = torch.abs(lens - d2) < dl
    r1_t = torch.full((), float(np.float32(r1)), dtype=torch.float32, device=dev)
    r2_t = torch.full((), float(np.float32(r2)), dtype=torch.float32, device=dev)
    e1 = _fma(r1_t, pb - pa, pa)
    e2 = _fma(r2_t, pb - pa, pa)
    e1m = torch.where(ok1[:, None], e1, torch.full_like(e1, 1e9))
    e2m = torch.where(ok2[:, None], e2, torch.full_like(e2, -1e9))
    p = pairs_i.shape[0]
    per = max(1, _block(scene) // max(1, p * 3))
    mind, argm = [], []
    for c0 in range(0, p, per):
        d2_ = _sum3_sq(e1m[c0: c0 + per, None, :] - e2m[None, :, :])
        v, i = torch.min(d2_, dim=1)
        mind.append(v)
        argm.append(i)
    mind, argm = torch.cat(mind), torch.cat(argm)
    # lax.top_k(-mind): the smallest first, the lowest index among ties.
    order = torch.argsort(mind, stable=True)
    sel = order[:top_hyp]
    q2 = argm[sel]
    src = torch.stack([pa[sel], pb[sel], pa[q2], pb[q2]], dim=1)  # (K, 4, 3) model base
    dst = torch.cat([base1, base2], dim=0)[None].expand(src.shape[0], 4, 3)
    T = kabsch(src, dst)
    lcp = _lcp_scores(T, model_eval, scene, delta)
    gate = torch.full((), _sq32(delta), dtype=torch.float32, device=dev)
    lcp = torch.where(mind[sel] < gate, lcp, torch.zeros_like(lcp))
    best = torch.argmax(lcp)
    return T[best], lcp[best]


def pose_estimation(
    segment_cloud: np.ndarray,
    model_pts: np.ndarray,
    delta: float = 5.0,
    min_lcp: float = 0.5,
    num_hyp: int = 1024,
    sample_scene: int = 512,
    sample_model: int = 512,
    sample_eval: int = 256,
    seed: int = 0,
    method: str = "auto",
    num_bases: int = 4,
    num_pairs: int = 2048,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Register a segment cloud against a model cloud, on ``device`` (the
    card unless ``"cpu"``).

    Args:
      segment_cloud: (N, 3) scene-segment points (model units, e.g. mm).
      model_pts: (M, 3) model points.
      delta: LCP inlier radius in model units.
      min_lcp: acceptance threshold (reference: LCP > 0.5).
      method: "tri", "4pcs", or "auto" (tri first, 4pcs fallback when below
        ``min_lcp``).

    Returns (T, lcp): model->scene 4x4 float64 (zeros when below min_lcp),
    score.  Each hypothesis generator reads its best transform and score
    back once.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    scene = _subsample(segment_cloud, sample_scene)
    model = _subsample(model_pts, sample_model)
    model_eval = _subsample(model_pts, sample_eval, seed=1)
    scene_t, model_t, eval_t = (torch.from_numpy(a).to(dev) for a in (scene, model, model_eval))

    best_T, best_lcp = np.zeros((4, 4)), 0.0

    if method in ("tri", "auto"):
        tri_s = rng.integers(0, len(scene), (num_hyp, 3))
        tri_m = rng.integers(0, len(model), (num_hyp, 3))
        T, lcp = _ransac_core(scene_t, model_t, eval_t, torch.from_numpy(tri_s).to(dev),
                              torch.from_numpy(tri_m).to(dev), float(delta))
        host = torch.cat([T.reshape(-1), lcp.reshape(1)]).cpu().numpy()
        best_T, best_lcp = host[:16].reshape(4, 4).astype(np.float64), float(host[16])

    if method == "4pcs" or (method == "auto" and best_lcp <= min_lcp):
        pairs_i = rng.integers(0, len(model), num_pairs)
        pairs_j = rng.integers(0, len(model), num_pairs)
        far = pairs_i != pairs_j
        pairs_i, pairs_j = pairs_i[far], pairs_j[far]
        pi_t, pj_t = torch.from_numpy(pairs_i).to(dev), torch.from_numpy(pairs_j).to(dev)
        for _ in range(num_bases):
            base = _coplanar_base(scene, rng, delta)
            if base is None:
                continue
            b1, b2, r1, r2 = base
            T, lcp = _fourpcs_core(scene_t, model_t, eval_t, pi_t, pj_t,
                                   torch.from_numpy(b1.astype(np.float32)).to(dev),
                                   torch.from_numpy(b2.astype(np.float32)).to(dev), r1, r2, float(delta))
            host = torch.cat([T.reshape(-1), lcp.reshape(1)]).cpu().numpy()
            lcp = float(host[16])
            if lcp > best_lcp:
                best_T, best_lcp = host[:16].reshape(4, 4).astype(np.float64), lcp
            if best_lcp > min_lcp:
                break

    if best_lcp <= min_lcp:
        return np.zeros((4, 4)), best_lcp
    return best_T, best_lcp
