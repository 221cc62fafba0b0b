"""View-sphere sampling for template training.

Reference: pysixd/view_sampler.py — icosahedron-refinement sampling
("hinter_sampling", :61), fibonacci lattice (:10), and viewpoint ->
camera (R, t) conversion with an in-plane tilt sweep ("pts2views",
:182-235; sample_views :237-259).  Behavior reproduced: same icosahedron
seed geometry, same midpoint refinement, same gluLookAt-style rotation
with the OpenGL->OpenCV flip, same azimuth/elevation filters.

A copy of the JAX package's ``geometry/view_sampler.py``; both give equal
arrays.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from sixdpose_tpu_torch.geometry.transform import rotation_matrix


def fibonacci_sampling(n_pts: int, radius: float = 1.0) -> np.ndarray:
    """Odd number of near-equidistant points on a sphere (golden-angle)."""
    assert n_pts % 2 == 1
    half = n_pts // 2
    phi = (math.sqrt(5.0) + 1.0) / 2.0
    ga = 2.0 * math.pi * (phi - 1.0)
    i = np.arange(-half, half + 1, dtype=np.float64)
    lat = np.arcsin(2.0 * i / (2 * half + 1))
    lon = (ga * i) % (2.0 * math.pi)
    s = np.cos(lat) * radius
    return np.stack([np.cos(lon) * s, np.sin(lon) * s, np.tan(lat) * s], 1)


def hinter_sampling(min_n_pts: int, radius: float = 1.0):
    """Icosahedron-refinement sphere sampling.

    Returns (pts (n, 3), level list) — each refinement level splits every
    triangle into four; points are projected back onto the sphere.
    (Point ordering differs from the reference's azimuth re-ordering pass,
    which has no effect on the trained template bank's coverage.)
    """
    b, c = 1.0, (1.0 + math.sqrt(5.0)) / 2.0
    pts = [
        (-b, c, 0.0), (b, c, 0.0), (-b, -c, 0.0), (b, -c, 0.0),
        (0.0, -b, c), (0.0, b, c), (0.0, -b, -c), (0.0, b, -c),
        (c, 0.0, -b), (c, 0.0, b), (-c, 0.0, -b), (-c, 0.0, b),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    levels = [0] * len(pts)
    ref_level = 0
    while len(pts) < min_n_pts:
        ref_level += 1
        edge_map = {}
        new_faces = []
        for face in faces:
            mids = []
            for i in range(3):
                e = tuple(sorted((face[i], face[(i + 1) % 3])))
                if e not in edge_map:
                    edge_map[e] = len(pts)
                    mid = 0.5 * (np.array(pts[e[0]]) + np.array(pts[e[1]]))
                    pts.append(tuple(mid))
                    levels.append(ref_level)
                mids.append(edge_map[e])
            a, bb, cc = face
            m0, m1, m2 = mids
            new_faces += [(a, m0, m2), (m0, bb, m1), (m0, m1, m2), (m2, m1, cc)]
        faces = new_faces
    p = np.array(pts, np.float64)
    p *= radius / np.linalg.norm(p, axis=1, keepdims=True)
    return p, levels


def _rotate_along_axis(theta: float, u: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Rotate vector x about unit axis u by theta (Rodrigues)."""
    c, s = math.cos(theta), math.sin(theta)
    return x * c + np.cross(u, x) * s + u * np.dot(u, x) * (1 - c)


def pts2views(
    pts: np.ndarray,
    azimuth_range: Tuple[float, float] = (0.0, 2 * math.pi),
    elev_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
    tilt_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
    tilt_step: float = 0.1 * math.pi,
) -> List[dict]:
    """Camera poses looking at the origin from each sphere point, with an
    in-plane tilt sweep (reference pts2views, view_sampler.py:182-235)."""
    views = []
    flip = rotation_matrix(math.pi, [1, 0, 0])[:3, :3]  # OpenGL -> OpenCV
    for pt in np.asarray(pts, np.float64):
        azimuth = math.atan2(pt[1], pt[0])
        if azimuth < 0:
            azimuth += 2.0 * math.pi
        a = np.linalg.norm(pt)
        b = np.linalg.norm([pt[0], pt[1], 0.0])
        elev = math.acos(min(max(b / a, -1.0), 1.0))
        if pt[2] < 0:
            elev = -elev
        if not (
            azimuth_range[0] <= azimuth <= azimuth_range[1]
            and elev_range[0] <= elev <= elev_range[1]
        ):
            continue
        f = -pt / np.linalg.norm(pt)
        for tilt in np.arange(tilt_range[0], tilt_range[1], tilt_step):
            u = np.array([0.0, 0.0, 1.0])
            s = np.cross(f, u)
            if np.count_nonzero(s) == 0:
                s = np.array([1.0, 0.0, 0.0])
            s = s / np.linalg.norm(s)
            s = _rotate_along_axis(tilt, f, s)
            u = np.cross(s, f)
            R = flip @ np.stack([s, u, -f], 0)
            t = -R @ pt.reshape(3, 1)
            views.append({"R": R, "t": t})
    return views


def sample_views(
    min_n_views: int,
    radius: float = 1.0,
    azimuth_range: Tuple[float, float] = (0.0, 2 * math.pi),
    elev_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
    tilt_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
    tilt_step: float = 0.1 * math.pi,
):
    """Sample camera views on a sphere (reference sample_views,
    view_sampler.py:237-259).  Returns (views, pts_level)."""
    pts, levels = hinter_sampling(min_n_views, radius=radius)
    return (
        pts2views(pts, azimuth_range, elev_range, tilt_range, tilt_step),
        levels,
    )
