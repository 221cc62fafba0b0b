"""Rigid-transform utilities: rotations, Euler angles, quaternions.

Covers the subset of the reference's Gohlke transformations library
(pysixd/transform.py) actually used by the pipelines: rotation matrices
about axes, Euler <-> matrix (sxyz convention), quaternion <-> matrix,
random rotations, plus homogeneous compose/invert helpers.
Implemented from standard definitions in compact numpy.

A copy of the JAX package's ``geometry/transform.py`` (the port imports
nothing of that package): the same functions draw from an
``np.random.Generator`` in the same order, so scenes made from one seed are
equal in both packages.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def rotation_matrix(angle: float, direction: Sequence[float]) -> np.ndarray:
    """4x4 homogeneous rotation about an axis through the origin."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    c, s = math.cos(angle), math.sin(angle)
    K = np.array(
        [[0, -d[2], d[1]], [d[2], 0, -d[0]], [-d[1], d[0], 0]], np.float64
    )
    R = np.eye(3) * c + s * K + (1 - c) * np.outer(d, d)
    M = np.eye(4)
    M[:3, :3] = R
    return M


def euler_matrix(ai: float, aj: float, ak: float, axes: str = "sxyz") -> np.ndarray:
    """4x4 rotation from Euler angles.

    Supports the static conventions used by the reference scripts
    ('sxyz' default; LCHF_test.py uses euler from matrix and back).
    """
    if not axes.startswith("s") or axes[1:] not in ("xyz", "zyx"):
        raise NotImplementedError(f"axes {axes!r}")
    def rot(a, axis):
        v = [0.0, 0.0, 0.0]
        v["xyz".index(axis)] = 1.0
        return rotation_matrix(a, v)

    if axes == "sxyz":
        return rot(ak, "z") @ rot(aj, "y") @ rot(ai, "x")
    else:  # szyx
        return rot(ak, "x") @ rot(aj, "y") @ rot(ai, "z")


def euler_from_matrix(M: np.ndarray, axes: str = "sxyz"):
    """Euler angles (sxyz) from a rotation matrix: R = Rz(ak) Ry(aj) Rx(ai)."""
    if axes != "sxyz":
        raise NotImplementedError(f"axes {axes!r}")
    R = np.asarray(M)[:3, :3]
    cy = math.hypot(R[0, 0], R[1, 0])
    if cy > 1e-8:
        ai = math.atan2(R[2, 1], R[2, 2])
        aj = math.atan2(-R[2, 0], cy)
        ak = math.atan2(R[1, 0], R[0, 0])
    else:
        ai = math.atan2(-R[1, 2], R[1, 1])
        aj = math.atan2(-R[2, 0], cy)
        ak = 0.0
    return ai, aj, ak


def quaternion_matrix(q: Sequence[float]) -> np.ndarray:
    """4x4 rotation from quaternion (w, x, y, z)."""
    q = np.asarray(q, np.float64)
    n = np.dot(q, q)
    if n < 1e-14:
        return np.eye(4)
    q = q * math.sqrt(2.0 / n)
    q = np.outer(q, q)
    M = np.array(
        [
            [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
            [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
            [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2], 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    return M


def quaternion_from_matrix(M: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) from rotation matrix (Shepperd's method)."""
    R = np.asarray(M, np.float64)[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = math.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = math.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = math.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
    return np.array([w, x, y, z])


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation (via random unit quaternion)."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    return quaternion_matrix(q)[:3, :3]


def compose_rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(3,3), (3,) or (3,1) -> 4x4 homogeneous."""
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = np.asarray(t).flatten()
    return M


def invert_rt(M: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4."""
    R = M[:3, :3]
    t = M[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def transform_pts_Rt(pts: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply R, t to (n, 3) points (pysixd/misc.py:129)."""
    return pts @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
