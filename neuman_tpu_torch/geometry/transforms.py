"""Homogeneous transformation helpers (the port's copy of the four that
neuman_tpu/geometry/transforms.py gives to its rotation and camera-pose
types; numpy, float64).

Quaternion convention: (w, x, y, z), as COLMAP's images.txt.
"""

import math

import numpy as np


def translation_matrix(direction):
    """4x4 matrix translating by `direction` (3,)."""
    m = np.eye(4)
    m[:3, 3] = direction[:3]
    return m


def translation_from_matrix(matrix):
    """Translation component (3,) of a 4x4 matrix."""
    return np.asarray(matrix)[:3, 3].copy()


def quaternion_matrix(quaternion):
    """4x4 rotation matrix from quaternion (w, x, y, z)."""
    w, x, y, z = np.asarray(quaternion, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < np.finfo(np.float64).eps:
        return np.eye(4)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    m = np.eye(4)
    m[0, 0] = 1.0 - (yy + zz)
    m[0, 1] = xy - wz
    m[0, 2] = xz + wy
    m[1, 0] = xy + wz
    m[1, 1] = 1.0 - (xx + zz)
    m[1, 2] = yz - wx
    m[2, 0] = xz - wy
    m[2, 1] = yz + wx
    m[2, 2] = 1.0 - (xx + yy)
    return m


def quaternion_from_matrix(matrix):
    """Quaternion (w, x, y, z), w >= 0, from the upper-left 3x3 of a
    rotation matrix, by Shepperd's branch selection."""
    m = np.asarray(matrix, dtype=np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0.0:
        s = math.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] >= m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)
