"""Homogeneous transformation helpers (the port's copy of
neuman_tpu/geometry/transforms.py: the quaternion and translation helpers
of the rotation and camera-pose types, and the axis-angle, Euler and
vector-angle helpers of the 360 paths and the mocap alignments; numpy,
float64).

Quaternion convention: (w, x, y, z), as COLMAP's images.txt.
"""

import math

import numpy as np


def unit_vector(v):
    """`v` scaled to unit length; raises on a zero vector."""
    v = np.asarray(v, dtype=np.float64)
    n = np.linalg.norm(v)
    if n == 0:
        raise ValueError("zero-length vector")
    return v / n


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


def rotation_matrix(angle, direction, point=None):
    """4x4 matrix rotating by `angle` radians about the axis `direction`,
    through `point` when given, else through the origin."""
    d = unit_vector(direction[:3])
    sina = math.sin(angle)
    cosa = math.cos(angle)
    r = np.eye(3) * cosa
    r += np.outer(d, d) * (1.0 - cosa)
    r += sina * np.array([[0.0, -d[2], d[1]], [d[2], 0.0, -d[0]], [-d[1], d[0], 0.0]])
    m = np.eye(4)
    m[:3, :3] = r
    if point is not None:
        point = np.asarray(point[:3], dtype=np.float64)
        m[:3, 3] = point - r @ point
    return m


def euler_matrix(ai, aj, ak, axes="sxyz"):
    """4x4 rotation matrix of Euler angles about static x, y, z:
    Rz(ak) @ Ry(aj) @ Rx(ai). Only the "sxyz" convention is supported."""
    if axes != "sxyz":
        raise NotImplementedError(f"unsupported euler convention: {axes}")
    ci, si = math.cos(ai), math.sin(ai)
    cj, sj = math.cos(aj), math.sin(aj)
    ck, sk = math.cos(ak), math.sin(ak)
    rx = np.array([[1, 0, 0], [0, ci, -si], [0, si, ci]])
    ry = np.array([[cj, 0, sj], [0, 1, 0], [-sj, 0, cj]])
    rz = np.array([[ck, -sk, 0], [sk, ck, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = rz @ ry @ rx
    return m


def angle_between_vectors(v0, v1, directed=True):
    """Angle in radians between two vectors; undirected: at most pi / 2."""
    v0 = np.asarray(v0, dtype=np.float64)
    v1 = np.asarray(v1, dtype=np.float64)
    dot = np.dot(v0, v1) / (np.linalg.norm(v0) * np.linalg.norm(v1))
    a = math.acos(np.clip(dot, -1.0, 1.0))
    if not directed:
        a = min(a, math.pi - a)
    return a
