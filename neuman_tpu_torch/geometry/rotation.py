"""Rotation and translation value types (the port's copy of
neuman_tpu/geometry/rotation.py; numpy).

- `Rotation` holds a unit quaternion (w, x, y, z);
- `UnstableRotation` holds a 4x4 rotation matrix as given, without a
  round trip through a quaternion (for matrices that may be slightly
  non-orthonormal, as a moved camera centre gives);
- `Translation` holds a float32 3-vector.
"""

import numpy as np

from neuman_tpu_torch.geometry import transforms


class Rotation:
    def __init__(self, quat):
        self.quaternion = quat

    def __str__(self):
        return f"quaternion: {self.quaternion}"

    @property
    def rotation_matrix(self):
        return transforms.quaternion_matrix(self.quaternion).astype(np.float32)

    @property
    def quaternion(self):
        return self._quaternion

    @quaternion.setter
    def quaternion(self, quat):
        quat = np.asarray(quat)
        if quat.shape != (4,):
            raise ValueError(f"a quaternion has shape (4,), not {quat.shape}")
        n = np.linalg.norm(quat)
        if not np.isclose(n, 1.0):
            quat = quat / n
        self._quaternion = quat


class UnstableRotation:
    """A rotation kept as a float64 4x4 matrix; its translation is zeroed."""

    def __init__(self, mat):
        mat = np.array(mat, dtype=np.float64)
        if mat.shape == (3, 3):
            m = np.eye(4)
            m[:3, :3] = mat
            mat = m
        if mat.shape != (4, 4):
            raise ValueError(f"a rotation matrix is 3x3 or 4x4, not {mat.shape}")
        mat[:3, 3] = 0
        self.rotation_matrix = mat

    def __str__(self):
        return f"rotation_matrix: {self.rotation_matrix}"


class Translation:
    def __init__(self, vec):
        self.translation_vector = vec

    def __str__(self):
        return f"translation: {self.translation_vector}"

    @property
    def translation_matrix(self):
        return transforms.translation_matrix(self.translation_vector).astype(np.float32)

    @property
    def translation_vector(self):
        return self._translation_vector

    @translation_vector.setter
    def translation_vector(self, vec):
        vec = np.asarray(vec, dtype=np.float32)
        if vec.shape != (3,):
            raise ValueError(f"a translation has shape (3,), not {vec.shape}")
        self._translation_vector = vec
