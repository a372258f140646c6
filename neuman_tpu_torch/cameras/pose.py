"""World <-> camera extrinsics kept as (translation, rotation), both
world-to-camera (the port's copy of neuman_tpu/cameras/pose.py; numpy)."""

import numpy as np

from neuman_tpu_torch.geometry import transforms
from neuman_tpu_torch.geometry.rotation import Rotation, Translation, UnstableRotation


class CameraPose:
    def __init__(self, t, r):
        if not isinstance(t, Translation) or not isinstance(r, (Rotation, UnstableRotation)):
            raise TypeError("CameraPose takes a Translation and a Rotation")
        self.t = t
        self.r = r

    def __str__(self):
        return f"translation: {self.t}, rotation: {self.r}"

    @classmethod
    def from_world_to_camera(cls, world_to_camera, unstable=False):
        world_to_camera = np.asarray(world_to_camera)
        t = Translation(transforms.translation_from_matrix(world_to_camera).astype(np.float32))
        if unstable:
            r = UnstableRotation(world_to_camera)
        else:
            r = Rotation(transforms.quaternion_from_matrix(world_to_camera).astype(np.float32))
        return cls(t, r)

    @classmethod
    def from_camera_to_world(cls, camera_to_world, unstable=False):
        world_to_camera = np.linalg.inv(np.asarray(camera_to_world))
        world_to_camera /= world_to_camera[3, 3]
        return cls.from_world_to_camera(world_to_camera, unstable)

    @property
    def quaternion(self):
        return self.r.quaternion

    @property
    def world_to_camera(self):
        m = self.t.translation_matrix @ self.r.rotation_matrix
        m /= m[3, 3]
        return m

    @property
    def world_to_camera_3x4(self):
        return self.world_to_camera[0:3, 0:4]

    @property
    def extrinsic_matrix(self):
        """The 3x4 world-to-camera matrix."""
        return self.world_to_camera_3x4

    @property
    def camera_to_world(self):
        m = np.linalg.inv(self.world_to_camera)
        m /= m[3, 3]
        return m

    @property
    def camera_to_world_3x4(self):
        return self.camera_to_world[0:3, 0:4]

    @property
    def camera_center_in_world(self):
        return self.camera_to_world[:3, 3]

    @camera_center_in_world.setter
    def camera_center_in_world(self, value):
        c2w = self.camera_to_world
        c2w[:3, 3] = value
        self.t = CameraPose.from_camera_to_world(c2w, unstable=True).t

    @property
    def forward(self):
        return self.camera_to_world[:3, 2]

    @property
    def up(self):
        return -self.camera_to_world[:3, 1]

    @property
    def right(self):
        return self.camera_to_world[:3, 0]
