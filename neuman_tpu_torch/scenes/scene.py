"""Scene containers: captures and a point cloud, and for a NeuMan scene
its SMPL state (the port's copy of neuman_tpu/scenes/scene.py)."""

import os


class BaseScene:
    def __init__(self, captures, point_cloud=None):
        self.captures = captures
        self.point_cloud = point_cloud

    def __str__(self):
        s = f"this scene contains {len(self.captures)} captures"
        if self.point_cloud is not None:
            s += f", with {self.point_cloud.shape[0]} points"
        return s

    def read_data_to_ram(self, data_list=("image",)):
        """Read the images ("image": also masks and mono depth) and MVS
        depth maps ("depth") of every capture into memory; returns bytes."""
        total = 0
        for cap in self.captures:
            if "image" in data_list:
                total += cap.read_image_to_ram()
            if "depth" in data_list:
                total += cap.read_depth_to_ram()
        return total


class ImageFileScene(BaseScene):
    def __init__(self, captures, point_cloud=None):
        super().__init__(captures, point_cloud)
        if not captures:
            raise ValueError("a scene needs captures")
        self.image_path_to_index = {}
        self.fname_to_index_dict = {}
        for i, cap in enumerate(captures):
            fname = os.path.basename(cap.image_path)
            if cap.image_path in self.image_path_to_index or fname in self.fname_to_index_dict:
                raise ValueError(f"image {cap.image_path} appears twice")
            self.image_path_to_index[cap.image_path] = i
            self.fname_to_index_dict[fname] = i

    def __getitem__(self, x):
        if isinstance(x, str):
            if x in self.image_path_to_index:
                return self.captures[self.image_path_to_index[x]]
            return self.captures[self.fname_to_index_dict[x]]
        return self.captures[x]


class RigCameraScene(ImageFileScene):
    def __init__(self, captures, num_views, num_cams, point_cloud=None):
        super().__init__(captures, point_cloud)
        self.num_views = num_views
        self.num_cams = num_cams
        self.view_id_to_index = {}
        self.cam_id_to_index = {}
        for i, cap in enumerate(captures):
            if cap.view_id >= num_views or cap.cam_id >= num_cams:
                raise ValueError(f"capture {i}: view {cap.view_id} / camera {cap.cam_id} out of "
                                 f"range ({num_views} views, {num_cams} cameras)")
            self.view_id_to_index.setdefault(cap.view_id, []).append(i)
            self.cam_id_to_index.setdefault(cap.cam_id, []).append(i)

    def __str__(self):
        s = (f"this scene is captured by a {self.num_cams} cameras rig, has "
             f"{self.num_views} views, and in total {len(self.captures)} captures")
        if self.point_cloud is not None:
            s += f", with {self.point_cloud.shape[0]} points"
        return s

    def get_capture_by_view_cam_id(self, view_id, cam_id):
        idx = set(self.cam_id_to_index[cam_id]) & set(self.view_id_to_index[view_id])
        if len(idx) != 1:
            raise KeyError(f"{len(idx)} captures of view {view_id}, camera {cam_id}")
        return self.captures[idx.pop()]
