"""NeuMan scene reader (the port's copy of neuman_tpu/data_io/neuman.py):
COLMAP text -> captures -> near/far planes -> normalisation -> SMPL.

- Per capture near/far: the background's from the projected COLMAP point
  cloud (near 0, far its 95th percentile depth), the human's from the
  projected posed SMPL vertices (min, max), each widened by its range
  scale about its centre.
- `normalize`: scale = 3.14 / 95th percentile of the background fars,
  applied to camera centres, depth maps, the point cloud and the SMPL
  transforms.
- `read_smpls`: per frame, the Da-pose -> scene transform
  T_da2scene = S @ alignment.T @ T_t2pose @ inv(T_t2da) and the world
  vertices and joints. The skinning runs in torch float32 on the CPU (one
  frame at a time), then the same numpy float64 products as the JAX reader.
- `create_split_files`: the 80/10/10 interleaved train/val/test split.

The scene reader runs on the host: nothing here touches the card.
"""

import os

import numpy as np
import torch

from neuman_tpu_torch.cameras.capture import Capture
from neuman_tpu_torch.data_io import smpl_pickle
from neuman_tpu_torch.data_io.colmap import ColmapAsciiReader
from neuman_tpu_torch.geometry import pcd
from neuman_tpu_torch.models import smpl as smpl_module
from neuman_tpu_torch.scenes.scene import RigCameraScene


def default_data_root():
    """$NEUMAN_DATA_ROOT, else <repo>/data (where smplx/smpl/SMPL_NEUTRAL.pkl
    and smplx/smpl_uv.obj are looked for)."""
    env = os.environ.get("NEUMAN_DATA_ROOT")
    if env:
        return env
    return os.path.join(os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")),
                        "data")


def default_smpl_path():
    return os.path.join(default_data_root(), "smplx", "smpl")


def to_homogeneous(pts):
    return np.concatenate([pts, np.ones_like(pts[..., 0:1])], axis=-1)


def read_obj(path):
    """(vertices, uvs, faces - 1) of a wavefront obj with UVs; a face row
    holds its vertex ids, then its uv ids."""
    vert, uvs, faces = [], [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line[:2] == "v ":
                vert.append(np.array([float(i) for i in line[2:].split()]))
            elif line[:3] == "vt ":
                uvs.append(np.array([float(i) for i in line[3:].split()]))
            elif line[:2] == "f ":
                fs = line[2:].split()
                fv = [int(i.split("/")[0]) for i in fs]
                ft = [int(i.split("/")[1]) for i in fs]
                faces.append(np.array(fv + ft))
    return np.array(vert), np.array(uvs), np.array(faces) - 1


def read_text(txt_file):
    """The non-empty lines of a text file, stripped."""
    with open(txt_file, "r") as fid:
        return [line.strip() for line in fid if line.strip()]


def create_split_files(scene_dir):
    """Write {train,val,test}_split.txt (file names, one a line) into
    `scene_dir`: every (N // (N // 5))-th capture from the middle of the
    first stride is held out, the first half of those for test, the rest
    for validation. Returns the three paths."""
    dummy_scene = NeuManReader.read_scene(scene_dir)
    scene_length = len(dummy_scene.captures)
    num_val = scene_length // 5
    if num_val == 0:
        raise ValueError(f"{scene_dir}: {scene_length} captures are too few for a split")
    length = int(1 / num_val * scene_length)
    offset = length // 2
    val_list = list(range(scene_length))[offset::length]
    train_list = list(set(range(scene_length)) - set(val_list))
    test_list = val_list[: len(val_list) // 2]
    val_list = val_list[len(val_list) // 2:]
    if not (train_list and test_list and val_list):
        raise ValueError(f"{scene_dir}: {scene_length} captures leave an empty split")
    splits = []
    for lst, split in zip([train_list, val_list, test_list], ["train", "val", "test"]):
        save_path = os.path.join(scene_dir, f"{split}_split.txt")
        with open(save_path, "w") as f:
            for i, cap in enumerate(dummy_scene.captures):
                if i in lst:
                    f.write(os.path.basename(cap.image_path) + "\n")
        splits.append(save_path)
    return splits


class NeuManReader:
    @classmethod
    def read_scene(cls, scene_dir, tgt_size=None, normalize=False, bkg_range_scale=1.1,
                   human_range_scale=1.1, mask_dir="segmentations", smpl_type="romp",
                   keypoints_dir="keypoints", densepose_dir="densepose", smpl_model_path=None):
        """A RigCameraScene of `scene_dir` with `point_cloud`, `scale`,
        `smpls` (per frame: the fit's entries at its frame, `joints_3d`,
        `static_joints_3d`), `verts` and `static_vert` (posed world and
        Da-pose vertices), `Ts` (Da-pose -> scene, [V + J, 4, 4] float64),
        `faces` ([F, 6] int64: vertex ids, then uv ids), `uvs`, and per
        capture near/far for "bkg" and "human" and `frame_id`."""

        def update_near_far(scene, key, range_scale):
            for view_id in range(scene.num_views):
                for cam_id in range(scene.num_cams):
                    cap = scene.get_capture_by_view_cam_id(view_id, cam_id)
                    if key == "bkg":
                        pcd_2d = pcd.project_point_cloud_at_capture(scene.point_cloud, cap)
                        near, far = 0, np.percentile(pcd_2d[:, 2], 95)
                    else:
                        pcd_2d = pcd.project_point_cloud_at_capture(scene.verts[view_id], cap)
                        near, far = pcd_2d[:, 2].min(), pcd_2d[:, 2].max()
                    center = (near + far) / 2
                    length = (far - near) * range_scale
                    cap.near[key] = max(0.0, float(center - length / 2))
                    cap.far[key] = float(center + length / 2)

        captures, point_cloud, num_views, num_cams = cls.read_captures(
            scene_dir, tgt_size, mask_dir=mask_dir, keypoints_dir=keypoints_dir,
            densepose_dir=densepose_dir)
        scene = RigCameraScene(captures, num_views, num_cams)
        scene.point_cloud = point_cloud
        update_near_far(scene, "bkg", bkg_range_scale)

        scale = 1
        if normalize:
            fars = np.array([cap.far["bkg"] for cap in scene.captures])
            scale = 3.14 / np.percentile(fars, 95)
            for cap in scene.captures:
                cap.cam_pose.camera_center_in_world = cap.cam_pose.camera_center_in_world * scale
                cap.near["bkg"], cap.far["bkg"] = cap.near["bkg"] * scale, cap.far["bkg"] * scale
                cap.captured_depth.scale = scale
                if cap.captured_mono_depth is not None:
                    cap.captured_mono_depth.scale = scale
            scene.point_cloud[:, :3] *= scale
        scene.scale = scale

        model = cls._body_model(smpl_model_path)
        scene.smpls, scene.verts, scene.static_vert, scene.Ts = cls.read_smpls(
            scene_dir, scene.captures, scale=scale, smpl_type=smpl_type, body_model=model)
        uv_obj = os.path.join(default_data_root(), "smplx", "smpl_uv.obj")
        if os.path.isfile(uv_obj):
            _, uvs, faces = read_obj(uv_obj)
            scene.uvs, scene.faces = uvs, faces.astype(np.int64)
        else:
            # without the UV file, the body model's triangles twice
            # (faces[:, :3] is all the trainers read)
            scene.uvs = None
            scene.faces = np.concatenate([model.faces, model.faces], axis=1).astype(np.int64)
        update_near_far(scene, "human", human_range_scale)
        return scene

    @classmethod
    def _body_model(cls, smpl_model_path=None):
        """The neutral SMPL model on the CPU."""
        return smpl_module.load_smpl(smpl_model_path or default_smpl_path(), "neutral")

    @classmethod
    def read_smpls(cls, scene_dir, caps, scale=1, smpl_type="romp", smpl_model_path=None,
                   body_model=None):
        """(smpls, world verts, Da-pose verts, Ts) per capture, the SMPL
        fit of `smpl_output_<smpl_type>.pkl` at the frame its file name
        gives, placed in the scene by `alignments.npy`."""
        model = body_model or cls._body_model(smpl_model_path)
        smpl_path = os.path.join(scene_dir, f"smpl_output_{smpl_type}.pkl")
        if not os.path.isfile(smpl_path):
            raise FileNotFoundError(f"{smpl_path} is missing")
        raw_smpl = smpl_pickle.load(smpl_path)
        if len(raw_smpl) != 1:
            raise ValueError(f"{smpl_path} holds {len(raw_smpl)} tracks, not 1")
        raw_smpl = raw_smpl[list(raw_smpl.keys())[0]]
        raw_alignments = np.load(os.path.join(scene_dir, "alignments.npy"),
                                 allow_pickle=True).item()
        da_smpl = smpl_module.da_pose_vector(model.num_joints)

        def frame_tensors(pose, betas):
            """The frame's T_t2pose, T_t2da (vertices then joints), Da-pose
            vertices and joints, as float32 numpy."""
            with torch.no_grad():
                t_v, _, _, t_j, _, _ = smpl_module.lbs_joints(betas, pose, model)
                da_v, _, dav, da_j, _, daj = smpl_module.lbs_joints(betas, da_smpl, model)
            return (torch.cat([t_v[0], t_j[0]]).numpy(), torch.cat([da_v[0], da_j[0]]).numpy(),
                    dav[0].numpy(), daj[0].numpy())

        smpls, static_verts, world_verts, Ts = [], [], [], []
        for cap in caps:
            fname = os.path.basename(cap.image_path)
            frame_id = int(fname[:-4])
            temp_smpl = {}
            for k, v in raw_smpl.items():
                try:
                    temp_smpl[k] = v[frame_id]
                except (IndexError, KeyError, TypeError):
                    temp_smpl[k] = None
            temp_alignment = np.eye(4)
            temp_alignment[:, :3] = raw_alignments[fname]

            T_t2pose, T_t2da, da_verts, da_joints = frame_tensors(
                torch.as_tensor(np.asarray(temp_smpl["pose"][None], dtype=np.float32)),
                torch.as_tensor(np.asarray(temp_smpl["betas"][None], dtype=np.float32)))
            T_da2pose = T_t2pose @ np.linalg.inv(T_t2da)
            T_da2scene = temp_alignment.T @ T_da2pose
            s = np.eye(4)
            s[:3, :3] *= scale
            T_da2scene = s @ T_da2scene

            temp_world = np.einsum(
                "BNi,Bi->BN", T_da2scene,
                to_homogeneous(np.concatenate([da_verts, da_joints], axis=0)))[:, :3].astype(
                    np.float32)
            nv = model.num_verts
            temp_smpl["joints_3d"] = temp_world[nv:]
            temp_smpl["static_joints_3d"] = da_joints
            smpls.append(temp_smpl)
            Ts.append(T_da2scene)
            static_verts.append(da_verts)
            world_verts.append(temp_world[:nv])
        return smpls, world_verts, static_verts, Ts

    @classmethod
    def read_captures(cls, scene_dir, tgt_size, mask_dir="segmentations",
                      keypoints_dir="keypoints", densepose_dir="densepose"):
        raw_scene = ColmapAsciiReader.read_scene(
            os.path.join(scene_dir, "sparse"), os.path.join(scene_dir, "images"),
            tgt_size=None,  # Capture resizes the camera
            order="video")
        caps = []
        for view_id, raw_cap in enumerate(raw_scene.captures):
            depth_path = raw_cap.image_path.replace("/images/", "/depth_maps/") + ".geometric.bin"
            mono_depth_path = raw_cap.image_path.replace("/images/", "/mono_depth/")
            if not os.path.isfile(depth_path):
                depth_path = raw_cap.image_path + "dummy"
            if not os.path.isfile(mono_depth_path):
                mono_depth_path = raw_cap.image_path + "dummy"
            fname = os.path.basename(raw_cap.image_path)
            mask_path = os.path.join(scene_dir, mask_dir, fname + ".npy")
            if not os.path.isfile(mask_path):
                mask_path = os.path.join(scene_dir, mask_dir, fname)
            keypoints_path = os.path.join(scene_dir, keypoints_dir, fname + ".npy")
            densepose_path = os.path.join(scene_dir, densepose_dir, "dp_" + fname + ".npy")
            cap = Capture(
                raw_cap.image_path, depth_path, mask_path, raw_cap.pinhole_cam, raw_cap.cam_pose,
                view_id=view_id, cam_id=0, tgt_size=tgt_size, mono_depth_path=mono_depth_path,
                keypoints_path=keypoints_path if os.path.isfile(keypoints_path) else None,
                densepose_path=densepose_path if os.path.isfile(densepose_path) else None)
            cap.frame_id = raw_cap.frame_id
            caps.append(cap)
        return caps, raw_scene.point_cloud, len(caps), 1
