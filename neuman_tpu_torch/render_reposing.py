"""Repose the reconstructed human with an AMASS mocap sequence
(counterpart of render_reposing.py).

    python -m neuman_tpu_torch.render_reposing --scene_dir <dir> \
        --weights_path <out>/<human>/checkpoint.npz \
        [--mocap_path <motion>_poses.npz --mocap_start 0 --mocap_end -1 --mocap_skip 1]

The motion's poses[start:end:skip] (the first 72 values, the hands
zeroed) and translations drive the scene's SMPL body (its first frame's
betas), placed in the scene by the per-scene manual alignment; without
`--mocap_path` the scene and `--motion_name` pick a preset (bike /
jumpandroll). Each frame is rendered with the hybrid renderer from a
camera dollied sideways from a capture of the scene and written as
./demo/reposing/<scene>/out_%04d.png, relative to the working directory.
`main(argv, device)` runs on the card unless device="cpu"; under `torchrun
--nproc_per_node N` each chunk's rays split over N GPUs and rank 0 writes
(render/cli.py).
"""

import copy
import os
import sys

import numpy as np
import torch

from neuman_tpu_torch.data_io import neuman
from neuman_tpu_torch.geometry import transforms
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import smpl as smpl_module
from neuman_tpu_torch.ops.mesh import MeshTopology
from neuman_tpu_torch.render import cli, renderer
from neuman_tpu_torch.train import auto_geo_threshold, require_device


def read_novel_caps(opt, num_caps, scene):
    """`num_caps` copies of one capture, the i-th moved 0.05 i along its
    right axis (bike / jumpandroll: capture 25; else the middle one)."""
    if os.path.basename(opt.scene_dir) == "bike" and opt.motion_name == "jumpandroll":
        start_id = 25
    else:
        start_id = len(scene.captures) // 2
    novel_caps = []
    for i in range(num_caps):
        temp = copy.deepcopy(scene.captures[start_id])
        temp.cam_pose.camera_center_in_world = (temp.cam_pose.camera_center_in_world
                                                + 0.05 * i * temp.cam_pose.right)
        novel_caps.append(temp)
    return novel_caps


def get_mocap_path(opt):
    """(path, start, end, skip) of the scene's preset motion."""
    if os.path.basename(opt.scene_dir) == "bike" and opt.motion_name == "jumpandroll":
        return "./data/SFU/0012/0012_JumpAndRoll001_poses.npz", 100, 400, 30
    raise ValueError("Define new elif branch")


def get_manual_alignment(opt):
    """(translation, Euler angles in radians, scale) placing the motion in
    the scene."""
    if os.path.basename(opt.scene_dir) == "bike" and opt.motion_name == "jumpandroll":
        return np.array([0.08, 0.12, 0.4]), np.array([95.8, 10.4, 1.8]) / 180 * np.pi, 0.14
    return np.array([0, 0, 0]), np.array([0, 0, 0], dtype=np.float64), 1


def read_mocap(path, start, end, skip):
    """(poses [T, 72] with the hand joints zeroed, translations [T, 3]) of
    frames start:end:skip of an AMASS .npz (poses [N, 156], trans [N, 3])."""
    motions = np.load(path)
    poses = motions["poses"][start:end:skip][:, :72]
    poses[:, 66:] = 0
    return poses, motions["trans"][start:end:skip]


def mocap_to_scene(body_model, poses, trans, beta, alignment):
    """Per frame, (posed vertices [V, 3] f32, T_da2scene [V, 4, 4] float64)
    of the body with betas `beta` [nb] in the poses [T, 72] and translations
    [T, 3], moved into the scene by `alignment` = (translation, Euler
    angles, scale): T_da2scene = T_mocap2scene @ T_t2mocap @ inv(T_t2da).
    The skinning runs in torch f32 on the host, the products in numpy
    float64, in the JAX scripts' order."""
    manual_trans, manual_rot, manual_scale = alignment
    m_s = np.eye(4)
    m_s[:3, :3] *= manual_scale
    t_mocap2scene = (transforms.translation_matrix(manual_trans) @ m_s
                     @ transforms.euler_matrix(*manual_rot))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    betas = f32(beta[None])
    da_smpl = smpl_module.da_pose_vector(body_model.num_joints)
    _, t_t2da = smpl_module.verts_transformations(body_model, da_smpl, betas)
    inv_t2da = np.linalg.inv(t_t2da[0].numpy())
    static_verts = smpl_module.smpl_forward(body_model, da_smpl, betas)[0][0].numpy()
    homog = neuman.to_homogeneous(static_verts)
    raw_verts, ts_list = [], []
    for p, t in zip(poses, trans):
        _, t_t2mocap = smpl_module.verts_transformations(body_model, f32(p[None]), betas,
                                                         transl=f32(t[None]))
        t_da2scene = t_mocap2scene[None] @ t_t2mocap[0].numpy() @ inv_t2da
        raw_verts.append(np.einsum("BNi,Bi->BN", t_da2scene, homog)[:, :3].astype(np.float32))
        ts_list.append(t_da2scene)
    return raw_verts, ts_list


def read_human_poses(opt, scene, mocap_path=None, start=None, end=None, skip=None):
    """Per frame, (posed vertices in the scene, T_da2scene) of the scene's
    body (its first frame's betas) in the motion of `mocap_path`, else of
    `--mocap_path` (`--mocap_end -1`: to the end), else of the preset."""
    if mocap_path is None:
        if opt.mocap_path is not None:
            mocap_path = opt.mocap_path
            start, end, skip = opt.mocap_start, opt.mocap_end, opt.mocap_skip
            if end == -1:
                end = None
        else:
            mocap_path, start, end, skip = get_mocap_path(opt)
    poses, trans = read_mocap(mocap_path, start, end, skip)
    return mocap_to_scene(neuman.NeuManReader._body_model(), poses, trans,
                          scene.smpls[0]["betas"], get_manual_alignment(opt))


def run(opt, device="cuda", mesh=None):
    """Render the reposed frames, each frame's rays split over `mesh`.
    Returns their paths."""
    scene = cli.read_scene(opt, smpl_type="optimized")
    geo_threshold, _ = auto_geo_threshold(scene)
    raw_verts, ts_list = read_human_poses(opt, scene)
    caps = read_novel_caps(opt, len(raw_verts), scene)
    spec = hn.build_human_nerf_spec(opt)
    model = cli.load_net(opt, spec, device)
    topology = MeshTopology.build(scene.faces, len(raw_verts[0]), device)
    saved = []
    for i in range(len(raw_verts)):
        rgb = renderer.render_hybrid_nerf(
            spec, model, caps[i], raw_verts[i], scene.faces, ts_list[i], device,
            importance_samples_per_ray=opt.importance_samples_per_ray,
            geo_threshold=geo_threshold, topology=topology, **cli.render_kwargs(opt, mesh))[0]
        saved.append(cli.save_frame(rgb, f"reposing/{os.path.basename(opt.scene_dir)}", i))
    return saved


def main(argv=None, device="cuda"):
    """The command line: train.py's flags. Returns the frames' paths."""
    opt = cli.options(argv)
    require_device(device, "render")
    return run(opt, device, cli.render_mesh(opt, device))


if __name__ == "__main__":
    main(sys.argv[1:])
