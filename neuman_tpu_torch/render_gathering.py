"""Telegathering: several reconstructed humans in one scene (counterpart
of render_gathering.py).

    python -m neuman_tpu_torch.render_gathering --scene_dir <dir> \
        --weights_path <out>/<background>/checkpoint.npz [--actors a b ...]

Each actor's human net comes from ./out/<ACTOR_WEIGHTS_DICT[actor]>/
checkpoint.npz, its betas from <dirname(scene_dir)>/<actor>/
smpl_output_optimized.pkl, its manual alignment from the `--motion_name`
preset (default dance_together); all actors follow the preset's motion
(./data/SFU/0018/0018_XinJiang002_poses.npz, frames 0:800:4; these paths
are fixed, as in the JAX script, and relative to the working directory).
The background net comes from `--weights_path`. Each frame is rendered by
`render_hybrid_nerf_multi_persons` from a camera on an ellipse about a
capture of the scene (the body's topology built once for every actor and
frame) and written as ./demo/gathering/<motion_name>/
out_%04d.png. `main(argv, device)` runs on the card unless device="cpu";
under `torchrun --nproc_per_node N` each chunk's rays split over N GPUs
and rank 0 writes (render/cli.py).
"""

import argparse
import copy
import os
import sys

import numpy as np

from neuman_tpu_torch.data_io import neuman, smpl_pickle
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.render import cli, renderer
from neuman_tpu_torch.render_reposing import mocap_to_scene, read_mocap
from neuman_tpu_torch.train import auto_geo_threshold, require_device

ACTOR_WEIGHTS_DICT = {
    "seattle": "seattle_human",
    "citron": "citron_human",
    "parkinglot": "parkinglot_human",
}
DEFAULT_ACTORS = ["seattle", "citron", "parkinglot"]


def read_novel_caps(opt, num_caps, scene):
    """`num_caps` copies of capture min(20, N - 1), the i-th moved on an
    ellipse (0.15 along its right axis, 0.05 along its up axis) two turns
    over the frames."""
    novel_caps = []
    base_id = min(20, len(scene.captures) - 1)
    for i in range(num_caps):
        cap = copy.deepcopy(scene.captures[base_id])
        ellipse_a, ellipse_b = 0.15, 0.05
        x_off = cap.cam_pose.right * ellipse_a * np.cos((i / num_caps) * (4 * np.pi))
        y_off = cap.cam_pose.up * ellipse_b * np.sin((i / num_caps) * (4 * np.pi))
        cap.cam_pose.camera_center_in_world = cap.cam_pose.camera_center_in_world + x_off + y_off
        novel_caps.append(cap)
    return novel_caps


def get_mocap_path(motion_name, actor_name=None):
    """(path, start, end, skip) of the motion's preset."""
    if motion_name == "dance_together":
        return "./data/SFU/0018/0018_XinJiang002_poses.npz", 0, 800, 4
    raise ValueError("Define new elif branch")


def get_manual_alignment(motion_name, actor_name):
    """(translation, Euler angles in radians, scale) of an actor in the
    motion's preset; identity for any other."""
    presets = {
        ("dance_together", "seattle"): ([0, 0.15, 0.77], [90.4, -10.9, 4], 0.2),
        ("dance_together", "citron"): ([-0.36, 0.13, 0.92], [90, -9.4, 4], 0.2),
        ("dance_together", "parkinglot"): ([0.32, 0.12, 0.96], [90, -11.6, 4], 0.2),
    }
    if (motion_name, actor_name) in presets:
        t, r, s = presets[(motion_name, actor_name)]
        return np.array(t), np.array(r) / 180 * np.pi, s
    return np.array([0, 0, 0]), np.zeros(3), 1


def read_actor(opt, actor_name, device="cuda"):
    """(spec, HumanNeRF, posed vertices per frame, T_da2scene per frame) of
    an actor: its checkpoint, its mean betas and the motion's frames."""
    spec = hn.build_human_nerf_spec(opt)
    model, _ = cli.load_model(spec, f"./out/{ACTOR_WEIGHTS_DICT[actor_name]}/checkpoint.npz",
                              device)
    poses, trans = read_mocap(*get_mocap_path(opt.motion_name))
    smpl_path = os.path.join(os.path.dirname(opt.scene_dir), actor_name,
                             "smpl_output_optimized.pkl")
    raw_smpl = smpl_pickle.load(smpl_path)
    raw_smpl = raw_smpl[list(raw_smpl.keys())[0]]
    beta = np.array(raw_smpl["betas"]).mean(0)
    raw_verts, ts_list = mocap_to_scene(neuman.NeuManReader._body_model(), poses, trans, beta,
                                        get_manual_alignment(opt.motion_name, actor_name))
    return spec, model, raw_verts, ts_list


def run(opt, device="cuda", mesh=None):
    """Render the actors of `opt.actors` together, each frame's rays split
    over `mesh`. Returns the frames' paths."""
    scene = cli.read_scene(opt, smpl_type="optimized")
    geo_threshold, _ = auto_geo_threshold(scene)
    actors = [read_actor(opt, a, device) for a in opt.actors]
    caps = read_novel_caps(opt, len(actors[0][2]), scene)
    bkg_spec = hn.build_human_nerf_spec(opt)
    bkg_model = cli.load_net(opt, bkg_spec, device)
    # every actor is the scene's body: one topology serves them all, every frame
    topology = mesh_ops.MeshTopology.build(scene.faces, len(actors[0][2][0]), device)
    saved = []
    for i in range(len(caps)):
        rgb = renderer.render_hybrid_nerf_multi_persons(
            bkg_spec, bkg_model, caps[i], [a[0] for a in actors], [a[1] for a in actors],
            [a[2][i] for a in actors], [scene.faces] * len(actors), [a[3][i] for a in actors],
            device, importance_samples_per_ray=opt.importance_samples_per_ray,
            geo_threshold=geo_threshold, topologies=[topology] * len(actors),
            **cli.render_kwargs(opt, mesh))[0]
        saved.append(cli.save_frame(rgb, f"gathering/{opt.motion_name}", i))
    return saved


def main(argv=None, device="cuda"):
    """The command line: `--actors` and train.py's flags (`--motion_name`
    dance_together by default). Returns the frames' paths."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--actors", nargs="*", type=str, default=DEFAULT_ACTORS)
    known, rest = pre.parse_known_args(argv)
    opt = cli.options(rest, motion_name="dance_together")
    opt.actors = known.actors
    require_device(device, "render")
    return run(opt, device, cli.render_mesh(opt, device))


if __name__ == "__main__":
    main(sys.argv[1:])
