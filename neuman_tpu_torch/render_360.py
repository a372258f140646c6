"""360-degree orbits of the reconstructed human (counterpart of
render_360.py).

    python -m neuman_tpu_torch.render_360 --mode canonical_360|posed_360 \
        --scene_dir <dir> --weights_path <out>/<human>/checkpoint.npz

`--mode canonical_360` orbits the Da-posed human with the zoomed pinhole
camera (no warp); `--mode posed_360` orbits the posed human of the first
frame in scene space (the warp through the `ericson_select` kernel).
Frames go to ./demo/<mode>/<scene>/out_%04d.png, relative to the working
directory. Every other flag is train.py's (options/config.py), with
geo_threshold taken from the scene's bones. `main(argv, device)` runs on
the card unless device="cpu"; under `torchrun --nproc_per_node N` each
chunk's rays split over N GPUs and rank 0 writes (render/cli.py).
"""

import argparse
import os
import sys

from neuman_tpu_torch.cameras.capture import ResizedPinholeCapture
from neuman_tpu_torch.cameras.pinhole import PinholeCamera
from neuman_tpu_torch.data_io import neuman
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.ops.mesh import MeshTopology
from neuman_tpu_torch.options import config as config_module
from neuman_tpu_torch.render import cli, paths, renderer
from neuman_tpu_torch.render.cli import load_net
from neuman_tpu_torch.train import auto_geo_threshold, require_device
from neuman_tpu_torch.utils.constants import CANONICAL_CAMERA_DIST, CANONICAL_ZOOM_FACTOR
from neuman_tpu_torch.utils.misc import smpl_verts_to_center_and_up

MODES = ("canonical_360", "posed_360")


def main_canonical_360(opt, device="cuda", mesh=None):
    """The Da-posed human of the first frame, `opt.trajectory_resolution`
    cameras on a circle CANONICAL_CAMERA_DIST from its spine, each
    frame's rays split over `mesh`. Returns the frames' paths."""
    scene = cli.read_scene(opt)
    geo_threshold, can_bone = auto_geo_threshold(scene)
    spec = hn.build_human_nerf_spec(opt)
    model = load_net(opt, spec, device)
    body_model = neuman.NeuManReader._body_model()
    topology = MeshTopology.build(scene.faces, len(scene.static_vert[0]), device)

    center, up = smpl_verts_to_center_and_up(scene.static_vert[0], body_model)
    render_poses = paths.default_360_path(center, up, CANONICAL_CAMERA_DIST,
                                          opt.trajectory_resolution)
    base = scene.captures[0].pinhole_cam
    saved = []
    for i, rp in enumerate(render_poses):
        can_cap = ResizedPinholeCapture(
            PinholeCamera(base.width, base.height, CANONICAL_ZOOM_FACTOR * base.width,
                          CANONICAL_ZOOM_FACTOR * base.width, base.width / 2.0,
                          base.height / 2.0),
            rp, tgt_size=base.shape)
        rgb = renderer.render_smpl_nerf(
            spec, model, can_cap, scene.static_vert[0], scene.faces, None, device,
            render_can=True, interval_comp=geo_threshold / can_bone, geo_threshold=geo_threshold,
            topology=topology, **cli.render_kwargs(opt, mesh))[0]
        saved.append(cli.save_frame(rgb, f"canonical_360/{os.path.basename(opt.scene_dir)}", i))
    return saved


def main_posed_360(opt, device="cuda", mesh=None):
    """The posed human of the first frame, `opt.trajectory_resolution`
    cameras on a circle 36 geo_thresholds from its spine, each frame's
    rays split over `mesh`. Returns the frames' paths."""
    scene = cli.read_scene(opt, smpl_type="optimized")
    geo_threshold, _ = auto_geo_threshold(scene)
    spec = hn.build_human_nerf_spec(opt)
    model = load_net(opt, spec, device)
    body_model = neuman.NeuManReader._body_model()
    topology = MeshTopology.build(scene.faces, len(scene.verts[0]), device)

    cap_id = 0
    center, up = smpl_verts_to_center_and_up(scene.verts[cap_id], body_model)
    dist = geo_threshold * 36  # the camera's distance scales with the human's size
    render_poses = paths.default_360_path(center, up, dist, opt.trajectory_resolution)
    saved = []
    for i, rp in enumerate(render_poses):
        cap = ResizedPinholeCapture(scene.captures[0].pinhole_cam, rp,
                                    tgt_size=scene.captures[0].size)
        rgb = renderer.render_smpl_nerf(
            spec, model, cap, scene.verts[cap_id], scene.faces, scene.Ts[cap_id], device,
            white_bkg=opt.white_bkg, render_can=False, geo_threshold=geo_threshold,
            topology=topology, **cli.render_kwargs(opt, mesh))[0]
        saved.append(cli.save_frame(rgb, f"posed_360/{os.path.basename(opt.scene_dir)}", i))
    return saved


def main(argv=None, device="cuda"):
    """The command line: `--mode` and train.py's flags. Returns the
    frames' paths."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--mode", choices=MODES)
    known, rest = pre.parse_known_args(argv)
    opt = cli.options(rest)
    if known.mode is None:
        pre.error(f"--mode {'|'.join(MODES)} is required")
    if opt.geo_threshold != -1:
        raise ValueError("the 360 renders take the automatic geo_threshold (-1)")
    require_device(device, "render")
    mesh = cli.render_mesh(opt, device)
    if cli.is_main():
        config_module.print_opt(opt)
    if known.mode == "canonical_360":
        return main_canonical_360(opt, device, mesh)
    return main_posed_360(opt, device, mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
