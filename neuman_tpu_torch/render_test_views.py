"""Render the held-out test views and score them (counterpart of
render_test_views.py).

    python -m neuman_tpu_torch.render_test_views --scene_dir <dir> \
        --weights_path <out>/<human>/checkpoint.npz [--render_h H --render_w W]

Every view of the scene's test split (split files written anew, as the
train command line writes them) is rendered with the hybrid renderer (the
`nerf_mlp` and `ericson_select` kernels), written as
./demo/test_views/<scene>/out_%04d.png relative to the working directory,
read back from the PNG and scored against the capture's image: mean PSNR,
SSIM and LPIPS (utils/metrics.py; LPIPS with the weights of
`--lpips_weights` or <repo>/data/lpips_alex.npz, None without). Every
other flag is train.py's (options/config.py), with geo_threshold taken
from the scene's bones. `main(argv, device)` runs on the card unless
device="cpu", prints the scores and returns them.

    torchrun --nproc_per_node N -m neuman_tpu_torch.render_test_views ...

splits each chunk's rays over N GPUs (render/cli.py); rank 0 alone writes
the PNGs and scores them, and every rank's main returns its scores.
"""

import os
import sys

from neuman_tpu_torch.data_io import neuman
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.ops.mesh import MeshTopology
from neuman_tpu_torch.render import cli, renderer
from neuman_tpu_torch.train import auto_geo_threshold, load_lpips_params, require_device
from neuman_tpu_torch.utils import png
from neuman_tpu_torch.utils.metrics import eval_metrics


def run(opt, device="cuda", mesh=None):
    """Render, write, read back and score the test views of
    `opt.scene_dir`, each frame's rays split over `mesh`; rank 0 writes
    and scores. Returns {"ssim", "psnr", "lpips"} on every rank."""
    _, _, test_split = neuman.create_split_files(opt.scene_dir)
    test_views = neuman.read_text(test_split)
    scene = cli.read_scene(opt, smpl_type="optimized")
    geo_threshold, _ = auto_geo_threshold(scene)
    spec = hn.build_human_nerf_spec(opt)
    model = cli.load_net(opt, spec, device)
    topology = MeshTopology.build(scene.faces, len(scene.verts[0]), device)

    preds, gts = [], []
    for view_name in test_views:
        cap = scene[view_name]
        i = cap.frame_id["frame_id"]
        rgb = renderer.render_hybrid_nerf(
            spec, model, cap, scene.verts[i], scene.faces, scene.Ts[i], device,
            importance_samples_per_ray=opt.importance_samples_per_ray,
            geo_threshold=geo_threshold, topology=topology, **cli.render_kwargs(opt, mesh))[0]
        path = cli.save_frame(rgb, f"test_views/{os.path.basename(opt.scene_dir)}", i)
        if cli.is_main():  # scored as written: the uint8 frame read back from its PNG
            preds.append(png.read_png(path))
            gts.append(cap.image)

    results = None
    if cli.is_main():
        results = eval_metrics(gts, preds, lpips_params=load_lpips_params(opt, device))
        print(results)
    if mesh is not None:
        results = mesh.broadcast_object(results)
    return results


def main(argv=None, device="cuda"):
    """The command line: train.py's flags. Returns the scores."""
    opt = cli.options(argv)
    if opt.geo_threshold != -1:
        raise ValueError("the test views take the automatic geo_threshold (-1)")
    require_device(device, "render")
    return run(opt, device, cli.render_mesh(opt, device))


if __name__ == "__main__":
    main(sys.argv[1:])
