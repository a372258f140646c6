"""What the render command lines share (render_test_views, render_360,
render_reposing, render_gathering): their configuration, the render mesh,
the scene read at the render size, the HumanNeRF of a checkpoint, the
renderers' common arguments, and the frames written as
./demo/<what>/out_%04d.png relative to the working directory, as the JAX
package's scripts write them.

Launched as N ranks (`torchrun --nproc_per_node N -m
neuman_tpu_torch.render_test_views ...`), the command lines join one
process group and split each chunk's rays over the ranks; rank 0 alone
prints and writes."""

import os

import numpy as np
import torch
import torch.distributed as dist

from neuman_tpu_torch import convert
from neuman_tpu_torch.data_io import neuman
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.options import config as config_module
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.trainers import checkpoint as ckpt
from neuman_tpu_torch.utils import png

DEMO_DIR = "./demo"


def options(argv, **base):
    """The render command lines' config: every flag of options/config.py
    without the train modes' defaults, on a base with offset_scale 1, the
    automatic geo_threshold (-1) and the `base` fields."""
    cfg = config_module.NeuManConfig(offset_scale=1.0, geo_threshold=-1.0, **base)
    return config_module.from_cli(argv, mode_aware=False, base=cfg)


def render_mesh(opt, device):
    """The render mesh: launched as one of several ranks (torchrun), join
    their process group first (NCCL on the card, gloo on the CPU), then
    `resolve_render_mesh(opt)` (`--data_parallel auto|on|off`)."""
    pmesh.maybe_init_distributed("nccl" if torch.device(device).type == "cuda" else "gloo")
    return pmesh.resolve_render_mesh(opt)


def is_main():
    """True in the process that prints and writes: rank 0, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def read_scene(opt, **kw):
    """`opt.scene_dir` at the render size (`--render_h/--render_w`; native
    when not given)."""
    return neuman.NeuManReader.read_scene(
        opt.scene_dir, tgt_size=opt.render_size, normalize=opt.normalize,
        bkg_range_scale=opt.bkg_range_scale, human_range_scale=opt.human_range_scale, **kw)


def load_model(spec, path, device):
    """(HumanNeRF on `device` with the "hybrid_model" of the checkpoint at
    `path` (of either package) merged in, the paths the checkpoint did not
    give). What it does not give keeps weights drawn from seed 0."""
    model = hn.HumanNeRF(spec, device=device, generator=torch.Generator().manual_seed(0))
    missing = convert.load_hybrid(model, ckpt.load_checkpoint(path)["hybrid_model"])
    model.requires_grad_(False)
    return model, missing


def load_net(opt, spec, device):
    """The HumanNeRF of `opt.weights_path`; a partial load is reported."""
    model, missing = load_model(spec, opt.weights_path, device)
    if missing and is_main():
        print(f"partial weight load; missing: {missing[:8]}...")
    return model


def render_kwargs(opt, mesh=None):
    """The arguments every renderer takes from the command line: chunk,
    samples, the group-KNN stride; `--use_pallas false` renders through
    the plain versions of the kernels; the render mesh."""
    return dict(rays_per_batch=opt.rays_per_batch, samples_per_ray=opt.samples_per_ray,
                knn_stride=opt.knn_stride, use_kernels=opt.use_pallas is not False, mesh=mesh)


def save_frame(rgb, what, i):
    """Write the frame `rgb` [H, W, 3] as DEMO_DIR/<what>/out_%04d.png,
    quantised on the host as the JAX scripts quantise (clip to [0, 1],
    x 255, truncate to uint8); rank 0 alone writes. Returns the path."""
    path = os.path.join(DEMO_DIR, what, f"out_{str(i).zfill(4)}.png")
    if is_main():
        frame = (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        png.write_png(path, frame)
        print(f"image saved: {path}")
    return path
