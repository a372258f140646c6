"""Training entry points of the port (counterpart of train.py).

    from neuman_tpu_torch.train import train_background
    trainer = train_background(opt, scene, train_views, val_views)

`train_background` trains the background NeRF (stage 1, `--train_mode=bkg`)
on a scene already in memory: the scene-directory reader is not ported
yet, so the command line waits for it. It runs on the card unless the
caller passes device="cpu".
"""

import torch

from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.trainers.background import NeRFTrainer


def init_bkg_params(spec, seed, device):
    """Coarse and fine Joiners with torch.nn.Linear's init, drawn on the
    host from `seed`, so a seed gives the same nets on every device."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for k in ("coarse", "fine"):
        net = nerf_module.Joiner(spec, device=device)
        net.nerf.reset_parameters(gen)
        params[k] = net
    return params


def train_background(opt, scene, train_views, val_views, device="cuda"):
    """Stage 1 on `scene` (duck-typed as the JAX package's Scene: captures
    with images, masks, border masks, depth maps, cameras and near/far; see
    datasets.arrays.build_scene_arrays), for `opt.max_iter` steps with a
    validation and a checkpoint every `opt.valid_iter`. Returns the trainer."""
    spec = nerf_module.build_nerf_specs(opt)
    params = init_bkg_params(spec, opt.seed, device)
    trainer = NeRFTrainer(opt, spec, params, scene, train_views, val_views, device=device)
    trainer.train()
    return trainer
