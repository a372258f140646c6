"""Training entry points of the port (counterpart of train.py).

    from neuman_tpu_torch.train import train_background, train_human
    trainer = train_background(opt, scene, train_views, val_views)
    trainer = train_human(opt, scene, train_views, val_views, body_model)

`train_background` trains the background NeRF (stage 1, `--train_mode=bkg`)
and `train_human` the human NeRF (stage 2, `--train_mode=smpl_and_offset`
or `smpl_only`) on a scene already in memory: the scene-directory reader
is not ported yet, so the command line waits for it. Both run on the card
unless the caller passes device="cpu".
"""

import os

import numpy as np
import torch

from neuman_tpu_torch import convert
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import lpips as lpips_module
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.trainers import checkpoint as ckpt
from neuman_tpu_torch.trainers.background import NeRFTrainer
from neuman_tpu_torch.trainers.human import HumanNeRFTrainer


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


def load_background(model, path):
    """The coarse and fine nets of a background-stage `checkpoint.npz` (of
    either package) into `model`'s background joiners."""
    data = ckpt.load_checkpoint(path)
    for net, key in ((model.coarse_bkg_net, "coarse_model"), (model.fine_bkg_net, "fine_model")):
        merged, missing = ckpt.safe_merge_params(convert.to_jax_params(net.state_dict()),
                                                 data[key])
        net.load_state_dict(convert.joiner_state_dict(merged))
        if missing:
            print(f"partial background load; missing: {missing}")


def train_human(opt, scene, train_views, val_views, body_model, interval_comp=1.0,
                lpips_params=None, device="cuda"):
    """Stage 2 on `scene` (duck-typed as the JAX package's Scene; see
    HumanNeRFTrainer, plus `smpls` [{"pose", "betas"}] and `alignments`
    [N, 4, 4], the initial per-frame SMPL state) with the SMPL-like
    `body_model` on `device`, for `opt.max_iter` steps with a validation and
    a checkpoint every `opt.valid_iter`. A background trained by stage 1 is
    loaded from `opt.out_dir/opt.load_background`. With the LPIPS loss on and
    no `lpips_params`, LPIPS runs on weights drawn from `opt.seed` (the
    calibrated ones are not shipped). `interval_comp` is the scene's
    geo_threshold over its canonical bone length. Returns the trainer."""
    if opt.train_mode == "smpl_only" and opt.offset_scale != 0:
        raise ValueError("train_mode smpl_only needs offset_scale 0")
    spec = hn.build_human_nerf_spec(opt)
    model = hn.HumanNeRF(
        spec, device=device, generator=torch.Generator().manual_seed(opt.seed),
        poses=np.stack([s["pose"] for s in scene.smpls]),
        betas=np.stack([s["betas"] for s in scene.smpls]), alignments=scene.alignments)
    if opt.load_background:
        path = os.path.join(opt.out_dir, opt.load_background, "checkpoint.npz")
        load_background(model, path)
        print(f"pretrained background model loaded from {path}")
    if opt.penalize_lpips > 0 and lpips_params is None:
        print("LPIPS weights drawn from the seed: a perceptual distance, not the calibrated one")
        lpips_params = lpips_module.init_lpips_params(opt.seed, device)
    trainer = HumanNeRFTrainer(opt, model, scene, train_views, val_views, body_model,
                               interval_comp=interval_comp, lpips_params=lpips_params,
                               device=device)
    trainer.train()
    return trainer
