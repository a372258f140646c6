"""Training entry points of the port (counterpart of train.py): the
two-stage command line, and the stages on a scene already in memory.

    python -m neuman_tpu_torch.train --train_mode bkg --scene_dir <dir> --name bkg
    python -m neuman_tpu_torch.train --train_mode smpl_and_offset --scene_dir <dir> \
        --name human --load_background bkg

The command line takes every flag of the JAX package's train.py (see
options/config.py), with the same mode-dependent defaults, writes
<out_dir>/<name>/params.json, reads the scene directory
(data_io/neuman.py) and trains stage 1 (`--train_mode bkg`, the
background NeRF) or stage 2 (`smpl_only` / `smpl_and_offset`, the human
NeRF, on the background of `--load_background`). `main(argv, device)`
runs on the card unless device="cpu". On N GPUs, data parallel:

    torchrun --nproc_per_node N -m neuman_tpu_torch.train --train_mode bkg ...

(parallel/mesh.py: every rank trains on its share of each batch, rank 0
writes the outputs). The NeRF-T ablation: `--train_mode bkg
--ablate_nerft true --raw_pos_dim 4`.

    from neuman_tpu_torch.train import train_background, train_human
    trainer = train_background(opt, scene, train_views, val_views)
    trainer = train_human(opt, scene, train_views, val_views, body_model)

train the stages on a scene in memory (duck-typed as data_io's; see
datasets/arrays.py); both run on the card unless the caller passes
device="cpu".
"""

import os
import sys

import numpy as np
import torch

from neuman_tpu_torch import convert
from neuman_tpu_torch.data_io import neuman
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import lpips as lpips_module
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.ops.kernels.nerf_mlp import nerf_mlp_plain
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn
from neuman_tpu_torch.options import config as config_module
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.trainers import checkpoint as ckpt
from neuman_tpu_torch.trainers.background import NeRFTrainer
from neuman_tpu_torch.trainers.human import KERNELS, PLAIN, HumanNeRFTrainer
from neuman_tpu_torch.utils.misc import add_border_mask

# LPIPS weights the command line looks for when --lpips_weights is not given
DEFAULT_LPIPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "data", "lpips_alex.npz")


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
    validation and a checkpoint every `opt.valid_iter`. `opt.use_pallas`
    False runs autograd of the plain MLP in place of the kernels. Returns
    the trainer."""
    spec = nerf_module.build_nerf_specs(opt)
    params = init_bkg_params(spec, opt.seed, device)
    mlp = nerf_mlp_plain if opt.use_pallas is False else nerf_mlp_fn
    trainer = NeRFTrainer(opt, spec, params, scene, train_views, val_views, device=device,
                          mlp=mlp)
    trainer.train()
    return trainer


def _load_joiners(path, pairs):
    """Joiners from a `checkpoint.npz` (of either package): pairs of
    (Joiner, key path into the checkpoint's tree)."""
    data = ckpt.load_checkpoint(path)
    for net, keys in pairs:
        tree = data
        for k in keys:
            tree = tree[k]
        merged, missing = ckpt.safe_merge_params(convert.to_jax_params(net.state_dict()), tree)
        net.load_state_dict(convert.joiner_state_dict(merged))
        if missing:
            print(f"partial load of {'/'.join(keys)}; missing: {missing}")


def load_background(model, path):
    """The coarse and fine nets of a background-stage `checkpoint.npz` (of
    either package) into `model`'s background joiners."""
    _load_joiners(path, [(model.coarse_bkg_net, ("coarse_model",)),
                         (model.fine_bkg_net, ("fine_model",))])


def load_canonical(model, path):
    """The canonical human net of a human-stage `checkpoint.npz` (of either
    package) into `model`'s."""
    _load_joiners(path, [(model.coarse_human_net, ("hybrid_model", "coarse_human_net"))])


def train_human(opt, scene, train_views, val_views, body_model, interval_comp=1.0,
                lpips_params=None, device="cuda", draw_lpips=True):
    """Stage 2 on `scene` (duck-typed as the JAX package's Scene; see
    HumanNeRFTrainer, plus `smpls` [{"pose", "betas"}] and `alignments`
    [N, 4, 4], the initial per-frame SMPL state) with the SMPL-like
    `body_model` on `device`, for `opt.max_iter` steps with a validation and
    a checkpoint every `opt.valid_iter`. The background trained by stage 1
    is loaded from `opt.out_dir/opt.load_background`, a canonical human net
    from `opt.out_dir/opt.load_can`; as in the JAX command line, a load
    that fails is reported and the net trains from scratch. With the LPIPS
    loss on and no `lpips_params`, LPIPS runs on weights drawn from
    `opt.seed` (the calibrated ones are not shipped), or with draw_lpips
    False not at all. `interval_comp` is the scene's geo_threshold over its
    canonical bone length. `opt.use_pallas` False runs the plain ops
    (`PLAIN`). Returns the trainer."""
    if opt.train_mode == "smpl_only" and opt.offset_scale != 0:
        raise ValueError("train_mode smpl_only needs offset_scale 0")
    spec = hn.build_human_nerf_spec(opt)
    model = hn.HumanNeRF(
        spec, device=device, generator=torch.Generator().manual_seed(opt.seed),
        poses=np.stack([s["pose"] for s in scene.smpls]),
        betas=np.stack([s["betas"] for s in scene.smpls]), alignments=scene.alignments)
    for name, load, what in ((opt.load_background, load_background, "background"),
                             (opt.load_can, load_canonical, "canonical human")):
        if not name:
            continue
        path = os.path.join(opt.out_dir, name, "checkpoint.npz")
        try:
            load(model, path)
            print(f"pretrained {what} model loaded from {path}")
        except (OSError, KeyError, ValueError) as e:
            print(e)
            print("train from scratch")
    if opt.penalize_lpips > 0 and lpips_params is None and draw_lpips:
        print("LPIPS weights drawn from the seed: a perceptual distance, not the calibrated one")
        lpips_params = lpips_module.init_lpips_params(opt.seed, device)
    ops = PLAIN if opt.use_pallas is False else KERNELS
    trainer = HumanNeRFTrainer(opt, model, scene, train_views, val_views, body_model,
                               interval_comp=interval_comp, lpips_params=lpips_params,
                               device=device, ops=ops)
    trainer.train()
    return trainer


def auto_geo_threshold(scene):
    """(mean hip-to-pelvis bone length over the frames, posed; the same in
    the Da pose): joints 3 and 0 of `joints_3d` / `static_joints_3d`."""
    bones, can_bones = [], []
    for smpl in scene.smpls:
        bones.append(np.linalg.norm(smpl["joints_3d"][3] - smpl["joints_3d"][0]))
        can_bones.append(np.linalg.norm(smpl["static_joints_3d"][3]
                                        - smpl["static_joints_3d"][0]))
    return float(np.mean(bones)), float(np.mean(can_bones))


def load_lpips_params(opt, device="cuda"):
    """The LPIPS weights of `opt.lpips_weights`, else of <repo>/data/
    lpips_alex.npz, as tensors on `device`; None when neither is given and
    the default file is absent."""
    path = opt.lpips_weights or DEFAULT_LPIPS
    if os.path.isfile(path):
        return lpips_module.lpips_params_from_jax(ckpt.load_checkpoint(path), device)
    if opt.lpips_weights:
        raise FileNotFoundError(f"--lpips_weights {path} does not exist")
    return None


def read_scene_for(opt, human):
    """(scene, train views, val views) of `opt.scene_dir` for a stage, as
    the JAX command line reads it: the split files written anew; the
    background stage reads the scene with the reader's mask and SMPL
    defaults, the human stage with `opt.mask_dir` and `opt.smpl_type`."""
    train_split, val_split, _ = neuman.create_split_files(opt.scene_dir)
    kw = dict(mask_dir=opt.mask_dir, smpl_type=opt.smpl_type) if human else {}
    scene = neuman.NeuManReader.read_scene(
        opt.scene_dir, tgt_size=opt.tgt_size, normalize=opt.normalize,
        bkg_range_scale=opt.bkg_range_scale, human_range_scale=opt.human_range_scale, **kw)
    views = lambda split: [scene.fname_to_index_dict[f] for f in neuman.read_text(split)]
    return scene, views(train_split), views(val_split)


def scene_alignments(opt, scene):
    """[N, 4, 4] per-capture alignments: alignments.npy's [4, 3] as the
    first three columns of the identity."""
    raw = np.load(os.path.join(opt.scene_dir, "alignments.npy"), allow_pickle=True).item()
    alignments = np.stack([raw[os.path.basename(cap.image_path)] for cap in scene.captures])
    out = np.stack([np.eye(4)] * alignments.shape[0])
    out[..., :3] = alignments
    return out


def run_background(opt, device="cuda"):
    """Stage 1 of the command line on `opt.scene_dir`."""
    if opt.bkg_rays_ratio != 1:
        raise ValueError("the background stage samples background rays only (bkg_rays_ratio 1)")
    scene, train_views, val_views = read_scene_for(opt, human=False)
    scene.read_data_to_ram(data_list=["image", "depth"])
    add_border_mask(scene, iterations=opt.dilation)
    return train_background(opt, scene, train_views, val_views, device=device)


def run_human(opt, device="cuda"):
    """Stage 2 of the command line on `opt.scene_dir`: geo_threshold from
    the scene's bones when negative, interval_comp = geo_threshold / the
    canonical bone length, LPIPS weights from the file or the LPIPS loss
    off (its patch is still drawn, as in the JAX command line)."""
    if opt.bkg_lr != 0:
        raise ValueError("the background stays frozen in the human stage (bkg_lr 0)")
    scene, train_views, val_views = read_scene_for(opt, human=True)
    bone, can_bone = auto_geo_threshold(scene)
    if opt.geo_threshold < 0:
        opt.geo_threshold = bone
    scene.read_data_to_ram(data_list=["image"])
    add_border_mask(scene, iterations=opt.dilation)
    scene.alignments = scene_alignments(opt, scene)
    body_model = neuman.NeuManReader._body_model().to(device)
    lpips_params = load_lpips_params(opt, device) if opt.penalize_lpips > 0 else None
    if opt.penalize_lpips > 0 and lpips_params is None:
        print("warning: no LPIPS weights at data/lpips_alex.npz; lpips loss off")
    return train_human(opt, scene, train_views, val_views, body_model,
                       interval_comp=opt.geo_threshold / can_bone, lpips_params=lpips_params,
                       device=device, draw_lpips=False)


def require_device(device, what):
    """Raise when `device` is CUDA and there is no CUDA device: the command
    lines never carry on on the CPU unless asked to."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: pass device='cpu' to {what} on the CPU")


def main(argv=None, device="cuda"):
    """The command line: parse `argv`, write params.json, train the stage
    `--train_mode` names on `device`. Returns the trainer. Launched as one
    of several ranks (torchrun), it first joins their process group (NCCL
    on the card, gloo on the CPU), and rank 0 alone writes params.json."""
    opt = config_module.from_cli(argv)
    if opt.scene_dir is None:
        raise ValueError("--scene_dir is required")
    if opt.normalize is not True:
        raise ValueError("the trainers need a normalised scene (--normalize true)")
    require_device(device, "train")
    pmesh.maybe_init_distributed("nccl" if torch.device(device).type == "cuda" else "gloo")
    if not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0:
        config_module.print_opt(opt)
        opt.save()
    if opt.train_mode == "bkg":
        return run_background(opt, device)
    if opt.train_mode in ("smpl_only", "smpl_and_offset"):
        return run_human(opt, device)
    raise ValueError(opt.train_mode)


if __name__ == "__main__":
    main(sys.argv[1:])
