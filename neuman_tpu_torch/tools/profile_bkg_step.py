"""Where the device time of a train step goes, on the GPU.

    python -m neuman_tpu_torch.tools.profile_bkg_step [--stage bkg] [--dtype float32]
                                                      [--mlp_tape recompute] [--steps 3]
                                                      [--seed 0]

--stage bkg builds a NeRFTrainer at the bkg defaults (4096 rays, 128 + 128
samples, the 8x256 nets from --seed); --stage human a HumanNeRFTrainer at
the smpl_and_offset defaults (1536 rays, 128 samples, all seven losses,
LPIPS weights from --seed, geo_threshold 0.25) on the body-proxy SMPL model
(V=10,242), with the canonical net's density bias at 0.5 so that the net is
alive. Both train on the synthetic 4-view 270x480 scene of
`datasets.arrays` (views 0-2 train, 3 validates). --mlp_tape hbm runs the
fused MLPs' backward from the forward-written tape. Two warm-up `train_step`s,
each drawing its batch, then --steps steps traced with torch.profiler.
Prints the card, the wall time per step, the device time per kernel
(largest first, with its share and its calls per step) and the share of the
wall time the device was idle.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from neuman_tpu_torch.datasets import arrays as darrays
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import lpips as lpips_module
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.models import smpl
from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults
from neuman_tpu_torch.train import init_bkg_params
from neuman_tpu_torch.trainers.background import NeRFTrainer
from neuman_tpu_torch.trainers.human import HumanNeRFTrainer
from neuman_tpu_torch.utils import card


def bkg_trainer(args, out_dir, device):
    cfg = apply_mode_defaults(NeuManConfig(), "bkg")
    cfg.compute_dtype, cfg.seed, cfg.out_dir = args.dtype, args.seed, out_dir
    cfg.mlp_tape = args.mlp_tape
    spec = nerf_module.build_nerf_specs(cfg)
    scene = darrays.ArraysScene(darrays.synthetic_arrays(4, 270, 480, seed=args.seed, device="cpu"))
    return NeRFTrainer(cfg.finalize(), spec, init_bkg_params(spec, args.seed, device), scene,
                       [0, 1, 2], [3], device=device)


def human_trainer(args, out_dir, device):
    cfg = apply_mode_defaults(NeuManConfig(), "smpl_and_offset")
    cfg.compute_dtype, cfg.seed, cfg.out_dir, cfg.geo_threshold = args.dtype, args.seed, out_dir, 0.25
    cfg.mlp_tape = args.mlp_tape
    body = smpl.body_proxy_smpl_model(subdivisions=5, device=device)
    scene = darrays.synthetic_human_scene(body, seed=args.seed, device="cpu")
    model = hn.HumanNeRF(
        hn.build_human_nerf_spec(cfg), device=device,
        generator=torch.Generator().manual_seed(args.seed),
        poses=np.stack([s["pose"] for s in scene.smpls]),
        betas=np.stack([s["betas"] for s in scene.smpls]), alignments=scene.alignments)
    with torch.no_grad():
        model.coarse_human_net.nerf.alpha_linear.bias.fill_(0.5)
    return HumanNeRFTrainer(cfg.finalize(), model, scene, [0, 1, 2], [3], body,
                            lpips_params=lpips_module.init_lpips_params(args.seed, device),
                            device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stage", default="bkg", choices=("bkg", "human"))
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--mlp_tape", default="recompute", choices=("recompute", "hbm"))
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bkg_step: no CUDA device")
    device = torch.device("cuda", 0)
    print(card.smi_line())
    with tempfile.TemporaryDirectory() as out_dir:
        build = bkg_trainer if args.stage == "bkg" else human_trainer
        trainer = build(args, out_dir, device)
        profile(trainer, trainer.opt, args)


def profile(trainer, cfg, args):
    for _ in range(2):
        trainer.train_step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / args.steps
    print(f"stage={args.stage} dtype={args.dtype} mlp_tape={cfg.mlp_tape} rays={cfg.rays_per_batch} S={cfg.samples_per_ray} "
          f"I={cfg.importance_samples_per_ray} wall_ms_per_step={wall_ms:.3f} "
          f"device_ms_per_step={device_ms:.3f} idle_share={1 - device_ms / wall_ms:.4f} "
          f"kernels={len(kernels)}")
    if not kernels:
        raise SystemExit("profile_bkg_step: the trace holds no device time")
    for e in kernels[:args.top]:
        ms = e.device_time_total / 1e3 / args.steps
        print(f"{ms:10.3f} ms {ms / device_ms:7.2%} {e.count / args.steps:8.1f}/step  {e.key[:100]}")
    rest = sum(e.device_time_total for e in kernels[args.top:]) / 1e3 / args.steps
    print(f"{rest:10.3f} ms {rest / device_ms:7.2%}  the other {len(kernels) - args.top} kernels")


if __name__ == "__main__":
    main()
