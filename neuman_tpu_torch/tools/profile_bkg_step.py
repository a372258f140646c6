"""Where the device time of a background train step goes, on the GPU.

    python -m neuman_tpu_torch.tools.profile_bkg_step [--dtype float32] [--steps 3] [--seed 0]

Builds a NeRFTrainer at the bkg defaults (4096 rays, 128 + 128 samples,
the 8x256 nets from --seed) on the synthetic 4-view 270x480 scene of
`datasets.arrays.synthetic_arrays` (views 0-2 train, 3 validates), runs
two warm-up `train_step`s, each drawing its batch, then traces
--steps steps with torch.profiler. Prints the card, the wall time per
step, the device time per kernel (largest first, with its share and its
calls per step) and the share of the wall time the device was idle.
"""

import argparse
import subprocess
import tempfile
import time

import torch

from neuman_tpu_torch.datasets import arrays as darrays
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults
from neuman_tpu_torch.train import init_bkg_params
from neuman_tpu_torch.trainers.background import NeRFTrainer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bkg_step: no CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")

    cfg = apply_mode_defaults(NeuManConfig(), "bkg")
    cfg.compute_dtype, cfg.seed = args.dtype, args.seed
    spec = nerf_module.build_nerf_specs(cfg)
    arrays = darrays.synthetic_arrays(4, 270, 480, seed=args.seed, device="cpu")
    scene = darrays.ArraysScene(arrays)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg.out_dir = out_dir
        trainer = NeRFTrainer(cfg.finalize(), spec, init_bkg_params(spec, args.seed, device),
                              scene, [0, 1, 2], [3], device=device)
        profile(trainer, cfg, args)


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
    print(f"dtype={args.dtype} rays={cfg.rays_per_batch} S={cfg.samples_per_ray} "
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
