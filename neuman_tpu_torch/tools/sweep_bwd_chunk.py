"""Time nerf_mlp_bwd over tape chunk sizes, on the GPU.

    python -m neuman_tpu_torch.tools.sweep_bwd_chunk [--chunks 4096,8192,16384,32768,65536]
                                                     [--rays 4096] [--samples 256] [--seed 0]

The backward writes its tape one chunk of whole rays at a time
(`CHUNK_SAMPLES` in ops/kernels/nerf_mlp_vjp.py). A chunk whose tape fits
in the 50 MB L2 lets the dW pass read it back from L2 rather than HBM; a
larger one gives each dW launch more samples to split over the card. This
times both dtypes at each size on the background net (8x256, per-ray
posenc, random weights from --seed): prints the card, then one line per
dtype and chunk with the tape bytes of a chunk and the mean ms of 5 calls
after 2 warm-ups (CUDA events).
"""

import argparse
import subprocess

import torch

from neuman_tpu_torch.models import nerf
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
from neuman_tpu_torch.options.config import NeuManConfig


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunks", default="4096,8192,16384,32768,65536")
    parser.add_argument("--rays", type=int, default=4096)
    parser.add_argument("--samples", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_bwd_chunk: no CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    spec = nerf.build_nerf_specs(NeuManConfig())
    gen = torch.Generator().manual_seed(args.seed)
    net = nerf.NeRF(spec.nerf, device=device).reset_parameters(gen).requires_grad_(False)
    r, s = args.rays, args.samples
    planes = [(torch.rand(r, s, generator=gen) * 3 - 1.5).to(device) for _ in range(3)]
    cot = [torch.randn(r, s, generator=gen).to(device) for _ in range(4)]
    dirs = torch.randn(r, 3, generator=gen)
    dirs = (dirs / dirs.norm(dim=1, keepdim=True)).to(device)
    cols = kvjp._lib().nerf_mlp_bwd_tape_cols(spec.nerf.depth, spec.nerf.width, 0)
    default = kvjp.CHUNK_SAMPLES
    try:
        for dtype in (torch.float32, torch.bfloat16):
            dir_part = kmlp.dir_projection(spec, net, dirs, dtype)
            run = lambda: kvjp.nerf_mlp_bwd(spec, net, *planes, cot[0], cot[1:],
                                            dir_part=dir_part, compute_dtype=dtype)
            for chunk in (int(c) for c in args.chunks.split(",")):
                kvjp.CHUNK_SAMPLES = chunk
                for _ in range(2):
                    run()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    run()
                end.record()
                torch.cuda.synchronize()
                tape_mb = max(1, min(r, chunk // s)) * s * cols * (2 if dtype == torch.bfloat16 else 4)
                print(f"dtype={str(dtype).split('.')[1]} R={r} S={s} chunk_samples={chunk} "
                      f"tape_mb={tape_mb / 1e6:.1f} ms={start.elapsed_time(end) / 5:.3f}", flush=True)
    finally:
        kvjp.CHUNK_SAMPLES = default


if __name__ == "__main__":
    main()
