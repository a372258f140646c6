"""Stage-1 training losses in float32 and in bfloat16, side by side.

For each seed, the benchmark's `bkg-train-bf16` cell is built twice, once
with its configuration's compute dtype set to float32 and once as it is
(bfloat16): the same weights, video and set-up steps from the seed, and the
same batch draws (the draw reads only the step's generator). Each then
trains `--steps` steps, and the mean total loss of each `--every` steps is
reported beside the other dtype's. The two float32 seeds' difference is the
yardstick: how far two scenes' curves lie apart.

    python3 tools/bkg_dtype_loss.py --seeds 2727001,2727002 --steps 1000 \
        [--every 100] [--out curves.json]

Needs a CUDA card. Prints one JSON line a seed and dtype, then a summary.
"""

import argparse
import copy
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import cells, run as brun  # noqa: E402

CELL = "bkg-train-bf16"


def curve(cfg, traffic, seed, steps, every, device):
    """(mean total loss of each `every` steps, seconds a step, dead-net
    restarts)."""
    runner = cells.TrainBkg(cfg, traffic, seed, device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        runner.unit()
    sync()
    losses = torch.stack(runner.window_losses).double().cpu()
    step_s = (time.perf_counter() - t0) / steps
    restarts = runner.restarts
    runner.release()
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    means = [float(losses[i:i + every].mean()) for i in range(0, steps, every)]
    return means, step_s, restarts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--every", type=int, default=100)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    brun.caches()
    torch.set_num_threads(1)
    device = torch.device("cuda")
    _, cfg, traffic = brun.find_cell(brun.load_manifest(), CELL)
    out = {"device": torch.cuda.get_device_name(device), "steps": args.steps, "every": args.every,
           "curves": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        for dtype in ("float32", "bfloat16"):
            c = copy.deepcopy(cfg)
            c["config"]["compute_dtype"] = dtype
            means, step_s, restarts = curve(c, traffic, seed, args.steps, args.every, device)
            out["curves"][f"{seed}.{dtype}"] = means
            print(json.dumps({"seed": seed, "dtype": dtype, "means": means, "step_ms": 1e3 * step_s,
                              "restarts": restarts}), flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    cv = out["curves"]
    out["bf16_minus_f32"] = {s: [b - a for a, b in zip(cv[f"{s}.float32"], cv[f"{s}.bfloat16"])]
                             for s in seeds}
    if len(seeds) >= 2:
        a, b = seeds[:2]
        out["f32_seed_gap"] = [abs(x - y) for x, y in zip(cv[f"{a}.float32"], cv[f"{b}.float32"])]
    print(json.dumps({k: v for k, v in out.items() if k != "curves"}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
