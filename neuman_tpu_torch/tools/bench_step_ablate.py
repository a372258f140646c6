"""Marginal cost of each human-step loss family, on the full step (counterpart
of tools/bench_step_ablate.py).

    python -m neuman_tpu_torch.tools.bench_step_ablate [family ...] [--iters 10]
                                                      [--device cuda]

Families: full lpips shape sym color sparsity mask. Each family zeroes its
losses' weights (the families the reference schedules in
human_nerf_trainer.py:366-435) through the `overrides` of the bench's human
section (`bench.bench_human_train_step`), and prints its ms/step and the
marginal: full minus ablated, the backward and whatever else the family
costs included.

Each family runs in its own process (`--one <family>`): the caches a process
keeps of earlier configurations (the kernel plans, the caching allocator's
blocks) would move the later ones.
"""

import argparse
import os
import subprocess
import sys

import torch

from neuman_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ABLATIONS = {
    "full": {},
    "lpips": {"penalize_lpips": 0.0},
    "shape": {"penalize_smpl_alpha": 0.0, "penalize_dummy": 0.0},
    "sym": {"penalize_symmetric_alpha": 0.0},
    "color": {"penalize_color_range": 0.0},
    "sparsity": {"penalize_sharp_edge": 0.0, "penalize_hard_surface": 0.0},
    "mask": {"penalize_mask": 0.0},
}


def run_one(name, device="cuda", iters=10, **section):
    """ms/step of the human step with family `name` ablated (in this
    process), printed as "RESULT <name> <ms>". `section`: further keyword
    arguments of bench_human_train_step (its `overrides` are kept, the
    family's laid over them)."""
    overrides = {**section.pop("overrides", {}), **ABLATIONS[name]}
    ms = bench.bench_human_train_step(torch.device(device), iters, overrides=overrides, **section)
    print(f"RESULT {name} {ms:.3f}", flush=True)
    return ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("families", nargs="*", help="default: all, full first; of "
                        + ", ".join(ABLATIONS))
    parser.add_argument("--one", choices=tuple(ABLATIONS), help="run one family in this process")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if set(args.families) - set(ABLATIONS):
        parser.error(f"unknown family in {args.families}")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("bench_step_ablate: no CUDA device (--device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    if args.one:
        run_one(args.one, args.device, args.iters)
        return 0
    print(bench.card_line(torch.device(args.device)), flush=True)
    results, rc = {}, 0
    for name in args.families or list(ABLATIONS):
        proc = subprocess.run(
            [sys.executable, "-m", "neuman_tpu_torch.tools.bench_step_ablate", "--one", name,
             "--iters", str(args.iters), "--device", args.device],
            cwd=REPO, capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(f"{name}: FAILED\n{proc.stderr[-1500:]}", flush=True)
            rc = 1
            continue
        results[name] = float(line[-1].split()[-1])
        base = results.get("full")
        marginal = (f"  (marginal {base - results[name]:+.3f} ms)"
                    if base is not None and name != "full" else "")
        print(f"{name}: {results[name]:.3f} ms/step{marginal}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
