"""The readings that `correct`'s limits are set from, on the chip at a cell's
own size: for each seed, the numbers of the program against the reference
(the lower readings) and of the control against the reference (the upper
ones), in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--seconds 3]
                                 [--fault none|half_batch] [--all-frames]

The control is the reference put in the program's place, computed in the
precision just below the one the configuration states: TF32 for the train
cells' float32, float8 e4m3 for the renders' bfloat16. `--fault
half_batch` (train cells) plants a fault in the program instead: each step
trains on half of its batch (the LPIPS patch kept), the mean taken over
the rest. `--all-frames` (render cells) renders every camera of the path
once in place of a window, checks them all, and adds each frame's readings
to the line. The benchmark's own runs never run this; one JSON line a seed.
"""

import argparse
import json
import sys
import time

import torch

from benchmark import cells, run as brun
from benchmark.reference import Precision

CONTROL = {"step": "tf32", "frame": "fp8"}
PATCH_ROWS = 32 * 32


def half_batch(runner):
    """Plant the fault: the runner's steps see half of each batch."""
    step = runner._step

    def halved(batch):
        n = batch["origin"].shape[0]
        patch = "patch_counter" in batch and runner.c["penalize_lpips"] > 0
        keep = PATCH_ROWS + (n - PATCH_ROWS) // 2 if patch else n // 2
        return step({k: v[:keep] if torch.is_tensor(v) and v.dim() and v.shape[0] == n else v
                     for k, v in batch.items()})

    runner._step = halved


def alter_batch(runner):
    """Plant the fault: the batch draw gives ray 0 the inverse colour."""
    draw = runner._draw

    def altered():
        batch = dict(draw())
        batch["color"] = batch["color"].clone()
        batch["color"][0] = 1.0 - batch["color"][0]
        return batch

    runner._draw = altered


FAULTS = {"half_batch": half_batch, "alter_batch": alter_batch}


def readings(cell, cfg, traffic, seed, seconds, fault, device="cuda", all_frames=False):
    """(program's numbers, control's numbers); with `all_frames`, also each
    frame's {number: [program's], "control": {number: [control's]},
    "unsettled": rays left out}."""
    kind = cells.KINDS[traffic["kind"]]
    if fault != "none":
        # the fault has to be in place before the set-up's first steps
        class Faulty(kind):
            def _record_first_steps(self):
                FAULTS[fault](self)
                super()._record_first_steps()
        kind = Faulty
    runner = kind(cfg, traffic, seed, torch.device(device))
    if runner.unit_name == "frame" and all_frames:
        runner.traffic = dict(runner.traffic, check_frames=len(runner.cams))
        for _ in runner.cams:
            runner.unit()
        runner.finish_window()
    elif runner.unit_name == "frame":
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            runner.unit()
        runner.finish_window()
    prog, ctrl = runner.check(Precision(CONTROL[runner.unit_name]))
    frames = None
    if all_frames:
        gaps, cgaps = runner.frame_gaps
        frames = dict(gaps, control=cgaps, unsettled=runner.unsettled)
    del runner
    torch.cuda.empty_cache()
    return (prog, ctrl, frames) if all_frames else (prog, ctrl)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default="none", choices=("none", "half_batch", "alter_batch"))
    p.add_argument("--all-frames", action="store_true")
    args = p.parse_args(argv)
    brun.caches()
    cell, cfg, traffic = brun.find_cell(brun.load_manifest(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell, cfg, traffic, seed, args.seconds, args.fault, all_frames=args.all_frames)
        line = {"cell": args.workload, "seed": seed, "fault": args.fault, "program": got[0], "control": got[1]}
        if args.all_frames:
            line["frames"] = got[2]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
