"""A cell shrunk for the CPU: narrow nets, few samples, a 48x64 video of 6
frames. Widths are never cut in a cell; this is for tests only."""

import copy

from benchmark import run as brun


def tiny(cell, manifest=None, bench=brun.BENCH, lpips=True):
    """(manifest, cell, configuration, traffic) of `cell`, shrunk."""
    manifest = manifest or brun.load_manifest()
    c, cfg, traffic = brun.find_cell(manifest, cell, bench)
    cfg = copy.deepcopy(cfg)
    human = cfg["train_mode"] != "bkg"
    cfg["config"].update(nerf_width=32, samples_per_ray=16, importance_samples_per_ray=16,
                         rays_per_batch=(1056 if lpips else 64) if human else 64,
                         render_rays_per_batch=512, dilation=2)
    if not lpips:
        cfg["config"]["penalize_lpips"] = 0.0
    traffic.update(frames=6, test_every=3, test_offset=1, height=48, width=64, focal=60.0,
                   canonical_cameras=4, cameras=3, canonical_focal=50.0, check_rays=256, dilation=2)
    return manifest, c, cfg, traffic


def run(cell, seed=3, trace=0, seconds=0.3, **kw):
    """(result line, numbers) of one tiny run on the CPU."""
    manifest, c, cfg, traffic = tiny(cell, **kw)
    args = brun.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", str(trace), "--device", "cpu"])
    return brun.run(args, manifest, c, cfg, traffic, kw.get("bench", brun.BENCH))
