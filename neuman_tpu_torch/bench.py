"""Benchmark of the port on one GPU (counterpart of the repo root's bench.py).

    python -m neuman_tpu_torch.bench [--rays 32768] [--samples 128] [--importance 128]
                                     [--iters 10] [--dtype bfloat16] [--train_iters 10]
                                     [--no-train] [--no-hybrid] [--no-kernels]
                                     [--break-stage STAGE] [--assert-floor X]
                                     [--device cuda]

Times the sections of bench.py, at its shapes, on random weights from seed 0
and the body proxy (V=10,242), and prints the card's name and power limit,
then ONE JSON line with bench.py's keys:
  {"metric": "ray_samples_per_sec_per_chip", "value": N, "unit": ...,
   "vs_baseline": N / 1e7, "protocol": "cuda_events" ("wall_clock" on the CPU),
   "human_train_step_ms": ..., "bkg_train_step_ms": ..., "hybrid_render_ms": ...,
   "hybrid_sec_per_frame": ..., "hybrid_frame_hit_frac": ..., "kernels": ...}

Sections (stage names of --break-stage in brackets):
- render: one chunk of --rays rays, --samples coarse + --importance fine
  samples, the 8x256 nets in --dtype; value = R (S + S + I) samples a call
  over its time;
- bkg_step: a background train step at the bkg defaults (4096 rays, 128 +
  128 samples, f32) on a 4-view 270x480 synthetic scene, batch draw included;
- human_step: a human train step at the smpl_and_offset defaults (1536 rays,
  128 samples, the seven losses with LPIPS on, random-init AlexNet), the
  body proxy's vertices over 4 views. A step's time depends on
  its batch draw (the backward of the warp's gathers by the closest faces'
  corners), so the mean moves with --train_iters; the draws are seeded, so
  a window gives the same mean run to run (tools/bench_step_windows.py
  times step by step);
- hybrid_render: one 4096-ray hybrid chunk, 64 + 32 background and 64 human
  samples, bf16;
- hybrid_frame: s per 1280x720 hybrid frame through render_hybrid_nerf
  (8192-ray chunks), and the share of its rays within geo_threshold of the
  body.
Both train steps take NEUMAN_MLP_TAPE (recompute or hbm) as `mlp_tape`.

Timing: one warm-up call (it builds the kernels), then `iters` calls back to
back between two CUDA events, each call's input varied (origins or vertices
+ i x 1e-5) and its output summed into a scalar that the next call's input
takes; host launch time is in. The frame is timed by the wall clock from
the first frame to the last, the card synchronised before each read.

No fallback: a stage that raises gets null keys and "failed:<stage>:<Error>"
in "kernels"; the other stages run, the line is printed and the exit code is
1. "kernels" is "compiled" when every stage ran on the card through the
kernels (each stage checks that its kernels were launched), "off" with
--no-kernels or --device cpu (the wrappers then run their plain versions).
An error outside the stages prints one line with "error" and exits 1, as
does a run without a CUDA device unless --device cpu is given.
"""

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

from neuman_tpu_torch.cameras.capture import ResizedPinholeCapture
from neuman_tpu_torch.cameras.pinhole import PinholeCamera
from neuman_tpu_torch.cameras.pose import CameraPose
from neuman_tpu_torch.datasets import sampler
from neuman_tpu_torch.datasets.arrays import synthetic_arrays
from neuman_tpu_torch.geometry.rotation import Rotation, Translation
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import lpips as lpips_module
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.models.smpl import body_proxy_smpl_model
from neuman_tpu_torch.ops import kernels
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.ops import volume
from neuman_tpu_torch.ops.kernels.nerf_mlp import nerf_mlp_plain
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn
from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults
from neuman_tpu_torch.render import renderer
from neuman_tpu_torch.train import init_bkg_params
from neuman_tpu_torch.trainers import human
from neuman_tpu_torch.trainers.background import (DTYPES, make_bkg_train_step, make_optimizer,
                                                   named_params)
from neuman_tpu_torch.trainers.human import make_human_train_step
from neuman_tpu_torch.utils import card

METRIC = "ray_samples_per_sec_per_chip"
BASELINE = 1e7
# how a time was taken: CUDA events on the card, the wall clock on the CPU
PROTOCOL = {"cuda": "cuda_events", "cpu": "wall_clock"}
# each stage's keys in the JSON line, in bench.py's order of the stages
STAGE_KEYS = {
    "render": ("value", "vs_baseline"),
    "human_step": ("human_train_step_ms",),
    "bkg_step": ("bkg_train_step_ms",),
    "hybrid_render": ("hybrid_render_ms",),
    "hybrid_frame": ("hybrid_sec_per_frame", "hybrid_frame_hit_frac"),
}
# the kernels each stage must launch on the card
STAGE_KERNELS = {
    "render": ("nerf_mlp",),
    "human_step": ("nerf_mlp", "nerf_mlp_bwd", "offset_mlp", "offset_mlp_bwd", "ericson_select",
                   "bucketed_knn"),
    "bkg_step": ("nerf_mlp", "nerf_mlp_bwd"),
    "hybrid_render": ("nerf_mlp", "ericson_select"),
    "hybrid_frame": ("nerf_mlp", "ericson_select"),
}


def _config(mode=None, overrides=None):
    """NeuManConfig (with `mode`'s defaults), then `overrides` {field: value}."""
    cfg = NeuManConfig() if mode is None else apply_mode_defaults(NeuManConfig(), mode)
    if mode is not None:
        cfg.mlp_tape = os.environ.get("NEUMAN_MLP_TAPE", cfg.mlp_tape)
    for k, v in (overrides or {}).items():
        if not hasattr(cfg, k):
            raise ValueError(f"NeuManConfig has no field {k!r}")
        setattr(cfg, k, v)
    return cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(device, fn):
    """(ms that fn() took, its result): CUDA events around it on the card,
    the wall clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        _sync(device)
        start.record()
        out = fn()
        end.record()
        _sync(device)
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def chained_ms(device, call, x0, iters):
    """ms per call of `iters` back-to-back calls of call(x) -> scalar
    tensor after one warm-up call: the i-th on x0 + (i + 1e-3) x 1e-5 plus
    0 x the sum of the earlier calls' scalars, so every input differs and
    waits for the call before. Raises if a scalar is not finite."""
    carry = call(x0)

    def calls():
        c = carry
        for i in range(iters):
            c = c + call(x0 + (i + 1e-3) * 1e-5 + c * 0.0)
        return c

    ms, carry = time_ms(device, calls)
    if not bool(torch.isfinite(carry)):
        raise FloatingPointError("a timed call's output is not finite")
    return ms / iters


def steps_ms(device, step, iters):
    """ms per step of `iters` back-to-back step() -> loss calls (a train
    step varies its own input: the state moves). Raises if a loss is not
    finite."""
    ms, losses = time_ms(device, lambda: torch.stack([step() for _ in range(iters)]))
    if not bool(torch.isfinite(losses).all()):
        raise FloatingPointError("a timed step's loss is not finite")
    return ms / iters


def bench_render(device, rays=32768, samples=128, importance=128, iters=10, dtype="bfloat16",
                 use_kernels=True, overrides=None):
    """Render chunk (bench.py:149-265): ray-samples/s of the background
    coarse -> importance -> fine pass on one chunk of `rays` rays
    (`render_inputs`); white background."""
    spec, coarse, fine, origins, dirs, near, far = render_inputs(device, rays, overrides)

    @torch.no_grad()
    def chunk(o):
        rgb, depth = render_chunk(spec, coarse, fine, o, dirs, near, far, samples, importance,
                                  DTYPES[dtype], use_kernels)
        return rgb.sum() + depth.sum()

    ms = chained_ms(device, chunk, origins, iters)
    return rays * (samples + samples + importance) / (ms / 1e3)


def render_inputs(device, rays=32768, overrides=None):
    """The render chunk's nets and rays: (spec, coarse net, fine net,
    origins, dirs, near, far); the reference nets (8x256, PE 10 + 4 bands)
    from seed 0, `rays` rays from (0, 0, -2) along N(0, 0.1) + (0, 0, 1),
    normalised; near 0.5, far 4.0."""
    spec = nerf_module.build_nerf_specs(_config(overrides=overrides))
    params = init_bkg_params(spec, 0, device)
    gen = torch.Generator().manual_seed(2)
    d = torch.randn(rays, 3, generator=gen) * 0.1 + torch.tensor([0.0, 0.0, 1.0])
    dirs = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(device)
    origins = torch.zeros(rays, 3, device=device)
    origins[:, 2] = -2.0
    near = torch.full((rays, 1), 0.5, device=device)
    far = torch.full((rays, 1), 4.0, device=device)
    return spec, params["coarse"].nerf, params["fine"].nerf, origins, dirs, near, far


def render_chunk(spec, coarse, fine, origins, dirs, near, far, samples, importance,
                 compute_dtype, use_kernels=True):
    """(rgb [R, 3], depth [R]) of the fine pass of one chunk, white
    background: bench.py's `render_chunk`."""
    f_z, f_sigma, f_rgb_c, dir_norm = renderer._bkg_branch(
        spec, coarse, fine, origins, dirs, near, far, samples, importance, True, compute_dtype,
        use_kernels, dir_chunk=(dirs, slice(None)))
    rgb, _, _, _, depth = volume.integrate_planar(f_sigma, f_rgb_c, f_z, dir_norm, True)
    return rgb, depth


def bench_bkg_train_step(device, iters=10, use_kernels=True, overrides=None, views=4,
                         hw=(270, 480)):
    """Background train step (bench.py:345-401), ms/step: the bkg defaults
    on synthetic_arrays(views, *hw, 64 vertices), every view trained; the
    batch draw is part of the step."""
    cfg = _config("bkg", overrides)
    spec = nerf_module.build_nerf_specs(cfg)
    arrays = synthetic_arrays(views, *hw, num_verts=64, device=device)
    optimizer = make_optimizer()
    params = init_bkg_params(spec, 0, device)
    state = {
        "params": params,
        "opt_state": optimizer.init(named_params(params)),
        "iteration": 0,
        "generator": torch.Generator(device).manual_seed(0),
        "init_generator": torch.Generator().manual_seed(1),
    }
    train_step = make_bkg_train_step(spec, cfg, optimizer,
                                     mlp=nerf_mlp_fn if use_kernels else nerf_mlp_plain)
    ids = torch.arange(views, device=device)

    def step():
        batch = sampler.sample_background_batch(state["generator"], arrays, ids,
                                                cfg.rays_per_batch,
                                                use_fused_depth=cfg.use_fused_depth)
        return train_step(state, batch)[1]["total_loss"]

    step()
    return steps_ms(device, step, iters)


def human_setup(device, use_kernels=True, overrides=None, views=4, hw=(270, 480),
                body_subdivisions=5):
    """What bench.py:431-476 builds for the human step: the smpl_and_offset
    defaults with geo_threshold 0.25 (then `overrides`), the body proxy,
    synthetic_arrays over `views` views with the proxy's template + 0.02 x
    their vertices, poses and betas 0.05 x normal draws of
    default_rng(0), identity alignments, the ctx of the JAX bench (LPIPS
    weights from seed 7) and the train step (the kernels, or with
    use_kernels=False the plain forwards and mesh queries). Returns a
    namespace: cfg, body, arrays, model, ctx, ids, step (the train step,
    its state in `state`)."""
    cfg = _config("smpl_and_offset", {"geo_threshold": 0.25, **(overrides or {})})
    body = body_proxy_smpl_model(subdivisions=body_subdivisions, device=device)
    arrays = synthetic_arrays(views, *hw, num_verts=body.num_verts, device=device)
    arrays.verts = body.v_template[None] + arrays.verts * 0.02
    rng = np.random.default_rng(0)
    model = hn.HumanNeRF(
        hn.build_human_nerf_spec(cfg), device=device,
        generator=torch.Generator().manual_seed(0),
        poses=rng.normal(size=(views, 72)).astype(np.float32) * 0.05,
        betas=rng.normal(size=(views, 10)).astype(np.float32) * 0.05,
        alignments=np.tile(np.eye(4, dtype=np.float32)[None], (views, 1, 1)))
    ctx = {
        "body_model": body,
        "da_smpl": hn.da_pose_params(24, device),
        "scale": 1.0,
        "topo": mesh_ops.MeshTopology.build(body.faces, body.num_verts, device),
        "can_verts": arrays.verts,
        "can_k": arrays.intrinsics[:2],
        "can_c2w": arrays.c2w[:2],
        "can_hw": tuple(hw),
        "interval_comp": 1.0,
        "lpips_params": lpips_module.init_lpips_params(7, device),
        "scene_ids": torch.arange(views, device=device),
        "grad_masks": torch.ones(views, 72, device=device),
        "knn_k": 4,
        "knn_stride": cfg.knn_stride,
    }
    optimizer = make_optimizer()
    state = {
        "opt_state": optimizer.init(human.trained_params(model)),
        "iteration": 0,
        "generator": torch.Generator(device).manual_seed(0),
        "init_generator": torch.Generator().manual_seed(1),
    }
    step = make_human_train_step(model, cfg, optimizer, ctx,
                                 ops=human.KERNELS if use_kernels else human.PLAIN)
    return types.SimpleNamespace(cfg=cfg, body=body, arrays=arrays, model=model, ctx=ctx,
                                 ids=torch.arange(views, device=device), step=step, state=state)


def human_step_fn(s, restarts):
    """step() -> total loss: one human train step on the setup `s`
    (`human_setup`), its batch draw included; appends 1.0 to `restarts`
    when the step restarted a dead canonical net, else 0.0."""
    cfg = s.cfg

    def step():
        batch = sampler.sample_human_batch(
            s.state["generator"], s.arrays, s.ids, cfg.geo_threshold, cfg.rays_per_batch,
            ratios=(cfg.body_rays_ratio, cfg.border_rays_ratio, cfg.bkg_rays_ratio),
            use_patch=cfg.penalize_lpips > 0, dilation=cfg.dilation)
        metrics = s.step(s.state, batch)[1]
        restarts.append(metrics["dead_restart"])
        return metrics["total_loss"]

    return step


def bench_human_train_step(device, iters=10, use_kernels=True, overrides=None, views=4,
                           hw=(270, 480), body_subdivisions=5):
    """Human train step (bench.py:404-513), ms/step, batch draw included."""
    s = human_setup(device, use_kernels, overrides, views, hw, body_subdivisions)
    restarts = []
    step = human_step_fn(s, restarts)
    step()
    ms = steps_ms(device, step, iters)
    print(f"human_step: {sum(restarts[1:]):g} of {iters} timed steps restarted a dead canonical "
          f"net", file=sys.stderr)
    return ms


def _hybrid_model(device, overrides):
    cfg = _config("smpl_and_offset", overrides)
    spec = hn.build_human_nerf_spec(cfg)
    model = hn.HumanNeRF(spec, device=device, generator=torch.Generator().manual_seed(0))
    return spec, model.requires_grad_(False)


def bench_hybrid_render(device, iters=10, rays=4096, samples=64, importance=32, use_kernels=True,
                        knn_k=4, knn_stride=4, overrides=None, body_subdivisions=5):
    """Hybrid chunk (bench.py:597-656), ms: `rays` rays from (0, 0, -2.5)
    along (0, 0, 1) + N(0, 0.25) in x and y, normalised; background near
    0.5, far 5.0; the human branch on every ray against the body proxy with
    identity transforms, geo_threshold 0.25; bf16, white background."""
    spec, model = _hybrid_model(device, overrides)
    body = body_proxy_smpl_model(subdivisions=body_subdivisions, device=device)
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, device)
    verts = body.v_template
    ts = torch.eye(4, device=device).repeat(body.num_verts, 1, 1)
    jitter = np.random.default_rng(3).normal(size=(rays, 3)) * np.array([0.25, 0.25, 0.0])
    d = torch.as_tensor(jitter + np.array([0.0, 0.0, 1.0]), dtype=torch.float32)
    dirs = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).to(device)
    origins = torch.zeros(rays, 3, device=device)
    origins[:, 2] = -2.5
    bkg_near = torch.full((rays, 1), 0.5, device=device)
    bkg_far = torch.full((rays, 1), 5.0, device=device)

    @torch.no_grad()
    def chunk(o):
        rgb, depth, _ = renderer._hybrid_chunk(
            spec, model, topo, o, dirs, bkg_near, bkg_far, verts, ts, 0.25, samples, importance,
            True, knn_k, torch.bfloat16, knn_stride, use_kernels)
        return rgb.sum() + depth.sum()

    return chained_ms(device, chunk, origins, iters)


def frame_capture(h=720, w=1280, focal=800.0):
    """bench.py's frame camera: f = `focal`, the principal point at the
    centre, w2c translation (0, 0, 3.5) and no rotation (the camera at
    (0, 0, -3.5) looking along +z at the body proxy); near/far 0.5/6.0 for
    the background, 1.0/5.0 for the human."""
    cam = PinholeCamera(w, h, focal, focal, w / 2, h / 2)
    pose = CameraPose(Translation(np.array([0, 0, 3.5], dtype=np.float32)),
                      Rotation(np.array([1.0, 0, 0, 0])))
    cap = ResizedPinholeCapture(cam, pose, (h, w))
    cap.near = {"bkg": 0.5, "human": 1.0}
    cap.far = {"bkg": 6.0, "human": 5.0}
    cap.frame_id = {"frame_id": 0, "total_frames": 1}
    return cap


@torch.no_grad()
def frame_hit_fraction(cap, verts, geo_threshold, rays_per_batch, device):
    """Share of the frame's rays that pass within geo_threshold of a vertex
    (the rays the human branch runs on), chunk by chunk."""
    origins, dirs = renderer.cap_rays(cap, device)
    verts = torch.as_tensor(verts, dtype=torch.float32, device=device)
    hits = 0
    for o, d in zip(origins.split(rays_per_batch), dirs.split(rays_per_batch)):
        near, far = ray_ops.geometry_guided_near_far(o, d, verts, geo_threshold)
        hits += int((near < far).sum())
    return hits / origins.shape[0]


def bench_hybrid_frame(device, h=720, w=1280, rays_per_batch=8192, samples=64, importance=32,
                       use_kernels=True, knn_stride=4, frames=3, focal=800.0, overrides=None,
                       body_subdivisions=5):
    """Hybrid frame (bench.py:516-594): (s per frame, hit fraction) through
    render_hybrid_nerf on `frame_capture`, the body proxy's vertices (+ i x
    1e-5 in frame i), its faces doubled as bench.py passes them, identity
    transforms, geo_threshold 0.25; one warm-up frame, then `frames` frames
    by the wall clock."""
    spec, model = _hybrid_model(device, overrides)
    body = body_proxy_smpl_model(subdivisions=body_subdivisions)
    verts = np.asarray(body.v_template, np.float32)
    faces = np.concatenate([body.faces, body.faces], axis=1)
    ts = np.tile(np.eye(4, dtype=np.float32)[None], (body.num_verts, 1, 1))
    # built once, as the JAX renderer caches it by the faces
    topo = mesh_ops.MeshTopology.build(faces, body.num_verts, device)
    cap = frame_capture(h, w, focal)

    def frame(i):
        rgb, _, _ = renderer.render_hybrid_nerf(
            spec, model, cap, verts + i * 1e-5, faces, ts, device, rays_per_batch=rays_per_batch,
            samples_per_ray=samples, importance_samples_per_ray=importance, geo_threshold=0.25,
            knn_stride=knn_stride, use_kernels=use_kernels, topology=topo)
        return rgb

    frame(0)
    hit_frac = frame_hit_fraction(cap, verts, 0.25, rays_per_batch, device)
    _sync(device)
    t0 = time.perf_counter()
    total = torch.zeros((), device=device)
    for i in range(1, frames + 1):
        total = total + frame(i).sum()
    _sync(device)
    sec = (time.perf_counter() - t0) / frames
    if not bool(torch.isfinite(total)):
        raise FloatingPointError("a timed frame is not finite")
    return sec, hit_frac


def card_line(device):
    """The card's name and power limit (nvidia-smi's line where it runs)."""
    if device.type != "cuda":
        return f"device: {device}"
    return f"device: {torch.cuda.get_device_name(device)} ({card.smi_line()})"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rays", type=int, default=32768)
    parser.add_argument("--samples", type=int, default=128)
    parser.add_argument("--importance", type=int, default=128)
    parser.add_argument("--iters", type=int, default=10,
                        help="timed calls of the render and hybrid chunks")
    parser.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES),
                        help="the render chunk's MLP products")
    parser.add_argument("--train_iters", type=int, default=10, help="timed steps of each stage")
    parser.add_argument("--no-train", dest="train", action="store_false", default=True,
                        help="skip both train steps")
    parser.add_argument("--no-hybrid", dest="hybrid", action="store_false", default=True,
                        help="skip the hybrid chunk and frame")
    parser.add_argument("--no-kernels", dest="kernels", action="store_false", default=True,
                        help="the kernels' plain PyTorch versions throughout (kernels: off)")
    parser.add_argument("--break-stage", choices=tuple(STAGE_KEYS), default=None,
                        help="fault injection: the named stage raises RuntimeError, proving "
                             "that its keys turn null and the exit code 1")
    parser.add_argument("--assert-floor", type=float, default=None,
                        help="exit 1 if vs_baseline is below this or a stage failed")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def _error_line(message, device_type="cuda"):
    return {"metric": METRIC, "value": None, "unit": "ray-samples/s", "vs_baseline": None,
            "protocol": PROTOCOL.get(device_type, PROTOCOL["cuda"]), "error": message[:400]}


def run(argv=None, sizes=None):
    """Run the bench; print the card line and the JSON line. `sizes`
    {stage: keyword arguments of its section} shrinks a section (the CPU
    tests). Returns (the JSON line's dict, exit code, {stage: {kernel:
    launches}})."""
    args = parse_args(argv)
    try:
        return _run(args, sizes or {})
    except Exception as e:  # noqa: BLE001 -- always one parseable line
        result = _error_line(f"unhandled:{type(e).__name__}: {e}", args.device.split(":")[0])
        print(json.dumps(result), flush=True)
        return result, 1, {}


def _run(args, sizes):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        result = _error_line("no CUDA device: the bench runs on the GPU (--device cpu for the "
                             "plain versions on the CPU)")
        print(json.dumps(result), flush=True)
        return result, 1, {}
    print(card_line(device), flush=True)
    on_card = device.type == "cuda" and args.kernels
    it, tit, kw = args.iters, args.train_iters, dict(use_kernels=args.kernels)
    size = lambda stage: {**kw, **sizes.get(stage, {})}
    stages = {"render": lambda: bench_render(device, args.rays, args.samples, args.importance, it,
                                             args.dtype, **size("render"))}
    if args.train:
        stages["human_step"] = lambda: bench_human_train_step(device, tit, **size("human_step"))
        stages["bkg_step"] = lambda: bench_bkg_train_step(device, tit, **size("bkg_step"))
    if args.hybrid:
        stages["hybrid_render"] = lambda: bench_hybrid_render(device, it,
                                                              **size("hybrid_render"))
        stages["hybrid_frame"] = lambda: bench_hybrid_frame(device, **size("hybrid_frame"))

    failures, values, launches = [], {}, {}
    for name, fn in stages.items():
        before = kernels.launches()
        try:
            if args.break_stage == name:
                raise RuntimeError(f"fault injection: --break-stage {name}")
            out = fn()
            launches[name] = {k: v for k, v in kernels.launches(before).items() if v}
            missing = [k for k in STAGE_KERNELS[name] if on_card and k not in launches[name]]
            if missing:
                raise RuntimeError(f"{name} launched no {', '.join(missing)} kernel")
            values[name] = out if isinstance(out, tuple) else (out,)
        except Exception as e:  # noqa: BLE001 -- a failed stage gives no number
            failures.append(f"{name}:{type(e).__name__}")
            print(f"STAGE FAILURE in {name}: {type(e).__name__}: {e}", file=sys.stderr)
            values[name] = (None,) * len(STAGE_KEYS[name])
        if device.type == "cuda":
            torch.cuda.empty_cache()

    value = values["render"][0]
    result = {"metric": METRIC, "value": value, "unit": "ray-samples/s",
              "vs_baseline": None if value is None else value / BASELINE,
              "protocol": PROTOCOL[device.type]}
    for name in stages:
        if name != "render":
            result.update(zip(STAGE_KEYS[name], values[name]))
    result["kernels"] = ("failed:" + ",".join(failures) if failures
                         else "compiled" if on_card else "off")
    print(json.dumps(result), flush=True)
    print(f"launches by stage: {json.dumps(launches, separators=(',', ':'))}", file=sys.stderr)
    rc = 1 if failures else 0
    if args.assert_floor is not None and (result["vs_baseline"] is None
                                          or result["vs_baseline"] < args.assert_floor
                                          or failures):
        print(f"PERF FLOOR VIOLATION: vs_baseline={result['vs_baseline']} < "
              f"{args.assert_floor} or kernels={result['kernels']!r}", file=sys.stderr)
        rc = 1
    return result, rc, launches


def main(argv=None):
    return run(argv)[1]


if __name__ == "__main__":
    sys.exit(main())
