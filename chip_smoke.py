#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (neuman_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each; any failure ends the run with a non-zero exit:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc builds the three kernels from neuman_tpu_torch/csrc/ (sm_90a);
  3. nerf_mlp kernel vs its plain PyTorch version at full width (8x256,
     PE 10 + 4 bands), R=1024 x S=64: per-ray posenc and per-sample
     rotate, f32 and bf16;
  4. ericson_select kernel vs its plain version, N=65,536 ray samples on
     the body-proxy mesh (V=10,242), k=4, stride 1 and 4;
  5. the render slice at full width: one 4096-ray hybrid chunk in f32,
     kernels vs plain, then a 270x480 frame through render_hybrid_nerf at
     its default bf16 (the render path; launch counts reset just before it)
     against the plain bf16 frame;
  6. nerf_mlp_bwd and nerf_mlp kernels vs their plain versions at full
     width at the train step's shapes, R=4096 x S=128 and S=256 per-ray
     posenc, S=128 per-sample rotate, f32 and bf16; two backward kernel
     runs bit-identical;
  7. the background train slice at the bkg defaults (4096 rays, 128 + 128
     samples) on a 4-view 270x480 synthetic scene: a step's losses and
     gradients with the kernels vs the plain path on one batch, in f32 and
     in bf16; then train_background (the train path; launch counts reset
     just before it) and 20 timed steps in f32 and in bf16; a
     checkpoint.npz round trip.
Then one JSON line of per-kernel results, and last the device line.

Weights are random (HumanNeRF and background nets from --seed); the body
is the numpy body-proxy SMPL model posed by LBS. Imports nothing of JAX.
"""

import argparse
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# shapes of each phase
MLP_RAYS, MLP_SAMPLES = 1024, 64
MESH_RAYS, MESH_SAMPLES = 1024, 64  # N = 65,536 query points
BODY_SUBDIVISIONS = 5  # V = 10,242, F = 20,480
CHUNK_RAYS = 4096
FRAME_HW = (270, 480)
RENDER = dict(rays_per_batch=8192, samples_per_ray=64, importance_samples_per_ray=32,
              geo_threshold=0.2, knn_k=4, knn_stride=4)

# kernel vs plain tolerances (see the phase functions for the reasons)
MLP_F32_ATOL = 1e-3
MLP_BF16_REL = 5e-2
MESH_ATOL = 1e-6
CHUNK_ATOL = {"rgb": 2e-3, "depth": 2e-2, "acc": 2e-3}
FRAME_MIN_PSNR = 40.0

# phase 6: the train step's MLP shapes (coarse S=128, fine S=128+128)
BWD_RAYS = 4096
BWD_CASES = (("per_ray", 128), ("per_ray", 256), ("per_sample", 128))
# f32: max |kernel - plain| over max |plain|, each output; bf16: L2 error
# over L2 norm, each output (see phase_bwd for why)
BWD_F32_REL = 1e-3
BWD_BF16_L2 = 5e-2
# phase 7: the bench scene of bench.py (4 views, 270x480)
SLICE_VIEWS, SLICE_HW = 4, (270, 480)
SLICE_STEPS = 20
# loss rel error, each gradient's L2 error over its L2 norm
STEP_TOL = {"float32": (1e-4, 5e-3), "bfloat16": (5e-3, BWD_BF16_L2)}

# published peaks of one H100 SXM (dense), for the bound of each kernel
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# closest point on a triangle (Ericson, RTCD 5.1.5): ~60 f32 operations
# for one point and one candidate
ERICSON_OPS_PER_TEST = 60


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, dtype):
    """(least ms for the work, "operations" or "bytes"): the larger of the
    operations at the card's peak for `dtype` and the bytes at its HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mlp_macs_per_sample(spec, per_sample):
    """Multiply-adds of one forward application of the NeRF to one sample
    (the per-ray direction term is computed once per ray, outside)."""
    n, cp, cd = spec.nerf, spec.pos_pe.out_dim, spec.dir_pe.out_dim
    w = n.width
    trunk = sum((cp if i == 0 else cp + w if (i - 1) in n.skips else w) * w
                for i in range(n.depth))
    return trunk + w + w * w + (w + (cd if per_sample else 0)) * (w // 2) + (w // 2) * 3


def mlp_bound(spec, net, per_sample, r, s, dtype, backward):
    """Bound of the forward (each input read once: planes, direction,
    weights; outputs sigma, rgb) or of the recompute backward (+ the four
    cotangents in; d_planes, d_dir and every weight gradient out; 3x the
    forward's multiply-adds)."""
    n = r * s
    params = sum(p.numel() for p in net.parameters()) * 4
    dirs = 3 * n * 4 if per_sample else r * (spec.nerf.width // 2) * 4
    flops = 2 * mlp_macs_per_sample(spec, per_sample) * n * (3 if backward else 1)
    nbytes = 3 * n * 4 + dirs + params + 4 * n * 4
    if backward:
        nbytes += 3 * n * 4 + dirs + params
    return bound_ms(flops, nbytes, dtype)


def ericson_bound(n, c, stride):
    """p3 [3, N], rows9 [9C, N/stride], cand [C, N/stride] in; d2, face id,
    closest point [3, N] out."""
    groups = -(-n // stride)
    nbytes = 3 * n * 4 + 9 * c * groups * 4 + c * groups * 4 + 5 * n * 4
    return bound_ms(ERICSON_OPS_PER_TEST * c * n, nbytes, "f32")


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log("card", name=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())


def phase_build():
    """One nvcc per source, all started together."""
    from neuman_tpu_torch.ops.kernels import _build, meshquery, nerf_mlp, nerf_mlp_vjp

    t0 = time.perf_counter()
    libs = (nerf_mlp._lib, meshquery._lib, nerf_mlp_vjp._lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_library={k: round(v, 2) for k, v in _build.build_seconds.items()},
        dir=os.path.relpath(_build.BUILD_DIR, ROOT))


def _fwd_compare(spec, net, planes, kw, dtype):
    """nerf_mlp kernel vs its plain version on one input: (max abs error,
    output scale, kernel call, plain call)."""
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp

    run_k = lambda: kmlp.nerf_mlp(spec, net, *planes, compute_dtype=dtype, **kw)
    run_p = lambda: kmlp.nerf_mlp_plain(spec, net, *planes, compute_dtype=dtype, **kw)
    (ks, krgb), (ps, prgb) = run_k(), run_p()
    torch.cuda.synchronize()
    out_k = torch.stack([ks, *krgb])
    out_p = torch.stack([ps, *prgb])
    if not torch.isfinite(out_k).all():
        raise RuntimeError(f"nerf_mlp {dtype}: non-finite kernel output")
    return (out_k - out_p).abs().max().item(), out_p.abs().max().item(), run_k, run_p


def _fwd_ok(err, scale, name):
    """The tolerances of phase_mlp."""
    return err <= MLP_F32_ATOL if name == "f32" else err <= MLP_BF16_REL * scale


def _mlp_case(spec, net, mode, r, s, dtype, gen, device):
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp

    planes = [(torch.rand(r, s, generator=gen) * 3 - 1.5).to(device) for _ in range(3)]
    if mode == "per_sample":
        d = torch.randn(3, r, s, generator=gen)
        d = (d / d.norm(dim=0, keepdim=True)).to(device)
        kw = {"dir_planes": [d[0].contiguous(), d[1].contiguous(), d[2].contiguous()]}
    else:
        d = torch.randn(r, 3, generator=gen)
        kw = {"dir_part": kmlp.dir_projection(spec, net, (d / d.norm(dim=1, keepdim=True)).to(device),
                                              dtype)}
    err, scale, run_k, run_p = _fwd_compare(spec, net, planes, kw, dtype)
    return err, scale, cuda_ms(run_k), cuda_ms(run_p)


def phase_mlp(model, spec, device, seed):
    """f32: both sides take f32 products in another summation order (the
    kernel sums k in order, cuBLAS in tiles), so ~1e-5 on outputs of O(1);
    1e-3 bounds it. bf16: both round weights and activations to bf16 at the
    same points, but an activation within an ulp of a rounding boundary can
    round to neighbouring bf16 values on the two sides, which moves the
    output by up to a few bf16 ulps of the layer scale: 5e-2 of the output
    scale bounds it."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    results = {}
    for mode, jspec, net in (
        ("per_ray", spec.bkg, model.coarse_bkg_net.nerf),
        ("per_sample", spec.human, model.coarse_human_net.nerf),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            err, scale, k_ms, p_ms = _mlp_case(jspec, net, mode, MLP_RAYS, MLP_SAMPLES, dtype,
                                               gen, device)
            name = "f32" if dtype == torch.float32 else "bf16"
            ok = _fwd_ok(err, scale, name)
            b_ms, b_by = mlp_bound(jspec, net, mode == "per_sample", MLP_RAYS, MLP_SAMPLES, name,
                                   backward=False)
            log("mlp", mode=mode, pe=jspec.pos_pe.mapping, dtype=name, R=MLP_RAYS, S=MLP_SAMPLES,
                max_abs_err=f"{err:.3e}", out_scale=f"{scale:.3f}", kernel_ms=f"{k_ms:.3f}",
                plain_ms=f"{p_ms:.3f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by, ok=ok)
            if not ok:
                raise RuntimeError(f"nerf_mlp {mode} {name}: error {err} over tolerance")
            results[(mode, name)] = (err, k_ms, p_ms, b_ms, b_by)
    return results


def _ray_samples(verts, num_rays, s, gen, band=0.3):
    """Ray-ordered samples: each ray marches through a surface point from
    outside (groups of consecutive samples stay close, as in a render)."""
    import torch

    idx = torch.randint(0, verts.shape[0], (num_rays,), generator=gen).to(verts.device)
    target = verts[idx]
    d = torch.randn(num_rays, 3, generator=gen).to(verts.device)
    d = d / d.norm(dim=1, keepdim=True)
    t = torch.linspace(-band, band, s, device=verts.device)
    return (target[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)


def phase_mesh(verts, topo, seed):
    """Built with --fmad=false the kernel runs the same IEEE operations as
    the plain version, so d2 and cp agree to 1e-6 (expected: exactly); the
    face id may differ only where another face ties within 1e-6."""
    import torch
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.ops.kernels import meshquery as kmq

    gen = torch.Generator().manual_seed(seed + 1)
    pts = _ray_samples(verts, MESH_RAYS, MESH_SAMPLES, gen)
    results = {}
    for stride in (1, 4):
        ops = mesh_ops.candidate_operands(pts, verts, topo, k=4, knn_stride=stride)
        run_k = lambda: kmq.ericson_select(*ops)
        run_p = lambda: kmq.ericson_select_plain(*ops)
        (kd2, kf, kcp), (pd2, pf, pcp) = run_k(), run_p()
        torch.cuda.synchronize()
        err = max((kd2 - pd2).abs().max().item(),
                  max((a - b).abs().max().item() for a, b in zip(kcp, pcp)))
        diff = kf != pf
        ties_only = bool((kmq.tie_gap(*ops)[diff] <= MESH_ATOL).all())
        k_ms, p_ms = cuda_ms(run_k), cuda_ms(run_p)
        b_ms, b_by = ericson_bound(pts.shape[0], ops[2].shape[0], stride)
        ok = err <= MESH_ATOL and ties_only and bool(torch.isfinite(kd2).all())
        log("ericson", N=pts.shape[0], C=ops[2].shape[0], stride=stride,
            max_abs_err=f"{err:.3e}", f_id_diff=int(diff.sum()), kernel_ms=f"{k_ms:.3f}",
            plain_ms=f"{p_ms:.3f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by, ok=ok)
        if not ok:
            raise RuntimeError(f"ericson_select stride {stride}: kernel disagrees")
        results[stride] = (err, k_ms, p_ms, b_ms, b_by)
    return results


class Capture:
    """The duck-typed capture render_hybrid_nerf reads."""

    def __init__(self, h, w, focal, cam_to_world, near, far):
        class Pose:
            camera_to_world = cam_to_world

        self.shape = (h, w)
        self.intrinsic_matrix = [[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]]
        self.cam_pose = Pose()
        self.near, self.far = {"bkg": near}, {"bkg": far}


def phase_slice(model, spec, body, device, seed):
    """Hybrid chunk tolerances: the two MLP paths differ in the last bits
    (phase 3), which moves the inverse-CDF importance samples and the
    merged z order by as much, so pixels agree to ~1e-4; the bounds leave
    an order of magnitude."""
    import torch
    from neuman_tpu_torch.models import smpl
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.ops import rays as ray_ops
    from neuman_tpu_torch.ops.kernels import meshquery as kmq
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
    from neuman_tpu_torch.render import renderer

    gen = torch.Generator().manual_seed(seed + 2)
    pose = torch.zeros(1, 72)
    pose[0, 3:] = torch.randn(69, generator=gen) * 0.1
    verts, ts = smpl.da_pose_to_scene(body, pose.to(device), torch.zeros(1, 10, device=device))
    topo = mesh_ops.MeshTopology.build(body.faces, len(verts), device)
    # camera 3 units in front of the body, image y down = world -y
    c2w = [[1.0, 0, 0, 0], [0, -1.0, 0, 0], [0, 0, -1.0, 3.0], [0, 0, 0, 1.0]]
    h, w = FRAME_HW
    cap = Capture(h, w, 380.0 * w / 480, c2w, near=0.5, far=6.0)
    s, i, g = RENDER["samples_per_ray"], RENDER["importance_samples_per_ray"], RENDER["geo_threshold"]

    # one hybrid chunk of CHUNK_RAYS rays of the frame, hit rays first
    with torch.no_grad():
        origins, dirs = renderer.cap_rays(cap, device)
        near, far = ray_ops.geometry_guided_near_far(origins, dirs, verts, g)
        hit = near < far
        order = torch.argsort(hit.to(torch.int8), descending=True, stable=True)[:CHUNK_RAYS]
        n = order.numel()
        args = (spec, model, topo, origins[order], dirs[order],
                torch.full((n, 1), cap.near["bkg"], device=device),
                torch.full((n, 1), cap.far["bkg"], device=device),
                verts, ts, g, s, i, True, RENDER["knn_k"], torch.float32, RENDER["knn_stride"])
        k_out = renderer._hybrid_chunk(*args, use_kernels=True)
        p_out = renderer._hybrid_chunk(*args, use_kernels=False)
        torch.cuda.synchronize()
    errs = {k: (a - b).abs().max().item() for k, a, b in zip(("rgb", "depth", "acc"), k_out, p_out)}
    chunk_hits = int(hit[order].sum())
    ok = all(errs[k] <= CHUNK_ATOL[k] for k in errs) and all(torch.isfinite(x).all() for x in k_out)
    log("chunk", rays=n, hit_rays=chunk_hits, **{f"{k}_err": f"{v:.3e}" for k, v in errs.items()},
        ok=ok)
    if not ok or chunk_hits == 0:
        raise RuntimeError("hybrid chunk: kernel path disagrees with the plain path")

    # the main path: one frame with the kernels (warm-up frame first)
    render = lambda use: renderer.render_hybrid_nerf(
        spec, model, cap, verts, body.faces, ts, device, topology=topo, use_kernels=use, **RENDER)
    render(True)
    torch.cuda.synchronize()
    kmlp.nerf_mlp.launches = 0
    kmq.ericson_select.launches = 0
    t0 = time.perf_counter()
    rgb, depth, acc = render(True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"nerf_mlp": kmlp.nerf_mlp.launches, "ericson_select": kmq.ericson_select.launches}

    t0 = time.perf_counter()
    p_rgb, _, _ = render(False)
    torch.cuda.synchronize()
    plain_sec = time.perf_counter() - t0
    mse = torch.mean((rgb - p_rgb) ** 2).item()
    psnr = -10.0 * math.log10(max(mse, 1e-20))
    hit_frac = hit.float().mean().item()
    human_frac = (acc > 0.5).float().mean().item()
    ok = (tuple(rgb.shape) == (h, w, 3) and bool(torch.isfinite(rgb).all())
          and bool(torch.isfinite(depth).all()) and psnr >= FRAME_MIN_PSNR
          and all(v > 0 for v in launches.values()) and human_frac > 0)
    log("frame", H=h, W=w, dtype="bf16", sec_per_frame=f"{sec:.3f}",
        plain_sec_per_frame=f"{plain_sec:.3f}", hit_fraction=f"{hit_frac:.4f}",
        human_fraction=f"{human_frac:.4f}", psnr_vs_plain=f"{psnr:.2f}",
        launches=json.dumps(launches, separators=(",", ":")), ok=ok)
    if not ok:
        raise RuntimeError("frame: not finite, under the PSNR bar, or a kernel was not launched")
    return launches


def _flat_grads(out):
    grads, d_planes, d_dir = out
    return ([t for wb in grads for t in wb] + list(d_planes)
            + (list(d_dir) if isinstance(d_dir, list) else [d_dir]))


def phase_bwd(model, spec, device, seed):
    """f32: the kernel sums each dW over the samples in tiles and fixed
    partials, cuBLAS in its own order, over up to 1M samples: 1e-3 of each
    output's largest value bounds it. bf16: both sides round to bf16 at the
    same points, but a sum taken in another order can land on the other
    side of a bf16 rounding boundary; each such step may flip a ReLU mask
    further down, which moves one sample's whole term of a dW element, so
    the element-wise error has outliers and the bound is on the L2 error of
    each output. Every case runs the kernel twice: the gradients must be
    bit-identical. The forward kernel is held against its plain version on
    the same inputs too, at phase 3's tolerances: these are the shapes the
    train step gives it."""
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
    from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp

    gen = torch.Generator().manual_seed(seed + 3)
    results, failed = {}, []
    for mode, s in BWD_CASES:
        per_sample = mode == "per_sample"
        jspec, net = ((spec.human, model.coarse_human_net.nerf) if per_sample
                      else (spec.bkg, model.coarse_bkg_net.nerf))
        r = BWD_RAYS
        planes = [(torch.rand(r, s, generator=gen) * 3 - 1.5).to(device) for _ in range(3)]
        cot = [torch.randn(r, s, generator=gen).to(device) for _ in range(4)]
        if per_sample:
            d = torch.randn(3, r, s, generator=gen)
            d = (d / d.norm(dim=0, keepdim=True)).to(device)
        else:
            d = torch.randn(r, 3, generator=gen)
            d = (d / d.norm(dim=1, keepdim=True)).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            kw = ({"dir_planes": [x.contiguous() for x in d]} if per_sample
                  else {"dir_part": kmlp.dir_projection(jspec, net, d, dtype)})
            f_err, f_scale = _fwd_compare(jspec, net, planes, kw, dtype)[:2]
            f_ok = _fwd_ok(f_err, f_scale, name)
            args = (jspec, net, *planes, cot[0], cot[1:])
            run_k = lambda: kvjp.nerf_mlp_bwd(*args, compute_dtype=dtype, **kw)
            run_p = lambda: kvjp.nerf_mlp_bwd_plain(*args, compute_dtype=dtype, **kw)
            got, again = _flat_grads(run_k()), _flat_grads(run_k())
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            ref = _flat_grads(run_p())
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            err = max((a - c).abs().max().item() for a, c in zip(got, ref))
            rel = max((a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
                      for a, c in zip(got, ref))
            l2 = max(((a - c).norm() / c.norm().clamp_min(1e-30)).item() for a, c in zip(got, ref))
            scale = max(c.abs().max().item() for c in ref)
            del got, ref
            torch.cuda.empty_cache()
            k_ms, p_ms = cuda_ms(run_k, iters=3, warmup=1), cuda_ms(run_p, iters=3, warmup=1)
            b_ms, b_by = mlp_bound(jspec, net, per_sample, r, s, name, backward=True)
            ok = (identical and finite and f_ok
                  and (rel <= BWD_F32_REL if name == "f32" else l2 <= BWD_BF16_L2))
            log("mlp_bwd", mode=mode, pe=jspec.pos_pe.mapping, dtype=name, R=r, S=s,
                fwd_max_abs_err=f"{f_err:.3e}", fwd_out_scale=f"{f_scale:.3f}", fwd_ok=f_ok,
                max_abs_err=f"{err:.3e}", grad_scale=f"{scale:.3e}", max_rel_err=f"{rel:.3e}",
                l2_rel_err=f"{l2:.3e}", bit_identical=identical, kernel_ms=f"{k_ms:.3f}",
                plain_ms=f"{p_ms:.3f}", bound_ms=f"{b_ms:.3f}", bound_by=b_by, ok=ok)
            if not ok:
                failed.append(f"{mode} S={s} {name}")
            results[(mode, s, name)] = (err, k_ms, p_ms, b_ms, b_by)
    if failed:
        raise RuntimeError(f"nerf_mlp or nerf_mlp_bwd disagrees with its plain version, or "
                           f"nerf_mlp_bwd between runs: {failed}")
    return results


def _bkg_config(out_dir, seed, **fields):
    from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults

    cfg = apply_mode_defaults(NeuManConfig(), "bkg")
    cfg.out_dir, cfg.seed, cfg.max_iter, cfg.valid_iter = out_dir, seed, 2, 1000
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg.finalize()


def phase_train(device, seed):
    """f32: the plain step takes its sums in another order than the
    kernels: each weight gradient sums 1.5 M per-sample terms, and where
    the terms of a loss gradient cancel, the rounding of the sum is large
    next to what is left of it; the importance samples move in their last
    bits and a few ReLU masks flip too. Losses agree to 1e-4 and each
    gradient to 5e-3 in L2 (4.4e-4 measured; the largest element-wise
    error is printed too). bf16: the plain side is the kernels' plain
    versions (nerf_mlp_fn with plain=True; autograd of the plain forward
    would not round the cotangents as the kernel does). Both round at the
    same points, but a value near a rounding boundary lands on either side
    (phases 3 and 6) and the same cancellation magnifies what that moves:
    each gradient is held to phase 6's L2 bound, 5e-2 (2.0e-2 measured),
    and the losses, means over 4096 rays, to 5e-3 (6.9e-4 measured). For
    scale, the line also prints how far bf16 rounding itself moves the
    plain gradients from plain f32, and the largest ratio of the two
    distances; that ratio is not held: on alpha_linear's one-element bias
    both distances are one cancelling sum each, and it reached 3.1. A wiring
    fault (a gradient routed to the wrong parameter, a missing direction
    term) is O(1); the kernels themselves are held tighter in phases 3
    and 6. The checkpoint round trip is exact.

    Returns, per dtype, the median ms/step and each kernel's launches in
    train_background (2 steps and 2 validations) and in the 20 timed steps,
    each counted from 0."""
    import torch
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.datasets import arrays as darrays
    from neuman_tpu_torch.datasets import sampler
    from neuman_tpu_torch.models import nerf as nerf_module
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
    from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
    from neuman_tpu_torch.trainers import background as bkg

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        arrays = darrays.synthetic_arrays(SLICE_VIEWS, *SLICE_HW, seed=seed, device=device)
        train_views, val_views = [0, 1, 2], [3]

        # one step's losses and gradients, kernels vs plain, on one batch
        # and from the same params in both dtypes
        for dtype in ("float32", "bfloat16"):
            cfg = _bkg_config(out_dir, seed, name="grad", compute_dtype=dtype)
            spec = nerf_module.build_nerf_specs(cfg)
            params = ttrain.init_bkg_params(spec, seed, device)
            batch = sampler.sample_background_batch(
                torch.Generator(device).manual_seed(seed), arrays,
                torch.tensor(train_views, device=device), cfg.rays_per_batch)
            names, flat = zip(*[(f"{k}.{n}", p) for k, ps in bkg.named_params(params).items()
                                for n, p in ps.items()])

            def loss_grads(mlp):
                out = bkg.bkg_loss_fn(params, spec, batch, cfg, cfg.penalize_empty_space, mlp=mlp)
                return [x.detach() for x in out[:4]], torch.autograd.grad(sum(out[:4]), flat)

            # f32: autograd of the plain forward, independent of the kernels;
            # bf16: the kernels' plain versions, rounded at the same points
            plain = (kmlp.nerf_mlp_plain if dtype == "float32"
                     else functools.partial(kvjp.nerf_mlp_fn, plain=True))
            k_loss, k_grad = loss_grads(kvjp.nerf_mlp_fn)
            torch.cuda.reset_peak_memory_stats()
            p_loss, p_grad = loss_grads(plain)
            torch.cuda.synchronize()
            plain_gib = torch.cuda.max_memory_allocated() / 2**30
            loss_err = max((abs(a - b) / abs(b).clamp_min(1e-30)).item()
                           for a, b in zip(k_loss, p_loss))
            grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                           for a, b in zip(k_grad, p_grad))
            l2 = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                  for a, b in zip(k_grad, p_grad)]
            grad_l2 = max(l2)
            extra = {"worst": names[l2.index(grad_l2)]}
            if dtype == "float32":
                f32_plain = p_grad
            else:
                shift = [(b - c).norm() for b, c in zip(p_grad, f32_plain)]
                bf16_shift = max((d / c.norm().clamp_min(1e-30)).item()
                                 for d, c in zip(shift, f32_plain))
                ratio = [((a - b).norm() / d.clamp_min(1e-30)).item()
                         for a, b, d in zip(k_grad, p_grad, shift)]
                extra.update({"plain_bf16_vs_f32_l2_rel": f"{bf16_shift:.3e}",
                              "max_err_over_bf16_shift": f"{max(ratio):.3e}",
                              "at": names[ratio.index(max(ratio))]})
            loss_tol, grad_tol = STEP_TOL[dtype]
            ok = (loss_err <= loss_tol and grad_l2 <= grad_tol
                  and all(bool(torch.isfinite(g).all()) for g in k_grad))
            log("step_grad", rays=cfg.rays_per_batch, S=cfg.samples_per_ray,
                I=cfg.importance_samples_per_ray, dtype=dtype, loss_rel_err=f"{loss_err:.3e}",
                grad_l2_rel_err=f"{grad_l2:.3e}", grad_max_rel_err=f"{grad_rel:.3e}", **extra,
                plain_peak_gib=f"{plain_gib:.2f}", ok=ok)
            if not ok:
                raise RuntimeError(f"train step {dtype}: kernel gradients disagree with the "
                                   f"plain path")
            del params, k_grad, names, flat
            torch.cuda.empty_cache()
        del p_grad, f32_plain

        # the train path: train_background (2 steps, 2 validations), then
        # SLICE_STEPS timed steps, in f32 (the default) and in bf16
        scene = darrays.ArraysScene(arrays)
        results = {}
        for dtype in ("float32", "bfloat16"):
            cfg = _bkg_config(out_dir, seed, name=dtype, compute_dtype=dtype)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kmlp.nerf_mlp.launches = 0
            kvjp.nerf_mlp_bwd.launches = 0
            trainer = ttrain.train_background(cfg, scene, train_views, val_views, device=device)
            before = (kmlp.nerf_mlp.launches, kvjp.nerf_mlp_bwd.launches)
            events, losses = [], []
            for _ in range(SLICE_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(trainer.train_step()["total_loss"])
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            after = (kmlp.nerf_mlp.launches, kvjp.nerf_mlp_bwd.launches)
            launches = {k: {"train_background": b, f"train_{SLICE_STEPS}_steps": a - b}
                        for k, b, a in zip(("nerf_mlp", "nerf_mlp_bwd"), before, after)}
            per_step = [(a - b) / SLICE_STEPS for b, a in zip(before, after)]
            ms = sorted(s.elapsed_time(e) for s, e in events)
            median = (ms[(SLICE_STEPS - 1) // 2] + ms[SLICE_STEPS // 2]) / 2
            losses = torch.stack(losses)
            gib = torch.cuda.max_memory_allocated() / 2**30
            val = trainer.last_val_rgb
            ok = (bool(torch.isfinite(losses).all()) and per_step == [2, 2]
                  and tuple(val.shape) == (*SLICE_HW, 3) and bool(torch.isfinite(val).all()))
            log("train", dtype=dtype, rays=cfg.rays_per_batch, S=cfg.samples_per_ray,
                I=cfg.importance_samples_per_ray, steps=SLICE_STEPS, ms_per_step=f"{median:.3f}",
                ms_min=f"{ms[0]:.3f}", ms_max=f"{ms[-1]:.3f}",
                first_loss=f"{losses[0].item():.5f}", last_loss=f"{losses[-1].item():.5f}",
                launches_per_step=json.dumps(per_step), peak_gib=f"{gib:.2f}",
                launches=json.dumps(launches, separators=(",", ":")), ok=ok)
            if not ok:
                raise RuntimeError(f"train {dtype}: a loss is not finite, or the kernels did not "
                                   f"run twice each per step ({per_step})")
            results[dtype] = (median, launches)

        # checkpoint.npz round trip: a resumed trainer holds the same state
        trainer.save_model()
        resumed = bkg.NeRFTrainer(dataclasses.replace(cfg, resume=True).finalize(), spec,
                                  ttrain.init_bkg_params(spec, seed + 1, device), scene,
                                  train_views, val_views, device=device)
        a, b = trainer.state, resumed.state
        same = (a["iteration"] == b["iteration"]
                and torch.equal(a["opt_state"]["count"], b["opt_state"]["count"]))
        for k in ("coarse", "fine"):
            for (n, p), (_, q) in zip(a["params"][k].named_parameters(),
                                      b["params"][k].named_parameters()):
                same = same and torch.equal(p, q)
                for m in ("mu", "nu"):
                    same = same and torch.equal(a["opt_state"][m][k][n], b["opt_state"][m][k][n])
        log("checkpoint", iteration=b["iteration"], identical=same, ok=same)
        if not same:
            raise RuntimeError("checkpoint.npz round trip changed the trainer state")
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def build_model(device, seed):
    """Full-width HumanNeRF (8 x 256, PE 10 + 4 bands) initialised from seed."""
    import torch
    from neuman_tpu_torch.models import human_nerf
    from neuman_tpu_torch.options.config import NeuManConfig

    spec = human_nerf.build_human_nerf_spec(NeuManConfig())
    model = human_nerf.HumanNeRF(spec, device=device, generator=torch.Generator().manual_seed(seed))
    model.requires_grad_(False)
    # random nets are nearly transparent; shift the density biases so the
    # background fills the frame and the body is opaque, and both branches
    # (and any kernel error in them) show in the pixels
    model.coarse_bkg_net.nerf.alpha_linear.bias.fill_(0.5)
    model.fine_bkg_net.nerf.alpha_linear.bias.fill_(0.5)
    model.coarse_human_net.nerf.alpha_linear.bias.fill_(5.0)
    return spec, model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from neuman_tpu_torch.models import smpl
    from neuman_tpu_torch.ops import mesh as mesh_ops

    device = torch.device("cuda", 0)
    phase_card()
    phase_build()

    spec, model = build_model(device, args.seed)
    body = smpl.body_proxy_smpl_model(subdivisions=BODY_SUBDIVISIONS, device=device)
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, device)

    mlp = phase_mlp(model, spec, device, args.seed)
    mesh = phase_mesh(body.v_template, topo, args.seed)
    launches = phase_slice(model, spec, body, device, args.seed)
    bwd = phase_bwd(model, spec, device, args.seed)
    train = phase_train(device, args.seed)

    # timings: nerf_mlp the render path's bf16 per-ray case (phase 3),
    # ericson_select stride 4 (phase 4), nerf_mlp_bwd the fine pass of the
    # f32 train step (phase 6). launches: the sum over the main paths, each
    # counted from 0 in its own run and listed in launches_by_path: one
    # render frame (phase 5), and the f32 train path (phase 7) split into
    # train_background (2 steps, 2 validations) and the 20 timed steps.
    # No single PyTorch call computes any of the three functions.
    def entry(name, replaces, by_path, max_abs_err, timing):
        ms, plain_ms, b_ms, b_by = timing
        return {"name": name, "route": "cuda", "source": f"neuman_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": max_abs_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    train_launches = train["float32"][1]
    kernels = [
        entry("nerf_mlp", "neuman_tpu/ops/pallas/raymarch.py:105",
              {"render_frame": launches["nerf_mlp"], **train_launches["nerf_mlp"]},
              max(mlp[(m, "bf16")][0] for m in ("per_ray", "per_sample")),
              mlp[("per_ray", "bf16")][1:]),
        entry("ericson_select", "neuman_tpu/ops/pallas/meshquery.py:314",
              {"render_frame": launches["ericson_select"]}, max(r[0] for r in mesh.values()),
              mesh[4][1:]),
        entry("nerf_mlp_bwd", "neuman_tpu/ops/pallas/raymarch_vjp.py:76",
              train_launches["nerf_mlp_bwd"], bwd[("per_ray", 256, "f32")][0],
              bwd[("per_ray", 256, "f32")][1:]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
