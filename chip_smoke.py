#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (neuman_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--seed N] [--phases mlp,mesh,...]

Phases, one line each; any failure ends the run with a non-zero exit:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc builds the six kernel libraries (seven kernels) from
     neuman_tpu_torch/csrc/ (sm_90a), all started together; then each
     kernel of the nerf_mlp and offset_mlp pairs (all on mlp_hopper.cuh)
     with its registers, spill bytes and stack (ptxas -v) and the dynamic
     shared memory it launches with;
  3. mlp: nerf_mlp kernel vs its plain PyTorch version at full width (8x256,
     PE 10 + 4 bands), R=1024 x S=64: per-ray posenc and per-sample
     rotate, f32 and bf16;
  4. mesh: ericson_select kernel vs its plain version, N=65,536 ray samples
     on the body-proxy mesh (V=10,242), k=4, stride 1 and 4;
  5. slice: the render slice at full width: one 4096-ray hybrid chunk in
     f32, kernels vs plain, then a 270x480 frame through render_hybrid_nerf
     at its default bf16 (the render path; launch counts reset just before
     it) against the plain bf16 frame;
  6. bwd: nerf_mlp_bwd and nerf_mlp kernels vs their plain versions at full
     width at the background train step's shapes, R=4096 x S=128 and S=256
     per-ray posenc, S=128 per-sample rotate, f32 and bf16; two backward
     kernel runs bit-identical;
  7. train: the background train slice at the bkg defaults (4096 rays, 128
     + 128 samples) on a 4-view 270x480 synthetic scene: a step's losses and
     gradients with the kernels vs the plain path on one batch, in f32 and
     in bf16; then train_background (the train path; launch counts reset
     just before it) and 20 timed steps in f32 and in bf16; a
     checkpoint.npz round trip;
  8. offset, knn: offset_mlp and offset_mlp_bwd vs their plain versions at
     the human step's shape, R=1536 x S=128 on (x, y, z, t), f32 and bf16,
     two backward runs bit-identical; bucketed_knn vs its plain version at
     Nq=49,152 and 196,608 on the V=10,242 proxy, k=4 (scores everywhere,
     indices outside score ties; recall of the exact nearest vertex
     printed);
  9. human: the human train slice at the smpl_and_offset defaults (1536
     rays, 128 samples, all seven losses, V=10,242 body) on the same
     synthetic scene: a step's losses and every parameter gradient
     (canonical net, offset net, poses), kernels vs plain, in f32 and bf16;
     the nerf_mlp pair at the step's R=6144 x S=128 per-sample shape;
     train_human for 2 steps with validations (the human train path; launch
     counts reset just before it) and a checkpoint.npz round trip; 20 timed
     steps in f32 and in bf16 with each kernel's launches per step; the
     validation's four PNGs read back and decoded; the same 20 steps in the
     mlp_tape="hbm" configuration (as in phase 7 too), whose parameters after
     train_human's 2 steps equal the recompute configuration's bit for bit,
     with the peak memory of each; one step's losses with the fused signed
     distance against the default, and 2 train steps with it;
 10. tape: at the shapes of phases 6, 8 and 9 (R=4096 x S=256 per-ray,
     R=6144 x S=128 per-sample, the offset net's R=1536 x S=128; f32 and
     bf16) the tape-writing forwards vs their plain versions (outputs and
     tape) and the backwards with the tape vs recompute (every gradient
     bit-identical); times of both configurations and the tape's bytes; no
     tape under torch.no_grad();
 11. signed: ericson_signed_select vs its plain version, vs ericson_select
     and vs the unfused signed distance at N=196,608, C=24, stride 4 and 1,
     with tables; its gradient; times of the fused and unfused queries;
 12. renders: a 270x480 render_smpl_nerf frame, canonical and posed, and a
     two-actor render_hybrid_nerf_multi_persons frame, bf16, kernels vs the
     plain path.
Then one JSON line of per-kernel results, and last the device line.
--phases runs a subset (for work on one kernel); the contract is the run
with no arguments.

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

# phase 8: the human step's offset-net shape, and its KNN query counts
# (196,608 points in groups of 4, and every point)
OFFSET_RAYS, OFFSET_SAMPLES = 1536, 128
KNN_QUERIES = (49152, 196608)
KNN_K = 4
# scores: both sides take the same f32 operations; indices may differ only
# where the two picked vertices' scores agree to this (a tie)
KNN_SCORE_ATOL = 1e-5
# phase 9: iteration of the gradient check (the offset scale is 0, and the
# offset net's gradient with it, before offset_delay = 20,000)
HUMAN_GRAD_ITERATION = 30000
HUMAN_STEPS = 20
# loss rel error; each parameter group's worst gradient L2 error over its L2
# norm (see phase_human for the reasons)
HUMAN_STEP_TOL = {
    "float32": (1e-4, {"poses": 5e-3, "coarse_human_net": 1e-2, "offset_nets": 5e-2}),
    "bfloat16": (5e-3, {"poses": 5e-2, "coarse_human_net": 5e-2, "offset_nets": 1e-1}),
}
# launches of one human train step: nerf_mlp = frozen coarse and fine
# background + the batched canonical application + the sparsity rays
HUMAN_LAUNCHES = {"nerf_mlp": 4, "nerf_mlp_bwd": 2, "offset_mlp": 1, "offset_mlp_bwd": 1,
                  "ericson_select": 3, "ericson_signed_select": 0, "bucketed_knn": 3}
# phase 11: the human step's signed-distance queries (1536 rays x 128 samples)
SIGNED_RAYS, SIGNED_SAMPLES = 1536, 128
# the fused kernel and the unfused tail take the same operations on the same
# values, so their signs agree; a difference is excused only where the
# unfused |(p - closest) . n| is within this of 0, and is counted
SIGN_DOT_ATOL = 1e-6
# barycentric weights, the normal blend and the dot, for the selected candidate
SIGN_OPS_PER_POINT = 70
# the losses of a step with the fused signed distance against the default
FUSED_LOSS_ATOL = 1e-6
# the images a human validation writes, and the index of the shape loss
VAL_IMAGES = ("val_can", "val_depth", "val_acc", "val_smpl_overlay")
LOSS_NAMES_SHAPE = 4  # "smpl_shape_reg" in trainers.human.LOSS_NAMES
# launches of two human train steps with the fused signed distance
FUSED_LAUNCHES = {"ericson_select": 2, "ericson_signed_select": 4}
# a vertex score |v|^2 - 2 v.p: 3 multiplies and 3 adds
KNN_OPS_PER_SCORE = 6

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


def cuda_ms_min(fn, repeats=5, iters=20, warmup=20):
    """For kernels of a millisecond or less, whose time moves with the
    card's clocks (idle after the build): the least of `repeats` means of
    `iters` calls each, after `warmup` calls."""
    return min(cuda_ms(fn, iters, warmup if i == 0 else 0) for i in range(repeats))


def bound_ms(flops, nbytes, dtype):
    """(least ms for the work, "operations" or "bytes"): the larger of the
    operations at the card's peak for `dtype` and the bytes at its HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def trunk_macs_per_sample(spec):
    """Multiply-adds of the ReLU trunk for one sample."""
    n, cp, w = spec.nerf, spec.pos_pe.out_dim, spec.nerf.width
    return sum((cp if i == 0 else cp + w if (i - 1) in n.skips else w) * w
               for i in range(n.depth))


def mlp_macs_per_sample(spec, per_sample):
    """Multiply-adds of one forward application of the NeRF to one sample
    (the per-ray direction term is computed once per ray, outside)."""
    w, cd = spec.nerf.width, spec.dir_pe.out_dim
    return (trunk_macs_per_sample(spec) + w + w * w
            + (w + (cd if per_sample else 0)) * (w // 2) + (w // 2) * 3)


def tape_bytes(spec, n, dtype):
    """The trunk posts of n samples in the compute dtype."""
    return n * spec.nerf.depth * spec.nerf.width * (2 if dtype == "bf16" else 4)


def mlp_bound(spec, net, per_sample, r, s, dtype, backward, tape=False):
    """Bound of the forward (each input read once: planes, direction,
    weights; outputs sigma, rgb) or of the recompute backward (+ the four
    cotangents in; d_planes, d_dir and every weight gradient out; 3x the
    forward's multiply-adds). tape: the forward also writes the trunk
    posts; the backward reads them and leaves out the trunk's forward."""
    n = r * s
    params = sum(p.numel() for p in net.parameters()) * 4
    dirs = 3 * n * 4 if per_sample else r * (spec.nerf.width // 2) * 4
    macs = mlp_macs_per_sample(spec, per_sample) * (3 if backward else 1)
    nbytes = 3 * n * 4 + dirs + params + 4 * n * 4
    if backward:
        nbytes += 3 * n * 4 + dirs + params
    if tape:
        nbytes += tape_bytes(spec, n, dtype)
        macs -= trunk_macs_per_sample(spec) if backward else 0
    return bound_ms(2 * macs * n, nbytes, dtype)


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
    from neuman_tpu_torch.ops.kernels import (_build, knn, meshquery, nerf_mlp, nerf_mlp_vjp,
                                              offset_mlp)

    t0 = time.perf_counter()
    libs = (nerf_mlp_vjp._lib, offset_mlp._lib_bwd, nerf_mlp._lib, offset_mlp._lib_fwd,
            meshquery._lib, knn._lib)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib) for lib in libs]:
            f.result()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_library={k: round(v, 2) for k, v in _build.build_seconds.items()},
        dir=os.path.relpath(_build.BUILD_DIR, ROOT))
    # dynamic shared memory of the forward, chain-pass and dW kernels (the
    # offset pair's at the (x, y, z, t) PE of 84 columns)
    nbwd, obwd = nerf_mlp_vjp._lib().nerf_mlp_bwd_shared_bytes, offset_mlp._lib_bwd().offset_mlp_bwd_shared_bytes
    pos_dim = 84
    smem = {("nerf_mlp", "nerf_mlp_kernel"): nerf_mlp._lib().nerf_mlp_shared_bytes,
            ("nerf_mlp_bwd", "bwd_chain_kernel"): functools.partial(nbwd, 0),
            ("nerf_mlp_bwd", "dw_kernel"): functools.partial(nbwd, 1),
            ("offset_mlp", "offset_mlp_kernel"):
                lambda w, h: offset_mlp._lib_fwd().offset_mlp_shared_bytes(w, pos_dim, h),
            ("offset_mlp_bwd", "offset_chain_kernel"): lambda w, h: obwd(0, w, pos_dim, h),
            ("offset_mlp_bwd", "dw_kernel"): lambda w, h: obwd(1, w, pos_dim, h)}
    spills = []
    for lib in ("nerf_mlp", "nerf_mlp_bwd", "offset_mlp", "offset_mlp_bwd"):
        for fn, res in sorted(_build.kernel_resources(lib).items()):
            kernel, dtype, width = _kernel_name(fn)
            if kernel is None or "registers" not in res:
                continue
            size = smem.get((lib, kernel))
            shared = size(width or 256, int(dtype == "bf16")) if size else 0
            log("ptxas", library=lib, kernel=kernel, dtype=dtype, width=width or "any",
                registers=res["registers"], spill_stores=res.get("spill_stores", 0),
                spill_loads=res.get("spill_loads", 0), stack=res.get("stack", 0),
                dynamic_smem=shared)
            if res.get("spill_stores", 0) or res.get("spill_loads", 0):
                spills.append(f"{lib}:{kernel}<{dtype},{width}>")
    log("ptxas_spills", kernels=",".join(spills) or "none")


def _kernel_name(mangled):
    """(kernel, dtype, width) of a mangled kernel name of the nerf_mlp or
    offset_mlp pair, or (None, None, None) for another function."""
    import re

    m = re.search(r"(nerf_mlp_kernel|bwd_chain_kernel|dw_kernel|bwd_ddir_kernel|dw_reduce_kernel"
                  r"|offset_mlp_kernel|offset_chain_kernel)"
                  r"(I(f|13__nv_bfloat16)(Li(\d+)E)?E)?", mangled)
    if m is None:
        return None, None, None
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16"}.get(m.group(3), "f32")
    return m.group(1), dtype, int(m.group(5)) if m.group(5) else None


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
    return err, scale, cuda_ms_min(run_k), cuda_ms_min(run_p)


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
        k_ms, p_ms = cuda_ms_min(run_k), cuda_ms_min(run_p, repeats=2, iters=5, warmup=2)
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

    Each dtype runs in both tape configurations (`mlp_tape`), from the same
    seed: after train_background's 2 steps the "hbm" parameters must equal
    the "recompute" ones bit for bit, and the launches are the same.

    Returns, per dtype (and per dtype + "_hbm"), the median ms/step, each
    kernel's launches in train_background (2 steps and 2 validations) and in
    the 20 timed steps, each counted from 0, and the peak memory in GiB."""
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
        for dtype, tape in ((d, t) for d in ("float32", "bfloat16") for t in ("recompute", "hbm")):
            cfg = _bkg_config(out_dir, seed, name=f"{dtype}_{tape}", compute_dtype=dtype,
                              mlp_tape=tape)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kmlp.nerf_mlp.launches = 0
            kvjp.nerf_mlp_bwd.launches = 0
            trainer = ttrain.train_background(cfg, scene, train_views, val_views, device=device)
            before = (kmlp.nerf_mlp.launches, kvjp.nerf_mlp_bwd.launches)
            # the two configurations' parameters after the same 2 steps
            after_2 = [p.detach().clone() for net in trainer.state["params"].values()
                       for p in net.parameters()]
            if tape == "recompute":
                recompute_2, same_2 = after_2, True
            else:
                same_2 = all(torch.equal(a, b) for a, b in zip(after_2, recompute_2))
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
            ok = (bool(torch.isfinite(losses).all()) and per_step == [2, 2] and same_2
                  and tuple(val.shape) == (*SLICE_HW, 3) and bool(torch.isfinite(val).all()))
            log("train", dtype=dtype, mlp_tape=tape, params_equal_recompute_after_2_steps=same_2,
                rays=cfg.rays_per_batch, S=cfg.samples_per_ray,
                I=cfg.importance_samples_per_ray, steps=SLICE_STEPS, ms_per_step=f"{median:.3f}",
                ms_min=f"{ms[0]:.3f}", ms_max=f"{ms[-1]:.3f}",
                first_loss=f"{losses[0].item():.5f}", last_loss=f"{losses[-1].item():.5f}",
                launches_per_step=json.dumps(per_step), peak_gib=f"{gib:.2f}",
                launches=json.dumps(launches, separators=(",", ":")), ok=ok)
            if not ok:
                raise RuntimeError(f"train {dtype} {tape}: a loss is not finite, the kernels did "
                                   f"not run twice each per step ({per_step}), or the tape "
                                   f"configuration's parameters differ from recompute's")
            results[dtype if tape == "recompute" else f"{dtype}_hbm"] = (median, launches, gib)

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


def offset_bound(spec, net, n, dtype, backward, tape=False):
    """Bound of the offset net's forward (4 input planes, the weights, 3
    output planes) or recompute backward (+ 3 cotangent planes in; d_axes
    and every weight gradient out; 3x the forward's multiply-adds). tape: as
    in `mlp_bound`."""
    ns = spec.nerf
    trunk = trunk_macs_per_sample(spec)
    macs = (trunk + ns.width * ns.output_ch) * (3 if backward else 1)
    params = sum(p.numel() for p in net.parameters()) * 4
    nbytes = 4 * n * 4 + params + ns.output_ch * n * 4
    if backward:
        nbytes += ns.output_ch * n * 4 + 4 * n * 4 + params
    if tape:
        nbytes += tape_bytes(spec, n, dtype)
        macs -= trunk if backward else 0
    return bound_ms(2 * macs * n, nbytes, dtype)


def phase_offset(model, spec, device, seed):
    """The tolerances of phases 3 and 6, for the same reasons: f32 forward
    1e-3 absolute, backward 1e-3 of each output's largest value (both sides
    f32, another order of the sums); bf16 forward 5e-2 of the output scale,
    backward 5e-2 in L2 of each output (same rounding points, values near a
    rounding boundary land on either side and flip ReLU masks further down).
    Two backward runs must be bit-identical."""
    import torch
    from neuman_tpu_torch.ops.kernels import offset_mlp as koff

    gen = torch.Generator().manual_seed(seed + 4)
    ospec, net = spec.offset, model.offset_nets[0].nerf
    r, s = OFFSET_RAYS, OFFSET_SAMPLES
    axes = [(torch.rand(r, s, generator=gen) * 3 - 1.5).to(device) for _ in range(3)]
    axes.append(torch.full((r, s), 0.37, device=device))
    cot = [torch.randn(r, s, generator=gen).to(device) for _ in range(3)]
    results, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        fwd_k = lambda: koff.offset_mlp(ospec, net, axes, dtype)
        fwd_p = lambda: koff.offset_mlp_plain(ospec, net, axes, dtype)
        out_k, out_p = torch.stack(fwd_k()), torch.stack(fwd_p())
        torch.cuda.synchronize()
        f_err, f_scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
        f_std = out_k.std(dim=1).min().item()  # a net that ignores its input would show 0
        f_ok = bool(torch.isfinite(out_k).all()) and f_std > 0 and _fwd_ok(f_err, f_scale, name)
        bwd_k = lambda: koff.offset_mlp_bwd(ospec, net, axes, cot, dtype)
        bwd_p = lambda: koff.offset_mlp_bwd_plain(ospec, net, axes, cot, dtype)
        flat = lambda out: [t for wb in out[0] for t in wb] + list(out[1])
        got, again, ref = flat(bwd_k()), flat(bwd_k()), flat(bwd_p())
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        err = max((a - c).abs().max().item() for a, c in zip(got, ref))
        rel = max((a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
                  for a, c in zip(got, ref))
        l2 = max(((a - c).norm() / c.norm().clamp_min(1e-30)).item() for a, c in zip(got, ref))
        del got, again, ref
        torch.cuda.empty_cache()
        times = {k: cuda_ms(f, iters=5, warmup=1) for k, f in
                 (("fwd", fwd_k), ("fwd_plain", fwd_p), ("bwd", bwd_k), ("bwd_plain", bwd_p))}
        fb = offset_bound(ospec, net, r * s, name, backward=False)
        bb = offset_bound(ospec, net, r * s, name, backward=True)
        ok = (f_ok and identical and finite
              and (rel <= BWD_F32_REL if name == "f32" else l2 <= BWD_BF16_L2))
        log("offset_mlp", dtype=name, R=r, S=s, fwd_max_abs_err=f"{f_err:.3e}",
            fwd_out_scale=f"{f_scale:.3f}", fwd_out_std=f"{f_std:.3e}", fwd_ok=f_ok,
            fwd_kernel_ms=f"{times['fwd']:.3f}",
            fwd_plain_ms=f"{times['fwd_plain']:.3f}", fwd_bound_ms=f"{fb[0]:.4f}",
            bwd_max_abs_err=f"{err:.3e}", bwd_max_rel_err=f"{rel:.3e}", bwd_l2_rel_err=f"{l2:.3e}",
            bit_identical=identical, bwd_kernel_ms=f"{times['bwd']:.3f}",
            bwd_plain_ms=f"{times['bwd_plain']:.3f}", bwd_bound_ms=f"{bb[0]:.4f}",
            bound_by=bb[1], ok=ok)
        if not ok:
            failed.append(name)
        results[name] = {"fwd": (f_err, times["fwd"], times["fwd_plain"], *fb),
                         "bwd": (err, times["bwd"], times["bwd_plain"], *bb)}
    if failed:
        raise RuntimeError(f"offset_mlp or offset_mlp_bwd disagrees with its plain version, or "
                           f"offset_mlp_bwd between runs: {failed}")
    return results


def phase_knn(verts, seed):
    """Kernel and plain take each score by the same f32 operations (an
    explicit FMA chain), so the k scores agree to 1e-5 everywhere (expected:
    exactly, or one rounding where the plain version's f64 emulation of an
    FMA rounds twice) and the indices agree except where the two picked
    vertices' scores tie within that. The recall of the exact nearest
    vertex (a top-k over all V vertices) is printed, not held: the bucketed
    KNN is approximate by design, as in the JAX package."""
    import torch
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.ops.kernels import knn as kknn

    gen = torch.Generator().manual_seed(seed + 5)
    results = {}
    for nq in KNN_QUERIES:
        pts = _ray_samples(verts, nq // OFFSET_SAMPLES, OFFSET_SAMPLES, gen)
        run_k = lambda: kknn.bucketed_knn(pts, verts, KNN_K)
        run_p = lambda: kknn.bucketed_knn_plain(pts, verts, KNN_K)
        (ki, ks), (pi_, ps) = run_k(), run_p()
        torch.cuda.synchronize()
        err = (ks - ps).abs().max().item()
        diff = ki != pi_
        ties_only = bool(((ks - ps).abs()[diff] <= KNN_SCORE_ATOL).all())
        in_range = bool(((ki >= 0) & (ki < verts.shape[0])).all())
        exact = torch.cat([mesh_ops._query_knn(c, verts, KNN_K)[0] for c in pts.split(16384)])
        recall1 = (ki[:, 0] == exact[:, 0]).float().mean().item()
        recall_k = (ki[:, :, None] == exact[:, None, :]).any(1).float().mean().item()
        del exact
        k_ms, p_ms = cuda_ms(run_k, iters=5, warmup=1), cuda_ms(run_p, iters=2, warmup=1)
        v_pad = kknn.bucket_table(verts)[..., 0].numel()
        b_ms, b_by = bound_ms(KNN_OPS_PER_SCORE * nq * verts.shape[0],
                              3 * nq * 4 + 3 * verts.shape[0] * 4 + 2 * KNN_K * nq * 4, "f32")
        ok = err <= KNN_SCORE_ATOL and ties_only and in_range
        log("bucketed_knn", Nq=nq, V=verts.shape[0], V_pad=v_pad, k=KNN_K,
            score_max_abs_err=f"{err:.3e}", idx_diff=int(diff.sum()), ties_only=ties_only,
            recall_nearest=f"{recall1:.4f}", recall_top_k=f"{recall_k:.4f}",
            kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.3f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, ok=ok)
        if not ok:
            raise RuntimeError(f"bucketed_knn Nq={nq}: kernel disagrees with its plain version")
        results[nq] = (err, k_ms, p_ms, b_ms, b_by)
    return results


def _human_config(out_dir, seed, **fields):
    from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults

    cfg = apply_mode_defaults(NeuManConfig(), "smpl_and_offset")
    cfg.out_dir, cfg.seed, cfg.max_iter, cfg.valid_iter = out_dir, seed, 2, 1000
    cfg.geo_threshold = 0.25
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg.finalize()


def _kernel_counters():
    from neuman_tpu_torch.ops.kernels import knn, meshquery, nerf_mlp, nerf_mlp_vjp, offset_mlp

    return {"nerf_mlp": nerf_mlp.nerf_mlp, "nerf_mlp_bwd": nerf_mlp_vjp.nerf_mlp_bwd,
            "offset_mlp": offset_mlp.offset_mlp, "offset_mlp_bwd": offset_mlp.offset_mlp_bwd,
            "ericson_select": meshquery.ericson_select,
            "ericson_signed_select": meshquery.ericson_signed_select,
            "bucketed_knn": knn.bucketed_knn}


def _cudnn_flags():
    import torch

    c = torch.backends.cudnn
    return c.enabled, c.benchmark, c.deterministic, c.allow_tf32


def _alive(model):
    """A random canonical net's density is nearly the same everywhere, so it
    can be <= 0 everywhere (a dead net, which the step restarts): shift its
    bias so that the checks and the timed steps see a live net."""
    import torch

    with torch.no_grad():
        model.coarse_human_net.nerf.alpha_linear.bias.fill_(0.5)


def phase_human_step(body, device, seed):
    """One human step's losses and gradients, kernels against plain, on a
    batch that leads with the LPIPS patch, at iteration 30,000, where the
    offset scale (0 before 20,000) gives the offset net a gradient. The
    canonical net's density bias is set to 0.5: a random net can be dead.
    f32: the plain side is autograd of the plain forwards with the plain
    mesh queries (`PLAIN`), independent of the backward kernels;
    bf16: the kernels' plain versions in the same autograd Functions
    (`PLAIN_FUNCTIONS`), rounded where the kernels round.

    Tolerances (HUMAN_STEP_TOL), per parameter group, on the L2 error of
    each parameter's gradient: the reasons are phase 7's (a weight gradient
    sums ~1M per-sample terms that largely cancel, in another order; the
    importance samples, the z-merge order and ReLU masks move with the last
    bits), and the offset net sits behind one more cancelling sum: its
    cotangents are the canonical net's d_planes (the PE derivative at bands
    up to 2^9) times the offset scale. Measured on the H100: 4e-6 for every
    group on the batch of seed 0 with the patch, and 3.3e-5 (poses), 3.7e-3
    (canonical net), 2.1e-2 (offset net) on the batch without it, where a
    few samples' z order or masks differ between the two paths; the line
    prints, for scale, how far the same plain arithmetic moves when only the
    backward's sums are ordered otherwise (f32) and how far bf16 rounding
    moves the plain gradients from f32 (bf16: 6e-2, 4e-2, 0.27 against the
    kernels' 7e-3, 7e-3, 4e-2). Held: f32 5e-3 / 1e-2 / 5e-2, bf16 5e-2 /
    5e-2 / 1e-1, losses 1e-4 and 5e-3. A wiring fault is O(1). The poses'
    gradient comes through the kernels' d_planes and d_dir, the warp's
    barycentric blend and `vertex_forward`; the face choice carries no
    gradient and is the same on both sides (the closest-point kernel is
    bit-equal to plain, the KNN equal outside ties).

    Each dtype then trains in both tape configurations (`mlp_tape`) from the
    same seed: after train_human's 2 steps the "hbm" parameters must equal
    the "recompute" ones bit for bit, with no cuDNN flag set from outside
    (the train step scopes cuDNN's deterministic convolutions itself and
    must leave the process's flags as it found them); the launches per
    step are the same.
    Each train_human's last validation must have written its four PNGs,
    which are read back and decoded. Last, the step's losses with the fused
    signed distance are held to the default's, and 2 steps train with it.

    Returns, per dtype (and per dtype + "_hbm"), the median ms/step, each
    kernel's launches in train_human (2 steps and 2 validations) and in the
    20 timed steps, and the peak memory in GiB; and the launches of the 2
    steps with the fused signed distance."""
    import numpy as np
    import torch
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.datasets import arrays as darrays
    from neuman_tpu_torch.models import human_nerf as hn
    from neuman_tpu_torch.models import lpips as lpips_module
    from neuman_tpu_torch.trainers import human
    from neuman_tpu_torch.trainers import logging as tlog

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    counters = _kernel_counters()
    try:
        scene = darrays.synthetic_human_scene(body, SLICE_VIEWS, *SLICE_HW, seed=seed, device=device)
        train_views, val_views = [0, 1, 2], [3]
        poses = np.stack([s["pose"] for s in scene.smpls])
        betas = np.stack([s["betas"] for s in scene.smpls])

        def trainer_for(cfg, model_seed, ops=human.KERNELS):
            spec = hn.build_human_nerf_spec(cfg)
            model = hn.HumanNeRF(spec, device=device,
                                 generator=torch.Generator().manual_seed(model_seed),
                                 poses=poses, betas=betas, alignments=scene.alignments)
            _alive(model)
            return human.HumanNeRFTrainer(
                cfg, model, scene, train_views, val_views, body,
                lpips_params=lpips_module.init_lpips_params(seed, device), device=device,
                ops=ops)

        # one step's losses and gradients, kernels vs plain, on one batch
        for dtype in ("float32", "bfloat16"):
            cfg = _human_config(out_dir, seed, name="grad", compute_dtype=dtype)
            trainer = trainer_for(cfg, seed)
            model = trainer.model
            for batch_seed in range(seed, seed + 16):  # a batch that leads with the LPIPS patch
                batch = trainer.draw_batch(generator=torch.Generator(device).manual_seed(batch_seed))
                if int(batch["patch_counter"]) == 1:
                    break
            hit = batch["is_hit"].float().mean().item()
            named = human.trained_params(model)
            names, flat = zip(*[(human._full_name(k, n), p) for k, ps in named.items()
                                for n, p in ps.items()])
            anneals = human.compute_anneals(cfg, HUMAN_GRAD_ITERATION)

            def loss_grads(ops):
                fn = human.make_human_loss_fn(model, cfg, trainer.ctx, ops=ops)
                total, aux = fn(batch, torch.Generator(device).manual_seed(seed + 1), anneals)
                losses = [aux["losses"][k].detach() for k in human.LOSS_NAMES]
                return losses, torch.autograd.grad(total, flat), bool(aux["dead"])

            def group_l2(got, ref):
                l2 = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                      for a, b in zip(got, ref)]
                worst = {g: max((e, n) for n, e in zip(names, l2) if n.startswith(g))
                         for g in human.TRAINED}
                return ({g: float(f"{e:.3e}") for g, (e, _) in worst.items()},
                        max(worst.values())[1])

            k_loss, k_grad, dead = loss_grads(human.KERNELS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if dtype == "float32":
                p_loss, p_grad, _ = loss_grads(human.PLAIN)
                f32_plain = p_grad
                torch.cuda.synchronize()
                plain_gib = torch.cuda.max_memory_allocated() / 2**30
                # for scale: the same plain arithmetic with the backward's
                # sums in another order (the explicit plain backwards)
                other = group_l2(loss_grads(human.PLAIN_FUNCTIONS)[1], p_grad)[0]
                extra = {"plain_functions_vs_plain_l2": json.dumps(other, separators=(",", ":"))}
            else:
                p_loss, p_grad, _ = loss_grads(human.PLAIN_FUNCTIONS)
                torch.cuda.synchronize()
                plain_gib = torch.cuda.max_memory_allocated() / 2**30
                # for scale: how far bf16 rounding itself moves the plain gradients
                shift = group_l2(p_grad, f32_plain)[0]
                extra = {"plain_bf16_vs_f32_l2": json.dumps(shift, separators=(",", ":"))}
            loss_err = max((abs(a - b) / abs(b).clamp_min(1e-30)).item()
                           for a, b in zip(k_loss, p_loss))
            by_group, worst = group_l2(k_grad, p_grad)
            nonzero = all(bool(g.abs().max() > 0) for g in k_grad)
            loss_tol, grad_tol = HUMAN_STEP_TOL[dtype]
            ok = (not dead and nonzero and loss_err <= loss_tol
                  and all(by_group[g] <= grad_tol[g] for g in human.TRAINED)
                  and all(bool(torch.isfinite(g).all()) for g in k_grad)
                  and all(bool(b != 0) for b in p_loss))
            log("human_step_grad", rays=cfg.rays_per_batch, S=cfg.samples_per_ray, dtype=dtype,
                hit_share=f"{hit:.4f}", loss_rel_err=f"{loss_err:.3e}",
                losses=json.dumps({k: round(v.item(), 6) for k, v in
                                   zip(human.LOSS_NAMES, k_loss)}, separators=(",", ":")),
                grad_l2_rel_err=json.dumps(by_group, separators=(",", ":")), worst=worst,
                **extra, plain_peak_gib=f"{plain_gib:.2f}", ok=ok)
            if not ok:
                raise RuntimeError(f"human step {dtype}: kernel losses or gradients disagree "
                                   f"with the plain path, or a loss or gradient is zero")
            del trainer, model, k_grad, p_grad, flat, named
            torch.cuda.empty_cache()
        del f32_plain

        # the human train path: train_human (2 steps, 2 validations), then
        # HUMAN_STEPS timed steps, in f32 (the default) and in bf16
        results = {}
        for dtype, tape in ((d, t) for d in ("float32", "bfloat16") for t in ("recompute", "hbm")):
            cfg = _human_config(out_dir, seed, name=f"{dtype}_{tape}", compute_dtype=dtype,
                                mlp_tape=tape)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            # no flag is set here: the train step is deterministic itself
            flags = _cudnn_flags()
            trainer = ttrain.train_human(cfg, scene, train_views, val_views, body, device=device)
            flags_kept = _cudnn_flags() == flags
            before = {k: fn.launches for k, fn in counters.items()}
            val_ok = all(math.isfinite(v) for v in trainer.last_val_losses.values())
            # the validation's images, read back and decoded
            pngs = {os.path.basename(path).rsplit("_", 1)[0]: tlog.decode_png(open(path, "rb").read())
                    for path in trainer.last_val_images}
            val_ok = val_ok and sorted(pngs) == sorted(VAL_IMAGES) and all(
                img.shape == (*SLICE_HW, 3) for img in pngs.values())
            # the two configurations' parameters after the same 2 steps
            after_2 = [p.detach().clone() for p in trainer.model.parameters()]
            if tape == "recompute":
                recompute_2, same_2 = after_2, True
            else:
                same_2 = all(torch.equal(a, b) for a, b in zip(after_2, recompute_2))
            _alive(trainer.model)
            events, losses = [], []
            for _ in range(HUMAN_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(trainer.train_step()["total_loss"])
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            after = {k: fn.launches for k, fn in counters.items()}
            launches = {k: {"train_human": before[k], f"human_{HUMAN_STEPS}_steps": after[k] - before[k]}
                        for k in counters}
            per_step = {k: (after[k] - before[k]) / HUMAN_STEPS for k in counters}
            ms = sorted(s.elapsed_time(e) for s, e in events)
            median = (ms[(HUMAN_STEPS - 1) // 2] + ms[HUMAN_STEPS // 2]) / 2
            losses = torch.stack(losses)
            gib = torch.cuda.max_memory_allocated() / 2**30
            ok = (val_ok and same_2 and flags_kept and bool(torch.isfinite(losses).all())
                  and bool((losses != 0).all()) and per_step == HUMAN_LAUNCHES
                  and all(v > 0 for k, v in before.items() if HUMAN_LAUNCHES[k]))
            log("human_train", dtype=dtype, mlp_tape=tape,
                params_equal_recompute_after_2_steps=same_2, cudnn_flags_kept=flags_kept,
                val_pngs=json.dumps({k: list(v.shape) for k, v in pngs.items()},
                                    separators=(",", ":")),
                rays=cfg.rays_per_batch, S=cfg.samples_per_ray,
                V=body.num_verts, steps=HUMAN_STEPS, ms_per_step=f"{median:.3f}",
                ms_min=f"{ms[0]:.3f}", ms_max=f"{ms[-1]:.3f}",
                first_loss=f"{losses[0].item():.5f}", last_loss=f"{losses[-1].item():.5f}",
                launches_per_step=json.dumps(per_step, separators=(",", ":")),
                peak_gib=f"{gib:.2f}", launches=json.dumps(launches, separators=(",", ":")), ok=ok)
            if not ok:
                raise RuntimeError(f"human train {dtype} {tape}: a loss is not finite or is zero, "
                                   f"the kernels' launches per step are not {HUMAN_LAUNCHES}, a "
                                   f"validation PNG is missing or of another size, the tape "
                                   f"configuration's parameters differ from recompute's, or the "
                                   f"step changed the process's cuDNN flags")
            results[dtype if tape == "recompute" else f"{dtype}_hbm"] = (median, launches, gib)

        # what the train step's cuDNN scope costs: the LPIPS loss on the
        # step's 32 x 32 patch pair and its gradient (the only convolutions
        # of the step), under the flags the step ran with before the scope
        # (cuDNN's default algorithms, TF32 off) and under the scope
        gen = torch.Generator().manual_seed(seed + 7)
        lp = lpips_module.init_lpips_params(seed, device)
        pair = [(torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1).to(device) for _ in range(2)]
        x = pair[0].requires_grad_(True)
        run = lambda: torch.autograd.grad(lpips_module.lpips(lp, x, pair[1]).sum(), x)
        flags = {"default": dict(deterministic=False, allow_tf32=False),
                 "scope": dict(enabled=True, benchmark=False, deterministic=True,
                               allow_tf32=False)}
        scope_ms = {"default": math.inf, "scope": math.inf}
        for name in ("default", "scope", "scope", "default") * 2:  # in turns: the least of each
            with lpips_module.cudnn_scope(**flags[name]):
                scope_ms[name] = min(scope_ms[name], cuda_ms_min(run))
        log("human_cudnn_scope", lpips_fwd_bwd_default_ms=f"{scope_ms['default']:.4f}",
            lpips_fwd_bwd_scope_ms=f"{scope_ms['scope']:.4f}",
            cost_ms=f"{scope_ms['scope'] - scope_ms['default']:.4f}")

        # the fused signed distance: one step's losses against the default
        # on one batch, then 2 train steps of a trainer that runs it (the
        # shape regulariser's 2 queries; the warp's stays ericson_select)
        cfg = _human_config(out_dir, seed, name="fused", compute_dtype="float32")
        trainer = trainer_for(cfg, seed, ops=human.KERNELS_FUSED)
        batch = trainer.draw_batch(generator=torch.Generator(device).manual_seed(seed))
        anneals = human.compute_anneals(cfg, HUMAN_GRAD_ITERATION)
        both = []
        with torch.no_grad():
            for ops in (human.KERNELS, human.KERNELS_FUSED):
                fn = human.make_human_loss_fn(trainer.model, cfg, trainer.ctx, ops=ops)
                aux = fn(batch, torch.Generator(device).manual_seed(seed + 1), anneals)[1]
                both.append(torch.stack([aux["losses"][k] for k in human.LOSS_NAMES]))
        loss_err = (both[0] - both[1]).abs().max().item()
        for fn in counters.values():
            fn.launches = 0
        fused_losses = torch.stack([trainer.train_step()["total_loss"] for _ in range(2)])
        torch.cuda.synchronize()
        fused_launches = {k: fn.launches for k, fn in counters.items()}
        ok = (loss_err <= FUSED_LOSS_ATOL and bool(both[0][LOSS_NAMES_SHAPE] != 0)
              and bool(torch.isfinite(fused_losses).all())
              and all(fused_launches[k] == v for k, v in FUSED_LAUNCHES.items()))
        log("human_fused_sd", dtype="float32", loss_max_abs_err=f"{loss_err:.3e}",
            smpl_shape_reg=f"{both[1][LOSS_NAMES_SHAPE].item():.6f}",
            launches_2_steps=json.dumps(fused_launches, separators=(",", ":")), ok=ok)
        if not ok:
            raise RuntimeError("human step with the fused signed distance: the losses differ from "
                               "the default's, or the signed kernel was not launched")
        results["fused_launches"] = {k: {"human_2_steps_fused_sd": v}
                                     for k, v in fused_launches.items()}

        # checkpoint.npz round trip: a resumed trainer holds the same state
        trainer.save_model()
        resumed = trainer_for(dataclasses.replace(cfg, resume=True).finalize(), seed + 1)
        a, b = trainer.state, resumed.state
        same = (a["iteration"] == b["iteration"]
                and torch.equal(a["opt_state"]["count"], b["opt_state"]["count"]))
        for (n, p), (_, q) in zip(trainer.model.state_dict().items(),
                                  resumed.model.state_dict().items()):
            same = same and torch.equal(p, q)
        for m in ("mu", "nu"):
            for g, ps in a["opt_state"][m].items():
                for n, v in ps.items():
                    same = same and torch.equal(v, b["opt_state"][m][g][n])
        log("human_checkpoint", iteration=b["iteration"], identical=same, ok=same)
        if not same:
            raise RuntimeError("checkpoint.npz round trip changed the human trainer's state")
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def phase_human_mlp(model, spec, device, seed):
    """The nerf_mlp pair at the human step's batched canonical application,
    per-sample rotate R=6144 x S=128 (786,432 samples, 24 tape chunks), and
    at the sparsity rays' per-ray R=128 x S=128: forward and backward against
    the plain versions at phase 6's tolerances, in f32."""
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
    from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp

    gen = torch.Generator().manual_seed(seed + 6)
    jspec, net = spec.human, model.coarse_human_net.nerf
    for mode, r, s in (("per_sample", 4 * OFFSET_RAYS, OFFSET_SAMPLES), ("per_ray", 128, 128)):
        planes = [(torch.rand(r, s, generator=gen) * 3 - 1.5).to(device) for _ in range(3)]
        cot = [torch.randn(r, s, generator=gen).to(device) for _ in range(4)]
        if mode == "per_sample":
            d = torch.randn(3, r, s, generator=gen)
            kw = {"dir_planes": [x.contiguous() for x in (d / d.norm(dim=0, keepdim=True)).to(device)]}
        else:
            d = torch.randn(r, 3, generator=gen)
            kw = {"dir_part": kmlp.dir_projection(jspec, net, (d / d.norm(dim=1, keepdim=True)).to(device))}
        f_err, f_scale = _fwd_compare(jspec, net, planes, kw, torch.float32)[:2]
        args = (jspec, net, *planes, cot[0], cot[1:])
        got = _flat_grads(kvjp.nerf_mlp_bwd(*args, **kw))
        ref = _flat_grads(kvjp.nerf_mlp_bwd_plain(*args, **kw))
        torch.cuda.synchronize()
        rel = max((a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
                  for a, c in zip(got, ref))
        ok = _fwd_ok(f_err, f_scale, "f32") and rel <= BWD_F32_REL
        log("human_mlp", mode=mode, pe=jspec.pos_pe.mapping, dtype="f32", R=r, S=s,
            fwd_max_abs_err=f"{f_err:.3e}", bwd_max_rel_err=f"{rel:.3e}", ok=ok)
        del got, ref
        torch.cuda.empty_cache()
        if not ok:
            raise RuntimeError(f"nerf_mlp pair at the human step's {mode} shape disagrees with plain")


def _tape_cases(model, spec, device, gen):
    """(name, R, S, net spec, make(dtype) -> (forward of a given function
    with or without the tape, the kernel, its plain version, backward given
    a tape or None and optionally the function, the plain backward,
    flatteners of the backward's and the forward's outputs),
    bound(dtype, backward=) with the tape) of each fused MLP at its
    train-step shape."""
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
    from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
    from neuman_tpu_torch.ops.kernels import offset_mlp as koff

    rand = lambda r, s: (torch.rand(r, s, generator=gen) * 3 - 1.5).to(device)
    for mode, r, s in (("per_ray", BWD_RAYS, 256), ("per_sample", 4 * OFFSET_RAYS, OFFSET_SAMPLES)):
        per_sample = mode == "per_sample"
        jspec, net = ((spec.human, model.coarse_human_net.nerf) if per_sample
                      else (spec.bkg, model.coarse_bkg_net.nerf))
        planes = [rand(r, s) for _ in range(3)]
        cot = [torch.randn(r, s, generator=gen).to(device) for _ in range(4)]
        d = torch.randn(3, r, s, generator=gen) if per_sample else torch.randn(r, 3, generator=gen)
        d = (d / d.norm(dim=0 if per_sample else 1, keepdim=True)).to(device)

        def make(dtype, jspec=jspec, net=net, planes=planes, cot=cot, d=d, per_sample=per_sample):
            kw = ({"dir_planes": [x.contiguous() for x in d]} if per_sample
                  else {"dir_part": kmlp.dir_projection(jspec, net, d, dtype)})
            fwd = lambda fn, tape=True: fn(jspec, net, *planes, compute_dtype=dtype,
                                           emit_tape=tape, **kw)
            bwd = lambda tape, fn=kvjp.nerf_mlp_bwd: fn(jspec, net, *planes, cot[0], cot[1:],
                                                        compute_dtype=dtype, tape=tape, **kw)
            flat_out = lambda out: torch.stack([out[0], *out[1]])
            return (fwd, kmlp.nerf_mlp, kmlp.nerf_mlp_plain, bwd, kvjp.nerf_mlp_bwd_plain,
                    _flat_grads, flat_out)

        bound = functools.partial(mlp_bound, jspec, net, per_sample, r, s, tape=True)
        yield f"nerf_mlp {mode}", r, s, jspec.nerf, make, bound
    r, s = OFFSET_RAYS, OFFSET_SAMPLES
    ospec, onet = spec.offset, model.offset_nets[0].nerf
    axes = [rand(r, s) for _ in range(3)] + [torch.full((r, s), 0.37, device=device)]
    ocot = [torch.randn(r, s, generator=gen).to(device) for _ in range(3)]

    def make_offset(dtype):
        fwd = lambda fn, tape=True: fn(ospec, onet, axes, dtype, emit_tape=tape)
        bwd = lambda tape, fn=koff.offset_mlp_bwd: fn(ospec, onet, axes, ocot, dtype, tape=tape)
        flat = lambda out: [t for wb in out[0] for t in wb] + list(out[1])
        return (fwd, koff.offset_mlp, koff.offset_mlp_plain, bwd, koff.offset_mlp_bwd_plain, flat,
                torch.stack)

    bound = lambda dtype, backward: offset_bound(ospec, onet, r * s, dtype, backward, tape=True)
    yield "offset_mlp", r, s, ospec.nerf, make_offset, bound


def phase_tape(model, spec, device, seed):
    """The `mlp_tape="hbm"` configuration of the four fused-MLP kernels at
    the train steps' shapes. The tape-writing forward against its plain
    version: outputs and tape at phase 3's tolerances (f32: another
    summation order, 1e-3; bf16: 5e-2 of the largest value, a value on a
    rounding boundary lands on either side). The backward with the tape
    against the backward that recomputes the trunk: every weight gradient,
    d_planes / d_axes and d_dir bit-identical (`torch.equal`), because the
    forward kernel's trunk is the chain pass's arithmetic. Under
    torch.no_grad() the Function writes no tape."""
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp

    gen = torch.Generator().manual_seed(seed + 7)
    results, failed = {}, []
    for name, r, s, nspec, make, bound in _tape_cases(model, spec, device, gen):
        for dtype in (torch.float32, torch.bfloat16):
            dname = "f32" if dtype == torch.float32 else "bf16"
            fwd, kernel, plain, bwd, bwd_plain, flat, flat_out = make(dtype)
            out_k, tape = fwd(kernel)
            out_p, tape_p = fwd(plain)
            torch.cuda.synchronize()
            out_k, out_p = flat_out(out_k), flat_out(out_p)
            f_err, f_scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
            # the tape in pieces: a whole-tape float copy would double 8.6 GB
            t_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(tape.split(65536), tape_p.split(65536)))
            t_scale = max(b.float().abs().max().item() for b in tape_p.split(65536))
            shape_ok = (tape.dtype == dtype and tuple(tape.shape) == (r * s, nspec.depth * nspec.width))
            del tape_p, out_p
            torch.cuda.empty_cache()
            fwd_ok = _fwd_ok(f_err, f_scale, dname) and _fwd_ok(t_err, t_scale, dname) and shape_ok
            taped, recomputed = flat(bwd(tape)), flat(bwd(None))
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(taped, recomputed))
            finite = all(bool(torch.isfinite(a).all()) for a in taped)
            del taped, recomputed
            torch.cuda.empty_cache()
            times = {"fwd": cuda_ms(lambda: fwd(kernel, False), iters=3, warmup=1),
                     "fwd_tape": cuda_ms(lambda: fwd(kernel), iters=3, warmup=1),
                     "bwd": cuda_ms(lambda: bwd(None), iters=3, warmup=1),
                     "bwd_tape": cuda_ms(lambda: bwd(tape), iters=3, warmup=1),
                     "fwd_tape_plain": cuda_ms(lambda: fwd(plain), iters=2, warmup=1),
                     "bwd_tape_plain": cuda_ms(lambda: bwd(tape, bwd_plain), iters=2, warmup=1)}
            tape_gb = tape.numel() * tape.element_size() / 1e9
            (fb_ms, fb_by), (bb_ms, bb_by) = bound(dname, backward=False), bound(dname, backward=True)
            ok = fwd_ok and equal and finite
            log("tape", kernel=name, dtype=dname, R=r, S=s, fwd_max_abs_err=f"{f_err:.3e}",
                tape_max_abs_err=f"{t_err:.3e}", tape_scale=f"{t_scale:.3f}", fwd_ok=fwd_ok,
                grads_bit_identical_to_recompute=equal, tape_gb=f"{tape_gb:.3f}",
                **{f"{k}_ms": f"{v:.3f}" for k, v in times.items()},
                fwd_tape_bound_ms=f"{fb_ms:.3f}", fwd_tape_bound_by=fb_by,
                bwd_tape_bound_ms=f"{bb_ms:.3f}", bwd_tape_bound_by=bb_by, ok=ok)
            if not ok:
                failed.append(f"{name} {dname}")
            results[(name, dname)] = (times, tape_gb)
            del tape
            torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"tape configuration: a forward disagrees with its plain version or a "
                           f"gradient with recompute: {failed}")

    # no tape under torch.no_grad(): the Function allocates none
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
    jspec, net = spec.bkg, model.coarse_bkg_net.nerf
    r, s = 1024, 128
    planes = [(torch.rand(r, s, generator=gen) * 3 - 1.5).to(device) for _ in range(3)]
    dirp = kmlp.dir_projection(jspec, net, torch.randn(r, 3, generator=gen).to(device))
    tape_bytes = r * s * jspec.nerf.depth * jspec.nerf.width * 4
    net.requires_grad_(True)
    peaks = {}
    try:
        for label, ctx in (("no_grad", torch.no_grad()), ("grad", torch.enable_grad())):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with ctx:
                out = kvjp.nerf_mlp_fn(jspec, net, *planes, dir_part=dirp, tape_mode="hbm")
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() - base
            del out
    finally:
        net.requires_grad_(False)
    ok = peaks["no_grad"] < tape_bytes / 2 <= peaks["grad"]
    log("tape_no_grad", tape_mb=f"{tape_bytes / 1e6:.1f}",
        **{f"{k}_peak_mb": f"{v / 1e6:.1f}" for k, v in peaks.items()}, ok=ok)
    if not ok:
        raise RuntimeError("nerf_mlp_fn allocated a tape under torch.no_grad(), or none with grad")
    return results


def signed_bound(n, c, stride):
    """p3 [3, N], rows9 and cand [9C + C, N/stride] in; of vn9 only what
    the function needs, the nine normal components of each point's selected
    candidate; sd, face id, closest point [3, N] out; the region test for
    every candidate and the sign for the selected one."""
    groups = -(-n // stride)
    nbytes = 3 * n * 4 + 9 * c * groups * 4 + c * groups * 4 + 9 * n * 4 + 5 * n * 4
    return bound_ms((ERICSON_OPS_PER_TEST * c + SIGN_OPS_PER_POINT) * n, nbytes, "f32")


def phase_signed(verts, topo, seed):
    """`ericson_signed_select` at the human step's query, N=196,608 ray
    samples, C=24, stride 4 and 1, operands from the query tables and the
    bucketed KNN. Built with --fmad=false it runs the plain version's
    operations: sd and the closest point are held to it bit for bit, the face
    id outside ties; to `ericson_select` on the same operands bit for bit
    (|sd| = sqrt(d2), closest point, face id: one device function); its
    gradient to the plain Function's exactly. Against the unfused signed
    distance (ericson_select + the sign in PyTorch, the same operations on
    the same values) the signs may differ only where the unfused
    |(p - closest) . n| <= 1e-6; those points are counted. Timed: the two
    kernels and the plain version on the same operands, and the whole query
    (`signed_distance`) fused and unfused."""
    import torch
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.ops.kernels import meshquery as kmq

    gen = torch.Generator().manual_seed(seed + 8)
    pts = _ray_samples(verts, SIGNED_RAYS, SIGNED_SAMPLES, gen)
    tables = mesh_ops.build_query_tables(verts, topo)
    results = {}
    for stride in (4, 1):
        kw = dict(k=4, knn_stride=stride, knn_impl="bucketed", tables=tables)
        p3, rows9, vn9, cand, st = mesh_ops.candidate_operands(pts, verts, topo, normals=True, **kw)
        run_k = lambda: kmq.ericson_signed_select(p3, rows9, vn9, cand, st)
        run_p = lambda: kmq.ericson_signed_select_plain(p3, rows9, vn9, cand, st)
        run_u = lambda: kmq.ericson_select(p3, rows9, cand, st)
        (sd, f_id, cp), (psd, pf, pcp), (d2, uf, ucp) = run_k(), run_p(), run_u()
        torch.cuda.synchronize()
        cp, pcp, ucp = torch.stack(cp), torch.stack(pcp), torch.stack(ucp)
        err = max((sd - psd).abs().max().item(), (cp - pcp).abs().max().item())
        plain_equal = torch.equal(sd, psd) and torch.equal(cp, pcp)
        diff = f_id != pf
        ties_only = bool((kmq.tie_gap(p3, rows9, cand, st)[diff] <= MESH_ATOL).all())
        unsigned_equal = (torch.equal(sd.abs(), torch.sqrt(d2.clamp(min=0)))
                          and torch.equal(cp, ucp) and torch.equal(f_id, uf))
        # the unfused tail on the unsigned kernel's outputs
        side = mesh_ops.pseudonormal_side(pts, verts, topo, uf, tuple(ucp), tables)
        flips = (side < 0) != (sd < 0)
        excused = bool((side.abs()[flips] <= SIGN_DOT_ATOL).all())
        inside = (sd < 0).float().mean().item()
        # gradient: kernel Function against the plain Function
        g = torch.randn(sd.shape, generator=gen).to(sd.device)
        grads = []
        for plain in (False, True):
            q = p3.clone().requires_grad_(True)
            out = kmq.ericson_signed_select(q, rows9, vn9, cand, st, plain=plain)[0]
            grads.append(torch.autograd.grad((out * g).sum(), q)[0])
        grad_equal = torch.equal(*grads)
        del grads, psd, pcp
        full = lambda fused: mesh_ops.signed_distance(pts, verts, topo, fused=fused, **kw)
        times = {"kernel": cuda_ms_min(run_k), "unsigned_kernel": cuda_ms_min(run_u),
                 "plain": cuda_ms(run_p, iters=3, warmup=1),
                 "query_fused": cuda_ms(lambda: full(True)),
                 "query_unfused": cuda_ms(lambda: full(False))}
        b_ms, b_by = signed_bound(pts.shape[0], cand.shape[0], st)
        ok = (plain_equal and ties_only and unsigned_equal and excused and grad_equal
              and bool(torch.isfinite(sd).all()) and 0.05 < inside < 0.95)
        log("ericson_signed", N=pts.shape[0], C=cand.shape[0], stride=st,
            max_abs_err=f"{err:.3e}", bit_equal_plain=plain_equal, f_id_diff=int(diff.sum()),
            bit_equal_ericson_select=unsigned_equal, sign_flips_vs_unfused=int(flips.sum()),
            flips_within_dot_bound=excused, grad_bit_equal_plain=grad_equal,
            inside_share=f"{inside:.4f}", **{f"{k}_ms": f"{v:.3f}" for k, v in times.items()},
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, ok=ok)
        if not ok:
            raise RuntimeError(f"ericson_signed_select stride {st}: kernel disagrees")
        results[st] = (err, times["kernel"], times["plain"], b_ms, b_by)
    return results


def phase_renders(model, spec, body, device, seed):
    """The human-only and multi-person frames at 270x480 in bf16 through the
    kernels, each against the same renderer on the plain path (>= 40 dB, the
    repo's image-parity bar; the MLP paths differ in their last bits, as in
    phase 5): `render_smpl_nerf` of the posed body and of the canonical body
    (render_can: no warp, per-ray directions), and
    `render_hybrid_nerf_multi_persons` with the body twice, the second copy
    0.8 to the side. Each render path's launches are counted from 0."""
    import torch
    from neuman_tpu_torch.models import smpl
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.render import renderer

    counters = _kernel_counters()
    gen = torch.Generator().manual_seed(seed + 2)
    pose = torch.zeros(1, 72)
    pose[0, 3:] = torch.randn(69, generator=gen) * 0.1
    verts, ts = smpl.da_pose_to_scene(body, pose.to(device), torch.zeros(1, 10, device=device))
    topo = mesh_ops.MeshTopology.build(body.faces, len(verts), device)
    c2w = [[1.0, 0, 0, 0], [0, -1.0, 0, 0], [0, 0, -1.0, 3.0], [0, 0, 0, 1.0]]
    h, w = FRAME_HW
    cap = Capture(h, w, 380.0 * w / 480, c2w, near=0.5, far=6.0)
    kw = {k: v for k, v in RENDER.items() if k != "importance_samples_per_ray"}
    shift = torch.tensor([0.8, 0.0, 0.0], device=device)
    ts2 = ts.clone()
    ts2[:, :3, 3] += shift
    frames = {
        "smpl_posed": lambda use: renderer.render_smpl_nerf(
            spec, model, cap, verts, body.faces, ts, device, topology=topo, use_kernels=use, **kw),
        "smpl_canonical": lambda use: renderer.render_smpl_nerf(
            spec, model, cap, body.v_template, body.faces, None, device, topology=topo,
            render_can=True, use_kernels=use, **kw),
        "multi_persons": lambda use: renderer.render_hybrid_nerf_multi_persons(
            spec, model, cap, [spec, spec], [model, model], [verts, verts + shift],
            [body.faces, body.faces], [ts, ts2], device, use_kernels=use, **RENDER),
    }
    launches = {}
    for name, render in frames.items():
        render(True)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = render(True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counters.items() if fn.launches}
        ref = render(False)
        torch.cuda.synchronize()
        psnr = -10.0 * math.log10(max(torch.mean((out[0] - ref[0]) ** 2).item(), 1e-20))
        # the share of pixels that show a body: opaque ones, or for the
        # composite those that differ from the background-only frame
        if name == "multi_persons":
            bkg_only = renderer.render_vanilla(
                spec.bkg, model.coarse_bkg_net.nerf, cap, model.fine_bkg_net.nerf, device,
                **{k: RENDER[k] for k in ("rays_per_batch", "samples_per_ray",
                                          "importance_samples_per_ray")})
            shown = ((out[0] - bkg_only).abs().amax(-1) > 1e-2).float().mean().item()
        else:
            shown = (out[2] > 0.5).float().mean().item()
        expect = ("nerf_mlp",) if name == "smpl_canonical" else ("nerf_mlp", "ericson_select")
        ok = (tuple(out[0].shape) == (h, w, 3) and all(bool(torch.isfinite(t).all()) for t in out)
              and psnr >= FRAME_MIN_PSNR and shown > 0.01
              and all(launches[name].get(k, 0) > 0 for k in expect))
        log("render", frame=name, H=h, W=w, dtype="bf16", sec_per_frame=f"{sec:.3f}",
            psnr_vs_plain=f"{psnr:.2f}", body_fraction=f"{shown:.4f}",
            launches=json.dumps(launches[name], separators=(",", ":")), ok=ok)
        if not ok:
            raise RuntimeError(f"render {name}: not finite, under the PSNR bar, no body in the "
                               f"frame, or a kernel was not launched")
    return launches


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


def phase_human(model, spec, body, device, seed):
    phase_human_mlp(model, spec, device, seed)
    return phase_human_step(body, device, seed)


PHASES = ("mlp", "mesh", "slice", "bwd", "train", "offset", "knn", "human", "tape", "signed",
          "renders")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phase in {phases}")

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

    run = {
        "mlp": lambda: phase_mlp(model, spec, device, args.seed),
        "mesh": lambda: phase_mesh(body.v_template, topo, args.seed),
        "slice": lambda: phase_slice(model, spec, body, device, args.seed),
        "bwd": lambda: phase_bwd(model, spec, device, args.seed),
        "train": lambda: phase_train(device, args.seed),
        "offset": lambda: phase_offset(model, spec, device, args.seed),
        "knn": lambda: phase_knn(body.v_template, args.seed),
        "human": lambda: phase_human(model, spec, body, device, args.seed),
        "tape": lambda: phase_tape(model, spec, device, args.seed),
        "signed": lambda: phase_signed(body.v_template, topo, args.seed),
        "renders": lambda: phase_renders(model, spec, body, device, args.seed),
    }
    out = {name: run[name]() for name in PHASES if name in phases}
    device_line = {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}
    if set(phases) != set(PHASES):
        print(json.dumps({**device_line, "phases": phases}), flush=True)
        return 0
    mlp, mesh, launches, bwd, train = (out[k] for k in ("mlp", "mesh", "slice", "bwd", "train"))
    offset, knn, human, signed, renders = (out[k] for k in ("offset", "knn", "human", "signed",
                                                            "renders"))

    # timings: nerf_mlp the render path's bf16 per-ray case (phase 3),
    # ericson_select stride 4 (phase 4), nerf_mlp_bwd the fine pass of the
    # f32 background step (phase 6), offset_mlp and offset_mlp_bwd the f32
    # human step's shape and bucketed_knn its 49,152 groups (phase 8),
    # ericson_signed_select the human step's stride-4 query (phase 11).
    # launches: the sum over the main paths, each counted from 0 in its own
    # run and listed in launches_by_path: one hybrid frame (phase 5), the
    # f32 background train path (phase 7) split into train_background (2
    # steps, 2 validations) and the 20 timed steps, in both tape
    # configurations, the f32 human train path (phase 9) split likewise, its
    # 2 steps with the fused signed distance, and the three frames of phase
    # 12. No single PyTorch call computes any of the seven functions.
    def entry(name, source, replaces, by_path, max_abs_err, timing):
        ms, plain_ms, b_ms, b_by = timing
        return {"name": name, "route": "cuda", "source": f"neuman_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": max_abs_err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    def by_path(name):
        paths = {"render_frame": launches.get(name, 0)}
        for key, run in (("", train.get("float32")), ("hbm_", train.get("float32_hbm")),
                         ("", human["float32"]), ("hbm_", human["float32_hbm"])):
            paths.update({key + k: v for k, v in run[1].get(name, {}).items()})
        paths.update(human["fused_launches"].get(name, {}))
        paths.update({f"render_{frame}": counts.get(name, 0) for frame, counts in renders.items()})
        return {k: v for k, v in paths.items() if v}

    kernels = [
        entry("nerf_mlp", "nerf_mlp", "neuman_tpu/ops/pallas/raymarch.py:105", by_path("nerf_mlp"),
              max(mlp[(m, "bf16")][0] for m in ("per_ray", "per_sample")),
              mlp[("per_ray", "bf16")][1:]),
        entry("ericson_select", "ericson_select", "neuman_tpu/ops/pallas/meshquery.py:314",
              by_path("ericson_select"), max(r[0] for r in mesh.values()), mesh[4][1:]),
        entry("nerf_mlp_bwd", "nerf_mlp_bwd", "neuman_tpu/ops/pallas/raymarch_vjp.py:76",
              by_path("nerf_mlp_bwd"), bwd[("per_ray", 256, "f32")][0],
              bwd[("per_ray", 256, "f32")][1:]),
        entry("offset_mlp", "offset_mlp", "neuman_tpu/ops/pallas/raymarch_vjp.py:506",
              by_path("offset_mlp"), offset["f32"]["fwd"][0], offset["f32"]["fwd"][1:]),
        entry("offset_mlp_bwd", "offset_mlp_bwd", "neuman_tpu/ops/pallas/raymarch_vjp.py:620",
              by_path("offset_mlp_bwd"), offset["f32"]["bwd"][0], offset["f32"]["bwd"][1:]),
        entry("bucketed_knn", "bucketed_knn", "neuman_tpu/ops/pallas/meshquery.py:427",
              by_path("bucketed_knn"), max(r[0] for r in knn.values()), knn[KNN_QUERIES[0]][1:]),
        entry("ericson_signed_select", "ericson_select", "neuman_tpu/ops/pallas/meshquery.py:191",
              by_path("ericson_signed_select"), max(r[0] for r in signed.values()), signed[4][1:]),
    ]
    if any(k["launches"] == 0 for k in kernels):
        raise RuntimeError("a kernel was launched on no main path: "
                           + ", ".join(k["name"] for k in kernels if not k["launches"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps(device_line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
