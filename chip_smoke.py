#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (neuman_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--seed N] [--phases mlp,mesh,...]

Phases, one line each; any failure ends the run with a non-zero exit:
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: nvcc builds the six kernel libraries (seven kernels) from
     neuman_tpu_torch/csrc/ (sm_90a), all started together; then each
     kernel of the nerf_mlp and offset_mlp pairs (all on mlp_hopper.cuh),
     of bucketed_knn and of ericson_select with its registers, spill bytes,
     stack and static shared memory (ptxas -v) and the dynamic shared
     memory it launches with;
  3. mlp: nerf_mlp kernel vs its plain PyTorch version at full width (8x256,
     PE 10 + 4 bands), R=1024 x S=64: per-ray posenc and per-sample
     rotate, f32 and bf16;
  4. mesh: ericson_select kernel vs its plain version, N=65,536 ray samples
     on the body-proxy mesh (V=10,242), k=4, stride 1 and 4, and the human
     step's N=196,608, stride 4 and 1;
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
     indices outside score ties, each index carrying its score; the first
     pick an exact nearest vertex up to a tie, the recall of the exact top
     k printed), on integer grids full of exact ties at V=10,242 and 40,962
     (indices and scores equal) and on ray samples at V=40,962 (a table
     over the shared-memory budget);
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
     distance against the default, 2 train steps with it, and the median of
     10 bf16 steps with it and with the default;
 10. tape: at the shapes of phases 6, 8 and 9 (R=4096 x S=256 per-ray,
     R=6144 x S=128 per-sample, the offset net's R=1536 x S=128; f32 and
     bf16) the tape-writing forwards vs their plain versions (outputs and
     tape) and the backwards with the tape vs recompute (every gradient
     bit-identical); times of both configurations and the tape's bytes; no
     tape under torch.no_grad();
 11. signed: ericson_signed_select (the table kernel) vs its plain
     version, vs the planar plain version and ericson_select on the same
     candidates and vs the unfused signed distance at N=196,608, C=24,
     stride 4 and 1, on the query tables and the bucketed KNN's knn_idx;
     its gradient; times of the kernel and of the fused and unfused
     queries;
 12. renders: a 270x480 render_smpl_nerf frame, canonical and posed, and a
     two-actor render_hybrid_nerf_multi_persons frame, bf16, kernels vs the
     plain path;
 13. cli: the command line on a scene directory. tools/synthetic_scene.py
     writes a 10-frame 270x480 scene with the body proxy at subdivision 5,
     its spine rigged as SMPL's (rig_body_proxy: the hip bone that sets the
     automatic geo_threshold ~6% of the height), as SMPL_NEUTRAL.pkl;
     NeuManReader.read_scene reads it back (images,
     masks and depths equal to what was written; its time printed); then
     train.main runs stage 1 (--train_mode bkg) and stage 2
     (--train_mode smpl_and_offset --load_background <stage 1>), each for
     --max_iter 2 at the default flags (the launch counts reset just before
     each), and 5 more steps of each stage's trainer are timed. Checked:
     the kernels of each stage were launched, every loss is finite,
     checkpoint.npz, params.json and metrics.jsonl (with validation
     records) were written, and the validation PNGs decode;
 14. render_cli: the render command lines on phase 13's scene and stage-2
     checkpoint, from a temporary working directory, at the render
     defaults and 270x480: render_test_views.main (the split's test view,
     scored with LPIPS weights drawn from --seed and written in the JAX
     layout), render_360.main --mode canonical_360 and posed_360 (4
     cameras each), render_reposing.main on a 4-frame motion
     (--mocap_path), render_gathering.main --actors seattle citron (the
     checkpoint and fits laid out where the script looks for them, 4
     frames of its preset motion). For each: the frames, the median
     s/frame (each renderer call between two synchronises), the share of
     rays within geo_threshold of the body, the launches counted from 0
     (nerf_mlp in all five, ericson_select in the four that warp), every
     PNG read back at 270x480; the test view also through the plain
     versions (--use_pallas false), >= 40 dB against the kernels' PNG.
     --phases render_cli runs phase 13 first;
 15. preprocess: stages 9 and 10 on a synthetic video's outputs
     (tools/synthetic_scene.write_preprocess_inputs: COLMAP text with a
     ground plane, ROMP npz files, keypoints, DensePose labels and masks of
     4 frames at 270x480, the rigged proxy at subdivision 5): run_alignment
     (its alignments against the scene's truth) and run_optimize_smpl with
     20 steps a frame (the mapped joints' keypoint error lowered), both
     outputs read back, each stage's seconds; one frame's refinement at
     1280x720 (stride 4, F=20,480): ms per step by CUDA events over 5
     steps after 2, peak GiB, ms per frame at 100 steps; one step's loss
     and gated pose gradient on the card against the CPU (270x480, the
     subdivision-3 proxy). No kernel of the port runs here: the
     rasteriser is plain PyTorch. Every line carries the card's name and
     power limit;
 16. parallel: data parallelism and the NeRF-T ablation. (a)
     parallel.dryrun on two gloo ranks on the one card (NCCL cannot put
     two ranks of one group on one GPU): 2 f32 steps of each stage at the
     defaults (4096 rays, 128 + 128 samples; 1536 rays, LPIPS on with its
     patch over both ranks' rows, V=10,242) against the same steps in this
     process: the losses, the step-1 gradients, the parameters (the ranks'
     equal), each rank's launches; (b) train.main --data_parallel on under
     the torchrun environment (NCCL at world size 1) on phase 13's scene,
     both stages for 2 steps, then 5 steps a turn with and without the
     mesh on the one trainer: what the mesh costs a step; (c) stage 1 with
     --ablate_nerft true --raw_pos_dim 4 (the plain net, as in the JAX
     package): ms/step, peak GiB, the validation PNG, the step-1 loss
     against the CPU's. --phases parallel runs phase 13 first. Every line
     carries the card's name and power limit;
 17. envelope: the quick subset of the kernel shape sweep
     (neuman_tpu_torch/tools/sweep_kernel_envelope.py --quick), at the
     shapes a real SMPL mesh gives (vertices of degree 9, V=6,890):
     ericson_select at C=36 and 72 (N=262,144, stride 1), the signed table
     kernel at C=36 (a degree-9 mesh, k=4, N=196,608, strides 1 and 4),
     bucketed_knn at Nq=196,608, V=6,890, k=8 and nerf_mlp at R=1536 x
     S=16 in both direction modes, bf16; each held to its plain version at
     the bars of phases 3, 4, 8 and 11, one JSON line a case;
 18. render_parallel: rendering on N ranks. (a) parallel.dryrun's render
     job on two gloo ranks on the one card: each of phase 14's five
     render command lines renders two frames (two cameras, two motion
     frames; the test view its one, last) of phase 13's scene and
     checkpoint at 270x480 and the render defaults, each chunk's rays
     split over the ranks, against the same command line in this
     process: the frames within the JAX package's sharded-render bars
     (rgb 1e-5; depth 1e-4 for the multi-person render, 1e-5 for the
     others) and whether they are bit-equal, both ranks holding the
     frame, rank 0 alone writing the PNGs (the same bytes as one
     process's), the same scores on every rank; each rank's s/frame (the
     last frame's), rays through the human branch and launches (nerf_mlp
     on every rank, ericson_select on every rank with hits where the
     command line warps); (b) render_test_views.main --data_parallel on
     under the torchrun environment (NCCL at world size 1): its scores
     equal one process's. --phases render_parallel runs phase 13 first.
     Every line carries the card's name and power limit;
 19. bench: the port's benchmark (`python -m neuman_tpu_torch.bench`) in
     this process at bench.py's shapes with --iters 3 --train_iters 3 (the
     bench path; launch counts reset just before it): its card line and JSON
     line printed, every key a finite number and "kernels" "compiled";
     nerf_mlp at the render chunk's shapes (32,768 rays, the coarse call at
     S=128 and the fine at S=256, per-ray, bf16, the bench's nets and rays)
     against its plain version run over 4,096 rays at a time; then
     --break-stage render at --rays 1024 with the render alone (null keys,
     "failed:render:RuntimeError", exit code 1) and `bench_step_parts query`
     (the signed-distance query's six forms at N=196,608).
Then one JSON line of per-kernel results (`ms` by CUDA events around the
wrapper's calls; for the three mesh kernels also `device_ms`, the kernel's
own time by torch.profiler, else null; `launches_by_path` also lists phase
17's comparison launches as `envelope_quick`, which `launches` leaves
out), and last the device line.
--phases runs a subset (for work on one kernel); the contract is the run
with no arguments.

Weights are random (HumanNeRF and background nets from --seed); the body
is the numpy body-proxy SMPL model posed by LBS. Imports nothing of JAX.
"""

import argparse
import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
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
# the table over the shared-memory budget: the proxy at subdivision 6 (V = 40,962)
KNN_BIG_SUBDIVISIONS = 6
# query points of the integer-grid cases, where most scores tie exactly
KNN_TIE_QUERIES = 8192
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
# bf16 steps timed with KERNELS and with KERNELS_FUSED
FUSED_STEPS = 10
# a vertex score |v|^2 - 2 v.p: 3 multiplies and 3 adds
KNN_OPS_PER_SCORE = 6

# phase 13: the scene directory the command line trains on (10 frames, the
# fewest the 80/10/10 split takes with a test view), the steps of each
# stage's train.main run, and the steps timed on its trainer after it
CLI_FRAMES, CLI_HW = 10, (270, 480)
CLI_MAX_ITER = 2
CLI_TIMED_STEPS = 5
# flags added to both stages' command lines (none: the defaults)
CLI_FLAGS = ()
CLI_BKG_KERNELS = ("nerf_mlp", "nerf_mlp_bwd")
CLI_HUMAN_KERNELS = ("nerf_mlp", "nerf_mlp_bwd", "offset_mlp", "offset_mlp_bwd", "ericson_select",
                     "bucketed_knn")

# phase 14: the render command lines on phase 13's scene and stage-2
# checkpoint: 360 orbits of 4 cameras, a 4-frame motion for the reposing,
# two actors for the gathering (its preset takes mocap frames 0:800:4, so
# its motion has 13 frames, 4 of them rendered); flags added to every
# command line (none: the render defaults)
RENDER_CLI_TRAJECTORY = 4
RENDER_CLI_MOCAP_FRAMES = 4
RENDER_CLI_GATHER_MOCAP_FRAMES = 13
RENDER_CLI_ACTORS = ("seattle", "citron")
RENDER_CLI_FLAGS = ()
# the renderers the command lines call, each frame timed by wrapping them
RENDERERS = ("render_hybrid_nerf", "render_smpl_nerf", "render_hybrid_nerf_multi_persons")

# phase 15: preprocessing stages 9 and 10 on a synthetic video's outputs:
# (a) the whole pipeline, stage 10 at PRE_ITERS steps a frame; (b) one
# frame's refinement at the full 1280x720 (stride 4: 180x320 pixels) with
# the body proxy's F=20,480 faces, PRE_FULL_WARMUP + PRE_FULL_TIMED steps;
# (c) one step's loss and gated pose gradient on the card against the CPU
# at 270x480 with the subdivision-3 proxy (F=1,280)
PRE_FRAMES, PRE_HW, PRE_ITERS = 4, (270, 480), 20
PRE_FULL_HW, PRE_FULL_WARMUP, PRE_FULL_TIMED = (720, 1280), 2, 5
PRE_REFERENCE_ITERS = 100  # stage 10's steps a frame (run_optimize_smpl's default)
PRE_CPU_SUBDIVISIONS = 3
# stage 9's alignments against the scene's truth, each over its largest
# entry: EPnP is exact on the scene's clean projections, and the translation
# refinement's 1000 f32 Adam steps at lr 1e-3 end in a wobble of ~1e-3
PRE_ALIGN_REL = 1e-2
# card vs CPU, both f32 with TF32 off: the loss (relative) and the gated
# gradient's L2 error over its L2 norm, the port-vs-JAX bars of
# tests/test_torch_preprocess.py (sums of the same terms in other orders)
PRE_LOSS_REL, PRE_GRAD_REL = 1e-5, 1e-4

# phase 16: (a) PAR_WORLD gloo ranks on the one card against one process,
# PAR_STEPS f32 steps of each stage at the defaults (4096 and 1536 rays);
# each step's loss within PAR_LOSS_RTOL (the JAX package's sharded-vs-
# unsharded bar), the step-1 gradients within section 2's f32 bars, the
# ranks' parameters equal and, against one process, every element within
# PAR_PARAM_ABS_BAR and at most a PAR_PARAM_SHARE_BAR share of them over
# 1e-5 (dryrun.compare's atol). Measured on the H100: at most 1.3e-6 apart
# in the background stage, 1.07e-5 in the human one, where one element of
# 1.15 M was over 1e-5 (in its first steps Adam moves an element by ~lr
# whatever its gradient's size, which magnifies rounding where a gradient
# is near 0); the kernels each rank must launch.
# (b) train.main under NCCL at world size 1, 2 steps, then PAR_TIMED_STEPS
# steps a turn with and without the mesh. (c) NeRF-T stage 1: its step-1
# loss on the card against the CPU's
PAR_WORLD, PAR_STEPS, PAR_TIMED_STEPS = 2, 2, 5
PAR_SPAWN_TIMEOUT_S = 300.0
PAR_LOSS_RTOL = 1e-4
PAR_PARAM_ABS_BAR, PAR_PARAM_SHARE_BAR = 1e-4, 5e-6
PAR_KERNELS = {"bkg": CLI_BKG_KERNELS, "human": CLI_HUMAN_KERNELS}
PAR_NERFT_LOSS_REL = 1e-4

# phase 18: PAR_WORLD gloo ranks on the one card render RENDER_PAR_FRAMES
# frames of each render command line (the test view: its one) on phase 13's
# scene and checkpoint against one process, each frame within
# parallel.dryrun.RENDER_BARS (the JAX package's sharded-render bars); the
# test view last, so that each process's s/frame is its last frame's, after
# the first call's set-up (kernel libraries loaded, cuBLAS handles made);
# then render_test_views.main under NCCL at world size 1
RENDER_PAR_FRAMES = 2
RENDER_PAR_TIMEOUT_S = 300.0

# phase 19: the bench's timed calls of each section, and the JSON line's number keys
BENCH_ITERS = 3
BENCH_KEYS = ("value", "vs_baseline", "human_train_step_ms", "bkg_train_step_ms",
              "hybrid_render_ms", "hybrid_sec_per_frame", "hybrid_frame_hit_frac")
# nerf_mlp at the bench's render chunk is held to its plain version run over
# slices of this many rays (each ray is independent of the others; the
# plain version of the whole 8.4 M-sample fine pass does not fit in memory)
BENCH_PLAIN_SLICE = 4096

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


def device_ms(fn, kernel, iters=20):
    """Mean device time in ms a call of fn of the kernels whose name holds
    `kernel` (or one of a tuple of names: a wrapper that launches several),
    over `iters` calls, by torch.profiler: for the mesh kernels, whose
    wrappers' host time is longer than the kernel at these sizes, so that
    CUDA events around the calls time the host. Each kernel counts its mean
    time a launch times its launches a call (the profiler may miss a launch
    of a window: 4 of 5 seen on the H100). Raises if the profiler saw no
    device time of those kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        time_us = getattr(e, "device_time_total", 0) or 0
        if time_us and e.count and any(n in e.key for n in names):
            total += time_us / e.count * max(1, round(e.count / iters))
    if not total:
        raise RuntimeError(f"torch.profiler saw no device time of {kernel}")
    return total / 1e3


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


def knn_bound(nq, num_verts, k=KNN_K):
    """Points in, vertices in, k indices and scores out; a score for every
    (point, vertex)."""
    return bound_ms(KNN_OPS_PER_SCORE * nq * num_verts,
                    3 * nq * 4 + 3 * num_verts * 4 + 2 * k * nq * 4, "f32")


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
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    log("card", name=torch.cuda.get_device_name(0), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    return line


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
    # the mesh kernels, every instantiation (bucketed_knn: 4 points a thread
    # for k <= 4, else 2; its dynamic shared memory the resident table of the
    # main path's body)
    knn_smem = knn.knn_plan(KNN_QUERIES[0], 10 * 4 ** BODY_SUBDIVISIONS + 2, KNN_K, 132)
    for lib in ("bucketed_knn", "ericson_select"):
        for fn, res in sorted(_build.kernel_resources(lib).items()):
            kernel, args = _mesh_kernel_name(fn)
            if kernel is None or "registers" not in res:
                continue
            if res.get("spill_stores", 0) or res.get("spill_loads", 0):
                spills.append(f"{lib}:{kernel}<{','.join(map(str, args))}>")
            names = {"bucketed_knn_kernel": ("queries", "k"), "ericson_select_kernel": ("members",),
                     "ericson_signed_select_kernel": ("members", "knn_idx")}
            log("ptxas", library=lib, kernel=kernel,
                **dict(zip(names.get(kernel, ()), args)), registers=res["registers"],
                spill_stores=res.get("spill_stores", 0), spill_loads=res.get("spill_loads", 0),
                stack=res.get("stack", 0), static_smem=res.get("static_smem", 0),
                dynamic_smem=knn_smem["smem_bytes"] if lib == "bucketed_knn" else 0)
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


def _mesh_kernel_name(mangled):
    """(kernel, template arguments: ints, then "int32" / "int64" for an
    index type) of a mangled mesh-query kernel name, or (None, ()) for
    another function."""
    import re

    m = re.search(r"(bucketed_knn_kernel|ericson_signed_select_kernel|ericson_select_kernel)"
                  r"(I((?:Li\d+E)*)([ix]?)E)?", mangled)
    if m is None:
        return None, ()
    args = tuple(int(x) for x in re.findall(r"Li(\d+)E", m.group(3) or ""))
    return m.group(1), args + ((("int32" if m.group(4) == "i" else "int64"),) if m.group(4) else ())


def _fwd_compare(spec, net, planes, kw, dtype):
    """nerf_mlp kernel vs its plain version on one input: (max abs error,
    output scale, kernel call, plain call)."""
    import torch
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp

    run_k = lambda: kmlp.nerf_mlp(spec, net, *planes, compute_dtype=dtype, **kw)
    run_p = lambda: kmlp.nerf_mlp_plain(spec, net, *planes, compute_dtype=dtype, **kw)
    (ks, krgb), (ps, prgb) = run_k(), run_p()
    if ks.is_cuda:
        torch.cuda.synchronize()
    out_k = torch.stack([ks, *krgb])
    out_p = torch.stack([ps, *prgb])
    if not torch.isfinite(out_k).all():
        raise RuntimeError(f"nerf_mlp {dtype}: non-finite kernel output")
    return (out_k - out_p).abs().max().item(), out_p.abs().max().item(), run_k, run_p


def _fwd_ok(err, scale, name):
    """The tolerances of phase_mlp."""
    return err <= MLP_F32_ATOL if name == "f32" else err <= MLP_BF16_REL * scale


def hold_offset_fwd(out_k, out_p, name):
    """offset_mlp's stacked outputs [3, R, S] against its plain version's:
    (fields, ok). phase_mlp's tolerances, finite, and a spread over the
    rays (a net that ignores its input would show none)."""
    import torch

    err, scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
    std = out_k.std(dim=1).min().item()
    ok = bool(torch.isfinite(out_k).all()) and std > 0 and _fwd_ok(err, scale, name)
    return {"fwd_max_abs_err": err, "fwd_out_scale": scale, "fwd_out_std": std}, ok


def hold_grads(got, want, name):
    """A backward kernel's gradients against its plain version's, output by
    output: (fields, ok). f32: the largest error within BWD_F32_REL of the
    output's largest value; bf16: the L2 error within BWD_BF16_L2 of its L2
    norm (phase_bwd says why); every gradient finite."""
    import torch

    err = max((a - c).abs().max().item() for a, c in zip(got, want))
    rel = max((a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
              for a, c in zip(got, want))
    l2 = max(((a - c).norm() / c.norm().clamp_min(1e-30)).item() for a, c in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = finite and (rel <= BWD_F32_REL if name == "f32" else l2 <= BWD_BF16_L2)
    return {"max_abs_err": err, "max_rel_err": rel, "l2_rel_err": l2,
            "grad_scale": max(c.abs().max().item() for c in want)}, ok


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


def hold_closest(got, want, gap):
    """A mesh kernel's (dist, f_id, cp) against its plain version's on the
    same candidates: (fields, ok). dist (d2 or sd) and cp within MESH_ATOL,
    finite; a face id different only where `gap` (kmq.tie_gap: how far the
    plain choice's d2 lies from another candidate's) <= MESH_ATOL."""
    import torch

    (dist, f_id, cp), (pdist, pf, pcp) = got, want
    err = max((dist - pdist).abs().max().item(),
              max((a - b).abs().max().item() for a, b in zip(cp, pcp)))
    diff = f_id != pf
    ties_only = bool((gap[diff] <= MESH_ATOL).all())
    bit_equal = (torch.equal(dist, pdist) and torch.equal(f_id, pf)
                 and all(torch.equal(a, b) for a, b in zip(cp, pcp)))
    ok = err <= MESH_ATOL and ties_only and bool(torch.isfinite(dist).all())
    return {"max_abs_err": err, "f_id_diff": int(diff.sum()), "f_id_diff_ties_only": ties_only,
            "bit_equal_plain": bit_equal}, ok


def phase_mesh(verts, topo, seed):
    """Built with --fmad=false the kernel runs the same IEEE operations as
    the plain version, so d2 and cp agree to 1e-6 (expected: exactly); the
    face id may differ only where another face ties within 1e-6. Shapes:
    the hybrid frame's N=65,536 (stride 1 and 4) and the human step's
    N=196,608 (stride 4, and 1), C=24; each with its plan (points a thread,
    candidate slices)."""
    import torch
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.ops.kernels import meshquery as kmq

    gen = torch.Generator().manual_seed(seed + 1)
    results = {}
    for rays, samples in ((MESH_RAYS, MESH_SAMPLES), (SIGNED_RAYS, SIGNED_SAMPLES)):
        pts = _ray_samples(verts, rays, samples, gen)
        for stride in (1, 4) if rays == MESH_RAYS else (4, 1):
            ops = mesh_ops.candidate_operands(pts, verts, topo, k=4, knn_stride=stride)
            run_k = lambda: kmq.ericson_select(*ops)
            run_p = lambda: kmq.ericson_select_plain(*ops)
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            rec, ok = hold_closest(got, want, kmq.tie_gap(*ops))
            err = rec["max_abs_err"]
            k_ms, p_ms = cuda_ms_min(run_k), cuda_ms_min(run_p, repeats=2, iters=5, warmup=2)
            k_dev = device_ms(run_k, "ericson_select_kernel")
            n, num_cands = pts.shape[0], ops[2].shape[0]
            b_ms, b_by = ericson_bound(n, num_cands, stride)
            plan = kmq.select_plan(n, num_cands, stride)
            log("ericson", N=n, C=num_cands, stride=stride, members=plan["members"],
                slices=plan["slices"], max_abs_err=f"{err:.3e}", f_id_diff=rec["f_id_diff"],
                bit_equal_plain=rec["bit_equal_plain"], kernel_ms=f"{k_ms:.4f}",
                kernel_device_ms=f"{k_dev:.4f}", plain_ms=f"{p_ms:.3f}",
                bound_ms=f"{b_ms:.4f}", bound_by=b_by, ok=ok)
            if not ok:
                raise RuntimeError(f"ericson_select N={n} stride {stride}: kernel disagrees")
            results[(n, stride)] = (err, k_ms, p_ms, b_ms, b_by, k_dev)
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
    counted_from = _launches()
    t0 = time.perf_counter()
    rgb, depth, acc = render(True)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _launches(counted_from)
    launches = {k: counts[k] for k in ("nerf_mlp", "ericson_select")}

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
            rec, g_ok = hold_grads(got, ref, name)
            err = rec["max_abs_err"]
            del got, ref
            torch.cuda.empty_cache()
            k_ms, p_ms = cuda_ms(run_k, iters=3, warmup=1), cuda_ms(run_p, iters=3, warmup=1)
            b_ms, b_by = mlp_bound(jspec, net, per_sample, r, s, name, backward=True)
            ok = identical and f_ok and g_ok
            log("mlp_bwd", mode=mode, pe=jspec.pos_pe.mapping, dtype=name, R=r, S=s,
                fwd_max_abs_err=f"{f_err:.3e}", fwd_out_scale=f"{f_scale:.3f}", fwd_ok=f_ok,
                **{k: f"{v:.3e}" for k, v in rec.items()}, bit_identical=identical,
                kernel_ms=f"{k_ms:.3f}",
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
            counted_from = _launches()
            trainer = ttrain.train_background(cfg, scene, train_views, val_views, device=device)
            counts = _launches(counted_from)
            before = (counts["nerf_mlp"], counts["nerf_mlp_bwd"])
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
            counts = _launches(counted_from)
            after = (counts["nerf_mlp"], counts["nerf_mlp_bwd"])
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
        f_rec, f_ok = hold_offset_fwd(out_k, out_p, name)
        f_err = f_rec["fwd_max_abs_err"]
        bwd_k = lambda: koff.offset_mlp_bwd(ospec, net, axes, cot, dtype)
        bwd_p = lambda: koff.offset_mlp_bwd_plain(ospec, net, axes, cot, dtype)
        flat = lambda out: [t for wb in out[0] for t in wb] + list(out[1])
        got, again, ref = flat(bwd_k()), flat(bwd_k()), flat(bwd_p())
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        b_rec, b_ok = hold_grads(got, ref, name)
        err = b_rec["max_abs_err"]
        del got, again, ref
        torch.cuda.empty_cache()
        times = {k: cuda_ms(f, iters=5, warmup=1) for k, f in
                 (("fwd", fwd_k), ("fwd_plain", fwd_p), ("bwd", bwd_k), ("bwd_plain", bwd_p))}
        fb = offset_bound(ospec, net, r * s, name, backward=False)
        bb = offset_bound(ospec, net, r * s, name, backward=True)
        ok = f_ok and identical and b_ok
        log("offset_mlp", dtype=name, R=r, S=s, **{k: f"{v:.3e}" for k, v in f_rec.items()},
            fwd_ok=f_ok, fwd_kernel_ms=f"{times['fwd']:.3f}",
            fwd_plain_ms=f"{times['fwd_plain']:.3f}", fwd_bound_ms=f"{fb[0]:.4f}",
            **{f"bwd_{k}": f"{v:.3e}" for k, v in b_rec.items() if k != "grad_scale"},
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


def knn_exact(verts, pts, k):
    """The exact k nearest of all V vertices of each point, [Nq, k] int64
    (a top-k over every vertex, in chunks)."""
    import torch
    from neuman_tpu_torch.ops import mesh as mesh_ops

    return torch.cat([mesh_ops._query_knn(c, verts, k)[0] for c in pts.split(16384)])


def hold_knn(verts, pts, got, want, exact=None):
    """bucketed_knn's (idx, scores) [Nq, k] against its plain version's on
    the same input: (fields, ok). Scores within KNN_SCORE_ATOL; every index
    in range, and where it differs from the plain version's, the score of
    the vertex it names (|v|^2 - 2 p.v, in f64) within KNN_SCORE_ATOL of
    the plain score at that slot: a tie, so an index that does not carry its
    score fails. Given the exact top k (`exact`), the first pick must be an
    exact nearest vertex up to such a tie (the nearest vertex is its
    bucket's minimum, so the bucketed KNN always finds it), and the recall
    of the exact nearest vertex and of the exact top k are reported (the
    top k is approximate by design: two near vertices can share a bucket)."""
    import torch

    (ki, ks), (pi, ps) = got, want
    nv = verts.shape[0]
    vd, pd = verts.double(), pts.double()

    def score(rows, idx):
        v = vd[idx.long().clamp(0, nv - 1)]
        return (v * v).sum(-1) - 2.0 * (pd[rows] * v).sum(-1)

    err = (ks - ps).abs().max().item()
    in_range = bool(((ki >= 0) & (ki < nv)).all())
    diff = ki != pi
    rows, slots = diff.nonzero(as_tuple=True)
    ties_only = bool(((score(rows, ki[rows, slots]) - ps[rows, slots].double()).abs()
                      <= KNN_SCORE_ATOL).all())
    rec = {"score_max_abs_err": err, "idx_diff": int(diff.sum()), "idx_diff_ties_only": ties_only,
           "in_range": in_range, "bit_equal_plain": torch.equal(ki, pi) and torch.equal(ks, ps)}
    ok = err <= KNN_SCORE_ATOL and ties_only and in_range
    if exact is not None:
        every = torch.arange(len(pts), device=pts.device)
        nearest = bool((score(every, ki[:, 0]) - score(every, exact[:, 0])
                        <= KNN_SCORE_ATOL).all())
        rec.update(recall_nearest=(ki[:, 0] == exact[:, 0]).float().mean().item(),
                   recall_top_k=(ki[:, :, None] == exact[:, None, :]).any(1).float().mean().item(),
                   nearest_up_to_ties=nearest)
        ok = ok and nearest
    return rec, ok


def _knn_check(verts, pts, plain_iters, exact=None):
    """bucketed_knn vs its plain version on one input (`hold_knn`): (fields,
    ok, kernel ms, kernel device ms, plain ms or None)."""
    import torch
    from neuman_tpu_torch.ops.kernels import knn as kknn

    run_k = lambda: kknn.bucketed_knn(pts, verts, KNN_K)
    run_p = lambda: kknn.bucketed_knn_plain(pts, verts, KNN_K)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    rec, ok = hold_knn(verts, pts, got, want, exact)
    del got, want
    k_ms, k_dev = cuda_ms_min(run_k), device_ms(run_k, "bucketed_knn_kernel")
    p_ms = cuda_ms(run_p, iters=plain_iters, warmup=1) if plain_iters else None
    return rec, ok, k_ms, k_dev, p_ms


def phase_knn(verts, seed):
    """Kernel and plain take each score by the same f32 operations (three
    FMAs seeded with |v|^2, which the plain version rounds once each), so
    the k scores agree to 1e-5 everywhere (expected: exactly) and the
    indices agree except where the two picked vertices' scores tie within
    that (`hold_knn`). At the human step's Nq=49,152 and 196,608 on the
    V=10,242 proxy (the table resident in shared memory); on a coarse
    integer grid, where most scores tie exactly, indices and scores must be
    equal (the earliest position in a bucket, the lower bucket across
    buckets), at V=10,242 and at V=40,962 (subdivision 6: the table over the
    shared-memory budget, staged in groups of buckets); and Nq=49,152 ray
    samples on V=40,962. On ray samples the first pick must be an exact
    nearest vertex up to a tie; the recall of the exact top k is printed,
    not held: the bucketed KNN is approximate by design, as in the JAX
    package."""
    import torch
    from neuman_tpu_torch.ops.kernels import knn as kknn
    from neuman_tpu_torch.utils.synthetic_body import synthetic_body_mesh

    gen = torch.Generator().manual_seed(seed + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = torch.tensor(synthetic_body_mesh(subdivisions=KNN_BIG_SUBDIVISIONS)[0],
                       dtype=torch.float32, device=verts.device)
    results, failed = {}, []
    fmt = lambda rec: {k: f"{v:.4e}" if isinstance(v, float) else v for k, v in rec.items()}
    for nq in KNN_QUERIES:
        pts = _ray_samples(verts, nq // OFFSET_SAMPLES, OFFSET_SAMPLES, gen)
        rec, ok, k_ms, k_dev, p_ms = _knn_check(verts, pts, 2, knn_exact(verts, pts, KNN_K))
        plan = kknn.knn_plan(nq, verts.shape[0], KNN_K, sms)
        b_ms, b_by = knn_bound(nq, verts.shape[0])
        log("bucketed_knn", case="rays", Nq=nq, V=verts.shape[0], V_pad=64 * plan["bucket_size"],
            k=KNN_K, resident=plan["resident"], smem_bytes=plan["smem_bytes"],
            queries_a_thread=plan["queries"], grid=plan["grid"], **fmt(rec),
            kernel_ms=f"{k_ms:.4f}", kernel_device_ms=f"{k_dev:.4f}",
            plain_ms=f"{p_ms:.3f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by, ok=ok)
        if not ok:
            failed.append(f"rays Nq={nq}")
        results[nq] = (rec["score_max_abs_err"], k_ms, p_ms, b_ms, b_by, k_dev)
    # exact ties on an integer grid, resident and over the budget; ray
    # samples over the budget
    for case, table_verts in (("grid", verts), ("grid", big), ("rays", big)):
        nv = table_verts.shape[0]
        if case == "grid":
            grid_verts = torch.randint(-3, 4, (nv, 3), generator=gen).float().to(verts.device)
            pts = torch.randint(-4, 5, (KNN_TIE_QUERIES, 3), generator=gen).float()
            table_verts, pts = grid_verts, pts.to(verts.device)
            exact = None
        else:
            pts = _ray_samples(table_verts, KNN_QUERIES[0] // OFFSET_SAMPLES, OFFSET_SAMPLES, gen)
            exact = knn_exact(table_verts, pts, KNN_K)
        rec, ok, k_ms, k_dev, _ = _knn_check(table_verts, pts, 0, exact)
        plan = kknn.knn_plan(pts.shape[0], nv, KNN_K, sms)
        b_ms, b_by = knn_bound(pts.shape[0], nv)
        ok = ok and (rec["bit_equal_plain"] or case != "grid")
        log("bucketed_knn", case=case, Nq=pts.shape[0], V=nv, resident=plan["resident"],
            group=plan["group"], stages=plan["stages"], smem_bytes=plan["smem_bytes"],
            **fmt(rec), kernel_ms=f"{k_ms:.4f}", kernel_device_ms=f"{k_dev:.4f}",
            bound_ms=f"{b_ms:.4f}", ok=ok)
        if not ok:
            failed.append(f"{case} V={nv}")
    if failed:
        raise RuntimeError(f"bucketed_knn disagrees with its plain version: {failed}")
    return results


def _human_config(out_dir, seed, **fields):
    from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults

    cfg = apply_mode_defaults(NeuManConfig(), "smpl_and_offset")
    cfg.out_dir, cfg.seed, cfg.max_iter, cfg.valid_iter = out_dir, seed, 2, 1000
    cfg.geo_threshold = 0.25
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg.finalize()


def _launches(since=None):
    """{kernel: its launches in this process}, less `since` (an earlier
    reading) where given: the wrappers' counters in utils/tracing.py."""
    from neuman_tpu_torch.ops import kernels

    return kernels.launches(since)


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
    signed distance are held to the default's, 2 steps train with it, and
    10 bf16 steps are timed with it and with the default.

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
            counted_from = _launches()
            # no flag is set here: the train step is deterministic itself
            flags = _cudnn_flags()
            trainer = ttrain.train_human(cfg, scene, train_views, val_views, body, device=device)
            flags_kept = _cudnn_flags() == flags
            before = _launches(counted_from)
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
            after = _launches(counted_from)
            launches = {k: {"train_human": before[k], f"human_{HUMAN_STEPS}_steps": after[k] - before[k]}
                        for k in after}
            per_step = {k: (after[k] - before[k]) / HUMAN_STEPS for k in after}
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
        counted_from = _launches()
        fused_losses = torch.stack([trainer.train_step()["total_loss"] for _ in range(2)])
        torch.cuda.synchronize()
        fused_launches = _launches(counted_from)
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
        # what the fused signed distance moves in a bf16 step: the median of
        # FUSED_STEPS steps with either, each trainer from the same seed
        step_ms = {}
        for name, ops in (("kernels", human.KERNELS), ("kernels_fused", human.KERNELS_FUSED)):
            bcfg = _human_config(out_dir, seed, name=f"bf16_{name}", compute_dtype="bfloat16")
            bench = trainer_for(bcfg, seed, ops=ops)
            bench.train_step()
            events = []
            for _ in range(FUSED_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                bench.train_step()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            ms = sorted(a.elapsed_time(b) for a, b in events)
            step_ms[name] = (ms[(FUSED_STEPS - 1) // 2] + ms[FUSED_STEPS // 2]) / 2
            del bench
        log("human_fused_sd_steps", dtype="bfloat16", steps=FUSED_STEPS,
            **{f"{k}_ms_per_step": f"{v:.3f}" for k, v in step_ms.items()})

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
        rec, g_ok = hold_grads(got, ref, "f32")
        ok = _fwd_ok(f_err, f_scale, "f32") and g_ok
        log("human_mlp", mode=mode, pe=jspec.pos_pe.mapping, dtype="f32", R=r, S=s,
            fwd_max_abs_err=f"{f_err:.3e}", bwd_max_rel_err=f"{rec['max_rel_err']:.3e}", ok=ok)
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


def signed_bound(n, knn_idx, tables):
    """What the table kernel must move: p3 [3, N] in, knn_idx [N/stride, k]
    in (at its dtype's size), the three tables once (incidence, vtab9,
    vntab9: 76 B a (vertex, face slot)); sd, face id, closest point [3, N]
    out; the region test for every (point, candidate) and the sign for the
    selected one."""
    num_verts, deg = tables.incidence.shape
    num_cands = knn_idx.shape[1] * deg
    nbytes = (3 * n * 4 + knn_idx.numel() * knn_idx.element_size() + num_verts * deg * 76
              + 5 * n * 4)
    return bound_ms((ERICSON_OPS_PER_TEST * num_cands + SIGN_OPS_PER_POINT) * n, nbytes, "f32")


def phase_signed(verts, topo, seed):
    """`ericson_signed_select_tables` at the human step's query, N=196,608
    ray samples, C=24, stride 4 and 1, on the query tables and the bucketed
    KNN's knn_idx. Built with --fmad=false it runs the plain version's
    operations: sd, the closest point and the face id are held to it bit
    for bit, and to the planar plain version on the same candidates
    gathered into planes; to `ericson_select` on those planes bit for bit
    (|sd| = sqrt(d2), closest point, face id: one device function); its
    gradient to the plain Function's exactly. Against the unfused signed
    distance (ericson_select + the sign in PyTorch, the same operations on
    the same values) the signs may differ only where the unfused
    |(p - closest) . n| <= 1e-6; those points are counted. Timed: the
    kernel (CUDA events and the profiler's device time), `ericson_select`
    and the plain version on the same candidates, and the whole query
    (`signed_distance`) fused and unfused."""
    import torch
    from neuman_tpu_torch.ops import mesh as mesh_ops
    from neuman_tpu_torch.ops.kernels import meshquery as kmq

    gen = torch.Generator().manual_seed(seed + 8)
    pts = _ray_samples(verts, SIGNED_RAYS, SIGNED_SAMPLES, gen)
    tables = mesh_ops.build_query_tables(verts, topo)
    p3 = pts.T.contiguous()
    results = {}
    for stride in (4, 1):
        kw = dict(k=4, knn_stride=stride, knn_impl="bucketed", tables=tables)
        knn_idx, st = mesh_ops._query_knn(pts, verts, 4, stride, "bucketed")
        targs = (knn_idx, tables.incidence, tables.vtab9, tables.vntab9, st)
        run_k = lambda: kmq.ericson_signed_select_tables(p3, *targs)
        run_p = lambda: kmq.ericson_signed_select_tables_plain(p3, *targs)
        # the same candidates as the TPU kernel's planes
        nq = knn_idx.shape[0]
        rows9, vn9 = (kmq.planar_rows(t[knn_idx], nq) for t in (tables.vtab9, tables.vntab9))
        cand = tables.incidence[knn_idx].reshape(nq, -1).T.contiguous()
        run_u = lambda: kmq.ericson_select(p3, rows9, cand, st)
        (sd, f_id, cp), (psd, pf, pcp), (d2, uf, ucp) = run_k(), run_p(), run_u()
        qsd, qf, qcp = kmq.ericson_signed_select(p3, rows9, vn9, cand, st, plain=True)
        torch.cuda.synchronize()
        cp, pcp, ucp, qcp = (torch.stack(c) for c in (cp, pcp, ucp, qcp))
        err = max((sd - psd).abs().max().item(), (cp - pcp).abs().max().item())
        plain_equal = torch.equal(sd, psd) and torch.equal(cp, pcp) and torch.equal(f_id, pf)
        planar_equal = torch.equal(psd, qsd) and torch.equal(pcp, qcp) and torch.equal(pf, qf)
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
            out = kmq.ericson_signed_select_tables(q, *targs, plain=plain)[0]
            grads.append(torch.autograd.grad((out * g).sum(), q)[0])
        grad_equal = torch.equal(*grads)
        del grads, psd, pcp, qsd, qcp, vn9
        full = lambda fused: mesh_ops.signed_distance(pts, verts, topo, fused=fused, **kw)
        times = {"kernel": cuda_ms_min(run_k), "unsigned_kernel": cuda_ms_min(run_u),
                 "kernel_device": device_ms(run_k, "ericson_signed_select_kernel"),
                 "unsigned_kernel_device": device_ms(run_u, "ericson_select_kernel"),
                 "plain": cuda_ms(run_p, iters=3, warmup=1),
                 "query_fused": cuda_ms(lambda: full(True)),
                 "query_unfused": cuda_ms(lambda: full(False))}
        b_ms, b_by = signed_bound(pts.shape[0], knn_idx, tables)
        plan = kmq.select_plan(pts.shape[0], cand.shape[0], st)
        ok = (plain_equal and planar_equal and unsigned_equal and excused and grad_equal
              and bool(torch.isfinite(sd).all()) and 0.05 < inside < 0.95)
        log("ericson_signed", N=pts.shape[0], C=cand.shape[0], stride=st,
            knn_idx=str(knn_idx.dtype).replace("torch.", ""), members=plan["members"],
            slices=plan["slices"], max_abs_err=f"{err:.3e}", bit_equal_plain=plain_equal,
            plain_equal_planar_plain=planar_equal,
            bit_equal_ericson_select=unsigned_equal, sign_flips_vs_unfused=int(flips.sum()),
            flips_within_dot_bound=excused, grad_bit_equal_plain=grad_equal,
            inside_share=f"{inside:.4f}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in times.items()},
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, ok=ok)
        if not ok:
            raise RuntimeError(f"ericson_signed_select stride {st}: kernel disagrees")
        results[st] = (err, times["kernel"], times["plain"], b_ms, b_by, times["kernel_device"])
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
        counted_from = _launches()
        t0 = time.perf_counter()
        out = render(True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches[name] = {k: v for k, v in _launches(counted_from).items() if v}
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


def _timed_steps(trainer, n):
    """Median CUDA-event ms of n train steps of `trainer`, and their losses."""
    import torch

    events, losses = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = trainer.train_step()
        end.record()
        events.append((start, end))
        losses.append(sum(float(v) for k, v in metrics.items() if "loss" in k or "reg" in k))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in events)
    return (ms[(n - 1) // 2] + ms[n // 2]) / 2, losses


def _cli_outputs_ok(out, val_names):
    """Whether a train.main run left checkpoint.npz, a params.json that
    loads back, metrics.jsonl with validation records and every loss
    finite, and validation PNGs that decode; (ok, the PNGs' shapes)."""
    from neuman_tpu_torch.options.config import NeuManConfig
    from neuman_tpu_torch.utils import png

    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [v for r in records for k, v in r.items() if "loss" in k or k.endswith("_reg")]
    NeuManConfig.load(os.path.join(out, "params.json"))
    shapes = {}
    for name in sorted(os.listdir(out)):
        stem = name.rsplit("_", 1)[0]
        if name.endswith(".png") and stem in val_names:
            shapes[name] = list(png.read_png(os.path.join(out, name)).shape)
    ok = (os.path.isfile(os.path.join(out, "checkpoint.npz"))
          and any(k.startswith("val_loss/") for r in records for k in r)
          and bool(losses) and all(math.isfinite(v) for v in losses)
          and {n.rsplit("_", 1)[0] for n in shapes} == set(val_names))
    return ok, shapes


@contextlib.contextmanager
def _data_root(root):
    """NEUMAN_DATA_ROOT at root/data (where the scene's body model is) for
    the scope; the caller's value back after."""
    before = os.environ.get("NEUMAN_DATA_ROOT")
    os.environ["NEUMAN_DATA_ROOT"] = os.path.join(root, "data")
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("NEUMAN_DATA_ROOT", None)
        else:
            os.environ["NEUMAN_DATA_ROOT"] = before


def phase_cli(device, seed, root):
    """The command line on a scene directory written under `root` (phase 13
    of the module docstring). The scene's images and masks are held to the
    files byte for byte (re-encoded: the writer and encode_png are one
    deterministic encoder), its MVS depth to the plane's depth and its mono
    depth to the tool's map, each times the scene scale. Returns {stage:
    (ms/step, launches counted from 0 in train.main, peak GiB)}, the scene's
    read seconds and the scene directory (stage 2's checkpoint is
    root/out/cli_human/checkpoint.npz)."""
    import numpy as np
    import torch
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.data_io import neuman
    from neuman_tpu_torch.tools import synthetic_scene
    from neuman_tpu_torch.utils import png

    with _data_root(root):
        body = synthetic_scene.rigged_body_proxy(BODY_SUBDIVISIONS)
        t0 = time.perf_counter()
        scene_dir = synthetic_scene.build_synthetic_scene(root, CLI_FRAMES, *CLI_HW, seed=seed,
                                                          body=body)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = neuman.NeuManReader.read_scene(scene_dir, normalize=True, bkg_range_scale=3.0,
                                               human_range_scale=1.5, smpl_type="optimized")
        scene.read_data_to_ram(data_list=["image", "depth"])
        read_s = time.perf_counter() - t0
        plane = synthetic_scene.Z_PLANE - synthetic_scene.CAMERA_Z
        same = len(scene.captures) == CLI_FRAMES
        for cap in scene.captures:
            mask_path = cap.captured_mask.image_path
            same = (same and png.encode_png(cap.image) == open(cap.image_path, "rb").read()
                    and png.encode_png(cap.captured_mask.image) == open(mask_path, "rb").read()
                    and np.array_equal(cap.depth_map,
                                       np.full(CLI_HW, plane, np.float32) * scene.scale)
                    and np.array_equal(cap.mono_depth_map,
                                       synthetic_scene.mono_depth_png(*CLI_HW) / 10000.0
                                       * scene.scale))
        log("cli_scene", frames=len(scene.captures), hw=json.dumps(list(CLI_HW)),
            V=body.num_verts, write_s=f"{write_s:.3f}", read_s=f"{read_s:.3f}",
            scale=f"{scene.scale:.6f}", equal_to_written=same, ok=same)
        if not same:
            raise RuntimeError("the scene read back differs from what was written")
        del scene

        out_dir = os.path.join(root, "out")
        common = ["--scene_dir", scene_dir, "--out_dir", out_dir, "--max_iter", str(CLI_MAX_ITER),
                  *CLI_FLAGS]
        stages = (("bkg", ["--train_mode", "bkg", "--name", "cli_bkg"], CLI_BKG_KERNELS, ("val",)),
                  ("human", ["--train_mode", "smpl_and_offset", "--name", "cli_human",
                             "--load_background", "cli_bkg"], CLI_HUMAN_KERNELS, VAL_IMAGES))
        results = {}
        for stage, argv, kernels, val_names in stages:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            counted_from = _launches()
            t0 = time.perf_counter()
            trainer = ttrain.main(argv + common, device=device)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = _launches(counted_from)
            gib = torch.cuda.max_memory_allocated() / 2**30
            ok, shapes = _cli_outputs_ok(os.path.join(out_dir, argv[3]), val_names)
            ms, losses = _timed_steps(trainer, CLI_TIMED_STEPS)
            ok = (ok and all(launches[k] > 0 for k in kernels)
                  and all(math.isfinite(v) for v in losses))
            log(f"cli_{stage}", argv=" ".join(argv + ["--max_iter", str(CLI_MAX_ITER), *CLI_FLAGS]),
                rays=trainer.opt.rays_per_batch, S=trainer.opt.samples_per_ray,
                main_s=f"{main_s:.3f}", ms_per_step=f"{ms:.3f}", timed_steps=CLI_TIMED_STEPS,
                peak_gib=f"{gib:.2f}", geo_threshold=f"{trainer.opt.geo_threshold:.6f}",
                launches=json.dumps({k: v for k, v in launches.items() if v},
                                    separators=(",", ":")),
                val_pngs=json.dumps(shapes, separators=(",", ":")),
                last_loss=f"{losses[-1]:.5f}", ok=ok)
            if not ok:
                raise RuntimeError(f"cli {stage}: a kernel of {kernels} was not launched, a loss "
                                   f"is not finite, or an output is missing or unreadable")
            results[stage] = (ms, launches, gib)
            del trainer
        return results, read_s, scene_dir


@contextlib.contextmanager
def _frame_probe():
    """While in scope, each call of the renderers the command lines use is
    timed (wall clock between two synchronises), and geometry_guided_near_far
    counts the rays it tests and those within geo_threshold (the hit rays;
    for several actors, a ray is tested once for each). Yields (frame
    seconds, [hit rays (summed on the device), rays tested])."""
    import torch
    from neuman_tpu_torch.ops import rays as ray_ops
    from neuman_tpu_torch.render import renderer

    seconds, counts = [], [0, 0]
    near_far = ray_ops.geometry_guided_near_far
    saved = {name: getattr(renderer, name) for name in RENDERERS}

    def counted(origin, direction, verts, geo_threshold):
        near, far = near_far(origin, direction, verts, geo_threshold)
        counts[0] = counts[0] + (near < far).sum()  # stays on the device
        counts[1] += near.numel()
        return near, far

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out
        return run

    ray_ops.geometry_guided_near_far = counted
    for name, fn in saved.items():
        setattr(renderer, name, timed(fn))
    try:
        yield seconds, counts
    finally:
        ray_ops.geometry_guided_near_far = near_far
        for name, fn in saved.items():
            setattr(renderer, name, fn)


def _png_psnr(a, b):
    import numpy as np

    mse = np.mean((a.astype(np.float64) / 255.0 - b.astype(np.float64) / 255.0) ** 2)
    return math.inf if mse == 0 else -10.0 * math.log10(mse)


def _render_cli_runs(root, scene_dir, seed, work, trajectory, mocap_frames, gather_mocap_frames):
    """The render command lines' inputs laid out under the working
    directory `work` (LPIPS weights drawn from `seed`, a motion of
    `mocap_frames` for the reposing; the gathering's fixed paths: the
    actors' nets (phase 13's stage-2 checkpoint) and fits, and its preset
    motion of `gather_mocap_frames`, of which it renders every 4th).
    Returns (the flags every command line takes, [(command, module, its
    flags, the kernels it must launch, frames, where it writes them)])."""
    from neuman_tpu_torch import render_gathering
    from neuman_tpu_torch.models import lpips
    from neuman_tpu_torch.tools import synthetic_scene
    from neuman_tpu_torch.trainers import checkpoint as ckpt

    name = os.path.basename(scene_dir)
    weights = os.path.join(root, "out", "cli_human", "checkpoint.npz")
    lpips_path = os.path.join(work, "lpips_seeded.npz")
    os.makedirs(work)
    ckpt.save_checkpoint(lpips_path, lpips.lpips_params_to_jax(lpips.init_lpips_params(seed)))
    mocap = synthetic_scene.write_mocap_npz(os.path.join(work, "motion_poses.npz"), mocap_frames,
                                            seed)
    for actor in RENDER_CLI_ACTORS:
        nets = os.path.join(work, "out", render_gathering.ACTOR_WEIGHTS_DICT[actor])
        os.makedirs(nets)
        shutil.copy(weights, nets)
        fits = os.path.join(os.path.dirname(scene_dir), actor)
        os.makedirs(fits, exist_ok=True)
        shutil.copy(os.path.join(scene_dir, "smpl_output_optimized.pkl"), fits)
    synthetic_scene.write_mocap_npz(os.path.join(work, "data", "SFU", "0018",
                                                 "0018_XinJiang002_poses.npz"),
                                    gather_mocap_frames, seed + 1)
    common = ["--scene_dir", scene_dir, "--weights_path", weights, *RENDER_CLI_FLAGS]
    orbit = ["--trajectory_resolution", str(trajectory)]
    warp = ("nerf_mlp", "ericson_select")
    return common, (
        ("test_views", "render_test_views", ["--lpips_weights", lpips_path], warp, 1,
         f"test_views/{name}"),
        ("canonical_360", "render_360", ["--mode", "canonical_360", *orbit], ("nerf_mlp",),
         trajectory, f"canonical_360/{name}"),
        ("posed_360", "render_360", ["--mode", "posed_360", *orbit], warp, trajectory,
         f"posed_360/{name}"),
        ("reposing", "render_reposing", ["--mocap_path", mocap], warp, mocap_frames,
         f"reposing/{name}"),
        ("gathering", "render_gathering", ["--actors", *RENDER_CLI_ACTORS], warp,
         -(-gather_mocap_frames // 4), "gathering/dance_together"),
    )


def phase_render_cli(device, seed, root, scene_dir):
    """The four render command lines (phase 14 of the module docstring), run
    from a working directory under `root`, on phase 13's scene and its
    stage-2 checkpoint, at the render defaults (2048-ray chunks, 128 + 128
    samples, bf16, k=4, knn_stride 4) and the scene's 270x480. Each one's
    launches are counted from 0 just before its main() and read just after;
    every frame it wrote is read back. Returns {command line: (launches,
    frames, median s/frame, hit fraction)}."""
    import numpy as np
    import torch
    from neuman_tpu_torch import render_test_views
    from neuman_tpu_torch.utils import png

    work = os.path.join(root, "render_cwd")
    common, runs = _render_cli_runs(root, scene_dir, seed, work, RENDER_CLI_TRAJECTORY,
                                    RENDER_CLI_MOCAP_FRAMES, RENDER_CLI_GATHER_MOCAP_FRAMES)
    results = {}
    cwd = os.getcwd()
    with _data_root(root):
        try:
            os.chdir(work)
            for what, module, argv, kernels, frames, demo in runs:
                torch.cuda.synchronize()
                counted_from = _launches()
                t0 = time.perf_counter()
                with _frame_probe() as (seconds, hits):
                    ret = importlib.import_module(f"neuman_tpu_torch.{module}").main(
                        argv + common, device=device)
                torch.cuda.synchronize()
                main_s = time.perf_counter() - t0
                launches = {k: v for k, v in _launches(counted_from).items() if v}
                demo = os.path.join("demo", demo)
                written = sorted(os.listdir(demo))
                shapes = {png.read_png(os.path.join(demo, f)).shape == (*CLI_HW, 3)
                          for f in written}
                hit_fraction = int(hits[0]) / max(hits[1], 1)
                sec = float(np.median(seconds)) if seconds else math.nan
                ok = (len(written) == frames == len(seconds) and shapes == {True}
                      and all(launches.get(k, 0) > 0 for k in kernels) and hit_fraction > 0)
                extra = {}
                if what == "test_views":
                    extra["scores"] = json.dumps(ret, separators=(",", ":"))
                    ok = ok and all(v is not None and math.isfinite(v) for v in ret.values())
                log("render_cli", cmd=what, frames=len(written), H=CLI_HW[0], W=CLI_HW[1],
                    s_per_frame_median=f"{sec:.3f}", main_s=f"{main_s:.3f}",
                    hit_fraction=f"{hit_fraction:.4f}",
                    launches=json.dumps(launches, separators=(",", ":")), **extra, ok=ok)
                if not ok:
                    raise RuntimeError(f"render_cli {what}: frames missing or unreadable, no ray "
                                       f"hit the body, a score not finite, or a kernel of "
                                       f"{kernels} was not launched")
                results[what] = (launches, len(written), sec, hit_fraction)

            # the test view through the plain versions of the kernels
            tv_dir = os.path.join("demo", runs[0][5])
            (view,) = os.listdir(os.path.join(work, tv_dir))
            plain_dir = os.path.join(work, "plain")
            os.makedirs(plain_dir)
            os.chdir(plain_dir)
            plain_scores = render_test_views.main(runs[0][2] + ["--use_pallas", "false"] + common,
                                                  device=device)
            kernel_frame = png.read_png(os.path.join(work, tv_dir, view))
            plain_frame = png.read_png(os.path.join(plain_dir, tv_dir, view))
            psnr = _png_psnr(kernel_frame, plain_frame)
            ok = psnr >= FRAME_MIN_PSNR
            log("render_cli", cmd="test_views_plain", psnr_vs_kernels=f"{psnr:.2f}",
                scores=json.dumps(plain_scores, separators=(",", ":")), ok=ok)
            if not ok:
                raise RuntimeError("render_cli: the kernel test view is under the PSNR bar "
                                   "against the plain one")
        finally:
            os.chdir(cwd)
    return results


def _upscaled_capture(cap, hw):
    """`cap` (a stage-10 capture) at the size hw: intrinsics and keypoints
    scaled, mask and DensePose labels by nearest pixel."""
    import numpy as np

    sy, sx = hw[0] / cap.shape[0], hw[1] / cap.shape[1]
    rows = (np.arange(hw[0]) / sy).astype(np.int64)
    cols = (np.arange(hw[1]) / sx).astype(np.int64)
    keypoints = np.asarray(cap.keypoints, np.float64) * [sx, sy, 1.0]
    return types.SimpleNamespace(
        shape=tuple(hw), intrinsic_matrix=np.diag([sx, sy, 1.0]) @ cap.intrinsic_matrix,
        cam_pose=cap.cam_pose, binary_mask=cap.binary_mask[rows][:, cols], keypoints=keypoints,
        densepose=cap.densepose[rows][:, cols])


def _keypoint_px(refiner, pose):
    """Mean pixel distance of the mapped SMPL joints of `pose` to the
    refiner's keypoint targets."""
    import torch
    from neuman_tpu_torch.preprocess import optimize_smpl as osm

    with torch.no_grad():
        _, joints = osm.vertex_forward(pose, refiner.betas, refiner.align, refiner.body_model,
                                       refiner.scale)
        pj, _ = refiner.project(joints)
        err = torch.linalg.norm(pj - refiner.joints_target, dim=1)
    return float((err * refiner.joints_mask).sum() / refiner.joints_mask.sum())


def phase_preprocess(device, seed, root, card):
    """Preprocessing stages 9 and 10 (phase 15 of the module docstring),
    under `root`. Every line carries the card's name and power limit.
    Returns the numbers PERF.md reads."""
    import numpy as np
    import torch
    from neuman_tpu_torch.data_io import smpl_pickle
    from neuman_tpu_torch.data_io.neuman import NeuManReader
    from neuman_tpu_torch.preprocess import cli as pcli
    from neuman_tpu_torch.preprocess import optimize_smpl as osm
    from neuman_tpu_torch.tools import synthetic_scene

    out = {}
    with _data_root(root):
        # (a) the whole pipeline, 4 frames at 270x480
        body = synthetic_scene.rigged_body_proxy(BODY_SUBDIVISIONS)
        t0 = time.perf_counter()
        scene_dir, truth = synthetic_scene.write_preprocess_inputs(root, PRE_FRAMES, *PRE_HW,
                                                                   seed=seed, body=body)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alignments = pcli.run_alignment(os.path.join(scene_dir, "sparse"),
                                        os.path.join(scene_dir, "images"),
                                        os.path.join(scene_dir, "romp"), device=device)
        torch.cuda.synchronize()
        align_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fits = pcli.run_optimize_smpl(scene_dir, num_iters=PRE_ITERS, device=device)
        torch.cuda.synchronize()
        optimize_s = time.perf_counter() - t0

        align_err = max(np.abs(a - truth["alignments"][k]).max()
                        / np.abs(truth["alignments"][k]).max() for k, a in alignments.items())
        on_disk = np.load(os.path.join(scene_dir, "alignments.npy"), allow_pickle=True).item()
        romp = smpl_pickle.load(pcli.romp_pickle_path(os.path.join(scene_dir, "romp")))[1]
        optimized = smpl_pickle.load(os.path.join(scene_dir, "smpl_output_optimized.pkl"))[1]
        read_back = (sorted(on_disk) == sorted(alignments)
                     and all(np.array_equal(on_disk[k], a) for k, a in alignments.items())
                     and np.array_equal(romp["pose"], truth["romp_pose"])
                     and all(np.array_equal(optimized[k], v) for k, v in fits.items()))
        scene = NeuManReader.read_scene(scene_dir, smpl_type="romp", normalize=False)
        kp_before, kp_after, frames = [], [], []
        for i, cap in enumerate(scene.captures):
            align = np.eye(4)
            align[:, :3] = on_disk[os.path.basename(cap.image_path)]
            refiner = osm.FrameRefiner(cap, {"pose": romp["pose"][i], "betas": romp["betas"][i]},
                                       body, align, 1.0, device=device)
            kp_before.append(_keypoint_px(refiner, refiner.pose0))
            kp_after.append(_keypoint_px(refiner, torch.as_tensor(optimized["pose"][i],
                                                                  device=device)))
            frames.append((cap, align))
        ok = (align_err <= PRE_ALIGN_REL and read_back and np.all(np.isfinite(optimized["pose"]))
              and np.mean(kp_after) < np.mean(kp_before))
        log("preprocess_pipeline", card=json.dumps(card), frames=PRE_FRAMES,
            hw=json.dumps(list(PRE_HW)), V=body.num_verts, F=len(body.faces),
            setup_write_s=f"{write_s:.3f}", stage9_align_s=f"{align_s:.3f}",
            stage9_s_per_frame=f"{align_s / PRE_FRAMES:.3f}",
            stage10_optimize_s=f"{optimize_s:.3f}", stage10_iters=PRE_ITERS,
            stage10_s_per_frame=f"{optimize_s / PRE_FRAMES:.3f}",
            align_rel_err=f"{align_err:.3e}", align_tol=PRE_ALIGN_REL,
            keypoint_px_before=f"{np.mean(kp_before):.4f}",
            keypoint_px_after=f"{np.mean(kp_after):.4f}", read_back=read_back, ok=ok)
        if not ok:
            raise RuntimeError("preprocess: the alignments missed the truth, an output did not "
                               "read back, or the refinement did not lower the keypoint error")
        out["pipeline"] = dict(write_s=write_s, align_s=align_s, optimize_s=optimize_s,
                               align_rel_err=align_err, kp=(np.mean(kp_before), np.mean(kp_after)))

        # (b) one frame's refinement at 1280x720, F=20,480
        cap0, align0 = frames[0]
        fit0 = {"pose": romp["pose"][0], "betas": romp["betas"][0]}
        full = osm.FrameRefiner(_upscaled_capture(cap0, PRE_FULL_HW), fit0, body, align0, 1.0,
                                device=device)
        full.run(PRE_FULL_WARMUP)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pose = full.run(PRE_FULL_TIMED)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / PRE_FULL_TIMED
        gib = torch.cuda.max_memory_allocated() / 2**30
        pixels = len(range(0, PRE_FULL_HW[0], 4)) * len(range(0, PRE_FULL_HW[1], 4))
        ok = bool(torch.isfinite(pose).all())
        log("preprocess_full", card=json.dumps(card), hw=json.dumps(list(PRE_FULL_HW)),
            stride=4, pixels=pixels, F=len(body.faces), pairs=pixels * len(body.faces),
            warmup=PRE_FULL_WARMUP, timed=PRE_FULL_TIMED, ms_per_iter=f"{ms:.3f}",
            peak_gib=f"{gib:.3f}",
            ms_per_frame_at_100=f"{ms * PRE_REFERENCE_ITERS:.1f}", ok=ok)
        if not ok:
            raise RuntimeError("preprocess: the full-size refinement gave a non-finite pose")
        out["full"] = dict(ms_per_iter=ms, peak_gib=gib)

        # (c) one step on the card against the CPU, 270x480, F=1,280
        small = synthetic_scene.rigged_body_proxy(PRE_CPU_SUBDIVISIONS)
        steps = {}
        for dev in (device, "cpu"):
            refiner = osm.FrameRefiner(cap0, fit0, small, align0, 1.0, device=dev)
            loss, grad = refiner.gated_grad(refiner.pose0)
            steps[str(dev)] = (float(loss), grad.cpu().numpy().astype(np.float64))
        (lc, gc), (lh, gh) = steps[str(device)], steps["cpu"]
        loss_rel = abs(lc - lh) / abs(lh)
        grad_rel = float(np.linalg.norm(gc - gh) / np.linalg.norm(gh))
        ok = loss_rel <= PRE_LOSS_REL and grad_rel <= PRE_GRAD_REL and np.linalg.norm(gh) > 0
        log("preprocess_card_vs_cpu", card=json.dumps(card), hw=json.dumps(list(PRE_HW)),
            F=len(small.faces), loss_card=f"{lc:.8f}", loss_cpu=f"{lh:.8f}",
            loss_rel=f"{loss_rel:.3e}", loss_tol=PRE_LOSS_REL, grad_rel_l2=f"{grad_rel:.3e}",
            grad_tol=PRE_GRAD_REL, ok=ok)
        if not ok:
            raise RuntimeError("preprocess: the card's step differs from the CPU's")
        out["card_vs_cpu"] = dict(loss_rel=loss_rel, grad_rel=grad_rel)
    return out


@contextlib.contextmanager
def _environ(values):
    """The environment variables `values` for the scope; the caller's back
    after."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _grad_bar(kind, name):
    """PERF.md section 2's f32 gradient bar of a parameter (L2 error over
    L2 norm): the background nets and the poses 5e-3, the canonical net
    1e-2, the offset net 5e-2."""
    if kind == "bkg":
        return STEP_TOL["float32"][1]
    return HUMAN_STEP_TOL["float32"][1][name.split(".")[0]]


def _swap_timed(trainer, step_fns, n):
    """Each of `step_fns` ({label: step function}) on the one trainer, in
    turns (a, b, a, b; n steps a turn): {label: the mean of its two turns'
    median ms/step, label + "_losses": its steps' losses}."""
    runs = {k: [] for k in step_fns}
    for _ in range(2):
        for label, fn in step_fns.items():
            trainer.step_fn = fn
            runs[label].append(_timed_steps(trainer, n))
    out = {}
    for label, turns in runs.items():
        out[label] = sum(ms for ms, _ in turns) / len(turns)
        out[label + "_losses"] = [v for _, losses in turns for v in losses]
    return out


def phase_parallel(device, seed, root, scene_dir, card):
    """Data parallelism and the NeRF-T ablation (phase 16 of the module
    docstring). Returns {path: {kernel: launches}} of its main paths: each
    rank's two steps of (a) and the two train.main stages of (b), each
    counted from 0 (the NeRF-T stage launches no kernel: its nets are the
    plain PyTorch ones, as in the JAX package)."""
    import torch
    import torch.distributed as dist
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.models import nerf as nerf_module
    from neuman_tpu_torch.parallel import dryrun
    from neuman_tpu_torch.trainers import background as bkg
    from neuman_tpu_torch.trainers import human

    stamp = dict(card=json.dumps(card))
    launches = {}

    # (a) two gloo ranks on the one card against one process, f32, 2 steps
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        jobs = [dryrun.Job("bkg", _bkg_config(out_dir, seed, name="par_bkg"), steps=PAR_STEPS,
                           views=SLICE_VIEWS, hw=SLICE_HW, seed=seed),
                dryrun.Job("human", _human_config(out_dir, seed, name="par_human"),
                           steps=PAR_STEPS, views=SLICE_VIEWS, hw=SLICE_HW, seed=seed,
                           body_subdivisions=BODY_SUBDIVISIONS)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results = dryrun.dryrun_equality(PAR_WORLD, jobs, backend="gloo", device=str(device),
                                         timeout_s=PAR_SPAWN_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for job, eq in zip(jobs, results):
        kernels = PAR_KERNELS[job.kind]
        worst = {}
        for name, rel in eq["grad_rel_l2"].items():
            group = name.split(".")[0]
            worst[group] = max(worst.get(group, 0.0), rel)
        grads_ok = all(rel <= _grad_bar(job.kind, name) for name, rel in eq["grad_rel_l2"].items())
        launched = all(r[k] > 0 for r in eq["launches"] for k in kernels)
        # the human steps score the LPIPS patch (rays 0-1023 of 1536: both ranks' rows)
        patch_steps = sum(m.get("lpips_loss", 0.0) > 0 for m in eq["metrics"])
        ok = (eq["max_loss_rel_diff"] <= PAR_LOSS_RTOL and grads_ok and eq["ranks_equal"]
              and eq["max_param_abs_diff"] <= PAR_PARAM_ABS_BAR
              and eq["param_share_over_atol"] <= PAR_PARAM_SHARE_BAR and launched
              and (job.kind == "bkg" or patch_steps > 0))
        log("parallel_ranks", kind=job.kind, world=PAR_WORLD, backend="gloo",
            rays=job.cfg.rays_per_batch, rays_per_rank=job.cfg.rays_per_batch // PAR_WORLD,
            steps=PAR_STEPS, loss_1=json.dumps(eq["loss_unsharded"]),
            loss_n=json.dumps(eq["loss_sharded"]), max_loss_rel=f"{eq['max_loss_rel_diff']:.3e}",
            grad_rel_l2=json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}),
            max_param_abs=f"{eq['max_param_abs_diff']:.3e}",
            param_share_off=f"{eq['param_share_over_atol']:.2e}",
            lpips_steps=patch_steps if job.kind == "human" else "-",
            param_bars=f"{PAR_PARAM_ABS_BAR:.0e}/{PAR_PARAM_SHARE_BAR:.0e}",
            ranks_equal=eq["ranks_equal"],
            launches=json.dumps([{k: v for k, v in r.items() if v} for r in eq["launches"]],
                                separators=(",", ":")),
            wall_s=f"{wall_s:.1f}", **stamp, ok=ok)
        if not ok:
            raise RuntimeError(f"parallel {job.kind}: two ranks differ from one process, the "
                               "ranks differ, or a kernel of the step was not launched on a rank")
        for rank, counts in enumerate(eq["launches"]):
            launches[f"parallel_{job.kind}_rank{rank}"] = counts

    # (b) train.main under the torchrun environment: NCCL at world size 1
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    out_dir = os.path.join(root, "out_parallel")
    common = ["--scene_dir", scene_dir, "--out_dir", out_dir, "--max_iter", str(CLI_MAX_ITER),
              "--data_parallel", "on", *CLI_FLAGS]
    stages = (("bkg", ["--train_mode", "bkg", "--name", "par_bkg"]),
              ("human", ["--train_mode", "smpl_and_offset", "--name", "par_human",
                         "--load_background", "par_bkg"]))
    try:
        with _environ(env), _data_root(root):
            for stage, argv in stages:
                torch.cuda.synchronize()
                counted_from = _launches()
                trainer = ttrain.main(argv + common, device=device)
                torch.cuda.synchronize()
                counts = _launches(counted_from)
                mesh = trainer.mesh
                if stage == "bkg":
                    plain = bkg.make_bkg_train_step(trainer.spec, trainer.opt, trainer.optimizer,
                                                    trainer.mlp)
                else:
                    plain = human.make_human_train_step(trainer.model, trainer.opt,
                                                        trainer.optimizer, trainer.ctx)
                timed = _swap_timed(trainer, {"mesh": trainer.step_fn, "no_mesh": plain},
                                    PAR_TIMED_STEPS)
                losses = timed["mesh_losses"] + timed["no_mesh_losses"]
                out_ok, _ = _cli_outputs_ok(os.path.join(out_dir, argv[3]),
                                            ("val",) if stage == "bkg" else VAL_IMAGES)
                backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
                ok = (mesh is not None and dist.get_backend() == backend and mesh.size == 1
                      and out_ok and all(counts[k] > 0 for k in PAR_KERNELS[stage])
                      and all(math.isfinite(v) for v in losses))
                cost = timed["mesh"] - timed["no_mesh"]
                log("parallel_nccl", stage=stage, argv=" ".join(argv + ["--data_parallel", "on"]),
                    backend=dist.get_backend(), world=dist.get_world_size(),
                    ms_per_step_mesh=f"{timed['mesh']:.3f}",
                    ms_per_step_no_mesh=f"{timed['no_mesh']:.3f}",
                    mesh_cost_ms=f"{cost:.3f}", mesh_cost_share=f"{cost / timed['no_mesh']:.4f}",
                    timed_steps=2 * PAR_TIMED_STEPS,
                    launches=json.dumps({k: v for k, v in counts.items() if v},
                                        separators=(",", ":")), **stamp, ok=ok)
                if not ok:
                    raise RuntimeError(f"parallel nccl {stage}: no NCCL mesh, a missing output, a "
                                       "kernel not launched or a loss not finite")
                launches[f"parallel_nccl_{stage}"] = counts
                del trainer
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    # (c) the NeRF-T ablation: stage 1 with the time channel, card vs CPU at step 1
    first = {}
    draw, step = bkg.NeRFTrainer.draw_batch, bkg.NeRFTrainer.train_step

    def first_batch(self, view_ids=None, generator=None):
        batch = draw(self, view_ids, generator)
        if view_ids is None and "batch" not in first:
            first["batch"] = {k: v.cpu() for k, v in batch.items()}
        return batch

    def first_step(self):
        metrics = step(self)
        first.setdefault("loss", float(metrics["total_loss"]))
        return metrics

    argv = ["--train_mode", "bkg", "--name", "par_nerft", "--ablate_nerft", "true",
            "--raw_pos_dim", "4", "--scene_dir", scene_dir, "--out_dir", out_dir,
            "--max_iter", str(CLI_MAX_ITER), *CLI_FLAGS]
    bkg.NeRFTrainer.draw_batch, bkg.NeRFTrainer.train_step = first_batch, first_step
    try:
        counted_from = _launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _data_root(root):
            trainer = ttrain.main(argv, device=device)
        torch.cuda.synchronize()
        counts = _launches(counted_from)
        gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        bkg.NeRFTrainer.draw_batch, bkg.NeRFTrainer.train_step = draw, step
    ms, losses = _timed_steps(trainer, PAR_TIMED_STEPS)
    out_ok, shapes = _cli_outputs_ok(os.path.join(out_dir, "par_nerft"), ("val",))
    opt = trainer.opt
    spec = nerf_module.build_nerf_specs(opt)
    params = ttrain.init_bkg_params(spec, opt.seed, "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        c_rgb, c_emp, f_rgb, f_emp, _ = bkg.bkg_loss_fn(params, spec, first["batch"], opt,
                                                        opt.penalize_empty_space)
    cpu_loss = float(c_rgb + f_rgb + (c_emp + f_emp if 0 >= opt.delay_iters else 0.0))
    cpu_s = time.perf_counter() - t0
    rel = abs(first["loss"] - cpu_loss) / abs(cpu_loss)
    ok = (out_ok and all(math.isfinite(v) for v in losses + [first["loss"]])
          and rel <= PAR_NERFT_LOSS_REL and not any(counts.values()))
    log("parallel_nerft", argv=" ".join(argv[:6]), rays=opt.rays_per_batch,
        S=opt.samples_per_ray, pe_columns=spec.nerf.input_ch, ms_per_step=f"{ms:.3f}",
        timed_steps=PAR_TIMED_STEPS, peak_gib=f"{gib:.2f}", step1_loss=repr(first["loss"]),
        cpu_step1_loss=repr(cpu_loss), rel=f"{rel:.2e}", cpu_s=f"{cpu_s:.1f}",
        val_pngs=json.dumps(shapes, separators=(",", ":")),
        launches=json.dumps({k: v for k, v in counts.items() if v}), **stamp, ok=ok)
    if not ok:
        raise RuntimeError("parallel nerft: a missing output, a loss not finite, the card's "
                           "step-1 loss off the CPU's, or a kernel launched on the plain path")
    return launches


def phase_render_parallel(device, seed, root, scene_dir, card):
    """Rendering on N ranks (phase 18 of the module docstring). Returns
    {path: {kernel: launches}} of its main paths: each rank's render of
    each command line and the NCCL run, each counted from 0."""
    import torch
    import torch.distributed as dist
    from neuman_tpu_torch import render_test_views
    from neuman_tpu_torch.parallel import dryrun

    stamp = dict(card=json.dumps(card))
    work = os.path.join(root, "render_par_cwd")
    common, runs = _render_cli_runs(root, scene_dir, seed, work, RENDER_PAR_FRAMES,
                                    RENDER_PAR_FRAMES, 4 * RENDER_PAR_FRAMES - 3)
    runs = runs[1:] + runs[:1]
    jobs = [dryrun.RenderJob(what, dryrun.command_line, (module, argv + common), work)
            for what, module, argv, *_ in runs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _data_root(root):
        results = dryrun.render_equality(PAR_WORLD, jobs, backend="gloo", device=str(device),
                                         timeout_s=RENDER_PAR_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    launches, scores = {}, None
    for (what, _, _, kernels, frames, _), eq in zip(runs, results):
        faults = dryrun.render_faults(eq)
        # nerf_mlp on every rank; ericson_select on every rank whose share had hits
        launched = all(r.get("nerf_mlp", 0) > 0 for r in eq["launches"]) and all(
            r.get("ericson_select", 0) > 0 for r, rays in zip(eq["launches"], eq["human_rays"])
            if "ericson_select" in kernels and rays > 0)
        unsharded = any("UNSHARDED" in w for caught in eq["warnings"] for w in caught)
        ok = (not faults and launched and len(eq["renderers"]) == frames
              and eq["hw"] == list(CLI_HW) and eq["single_human_rays"] > 0 and not unsharded)
        if what == "test_views":
            scores = eq["single_returned"]
            ok = ok and all(r == scores for r in eq["returned"])
        log("render_parallel", cmd=what, world=PAR_WORLD, backend="gloo", H=CLI_HW[0],
            W=CLI_HW[1], renderer=eq["renderers"][0], frames=len(eq["renderers"]),
            max_abs=json.dumps({k: float(f"{v:.3e}") for k, v in eq["max_abs"].items()}),
            bit_equal=eq["bit_equal"], ranks_equal=eq["ranks_equal"],
            pngs_equal=eq["pngs_equal"], pngs_by_rank=json.dumps(eq["pngs_written"]),
            s_last_frame_ranks=json.dumps([round(s[-1], 4) for s in eq["seconds"]]),
            s_last_frame_single=f"{eq['single_seconds'][-1]:.4f}",
            human_rays_ranks=json.dumps(eq["human_rays"]),
            human_rays_single=eq["single_human_rays"],
            launches=json.dumps([{k: v for k, v in r.items() if v} for r in eq["launches"]],
                                separators=(",", ":")), faults=json.dumps(faults),
            wall_s=f"{wall_s:.1f}", **stamp, ok=ok)
        if not ok:
            raise RuntimeError(f"render_parallel {what}: {faults or 'a kernel not launched on a '
                               'rank, a frame missing, or no ray hit the body'}")
        for rank, counts in enumerate(eq["launches"]):
            launches[f"render_parallel_{what}_rank{rank}"] = counts

    # render_test_views.main under the torchrun environment: NCCL at world size 1
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    what, _, argv, kernels, _, _ = runs[-1]
    nccl_dir = os.path.join(work, "nccl")
    os.makedirs(nccl_dir)
    cwd = os.getcwd()
    try:
        with _environ(env), _data_root(root):
            os.chdir(nccl_dir)
            counted_from = _launches()
            got = render_test_views.main(argv + common + ["--data_parallel", "on"], device=device)
            torch.cuda.synchronize()
            counts = _launches(counted_from)
            backend, world = dist.get_backend(), dist.get_world_size()
    finally:
        os.chdir(cwd)
        if dist.is_initialized():
            dist.destroy_process_group()
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    ok = (backend == want and world == 1 and got == scores
          and all(counts[k] > 0 for k in kernels))
    log("render_parallel_nccl", cmd=what, backend=backend, world=world,
        scores=json.dumps(got, separators=(",", ":")), scores_equal_one_process=got == scores,
        launches=json.dumps({k: v for k, v in counts.items() if v}, separators=(",", ":")),
        **stamp, ok=ok)
    if not ok:
        raise RuntimeError("render_parallel nccl: no NCCL group, scores off one process's, or a "
                           "kernel not launched")
    launches["render_parallel_nccl"] = counts
    return launches


def phase_envelope(model, spec, device, seed):
    """Phase 17: the kernel shape sweep's quick cases (see
    neuman_tpu_torch/tools/sweep_kernel_envelope.py for each case's bars),
    with this run's model, untimed: the sweep alone times them (this late
    in a run torch.profiler saw no launch of the mesh kernels on the
    H100). Raises if a case failed. Returns each kernel's launches in the
    phase: comparisons with the plain versions, not a main path."""
    from neuman_tpu_torch.tools import sweep_kernel_envelope as sweep

    counted_from = _launches()
    t0 = time.perf_counter()
    ctx = sweep.Context(device, seed, model=(spec, model), timed=False)
    quick = [case for case in sweep.cases() if case.quick]
    failed = sweep.run_cases(quick, ctx)
    launches = {k: v for k, v in _launches(counted_from).items() if v}
    log("envelope", cases=len(quick), failed=len(failed),
        seconds=f"{time.perf_counter() - t0:.2f}", launches=launches)
    if failed:
        raise RuntimeError(f"kernel shape sweep: {failed}")
    return launches


def _captured(fn):
    """(fn()'s result, the lines it printed to stdout)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def hold_bench_render(device):
    """nerf_mlp at the shapes of the bench's render chunk: its coarse call
    (S=128) and its fine call (S=256, the coarse samples and the importance
    samples the kernel's coarse output gives), per-ray, bf16, on the bench's
    nets and rays (`bench.render_inputs`). Each is held within MLP_BF16_REL
    of the plain version's largest output, the plain version run over
    BENCH_PLAIN_SLICE rays at a time on the same inputs. Returns
    {pass: (max abs error, output scale, ok)}."""
    import torch
    from neuman_tpu_torch import bench
    from neuman_tpu_torch.ops import volume
    from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp

    dtype = torch.bfloat16
    spec, coarse, fine, origins, dirs, near, far = bench.render_inputs(device)
    z = volume.sample_z(near, far, 128)
    held = {}
    with torch.no_grad():
        for name, net in (("coarse", coarse), ("fine", fine)):
            planes = [origins[:, a, None] + dirs[:, a, None] * z for a in range(3)]
            dirp = kmlp.dir_projection(spec, net, dirs, dtype)
            sigma, rgb = kmlp.nerf_mlp(spec, net, *planes, dir_part=dirp, compute_dtype=dtype)
            got = torch.stack([sigma, *rgb])
            want = []
            for rows in torch.arange(z.shape[0], device=device).split(BENCH_PLAIN_SLICE):
                ps, prgb = kmlp.nerf_mlp_plain(spec, net, *(p[rows] for p in planes),
                                               dir_part=dirp[rows], compute_dtype=dtype)
                want.append(torch.stack([ps, *prgb]))
            want = torch.cat(want, dim=1)
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            held[name] = (err, scale, bool(torch.isfinite(got).all()) and _fwd_ok(err, scale,
                                                                                     "bf16"))
            log("bench_render_hold", call=name, rays=z.shape[0], samples=z.shape[1],
                max_abs_err=f"{err:.4g}", out_scale=f"{scale:.4g}",
                tol=f"{MLP_BF16_REL * scale:.4g}", ok=held[name][2])
            if name == "coarse":
                weights = volume.integrate_planar(sigma, rgb, z, torch.linalg.norm(dirs, dim=-1),
                                                  True)[3]
                z = volume.importance_z(z, weights, 128)
            del got, want
    return held


def phase_bench(device):
    """Phase 19: the bench, nerf_mlp at its render chunk's shapes
    (`hold_bench_render`), its fault path and the query's step parts. The
    bench's lines are printed behind "[bench]", so that no line but the
    last two is a bare JSON object. Returns each kernel's launches in the
    bench run."""
    from neuman_tpu_torch import bench
    from neuman_tpu_torch.tools import bench_step_parts

    counted_from = _launches()
    t0 = time.perf_counter()
    (result, rc, by_stage), lines = _captured(lambda: bench.run(
        ["--iters", str(BENCH_ITERS), "--train_iters", str(BENCH_ITERS)]))
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in _launches(counted_from).items() if v}
    for line in lines:
        print(f"[bench] {line}", flush=True)
    finite = all(isinstance(result.get(k), (int, float)) and math.isfinite(result[k])
                 for k in BENCH_KEYS)
    ok = rc == 0 and result.get("kernels") == "compiled" and finite
    log("bench", iters=BENCH_ITERS, exit_code=rc, seconds=f"{seconds:.2f}",
        launches=json.dumps(launches, separators=(",", ":")),
        launches_by_stage=json.dumps(by_stage, separators=(",", ":")), ok=ok)
    if not ok:
        raise RuntimeError(f"bench: exit code {rc}, kernels {result.get('kernels')!r}, or a key "
                           f"null or not finite: {result}")
    held = hold_bench_render(device)
    if not all(ok for _, _, ok in held.values()):
        raise RuntimeError(f"nerf_mlp at the bench's render chunk disagrees with its plain "
                           f"version: {held}")

    (broken, rc, _), lines = _captured(lambda: bench.run(
        ["--break-stage", "render", "--rays", "1024", "--no-train", "--no-hybrid"]))
    ok = (rc == 1 and broken["value"] is None and broken["vs_baseline"] is None
          and broken["kernels"] == "failed:render:RuntimeError")
    log("bench_break_stage", stage="render", exit_code=rc, line=lines[-1], ok=ok)
    if not ok:
        raise RuntimeError(f"bench --break-stage render: exit code {rc}, line {broken}")

    t0 = time.perf_counter()
    _, lines = _captured(lambda: bench_step_parts.run("query", device))
    for line in lines:
        print(f"[bench_step_parts] {line}", flush=True)
    log("bench_step_parts", component="query", seconds=f"{time.perf_counter() - t0:.2f}")
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
          "renders", "cli", "render_cli", "preprocess", "parallel", "envelope", "render_parallel", "bench")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        parser.error(f"unknown phase in {phases}")
    if {"render_cli", "parallel", "render_parallel"} & set(phases) and "cli" not in phases:
        phases.append("cli")  # phases 14, 16 and 18 read phase 13's scene (and checkpoint)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from neuman_tpu_torch.models import smpl
    from neuman_tpu_torch.ops import mesh as mesh_ops

    device = torch.device("cuda", 0)
    card = phase_card()
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
        "cli": lambda: phase_cli(device, args.seed, cli_root),
        "render_cli": lambda: phase_render_cli(device, args.seed, cli_root, out["cli"][2]),
        "preprocess": lambda: phase_preprocess(device, args.seed,
                                               os.path.join(cli_root, "preprocess"), card),
        "parallel": lambda: phase_parallel(device, args.seed, cli_root, out["cli"][2], card),
        "envelope": lambda: phase_envelope(model, spec, device, args.seed),
        "render_parallel": lambda: phase_render_parallel(device, args.seed, cli_root,
                                                         out["cli"][2], card),
        "bench": lambda: phase_bench(device),
    }
    cli_root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    out = {}
    try:
        for name in PHASES:
            if name in phases:
                out[name] = run[name]()
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
    device_line = {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}
    if set(phases) != set(PHASES):
        print(json.dumps({**device_line, "phases": phases}), flush=True)
        return 0
    mlp, mesh, launches, bwd, train = (out[k] for k in ("mlp", "mesh", "slice", "bwd", "train"))
    offset, knn, human, signed, renders = (out[k] for k in ("offset", "knn", "human", "signed",
                                                            "renders"))
    cli, render_cli, parallel = out["cli"][0], out["render_cli"], out["parallel"]
    envelope, render_parallel = out["envelope"], out["render_parallel"]
    bench = out["bench"]

    # timings (CUDA events; the three mesh kernels also by the profiler's
    # device time, device_ms): nerf_mlp the render path's bf16 per-ray case (phase 3),
    # ericson_select N=65,536 stride 4 (phase 4), nerf_mlp_bwd the fine pass of the
    # f32 background step (phase 6), offset_mlp and offset_mlp_bwd the f32
    # human step's shape and bucketed_knn its 49,152 groups (phase 8),
    # ericson_signed_select the human step's stride-4 query (phase 11).
    # launches: the sum over the main paths, each counted from 0 in its own
    # run and listed in launches_by_path: one hybrid frame (phase 5), the
    # f32 background train path (phase 7) split into train_background (2
    # steps, 2 validations) and the 20 timed steps, in both tape
    # configurations, the f32 human train path (phase 9) split likewise, its
    # 2 steps with the fused signed distance, the three frames of phase
    # 12, the command line's two stages (phase 13, train.main each), the
    # five render command lines (phase 14, main() each), phase 16's two
    # ranks' steps of each stage (counted in each rank) and its two
    # train.main stages under NCCL, and phase 18's two ranks' frame of each
    # render command line (counted in each rank) and its NCCL test view, and
    # phase 19's bench run.
    # Phase 17's launches are listed as
    # envelope_quick and left out of `launches`: they compare the kernels
    # with their plain versions.
    # No single PyTorch call computes any of the seven functions.
    def entry(name, source, replaces, by_path, max_abs_err, timing):
        ms, plain_ms, b_ms, b_by, *dev = timing
        main_paths = sum(v for k, v in by_path.items() if not k.startswith("envelope_"))
        return {"name": name, "route": "cuda", "source": f"neuman_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": main_paths,
                "launches_by_path": by_path, "max_abs_err": max_abs_err, "ms": ms,
                "device_ms": dev[0] if dev else None, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    def by_path(name):
        paths = {"render_frame": launches.get(name, 0)}
        for key, run in (("", train.get("float32")), ("hbm_", train.get("float32_hbm")),
                         ("", human["float32"]), ("hbm_", human["float32_hbm"])):
            paths.update({key + k: v for k, v in run[1].get(name, {}).items()})
        paths.update(human["fused_launches"].get(name, {}))
        paths.update({f"render_{frame}": counts.get(name, 0) for frame, counts in renders.items()})
        paths.update({f"cli_{stage}": run[1].get(name, 0) for stage, run in cli.items()})
        paths.update({f"render_cli_{cmd}": run[0].get(name, 0) for cmd, run in render_cli.items()})
        paths.update({path: counts.get(name, 0) for path, counts in parallel.items()})
        paths.update({path: counts.get(name, 0) for path, counts in render_parallel.items()})
        paths["bench"] = bench.get(name, 0)
        paths["envelope_quick"] = envelope.get(name, 0)
        return {k: v for k, v in paths.items() if v}

    kernels = [
        entry("nerf_mlp", "nerf_mlp", "neuman_tpu/ops/pallas/raymarch.py:105", by_path("nerf_mlp"),
              max(mlp[(m, "bf16")][0] for m in ("per_ray", "per_sample")),
              mlp[("per_ray", "bf16")][1:]),
        entry("ericson_select", "ericson_select", "neuman_tpu/ops/pallas/meshquery.py:314",
              by_path("ericson_select"), max(r[0] for r in mesh.values()),
              mesh[(MESH_RAYS * MESH_SAMPLES, 4)][1:]),
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
