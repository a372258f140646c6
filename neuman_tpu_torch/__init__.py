"""neuman_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of neuman_tpu.

The JAX package `neuman_tpu` stays the reference; every module here has a
counterpart at the same relative path there and is tested against it.
This package imports torch and nothing of `neuman_tpu`, jax, flax, optax
or cv2: what it needs of neuman_tpu's numpy-only modules it keeps as its
own copies (`utils/`, `geometry/`, `cameras/`, `scenes/`). `preprocess/pnp.py`
alone has no counterpart there: it replaces the JAX package's cv2 calls.

Layer map, entry points first:
    train.py             the command line (`python -m neuman_tpu_torch.train`,
                         main), train_background (stage 1), train_human (stage 2)
    render_test_views.py, render_360.py, render_reposing.py, render_gathering.py
                         the render command lines (`python -m
                         neuman_tpu_torch.render_*`, main): test views scored
                         by utils/metrics.py, 360 orbits (render/paths.py),
                         mocap reposing, several actors; render/cli.py holds
                         what they share
    visualize_scene.py   a scene's point cloud, bodies and cameras drawn into
                         a PNG (`python -m neuman_tpu_torch.visualize_scene`)
    preprocess/          stages 9-10 of a video's preprocessing (cli.py;
                         run.sh by gen_run.py): the SMPL-to-scene alignment
                         (alignment.py, EPnP in RANSAC in pnp.py) and the
                         per-frame pose refinement (optimize_smpl.py, the
                         soft face rasteriser soft_raster.py)
    options/config.py    every field and flag of the JAX config, params.json
    data_io/             the NeuMan scene reader (COLMAP text, the joblib-written
                         SMPL fits, near/far, normalisation, SMPL skinning),
                         over cameras/, geometry/, scenes/
    trainers/            NeRFTrainer, HumanNeRFTrainer: batches, losses,
                         autograd, Adam, validation, checkpoints, PNG logging
                         (the background one also the NeRF-T ablation)
    parallel/            data parallelism over torch.distributed (mesh.py:
                         the process group, the data mesh, sharded batches
                         and draws, global means, the all-reduces; torchrun
                         launches it) and its dry run against one process
                         (dryrun.py)
    datasets/            scene arrays in device memory, ray batch samplers
    render/renderer.py   one frame path (hit test, background chunks,
                         branches over the hit list) behind four renderers:
                         render_hybrid_nerf, render_smpl_nerf (posed and
                         canonical), render_hybrid_nerf_multi_persons,
                         render_vanilla; render/rasterize.py the SMPL overlay
    ops/rays.py          ray generation, z sampling, inverse CDF, near/far
    ops/volume.py        importance z, merge, volume integration
    ops/mesh.py          vertex KNN, closest point, signed distance, warp
    ops/kernels/         the nine hand-written CUDA kernels (sm_90a, sources
                         in csrc/) with their plain PyTorch twins: nerf_mlp and
                         nerf_mlp_bwd, offset_mlp and offset_mlp_bwd (both
                         pairs on mlp_hopper.cuh: wgmma + TMA in bf16, register
                         tiles in f32), ericson_select (points of a group
                         in one thread, candidates in slices) and
                         ericson_signed_select (the same on the query
                         tables by KNN index, the sign for the winner
                         only), bucketed_knn (the bucket table built in the
                         kernel, resident in shared memory), hit_test (each
                         ray's near and far over the vertex spheres in
                         registers), exact_knn (each query's k nearest
                         vertices of all V in registers)
    models/              PE, NeRF / HumanNeRF / offset nn.Modules, SMPL LBS,
                         LPIPS
    convert.py           neuman_tpu param pytree <-> torch state_dict
    utils/               PNG codec, PIL-exact resize, border masks and fused depth,
                         PSNR / SSIM / LPIPS
    tools/               per-kernel device-time profiles of a step or a frame,
                         timings over tape chunks and of the mesh kernels,
                         the kernel shape sweep (every kernel against its
                         plain version over the command lines' shapes), a
                         synthetic scene directory writer (a rigged body
                         proxy, AMASS-layout motions, a video's stage-9/10
                         inputs with their truth)
"""

__version__ = "0.1.0"
