"""neuman_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of neuman_tpu.

The JAX package `neuman_tpu` stays the reference; every module here has a
counterpart at the same relative path there and is tested against it.
This package imports torch and nothing of `neuman_tpu`, jax or flax: what
it needs of neuman_tpu's numpy-only modules it keeps as its own copies
under `utils/` (`constants.py`, `synthetic_body.py`, `canonical_cameras.py`).

Layer map, entry points first:
    train.py             train_background (stage 1) and train_human (stage 2)
    trainers/            NeRFTrainer, HumanNeRFTrainer: batches, losses,
                         autograd, Adam, validation, checkpoints, PNG logging
    datasets/            scene arrays in device memory, ray batch samplers
    render/renderer.py   render_hybrid_nerf, render_smpl_nerf (posed and
                         canonical), render_hybrid_nerf_multi_persons,
                         render_vanilla; render/rasterize.py the SMPL overlay
    ops/rays.py          ray generation, z sampling, inverse CDF, near/far
    ops/volume.py        importance z, merge, volume integration
    ops/mesh.py          vertex KNN, closest point, signed distance, warp
    ops/kernels/         the seven hand-written CUDA kernels (sm_90a, sources
                         in csrc/) with their plain PyTorch twins: nerf_mlp and
                         nerf_mlp_bwd, offset_mlp and offset_mlp_bwd (both
                         pairs on mlp_hopper.cuh: wgmma + TMA in bf16, register
                         tiles in f32), ericson_select and
                         ericson_signed_select, bucketed_knn
    models/              PE, NeRF / HumanNeRF / offset nn.Modules, SMPL LBS,
                         LPIPS
    convert.py           neuman_tpu param pytree <-> torch state_dict
    options/config.py    the config fields the port reads
    tools/               per-kernel device-time profiles of a step or a frame
"""

__version__ = "0.1.0"
