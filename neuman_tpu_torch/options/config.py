"""The configuration fields the port reads.

Field names and defaults are those of `neuman_tpu.options.config.NeuManConfig`,
so a `params.json` of either package sets the same values. `finalize`
derives the output paths as the JAX config does; it imports nothing, where
the JAX one asks jax for its backend.
"""

import math
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class NeuManConfig:
    # nerf
    nerf_depth: int = 8
    nerf_width: int = 256
    use_viewdirs: bool = True
    specular_can: bool = True

    # positional encoding
    raw_pos_dim: int = 3
    pos_min_freq: int = 0
    pos_max_freq: int = 9
    pos_N_freqs: int = 10
    raw_dir_dim: int = 3
    dir_max_freq: int = 3
    dir_N_freqs: int = 4
    log_sampling: bool = True
    include_input: bool = True
    can_posenc: str = "rotate"
    posenc: str = "posenc"

    # rendering
    rays_per_batch: int = 2048
    samples_per_ray: int = 128
    importance_samples_per_ray: int = 128
    white_bkg: bool = True

    # training, shared
    delay_iters: int = 0
    learning_rate: float = 5e-4
    lrate_decay: Optional[int] = 250
    raw_noise_std: float = 0.0
    out_dir: str = "./out"
    name: str = "dummy"
    resume: bool = False
    load_weights: Optional[str] = None
    max_iter: int = 500_000
    valid_iter: int = 5000
    perturb: float = 0.0

    # background stage
    empty_space_loss_fn: str = "mse"
    use_fused_depth: bool = True
    penalize_empty_space: float = 0.1
    margin: float = 0.8
    ablate_nerft: bool = False

    # ray classes of a batch (body, border, strict background); sum to 1
    train_mode: str = "bkg"  # bkg | smpl_only | smpl_and_offset
    dilation: int = 30
    body_rays_ratio: float = 0.0
    border_rays_ratio: float = 0.0
    bkg_rays_ratio: float = 1.0

    # human stage
    smpl_lr: float = 3e-4
    geo_threshold: float = -1.0
    knn_stride: int = 4
    penalize_smpl_alpha: float = 1.0
    penalize_outside_factor: float = 2.0
    penalize_outside_loss: str = "l1"
    dist_exponent: float = 1.0
    penalize_symmetric_alpha: float = 0.1
    penalize_hard_surface: float = 0.1
    penalize_dummy: float = 1.0
    penalize_color_range: float = 0.1
    penalize_mask: float = 0.01
    penalize_sharp_edge: float = 0.1
    penalize_lpips: float = 0.01
    load_background: Optional[str] = None
    num_offset_nets: int = 1
    offset_scale: float = 0.0
    offset_scale_type: str = "linear"
    offset_lim: float = 1.0
    offset_delay: int = 20000
    prior_knowledge_decay: bool = False
    block_grad: bool = True

    seed: int = 42
    compute_dtype: str = "float32"  # or "bfloat16" for the MLP products
    # the fused MLPs' backward: "recompute" re-derives the trunk activations,
    # "hbm" reads a tape of them that the forward wrote to device memory
    # (depth * width values a sample in the compute dtype, alive until the
    # backward); the gradients are bit-identical
    mlp_tape: str = "recompute"

    # derived (set by finalize)
    out: Optional[str] = None
    load_weights_path: Optional[str] = None

    def finalize(self):
        """Derived paths and invariants, as the JAX config's finalize."""
        self.out = os.path.join(self.out_dir, self.name)
        if self.load_weights is not None:
            self.load_weights_path = os.path.join(self.out_dir, self.load_weights,
                                                  "checkpoint.npz")
        elif self.resume:
            self.load_weights_path = os.path.join(self.out_dir, self.name, "checkpoint.npz")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {self.compute_dtype}")
        if self.mlp_tape not in ("recompute", "hbm"):
            raise ValueError(f"mlp_tape must be recompute or hbm, not {self.mlp_tape}")
        ratios = self.body_rays_ratio + self.border_rays_ratio + self.bkg_rays_ratio
        if not math.isclose(ratios, 1.0):
            raise ValueError(f"the ray ratios must sum to 1, not {ratios}")
        return self


def apply_mode_defaults(cfg: NeuManConfig, train_mode: str) -> NeuManConfig:
    """Mode-dependent defaults, as neuman_tpu.options.config.apply_mode_defaults."""
    cfg.train_mode = train_mode
    if train_mode == "bkg":
        cfg.rays_per_batch = 4096
        cfg.valid_iter = 5000
        cfg.max_iter = 500_000
        cfg.body_rays_ratio, cfg.border_rays_ratio, cfg.bkg_rays_ratio = 0.0, 0.0, 1.0
        cfg.perturb = 0.0
    elif train_mode in ("smpl_only", "smpl_and_offset"):
        cfg.rays_per_batch = 1536
        cfg.valid_iter = 1000
        cfg.max_iter = 300_000
        cfg.body_rays_ratio, cfg.border_rays_ratio, cfg.bkg_rays_ratio = 0.95, 0.05, 0.0
        cfg.perturb = 1.0
    else:
        raise ValueError(train_mode)
    return cfg
