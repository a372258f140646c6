"""The configuration fields the port reads.

Field names and defaults are those of `neuman_tpu.options.config.NeuManConfig`,
so a `params.json` of either package sets the same values. `finalize`
derives the output paths as the JAX config does; it imports nothing, where
the JAX one asks jax for its backend.
"""

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

    # human stage
    geo_threshold: float = -1.0
    knn_stride: int = 4
    num_offset_nets: int = 1
    offset_scale_type: str = "linear"

    seed: int = 42
    compute_dtype: str = "float32"  # or "bfloat16" for the MLP products

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
        return self


def apply_mode_defaults(cfg: NeuManConfig, train_mode: str) -> NeuManConfig:
    """Mode-dependent defaults, as neuman_tpu.options.config.apply_mode_defaults
    (the background stage samples background rays only, so the port has no
    ray-ratio fields yet)."""
    if train_mode == "bkg":
        cfg.rays_per_batch = 4096
        cfg.valid_iter = 5000
        cfg.max_iter = 500_000
        cfg.perturb = 0.0
    else:
        raise ValueError(f"train mode {train_mode!r} is not ported (only the background stage)")
    return cfg
