"""The configuration and its command line (counterpart of
neuman_tpu/options/config.py).

Every field of `neuman_tpu.options.config.NeuManConfig`, with its name and
default, so one command line and one `params.json` serve both packages.
`apply_mode_defaults` switches the defaults by `--train_mode` (the
reference's two-pass parsing); `add_cli_args` / `from_cli` expose every
field as a flag; `finalize` derives the output paths and the target sizes,
as the JAX config's does, and imports nothing.

Fields the port parses and saves but does not act on: those that steer XLA
or the TPU (`use_cuda`, `pe_recurrence`, `tb_dir`), the JAX profiler's
(`profile_dir`, `profile_steps`), and those of options not ported (`chunk`,
`penalize_outside`, `random_view`). `data_parallel` and `data_axis` pick
the trainers' data mesh (parallel/mesh.resolve_mesh). The render fields (`render_h`,
`render_w`, `weights_path`, `trajectory_resolution`, `motion_name`,
`mocap_*`) are read by the render command lines. `use_pallas` False
selects the plain PyTorch ops in both train steps and in the renders;
None (the default) or True the kernels.
"""

import argparse
import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

from neuman_tpu_torch.utils.misc import print_notification

# fields finalize sets: not command-line flags
DERIVED = ("out", "tb_dir", "load_weights_path", "tgt_size", "render_size")


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes", "y", "t")


@dataclass
class NeuManConfig:
    # general
    use_cuda: bool = False

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
    render_h: Optional[int] = None
    render_w: Optional[int] = None
    weights_path: Optional[str] = None
    # LPIPS weights (.npz in the JAX package's layout); the command line
    # also looks for <repo>/data/lpips_alex.npz
    lpips_weights: Optional[str] = None
    white_bkg: bool = True
    trajectory_resolution: int = 40

    # scene
    scene_dir: Optional[str] = None
    normalize: bool = True
    bkg_range_scale: float = 3.0
    human_range_scale: float = 1.5
    image_height: Optional[int] = None
    image_width: Optional[int] = None
    mask_dir: str = "segmentations"
    smpl_type: str = "optimized"
    dilation: int = 30

    # training, shared
    train_mode: str = "bkg"  # bkg | smpl_only | smpl_and_offset
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
    # ray classes of a batch (body, border, strict background); sum to 1
    body_rays_ratio: float = 0.0
    border_rays_ratio: float = 0.0
    bkg_rays_ratio: float = 1.0

    # background stage
    empty_space_loss_fn: str = "mse"
    use_fused_depth: bool = True
    penalize_empty_space: float = 0.1
    margin: float = 0.8
    ablate_nerft: bool = False

    # human stage
    bkg_lr: float = 0.0
    smpl_lr: float = 3e-4
    geo_threshold: float = -1.0
    knn_stride: int = 4
    penalize_smpl_alpha: float = 1.0
    penalize_outside: bool = True
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
    chunk: int = 10000
    load_background: Optional[str] = None
    load_can: Optional[str] = None
    num_offset_nets: int = 1
    offset_scale: float = 0.0
    offset_scale_type: str = "linear"
    offset_lim: float = 1.0
    offset_delay: int = 20000
    prior_knowledge_decay: bool = False
    block_grad: bool = True
    random_view: bool = False

    # fields of the JAX package's own
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    seed: int = 42
    data_axis: str = "data"
    data_parallel: str = "auto"
    compute_dtype: str = "float32"  # or "bfloat16" for the MLP products
    use_pallas: Optional[bool] = None
    pe_recurrence: Optional[bool] = None
    # the fused MLPs' backward: "recompute" re-derives the trunk activations,
    # "hbm" reads a tape of them that the forward wrote to device memory
    # (depth * width values a sample in the compute dtype, alive until the
    # backward); the gradients are bit-identical
    mlp_tape: str = "recompute"

    # derived (set by finalize)
    out: Optional[str] = None
    tb_dir: Optional[str] = None
    load_weights_path: Optional[str] = None
    tgt_size: Optional[Tuple[int, int]] = None
    render_size: Optional[Tuple[int, int]] = None
    motion_name: str = "speedvault"
    mocap_path: Optional[str] = None
    mocap_start: int = 0
    mocap_end: int = -1
    mocap_skip: int = 1

    def finalize(self):
        """Derived paths and sizes, and the invariants, as the JAX config's
        finalize (which also resolves use_pallas and pe_recurrence from its
        backend; here they stay as given)."""
        if self.image_height is not None or self.image_width is not None:
            if self.image_height is None or self.image_width is None:
                raise ValueError("--image_height and --image_width go together")
            self.tgt_size = (self.image_height, self.image_width)
        if self.render_h is not None:
            self.render_size = (self.render_h, self.render_w)
        self.out = os.path.join(self.out_dir, self.name)
        self.tb_dir = os.path.join(self.out_dir, "tensorboard_out", self.name)
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
        if self.ablate_nerft and (self.raw_pos_dim != 4 or self.train_mode != "bkg"):
            raise ValueError("ablate_nerft needs raw_pos_dim 4 and train_mode bkg")
        return self

    def save(self, path=None):
        """Write every field to `path` (default <out>/params.json)."""
        path = path or os.path.join(self.out, "params.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fp:
            json.dump(dataclasses.asdict(self), fp, indent=0, sort_keys=True, default=str)
        return path

    @classmethod
    def load(cls, path):
        """A config of a params.json (of either package); unknown keys are
        ignored."""
        with open(path) as fp:
            raw = json.load(fp)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        for k in ("tgt_size", "render_size"):
            if kwargs.get(k) is not None:
                kwargs[k] = tuple(kwargs[k])
        return cls(**kwargs)


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


def add_cli_args(parser: argparse.ArgumentParser, cfg: NeuManConfig):
    """A flag for every field that is not derived, with the field's value
    in `cfg` as its default (the JAX package's flag names and types)."""
    for f in dataclasses.fields(NeuManConfig):
        if f.name in DERIVED:
            continue
        value = getattr(cfg, f.name)
        if f.type in (bool, Optional[bool]) or isinstance(value, bool):
            typ = str2bool
        elif isinstance(value, int) or f.type == Optional[int]:
            typ = int
        elif isinstance(value, float) or f.type == Optional[float]:
            typ = float
        else:
            typ = str
        parser.add_argument(f"--{f.name}", type=typ, default=value)
    return parser


def from_cli(argv=None, mode_aware=True, base: Optional[NeuManConfig] = None):
    """Parse `argv` in two passes: --train_mode first, to set the mode's
    defaults, then every flag."""
    cfg = base or NeuManConfig()
    if mode_aware:
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--train_mode", type=str, default=cfg.train_mode)
        known, _ = pre.parse_known_args(argv)
        cfg = apply_mode_defaults(cfg, known.train_mode)
    parser = argparse.ArgumentParser()
    add_cli_args(parser, cfg)
    for k, v in vars(parser.parse_args(argv)).items():
        setattr(cfg, k, v)
    return cfg.finalize()


def print_opt(cfg: NeuManConfig):
    rows = sorted(dataclasses.asdict(cfg).items())
    print_notification([k.rjust(25, " ") + "  " + str(v) for k, v in rows], "OPTIONS")
