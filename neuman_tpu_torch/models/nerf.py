"""NeRF MLPs as nn.Modules (counterpart of neuman_tpu/models/nerf.py).

Depth x width ReLU trunk with the positional encoding concatenated back
after each layer in `skips`, then either the view-direction head (alpha
from the trunk; rgb from [feature, dir PE] through one width/2 layer) or a
single `output_linear`. Parameter names are the reference's `state_dict`
names (`pts_linears.{i}`, `views_linears.0`, `feature_linear`,
`alpha_linear`, `rgb_linear`, `output_linear`), so weights in the
reference layout load directly.
"""

import math
from dataclasses import dataclass

import torch
from torch import nn

from neuman_tpu_torch.models import embedder as embedder_module


@dataclass(frozen=True)
class NeRFSpec:
    depth: int = 8
    width: int = 256
    input_ch: int = 3
    input_ch_views: int = 3
    output_ch: int = 4
    skips: tuple = (4,)
    use_viewdirs: bool = False
    scale_type: str = "no"


@dataclass(frozen=True)
class JoinerSpec:
    """PE∘MLP over points + view directions."""

    pos_pe: embedder_module.EmbedderSpec
    dir_pe: embedder_module.EmbedderSpec
    nerf: NeRFSpec


@dataclass(frozen=True)
class OffsetNetSpec:
    """PE∘MLP on (xyz, t) -> 3-vector offset."""

    pos_pe: embedder_module.EmbedderSpec
    nerf: NeRFSpec


def build_nerf_specs(opt, posenc=None):
    """Joiner spec from a config, as neuman_tpu's build_nerf_specs with exact trig."""
    mapping = posenc if posenc is not None else opt.posenc
    pos_pe = embedder_module.make_embedder(
        opt.raw_pos_dim, opt.pos_max_freq, opt.pos_N_freqs, opt.log_sampling,
        opt.include_input, min_freq=opt.pos_min_freq, mapping=mapping,
    )
    dir_pe = embedder_module.make_embedder(
        opt.raw_dir_dim, opt.dir_max_freq, opt.dir_N_freqs, opt.log_sampling,
        opt.include_input, mapping=mapping,
    )
    nerf = NeRFSpec(
        depth=opt.nerf_depth, width=opt.nerf_width, input_ch=pos_pe.out_dim,
        input_ch_views=dir_pe.out_dim, use_viewdirs=opt.use_viewdirs,
    )
    return JoinerSpec(pos_pe=pos_pe, dir_pe=dir_pe, nerf=nerf)


def build_offset_net_spec(opt):
    st_pe = embedder_module.make_embedder(
        opt.raw_pos_dim + 1, opt.pos_max_freq, opt.pos_N_freqs,
        opt.log_sampling, opt.include_input, min_freq=opt.pos_min_freq,
    )
    nerf = NeRFSpec(
        depth=opt.nerf_depth, width=opt.nerf_width, input_ch=st_pe.out_dim,
        input_ch_views=0, output_ch=3, use_viewdirs=False,
        scale_type=opt.offset_scale_type,
    )
    return OffsetNetSpec(pos_pe=st_pe, nerf=nerf)


class NeRF(nn.Module):
    def __init__(self, spec: NeRFSpec, device=None):
        super().__init__()
        self.spec = spec
        w = spec.width
        fan_ins = [spec.input_ch] + [
            w + spec.input_ch if (i - 1) in spec.skips else w
            for i in range(1, spec.depth)
        ]
        self.pts_linears = nn.ModuleList(
            nn.Linear(f, w, device=device) for f in fan_ins
        )
        if spec.use_viewdirs:
            self.views_linears = nn.ModuleList(
                [nn.Linear(spec.input_ch_views + w, w // 2, device=device)]
            )
            self.feature_linear = nn.Linear(w, w, device=device)
            self.alpha_linear = nn.Linear(w, 1, device=device)
            self.rgb_linear = nn.Linear(w // 2, 3, device=device)
        else:
            self.output_linear = nn.Linear(w, spec.output_ch, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """torch.nn.Linear's default init, U(+-1/sqrt(fan_in)) for weight
        and bias, drawn on the host from the CPU `generator` so one seed
        gives the same weights on every device."""
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    draw = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                    p.copy_(draw)
        return self

    def forward(self, input_pts, input_views=None):
        """input_pts: [..., input_ch] (already embedded) -> raw outputs
        [..., 4] as (r, g, b, sigma), or [..., output_ch] (the offset nets'
        output scaling is `OffsetNet.forward`'s)."""
        h = input_pts
        for i, lin in enumerate(self.pts_linears):
            h = torch.relu(lin(h))
            if i in self.spec.skips:
                h = torch.cat([input_pts, h], dim=-1)
        if self.spec.use_viewdirs:
            alpha = self.alpha_linear(h)
            feature = self.feature_linear(h)
            h = torch.cat([feature, input_views], dim=-1)
            for lin in self.views_linears:
                h = torch.relu(lin(h))
            return torch.cat([self.rgb_linear(h), alpha], dim=-1)
        return self.output_linear(h)


class Joiner(nn.Module):
    """Embedder + NeRF; holds the MLP as `.nerf` like the reference."""

    def __init__(self, spec: JoinerSpec, device=None):
        super().__init__()
        self.spec = spec
        self.nerf = NeRF(spec.nerf, device=device)

    def forward(self, input_pts, input_views=None):
        return apply_joiner(self.spec, self.nerf, input_pts, input_views)


def apply_joiner(spec: JoinerSpec, nerf, input_pts, input_views=None):
    """The PE of `spec` and the NeRF module `nerf` on raw points [..., D]
    and view directions [..., 3]: raw outputs [..., 4]."""
    pts = embedder_module.embed(spec.pos_pe, input_pts)
    views = None
    if input_views is not None and spec.nerf.use_viewdirs:
        views = embedder_module.embed(spec.dir_pe, input_views)
    return nerf(pts, views)


class OffsetNet(nn.Module):
    """Embedder on (x, y, z, t) + NeRF with an `output_linear` head (the
    render path loads it but does not run it)."""

    def __init__(self, spec: OffsetNetSpec, device=None):
        super().__init__()
        self.spec = spec
        self.nerf = NeRF(spec.nerf, device=device)

    def forward(self, axes, scale, compute_dtype=torch.float32, mlp=None):
        """Offset planes 3 x [R, S] of the input planes `axes` (x, y, z, t,
        each [R, S]): the fused MLP and the output scaling of
        spec.nerf.scale_type with the per-step scalar `scale`, as
        neuman_tpu's `offset_net_planar`. `mlp` is the fused MLP:
        `offset_mlp_fn` (the kernel pair on the card) unless a check passes
        a plain version of it."""
        if mlp is None:
            from neuman_tpu_torch.ops.kernels.offset_mlp import offset_mlp_fn as mlp

        raw = mlp(self.spec, self.nerf, axes, compute_dtype)
        scale_type = self.spec.nerf.scale_type
        if scale_type == "linear":
            return [o * scale for o in raw]
        if scale_type == "tanh":
            return [torch.tanh(o) * scale for o in raw]
        if scale_type != "no":
            raise ValueError(scale_type)
        return raw
