"""HumanNeRF composite (counterpart of neuman_tpu/models/human_nerf.py).

Coarse and fine background joiners, the canonical ("coarse human") joiner
with min_freq 0, the `can_posenc` mapping and viewdirs gated by
`specular_can`, and N offset nets; with `poses` given, also the learnable
per-frame SMPL state (`poses`, `betas`, `alignments`) and `vertex_forward`.
The render path runs the background nets and the canonical net; the human
trainer runs all of it.
"""

import dataclasses

import numpy as np
import torch
from torch import nn

from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.models import smpl as smpl_module


@dataclasses.dataclass(frozen=True)
class HumanNeRFSpec:
    bkg: nerf_module.JoinerSpec
    human: nerf_module.JoinerSpec
    offset: nerf_module.OffsetNetSpec
    num_offset_nets: int = 1


def build_human_nerf_spec(opt):
    can_opt = dataclasses.replace(
        opt, pos_min_freq=0, use_viewdirs=opt.specular_can, posenc=opt.can_posenc
    )
    return HumanNeRFSpec(
        bkg=nerf_module.build_nerf_specs(opt),
        human=nerf_module.build_nerf_specs(can_opt),
        offset=nerf_module.build_offset_net_spec(opt),
        num_offset_nets=opt.num_offset_nets,
    )


class HumanNeRF(nn.Module):
    def __init__(self, spec: HumanNeRFSpec, device=None, generator=None, poses=None,
                 betas=None, alignments=None):
        """generator: the CPU torch.Generator every initial weight is
        drawn from (None draws from torch's default generator). poses
        [N, J*3], betas [N, nb], alignments [N, 4, 4]: the per-frame SMPL
        state of the human trainer (all three or none); only `poses` is
        trained."""
        super().__init__()
        self.spec = spec
        self.coarse_bkg_net = nerf_module.Joiner(spec.bkg, device=device)
        self.fine_bkg_net = nerf_module.Joiner(spec.bkg, device=device)
        self.coarse_human_net = nerf_module.Joiner(spec.human, device=device)
        self.offset_nets = nn.ModuleList(
            nerf_module.OffsetNet(spec.offset, device=device)
            for _ in range(spec.num_offset_nets)
        )
        for net in [self.coarse_bkg_net, self.fine_bkg_net,
                    self.coarse_human_net, *self.offset_nets]:
            net.nerf.reset_parameters(generator)
        if poses is not None:
            as_param = lambda a, grad: nn.Parameter(
                torch.tensor(np.asarray(a, np.float32), device=device), requires_grad=grad)
            self.poses = as_param(poses, True)
            self.betas = as_param(betas, False)
            self.alignments = as_param(alignments, False)


def da_pose_params(num_joints=24, device=None):
    """The Da-pose vector [1, J*3] (a constant of the model)."""
    return smpl_module.da_pose_vector(num_joints, device)


def _affine_cols(t):
    """[V, 4, 4] affine -> 12 columns (row-major upper 3x4)."""
    return tuple(t[:, i, j] for i in range(3) for j in range(4))


def _affine_inv_cols(c):
    """Closed-form affine inverse on columns: R' = adj(R)/det, t' = -R't."""
    m00, m01, m02, t0, m10, m11, m12, t1, m20, m21, m22, t2 = c
    det = (m00 * (m11 * m22 - m12 * m21) - m01 * (m10 * m22 - m12 * m20)
           + m02 * (m10 * m21 - m11 * m20))
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    i00 = (m11 * m22 - m12 * m21) / det
    i01 = (m02 * m21 - m01 * m22) / det
    i02 = (m01 * m12 - m02 * m11) / det
    i10 = (m12 * m20 - m10 * m22) / det
    i11 = (m00 * m22 - m02 * m20) / det
    i12 = (m02 * m10 - m00 * m12) / det
    i20 = (m10 * m21 - m11 * m20) / det
    i21 = (m01 * m20 - m00 * m21) / det
    i22 = (m00 * m11 - m01 * m10) / det
    tp0 = -(i00 * t0 + i01 * t1 + i02 * t2)
    tp1 = -(i10 * t0 + i11 * t1 + i12 * t2)
    tp2 = -(i20 * t0 + i21 * t1 + i22 * t2)
    return (i00, i01, i02, tp0, i10, i11, i12, tp1, i20, i21, i22, tp2)


def _affine_compose(a, b):
    """C = A @ B on 12-column affines; A's entries may be per-vertex
    columns or the scalars of one constant matrix."""
    out = []
    for i in range(3):
        ar = a[4 * i: 4 * i + 4]
        for j in range(3):
            out.append(ar[0] * b[j] + ar[1] * b[4 + j] + ar[2] * b[8 + j])
        out.append(ar[0] * b[3] + ar[1] * b[7] + ar[2] * b[11] + ar[3])
    return tuple(out)


def vertex_forward(model: HumanNeRF, body_model, da_smpl, scale, idx):
    """World-space posed vertices and per-vertex Da-pose -> scene transforms
    of frame `idx` of the model's SMPL state:
    T = scaleEye @ alignment.T @ T_t2pose @ inv(T_t2da), verts = T @ da_verts,
    on 12 affine columns per vertex with the closed-form inverse, as the
    JAX package computes them. Differentiable in `model.poses`.
    Returns (verts [1, V, 3], T [1, V, 4, 4])."""
    pose, beta = model.poses[idx][None], model.betas[idx][None]
    t_t2pose, _, _ = smpl_module.lbs(beta, pose, body_model)
    t_t2da, _, da_verts = smpl_module.lbs(beta, da_smpl, body_model)
    t_da2pose = _affine_compose(_affine_cols(t_t2pose[0]),
                                _affine_inv_cols(_affine_cols(t_t2da[0])))
    s = torch.eye(4, dtype=pose.dtype, device=pose.device)
    s[:3, :3] *= scale
    m = s @ model.alignments[idx].T
    t_cols = _affine_compose(tuple(m[i, j] for i in range(3) for j in range(4)), t_da2pose)
    v = da_verts[0]
    world = torch.stack(
        [t_cols[4 * i] * v[:, 0] + t_cols[4 * i + 1] * v[:, 1] + t_cols[4 * i + 2] * v[:, 2]
         + t_cols[4 * i + 3] for i in range(3)], dim=-1)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device)
    t16 = torch.cat([torch.stack(t_cols, dim=-1), last.expand(v.shape[0], 4)], dim=-1)
    return world[None], t16.reshape(1, v.shape[0], 4, 4)
