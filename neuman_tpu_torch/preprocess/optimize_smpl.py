"""Per-frame SMPL pose refinement (preprocessing stage 10; the port's
counterpart of neuman_tpu/preprocess/optimize_smpl.py).

Each frame's pose is refined against (a) the 2D keypoints (COCO-17 mapped
to SMPL joints) and (b) the person's mask, through the soft face
rasteriser's silhouette (`soft_raster.py`; the per-vertex Gaussian splat
is kept as `sil_impl="splat"`). The gradient reaches only the limb
components whose DensePose parts are visible, and only while the pose is
strictly inside its joint limits; the update is optax.adam's
(`trainers.background.ScaleByAdam`). Everything is float32, and TF32 is
off on the card for the whole refinement (`precision.no_tf32`): the
projections and the skinning's products stay float32.
"""

import numpy as np
import torch

from neuman_tpu_torch.models import smpl as smpl_module
from neuman_tpu_torch.ops.precision import no_tf32
from neuman_tpu_torch.preprocess.soft_raster import soft_rasterize_silhouette
from neuman_tpu_torch.trainers.background import ScaleByAdam
from neuman_tpu_torch.trainers.human import densepose_name_to_idx
from neuman_tpu_torch.train import require_device

# SMPL joint slot -> COCO-17 keypoint
COCO_OF_SMPL = {1: 11, 2: 12, 4: 13, 5: 14, 7: 15, 8: 16, 16: 5, 17: 6, 18: 7, 19: 8,
                20: 9, 21: 10}


def coco_to_smpl(coco2d):
    """COCO-17 keypoints [17, 2] -> SMPL-24 joint slots [24, 2] (zero where
    COCO has no such joint)."""
    coco2d = np.asarray(coco2d)
    if coco2d.shape != (17, 2):
        raise ValueError(f"expected COCO-17 keypoints [17, 2], got {coco2d.shape}")
    smpl2d = np.zeros((24, 2))
    for s, c in COCO_OF_SMPL.items():
        smpl2d[s] = coco2d[c]
    return smpl2d


def turn_smpl_gradient_on(dp_mask):
    """[72] pose-gradient mask: the limb components whose DensePose parts
    appear in `dp_mask`."""
    grad_mask = np.zeros([24, 3])
    idx2name = {i: name for name, ids in densepose_name_to_idx().items() for i in ids}
    present = np.unique(dp_mask)
    visible = {idx2name[i] for i in range(1, 25) if i in present}
    rules = [("Upper Leg Left", 1, [0, 2]), ("Upper Leg Right", 2, [0, 2]),
             ("Lower Leg Left", 4, [0]), ("Lower Leg Right", 5, [0]),
             ("Left Foot", 7, [0, 1, 2]), ("Right Foot", 8, [0, 1, 2]),
             ("Upper Arm Left", 16, [1, 2]), ("Upper Arm Right", 17, [1, 2]),
             ("Lower Arm Left", 18, [1]), ("Lower Arm Right", 19, [1])]
    for name, joint, axes in rules:
        if name in visible:
            grad_mask[joint, axes] = 1
    return grad_mask.reshape(-1)


def clip_smpl_vals():
    """Joint-angle limits in radians, [72, 2] (low, high)."""
    limits = np.ones([24, 3, 2])
    limits[..., 0] *= -360
    limits[..., 1] *= 360
    limits[4] = [[0, 160], [0, 0], [0, 0]]
    limits[5] = [[0, 160], [0, 0], [0, 0]]
    limits[7] = [[-45, 90], [-60, 60], [-10, 10]]
    limits[8] = [[-45, 90], [-60, 60], [-10, 10]]
    limits[18, 1] = [-160, 0]
    limits[19, 2] = [0, 160]
    return limits.reshape(-1, 2) / 180 * np.pi


def vertex_forward(pose, betas, align, body_model, scale):
    """World vertices [V, 3] and joints [J, 3] of pose [72] and betas [10]:
    the T-pose points through their LBS transforms, the alignment [4, 4]
    and the scene scale."""
    device = pose.device
    zeros = torch.zeros((1, 3), dtype=pose.dtype, device=device)
    _, mesh_transf = smpl_module.verts_transformations(body_model, pose[None], betas[None],
                                                       transl=zeros, concat_joints=True)
    mesh_transf = align.T @ mesh_transf[0]
    s = torch.eye(4, dtype=pose.dtype, device=device)
    s[:3, :3] *= scale
    mesh_transf = s @ mesh_transf
    t_verts, t_joints = smpl_module.smpl_forward(body_model, torch.zeros_like(pose)[None],
                                                 betas[None], transl=zeros)
    all_pts = torch.cat([t_verts[0], t_joints[0]], dim=0)
    homog = torch.cat([all_pts, torch.ones_like(all_pts[:, :1])], dim=-1)
    world = torch.einsum("nij,nj->ni", mesh_transf, homog)[:, :3]
    nv = body_model.num_verts
    return world[:nv], world[nv:]


def soft_silhouette(verts_img, h, w, sigma=2.0, stride=4):
    """Per-vertex Gaussian splat silhouette [ceil(h / stride), ceil(w /
    stride)] of pixel coordinates [V, 2], product-of-transparency blend."""
    gy, gx = torch.meshgrid(
        torch.arange(0, h, stride, dtype=verts_img.dtype, device=verts_img.device),
        torch.arange(0, w, stride, dtype=verts_img.dtype, device=verts_img.device),
        indexing="ij")
    d2 = ((gx[None] - verts_img[:, 0][:, None, None]) ** 2
          + (gy[None] - verts_img[:, 1][:, None, None]) ** 2)
    occ = torch.exp(-d2 / (2 * sigma ** 2))
    return 1.0 - torch.prod(1.0 - torch.clamp(occ, 0, 0.9999), dim=0)


class FrameRefiner:
    """One frame's refinement problem on `device`: `loss(pose)` and
    `gated_grad(pose)`, and `run(num_iters)` (optax.adam's rule from
    `pose0`).

    cap: a capture with .shape, .intrinsic_matrix, .cam_pose, .binary_mask,
    .keypoints [17, 3] and .densepose; smpl_frame: {"pose" [72], "betas"
    [10]}; align [4, 4]; scale: the scene scale. sil_impl "face" (the soft
    face rasteriser, sigma 1e-4 NDC^2 by default) or "splat" (sigma 2 px).
    """

    def __init__(self, cap, smpl_frame, body_model, align, scale, lr=5e-3, sil_stride=4,
                 sil_weight=1.0, sil_impl="face", sil_sigma=None, device="cuda"):
        if sil_impl not in ("face", "splat"):
            raise ValueError(f"sil_impl is 'face' or 'splat', not {sil_impl!r}")
        require_device(device, "optimize_smpl_frame")
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.device = torch.device(device)
        self.pose0 = f32(smpl_frame["pose"])
        self.betas = f32(smpl_frame["betas"])
        self.align = f32(align)
        self.scale = scale
        self.body_model = body_model.to(self.device)
        self.h, self.w = cap.shape
        self.k_mat = f32(cap.intrinsic_matrix)
        self.w2c = f32(cap.cam_pose.world_to_camera)
        self.mask_target = f32(cap.binary_mask[::sil_stride, ::sil_stride])
        keypoints = np.asarray(cap.keypoints, dtype=np.float64).copy()
        keypoints[keypoints[:, 2] < 0.3] = 0
        joints_target = coco_to_smpl(keypoints[:, :2])
        self.joints_mask = f32(joints_target.sum(axis=1) != 0)
        self.joints_target = f32(joints_target)
        self.grad_mask = f32(turn_smpl_gradient_on(cap.densepose))
        self.limits = f32(clip_smpl_vals())
        self.faces = torch.as_tensor(np.asarray(body_model.faces), dtype=torch.long,
                                     device=self.device)
        self.lr, self.sil_stride, self.sil_weight = lr, sil_stride, sil_weight
        self.sil_impl = sil_impl
        default_sigma = 1e-4 if sil_impl == "face" else 2.0
        self.sil_sigma = default_sigma if sil_sigma is None else sil_sigma

    def project(self, pts):
        """(pixels [N, 2], camera-space depth [N]) of world points."""
        cam = pts @ self.w2c[:3, :3].T + self.w2c[:3, 3]
        img = cam @ self.k_mat.T
        return img[:, :2] / img[:, 2:3], cam[:, 2]

    def loss(self, pose):
        """Keypoint MSE + sil_weight x silhouette MSE of `pose` [72]."""
        verts, joints = vertex_forward(pose, self.betas, self.align, self.body_model, self.scale)
        pj, _ = self.project(joints)
        kp_loss = (torch.sum(self.joints_mask[:, None] * (pj - self.joints_target) ** 2)
                   / torch.clamp(self.joints_mask.sum() * 2, min=1.0))
        vi, vz = self.project(verts)
        if self.sil_impl == "face":
            sil = soft_rasterize_silhouette(vi, self.faces, self.h, self.w, sigma=self.sil_sigma,
                                            stride=self.sil_stride, vert_z=vz)
        else:
            sil = soft_silhouette(vi, self.h, self.w, sigma=self.sil_sigma,
                                  stride=self.sil_stride)
        return kp_loss + self.sil_weight * torch.mean((sil - self.mask_target) ** 2)

    def gated_grad(self, pose):
        """(loss, gradient [72]) at `pose`, the gradient kept only on the
        DensePose-visible limb components strictly inside their limits."""
        with no_tf32():
            p = pose.detach().requires_grad_(True)
            loss = self.loss(p)
            (g,) = torch.autograd.grad(loss, p)
        valid = ((pose < self.limits[:, 1]) & (pose > self.limits[:, 0])).to(g.dtype)
        return loss.detach(), g * self.grad_mask * valid

    def run(self, num_iters):
        """The pose [72] after `num_iters` Adam steps from pose0."""
        pose = self.pose0.clone()
        named = {"smpl": {"pose": pose}}
        adam = ScaleByAdam()
        state = adam.init(named)
        keep = torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(num_iters):
            _, g = self.gated_grad(pose)
            adam.step(named, {"smpl": {"pose": g}}, state, self.lr, keep)
        return pose


def optimize_smpl_frame(cap, smpl_frame, body_model, align, scale, num_iters=100, lr=5e-3,
                        sil_stride=4, sil_weight=1.0, sil_impl="face", sil_sigma=None,
                        device="cuda"):
    """The refined pose [72] (float32 numpy) of one frame; see FrameRefiner."""
    refiner = FrameRefiner(cap, smpl_frame, body_model, align, scale, lr=lr,
                           sil_stride=sil_stride, sil_weight=sil_weight, sil_impl=sil_impl,
                           sil_sigma=sil_sigma, device=device)
    return refiner.run(num_iters).cpu().numpy()
