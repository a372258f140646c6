"""SMPL linear blend skinning (counterpart of neuman_tpu/models/smpl.py).

Produces what the warps consume: posed world vertices and the per-vertex
Da-pose -> scene transforms `Ts` (the scene reader, data_io/neuman.py,
computes them per frame with `lbs_joints`; the trainer's differentiable
`vertex_forward` is in models/human_nerf.py). Like the reference, pose
blend shapes are computed-and-discarded there, so they are skipped here
(v_posed == v_shaped). `load_smpl` reads an `SMPL_NEUTRAL.pkl`.
"""

import dataclasses
import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from neuman_tpu_torch.utils.synthetic_body import synthetic_body_mesh


@dataclass
class SMPLModel:
    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, B]
    J_regressor: torch.Tensor  # [J, V]
    lbs_weights: torch.Tensor  # [V, J]
    parents: tuple  # len J, parents[0] == -1
    faces: np.ndarray  # [F, 3] int32

    @classmethod
    def from_numpy(cls, v_template, shapedirs, J_regressor, lbs_weights,
                   parents, faces, device=None):
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(t(v_template), t(shapedirs), t(J_regressor), t(lbs_weights),
                   tuple(int(p) for p in parents), np.asarray(faces, np.int32))

    def to(self, device):
        """The model with its buffers on `device`."""
        return dataclasses.replace(self, **{k: getattr(self, k).to(device) for k in (
            "v_template", "shapedirs", "J_regressor", "lbs_weights")})

    @property
    def num_verts(self):
        return self.v_template.shape[0]

    @property
    def num_joints(self):
        return self.J_regressor.shape[0]


def _to_dense(a):
    if hasattr(a, "todense"):  # the scipy sparse J_regressor
        a = a.todense()
    return np.array(a, dtype=np.float32)


def load_smpl(model_path, gender="neutral", device=None):
    """An SMPL pickle (`SMPL_<GENDER>.pkl`, or the directory holding it) as
    an SMPLModel, as neuman_tpu.models.smpl.load_smpl reads it: latin-1
    pickle, dense float32 buffers, parents from the kinematic tree with
    parents[0] = -1. The pose blend shapes are not read (unused)."""
    if os.path.isdir(model_path):
        model_path = os.path.join(model_path, f"SMPL_{gender.upper()}.pkl")
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"Path {model_path} does not exist!")
    with open(model_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    parents = _to_dense(data["kintree_table"]).astype(np.int64)[0]
    parents[0] = -1
    return SMPLModel.from_numpy(_to_dense(data["v_template"]), _to_dense(data["shapedirs"]),
                                _to_dense(data["J_regressor"]), _to_dense(data["weights"]),
                                parents, np.array(data["f"], dtype=np.int32), device=device)


def body_proxy_smpl_model(subdivisions=5, num_joints=24, num_betas=10, seed=0,
                          device=None):
    """SMPL-like model on the smooth body-proxy surface: the same buffers,
    drawn from the same numpy generators, as
    neuman_tpu.utils.synthetic_body.body_proxy_smpl_model."""
    verts, faces = synthetic_body_mesh(subdivisions=subdivisions, seed=seed)
    num_verts = verts.shape[0]
    rng = np.random.default_rng(seed + 1)
    shapedirs = rng.normal(size=(num_verts, 3, num_betas)) * 0.01
    rng.normal(size=((num_joints - 1) * 9, num_verts * 3))  # posedirs: unused
    j_reg = rng.uniform(size=(num_joints, num_verts)).astype(np.float32)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    w = rng.uniform(size=(num_verts, num_joints)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    parents = [-1] + list(range(num_joints - 1))
    return SMPLModel.from_numpy(verts, shapedirs, j_reg, w, parents, faces, device=device)


def da_pose_vector(num_joints=24, device=None):
    """The Da rest pose: hips spread by +-1 rad about z. [1, J*3]."""
    da = torch.zeros(num_joints, 3, device=device)
    da[1, 2] = 1.0
    da[2, 2] = -1.0
    return da.reshape(1, -1)


def batch_rodrigues(rot_vecs, epsilon=1e-8):
    """Axis-angle [N, 3] -> rotation matrices [N, 3, 3]."""
    angle = torch.linalg.norm(rot_vecs + epsilon, dim=1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]
    rx, ry, rz = rot_dir.unbind(1)
    zeros = torch.zeros_like(rx)
    k = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * k + (1 - cos) * torch.matmul(k, k)


def _transform_mat(rot, t):
    """rot [..., 3, 3], t [..., 3] -> homogeneous [..., 4, 4]."""
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    return torch.cat([top, bottom.expand(*rot.shape[:-2], 1, 4)], dim=-2)


def batch_rigid_transform(rot_mats, joints, parents):
    """Accumulate rigid transforms along the kinematic tree (topologically
    sorted: parents[i] < i). rot_mats [B, J, 3, 3], joints [B, J, 3] ->
    (posed joints [B, J, 3], transforms of rest-space points [B, J, 4, 4])."""
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, list(parents[1:])]
    transforms_mat = _transform_mat(rot_mats, rel_joints)
    chain = [transforms_mat[:, 0]]
    for i in range(1, len(parents)):
        chain.append(torch.matmul(chain[parents[i]], transforms_mat[:, i]))
    transforms = torch.stack(chain, dim=1)
    posed_joints = transforms[:, :, :3, 3]
    correction = torch.einsum("bjmk,bjk->bjm", transforms[..., :3, :3], joints)
    rel = transforms.clone()
    rel[..., :3, 3] -= correction
    return posed_joints, rel


def lbs_joints(betas, pose, model: SMPLModel):
    """betas [B, nb], pose [B, J*3] axis-angle -> (T [B, V, 4, 4], rest
    vertices [B, V, 3], posed vertices [B, V, 3], the joints' transforms
    [B, J, 4, 4], rest joints [B, J, 3], posed joints [B, J, 3]): the JAX
    package's lbs(return_T=True, concat_joints=True) and smpl_forward."""
    batch = max(betas.shape[0], pose.shape[0])
    v_shaped = model.v_template[None] + torch.einsum("bl,mkl->bmk", betas, model.shapedirs)
    joints = vertices2joints(model.J_regressor, v_shaped)
    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(batch, -1, 3, 3)
    posed_joints, rel = batch_rigid_transform(rot_mats, joints, model.parents)
    t_per_vert = torch.matmul(
        model.lbs_weights[None].expand(batch, -1, -1), rel.reshape(batch, -1, 16)
    ).reshape(batch, -1, 4, 4)
    verts = torch.einsum("bvij,bvj->bvi", t_per_vert[..., :3, :3], v_shaped) + t_per_vert[..., :3, 3]
    return t_per_vert, v_shaped, verts, rel, joints, posed_joints


def lbs(betas, pose, model: SMPLModel):
    """betas [B, nb], pose [B, J*3] axis-angle -> (T [B, V, 4, 4],
    rest vertices [B, V, 3], posed vertices [B, V, 3])."""
    return lbs_joints(betas, pose, model)[:3]


def vertices2joints(J_regressor, vertices):
    """J_regressor [J, V] x vertices [B, V, 3] -> joints [B, J, 3]."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def verts_transformations(model, poses, betas, transl=None, concat_joints=False):
    """(rest vertices [1, V, 3], per-vertex LBS transforms [1, V, 4, 4]);
    `transl` [1, 3] pre-multiplies the transforms by its translation. With
    `concat_joints` the rest joints follow the vertices and the joints'
    transforms follow theirs ([1, V + J, ...]), as the JAX package's
    lbs(return_T=True, concat_joints=True)."""
    t_per_vert, v_shaped, _, rel, joints, _ = lbs_joints(betas, poses, model)
    if concat_joints:
        t_per_vert = torch.cat([t_per_vert, rel], dim=1)
        v_shaped = torch.cat([v_shaped, joints], dim=1)
    if transl is not None:
        transl_mat = torch.eye(4, dtype=t_per_vert.dtype, device=t_per_vert.device)[None].repeat(
            transl.shape[0], 1, 1)
        transl_mat[:, :3, 3] = transl
        t_per_vert = torch.matmul(transl_mat[:, None], t_per_vert)
    return v_shaped, t_per_vert


def smpl_forward(model, poses, betas, transl=None):
    """(posed vertices [B, V, 3], posed joints [B, J, 3]) of poses [B, J*3]
    and betas [B, nb], both moved by `transl` [B, 3] when given."""
    _, _, verts, _, _, joints = lbs_joints(betas, poses, model)
    if transl is not None:
        verts = verts + transl[:, None]
        joints = joints + transl[:, None]
    return verts, joints


def da_pose_to_scene(model, pose, betas, scale=1.0, alignment=None):
    """World vertices and per-vertex Da-pose -> scene transforms of one
    frame, as the JAX scene reader builds them:
    T = S @ alignment.T @ T_t2pose @ inv(T_t2da), verts = T @ da_verts.

    pose [1, J*3], betas [1, nb], alignment [4, 4] (identity if None).
    Returns (verts [V, 3], Ts [V, 4, 4]).
    """
    device = model.v_template.device
    t_t2pose, _, _ = lbs(betas, pose, model)
    t_t2da, _, da_verts = lbs(betas, da_pose_vector(model.num_joints, device), model)
    t_da2pose = t_t2pose[0] @ torch.linalg.inv(t_t2da[0])
    m = torch.eye(4, device=device)
    m[:3, :3] *= scale
    if alignment is not None:
        m = m @ alignment.T
    ts = m @ t_da2pose
    verts = torch.einsum("vij,vj->vi", ts[:, :3, :3], da_verts[0]) + ts[:, :3, 3]
    return verts, ts
