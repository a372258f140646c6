"""SMPL's linear blend skinning (Loper et al. 2015), plain: shape blend
shapes, joints by the regressor, Rodrigues rotations, the kinematic chain
and the per-vertex blend of the joints' transforms. Pose blend shapes are
left out, as NeuMan leaves them out of its warp.

`da_to_posed` gives what NeuMan's warp consumes for one frame: the posed
vertices and the per-vertex transforms from the Da pose (hips spread by
+-1 rad about z) to the frame's pose, T = scale . alignment^T .
T_pose . T_da^-1, differentiable in the pose.
"""

import torch


def rodrigues(r):
    """Axis-angle [N, 3] -> rotation matrices [N, 3, 3]."""
    angle = torch.linalg.norm(r + 1e-8, dim=1, keepdim=True)
    axis = r / angle
    cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    x, y, z = axis.unbind(1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], 1).reshape(-1, 3, 3)
    return torch.eye(3, device=r.device)[None] + sin * k + (1 - cos) * (k @ k)


def skinning(body, betas, pose):
    """betas [nb], pose [J*3] -> (per-vertex transforms [V, 4, 4], rest
    vertices [V, 3], joints [J, 3])."""
    v_shaped = body["v_template"] + torch.einsum("l,vkl->vk", betas, body["shapedirs"])
    joints = body["J_regressor"] @ v_shaped
    parents = body["parents"]
    rot = rodrigues(pose.reshape(-1, 3))
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[list(parents[1:])]
    local = torch.zeros(len(parents), 4, 4, device=pose.device)
    local[:, :3, :3] = rot
    local[:, :3, 3] = rel
    local[:, 3, 3] = 1.0
    chain = [local[0]]
    for i in range(1, len(parents)):
        chain.append(chain[parents[i]] @ local[i])
    g = torch.stack(chain)
    g = torch.cat([g[:, :3, :3], (g[:, :3, 3] - (g[:, :3, :3] @ joints[..., None])[..., 0])[..., None]],
                  -1)
    g = torch.cat([g, torch.tensor([0.0, 0.0, 0.0, 1.0], device=pose.device).expand(len(parents), 1, 4)], 1)
    t = (body["lbs_weights"] @ g.reshape(len(parents), 16)).reshape(-1, 4, 4)
    return t, v_shaped, joints


def da_pose(num_joints=24, device=None):
    da = torch.zeros(num_joints, 3, device=device)
    da[1, 2], da[2, 2] = 1.0, -1.0
    return da.reshape(-1)


def da_to_posed(body, betas, pose, scale=1.0, alignment=None):
    """(posed vertices [V, 3], Da -> posed transforms [V, 4, 4], Da-pose
    vertices [V, 3]) of one frame."""
    t_pose = skinning(body, betas, pose)[0]
    t_da, v_shaped, _ = skinning(body, betas, da_pose(len(body["parents"]), pose.device))
    da_verts = (t_da[:, :3, :3] @ v_shaped[..., None])[..., 0] + t_da[:, :3, 3]
    m = torch.eye(4, device=pose.device)
    m[:3, :3] = m[:3, :3] * scale
    if alignment is not None:
        m = m @ alignment.T
    ts = m @ t_pose @ torch.linalg.inv(t_da)
    verts = (ts[:, :3, :3] @ da_verts[..., None])[..., 0] + ts[:, :3, 3]
    return verts, ts, da_verts

