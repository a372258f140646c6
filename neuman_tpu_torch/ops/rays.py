"""Ray generation and sampling (counterpart of neuman_tpu/ops/rays.py)."""

import torch

from neuman_tpu_torch.ops.kernels.hit_test import hit_test
from neuman_tpu_torch.ops.precision import matmul_f32
from neuman_tpu_torch.utils.constants import PERTURB_EPSILON


def image_coords(h, w, device=None):
    """All pixel (x, y) coords of an HxW image, row-major. [H*W, 2] f32."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).float()


def pixels_to_rays(xy, intrinsic, cam2world):
    """xy [N, 2], intrinsic [3, 3], cam2world [4, 4] ->
    (origins [N, 3], unit dirs [N, 3])."""
    pix = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    cam_pts = matmul_f32(pix, torch.linalg.inv(intrinsic).T)
    homog = torch.cat([cam_pts, torch.ones_like(cam_pts[:, :1])], dim=-1)
    world_pts = matmul_f32(homog, cam2world.T)
    origin = cam2world[:3, 3]
    dirs = world_pts[:, :3] - origin
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return origin.expand_as(dirs), dirs


def sample_z_vals(near, far, samples_per_ray, perturb=0.0, generator=None, rand=torch.rand):
    """z values [R, S] between near and far ([R] or [R, 1]): evenly spaced,
    or with perturb > 0 one uniform draw from `generator` (a torch.Generator
    on near's device) inside each stratum, clipped away from its edges.
    `rand` draws it (torch.rand's signature)."""
    t = torch.linspace(0.0, 1.0, samples_per_ray, device=near.device)
    z = near.reshape(-1, 1) * (1.0 - t) + far.reshape(-1, 1) * t
    if perturb > 0.0:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        u = rand(z.shape, generator=generator, device=z.device)
        z = lower + (upper - lower) * u.clamp(PERTURB_EPSILON, 1 - PERTURB_EPSILON)
    return z


def sample_pdf(bins, weights, n_samples):
    """Deterministic inverse-CDF sampling: bins [R, B], weights [R, B-1]
    -> z samples [R, n_samples], nondecreasing along each ray."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [R, B]
    u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device).expand(cdf.shape[0], n_samples)
    # last bin whose cdf <= u, and the one after it (clamped to the end)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = cdf.gather(1, below), cdf.gather(1, above)
    bins_below, bins_above = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def geometry_guided_near_far(origin, direction, verts, geo_threshold):
    """Per-ray near/far from ray-sphere tests against body vertices.

    origin/direction [R, 3], verts [V, 3]. Rays that miss every sphere of
    radius geo_threshold get near=+inf, far=-inf (near >= far <=> miss).
    CUDA tensors go to the `hit_test` kernel (ops/kernels/hit_test.py),
    CPU tensors to `geometry_guided_near_far_plain`.
    """
    if origin.is_cuda:
        return hit_test(origin, direction, verts, geo_threshold)
    if origin.device.type != "cpu":
        raise ValueError(f"geometry_guided_near_far: no kernel for device {origin.device}")
    return geometry_guided_near_far_plain(origin, direction, verts, geo_threshold)


def geometry_guided_near_far_plain(origin, direction, verts, geo_threshold):
    """`geometry_guided_near_far` in plain PyTorch, as the JAX function
    computes it (two [R, 3] x [3, V] products and [R, V] passes): the CPU
    path, and the kernel's plain twin on the card (`use_kernels=False`)."""
    z0 = matmul_f32(direction, verts.T) - (direction * origin).sum(-1, keepdim=True)
    v2 = (verts * verts).sum(-1)[None, :]
    o2 = (origin * origin).sum(-1, keepdim=True)
    dist2 = v2 - 2.0 * matmul_f32(origin, verts.T) + o2
    dz = torch.sqrt(geo_threshold**2 - (dist2 - z0**2))  # NaN where missed
    miss = torch.isnan(dz)
    near = torch.where(miss, torch.inf, z0 - dz).amin(dim=1)
    far = torch.where(miss, -torch.inf, z0 + dz).amax(dim=1)
    return near, far
