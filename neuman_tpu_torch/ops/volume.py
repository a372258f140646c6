"""Planar sample sets: z sampling, importance z, z-merge, integration.

Counterpart of the planar helpers in neuman_tpu/ops/fused.py (sample_z,
importance_z, sort_merge_planar, integrate_planar). A "planar" sample set
is z [R, S] with raw sigma [R, S] and three raw colour planes [R, S].
Each op has one formulation here: the gather-free CDF, bitonic merge and
rank merge of the JAX package exist for the TPU's layout only.
"""

import torch

from neuman_tpu_torch.ops.rays import sample_pdf, sample_z_vals

sample_z = sample_z_vals


def importance_z(z_vals, weights, n):
    """Coarse z [R, S] + n deterministic inverse-CDF samples, sorted."""
    z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    z_samples = sample_pdf(z_mid, weights[:, 1:-1], n).detach()
    return torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values


def sort_merge_planar(z_list, sigma_list, rgb_c_list):
    """Merge per-ray sample sets by z. Stable: on equal z the earlier list
    wins, as in the JAX rank merge. Returns (z, sigma, rgb_c)."""
    z = torch.cat(z_list, dim=-1)
    z, order = torch.sort(z, dim=-1, stable=True)
    take = lambda planes: torch.cat(planes, dim=-1).gather(1, order)
    sigma = take(sigma_list)
    rgb_c = [take([rgb[c] for rgb in rgb_c_list]) for c in range(3)]
    return z, sigma, rgb_c


def integrate_planar(sigma, rgb_c, z_vals, dir_norm, white_bkg=True,
                     raw_noise_std=0.0, generator=None, randn=torch.randn):
    """Volume rendering of raw outputs. sigma, z_vals [R, S]; rgb_c 3x[R, S];
    dir_norm [R]. With raw_noise_std > 0 the densities get Gaussian noise
    drawn from `generator` (on sigma's device) by `randn` (torch.randn's
    signature). Returns (rgb [R, 3], disp [R], acc [R], weights [R, S],
    depth [R])."""
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    dists = dists * dir_norm[:, None]
    if raw_noise_std > 0.0:
        noise = randn(sigma.shape, generator=generator, device=sigma.device)
        sigma = sigma + noise * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1
    )[:, :-1]
    weights = alpha * trans
    rgb = torch.stack([(weights * torch.sigmoid(c)).sum(-1) for c in rgb_c], dim=-1)
    depth = (weights * z_vals).sum(-1)
    acc = weights.sum(-1)
    disp = 1.0 / torch.clamp(depth / acc, min=1e-10)
    if white_bkg:
        rgb = rgb + (1.0 - acc[:, None])
    return rgb, disp, acc, weights, depth
