"""Ray batches drawn on the device (counterpart of the background half of
neuman_tpu/datasets/sampler.py).

`sample_background_batch` draws rays uniformly over the train views, each
on a pixel outside the (dilated) human mask, from a torch.Generator on the
arrays' device: no host round trip. The batch has the JAX sampler's keys.
"""

import torch

from neuman_tpu_torch.datasets.arrays import RaySceneArrays


def _rays_from_pixels(arrays: RaySceneArrays, vids, flat_pix):
    """Per-ray (origin, unit direction, colour, mask, x, y) of (view id,
    flat pixel id) pairs. The small products are written out as sums, so
    they stay f32 on the card."""
    h, w = arrays.hw
    xi, yi = flat_pix % w, torch.div(flat_pix, w, rounding_mode="floor")
    pix = torch.stack([xi.float(), yi.float(), torch.ones_like(xi, dtype=torch.float32)], -1)
    k_inv = torch.linalg.inv(arrays.intrinsics)[vids]  # [B, 3, 3]
    cam_pts = (k_inv * pix[:, None, :]).sum(-1)
    c2w = arrays.c2w[vids]
    origin = c2w[:, :3, 3]
    world = (c2w[:, :3, :3] * cam_pts[:, None, :]).sum(-1) + origin
    d = world - origin
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    color = arrays.images[vids, yi, xi].float() / 255.0
    mask = arrays.masks[vids, yi, xi]
    return origin, d, color, mask, xi, yi


def sample_background_batch(generator, arrays: RaySceneArrays, view_ids, batch_size,
                            use_fused_depth=True):
    """Background-stage ray batch over the train views `view_ids` (a tensor
    of capture-array indices on the arrays' device), each ray on a pixel
    outside the body and its border."""
    device = arrays.images.device
    vidx = torch.randint(0, view_ids.shape[0], (batch_size,), generator=generator, device=device)
    vids = view_ids[vidx]
    hw = arrays.perm.shape[1]
    offset = arrays.body_count[vids] + arrays.border_count[vids]
    count = hw - offset
    u = torch.rand(batch_size, generator=generator, device=device)
    idx = (offset + torch.floor(u * count.float()).long()).clamp(0, hw - 1)
    flat_pix = arrays.perm[vids, idx]
    origin, direction, color, _, xi, yi = _rays_from_pixels(arrays, vids, flat_pix)
    depth_src = arrays.fused_depths if use_fused_depth else arrays.depths
    return {
        "color": color,
        "depth": depth_src[vids, yi, xi],
        "origin": origin,
        "direction": direction,
        "near": arrays.near_bkg[vids][:, None],
        "far": arrays.far_bkg[vids][:, None],
        "is_bkg": torch.ones(batch_size, dtype=torch.int32, device=device),
        "viewf_list": arrays.viewf[vids][:, None],
    }
