"""Ray batches drawn on the device (counterpart of
neuman_tpu/datasets/sampler.py).

`sample_background_batch` draws rays uniformly over the train views, each
on a pixel outside the (dilated) human mask. `sample_human_batch` draws one
view per batch and stratifies its rays into body / border / background
pools by static counts, optionally with a leading 32x32 patch seeded on a
body pixel (for the LPIPS loss), and computes each ray's human near/far
from the posed vertices. Both draw from a torch.Generator on the arrays'
device: no host round trip. The batches have the JAX sampler's keys.
"""

import numpy as np
import torch

from neuman_tpu_torch.datasets.arrays import RaySceneArrays
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.utils.constants import PATCH_SIZE, PATCH_SIZE_SQUARED


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


def num_rays_split(num, body_ratio, border_ratio, bkg_ratio, dilation=30):
    """Static body / border / background ray counts of a batch of `num`."""
    arr = np.array([int(round(num * body_ratio)),
                    int(round(num * border_ratio)) if dilation > 0 else 0,
                    int(round(num * bkg_ratio))])
    arr[arr.argmax()] += num - arr.sum()
    if arr.min() < 0:
        raise ValueError(f"ray ratios give negative counts: {arr}")
    return int(arr[0]), int(arr[1]), int(arr[2])


def _sample_pool(generator, arrays, vid, offset, count, n):
    """n uniform flat pixel ids of view `vid` from the class pool
    perm[vid, offset : offset + count] (offset, count: 0-dim tensors)."""
    u = torch.rand(n, generator=generator, device=arrays.perm.device)
    idx = (offset + torch.floor(u * count.float()).long()).clamp(0, arrays.perm.shape[1] - 1)
    return arrays.perm[vid, idx]


def _patch_coords(generator, arrays, vid):
    """Flat pixel ids [1024] of a 32x32 patch seeded on a random body pixel
    of view `vid` and clamped into the image, row-major."""
    h, w = arrays.hw
    zero = torch.zeros((), dtype=torch.int64, device=arrays.perm.device)
    seed = _sample_pool(generator, arrays, vid, zero, arrays.body_count[vid], 1)[0]
    lux = (seed % w - PATCH_SIZE // 2).clamp(0, w - PATCH_SIZE)
    luy = (torch.div(seed, w, rounding_mode="floor") - PATCH_SIZE // 2).clamp(0, h - PATCH_SIZE)
    d = torch.arange(PATCH_SIZE, device=arrays.perm.device)
    return ((luy + d)[:, None] * w + (lux + d)[None, :]).reshape(-1)


def _stratified_coords(generator, arrays, vid, counts):
    """Body / border / background stratified flat pixel ids of view `vid`.
    The human stage's background pool is every pixel outside the mask (the
    border ring included): perm[body_count:]."""
    n_body, n_border, n_bkg = counts
    body, border = arrays.body_count[vid], arrays.border_count[vid]
    hw = arrays.perm.shape[1]
    segs = []
    for n, offset, count in ((n_body, torch.zeros_like(body), body), (n_border, body, border),
                             (n_bkg, body, hw - body)):
        if n > 0:
            segs.append(_sample_pool(generator, arrays, vid, offset, count, n))
    return torch.cat(segs)


def human_batch_from_pixels(arrays: RaySceneArrays, vid, flat_pix, geo_threshold,
                            patch_counter):
    """The human-stage batch of the flat pixel ids `flat_pix` [B] of view
    `vid` (a 0-dim tensor): rays, colours, background near/far, and each
    ray's human near/far from the posed vertices (the view's defaults where
    the ray misses the body; `is_hit` says which)."""
    n = flat_pix.shape[0]
    vids = vid.expand(n)
    origin, direction, color, mask, _, _ = _rays_from_pixels(arrays, vids, flat_pix)
    near, far = ray_ops.geometry_guided_near_far(origin, direction, arrays.verts[vid],
                                                 geo_threshold)
    valid = near < far
    return {
        "color": color,
        "origin": origin,
        "direction": direction,
        "human_near": torch.where(valid, near, arrays.near_human[vid])[:, None],
        "human_far": torch.where(valid, far, arrays.far_human[vid])[:, None],
        "bkg_near": arrays.near_bkg[vid].expand(n)[:, None],
        "bkg_far": arrays.far_bkg[vid].expand(n)[:, None],
        "is_bkg": (mask == 0).to(torch.int32),
        "is_hit": valid.to(torch.int32),
        "cur_view_f": arrays.viewf[vid],
        "cap_id": vid,
        "patch_counter": patch_counter,
    }


def sample_human_batch(generator, arrays: RaySceneArrays, view_ids, geo_threshold, batch_size,
                       ratios=(0.95, 0.05, 0.0), use_patch=True, dilation=30):
    """Human-stage ray batch from one random view of `view_ids`. With
    use_patch the first 1024 rays are, with probability `body_ratio`, a
    32x32 patch (patch_counter 1), else stratified like the rest."""
    device = arrays.perm.device
    vid = view_ids[torch.randint(0, view_ids.shape[0], (), generator=generator, device=device)]
    if use_patch:
        if batch_size <= PATCH_SIZE_SQUARED:
            raise ValueError(f"a patch batch needs more than {PATCH_SIZE_SQUARED} rays")
        counts1 = num_rays_split(PATCH_SIZE_SQUARED, *ratios, dilation)
        counts2 = num_rays_split(batch_size - PATCH_SIZE_SQUARED, *ratios, dilation)
        need_patch = torch.rand((), generator=generator, device=device) < ratios[0]
        seg1 = torch.where(need_patch, _patch_coords(generator, arrays, vid),
                           _stratified_coords(generator, arrays, vid, counts1))
        flat_pix = torch.cat([seg1, _stratified_coords(generator, arrays, vid, counts2)])
        patch_counter = need_patch.to(torch.int32)
    else:
        flat_pix = _stratified_coords(generator, arrays, vid,
                                      num_rays_split(batch_size, *ratios, dilation))
        patch_counter = torch.zeros((), dtype=torch.int32, device=device)
    return human_batch_from_pixels(arrays, vid, flat_pix, geo_threshold, patch_counter)
