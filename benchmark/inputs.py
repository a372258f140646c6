"""Every input of a cell, made from its seed on the device: the networks'
weights, the LPIPS weights, the body's per-frame poses and the scene (the
views' images, masks, depth maps and cameras).

Weights are drawn in one `torch.rand` call a network from a generator on
the device seeded with the seed, in a fixed order (background coarse,
background fine, canonical, offset, LPIPS), so that one seed gives every
cell the same networks. The scene is a video of `frames` frames: the body
at the origin in a pose that moves from frame to frame, seen by a camera
that moves along an arc around it. Both the program and the reference are
handed these tensors; neither derives them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import body as body_mod
from benchmark.reference import nerf as nerf_ref
from benchmark.reference import smpl as smpl_ref

NETS = ("bkg_coarse", "bkg_fine", "can", "off")
LPIPS_CONVS = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]


def pe_channels(dims, n_freqs):
    return dims + 2 * n_freqs * dims


def net_shapes(cfg, net):
    """[(name, shape, fan_in)] of network `net` of the configuration."""
    w, depth = cfg["nerf_width"], cfg["nerf_depth"]
    pos, views = pe_channels(3, cfg["pos_N_freqs"]), pe_channels(3, cfg["dir_N_freqs"])
    if net == "off":
        return nerf_ref.layer_shapes(w, depth, (4,), pe_channels(4, cfg["pos_N_freqs"]), 0, 3,
                                     viewdirs=False)
    return nerf_ref.layer_shapes(w, depth, (4,), pos, views)


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def weights(cfg, gen, nets, alpha_bias=0.5):
    """{net: {name: tensor}} of the first len(nets) networks of NETS (the
    order is fixed), nn.Linear's U(+-1/sqrt(fan_in)); the density head's
    bias of the NeRFs set to `alpha_bias`, so that every net is alive."""
    out = {}
    for net in NETS[:len(nets)]:
        shapes = net_shapes(cfg, net)
        flat = torch.rand(sum(math.prod(s) for _, s, _ in shapes), generator=gen, device=gen.device)
        ws, at = {}, 0
        for name, shape, fan in shapes:
            n = math.prod(shape)
            ws[name] = ((flat[at:at + n] * 2.0 - 1.0) / math.sqrt(fan)).reshape(shape)
            at += n
        if "alpha_linear.bias" in ws:
            ws["alpha_linear.bias"].fill_(alpha_bias)
        out[net] = ws
    return out


def lpips_weights(gen):
    convs, lins = [], []
    for oc, ic, k in LPIPS_CONVS:
        w = (torch.rand(oc, ic, k, k, generator=gen, device=gen.device) * 2 - 1) / math.sqrt(ic * k * k)
        convs.append({"w": w, "b": torch.zeros(oc, device=gen.device)})
        lins.append(torch.rand(oc, generator=gen, device=gen.device) * 0.1)
    return {"convs": convs, "lins": lins}


def body(device):
    m = body_mod.model()
    t = lambda a: torch.as_tensor(a, device=device)
    return {"v_template": t(m["v_template"]), "shapedirs": t(m["shapedirs"]),
            "J_regressor": t(m["J_regressor"]), "lbs_weights": t(m["lbs_weights"]),
            "parents": m["parents"], "faces": t(m["faces"])}


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera-to-world [4, 4] (x right, y down, z forward) at `eye`."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    f = target - eye
    f /= np.linalg.norm(f)
    down = -(up - up.dot(f) * f)
    down /= np.linalg.norm(down)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = np.cross(down, f), down, f, eye
    return m


def intrinsics(focal, h, w):
    return np.array([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]])


def frames(traffic, gen, bod):
    """The video's per-frame poses and cameras: {"poses" [N, 72], "betas"
    [10], "k" [N, 3, 3], "c2w" [N, 4, 4], "verts" [N, V, 3] posed, "ts" [N,
    V, 4, 4] Da -> posed, "can_verts" [V, 3] Da-posed, "bone"}."""
    n, dev = traffic["frames"], gen.device
    betas = torch.randn(10, generator=gen, device=dev)
    amp = torch.rand(23 * 3, generator=gen, device=dev) * traffic["pose_amplitude"]
    phase = torch.rand(23 * 3, generator=gen, device=dev) * 2 * math.pi
    t = torch.arange(n, device=dev, dtype=torch.float32)[:, None]
    poses = torch.cat([torch.zeros(n, 3, device=dev),
                       amp * torch.sin(2 * math.pi * t / traffic["pose_period"] + phase)], 1)
    arc = np.deg2rad(traffic["arc_degrees"])
    az = np.linspace(-arc / 2, arc / 2, n)
    dist = traffic["camera_distance"]
    c2w = np.stack([look_at((dist * np.sin(a), traffic["camera_height"], -dist * np.cos(a)), (0, 0, 0))
                    for a in az])
    h, w = traffic["height"], traffic["width"]
    k = np.tile(intrinsics(traffic["focal"], h, w)[None], (n, 1, 1))
    verts, ts = [], []
    for i in range(n):
        v, tt, da = smpl_ref.da_to_posed(bod, betas, poses[i])
        verts.append(v)
        ts.append(tt)
    joints = bod["J_regressor"] @ (bod["v_template"] + torch.einsum("l,vkl->vk", betas, bod["shapedirs"]))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return {"poses": poses, "betas": betas, "k": f32(k), "c2w": f32(c2w), "verts": torch.stack(verts),
            "ts": torch.stack(ts), "can_verts": da, "bone": float(torch.linalg.norm(joints[3] - joints[0]))}


def canonical_cameras(can_verts, bod, count, dist, focal, h, w):
    """(k [count, 3, 3], c2w [count, 4, 4]) of `count` cameras on a circle
    of radius `dist` about the Da-posed body's spine (joints 0, 3, 6, 9),
    looking at it, in the plane normal to the spine."""
    joints = (bod["J_regressor"] @ can_verts).cpu().numpy().astype(np.float64)
    spine = joints[[0, 3, 6, 9]]
    center = spine.mean(0)
    up = spine[3] - spine[0]
    up /= np.linalg.norm(up)
    side = np.cross(up, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side)
    fwd = np.cross(side, up)
    c2w = []
    for a in np.linspace(-np.pi, np.pi, count + 1)[:-1]:
        eye = center + dist * (np.sin(a) * side - np.cos(a) * fwd)
        c2w.append(look_at(eye, center, up))
    dev = can_verts.device
    k = np.tile(intrinsics(focal, h, w)[None], (count, 1, 1))
    return (torch.as_tensor(k, dtype=torch.float32, device=dev),
            torch.as_tensor(np.stack(c2w), dtype=torch.float32, device=dev))


def _max_filter(m, radius):
    """Square max filter of [N, H, W] float masks (separable)."""
    x = m[:, None]
    x = F.max_pool2d(x, (1, 2 * radius + 1), 1, (0, radius))
    x = F.max_pool2d(x, (2 * radius + 1, 1), 1, (radius, 0))
    return x[:, 0]


def silhouettes(verts, k, c2w, h, w, splat=4):
    """[N, H, W] uint8 silhouettes of the posed bodies: every vertex
    projected, then closed by a square filter of `splat` pixels."""
    n = verts.shape[0]
    masks = torch.zeros(n, h * w, device=verts.device)
    for i in range(n):
        rot, eye = c2w[i, :3, :3], c2w[i, :3, 3]
        cam = (verts[i] - eye) @ rot
        x = torch.round(k[i, 0, 0] * cam[:, 0] / cam[:, 2] + k[i, 0, 2]).long()
        y = torch.round(k[i, 1, 1] * cam[:, 1] / cam[:, 2] + k[i, 1, 2]).long()
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (cam[:, 2] > 0)
        masks[i, (y * w + x)[ok]] = 1.0
    masks = _max_filter(masks.reshape(n, h, w), splat)
    return (1.0 - _max_filter(1.0 - masks, splat)).to(torch.uint8)


def scene_views(traffic, gen, fr, views, dilation):
    """The staged train views' tensors (RaySceneArrays' fields): images
    [N, H, W, 3] uint8 drawn from the seed, silhouette masks, a border ring
    of `dilation` pixels, fused depth maps drawn in [1, 5], cameras, near
    and far, frame times, the class-sorted pixel permutation and counts, and
    the posed vertices; and "classes" [N, H*W] uint8 (0 body, 1 border, 2
    background), which the program is not given."""
    dev, h, w = gen.device, traffic["height"], traffic["width"]
    n = len(views)
    idx = torch.as_tensor(views, device=dev)
    images = torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev, dtype=torch.uint8)
    fused = torch.rand(n, h, w, generator=gen, device=dev) * 4.0 + 1.0
    masks = silhouettes(fr["verts"][idx], fr["k"][idx], fr["c2w"][idx], h, w)
    ring = _max_filter(masks.float(), dilation).to(torch.uint8) - masks
    cls = torch.where(masks > 0, 0, torch.where(ring > 0, 1, 2)).to(torch.uint8).reshape(n, -1)
    perm = torch.sort(cls, dim=1, stable=True).indices
    full = lambda v: torch.full((n,), float(v), device=dev)
    return {
        "images": images, "masks": masks, "depths": torch.zeros(n, 1, 1, device=dev),
        "fused_depths": fused, "intrinsics": fr["k"][idx], "c2w": fr["c2w"][idx],
        "near_bkg": full(traffic["bkg_near"]), "far_bkg": full(traffic["bkg_far"]),
        "near_human": full(traffic["human_near"]), "far_human": full(traffic["human_far"]),
        "viewf": idx.float() / traffic["frames"], "perm": perm,
        "body_count": (cls == 0).sum(1), "border_count": (cls == 1).sum(1),
        "verts": fr["verts"][idx], "classes": cls,
    }

