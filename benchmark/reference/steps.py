"""NeuMan's two train steps, plain: the losses, their gradients by autograd
and Adam.

Stage 1 (background): coarse and fine MSE colour losses and the
empty-space penalty (densities before margin x depth pushed to zero
through tanh(relu(sigma))), weighted by the annealed penalty weight.
Stage 2 (human, "smpl_and_offset"): the frozen background's samples merged
by z with the human branch's (stratified samples in the body's range, the
offset net on (x, y, z, t), the warp by the frame's SMPL pose, the
canonical net with per-sample directions), and NeuMan's seven losses: RGB
on the rays that pass the body, LPIPS on the leading 32x32 patch, colour
range, symmetry, the SMPL shape prior by the signed distance with dummy
points, the mask, and sparsity on rays of a canonical camera.

Adam is optax's: bias-corrected moments, eps outside the square root; a
step whose loss is NaN or whose net is dead (largest density <= 0)
leaves the parameters and only moves the moments with zero gradients.

The random draws inside a human step (the stratified jitter, the colour
range's directions, the shape prior's dummy points, the sparsity term's
camera, pixels and jitter) are taken from a generator in the order the
program takes them: the step under test and this one start from the same
generator state and draw the same numbers.
"""

import math

import torch

from benchmark.reference import F32
from benchmark.reference import lpips as lpips_ref
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import nerf as nerf_ref
from benchmark.reference import smpl as smpl_ref

B1, B2, EPS = 0.9, 0.999, 1e-8
PATCH = 32
NUM_CAN_RAYS = 128
CAN_FAR = 3.0 * 1.667
HARD_SURFACE_OFFSET = 0.31326165795326233


class Adam:
    """optax.scale_by_adam then scale(-lr), with the skip rule."""

    def __init__(self, params):
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads, lrs, bad):
        self.count += 1
        bc1, bc2 = 1.0 - B1**self.count, 1.0 - B2**self.count
        for k, p in params.items():
            g = torch.zeros_like(p) if bad else grads[k]
            self.mu[k].mul_(B1).add_((1.0 - B1) * g)
            self.nu[k].mul_(B2).add_((1.0 - B2) * g * g)
            if not bad:
                p.add_(-(self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS) * lrs[k])


def _masked_mean(v, mask):
    return (v * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def bkg_loss(w, batch, cfg, penalty_weight, prec=F32):
    """(total, coarse and fine max density) of one stage-1 batch. w:
    {"coarse.<name>", "fine.<name>"} tensors."""
    o, d = batch["origin"], batch["direction"]
    r = o.shape[0]
    dn = torch.linalg.norm(d, dim=-1)
    dir_pe = nerf_ref.encode(d, cfg["dir_N_freqs"])
    net = lambda pre: {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}

    def losses(wn, z):
        pts = o[:, None] + d[:, None] * z[..., None]
        sigma, rgb = nerf_ref.nerf(wn, nerf_ref.encode(pts.reshape(-1, 3), cfg["pos_N_freqs"]),
                                   dir_pe, cfg["nerf_depth"], (4,), prec)
        sigma, rgb = sigma.reshape(r, -1), rgb.reshape(r, -1, 3)
        color, _, weights, _ = nerf_ref.integrate(sigma, rgb, z, dn, cfg["white_bkg"])
        closer = (z < batch["depth"][:, None] * cfg["margin"]).float()
        empty = _masked_mean(torch.tanh(torch.relu(sigma)) ** 2, closer) * penalty_weight
        return torch.mean((color - batch["color"]) ** 2), empty, weights, sigma.detach().max()

    z = nerf_ref.linspace_z(batch["near"], batch["far"], cfg["samples_per_ray"])
    c_rgb, c_emp, weights, c_max = losses(net("coarse."), z)
    fz = nerf_ref.importance(z, weights, cfg["importance_samples_per_ray"])
    f_rgb, f_emp, _, f_max = losses(net("fine."), fz)
    return c_rgb + f_rgb + c_emp + f_emp, torch.stack([c_max, f_max])


def bkg_step(w, adam, batch, cfg, iteration, prec=F32):
    """One stage-1 step in place on the leaves of `w`; returns the loss."""
    pw = cfg["penalize_empty_space"] * max(0.0, 1.0 - iteration / 60000.0)
    lr = cfg["learning_rate"] * 0.1 ** (iteration / (cfg["lrate_decay"] * 1000.0))
    with prec.scope():
        total, maxima = bkg_loss(w, batch, cfg, pw, prec)
        grads = dict(zip(w, torch.autograd.grad(total, list(w.values()))))
    bad = bool((maxima <= 0).any()) or math.isnan(float(total.detach()))
    adam.step(w, grads, {k: lr for k in w}, bad)
    return float(total.detach())


def human_anneals(cfg, it):
    decay = max(0.0, 1.0 - it / 60000.0)
    prior = decay if cfg["prior_knowledge_decay"] else 1.0
    ramp = (cfg["offset_lim"] - cfg["offset_scale"]) * max(0.0, (it - cfg["offset_delay"]) / 60000.0) \
        + cfg["offset_scale"]
    lr_decay = 0.1 ** (it / (cfg["lrate_decay"] * 1000.0))
    return {"mask_w": cfg["penalize_mask"] * decay, "sym_w": cfg["penalize_symmetric_alpha"] * prior,
            "dummy_w": cfg["penalize_dummy"] * prior, "alpha_w": cfg["penalize_smpl_alpha"] * prior,
            "offset_scale": min(ramp, cfg["offset_lim"]) if it >= cfg["offset_delay"] else 0.0,
            "lr": cfg["learning_rate"] * lr_decay, "smpl_lr": cfg["smpl_lr"] * lr_decay}


def _hard_surface(x):
    return torch.mean(-torch.log(torch.exp(-x.abs()) + torch.exp(-(1 - x).abs())) + HARD_SURFACE_OFFSET)


def _clustered_box(gen, r, s, group, half=1.5, jitter=0.005):
    """Uniform points in the [-half, half]^3 box in groups of `group` close
    points (a shared anchor, jitter, reflected at the walls)."""
    dev = gen.device
    a = (torch.rand(r, s // group, 1, 3, generator=gen, device=dev) - 0.5) * (2.0 * half)
    j = (torch.rand(r, s // group, group, 3, generator=gen, device=dev) - 0.5) * (2.0 * jitter)
    t = (a + j + half).abs()
    t = 2.0 * half - (2.0 * half - t).abs()
    return (t - half).reshape(r, s, 3)


def _sparsity(can, scene, gen, cfg, s, nf, depth, prec):
    """The hard-surface priors on rays of a random canonical camera."""
    dev = gen.device
    h, wd = scene["can_hw"]
    c = torch.randint(0, scene["can_k"].shape[0], (), generator=gen, device=dev)
    x = torch.randint(0, wd, (NUM_CAN_RAYS,), generator=gen, device=dev).float()
    y = torch.randint(0, h, (NUM_CAN_RAYS,), generator=gen, device=dev).float()
    co, cd = nerf_ref.rays(torch.stack([x, y], -1), scene["can_k"][c], scene["can_c2w"][c])
    cu = torch.rand(NUM_CAN_RAYS, s, generator=gen, device=dev)
    cz = nerf_ref.stratified_z(torch.zeros(NUM_CAN_RAYS, 1, device=dev),
                               torch.full((NUM_CAN_RAYS, 1), CAN_FAR, device=dev), s, cu)
    cpts = (co[:, None] + cd[:, None] * cz[..., None]).reshape(-1, 3)
    csig, crgb = nerf_ref.nerf(can, nerf_ref.encode(cpts, nf, "rotate"),
                               nerf_ref.encode(cd, cfg["dir_N_freqs"], "rotate"), depth, (4,), prec)
    _, cacc, cw, _ = nerf_ref.integrate(csig.reshape(NUM_CAN_RAYS, s) * scene["interval_comp"],
                                        crgb.reshape(NUM_CAN_RAYS, s, 3), cz,
                                        torch.linalg.norm(cd, dim=-1), True)
    reg = 0.0
    if cfg["penalize_sharp_edge"] > 0:
        reg = reg + _hard_surface(cacc.clamp(0.0, 1.0)) * cfg["penalize_sharp_edge"]
    if cfg["penalize_hard_surface"] > 0:
        reg = reg + _hard_surface(cw.clamp(0.0, 1.0)) * cfg["penalize_hard_surface"]
    return reg


def human_loss(w, scene, batch, gen, an, cfg, prec=F32):
    """(total, dead) of one stage-2 batch. w: {"poses", "can.<name>",
    "off.<name>"} trained tensors; scene: the frozen parts ("bkg_coarse",
    "bkg_fine" nets, "body", "betas", "faces", "inc", "can_verts",
    "can_k", "can_c2w", "can_hw", "interval_comp", "lpips")."""
    o, d = batch["origin"], batch["direction"]
    r, s = o.shape[0], cfg["samples_per_ray"]
    dev = o.device
    dn = torch.linalg.norm(d, dim=-1)
    can = {k[4:]: v for k, v in w.items() if k.startswith("can.")}
    off = {k[4:]: v for k, v in w.items() if k.startswith("off.")}
    nf, depth = cfg["pos_N_freqs"], cfg["nerf_depth"]
    stride = cfg["knn_stride"] if s % cfg["knn_stride"] == 0 else 1
    mesh_kw = dict(k=4, stride=stride, bucketed=True)

    with torch.no_grad():
        fz, fs, frgb = nerf_ref.background(scene["bkg_coarse"], scene["bkg_fine"], o, d,
                                           batch["bkg_near"], batch["bkg_far"], s,
                                           cfg["importance_samples_per_ray"], prec, cfg["dir_N_freqs"],
                                           nf)

    # the human branch: stratified samples, offsets, the warp
    u = torch.rand(r, s, generator=gen, device=dev)
    hz = nerf_ref.stratified_z(batch["human_near"], batch["human_far"], s, u)
    pts = (o[:, None] + d[:, None] * hz[..., None]).reshape(-1, 3)
    t = batch["cur_view_f"].reshape(1, 1).expand(pts.shape[0], 1)
    offset = nerf_ref.offset_net(off, torch.cat([pts, t], -1), nf, depth, (4,), prec) * an["offset_scale"]
    pose = w["poses"][scene["frame_ids"][batch["cap_id"]]]
    verts, ts, _ = smpl_ref.da_to_posed(scene["body"], scene["betas"], pose)
    can_pts = mesh_ref.warp(pts, verts, ts, scene["faces"], scene["inc"], **mesh_kw) + offset
    cp = can_pts.reshape(r, s, 3)
    diff = torch.cat([cp[:, 1:] - cp[:, :-1], cp[:, -1:] - cp[:, -2:-1]], 1)
    dirs = diff / (torch.sqrt((diff**2).sum(-1, keepdim=True)) + 1e-20)

    def canonical(points, directions):
        pe = nerf_ref.encode(points.reshape(-1, 3), nf, "rotate")
        dpe = nerf_ref.encode(directions.reshape(-1, 3), cfg["dir_N_freqs"], "rotate")
        sigma, rgb = nerf_ref.nerf(can, pe, dpe, depth, (4,), prec)
        return sigma.reshape(r, s), rgb.reshape(r, s, 3)

    hs, hrgb = canonical(cp, dirs)
    zero = torch.zeros((), device=dev)
    sym, color_range, shape = zero, zero, zero
    # the regularisers in the program's order, each drawing only when on
    if cfg["penalize_symmetric_alpha"] > 0:
        flip = torch.stack([-cp[..., 0], cp[..., 1], cp[..., 2]], -1).detach()
        fs_sym, _ = canonical(flip, dirs.detach())
        sym = torch.mean((torch.tanh(torch.relu(hs)) - torch.tanh(torch.relu(fs_sym))) ** 2) * an["sym_w"]
    if cfg["penalize_color_range"] > 0:
        color_dirs = torch.randn(r, s, 3, generator=gen, device=dev)
        color_dirs = color_dirs / torch.linalg.norm(color_dirs, dim=-1, keepdim=True)
        _, crgb = canonical(cp, color_dirs)
        color_range = ((torch.sigmoid(crgb) - torch.sigmoid(hrgb)) ** 2).sum() / (3 * r * s) \
            * cfg["penalize_color_range"]
    if cfg["penalize_smpl_alpha"] > 0:
        dummy = _clustered_box(gen, r, s, stride)
        ds, _ = canonical(dummy, dirs)
        cverts = scene["can_verts"]
        sd = mesh_ref.signed_distance(cp.reshape(-1, 3).detach(), cverts, scene["faces"], scene["inc"],
                                      **mesh_kw)
        sd_d = mesh_ref.signed_distance(dummy.reshape(-1, 3), cverts, scene["faces"], scene["inc"],
                                        **mesh_kw)
        occ = 1.0 - torch.exp(-torch.relu(hs.reshape(-1)))
        d_occ = 1.0 - torch.exp(-torch.relu(ds.reshape(-1)))
        shape = _masked_mean((occ - 1.0) ** 2, (sd < 0).float()) * an["alpha_w"]
        shape = shape + _masked_mean((d_occ - 1.0) ** 2, (sd_d < 0).float()) * an["dummy_w"]
        outside = d_occ * torch.pow(sd_d.abs() * cfg["penalize_outside_factor"], cfg["dist_exponent"])
        outside = outside**2 if cfg["penalize_outside_loss"] == "mse" else outside.abs()
        shape = shape + _masked_mean(outside, (sd_d > 0).float()) * an["dummy_w"]

    mask, sparsity = zero, zero
    if cfg["penalize_mask"] > 0:
        acc = nerf_ref.integrate(hs, hrgb, hz, dn, cfg["white_bkg"])[1]
        mask = torch.mean((acc.clamp(0.0, 1.0) - (1 - batch["is_bkg"]).float()) ** 2) * an["mask_w"]
    if cfg["penalize_sharp_edge"] > 0 or cfg["penalize_hard_surface"] > 0:
        sparsity = _sparsity(can, scene, gen, cfg, s, nf, depth, prec)

    mz, ms, mrgb = nerf_ref.merge([fz, hz], [fs, hs], [frgb, hrgb])
    rgb = nerf_ref.integrate(ms, mrgb, mz, dn, cfg["white_bkg"])[0]
    se = torch.mean((rgb - batch["color"]) ** 2, -1)
    fine_rgb = _masked_mean(se, batch["is_hit"].float())
    lp = zero
    if cfg["penalize_lpips"] > 0:
        img = lambda t: t[:PATCH * PATCH].reshape(PATCH, PATCH, 3).permute(2, 0, 1)[None] * 2 - 1
        lp = lpips_ref.distance(scene["lpips"], img(rgb), img(batch["color"]))[0]
        lp = lp * cfg["penalize_lpips"] * batch["patch_counter"].float()

    dead = bool(hs.detach().max() <= 0)
    total = sym + shape + mask + sparsity + fine_rgb + color_range + lp
    return (total * 0.0 if dead else total), dead


def human_step(w, adam, scene, batch, gen, cfg, iteration, prec=F32):
    """One stage-2 step in place on the leaves of `w`; returns the loss."""
    an = human_anneals(cfg, iteration)
    with prec.scope():
        total, dead = human_loss(w, scene, batch, gen, an, cfg, prec)
        grads = dict(zip(w, torch.autograd.grad(total, list(w.values()), allow_unused=True)))
    grads = {k: torch.zeros_like(w[k]) if g is None else g for k, g in grads.items()}
    grads["poses"] = grads["poses"] * scene["grad_masks"]
    lrs = {k: an["smpl_lr"] if k == "poses" else an["lr"] for k in w}
    bad = dead or math.isnan(float(total.detach()))
    adam.step(w, grads, lrs, bad)
    return float(total.detach())
