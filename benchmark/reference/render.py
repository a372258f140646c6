"""NeuMan's two renders of a set of rays, plain.

`hybrid`: the background's coarse -> importance -> fine pass on every ray;
on the rays that pass within `radius` of a body vertex, the human branch
(samples between the spheres' near and far, the warp by the frame's
per-vertex transforms, the canonical net with per-sample directions),
merged with the background's samples by z. `canonical`: the canonical net
alone on the rays that pass the Da-posed body (the ray's direction, no
warp), the others white.
"""

import torch

from benchmark.reference import F32
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import nerf as nerf_ref

CHUNK = 1024


def _canonical_net(w, pts, dirs, prec, cfg):
    pe = nerf_ref.encode(pts.reshape(-1, 3), cfg["pos_N_freqs"], "rotate")
    dpe = nerf_ref.encode(dirs.reshape(-1, 3) if dirs.dim() == 3 else dirs, cfg["dir_N_freqs"],
                          "rotate")
    return nerf_ref.nerf(w, pe, dpe, cfg["nerf_depth"], (4,), prec)


def _human(w, o, d, near, far, verts, ts, faces, inc, cfg, prec, warp=True, interval_comp=1.0):
    """(z, sigma, rgb) of the human branch on rays that hit."""
    r, s = o.shape[0], cfg["samples_per_ray"]
    z = nerf_ref.linspace_z(near, far, s)
    pts = o[:, None] + d[:, None] * z[..., None]
    if warp:
        stride = cfg["knn_stride"] if s % cfg["knn_stride"] == 0 else 1
        cp = mesh_ref.warp(pts.reshape(-1, 3), verts, ts, faces, inc, 4, stride).reshape(r, s, 3)
        diff = torch.cat([cp[:, 1:] - cp[:, :-1], cp[:, -1:] - cp[:, -2:-1]], 1)
        dirs = diff / (torch.sqrt((diff**2).sum(-1, keepdim=True)) + 1e-20)
        sigma, rgb = _canonical_net(w, cp, dirs, prec, cfg)
    else:
        sigma, rgb = _canonical_net(w, pts, d, prec, cfg)
    return z, sigma.reshape(r, s) * interval_comp, rgb.reshape(r, s, 3)


@torch.no_grad()
def hybrid(nets, o, d, bkg_near, bkg_far, verts, ts, faces, inc, radius, cfg, prec=F32):
    """rgb [N, 3] of the rays (o, d) through the scene with the body."""
    out = []
    with prec.scope():
        for oc, dc in zip(o.split(CHUNK), d.split(CHUNK)):
            n = oc.shape[0]
            fz, fs, frgb = nerf_ref.background(
                nets["bkg_coarse"], nets["bkg_fine"], oc, dc, torch.full((n, 1), bkg_near, device=o.device),
                torch.full((n, 1), bkg_far, device=o.device), cfg["samples_per_ray"],
                cfg["importance_samples_per_ray"], prec, cfg["dir_N_freqs"], cfg["pos_N_freqs"])
            dn = torch.linalg.norm(dc, dim=-1)
            rgb = nerf_ref.integrate(fs, frgb, fz, dn, True)[0]
            near, far = mesh_ref.near_far(oc, dc, verts, radius)
            hit = torch.nonzero(near < far).squeeze(1)
            if hit.numel():
                hz, hs, hrgb = _human(nets["can"], oc[hit], dc[hit], near[hit], far[hit], verts, ts,
                                      faces, inc, cfg, prec)
                mz, ms, mrgb = nerf_ref.merge([fz[hit], hz], [fs[hit], hs], [frgb[hit], hrgb])
                rgb[hit] = nerf_ref.integrate(ms, mrgb, mz, dn[hit], True)[0]
            out.append(rgb)
    return torch.cat(out)


@torch.no_grad()
def canonical(net, o, d, verts, radius, interval_comp, cfg, prec=F32):
    """rgb [N, 3] of the rays (o, d) through the Da-posed body alone."""
    out = []
    with prec.scope():
        for oc, dc in zip(o.split(CHUNK), d.split(CHUNK)):
            rgb = torch.ones(oc.shape[0], 3, device=o.device)
            near, far = mesh_ref.near_far(oc, dc, verts, radius)
            hit = torch.nonzero(near < far).squeeze(1)
            if hit.numel():
                z, sigma, hrgb = _human(net, oc[hit], dc[hit], near[hit], far[hit], None, None, None,
                                        None, cfg, prec, warp=False, interval_comp=interval_comp)
                rgb[hit] = nerf_ref.integrate(sigma, hrgb, z, torch.linalg.norm(dc[hit], dim=-1),
                                              True)[0]
            out.append(rgb)
    return torch.cat(out)
