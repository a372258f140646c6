"""NeRF's encodings, networks, ray sampling and volume rendering, plain.

Networks are dicts of tensors under the reference NeRF's `state_dict`
names (`pts_linears.{i}.weight`, `views_linears.0.weight`,
`feature_linear`, `alpha_linear`, `rgb_linear`, `output_linear`).
"""

import numpy as np
import torch

from benchmark.reference import F32


def posenc_freqs(n_freqs, min_freq=0, max_freq=None):
    max_freq = n_freqs - 1 if max_freq is None else max_freq
    return (2.0 ** np.linspace(min_freq, max_freq, n_freqs).astype(np.float32)
            .astype(np.float64)).astype(np.float32)


def rotate_basis(n_freqs, min_freq=0, max_freq=None):
    """[3 n_freqs, 3] f64: the axis-aligned frequency basis turned by two
    fixed 45-degree rotations (the canonical net's "rotate" mapping)."""
    max_freq = n_freqs - 1 if max_freq is None else max_freq
    b = 2.0 ** np.linspace(min_freq, max_freq, n_freqs)
    b = np.reshape(np.eye(3) * b[:, None, None], [n_freqs * 3, 3])
    s = 2**0.5 / 2
    rot1 = np.array([[s, -s, 0], [s, s, 0], [0, 0, 1]])
    rot2 = np.array([[1, 0, 0], [0, s, -s], [0, s, s]])
    return b @ rot1.T @ rot2.T


def encode(x, n_freqs, mapping="posenc"):
    """Positional encoding of x [..., D] (input included): "posenc" rows
    [x, sin(f0 x), cos(f0 x), ...]; "rotate" [x, sin(x B^T), cos(x B^T)],
    the projection taken in f64 and rounded once."""
    if mapping == "posenc":
        parts = [x]
        for f in posenc_freqs(n_freqs):
            parts += [torch.sin(x * float(f)), torch.cos(x * float(f))]
        return torch.cat(parts, -1)
    basis = torch.as_tensor(rotate_basis(n_freqs), device=x.device)
    proj = (x.double() @ basis.T).float()
    return torch.cat([x, torch.sin(proj), torch.cos(proj)], -1)


def layer_shapes(width, depth, skips, in_ch, views_ch, out_ch=4, viewdirs=True):
    """[(name, shape, fan_in)] of a NeRF MLP in `state_dict` order."""
    out = []
    fan = in_ch
    for i in range(depth):
        out += [(f"pts_linears.{i}.weight", (width, fan), fan), (f"pts_linears.{i}.bias", (width,), fan)]
        fan = width + in_ch if i in skips else width
    if viewdirs:
        vfan = width + views_ch
        out += [("views_linears.0.weight", (width // 2, vfan), vfan),
                ("views_linears.0.bias", (width // 2,), vfan),
                ("feature_linear.weight", (width, width), width), ("feature_linear.bias", (width,), width),
                ("alpha_linear.weight", (1, width), width), ("alpha_linear.bias", (1,), width),
                ("rgb_linear.weight", (3, width // 2), width // 2),
                ("rgb_linear.bias", (3,), width // 2)]
    else:
        out += [("output_linear.weight", (out_ch, width), width),
                ("output_linear.bias", (out_ch,), width)]
    return out


def _lin(w, name, h, prec):
    return prec.mm(h, w[name + ".weight"].T) + w[name + ".bias"]


def trunk(w, pe, depth, skips, prec):
    h = pe
    for i in range(depth):
        h = torch.relu(_lin(w, f"pts_linears.{i}", h, prec))
        if i in skips:
            h = torch.cat([pe, h], -1)
    return h


def nerf(w, pe, dir_pe, depth=8, skips=(4,), prec=F32):
    """Raw (sigma [N], rgb [N, 3]) of the view-direction NeRF on encoded
    points pe [N, C]. dir_pe: [N, Cd] per point, or [R, Cd] per ray with
    N = R x S (the points of a ray in a row)."""
    h = trunk(w, pe, depth, skips, prec)
    alpha = _lin(w, "alpha_linear", h, prec)[:, 0]
    feature = _lin(w, "feature_linear", h, prec)
    wv, bv = w["views_linears.0.weight"], w["views_linears.0.bias"]
    width = feature.shape[1]
    if dir_pe.shape[0] == pe.shape[0]:
        hv = prec.mm(torch.cat([feature, dir_pe], -1), wv.T) + bv
    else:
        r = dir_pe.shape[0]
        hv = (prec.mm(feature, wv[:, :width].T).reshape(r, -1, wv.shape[0])
              + prec.mm(dir_pe, wv[:, width:].T)[:, None] + bv).reshape(-1, wv.shape[0])
    rgb = _lin(w, "rgb_linear", torch.relu(hv), prec)
    return alpha, rgb


def offset_net(w, x4, n_freqs=10, depth=8, skips=(4,), prec=F32):
    """Raw offsets [N, 3] of the offset net on (x, y, z, t) points [N, 4]."""
    pe = encode(x4, n_freqs)
    return _lin(w, "output_linear", trunk(w, pe, depth, skips, prec), prec)


def rays(xy, k, c2w):
    """Pixel coordinates xy [N, 2] (float), intrinsics [3, 3], camera to
    world [4, 4] -> (origins [N, 3], unit directions [N, 3])."""
    cam = torch.stack([(xy[:, 0] - k[0, 2]) / k[0, 0], (xy[:, 1] - k[1, 2]) / k[1, 1],
                       torch.ones_like(xy[:, 0])], -1)
    d = (c2w[None, :3, :3] * cam[:, None, :]).sum(-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand_as(d), d


def linspace_z(near, far, n):
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    return near.reshape(-1, 1) * (1.0 - t) + far.reshape(-1, 1) * t


def stratified_z(near, far, n, u):
    """Stratified samples with jitter u [R, n] (clipped to [0.01, 0.99])."""
    z = linspace_z(near, far, n)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u.clamp(0.01, 0.99)


def importance(z, weights, n):
    """NeRF's deterministic inverse-CDF resampling (det=True) of the coarse
    weights' interior, merged with the coarse samples and sorted."""
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    wt = weights[:, 1:-1].detach() + 1e-5
    pdf = wt / wt.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    u = torch.linspace(0.0, 1.0, n, device=z.device).expand(z.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below, above = (inds - 1).clamp(min=0), inds.clamp(max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    samples = (b0 + (u - c0) / den * (b1 - b0)).detach()
    return torch.sort(torch.cat([z, samples], -1), -1).values


def integrate(sigma, rgb, z, dir_norm, white_bkg=True):
    """NeRF's volume rendering: sigma, z [R, S], rgb [R, S, 3] raw ->
    (rgb [R, 3], acc [R], weights [R, S], depth [R])."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists * dir_norm[:, None])
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1),
                          -1)[:, :-1]
    weights = alpha * trans
    color = (weights[..., None] * torch.sigmoid(rgb)).sum(1)
    acc = weights.sum(-1)
    if white_bkg:
        color = color + (1.0 - acc[:, None])
    return color, acc, weights, (weights * z).sum(-1)


def merge(zs, sigmas, rgbs):
    """Sample sets merged by z along each ray; on equal z the earlier set first."""
    z, order = torch.sort(torch.cat(zs, -1), dim=-1, stable=True)
    sigma = torch.cat(sigmas, -1).gather(1, order)
    rgb = torch.cat(rgbs, 1).gather(1, order[..., None].expand(-1, -1, 3))
    return z, sigma, rgb


def background(wc, wf, origins, dirs, near, far, samples, importance_samples, prec=F32,
               dir_freqs=4, pos_freqs=10):
    """The frozen background's coarse -> importance -> fine pass:
    (fine z [R, S+I], sigma, rgb [R, S+I, 3])."""
    r = origins.shape[0]
    dir_pe = encode(dirs, dir_freqs)
    dn = torch.linalg.norm(dirs, dim=-1)

    def run(w, z):
        pts = origins[:, None] + dirs[:, None] * z[..., None]
        sigma, rgb = nerf(w, encode(pts.reshape(-1, 3), pos_freqs), dir_pe, prec=prec)
        return sigma.reshape(r, -1), rgb.reshape(r, -1, 3)

    z = linspace_z(near, far, samples)
    sigma, rgb = run(wc, z)
    weights = integrate(sigma, rgb, z, dn)[2]
    fz = importance(z, weights, importance_samples)
    fs, frgb = run(wf, fz)
    return fz, fs, frgb
