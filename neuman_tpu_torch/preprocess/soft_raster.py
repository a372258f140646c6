"""Differentiable soft face rasteriser of a mesh's silhouette (pytorch3d's
SoftSilhouetteShader, as neuman_tpu/preprocess/soft_raster.py computes it).

For each (pixel, face): the squared 2D distance from the pixel to the
projected triangle's boundary, negative inside the triangle (either
orientation), in NDC units ((2 / min(h, w))^2 per squared pixel, the short
side spanning [-1, 1]); the face covers the pixel with probability
sigmoid(-signed_d2 / sigma), and alpha = 1 - prod_f (1 - prob), summed in
log space: log(1 - sigmoid(x)) = -softplus(x), computed as
-logaddexp(x, 0) like JAX's softplus (torch's `softplus` is the identity
above x = 20). Padded faces (-1) and faces with a vertex at z < znear
contribute nothing, to the silhouette or its gradient.

Faces go in chunks, each through `_ChunkLogTransparency`, an autograd
Function that keeps no [P, chunk] tensor: its backward recomputes the
chunk's distances and applies the analytic gradient (JAX's version wraps
the chunk in jax.checkpoint for the same reason: reverse mode through
every chunk's ~25 temporaries would take 40 x 25 x 118 MB at 1280x720,
stride 4 and F = 20,480). The gradient of the closest edge's squared
distance |p - s - t e|^2, t = clamp((p - s).e / |e|^2, 0, 1), is
-2 (1 - t) d for its start s and -2 t d for its end, d = p - s - t e,
whether t is clamped or not; a pixel equidistant from two edges sends it
to the first (JAX splits it; the two differ only on such ties). The work
is plain PyTorch elementwise passes on the device (~50 a chunk forward,
~90 backward); a fused CUDA rasteriser is later work.
"""

import torch


def _edges(px, py, tri):
    """For the edges a->b, b->c, c->a of the triangles tri [FC, 3, 2] and
    the pixels px, py [P, 1]: (dx, dy, t, squared distance, cross product
    e x (p - s)) each [P, FC]."""
    out = []
    for i in range(3):
        sx, sy = tri[None, :, i, 0], tri[None, :, i, 1]
        ex, ey = tri[None, :, (i + 1) % 3, 0] - sx, tri[None, :, (i + 1) % 3, 1] - sy
        rx, ry = px - sx, py - sy
        len2 = torch.clamp(ex * ex + ey * ey, min=1e-12)
        t = (torch.addcmul(rx * ex, ry, ey) / len2).clamp_(0.0, 1.0)
        dx = torch.addcmul(rx, t, ex, value=-1.0)
        dy = torch.addcmul(ry, t, ey, value=-1.0)
        out.append((dx, dy, t, torch.addcmul(dx * dx, dy, dy),
                    torch.addcmul(ex * ry, ey, rx, value=-1.0)))
    return out


def _coverage_logits(edges, ndc2, sigma):
    """(x = -signed_d2 / sigma in NDC units, inside, d2) of `_edges`."""
    d2 = torch.minimum(torch.minimum(edges[0][3], edges[1][3]), edges[2][3])
    c0, c1, c2 = (e[4] for e in edges)
    inside = ((torch.minimum(torch.minimum(c0, c1), c2) >= 0)
              | (torch.maximum(torch.maximum(c0, c1), c2) <= 0))
    return torch.where(inside, d2, -d2) * ndc2 / sigma, inside, d2


class _ChunkLogTransparency(torch.autograd.Function):
    """[P]: the sum over a chunk's faces of log(1 - coverage); the
    gradient reaches `tri` only."""

    @staticmethod
    def forward(ctx, tri, ok, px, py, ndc2, sigma):
        ctx.save_for_backward(tri, ok, px, py)
        ctx.ndc2, ctx.sigma = ndc2, sigma
        x, _, _ = _coverage_logits(_edges(px, py, tri), ndc2, sigma)
        term = torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
        return -torch.where(ok[None, :], term, 0.0).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        tri, ok, px, py = ctx.saved_tensors
        edges = _edges(px, py, tri)
        x, inside, d2 = _coverage_logits(edges, ctx.ndc2, ctx.sigma)
        # d log_tr / d d2 = sigmoid(x) ndc2 / sigma, negated inside
        gd2 = torch.where(ok[None, :], torch.sigmoid(x), 0.0) * (g * (ctx.ndc2 / ctx.sigma))[:, None]
        gd2 = torch.where(inside, -gd2, gd2)
        taken = torch.zeros_like(inside)
        grad = torch.zeros_like(tri)
        for i, (dx, dy, t, dist, _) in enumerate(edges):
            closest = (dist == d2) & ~taken
            taken |= closest
            gi = torch.where(closest, gd2, 0.0)
            a, b = gi * dx, gi * dy
            sa, sb, sat, sbt = a.sum(0), b.sum(0), (a * t).sum(0), (b * t).sum(0)
            grad[:, i, 0] -= 2.0 * (sa - sat)
            grad[:, i, 1] -= 2.0 * (sb - sbt)
            grad[:, (i + 1) % 3, 0] -= 2.0 * sat
            grad[:, (i + 1) % 3, 1] -= 2.0 * sbt
        return grad, None, None, None, None, None


def soft_rasterize_silhouette(verts_img, faces, h, w, sigma=1e-4, stride=4, face_chunk=512,
                              vert_z=None, znear=1e-4):
    """Soft silhouette [ceil(h / stride), ceil(w / stride)], alpha in [0, 1),
    differentiable with respect to `verts_img`.

    verts_img [V, 2] projected pixel coordinates (float32); faces [F, 3]
    integer (rows of -1 are padding); sigma in squared NDC units (pytorch3d's
    BlendParams(sigma=1e-4)); vert_z [V] camera-space depths, optional: a
    face with a vertex at z < znear is culled. The pixel grid is every
    `stride`-th pixel of the full h x w image; the NDC scale is the full
    image's.
    """
    device, dtype = verts_img.device, verts_img.dtype
    gh, gw = (h + stride - 1) // stride, (w + stride - 1) // stride
    gy, gx = torch.meshgrid(torch.arange(gh, dtype=dtype, device=device) * stride,
                            torch.arange(gw, dtype=dtype, device=device) * stride, indexing="ij")
    px, py = gx.reshape(-1, 1), gy.reshape(-1, 1)

    faces = torch.as_tensor(faces, device=device).long()
    valid = faces[:, 0] >= 0
    idx = torch.clamp(faces, min=0)
    if vert_z is not None:
        valid = valid & torch.all(vert_z[idx] >= znear, dim=1)
    tris = verts_img[idx]  # [F, 3, 2]
    ndc2 = (2.0 / min(h, w)) ** 2

    log_tr = torch.zeros(px.shape[0], dtype=dtype, device=device)
    for start in range(0, tris.shape[0], face_chunk):
        log_tr = log_tr + _ChunkLogTransparency.apply(
            tris[start:start + face_chunk], valid[start:start + face_chunk], px, py, ndc2, sigma)
    return (1.0 - torch.exp(log_tr)).reshape(gh, gw)
