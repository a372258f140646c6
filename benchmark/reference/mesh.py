"""Closest points on the body mesh, the warp into canonical space and the
signed distance, plain.

The closest point of a sample is taken over the faces incident to the k
nearest vertices of its group of `stride` consecutive samples (represented
by the group's middle sample), by Ericson's region test (Real-Time
Collision Detection 5.1.5), the first least squared distance winning. The
KNN is exact for the renders and, for training, the bucketed one: vertex i
in bucket i % 64, each bucket's nearest vertex, the k nearest of those.
These are the program's own approximations of "closest point on the mesh",
kept here as a frozen copy so that the reference picks the same faces; the
bucketed scores are taken as fused multiply-adds rounded once, as the
program takes them, so that near-ties resolve alike.
"""

import torch

NUM_BUCKETS = 64
CHUNK = 4096


def incidence(faces, num_verts):
    """[V, D] faces incident to each vertex, -1 padded (faces [F, 3] int64)."""
    f = faces.reshape(-1)
    order = torch.argsort(f, stable=True)
    verts = f[order]
    counts = torch.bincount(verts, minlength=num_verts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(f.numel(), device=f.device) - starts[verts]
    table = torch.full((num_verts, int(counts.max())), -1, dtype=torch.int64, device=f.device)
    table[verts, rank] = order // 3
    return table


def _fma(a, b, c):
    """fma(a, b, c) of f32 tensors rounded once to f32 (f64 product, the
    f64 sum made round-to-odd, then rounded)."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def knn_exact(q, verts, k):
    out = []
    v2 = (verts * verts).sum(-1)[None]
    for qc in q.split(CHUNK):
        d2 = ((qc * qc).sum(-1)[:, None] + v2) - 2.0 * (qc[:, None, :] * verts[None]).sum(-1)
        out.append(torch.topk(-d2, k, dim=-1, sorted=True).indices)
    return torch.cat(out)


def knn_bucketed(q, verts, k):
    v = verts.shape[0]
    vb = -(-(-(-v // NUM_BUCKETS)) // 8) * 8
    x, y, z = verts.unbind(-1)
    tab = torch.cat([verts, ((x * x + y * y) + z * z)[:, None]], -1)
    pad = torch.zeros(NUM_BUCKETS * vb - v, 4, device=verts.device)
    pad[:, 3] = 1e30
    tab = torch.cat([tab, pad]).reshape(vb, NUM_BUCKETS, 4).permute(1, 0, 2)
    out = []
    for qc in q.split(CHUNK // 2):
        qq = (-2.0 * qc)[:, None, None, :]
        acc = tab[None, ..., 3]
        for a in range(3):
            acc = _fma(tab[None, ..., a], qq[..., a], acc)
        best, pos = acc.min(dim=2)
        sel = torch.sort(best, dim=1, stable=True).indices[:, :k]
        out.append((pos.gather(1, sel) * NUM_BUCKETS + sel).clamp(max=v - 1))
    return torch.cat(out)


def _closest_on_triangle(p, a, b, c):
    """Ericson's closest point on triangles, (x, y, z) tuples; region order
    vertices, then edges, then the face."""
    sub = lambda u, v: tuple(u[i] - v[i] for i in range(3))
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    madd = lambda u, s, v: tuple(u[i] + s * v[i] for i in range(3))
    ab, ac = sub(b, a), sub(c, a)
    ap, bp, cp = sub(p, a), sub(p, b), sub(p, c)
    d1, d2, d3, d4, d5, d6 = dot(ab, ap), dot(ac, ap), dot(ab, bp), dot(ac, bp), dot(ab, cp), dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    safe = lambda den: torch.where(den.abs() < 1e-20, 1e-20, den)
    denom = safe(va + vb + vc)
    out = madd(madd(a, vb / denom, ab), vc / denom, ac)
    regions = (
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
         madd(b, (d4 - d3) / safe((d4 - d3) + (d5 - d6)), sub(c, b))),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), madd(a, d2 / safe(d2 - d6), ac)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), madd(a, d1 / safe(d1 - d3), ab)),
        ((d6 >= 0) & (d5 <= d6), c),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d1 <= 0) & (d2 <= 0), a),
    )
    for mask, pt in regions:
        out = tuple(torch.where(mask, pt[i], out[i]) for i in range(3))
    return out


def barycentric(p, v0, v1, v2):
    sub = lambda u, v: tuple(u[i] - v[i] for i in range(3))
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    cross = lambda u, v: (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                          u[0] * v[1] - u[1] * v[0])
    n = cross(sub(v1, v0), sub(v2, v0))
    den = dot(n, n)
    den = torch.where(den.abs() < 1e-20, 1e-20, den)
    u = dot(n, cross(sub(v2, v1), sub(p, v1))) / den
    v = dot(n, cross(sub(v0, v2), sub(p, v2))) / den
    return u, v, 1.0 - u - v


def closest(points, verts, faces, inc, k=4, stride=1, bucketed=False):
    """(d2 [N], face [N], closest [N, 3]) of points [N, 3]: no gradient."""
    with torch.no_grad():
        verts = verts.detach()
        points = points.detach()
        n = points.shape[0]
        stride = stride if stride > 1 and n % stride == 0 else 1
        q = points if stride == 1 else points.reshape(-1, stride, 3)[:, stride // 2]
        knn = (knn_bucketed if bucketed else knn_exact)(q, verts, k)
        d2s, fids, cps = [], [], []
        for lo in range(0, q.shape[0], CHUNK):
            kk = knn[lo:lo + CHUNK]
            cand = inc[kk].reshape(kk.shape[0], -1)  # [Q, C]
            tri = verts[faces[cand.clamp(min=0)]]  # [Q, C, 3, 3]
            pts = points[lo * stride:(lo + kk.shape[0]) * stride].reshape(-1, stride, 3)
            p = tuple(pts[:, :, None, i] for i in range(3))  # [Q, m, 1]
            corner = lambda j: tuple(tri[:, None, :, j, i] for i in range(3))
            cp = _closest_on_triangle(p, corner(0), corner(1), corner(2))
            d2 = sum((cp[i] - p[i]) ** 2 for i in range(3))
            d2 = torch.where(cand[:, None, :] >= 0, d2, torch.inf)
            sel = torch.argmin(d2, dim=2, keepdim=True)
            d2s.append(d2.gather(2, sel).reshape(-1))
            fids.append(cand[:, None, :].expand_as(d2).gather(2, sel).reshape(-1))
            cps.append(torch.stack([c.gather(2, sel).reshape(-1) for c in cp], -1))
        return torch.cat(d2s), torch.cat(fids), torch.cat(cps)


def warp(points, verts, ts, faces, inc, k=4, stride=1, bucketed=False):
    """Canonical points [N, 3] of posed points: the barycentric blend of the
    per-vertex transforms ts [V, 4, 4] at each point's closest point,
    inverted, applied to the point. Differentiable in verts, ts and the
    points; the closest point and its face carry no gradient."""
    _, fid, cp = closest(points, verts, faces, inc, k, stride, bucketed)
    fv = faces[fid]
    corners = [tuple(verts[fv[:, j], i] for i in range(3)) for j in range(3)]
    u, v, w = barycentric(tuple(cp[:, i] for i in range(3)), *corners)
    m = (u[:, None, None] * ts[fv[:, 0]] + v[:, None, None] * ts[fv[:, 1]]
         + w[:, None, None] * ts[fv[:, 2]])[:, :3, :]
    rot, t = m[:, :, :3], m[:, :, 3]
    inv = _inverse3(rot)
    return (inv * (points - t)[:, None, :]).sum(-1)


def _inverse3(m):
    """Closed-form inverse of [N, 3, 3] (adjugate over determinant)."""
    a = lambda i, j: m[:, i, j]
    c = [[a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1), a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
          a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)],
         [a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2), a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
          a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)],
         [a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0), a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
          a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)]]
    det = a(0, 0) * c[0][0] + a(0, 1) * c[1][0] + a(0, 2) * c[2][0]
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    return torch.stack([torch.stack(row, -1) for row in c], -2) / det[:, None, None]


def vertex_normals(verts, faces):
    """[V, 3] angle-weighted pseudonormals (Baerentzen-Aanaes)."""
    tri = verts[faces]
    e0, e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 2]
    unit = lambda u: u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-20)
    n = unit(torch.linalg.cross(e0, -e2))
    ang = lambda u, v: torch.arccos((unit(u) * unit(v)).sum(-1).clamp(-1.0, 1.0))
    vn = torch.zeros_like(verts)
    for j, a in enumerate((ang(e0, -e2), ang(e1, -e0), ang(e2, -e1))):
        vn = vn.index_add(0, faces[:, j], n * a[:, None])
    return unit(vn)


def signed_distance(points, verts, faces, inc, k=4, stride=1, bucketed=False):
    """Signed distance [N] to the closed mesh, negative inside: the closest
    point's distance with the sign of (p - closest) . n, n the barycentric
    blend of the face's corner pseudonormals; sign(0) = +1. No gradient."""
    with torch.no_grad():
        d2, fid, cp = closest(points, verts, faces, inc, k, stride, bucketed)
        fv = faces[fid]
        corners = [tuple(verts[fv[:, j], i] for i in range(3)) for j in range(3)]
        u, v, w = barycentric(tuple(cp[:, i] for i in range(3)), *corners)
        vn = vertex_normals(verts, faces)[fv]  # [N, 3, 3]
        normal = u[:, None] * vn[:, 0] + v[:, None] * vn[:, 1] + w[:, None] * vn[:, 2]
        side = ((points - cp) * normal).sum(-1)
        return torch.where(side < 0, -1.0, 1.0) * torch.sqrt(d2.clamp(min=0.0))


def near_far(origins, dirs, verts, radius):
    """Per-ray (near, far) of the spheres of `radius` about the vertices
    that the ray passes through; near = +inf, far = -inf where it passes
    none. Taken in f64."""
    near, far = [], []
    origins, dirs, verts = origins.double(), dirs.double(), verts.double()
    v2 = (verts * verts).sum(-1)[None]
    for o, d in zip(origins.split(CHUNK), dirs.split(CHUNK)):
        z0 = (d[:, None, :] * verts[None]).sum(-1) - (d * o).sum(-1, keepdim=True)
        dist2 = v2 - 2.0 * (o[:, None, :] * verts[None]).sum(-1) + (o * o).sum(-1, keepdim=True)
        dz = torch.sqrt(radius**2 - (dist2 - z0**2))
        miss = torch.isnan(dz)
        near.append(torch.where(miss, torch.inf, z0 - dz).amin(1))
        far.append(torch.where(miss, -torch.inf, z0 + dz).amax(1))
    return torch.cat(near).float(), torch.cat(far).float()


def unsettled(origins, dirs, verts, radius, ulps=16, jump=1e-2):
    """Rays whose hit test f32 cannot settle: moving every sphere's test
    (radius^2 - (dist^2 - z0^2), a difference of terms of the size of
    |o - v|^2) by `ulps` f32 units of those terms either way flips whether
    the ray hits, or moves its near or far by more than `jump`: a ray that
    grazes the outermost sphere, or the front one at an occlusion edge.
    There the render's answer turns on rounding alone (the last sample's
    interval is 1e10, so a ray a rounding inside a sphere is opaque)."""
    scale = (torch.linalg.norm(origins.double(), dim=-1).max() + torch.linalg.norm(verts.double(), dim=-1).max())
    scale = float(scale**2 * torch.clamp((dirs.double() ** 2).sum(-1).max(), min=1.0))
    eps = ulps * 2.0**-23 * scale
    n0, f0 = near_far(origins, dirs, verts, (radius**2 - eps) ** 0.5)
    n1, f1 = near_far(origins, dirs, verts, (radius**2 + eps) ** 0.5)
    hit0, hit1 = n0 < f0, n1 < f1
    moved = ((n0 - n1).abs() > jump) | ((f0 - f1).abs() > jump)
    return (hit0 != hit1) | (hit0 & moved)
