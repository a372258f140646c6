"""The hit test's kernel (ops/kernels/hit_test.py, csrc/hit_test.cu) on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain version, to an f64 near and far and to `kernel_model` there). Here:
the launch plan against a numpy restatement, the registry and the dispatch,
and `kernel_model`, the kernel's f32 arithmetic restated step by step
(each FMA rounded once), against the plain version and f64 on the cases the
card tests take, at sizes the CPU runs quickly. This file imports nothing
of JAX: the card tests import its helpers.
"""

import math

import numpy as np
import pytest
import torch

from neuman_tpu_torch.ops import kernels
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.ops.kernels import hit_test as khit
from neuman_tpu_torch.ops.kernels.knn import fma_f32
from neuman_tpu_torch.render import renderer

torch.set_num_threads(1)


# -- helpers, shared with the card tests ------------------------------------------------------

def body_verts(num_verts=6890, device="cpu"):
    """A body-shaped point set of `num_verts` vertices: rings of 65 points
    on ellipses whose half-width and half-depth vary with height (1.7 tall,
    centred at the origin), the last ring cut short. SMPL has V = 6,890 (106
    rings of 65)."""
    rings = -(-num_verts // 65)
    h = torch.linspace(-0.85, 0.85, rings, dtype=torch.float64)[:, None]
    a = torch.arange(65, dtype=torch.float64)[None] * (2 * math.pi / 65)
    width = 0.12 + 0.08 * torch.sin(3.0 * h).abs() + 0.06 * torch.cos(7.0 * h)
    x, z = width * torch.cos(a), 0.6 * width * torch.sin(a)
    v = torch.stack([x, h.expand_as(x), z], -1).reshape(-1, 3)[:num_verts]
    return v.float().to(device)


def frame_rays(h, w, focal, eye, device="cpu"):
    """(origins, unit dirs) [h * w, 3] of a pinhole camera at `eye` looking
    at the origin down -z (image y down = world -y)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    d = torch.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal, -torch.ones_like(xs)], -1)
    d = d.reshape(-1, 3).to(device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.tensor(eye, dtype=torch.float32, device=device).expand_as(d).contiguous()
    return o, d


def near_far_f64(origins, dirs, verts, radius, chunk=1024):
    """Each ray's near and far over the spheres it passes through, in f64
    (benchmark/reference/mesh.py `near_far` restated, kept in f64)."""
    o, d, v = origins.double(), dirs.double(), verts.double()
    v2 = (v * v).sum(-1)[None]
    near, far = [], []
    for oc, dc in zip(o.split(chunk), d.split(chunk)):
        z0 = dc @ v.T - (dc * oc).sum(-1, keepdim=True)
        dist2 = v2 - 2.0 * (oc @ v.T) + (oc * oc).sum(-1, keepdim=True)
        dz = torch.sqrt(radius**2 - (dist2 - z0**2))
        miss = torch.isnan(dz)
        near.append(torch.where(miss, torch.inf, z0 - dz).amin(1))
        far.append(torch.where(miss, -torch.inf, z0 + dz).amax(1))
    return torch.cat(near), torch.cat(far)


def unsettled(origins, dirs, verts, radius, ulps=16, jump=1e-2):
    """Rays whose hit test f32 cannot settle (benchmark/reference/mesh.py's
    rule restated): moving every sphere's test by `ulps` f32 units of terms
    of the size of |o - v|^2 either way flips the hit, or moves near or far
    by more than `jump`."""
    scale = (torch.linalg.norm(origins.double(), dim=-1).max()
             + torch.linalg.norm(verts.double(), dim=-1).max())
    scale = float(scale**2 * torch.clamp((dirs.double() ** 2).sum(-1).max(), min=1.0))
    eps = ulps * 2.0**-23 * scale
    n0, f0 = near_far_f64(origins, dirs, verts, (radius**2 - eps) ** 0.5)
    n1, f1 = near_far_f64(origins, dirs, verts, (radius**2 + eps) ** 0.5)
    hit0, hit1 = n0 < f0, n1 < f1
    moved = ((n0 - n1).abs() > jump) | ((f0 - f1).abs() > jump)
    return (hit0 != hit1) | (hit0 & moved)


def kernel_model(origins, dirs, verts, radius, chunk=256):
    """What the kernel computes, rounding as it rounds (csrc/hit_test.cu):
    p = v - o, z0 = fma(dz, pz, fma(dy, py, dx px)), q = fma(-z0, d, p),
    |q|^2 by two FMAs, h^2 = fma(z0 e, z0, |q|^2) with e = 1 - |d|^2 in f64
    rounded to f32, a hit where r^2 - h^2 >= 0, dz its correctly rounded
    square root. (near [R], far [R]) f32."""
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float64).float()
    dd = dirs.double()
    e = (1.0 - ((dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]) + dd[:, 2] * dd[:, 2])).float()
    near, far = [], []
    for o, d, ec in zip(origins.split(chunk), dirs.split(chunk), e.split(chunk)):
        p = [verts[None, :, a] - o[:, a, None] for a in range(3)]
        da = [d[:, a, None].expand_as(p[0]) for a in range(3)]
        z0 = fma_f32(da[2], p[2], fma_f32(da[1], p[1], da[0] * p[0]))
        q = [fma_f32(-z0, da[a], p[a]) for a in range(3)]
        qq = fma_f32(q[2], q[2], fma_f32(q[1], q[1], q[0] * q[0]))
        h2 = fma_f32(z0 * ec[:, None], z0, qq)
        disc = r2.to(h2.device) - h2
        hit = disc >= 0
        w = torch.sqrt(torch.where(hit, disc, 0.0).double()).float()
        near.append(torch.where(hit, z0 - w, torch.inf).amin(1))
        far.append(torch.where(hit, z0 + w, -torch.inf).amax(1))
    return torch.cat(near), torch.cat(far)


def accuracy(origins, dirs, verts, radius, got, plain):
    """How (near, far) `got` and `plain` stand against f64: {"mask_equal":
    got's hits equal f64's outside the unsettled rays, "flips": (got's,
    plain's) hits other than f64's, "err": (got's, plain's) largest |near|
    or |far| gap from f64 over the settled rays that all three hit,
    "hits", "unsettled"}."""
    n64, f64 = near_far_f64(origins, dirs, verts, radius)
    keep = ~unsettled(origins, dirs, verts, radius)
    hit64 = n64 < f64
    hits = [nf[0] < nf[1] for nf in (got, plain)]
    both = keep & hit64 & hits[0] & hits[1]

    def err(nf):
        if not both.any():
            return 0.0
        return max(float((nf[0].double() - n64)[both].abs().max()),
                   float((nf[1].double() - f64)[both].abs().max()))

    return {"mask_equal": bool(torch.equal(hits[0][keep], hit64[keep])),
            "flips": tuple(int((h != hit64).sum()) for h in hits),
            "err": (err(got), err(plain)), "hits": int(hit64.sum()),
            "unsettled": int((~keep).sum())}


def hit_cases(scale=1, device="cpu"):
    """{name: (origins, dirs, verts, radius)} of the card tests' cases, with
    ray counts and V divided by `scale` (1 on the card)."""
    body = body_verts(6890 // scale, device)
    gen = torch.Generator().manual_seed(19)

    def chunk(n, eye=(0.05, 0.1, 3.0), verts=body):
        o, d = frame_rays(96, 160, 110.0, eye, device)
        pick = torch.randperm(o.shape[0], generator=gen)[:n].to(device)
        return o[pick], d[pick], verts

    def batch(n):
        """The human batch's mix: 95% of the rays at body vertices, 5% near
        them; one origin expanded to every ray (row stride 0)."""
        o = torch.tensor([0.3, 0.2, 3.5], device=device).expand(n, 3)
        idx = torch.randint(0, body.shape[0], (n,), generator=gen).to(device)
        aim = body[idx] + 0.02 * torch.randn(n, 3, generator=gen).to(device)
        aim[int(0.95 * n):] += 0.3 * torch.randn(n - int(0.95 * n), 3, generator=gen).to(device)
        d = aim - o
        return o, d / torch.linalg.norm(d, dim=-1, keepdim=True), body

    def inside(n):
        """The camera inside the sphere of vertex 100: near < 0 on every ray."""
        o = (body[100] + torch.tensor([0.01, -0.005, 0.0], device=device)).expand(n, 3)
        d = torch.randn(n, 3, generator=gen).to(device)
        return o.contiguous(), d / torch.linalg.norm(d, dim=-1, keepdim=True), body

    def far(n):
        """A camera 20 away with a long lens: |o - v|^2 ~ 400 against r^2."""
        o, d = frame_rays(96, 160, 1000.0, (0.1, 0.3, 20.0), device)
        pick = torch.randperm(o.shape[0], generator=gen)[:n].to(device)
        return o[pick], d[pick], body

    def all_miss(n):
        """Lines that pass 1.1 or more to the side of the body."""
        o = torch.tensor([1.5, 0.0, 3.0], device=device).expand(n, 3).contiguous()
        uv = 0.2 * torch.rand(n, 2, generator=gen).to(device) - 0.1
        d = torch.cat([uv, -torch.ones(n, 1, device=device)], -1)
        return o, d / torch.linalg.norm(d, dim=-1, keepdim=True), body

    h, w = (720, 1280) if scale == 1 else (36, 64)
    return {
        "chunk2048": (*chunk(2048 // scale), 0.06),
        "frame": (*frame_rays(h, w, 1000.0 * w / 1280, (0.0, 0.0, 3.0), device), body, 0.06),
        "V10242": (*chunk(2048 // scale, verts=body_verts(10242 // scale, device)), 0.06),
        "ragged": (*chunk(2048 // scale + 37), 0.2),
        "all_miss": (*all_miss(2048 // scale), 0.06),
        "inside": (*inside(2048 // scale), 0.06),
        "batch1536": (*batch(1536 // scale), 0.06),
        "far": (*far(2048 // scale), 0.2),
    }


CASES = ("chunk2048", "frame", "V10242", "ragged", "all_miss", "inside", "batch1536", "far")


def check_case(name, got, plain, case):
    """The three checks of the card tests on one case, and what each case
    must show (hits, no hits, near < 0)."""
    o, d, v, g = case
    acc = accuracy(o, d, v, g, got, plain)
    assert acc["mask_equal"], (name, acc)
    assert acc["flips"][0] <= acc["flips"][1], (name, acc)
    assert acc["err"][0] <= acc["err"][1], (name, acc)
    hits = got[0] < got[1]
    if name == "all_miss":
        assert not hits.any() and torch.isinf(got[0]).all() and torch.isinf(got[1]).all()
        assert (got[0] > 0).all() and (got[1] < 0).all()
    else:
        assert acc["hits"] > 0, (name, acc)
    if name == "inside":
        assert hits.all() and (got[0] < 0).all()
    return acc


# -- tests --------------------------------------------------------------------------------------

def _plan_np(num_rays, num_verts, num_sms):
    tiles = int(np.ceil(num_rays / 512))
    want = int(np.ceil(8 * num_sms / max(tiles, 1)))
    slices = max(1, min(int(np.ceil(num_verts / 64)), want))
    slice_verts = max(1, int(np.ceil(num_verts / slices)))
    slices = max(1, int(np.ceil(num_verts / slice_verts)))
    return tiles, slices, slice_verts


@pytest.mark.parametrize("rays", [0, 1, 511, 512, 1536, 2048, 2085, 4096, 65536, 921600])
@pytest.mark.parametrize("verts", [0, 1, 63, 65, 6890, 10242])
def test_hit_plan_matches_numpy(rays, verts):
    """The plan against a numpy restatement; every slice holds vertices,
    together all of them, no more slices than V / 64 rounded up, and one
    slice where the ray tiles alone reach 8 blocks an SM."""
    plan = khit.hit_plan(rays, verts, 132)
    assert (plan["tiles"], plan["slices"], plan["slice_verts"]) == _plan_np(rays, verts, 132)
    s, sv = plan["slices"], plan["slice_verts"]
    assert s * sv >= verts and (verts == 0 or (s - 1) * sv < verts)
    assert s <= max(1, -(-verts // khit.MIN_SLICE_VERTS))
    if plan["tiles"] >= 8 * 132:
        assert s == 1


def test_hit_test_is_registered():
    assert "hit_test" in kernels.KERNELS
    before = kernels.launches()
    from neuman_tpu_torch.utils import tracing
    tracing.count("launches.hit_test", 3)
    assert kernels.launches(before) == {k: 3 if k == "hit_test" else 0 for k in kernels.KERNELS}


def test_dispatch_on_the_cpu_is_the_plain_version():
    """CPU tensors go to the plain version, bit for bit and with no launch;
    another device raises; the renderers pick the plain version with
    use_kernels=False."""
    o, d, v, g = hit_cases(scale=8)["chunk2048"]
    before = kernels.launches()
    got = ray_ops.geometry_guided_near_far(o, d, v, g)
    want = ray_ops.geometry_guided_near_far_plain(o, d, v, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launches(before)["hit_test"] == 0
    meta = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ray_ops.geometry_guided_near_far(meta, meta, meta, g)
    assert renderer._near_far(False) is ray_ops.geometry_guided_near_far_plain
    assert renderer._near_far(True) is ray_ops.geometry_guided_near_far


@pytest.mark.parametrize("name", CASES)
def test_kernel_arithmetic_is_closer_to_f64_than_plain(name):
    """kernel_model (the kernel's arithmetic) on each card case, scaled
    down: its hits equal f64's outside the unsettled rays, it flips no
    more hits than the plain version and its near and far lie no further
    from f64."""
    case = hit_cases(scale=8)[name]
    o, d, v, g = case
    acc = check_case(name, kernel_model(o, d, v, g),
                     ray_ops.geometry_guided_near_far_plain(o, d, v, g), case)
    if name not in ("all_miss", "inside"):
        assert acc["err"][0] < acc["err"][1], acc  # the cancellation is gone


def test_kernel_model_rounds_each_step_once():
    """kernel_model's pieces: fma_f32 rounds a*b + c once (against exact
    fractions), and a hit's dz is the correctly rounded square root."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a, b, c = (torch.tensor(rng.normal(size=64), dtype=torch.float32) for _ in range(3))
    got = fma_f32(a, b, c)
    for x, y, z, f in zip(a.tolist(), b.tolist(), c.tolist(), got.tolist()):
        exact = Fraction(x) * Fraction(y) + Fraction(z)
        gap = abs(Fraction(f) - exact)
        for step in (np.nextafter(np.float32(f), np.float32(np.inf)),
                     np.nextafter(np.float32(f), np.float32(-np.inf))):
            assert gap <= abs(Fraction(float(step)) - exact)
    # a ray through one vertex's centre: dz = r exactly, near/far = z0 -/+ r
    o = torch.tensor([[0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    v = torch.tensor([[0.0, 0.0, 0.5]])
    near, far = kernel_model(o, d, v, 0.25)
    assert near.item() == 2.25 and far.item() == 2.75
