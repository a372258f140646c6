"""Closest point over per-point candidate triangles: the `ericson_select`
CUDA kernel, and `ericson_signed_select`, the same with the pseudonormal
sign fused in.

Replaces neuman_tpu/ops/pallas/meshquery.py `_kernel` (:65, through
`_ericson_select_impl` :314 and `ericson_select_pallas` :390) and keeps
its contract: p3 [3, N] query points; rows9 [9C, N/stride] candidate
corners, coordinate-major (row j*C + ci is coordinate j of candidate ci:
ax ay az bx by bz cx cy cz); cand [C, N/stride] int32 face ids, -1 =
invalid; `stride` consecutive points share one candidate set. Returns
(d2 [N], f_id [N] int32, closest (x, y, z) of [N]): the first candidate
with the least squared distance. Source:
neuman_tpu_torch/csrc/ericson_select.cu, whose header says what bounds it
on the H100 and how the design answers that; `select_plan` is its launch
plan (points a thread, candidate slices), computed here and passed to the
launch.

The gradient is the envelope formula of the JAX custom VJP: d(d2)/dp =
2 (p - cp); the closest point and face id carry none, and nothing flows
into the triangles.

`ericson_signed_select_tables` replaces `_signed_kernel` (:119, through
`_signed_select_impl` :191 and `ericson_signed_select_pallas` :276), the
same query with the pseudonormal sign fused in, and reads its candidates
straight from the mesh's query tables by KNN index: knn_idx [N/stride, k]
(int32 or int64), incidence [V, D] int32, vtab9 [V, 9D] the corners of each
vertex's incident faces, vntab9 [V, 9D] their angle-weighted
pseudonormals; candidate j*D + d of a group is face incidence[knn_idx[g,
j], d]. Returns (sd [N], f_id [N] int32, closest): sd = sign *
sqrt(max(d2, 0)), the sign that of (p - closest) . (u na + v nb + w nc)
at the selected candidate, with sign(0) = +1. Gradient (the JAX custom
VJP): d sd / d p = sign(sd) (p - closest) / |sd|, 0 where |sd| < 1e-12.
Both kernels are in one source and share the region test, so d2, closest
and f_id agree bit for bit on the same candidates. `ericson_signed_select`
is the same function on the TPU kernel's planar operands (rows9 and vn9
[9C, N/stride], cand), in plain PyTorch only: the counterpart held to the
JAX package. The table kernel's launches count as
`launches.ericson_signed_select` (utils/tracing.py).
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.utils import tracing


def closest_point_on_triangles_planar(p, a, b, c):
    """Ericson's closest point (RTCD 5.1.5) on coordinate tuples: p, a, b,
    c are (x, y, z) tuples of broadcastable tensors. Returns the closest
    point as a tuple. Region priority: vertices, then edges, then face."""
    sub = lambda u, v: (u[0] - v[0], u[1] - v[1], u[2] - v[2])
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    madd = lambda u, s, v: (u[0] + s * v[0], u[1] + s * v[1], u[2] + s * v[2])
    ab, ac = sub(b, a), sub(c, a)
    ap, bp, cp = sub(p, a), sub(p, b), sub(p, c)
    d1, d2 = dot(ab, ap), dot(ac, ap)
    d3, d4 = dot(ab, bp), dot(ac, bp)
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    safe = lambda den: torch.where(den.abs() < 1e-20, 1e-20, den)
    v_ab = d1 / safe(d1 - d3)
    w_ac = d2 / safe(d2 - d6)
    w_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    denom = safe(va + vb + vc)
    v_int = vb / denom
    w_int = vc / denom

    out = madd(madd(a, v_int, ab), w_int, ac)
    for mask, pt in (
        (in_edge_bc, madd(b, w_bc, sub(c, b))),
        (in_edge_ac, madd(a, w_ac, ac)),
        (in_edge_ab, madd(a, v_ab, ab)),
        (in_vert_c, c),
        (in_vert_b, b),
        (in_vert_a, a),
    ):
        out = tuple(torch.where(mask, pt[i], out[i]) for i in range(3))
    return out


def barycentric_planar(closest, v0, v1, v2):
    """Barycentric weights (u, v, w) of v0, v1, v2 at points on the
    triangles, by the reference's cross/dot formulation."""
    sub = lambda u, v: (u[0] - v[0], u[1] - v[1], u[2] - v[2])
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]
    cross = lambda u, v: (
        u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0],
    )
    n = cross(sub(v1, v0), sub(v2, v0))
    denom = dot(n, n)
    denom = torch.where(denom.abs() < 1e-20, 1e-20, denom)
    u = dot(n, cross(sub(v2, v1), sub(closest, v1))) / denom
    v = dot(n, cross(sub(v0, v2), sub(closest, v2))) / denom
    return u, v, 1.0 - u - v


def planar_rows(rows, nq):
    """[Nq, ...] rows of nine floats a candidate (a face's corners or corner
    normals, candidates in order) -> the kernels' coordinate-major [9C, Nq]."""
    return rows.reshape(nq, -1, 9).permute(2, 1, 0).reshape(-1, nq).contiguous()


def ericson_select_plain(p3, rows9, cand, stride=1):
    """What the kernel computes, in plain PyTorch: the region test on
    [C, N/stride] planes, once per group member."""
    d2, f_id, cp = _select_plain(p3, rows9, cand, stride)
    return d2, f_id, tuple(cp)


def _member_candidates(p3, rows9, cand, stride, m):
    """Squared distance [C, Nq] and closest point 3x[C, Nq] of group
    member m to each candidate; invalid candidates at +inf."""
    nq, num_cands = p3.shape[1] // stride, cand.shape[0]
    rows = rows9.reshape(9, num_cands, nq)
    a, b, c = (rows[0], rows[1], rows[2]), (rows[3], rows[4], rows[5]), (rows[6], rows[7], rows[8])
    p = tuple(p3[j].reshape(nq, stride)[:, m][None, :] for j in range(3))
    cp = closest_point_on_triangles_planar(p, a, b, c)
    d2 = (cp[0] - p[0]) ** 2 + (cp[1] - p[1]) ** 2 + (cp[2] - p[2]) ** 2
    return torch.where(cand >= 0, d2, torch.inf), cp


def _select_plain(p3, rows9, cand, stride, vn9=None):
    """(d2 or, with vn9, the signed distance; f_id; cp [3, N])."""
    n = p3.shape[1]
    nq, num_cands = n // stride, cand.shape[0]
    dists, fids, cps = [], [], []
    for m in range(stride):
        d2, cp = _member_candidates(p3, rows9, cand, stride, m)
        sel = torch.argmin(d2, dim=0, keepdim=True)  # first minimum
        best = d2.gather(0, sel)[0]
        if vn9 is not None:
            rows = rows9.reshape(9, num_cands, nq)
            vn = vn9.reshape(9, num_cands, nq)
            corners = [tuple(rows[3 * j + a] for a in range(3)) for j in range(3)]
            u, v, w = barycentric_planar(cp, *corners)
            p = tuple(p3[j].reshape(nq, stride)[:, m][None, :] for j in range(3))
            dot = sum((p[a] - cp[a]) * (u * vn[a] + v * vn[3 + a] + w * vn[6 + a])
                      for a in range(3))
            sign = torch.where(dot.gather(0, sel)[0] < 0, -1.0, 1.0)
            best = sign * torch.sqrt(torch.clamp(best, min=0.0))
        dists.append(best)
        fids.append(cand.gather(0, sel)[0].clamp(min=0))
        cps.append(torch.stack([cp[j].gather(0, sel)[0] for j in range(3)]))
    dist = torch.stack(dists, dim=1).reshape(n)
    f_id = torch.stack(fids, dim=1).reshape(n).to(torch.int32)
    cp = torch.stack(cps, dim=2).reshape(3, n)
    return dist, f_id, cp


def ericson_signed_select_plain(p3, rows9, vn9, cand, stride=1):
    """What the signed kernel computes, in plain PyTorch: the sign dot on
    [C, N/stride] planes like the region test, the winner's picked."""
    sd, f_id, cp = _select_plain(p3, rows9, cand, stride, vn9)
    return sd, f_id, tuple(cp)


def _tables_plain(p3, knn_idx, incidence, vtab9, vntab9, stride):
    """(sd, f_id, cp [3, N]): the planar operands gathered from the tables
    by knn_idx (candidate j*D + d of a group is face incidence[knn_idx[g,
    j], d]), then the planar plain version."""
    nq = knn_idx.shape[0]
    cand = incidence[knn_idx].reshape(nq, -1).T.to(torch.int32).contiguous()
    rows9, vn9 = planar_rows(vtab9[knn_idx], nq), planar_rows(vntab9[knn_idx], nq)
    return _select_plain(p3, rows9, cand, stride, vn9)


def ericson_signed_select_tables_plain(p3, knn_idx, incidence, vtab9, vntab9, stride=1):
    """What the table kernel computes, in plain PyTorch."""
    sd, f_id, cp = _tables_plain(p3, knn_idx, incidence, vtab9, vntab9, stride)
    return sd, f_id, tuple(cp)


def tie_gap(p3, rows9, cand, stride=1):
    """Per point [N]: the least d2 over candidates with a face id other than
    the selected one, minus the selected d2. Points on a shared edge or
    vertex tie (gap ~0), and there any of the tied faces is a right answer."""
    gaps = []
    for m in range(stride):
        d2, _ = _member_candidates(p3, rows9, cand, stride, m)
        sel = torch.argmin(d2, dim=0, keepdim=True)
        other = torch.where(cand != cand.gather(0, sel), d2, torch.inf).amin(0)
        gaps.append(other - d2.gather(0, sel)[0])
    return torch.stack(gaps, dim=1).reshape(-1)


# the kernel's threads a block; the threads to aim for, the least
# candidates a slice and the most slices (csrc/ericson_select.cu)
SELECT_THREADS = 256
SELECT_TARGET_THREADS = 131072
SELECT_MIN_SLICE = 6
SELECT_MAX_SLICES = 8


def select_plan(n, num_cands, stride):
    """The `ericson_select` kernel's plan for N points in groups of `stride`
    over C candidates: a dict of `members` (points a thread: 4, 2 or 1, the
    largest that divides the stride; the thread loads each candidate once
    for all of them), `slices` (S, a power of two: the least >= 2 that puts
    >= 131,072 threads in flight, but no more than 8 and none with fewer
    than 6 candidates; 1 for C < 12) and `bounds` (S + 1 ints: slice s
    takes candidates [bounds[s], bounds[s + 1]), contiguous, in order,
    sizes within one of each other)."""
    members = 4 if stride % 4 == 0 else 2 if stride % 2 == 0 else 1
    units = n // members
    most = 1
    while most * 2 <= min(SELECT_MAX_SLICES, num_cands // SELECT_MIN_SLICE):
        most *= 2
    slices = min(2, most)
    while slices < most and units * slices < SELECT_TARGET_THREADS:
        slices *= 2
    bounds = [s * num_cands // slices for s in range(slices + 1)]
    return {"members": members, "slices": slices, "bounds": bounds}


@functools.lru_cache(maxsize=64)
def _plan_args(n, num_cands, stride):
    """`select_plan` and its bounds as the C array the launch takes."""
    plan = select_plan(n, num_cands, stride)
    return plan, (ctypes.c_int * (plan["slices"] + 1))(*plan["bounds"])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ericson_select", extra_flags=("--fmad=false",))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ericson_select_launch.argtypes = [p] * 6 + [i] * 5 + [p, p]
    lib.ericson_select_launch.restype = ctypes.c_int
    lib.ericson_signed_select_launch.argtypes = [p, p, i, p, p, p, p, p, p] + [i] * 6 + [p, p]
    lib.ericson_signed_select_launch.restype = ctypes.c_int
    return lib


def _check(what, operands, device):
    """Raise unless each (tensor, dtypes, shape) is on `device`, of one of
    the dtypes and the shape, and contiguous."""
    for t, dtypes, shape in operands:
        if t.device != device or t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(f"{what}: expected {dtypes} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def _outputs(n, device):
    """(dist [N] f32, f_id [N] int32, cp [3, N] f32), uninitialised."""
    return (torch.empty(n, device=device, dtype=torch.float32),
            torch.empty(n, device=device, dtype=torch.int32),
            torch.empty(3, n, device=device, dtype=torch.float32))


def _plan_for(n, num_cands, stride, plan):
    """(plan, its bounds as a C array): `select_plan`'s unless given."""
    if plan is None:
        return _plan_args(n, num_cands, stride)
    return plan, (ctypes.c_int * (plan["slices"] + 1))(*plan["bounds"])


def _aligned(p3, plan):
    """p3, copied if the kernel's M-point loads would be misaligned."""
    return p3.clone() if p3.data_ptr() % (4 * plan["members"]) else p3


def _launch(p3, rows9, cand, stride, plan=None):
    """Launch `ericson_select` (by `plan`, default `select_plan`)."""
    what = "ericson_select"
    device = p3.device
    n = p3.shape[1]
    num_cands = cand.shape[0]
    if stride < 1 or n % stride:
        raise ValueError(f"{what}: N={n} is not a multiple of stride={stride}")
    _check(what, [(p3, (torch.float32,), (3, n)),
                  (rows9, (torch.float32,), (9 * num_cands, n // stride)),
                  (cand, (torch.int32,), (num_cands, n // stride))], device)
    dist, f_id, cp = _outputs(n, device)
    plan, bounds = _plan_for(n, num_cands, stride, plan)
    p3 = _aligned(p3, plan)
    err = _lib().ericson_select_launch(
        p3.data_ptr(), rows9.data_ptr(), cand.data_ptr(), dist.data_ptr(), f_id.data_ptr(),
        cp.data_ptr(), n, num_cands, stride, plan["members"], plan["slices"], bounds,
        torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"{what}: bad plan {plan} for N={n}, C={num_cands}, stride={stride}")
    _build.check(err, what)
    tracing.count("launches.ericson_select")
    return dist, f_id, cp


def _launch_signed(p3, knn_idx, incidence, vtab9, vntab9, stride, plan=None):
    """Launch the table kernel `ericson_signed_select` (by `plan`, default
    `select_plan` over C = k * D candidates)."""
    what = "ericson_signed_select"
    device = p3.device
    n = p3.shape[1]
    (num_verts, deg), k = incidence.shape, knn_idx.shape[1]
    if stride < 1 or n % stride:
        raise ValueError(f"{what}: N={n} is not a multiple of stride={stride}")
    _check(what, [(p3, (torch.float32,), (3, n)),
                  (knn_idx, (torch.int32, torch.int64), (n // stride, k)),
                  (incidence, (torch.int32,), (num_verts, deg)),
                  (vtab9, (torch.float32,), (num_verts, 9 * deg)),
                  (vntab9, (torch.float32,), (num_verts, 9 * deg))], device)
    sd, f_id, cp = _outputs(n, device)
    plan, bounds = _plan_for(n, k * deg, stride, plan)
    p3 = _aligned(p3, plan)
    err = _lib().ericson_signed_select_launch(
        p3.data_ptr(), knn_idx.data_ptr(), int(knn_idx.dtype == torch.int64),
        incidence.data_ptr(), vtab9.data_ptr(), vntab9.data_ptr(), sd.data_ptr(),
        f_id.data_ptr(), cp.data_ptr(), n, k, deg, stride, plan["members"], plan["slices"],
        bounds, torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"{what}: bad plan {plan} for N={n}, C={k * deg}, stride={stride}")
    _build.check(err, what)
    tracing.count("launches.ericson_signed_select")
    return sd, f_id, cp


class _EricsonSelect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p3, rows9, cand, stride):
        if p3.is_cuda:
            d2, f_id, cp = _launch(p3, rows9, cand, stride)
        elif p3.device.type == "cpu":
            d2, f_id, cp = _select_plain(p3, rows9, cand, stride)
        else:
            raise ValueError(f"ericson_select: no kernel for device {p3.device}")
        ctx.save_for_backward(p3, cp)
        ctx.mark_non_differentiable(f_id, cp)
        return d2, f_id, cp

    @staticmethod
    def backward(ctx, g_d2, _g_fid, _g_cp):
        p3, cp = ctx.saved_tensors
        return 2.0 * (p3 - cp) * g_d2, None, None, None


def ericson_select(p3, rows9, cand, stride=1):
    """Kernel for CUDA tensors, `ericson_select_plain` for CPU tensors."""
    d2, f_id, cp = _EricsonSelect.apply(p3, rows9, cand, stride)
    return d2, f_id, (cp[0], cp[1], cp[2])


class _EricsonSignedSelect(torch.autograd.Function):
    """sd of `compute(p3, *operands)`, differentiable in p3 only."""

    @staticmethod
    def forward(ctx, p3, compute, *operands):
        sd, f_id, cp = compute(p3, *operands)
        ctx.num_operands = len(operands)
        ctx.save_for_backward(p3, cp, sd)
        ctx.mark_non_differentiable(f_id, cp)
        return sd, f_id, cp

    @staticmethod
    def backward(ctx, g_sd, _g_fid, _g_cp):
        p3, cp, sd = ctx.saved_tensors
        mag = sd.abs()
        inv = torch.where(mag < 1e-12, 0.0, 1.0 / mag)
        sign = torch.where(sd < 0, -1.0, 1.0)
        return (g_sd * sign * (p3 - cp) * inv, None) + (None,) * ctx.num_operands


def ericson_signed_select(p3, rows9, vn9, cand, stride=1, plain=False):
    """`ericson_signed_select_plain` on the planar operands, differentiable
    in p3: on CPU tensors, or on any device with plain=True. No kernel takes
    planar operands: a CUDA tensor without plain=True raises (the kernel is
    `ericson_signed_select_tables`)."""
    if not plain and p3.device.type != "cpu":
        raise ValueError("ericson_signed_select: no kernel takes planar operands; "
                         "use ericson_signed_select_tables, or plain=True")
    planar = lambda p, r, v, c, st: _select_plain(p, r, c, st, v)
    sd, f_id, cp = _EricsonSignedSelect.apply(p3, planar, rows9, vn9, cand, stride)
    return sd, f_id, (cp[0], cp[1], cp[2])


def ericson_signed_select_tables(p3, knn_idx, incidence, vtab9, vntab9, stride=1, plain=False):
    """The table kernel for CUDA tensors, `ericson_signed_select_tables_plain`
    for CPU tensors (or on any device with plain=True, under the same
    gradient, to hold the kernel to), differentiable in p3."""
    if plain or p3.device.type == "cpu":
        compute = _tables_plain
    elif p3.is_cuda:
        compute = _launch_signed
    else:
        raise ValueError(f"ericson_signed_select: no kernel for device {p3.device}")
    sd, f_id, cp = _EricsonSignedSelect.apply(p3, compute, knn_idx, incidence, vtab9, vntab9,
                                              stride)
    return sd, f_id, (cp[0], cp[1], cp[2])
