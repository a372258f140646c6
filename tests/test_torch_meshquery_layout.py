"""The plans and selection orders of the mesh-query kernels, checked on the CPU.

The kernels (neuman_tpu_torch/csrc/bucketed_knn.cu, ericson_select.cu)
cannot run here, so what surrounds them is held exact: numpy models of the
order in which each kernel selects (the KNN's per-slice chunk-minimum scan,
its (score, bucket) merge of the 8 slices and the rescan of one chunk for
the earliest position; the Ericson select's candidate slices merged on
(d2, index); the signed select's table addressing by KNN index, its slice
merge and the winner's reload for the sign) give the plain versions'
answers bit for bit, on inputs full of exact ties; the launch plans the
wrappers pass (`knn_plan`, `select_plan`) cover every bucket, table entry,
query tile and candidate once and stay inside the card's shared memory;
the plain KNN's |v|^2 and its FMA are rounded as the kernel's.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from neuman_tpu_torch.ops import mesh as tmesh
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from neuman_tpu_torch.utils.synthetic_body import synthetic_body_mesh

torch.set_num_threads(1)

H100_SMS = 132


def _grid_case(num_verts, num_points, seed):
    """Vertices and points on a coarse integer grid: most scores tie with
    another exactly, inside a bucket and across buckets."""
    rng = np.random.default_rng(seed)
    verts = rng.integers(-3, 4, size=(num_verts, 3)).astype(np.float32)
    pts = rng.integers(-4, 5, size=(num_points, 3)).astype(np.float32)
    return torch.tensor(pts), torch.tensor(verts)


def knn_model(points, verts, k, plan):
    """The kernel's selection, in numpy, on the plain version's scores:
    lane slice s holds buckets s, s + 8, ..., s + 56; the table is walked
    in the plan's stages; each bucket keeps its least score and the
    earliest chunk of 8 entries whose minimum lowered it (strict <); a slice
    keeps the k best (score, bucket) of its buckets; the 8 slices' lists
    merge on (score, bucket); each chosen bucket's chunk is rescanned for
    the first entry equal to its least score."""
    scores = kknn._scores(points, kknn.bucket_table(verts)).numpy()  # [n, 64, VB]
    n, nb, vb = scores.shape
    group, part = plan["group"], plan["part"]
    best = np.full((n, nb), np.inf, np.float32)
    chunk = np.zeros((n, nb), np.int64)
    order = []  # buckets in the order their scans finish
    for g0 in range(0, nb, group):
        for j0 in range(0, vb, part):
            jn = min(part, vb - j0)
            for b in range(g0, min(g0 + group, nb)):
                for c in range(jn // 8):
                    lo = j0 + 8 * c
                    cm = scores[:, b, lo:lo + 8].min(1)
                    lower = cm < best[:, b]
                    best[lower, b] = cm[lower]
                    chunk[lower, b] = lo // 8
                if j0 + jn == vb:
                    order.append(b)
    assert sorted(order) == list(range(nb))
    idx = np.zeros((n, k), np.int64)
    out = np.zeros((n, k), np.float32)
    for q in range(n):
        merged = []
        for s in range(kknn.KNN_SLICES):
            mine = sorted((best[q, b], b) for b in range(s, nb, kknn.KNN_SLICES))
            merged += mine[:k]
        for t, (sc, b) in enumerate(sorted(merged)[:k]):
            c = chunk[q, b]
            entries = scores[q, b, 8 * c:8 * c + 8]
            pos = 8 * c + int(np.flatnonzero(entries == sc)[0])
            idx[q, t] = min(pos * nb + b, verts.shape[0] - 1)
            out[q, t] = sc
    return idx, out


@pytest.mark.parametrize("num_verts,k,plan_kind", [
    (300, 4, "resident"), (1000, 8, "resident"), (40, 3, "resident"), (1000, 1, "grouped"),
    (1000, 4, "parts")])
def test_knn_model_matches_plain_on_grid_ties(num_verts, k, plan_kind):
    """The kernel's order of selection gives the plain version's indices and
    scores exactly, with most scores tied; grouped: 16 buckets a stage;
    parts: 8 buckets x 8 entries a stage (each bucket walked in parts)."""
    pts, verts = _grid_case(num_verts, 160, seed=num_verts + k)
    kw = {"resident": {}, "grouped": {"group": 16}, "parts": {"group": 8, "part": 8}}
    plan = kknn.knn_plan(len(pts), num_verts, k, H100_SMS, **kw[plan_kind])
    assert plan["resident"] == (plan_kind == "resident")
    idx, score = knn_model(pts, verts, k, plan)
    ref_idx, ref_score = kknn.bucketed_knn_plain(pts, verts, k)
    best = kknn._scores(pts, kknn.bucket_table(verts)).amin(2)
    tied = (best[:, :, None] == best[:, None, :]).sum((1, 2)) - best.shape[1]
    assert (tied > 0).float().mean() > 0.9  # nearly every point has tied buckets
    np.testing.assert_array_equal(idx, ref_idx.numpy())
    np.testing.assert_array_equal(score, ref_score.numpy())


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("num_verts", [40, 6890, 10242, 14336, 14337, 40962, 200000])
@pytest.mark.parametrize("nq", [1, 1000, 49152, 196608])
def test_knn_plan_covers_the_table_and_the_queries_once(num_verts, nq, k):
    """Resident while the table fits (V <= 14,336), else whole buckets in
    groups of 8 m, else parts of 8 buckets; the bytes stay within 227 KB;
    every (bucket, entry) is staged once a pass; the persistent blocks'
    warps take every query tile once, and no block is idle."""
    plan = kknn.knn_plan(nq, num_verts, k, H100_SMS)
    vb, group, part, q = plan["bucket_size"], plan["group"], plan["part"], plan["queries"]
    assert q == (4 if k <= 4 else 2)
    assert vb % 8 == 0 and 64 * vb >= num_verts > 64 * (vb - 8)
    assert plan["smem_bytes"] == group * (part + 1) * 16 <= kknn.SMEM_LIMIT
    assert plan["resident"] == (num_verts <= 14336)
    assert group % 8 == 0 and part % 8 == 0 and (part == vb or group == 8)
    if plan["resident"]:
        assert (group, part) == (64, vb)
    else:
        assert (group + 8) * (vb + 1) * 16 > kknn.SMEM_LIMIT
        if part < vb:
            assert 8 * (part + 9) * 16 > kknn.SMEM_LIMIT
    staged = np.zeros((64, vb), np.int64)
    for g0 in range(0, 64, group):
        for j0 in range(0, vb, part):
            staged[g0:g0 + group, j0:j0 + part] += 1
    assert (staged == 1).all()
    assert plan["stages"] == -(-64 // group) * -(-vb // part)
    warps, grid = kknn.KNN_WARPS, plan["grid"]
    warp_tiles = -(-nq // (kknn.KNN_QUERY_LANES * q))
    assert grid == min(H100_SMS, -(-warp_tiles // warps))
    taken = np.zeros(warp_tiles, np.int64)
    for blk in range(grid):
        mine = 0
        for w in range(warps):
            if plan["resident"]:
                t = np.arange(w * grid + blk, warp_tiles, grid * warps)
            else:
                t = np.arange(blk, -(-warp_tiles // warps), grid) * warps + w
                t = t[t < warp_tiles]
            taken[t] += 1
            mine += len(t)
        assert mine > 0
    assert (taken == 1).all()


def test_knn_plan_at_the_main_path_shapes():
    """V=10,242 (VB 168): the table resident in 173,056 B; 4 points a
    thread; 3,072 warp tiles at Nq=49,152 over 132 blocks of 16 warps. Over
    the budget (V=40,962, VB 648): 16 buckets a stage."""
    plan = kknn.knn_plan(49152, 10242, 4, H100_SMS)
    assert plan["resident"] and plan["queries"] == 4 and plan["grid"] == 132
    assert plan["smem_bytes"] == 64 * 169 * 16
    assert kknn.knn_plan(1000, 10242, 8, H100_SMS)["queries"] == 2
    big = kknn.knn_plan(49152, 40962, 4, H100_SMS)
    assert not big["resident"] and big["group"] == 16 and big["stages"] == 4


def test_bucket_table_norm_is_rounded_as_the_kernel_rounds_it():
    """|v|^2 = (x*x + y*y) + z*z in f32, bit for bit; the layout and the
    padding rows as the kernel stages them."""
    verts = torch.tensor(synthetic_body_mesh(subdivisions=2)[0], dtype=torch.float32)[:150]
    tab = kknn.bucket_table(verts)
    x, y, z = verts.unbind(-1)
    vb = kknn.bucket_size(150)
    assert tab.shape == (64, vb, 4) and vb == 8
    for i in range(150):
        b, j = i % 64, i // 64
        assert torch.equal(tab[b, j, :3], verts[i])
        assert torch.equal(tab[b, j, 3], (x[i] * x[i] + y[i] * y[i]) + z[i] * z[i])
    flat = tab.permute(1, 0, 2).reshape(-1, 4)
    assert torch.equal(flat[150:], torch.tensor([[0.0, 0.0, 0.0, 1e30]]).expand(64 * vb - 150, 4))


def _round_f32(x: Fraction):
    """The f32 nearest to x, ties to even (x finite, in the normal range)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    m = int(scaled)
    rest = scaled - m
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(sign * float(Fraction(m) * Fraction(2) ** (e - 23)))


def test_fma_f32_rounds_once():
    """fma_f32 against the exact a*b + c rounded to f32: random operands of
    mixed scale, and a case where rounding the f64 sum to f32 rounds twice
    (1 + 2^-23 - 2^-24 (1 - 2^-46) lies just above a midpoint)."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=400) * 10.0 ** rng.integers(-3, 4, 400)).astype(np.float32)
    b = (rng.normal(size=400) * 10.0 ** rng.integers(-3, 4, 400)).astype(np.float32)
    c = (rng.normal(size=400) * 10.0 ** rng.integers(-3, 4, 400)).astype(np.float32)
    hard = [np.float32(-(2.0 ** -24) * (1 - 2.0 ** -23)), np.float32(1 + 2.0 ** -23),
            np.float32(1 + 2.0 ** -23)]
    a, b, c = (np.append(v, h) for v, h in zip((a, b, c), hard))
    got = kknn.fma_f32(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = np.float32(np.float64(a[-1]) * np.float64(b[-1]) + np.float64(c[-1]))
    assert got[-1] == np.float32(1 + 2.0 ** -23) != naive


def select_model(p3, rows9, cand, stride, bounds):
    """The kernel's candidate slices, in numpy: slice 0 takes its first
    candidate, the others their first with d2 below +inf; each keeps the
    first strictly lower d2; slice 0 merges the others in order with the
    same strict <. Returns (d2, f_id, cp) as ericson_select_plain does."""
    n = p3.shape[1]
    nq = n // stride
    d2 = np.zeros((nq, stride), np.float32)
    f_id = np.zeros((nq, stride), np.int32)
    cp = np.zeros((3, nq, stride), np.float32)
    cand_np = cand.numpy()
    for m in range(stride):
        dist, close = kmq._member_candidates(p3, rows9, cand, stride, m)
        dist, close = dist.numpy(), [c.numpy() for c in close]
        win_d = np.full(nq, np.inf, np.float32)
        win_c = np.zeros(nq, np.int64)
        for s in range(len(bounds) - 1):
            c0, c1 = bounds[s], bounds[s + 1]
            sd = np.full(nq, np.inf, np.float32) if s else dist[c0].copy()
            sc = np.full(nq, c0, np.int64)
            for ci in range(c0 + (0 if s else 1), c1):
                lower = dist[ci] < sd
                sd[lower], sc[lower] = dist[ci][lower], ci
            take = sd < win_d if s else np.ones(nq, bool)
            win_d[take], win_c[take] = sd[take], sc[take]
        cols = np.arange(nq)
        d2[:, m] = win_d
        f_id[:, m] = np.maximum(cand_np[win_c, cols], 0)
        for a in range(3):
            cp[a, :, m] = close[a][win_c, cols]
    return d2.reshape(n), f_id.reshape(n), cp.reshape(3, n)


def _select_case(num_cands, nq, stride, seed):
    """Random triangles around the points; duplicate candidates (exact d2
    ties), invalid ids, and one group whose candidates are all invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(3, nq * stride)).astype(np.float32)
    centre = pts.reshape(3, nq, stride).mean(2)
    corners = centre[None, :, None, :] + rng.normal(size=(3, 3, num_cands, nq)) * 0.7
    rows9 = corners.transpose(1, 0, 2, 3).reshape(9 * num_cands, nq).astype(np.float32)
    cand = rng.integers(0, 500, size=(num_cands, nq)).astype(np.int32)
    rows = rows9.reshape(9, num_cands, nq)
    for ci in range(1, num_cands, 3):  # candidate ci copies an earlier one
        src = rng.integers(0, ci)
        rows[:, ci, ::2], cand[ci, ::2] = rows[:, src, ::2], cand[src, ::2]
    cand[rng.random(cand.shape) < 0.2] = -1
    cand[:, 1] = -1
    return torch.tensor(pts), torch.tensor(rows9), torch.tensor(cand)


@pytest.mark.parametrize("num_cands", [18, 24, 36])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("slices", [1, 2, 4, 8])
def test_select_model_matches_plain_bit_for_bit(num_cands, stride, slices):
    """The sliced scan and its merge reproduce the sequential first-minimum
    bit for bit: d2, face id and closest point, the all-invalid group
    (candidate 0, f_id 0) and the duplicated candidates (the earlier one)."""
    p3, rows9, cand = _select_case(num_cands, 37, stride, seed=num_cands + 10 * stride)
    bounds = [s * num_cands // slices for s in range(slices + 1)]
    d2, f_id, cp = select_model(p3, rows9, cand, stride, bounds)
    rd2, rf, rcp = kmq.ericson_select_plain(p3, rows9, cand, stride)
    np.testing.assert_array_equal(d2, rd2.numpy())
    np.testing.assert_array_equal(f_id, rf.numpy())
    np.testing.assert_array_equal(cp, torch.stack(rcp).numpy())
    invalid = slice(stride, 2 * stride)  # group 1
    assert np.isinf(d2[invalid]).all() and (f_id[invalid] == 0).all()


@pytest.mark.parametrize("stride", [1, 4])
def test_select_model_matches_plain_on_the_body(stride):
    """The same on the query the warp makes: ray samples through the body
    proxy, its candidates from the KNN (points over shared edges tie)."""
    verts, faces = synthetic_body_mesh(subdivisions=2)
    topo = tmesh.MeshTopology.build(faces, len(verts))
    rng = np.random.default_rng(4)
    pts = torch.tensor((verts[rng.integers(0, len(verts), 96)] * 1.05).astype(np.float32))
    p3, rows9, cand, st = tmesh.candidate_operands(pts, torch.tensor(verts), topo, k=4,
                                                   knn_stride=stride, knn_impl="bucketed")
    plan = kmq.select_plan(p3.shape[1], cand.shape[0], st)
    for bounds in (plan["bounds"], [0, 5, cand.shape[0]]):
        d2, f_id, cp = select_model(p3, rows9, cand, st, bounds)
        rd2, rf, rcp = kmq.ericson_select_plain(p3, rows9, cand, st)
        np.testing.assert_array_equal(d2, rd2.numpy())
        np.testing.assert_array_equal(f_id, rf.numpy())
        np.testing.assert_array_equal(cp, torch.stack(rcp).numpy())


@pytest.mark.parametrize("num_cands", [1, 3, 11, 12, 18, 24, 36, 48, 72])
@pytest.mark.parametrize("n,stride", [(65536, 4), (196608, 4), (65536, 1), (196608, 1),
                                      (4096, 4), (100, 2), (99, 3), (4096, 8)])
def test_select_plan_slices_every_candidate_once(num_cands, n, stride):
    """Members divide the stride; slices are a power of two, >= 2 where C
    allows 2 slices of 6, <= 8 and with >= 6 candidates each, the least
    that gives >= 131,072 threads or the most; the bounds cover every
    candidate once, contiguous and in order, sizes within one."""
    plan = kmq.select_plan(n, num_cands, stride)
    members, slices, bounds = plan["members"], plan["slices"], plan["bounds"]
    assert members in (1, 2, 4) and stride % members == 0
    assert members == max(m for m in (1, 2, 4) if stride % m == 0)
    assert slices in (1, 2, 4, 8) and kmq.SELECT_THREADS % slices == 0
    most = max(s for s in (1, 2, 4, 8) if s == 1 or num_cands // s >= 6)
    assert slices <= most and (slices >= 2 or most == 1)
    threads = n // members * slices
    assert threads >= kmq.SELECT_TARGET_THREADS or slices == most
    assert slices <= 2 or n // members * slices // 2 < kmq.SELECT_TARGET_THREADS
    assert len(bounds) == slices + 1 and bounds[0] == 0 and bounds[-1] == num_cands
    sizes = np.diff(bounds)
    assert (sizes >= 1).all() and sizes.max() - sizes.min() <= 1
    covered = np.concatenate([np.arange(bounds[s], bounds[s + 1]) for s in range(slices)])
    np.testing.assert_array_equal(covered, np.arange(num_cands))


def test_select_plan_at_the_main_path_shapes():
    """C=24: N=65,536 at stride 4, 4 slices of 6 candidates (65,536
    threads); the human step's N=196,608 at stride 4, 4 slices; stride 1,
    2 slices of 12."""
    assert kmq.select_plan(65536, 24, 4) == {"members": 4, "slices": 4,
                                              "bounds": [0, 6, 12, 18, 24]}
    assert kmq.select_plan(196608, 24, 4)["slices"] == 4
    assert kmq.select_plan(65536, 24, 1) == {"members": 1, "slices": 2, "bounds": [0, 12, 24]}
    assert kmq.select_plan(196608, 24, 1)["slices"] == 2


def signed_tables_model(p3, knn_idx, incidence, vtab9, vntab9, stride, bounds):
    """The table kernel, in numpy: candidate ci = j*D + d of group g is table
    entry e = knn_idx[g, j] * D + d, face incidence.flat[e], corners at
    9 e of the flat vtab9; the slices scanned and merged as `select_model`'s,
    the winning candidate's index carried; then the winner's entry reloaded,
    its corners and corner normals, for the barycentric weights and the
    sign, in the kernel's order of operations. Returns (sd, f_id, cp) as the plain
    version does."""
    n = p3.shape[1]
    nq, k = knn_idx.shape
    deg = incidence.shape[1]
    flat_inc = incidence.numpy().reshape(-1)
    tab = vtab9.numpy().reshape(-1)
    ntab = vntab9.numpy().reshape(-1)
    knn = knn_idx.numpy().astype(np.int64)
    cols = np.arange(nq)

    def entry(ci):  # [Nq] table entries of candidate ci (an int or one per group)
        j = ci // deg
        return knn[cols, j] * deg + (ci - j * deg)

    def nine(flat, e):
        return [flat[e * 9 + i] for i in range(9)]

    pts = p3.numpy().reshape(3, nq, stride)
    sd = np.zeros((nq, stride), np.float32)
    f_id = np.zeros((nq, stride), np.int32)
    cp = np.zeros((3, nq, stride), np.float32)
    for m in range(stride):
        p = [torch.tensor(pts[a, :, m]) for a in range(3)]
        dist, close = [], []
        for ci in range(k * deg):
            e = entry(ci)
            t = [torch.tensor(x) for x in nine(tab, e)]
            o = kmq.closest_point_on_triangles_planar(p, t[0:3], t[3:6], t[6:9])
            d2 = ((o[0] - p[0]) * (o[0] - p[0]) + (o[1] - p[1]) * (o[1] - p[1])
                  + (o[2] - p[2]) * (o[2] - p[2])).numpy()
            dist.append(np.where(flat_inc[e] >= 0, d2, np.float32(np.inf)))
            close.append([c.numpy() for c in o])
        win_d = np.full(nq, np.inf, np.float32)
        win_c = np.zeros(nq, np.int64)
        for s in range(len(bounds) - 1):
            c0, c1 = bounds[s], bounds[s + 1]
            sd_s = np.full(nq, np.inf, np.float32) if s else dist[c0].copy()
            sc = np.full(nq, c0, np.int64)
            for ci in range(c0 + (0 if s else 1), c1):
                lower = dist[ci] < sd_s
                sd_s[lower], sc[lower] = dist[ci][lower], ci
            take = sd_s < win_d if s else np.ones(nq, bool)
            win_d[take], win_c[take] = sd_s[take], sc[take]
        # the winner's reload
        e = entry(win_c)
        ax, ay, az, bx, by, bz, cx, cy, cz = nine(tab, e)
        nm = nine(ntab, e)
        o = [np.stack(close)[win_c, a, cols] for a in range(3)]
        one = np.float32(1.0)
        e1, e2 = (bx - ax, by - ay, bz - az), (cx - ax, cy - ay, cz - az)
        nx, ny, nz = (e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                      e1[0] * e2[1] - e1[1] * e2[0])
        denom = nx * nx + ny * ny + nz * nz
        denom = np.where(np.abs(denom) < np.float32(1e-20), np.float32(1e-20), denom)
        bc, qb = (cx - bx, cy - by, cz - bz), (o[0] - bx, o[1] - by, o[2] - bz)
        uu = (nx * (bc[1] * qb[2] - bc[2] * qb[1]) + ny * (bc[2] * qb[0] - bc[0] * qb[2])
              + nz * (bc[0] * qb[1] - bc[1] * qb[0])) / denom
        ca, qc = (ax - cx, ay - cy, az - cz), (o[0] - cx, o[1] - cy, o[2] - cz)
        vv = (nx * (ca[1] * qc[2] - ca[2] * qc[1]) + ny * (ca[2] * qc[0] - ca[0] * qc[2])
              + nz * (ca[0] * qc[1] - ca[1] * qc[0])) / denom
        ww = one - uu - vv
        mx, my, mz = (uu * nm[a] + vv * nm[3 + a] + ww * nm[6 + a] for a in range(3))
        dot = (pts[0, :, m] - o[0]) * mx + (pts[1, :, m] - o[1]) * my + (pts[2, :, m] - o[2]) * mz
        # the square root as the plain version takes it: torch.sqrt, which
        # on the CPU is not always correctly rounded (the kernel's sqrtf and
        # torch.sqrt on the card are)
        dist_m = torch.sqrt(torch.clamp(torch.tensor(win_d), min=0.0)).numpy()
        sd[:, m] = np.where(dot < 0, -dist_m, dist_m)
        f_id[:, m] = np.maximum(flat_inc[e], 0)
        for a in range(3):
            cp[a, :, m] = o[a]
    return sd.reshape(n), f_id.reshape(n), cp.reshape(3, n)


def _signed_tables_case(stride, k, seed, num_verts=30, deg=5, num_faces=6, nq=37):
    """Tables of a made-up mesh on an integer grid (corners, normals and
    points on it: d2 ties and dots of exactly 0 abound): each vertex's row
    holds up to D faces, -1 padded at its end (vertices 0-2 hold none), the
    same faces in many rows; padding rows as face 0 (as build_query_tables
    makes them). knn_idx: k distinct vertices a group, group 1's all
    faceless (an all-invalid group)."""
    rng = np.random.default_rng(seed)
    corners = rng.integers(-2, 3, size=(num_faces, 9)).astype(np.float32)
    normals = rng.integers(-1, 2, size=(num_faces, 9)).astype(np.float32)
    incidence = np.full((num_verts, deg), -1, np.int32)
    for v in range(3, num_verts):
        d = rng.integers(1, deg + 1)
        incidence[v, :d] = rng.choice(num_faces, size=d, replace=False)
    safe = np.maximum(incidence, 0)
    vtab9 = corners[safe].reshape(num_verts, deg * 9)
    vntab9 = normals[safe].reshape(num_verts, deg * 9)
    knn_idx = np.stack([rng.choice(np.arange(3, num_verts), size=k, replace=False)
                        for _ in range(nq)])
    knn_idx[1] = np.arange(k) % 3
    pts = rng.integers(-2, 3, size=(3, nq * stride)).astype(np.float32)
    pts[:, ::3] += 0.5
    return tuple(torch.tensor(x) for x in (pts, knn_idx, incidence, vtab9, vntab9))


@pytest.mark.parametrize("k", [3, 4, 6])
@pytest.mark.parametrize("stride", [1, 2, 4])
def test_signed_tables_model_matches_plain_bit_for_bit(stride, k):
    """The table kernel's addressing (candidate j*D + d -> table entry and
    face id), its slice merge and the winner's reload give the plain
    version's sd, face id and closest point bit for bit under every slice
    plan, on integer-grid ties with faces
    repeated across KNN vertices, D padding and an all-invalid group
    (candidate 0: f_id 0, |sd| = inf)."""
    p3, knn_idx, incidence, vtab9, vntab9 = _signed_tables_case(stride, k, seed=stride + 7 * k)
    want = kmq.ericson_signed_select_tables_plain(p3, knn_idx, incidence, vtab9, vntab9, stride)
    num_cands = k * incidence.shape[1]
    for slices in (1, 2, 4, 8):
        bounds = [s * num_cands // slices for s in range(slices + 1)]
        sd, f_id, cp = signed_tables_model(p3, knn_idx, incidence, vtab9, vntab9, stride, bounds)
        np.testing.assert_array_equal(sd, want[0].numpy())
        np.testing.assert_array_equal(f_id, want[1].numpy())
        np.testing.assert_array_equal(cp, torch.stack(want[2]).numpy())
    invalid = slice(stride, 2 * stride)
    assert np.isinf(sd[invalid]).all() and (f_id[invalid] == 0).all()
    # the inputs are tie-rich: the least d2 is reached by several candidates
    nq = knn_idx.shape[0]
    rows9 = kmq.planar_rows(vtab9[knn_idx], nq)
    cand = incidence[knn_idx].reshape(nq, -1).T.contiguous()
    tied = [(d2 == d2.amin(0)).sum(0) > 1
            for d2, _ in (kmq._member_candidates(p3, rows9, cand, stride, m)
                          for m in range(stride))]
    assert torch.stack(tied)[:, 2:].float().mean() > 0.5
    assert (sd < 0).any() and (sd > 0).any()


@pytest.mark.parametrize("stride", [1, 4])
def test_signed_tables_model_matches_plain_on_the_body(stride):
    """The same on the fused query of the shape regulariser: ray samples
    through the body proxy, its query tables, the bucketed KNN's knn_idx
    (int32, as that kernel gives it, and int64), the plan `select_plan`
    makes."""
    verts, faces = synthetic_body_mesh(subdivisions=2)
    verts = torch.tensor(verts)
    topo = tmesh.MeshTopology.build(faces, len(verts))
    tabs = tmesh.build_query_tables(verts, topo)
    rng = np.random.default_rng(5)
    pts = verts[torch.tensor(rng.integers(0, len(verts), 96))] * 1.03
    knn_idx, st = tmesh._query_knn(pts, verts, 4, stride, "bucketed")
    p3 = pts.T.contiguous()
    plan = kmq.select_plan(p3.shape[1], 4 * tabs.incidence.shape[1], st)
    for index in (knn_idx.to(torch.int32), knn_idx):
        args = (index, tabs.incidence, tabs.vtab9, tabs.vntab9, st)
        want = kmq.ericson_signed_select_tables_plain(p3, *args)
        sd, f_id, cp = signed_tables_model(p3, *args, plan["bounds"])
        np.testing.assert_array_equal(sd, want[0].numpy())
        np.testing.assert_array_equal(f_id, want[1].numpy())
        np.testing.assert_array_equal(cp, torch.stack(want[2]).numpy())
