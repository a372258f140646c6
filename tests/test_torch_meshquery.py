"""The port's ericson_select, ericson_signed_select (planar and on the
query tables), closest-point query and signed distance vs neuman_tpu, and
the exact vertex KNN (`exact_knn_plain`, the exact_knn kernel's twin) against
an f64 brute force.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are held to those on the card (tests/test_torch_cuda.py, and chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.ops import mesh as jmesh
from neuman_tpu.ops.pallas.meshquery import ericson_select_pallas, ericson_signed_select_pallas
from neuman_tpu.utils.synthetic_body import synthetic_body_mesh
from neuman_tpu_torch.ops import mesh as tmesh
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from tests.test_mesh_ops import brute_closest_numpy

torch.set_num_threads(1)


def _ray_points(verts, num_rays=24, s=16, seed=0):
    """Ray-ordered samples marching through the surface (stride groups
    of consecutive samples stay spatially coherent)."""
    rng = np.random.default_rng(seed)
    targets = verts[rng.integers(0, len(verts), num_rays)]
    origins = targets * 3.0
    tt = np.linspace(0.8, 1.2, s)[None, :, None]
    return (origins[:, None] * (1 - tt) + targets[:, None] * tt).reshape(-1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def body():
    verts, faces = synthetic_body_mesh(subdivisions=2)
    topo = tmesh.MeshTopology.build(faces, len(verts))
    return verts, faces, topo, torch.tensor(verts), torch.tensor(_ray_points(verts))


@pytest.mark.parametrize("stride", [1, 4])
def test_ericson_select_matches_pallas(body, stride):
    _, _, topo, verts, pts = body
    p3, rows9, cand, stride = tmesh.candidate_operands(pts, verts, topo, k=4, knn_stride=stride)
    d2, f_id, cp = kmq.ericson_select(p3, rows9, cand, stride)
    jd2, jf, jcp = ericson_select_pallas(
        jnp.asarray(p3.numpy()), jnp.asarray(rows9.numpy()), jnp.asarray(cand.numpy()),
        True, stride,
    )
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-6)
    for a in range(3):
        np.testing.assert_allclose(cp[a].numpy(), np.asarray(jcp[a]), atol=1e-6)
    clear = (kmq.tie_gap(p3, rows9, cand, stride) > 1e-6).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(f_id.numpy()[clear], np.asarray(jf)[clear])


@pytest.mark.parametrize("stride", [1, 4])
def test_point_mesh_closest_matches_brute_force(body, stride):
    verts_np, faces, topo, verts, pts = body
    d2, f_id, cp = tmesh.point_mesh_closest_planar(pts, verts, topo, k=4, knn_stride=stride)
    d2_b, _, cp_b = brute_closest_numpy(pts.numpy(), verts_np, faces)
    d2 = d2.numpy()
    # a restricted candidate set can only miss the closest face, never beat it
    assert np.all(d2 >= d2_b - 1e-6)
    exact = np.abs(d2 - d2_b) <= 1e-6
    assert exact.mean() > 0.9, exact.mean()
    np.testing.assert_allclose(np.stack([c.numpy() for c in cp], 1)[exact], cp_b[exact], atol=1e-5)
    # the returned face holds the returned closest point
    tri = verts_np[faces[f_id.numpy()]]
    on_face = np.stack([c.numpy() for c in cp], 1)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    np.testing.assert_allclose(((on_face - tri[:, 0]) * n).sum(-1), 0.0, atol=1e-5)


def test_ericson_select_envelope_gradient_matches_jax(body):
    _, _, topo, verts, pts = body
    p3, rows9, cand, stride = tmesh.candidate_operands(pts, verts, topo, k=4, knn_stride=4)
    w = np.random.default_rng(1).uniform(0.5, 1.5, size=p3.shape[1]).astype(np.float32)
    p3 = p3.clone().requires_grad_(True)
    d2, _, _ = kmq.ericson_select(p3, rows9, cand, stride)
    (d2 * torch.tensor(w)).sum().backward()

    def loss(p):
        jd2, _, _ = ericson_select_pallas(p, jnp.asarray(rows9.numpy()),
                                          jnp.asarray(cand.numpy()), True, stride)
        return jnp.sum(jd2 * w)

    g = jax.grad(loss)(jnp.asarray(p3.detach().numpy()))
    np.testing.assert_allclose(p3.grad.numpy(), np.asarray(g), atol=1e-5)


def _signed_operands(body, stride, tables=False):
    _, _, topo, verts, pts = body
    tabs = tmesh.build_query_tables(verts, topo) if tables else None
    return tmesh.candidate_operands(pts, verts, topo, k=4, knn_stride=stride, tables=tabs,
                                    normals=True)


@pytest.mark.parametrize("stride", [1, 4])
def test_ericson_signed_select_matches_pallas(body, stride):
    """sd and the closest point against the fused Pallas kernel in interpret
    mode at 1e-6 (the same f32 operations), the face id outside ties; the
    sign may differ only where |sd| is that small."""
    p3, rows9, vn9, cand, stride = _signed_operands(body, stride)
    assert vn9.shape == rows9.shape
    sd, f_id, cp = kmq.ericson_signed_select(p3, rows9, vn9, cand, stride)
    psd, pf, pcp = kmq.ericson_signed_select_plain(p3, rows9, vn9, cand, stride)
    assert torch.equal(sd, psd) and torch.equal(f_id, pf)
    assert all(torch.equal(a, b) for a, b in zip(cp, pcp))
    jsd, jf, jcp = ericson_signed_select_pallas(
        jnp.asarray(p3.numpy()), jnp.asarray(rows9.numpy()), jnp.asarray(vn9.numpy()),
        jnp.asarray(cand.numpy()), True, stride)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=1e-6)
    for a in range(3):
        np.testing.assert_allclose(cp[a].numpy(), np.asarray(jcp[a]), atol=1e-6)
    clear = (kmq.tie_gap(p3, rows9, cand, stride) > 1e-6).numpy()
    np.testing.assert_array_equal(f_id.numpy()[clear], np.asarray(jf)[clear])
    assert (sd < 0).any() and (sd > 0).any()
    # and the unsigned kernel's outputs on the same operands, exactly
    d2, uf, ucp = kmq.ericson_select(p3, rows9, cand, stride)
    assert torch.equal(sd.abs(), torch.sqrt(d2.clamp(min=0))) and torch.equal(f_id, uf)
    assert all(torch.equal(a, b) for a, b in zip(cp, ucp))


@pytest.mark.parametrize("tables", [False, True], ids=["gathered", "tables"])
@pytest.mark.parametrize("stride", [1, 4])
def test_signed_distance_fused_matches_jax_and_unfused(body, stride, tables):
    """`signed_distance(fused=True)` against the JAX package's
    use_pallas="fused" and against the port's unfused path: distances at
    1e-5, closest points at 1e-4 (the bars of tests/test_mesh_ops.py), signs
    equal wherever |sd| > 1e-5, face ids outside ties."""
    verts_np, faces, topo, verts, pts = body
    tabs = tmesh.build_query_tables(verts, topo) if tables else None
    kw = dict(k=4, knn_stride=stride, tables=tabs)
    sd, f_id, closest = tmesh.signed_distance(pts, verts, topo, fused=True, **kw)
    usd, uf, uclosest = tmesh.signed_distance(pts, verts, topo, **kw)
    plain = tmesh.signed_distance(pts, verts, topo, fused=True, use_kernels=False, **kw)
    assert torch.equal(sd, plain[0]) and torch.equal(closest, plain[2])
    assert closest.shape == (pts.shape[0], 3)
    np.testing.assert_allclose(sd.numpy(), usd.numpy(), atol=1e-5)
    np.testing.assert_allclose(closest.numpy(), uclosest.numpy(), atol=1e-4)
    assert torch.equal(f_id, uf)
    jtopo = jmesh.MeshTopology.build(faces, len(verts_np))
    jtabs = jmesh.build_query_tables(jnp.asarray(verts_np), jtopo) if tables else None
    jsd, jf, jclosest = jmesh.signed_distance(
        jnp.asarray(pts.numpy()), jnp.asarray(verts_np), jtopo, k=4, knn_stride=stride,
        tables=jtabs, use_pallas="fused")
    jsd = np.asarray(jsd)
    np.testing.assert_allclose(np.abs(sd.numpy()), np.abs(jsd), atol=1e-5)
    np.testing.assert_allclose(closest.numpy(), np.asarray(jclosest), atol=1e-4)
    far = np.abs(jsd) > 1e-5
    np.testing.assert_array_equal(np.sign(sd.numpy())[far], np.sign(jsd)[far])
    assert 0.02 < (jsd < 0).mean() < 0.98


@pytest.mark.parametrize("tables", [False, True], ids=["gathered", "tables"])
@pytest.mark.parametrize("stride", [1, 4])
def test_signed_select_tables_plain_matches_planar_and_jax(body, stride, tables):
    """The table form (`ericson_signed_select_tables`, its plain version on
    CPU tensors, int64 and int32 knn_idx) equals the planar plain version
    bit for bit on the same candidates gathered into planes, from the
    vertices or from prebuilt tables (the same values: padding as face 0 in
    both); and JAX's `_signed_distance_planar(use_pallas="fused")` at the
    bars of test_signed_distance_fused_matches_jax_and_unfused: distances
    1e-5, closest points 1e-4, signs where |sd| > 1e-5."""
    verts_np, faces, topo, verts, pts = body
    tabs = tmesh.build_query_tables(verts, topo)
    knn_idx, st = tmesh._query_knn(pts, verts, 4, stride)
    p3 = pts.T.contiguous()
    p3_, rows9, vn9, cand, _ = tmesh.candidate_operands(
        pts, verts, topo, k=4, knn_stride=stride, tables=tabs if tables else None, normals=True)
    qsd, qf, qcp = kmq.ericson_signed_select(p3_, rows9, vn9, cand, st)
    for index in (knn_idx, knn_idx.to(torch.int32)):
        sd, f_id, cp = kmq.ericson_signed_select_tables(p3, index, tabs.incidence, tabs.vtab9,
                                                        tabs.vntab9, st)
        assert torch.equal(sd, qsd) and torch.equal(f_id, qf)
        assert all(torch.equal(a, b) for a, b in zip(cp, qcp))
    jtopo = jmesh.MeshTopology.build(faces, len(verts_np))
    jtabs = jmesh.build_query_tables(jnp.asarray(verts_np), jtopo) if tables else None
    jsd, jf, jcp = jmesh._signed_distance_planar(
        jnp.asarray(pts.numpy()), jnp.asarray(verts_np), jtopo, k=4, knn_stride=stride,
        tables=jtabs, use_pallas="fused")
    jsd = np.asarray(jsd)
    np.testing.assert_allclose(np.abs(sd.numpy()), np.abs(jsd), atol=1e-5)
    for a in range(3):
        np.testing.assert_allclose(cp[a].numpy(), np.asarray(jcp[a]), atol=1e-4)
    far = np.abs(jsd) > 1e-5
    np.testing.assert_array_equal(np.sign(sd.numpy())[far], np.sign(jsd)[far])
    assert 0.02 < (jsd < 0).mean() < 0.98


def test_signed_select_gradient_matches_jax(body):
    """d sd / d p = sign(sd) (p - cp) / |sd| against jax.grad through the
    fused kernel's custom VJP, 1e-5; nothing flows into the mesh."""
    p3, rows9, vn9, cand, stride = _signed_operands(body, 4, tables=True)
    w = np.random.default_rng(1).uniform(0.5, 1.5, size=p3.shape[1]).astype(np.float32)
    p3 = p3.clone().requires_grad_(True)
    rows9, vn9 = rows9.clone().requires_grad_(True), vn9.clone().requires_grad_(True)
    sd, _, _ = kmq.ericson_signed_select(p3, rows9, vn9, cand, stride)
    (sd * torch.tensor(w)).sum().backward()
    assert rows9.grad is None and vn9.grad is None

    def loss(p):
        jsd, _, _ = ericson_signed_select_pallas(
            p, jnp.asarray(rows9.detach().numpy()), jnp.asarray(vn9.detach().numpy()),
            jnp.asarray(cand.numpy()), True, stride)
        return jnp.sum(jsd * w)

    g = jax.grad(loss)(jnp.asarray(p3.detach().numpy()))
    np.testing.assert_allclose(p3.grad.numpy(), np.asarray(g), atol=1e-5)


# -- the exact vertex KNN (`knn.exact_knn`; its kernel on the card) ---------------------------

def _exact_case(num_verts=642, nq=1001, seed=4):
    """The body proxy's first `num_verts` vertices and `nq` points (no
    multiple of any tile) within 0.1 of random vertices."""
    verts = torch.tensor(synthetic_body_mesh(subdivisions=3)[0][:num_verts], dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    pts = verts[torch.randint(0, num_verts, (nq,), generator=g)] + 0.1 * torch.randn(
        nq, 3, generator=g)
    return pts, verts


def _d2_f64(pts, verts):
    return ((pts.double()[:, None] - verts.double()[None]) ** 2).sum(-1)


@pytest.mark.parametrize("k", [1, 3, 4, 6, 8])
def test_exact_knn_plain_matches_f64_brute_force(k):
    """The k picks, in order, are the f64 brute force's k nearest wherever
    a point's k-th and (k+1)-th f64 distances differ by more than 1e-5 (a
    few f32 ulps of the scores at this scale): the same set; every pick's
    f64 distance no further than 1e-5 past the next pick's (the order up to
    such ties)."""
    pts, verts = _exact_case()
    idx = kknn.exact_knn_plain(pts, verts, k)
    assert idx.dtype == torch.int64 and idx.shape == (pts.shape[0], k)
    d2 = _d2_f64(pts, verts)
    srt = torch.sort(d2, dim=1)
    clear = (srt.values[:, k] - srt.values[:, k - 1]) > 1e-5
    assert clear.float().mean() > 0.9
    got = torch.sort(idx[clear], dim=1).values
    want = torch.sort(srt.indices[clear, :k], dim=1).values
    assert torch.equal(got, want)
    picked = d2.gather(1, idx)
    assert ((picked[:, 1:] - picked[:, :-1]) >= -1e-5).all()


def test_exact_knn_plain_ties_go_to_the_lower_index():
    """Equal scores: the lower vertex index first, duplicated vertices and
    on an integer grid where most scores tie exactly (each row against a
    stable sort by (score, index) of the f32 scores)."""
    verts = torch.tensor(synthetic_body_mesh(subdivisions=2)[0], dtype=torch.float32)
    verts[[40, 7, 90]] = verts[25].clone()
    idx = kknn.exact_knn_plain(verts[25:26] * 1.0, verts, 5)
    assert idx[0, :4].tolist() == [7, 25, 40, 90]
    g = torch.Generator().manual_seed(7)
    grid_v = torch.randint(-3, 4, (300, 3), generator=g).float()
    grid_p = torch.randint(-4, 5, (257, 3), generator=g).float()
    idx = kknn.exact_knn_plain(grid_p, grid_v, 8)
    score = kknn._scores(grid_p, kknn.vertex_rows(grid_v)).double()
    key = score * 4096 + torch.arange(300, dtype=torch.float64)  # scores are integers here
    assert torch.equal(idx, torch.sort(key, dim=1).indices[:, :8])
    assert (score.gather(1, idx)[:, :-1] == score.gather(1, idx)[:, 1:]).any()


def test_exact_knn_plain_chunks_do_not_change_it(monkeypatch):
    """A ragged Nq in chunks of 7 points equals one chunk; an empty query
    set gives [0, k]."""
    pts, verts = _exact_case(nq=103)
    want = kknn.exact_knn_plain(pts, verts, 4)
    monkeypatch.setattr(kknn, "EXACT_PLAIN_SCORES", 7 * verts.shape[0])
    assert torch.equal(kknn.exact_knn_plain(pts, verts, 4), want)
    assert kknn.exact_knn(pts[:0], verts, 4).shape == (0, 4)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_query_knn_exact_groups_by_stride(body, stride):
    """`_query_knn(knn_impl="exact")` takes each group's middle point (the
    rows read in place) and gives `exact_knn_plain`'s picks, with and
    without use_kernels on the CPU; a point count that is no multiple of
    the stride takes stride 1."""
    _, _, _, verts, pts = body
    got, st = tmesh._query_knn(pts, verts, 4, stride)
    assert st == stride
    mid = pts.reshape(-1, stride, 3)[:, stride // 2].contiguous()
    assert torch.equal(got, kknn.exact_knn_plain(mid, verts, 4))
    assert torch.equal(tmesh._query_knn(pts, verts, 4, stride, use_kernels=False)[0], got)
    odd, st = tmesh._query_knn(pts[:-1], verts, 4, stride)
    assert st == 1 and torch.equal(odd, kknn.exact_knn_plain(pts[:-1], verts, 4))


def test_exact_knn_agrees_with_bucketed_where_buckets_are_distinct():
    """Where a point's exact k nearest lie in k distinct buckets (i % 64)
    and its k + 1 least scores are distinct, each is its bucket's winner
    and the bucketed KNN returns the same vertices in the same order."""
    pts, verts = _exact_case()
    exact = kknn.exact_knn_plain(pts, verts, 5)
    bucketed = kknn.bucketed_knn_plain(pts, verts, 4)[0].long()
    score = torch.sort(kknn._scores(pts, kknn.vertex_rows(verts)), dim=1).values[:, :5]
    buckets = exact[:, :4] % kknn.NUM_BUCKETS
    distinct = torch.stack([(buckets[:, a] != buckets[:, b])
                            for a in range(4) for b in range(a)]).all(0)
    rows = distinct & (score[:, 1:] > score[:, :-1]).all(1)
    assert rows.float().mean() > 0.5
    assert torch.equal(bucketed[rows], exact[rows, :4])


def test_exact_knn_refuses_k_over_8_and_other_devices():
    pts, verts = _exact_case(nq=16)
    for fn in (kknn.exact_knn_plain, kknn.exact_knn):
        with pytest.raises(ValueError, match="k=9"):
            fn(pts, verts, 9)
        with pytest.raises(ValueError, match="k=0"):
            fn(pts, verts, 0)
        with pytest.raises(ValueError, match="k=4 of 3 vertices"):
            fn(pts, verts[:3], 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        kknn.exact_knn(pts.to("meta"), verts.to("meta"), 4)


def test_exact_knn_dispatch_on_the_cpu_is_the_plain_version():
    """CPU tensors run the plain version with no launch; the kernel is
    registered."""
    from neuman_tpu_torch.ops import kernels

    assert "exact_knn" in kernels.KERNELS
    pts, verts = _exact_case(nq=64)
    before = kernels.launches()
    assert torch.equal(kknn.exact_knn(pts, verts, 4), kknn.exact_knn_plain(pts, verts, 4))
    assert kernels.launches(before)["exact_knn"] == 0


def _exact_plan_np(nq, num_verts, k, num_sms):
    queries = 4 if k <= 4 else 2
    tiles = int(np.ceil(nq / (128 * queries)))
    want = int(np.floor(8 * num_sms / max(tiles, 1)))
    slices = max(1, min(int(np.ceil(num_verts / 64)), want))
    slice_verts = max(1, int(np.ceil(num_verts / slices)))
    return queries, tiles, max(1, int(np.ceil(num_verts / slice_verts))), slice_verts


@pytest.mark.parametrize("nq", [1, 511, 512, 16384, 65536, 196608, 1048576])
@pytest.mark.parametrize("num_verts", [8, 65, 642, 6890, 40962])
@pytest.mark.parametrize("k", [4, 8])
def test_exact_plan_matches_numpy(nq, num_verts, k):
    """The plan against a numpy restatement; every slice holds vertices,
    together all of them, no more slices than V / 64 rounded up, no more
    than 8 blocks an SM in all where the tiles leave room (one wave), and
    one slice where the query tiles alone reach 8 blocks an SM."""
    plan = kknn.exact_plan(nq, num_verts, k, 132)
    assert (plan["queries"], plan["tiles"], plan["slices"], plan["slice_verts"]) == \
        _exact_plan_np(nq, num_verts, k, 132)
    s, sv = plan["slices"], plan["slice_verts"]
    assert s * sv >= num_verts and (s - 1) * sv < num_verts
    assert s <= -(-num_verts // kknn.EXACT_MIN_SLICE_VERTS)
    assert s == 1 or plan["tiles"] * s <= 8 * 132
    if plan["tiles"] >= 8 * 132:
        assert s == 1
