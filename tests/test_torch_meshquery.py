"""The port's ericson_select, ericson_signed_select (planar and on the
query tables), closest-point query and signed distance vs neuman_tpu.

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
