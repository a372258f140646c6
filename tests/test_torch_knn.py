"""The port's bucketed vertex KNN, signed distance, differentiable warp and
`vertex_forward` vs neuman_tpu.

On the CPU `bucketed_knn` runs its plain PyTorch version and
`ericson_select` its own; the CUDA kernels are held to those on the card
(tests/test_torch_cuda.py, chip_smoke.py). Meshes are the body proxy at
subdivision 2 (V=162) and slices of it; points are ray-ordered samples
through the surface.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.models import human_nerf as jhn
from neuman_tpu.models import smpl as jsmpl
from neuman_tpu.ops import mesh as jmesh
from neuman_tpu.ops.pallas.meshquery import bucketed_knn_pallas
from neuman_tpu.utils.synthetic_body import synthetic_body_mesh
from neuman_tpu_torch.models import human_nerf as thn
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.ops import mesh as tmesh
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from tests.test_mesh_ops import brute_closest_numpy
from tests.torch_parity import t

torch.set_num_threads(1)

# two vertex scores closer than this are a tie: either vertex is right
SCORE_GAP = 1e-5


def _ray_points(verts, num_rays=24, s=16, seed=0):
    rng = np.random.default_rng(seed)
    targets = verts[rng.integers(0, len(verts), num_rays)]
    origins = targets * 3.0
    tt = np.linspace(0.8, 1.2, s)[None, :, None]
    return (origins[:, None] * (1 - tt) + targets[:, None] * tt).reshape(-1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def body():
    verts, faces = synthetic_body_mesh(subdivisions=2)
    return verts.astype(np.float32), faces, _ray_points(verts)


def _exact_scores(points, verts):
    """[N, V] |v|^2 - 2 v.p in f64."""
    p, v = points.astype(np.float64), verts.astype(np.float64)
    return (v * v).sum(-1)[None] - 2.0 * p @ v.T


# V not a multiple of 64 (padding rows), a multiple of 64, V < 64 (buckets
# that hold only padding: the clamp) and V < 64 with k near V
@pytest.mark.parametrize("num_verts,k", [(162, 4), (128, 4), (40, 3), (5, 4)])
def test_bucketed_knn_matches_pallas(body, num_verts, k):
    verts, _, pts = body
    verts = verts[:num_verts]
    idx, score = kknn.bucketed_knn(t(pts), t(verts), k)
    want = np.asarray(bucketed_knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k, interpret=True))
    assert idx.shape == (len(pts), k) and idx.dtype == torch.int32
    assert idx.min() >= 0 and idx.max() < num_verts
    exact = _exact_scores(pts, verts)
    rows = np.arange(len(pts))[:, None]
    # the two packages order a point's picks by the same scores; a pick may
    # differ only where the two vertices' scores tie
    mine, theirs = exact[rows, idx.numpy()], exact[rows, want]
    valid = idx.numpy() < num_verts - 1  # picks of padding-only buckets clamp to V - 1
    np.testing.assert_allclose(mine[valid], theirs[valid], atol=SCORE_GAP)
    assert (idx.numpy() == want).mean() > 0.99
    if num_verts >= 64:
        np.testing.assert_allclose(score.numpy(), mine, atol=SCORE_GAP)


def test_bucketed_knn_recall_of_exact_top_k(body):
    """With V=162 in 64 buckets of <= 3 vertices the bucket winners hold
    nearly all of a point's 4 nearest vertices; the nearest one always."""
    verts, _, pts = body
    idx, _ = kknn.bucketed_knn(t(pts), t(verts), 4)
    exact = np.argsort(_exact_scores(pts, verts), axis=1, kind="stable")[:, :4]
    assert (idx.numpy()[:, 0] == exact[:, 0]).all()
    recall = (idx.numpy()[:, :, None] == exact[:, None, :]).any(1).mean()
    assert recall > 0.8, recall


def test_bucketed_knn_ties_go_to_the_lower_bucket_and_earlier_vertex():
    """Equal scores: within a bucket the earlier vertex, across buckets the
    lower bucket (as `lax.top_k` on the [N, B] winners)."""
    verts = np.zeros((130, 3), np.float32)
    verts[:, 0] = 5.0
    verts[[3, 67, 9]] = [[1, 0, 0], [1, 0, 0], [1, 0, 0]]  # 3 and 67 share bucket 3
    idx, score = kknn.bucketed_knn(t(np.array([[1.0, 0, 0]])), t(verts), 3)
    assert idx[0].tolist() == [3, 9, 0]
    assert score[0, 0] == score[0, 1] < score[0, 2]


def test_bucketed_knn_raises_off_cpu_and_cuda(body):
    verts, _, pts = body
    with pytest.raises(ValueError, match="no kernel for device"):
        kknn.bucketed_knn(t(pts).to("meta"), t(verts).to("meta"), 4)


@pytest.mark.parametrize("stride", [1, 4])
def test_signed_distance_matches_jax_and_brute_force(body, stride):
    verts, faces, pts = body
    topo = tmesh.MeshTopology.build(faces, len(verts))
    jtopo = jmesh.MeshTopology.build(faces, len(verts))
    tables = tmesh.build_query_tables(t(verts), topo)
    sd, f_id, cp = tmesh.signed_distance(t(pts), t(verts), topo, k=4, knn_stride=stride,
                                         tables=tables, knn_impl="bucketed")
    sd2, f2, _ = tmesh.signed_distance(t(pts), t(verts), topo, k=4, knn_stride=stride,
                                       knn_impl="bucketed")
    torch.testing.assert_close(sd, sd2, atol=1e-6, rtol=0)  # with and without the tables
    jsd, jf, jcp = jmesh.signed_distance(
        jnp.asarray(pts), jnp.asarray(verts), jtopo, k=4, knn_stride=stride,
        tables=jmesh.build_query_tables(jnp.asarray(verts), jtopo), use_pallas=True,
        knn_impl="bucketed")
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=1e-5)
    np.testing.assert_allclose(cp.numpy(), np.asarray(jcp), atol=1e-5)
    # the face may differ only where another candidate face ties (a point
    # over a shared edge or vertex)
    ops = tmesh.candidate_operands(t(pts), t(verts), topo, 4, stride, "bucketed")
    clear = (kmq.tie_gap(*ops) > 1e-6).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(f_id.numpy()[clear], np.asarray(jf)[clear])
    # against the exhaustive search: the magnitude wherever the candidate
    # set held the closest face, and the sign of points clear of the surface
    d2_b, _, _ = brute_closest_numpy(pts, verts, faces)
    exact = np.abs(sd.numpy() ** 2 - d2_b) <= 1e-6
    assert exact.mean() > 0.9
    inside = np.linalg.norm(pts, axis=1) < np.linalg.norm(cp.numpy(), axis=1)
    far = np.abs(sd.numpy()) > 1e-3
    np.testing.assert_array_equal((sd.numpy() < 0)[far & exact], inside[far & exact])


def test_angle_weighted_vertex_normals_match_jax(body):
    verts, faces, _ = body
    got = tmesh.angle_weighted_vertex_normals(t(verts), torch.as_tensor(faces.astype(np.int64)))
    want = jmesh.angle_weighted_vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _smpl_pair(num_verts=64):
    jbody = jsmpl.synthetic_smpl_model(num_verts=num_verts, num_joints=24)
    tbody = tsmpl.SMPLModel.from_numpy(
        np.asarray(jbody.v_template), np.asarray(jbody.shapedirs), np.asarray(jbody.J_regressor),
        np.asarray(jbody.lbs_weights), jbody.parents, np.asarray(jbody.faces))
    return jbody, tbody


def _smpl_state(num_views=3, seed=0):
    rng = np.random.default_rng(seed)
    poses = rng.normal(size=(num_views, 72)).astype(np.float32) * 0.1
    betas = rng.normal(size=(num_views, 10)).astype(np.float32) * 0.1
    align = np.tile(np.eye(4, dtype=np.float32)[None], (num_views, 1, 1))
    align[:, :3, 3] = rng.normal(size=(num_views, 3)) * 0.1
    return poses, betas, align


class _Smpl(torch.nn.Module):
    """The SMPL state of a HumanNeRF, which is all vertex_forward reads."""

    def __init__(self, poses, betas, alignments):
        super().__init__()
        self.poses = torch.nn.Parameter(t(poses))
        self.betas = torch.nn.Parameter(t(betas), requires_grad=False)
        self.alignments = torch.nn.Parameter(t(alignments), requires_grad=False)


def test_vertex_forward_values_and_pose_gradient_match_jax():
    """Values and d/d poses at 1e-5 (f32 on both sides, the same formulas)."""
    jbody, tbody = _smpl_pair()
    poses, betas, align = _smpl_state()
    params = {"poses": jnp.asarray(poses), "betas": jnp.asarray(betas),
              "alignments": jnp.asarray(align)}
    rng = np.random.default_rng(1)
    wv = rng.normal(size=(64, 3)).astype(np.float32)
    wt = rng.normal(size=(64, 4, 4)).astype(np.float32)
    da = jhn.da_pose_params(24)

    def jloss(p):
        v, ts = jhn.vertex_forward(None, p, jbody, da, 1.3, 1)
        return jnp.sum(v[0] * wv) + jnp.sum(ts[0] * wt), (v, ts)

    (_, (jv, jts)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = _Smpl(poses, betas, align)
    v, ts = thn.vertex_forward(model, tbody, thn.da_pose_params(24), 1.3, torch.tensor(1))
    assert v.shape == (1, 64, 3) and ts.shape == (1, 64, 4, 4)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(jts), atol=1e-5)
    ((v[0] * t(wv)).sum() + (ts[0] * t(wt)).sum()).backward()
    want = np.asarray(jg["poses"])
    np.testing.assert_allclose(model.poses.grad.numpy(), want, atol=1e-5 * max(1, abs(want).max()))
    assert np.abs(want[1]).max() > 0 and np.abs(want[[0, 2]]).max() == 0


def test_warp_points_to_canonical_diff_values_and_gradients_match_jax(body):
    """The warp's values, and its gradients in `verts` and `T` (the closest
    point and the face choice carry none), at 1e-4 of the gradients' scale:
    the blend's determinant division amplifies the last bits. A point over
    a shared edge or vertex may take either of the tied faces: the values
    agree there too, but the derivative in the vertices belongs to the
    chosen face, so the gradients are compared over the points whose face
    is the same in both packages (each point's term is its own)."""
    verts, faces, pts = body
    topo = tmesh.MeshTopology.build(faces, len(verts))
    jtopo = jmesh.MeshTopology.build(faces, len(verts))
    rng = np.random.default_rng(2)
    ts = np.tile(np.eye(4, dtype=np.float32)[None], (len(verts), 1, 1))
    ts[:, :3, :] += rng.normal(size=(len(verts), 3, 4)).astype(np.float32) * 0.05
    w = rng.normal(size=(len(pts), 3)).astype(np.float32)

    def jwarp(v, tt):
        return jmesh.warp_points_to_canonical_diff(
            jnp.asarray(pts), v, tt, jtopo, k=4, knn_stride=4, use_pallas=True,
            knn_impl="bucketed")[:2]

    tv, tt = t(verts).requires_grad_(True), t(ts).requires_grad_(True)
    can, f_id = tmesh.warp_points_to_canonical_diff(t(pts), tv, tt, topo, k=4, knn_stride=4,
                                                    knn_impl="bucketed")
    jcan, jf = jwarp(jnp.asarray(verts), jnp.asarray(ts))
    same_face = f_id.numpy() == np.asarray(jf)
    assert same_face.mean() > 0.9
    np.testing.assert_allclose(can.detach().numpy(), np.asarray(jcan), atol=1e-5)
    wk = w * same_face[:, None]
    jgv, jgt = jax.grad(lambda v, m: jnp.sum(jwarp(v, m)[0] * wk), argnums=(0, 1))(
        jnp.asarray(verts), jnp.asarray(ts))
    (can * t(wk)).sum().backward()
    for got, want in ((tv.grad, jgv), (tt.grad, jgt)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
