"""The kernel shape sweep (neuman_tpu_torch/tools/sweep_kernel_envelope.py)
on the CPU: its degree-9 mesh, the port's plain mesh queries on that mesh
against the JAX package at SMPL's candidate counts (C = 36 and 72) and
vertex count (V = 6,890), the sweep's failure path, and the rest of
`geometry/pcd.py` and `cameras/capture.py` against the JAX package.

On the CPU the wrappers run their plain versions; the sweep holds the CUDA
kernels to those on the card.
"""

import functools
import json
from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.geometry import pcd as jpcd
from neuman_tpu.ops import mesh as jmesh
from neuman_tpu.ops.pallas.meshquery import bucketed_knn_pallas
from neuman_tpu_torch.geometry import pcd as tpcd
from neuman_tpu_torch.ops import mesh as tmesh
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from neuman_tpu_torch.tools import sweep_kernel_envelope as sweep
from neuman_tpu_torch.utils.synthetic_body import synthetic_body_mesh

torch.set_num_threads(1)

# port vs JAX on d2, closest points and sd: f32 on both sides, other orders
ATOL = 1e-5
# two vertex scores closer than this are a tie: either vertex is right
SCORE_GAP = 1e-5


@pytest.fixture(scope="module")
def deg9_small():
    """The degree-9 mesh of the proxy at subdivision 3 (V=642), ray samples
    through it: (verts [V, 3] f32, faces, degree-9 vertices, points [2048, 3])."""
    verts, faces = synthetic_body_mesh(subdivisions=3)
    faces9, targets = sweep.degree9_mesh(verts, faces)
    gen = torch.Generator().manual_seed(0)
    pts = sweep._ray_samples(torch.tensor(verts, dtype=torch.float32), 16, 128, gen)
    return verts.astype(np.float32), faces9, targets, pts.numpy()


def _edges(faces):
    return [(int(a), int(b)) for tri in faces for a, b in zip(tri, np.roll(tri, -1))]


@pytest.mark.parametrize("subdivisions", [3, 5])
def test_degree9_mesh_is_closed_manifold_with_incidence_width_9(subdivisions):
    verts, faces = synthetic_body_mesh(subdivisions=subdivisions)
    faces9, targets = sweep.degree9_mesh(verts, faces)
    directed = Counter(_edges(faces9))
    undirected = Counter(tuple(sorted(e)) for e in directed)
    # every edge in exactly two faces, once in each direction: closed,
    # manifold and consistently oriented
    assert set(undirected.values()) == {2} and set(directed.values()) == {1}
    assert len(verts) - len(undirected) + len(faces9) == 2
    topo = tmesh.MeshTopology.build(faces9, len(verts))
    assert topo.incidence.shape[1] == 9
    degree = (topo.incidence >= 0).sum(1)
    assert sorted(targets) == sorted(np.flatnonzero(degree.numpy() == 9).tolist())
    if subdivisions == 5:
        assert len(targets) >= 100
    tri = verts[faces9]
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert ((normal * tri.mean(1)).sum(1) > 0).all()  # outward (the body is star-shaped)
    v = torch.tensor(verts, dtype=torch.float32)
    centre = v.mean(0, keepdim=True)
    far = torch.tensor([[5.0, 0, 0], [0, -5.0, 0], [0, 0, 5.0]])
    sd, _, _ = tmesh.signed_distance(torch.cat([centre, far]), v, topo, k=4)
    assert sd[0] < 0 and (sd[1:] > 4).all()


def _face_d2(points, verts, faces, f_id):
    """The oracle: d2 of each point to its given face (Ericson in JAX)."""
    tri = verts[faces[f_id]]
    cp = np.asarray(jmesh.closest_point_on_triangles(
        jnp.asarray(points), jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
        jnp.asarray(tri[:, 2])))
    return ((cp - points) ** 2).sum(1)


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("num_cands", [36, 72])
def test_closest_point_on_degree9_mesh_matches_jax(deg9_small, num_cands, stride):
    """The port's closest-point query (C = k x 9) against the JAX package's
    Pallas kernel in interpret mode and its XLA path: d2 within 1e-5; each
    returned face holds the returned d2 (the oracle), and where the two
    packages chose other faces, JAX's face is as close (a tie: near a
    shared vertex two faces' distances round alike, and the interpret-mode
    kernel rounds other than the XLA path); the closest point within 1e-5
    wherever the faces agree (at a tie it is the other face's)."""
    verts, faces, _, pts = deg9_small
    k = num_cands // 9
    topo = tmesh.MeshTopology.build(faces, len(verts))
    p3, rows9, cand, st = tmesh.candidate_operands(torch.tensor(pts), torch.tensor(verts), topo,
                                                   k=k, knn_stride=stride)
    assert cand.shape[0] == num_cands and st == stride
    d2, f_id, cp = kmq.ericson_select(p3, rows9, cand, st)
    d2, f_id, cp = d2.numpy(), f_id.numpy(), np.stack([c.numpy() for c in cp], 1)
    np.testing.assert_allclose(_face_d2(pts, verts, faces, f_id), d2, atol=ATOL)
    jtopo = jmesh.MeshTopology.build(faces, len(verts))
    for use_pallas in (True, False):
        jd2, jf, jcp = jmesh.point_mesh_closest_planar(
            jnp.asarray(pts), jnp.asarray(verts), jtopo, k=k, knn_stride=stride,
            use_pallas=use_pallas)
        np.testing.assert_allclose(d2, np.asarray(jd2), atol=ATOL)
        jf = np.asarray(jf)
        other = jf != f_id
        assert other.mean() < 0.05
        np.testing.assert_allclose(cp[~other], np.stack([np.asarray(c) for c in jcp], 1)[~other],
                                   atol=ATOL)
        np.testing.assert_allclose(_face_d2(pts[other], verts, faces, jf[other]), d2[other],
                                   atol=ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("num_cands", [36, 72])
def test_signed_distance_on_degree9_mesh_matches_jax(deg9_small, num_cands, stride, fused):
    """sd within 1e-5 of the JAX package's (Pallas in interpret mode, and
    its fused kernel for fused=True) on the query tables, the closest point
    wherever the two chose one face (the ties of the test above); both
    sides inside and outside."""
    verts, faces, _, pts = deg9_small
    k = num_cands // 9
    topo = tmesh.MeshTopology.build(faces, len(verts))
    tables = tmesh.build_query_tables(torch.tensor(verts), topo)
    sd, f_id, cp = tmesh.signed_distance(torch.tensor(pts), torch.tensor(verts), topo, k=k,
                                         knn_stride=stride, tables=tables, fused=fused)
    jtopo = jmesh.MeshTopology.build(faces, len(verts))
    jsd, jf, jcp = jmesh.signed_distance(
        jnp.asarray(pts), jnp.asarray(verts), jtopo, k=k, knn_stride=stride,
        tables=jmesh.build_query_tables(jnp.asarray(verts), jtopo),
        use_pallas="fused" if fused else True)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), atol=ATOL)
    same = f_id.numpy() == np.asarray(jf)
    assert same.mean() > 0.95
    np.testing.assert_allclose(cp.numpy()[same], np.asarray(jcp)[same], atol=ATOL)
    assert (sd < 0).any() and (sd > 0).any()


def test_bucketed_knn_k8_at_smpl_vertex_count_matches_pallas():
    """k = 8 (two queries a thread in the kernel) among V = 6,890 vertices,
    not a multiple of the 64 buckets: the picks equal the JAX kernel's in
    interpret mode except where the two vertices' scores tie."""
    verts = synthetic_body_mesh(subdivisions=5)[0][:sweep.SMPL_VERTS].astype(np.float32)
    gen = torch.Generator().manual_seed(1)
    pts = sweep._ray_samples(torch.tensor(verts), 16, 128, gen).numpy()
    idx, _ = kknn.bucketed_knn_plain(torch.tensor(pts), torch.tensor(verts), 8)
    want = np.asarray(bucketed_knn_pallas(jnp.asarray(pts), jnp.asarray(verts), 8,
                                          interpret=True))
    idx = idx.numpy()
    assert idx.shape == (len(pts), 8) and idx.min() >= 0 and idx.max() < len(verts)
    p, v = pts.astype(np.float64), verts.astype(np.float64)
    score = lambda i: (v[i] ** 2).sum(-1) - 2.0 * (p[:, None] * v[i]).sum(-1)
    other = idx != want
    assert other.mean() < 0.01
    np.testing.assert_allclose(score(idx)[other], score(want)[other], atol=SCORE_GAP)


def test_bucketed_knn_kernel_refuses_k_over_8_by_name():
    """The launch checks k before it loads the library: k = 9 is a
    ValueError that names it (tests/test_torch_cuda.py holds the wrapper to
    it on the card)."""
    verts = torch.tensor(synthetic_body_mesh(subdivisions=2)[0], dtype=torch.float32)
    with pytest.raises(ValueError, match="k=9"):
        kknn._launch(verts[:8], verts, 9, kknn.NUM_BUCKETS)


def _small_select_case(c=36, n=2048):
    return sweep.Case(f"ericson_select C={c} N={n} stride=1",
                      functools.partial(sweep.select_case, c=c, n=n, stride=1))


def test_sweep_passes_plain_against_plain(capsys):
    ctx = sweep.Context("cpu", subdivisions=3)
    cases = [_small_select_case(),
             sweep.Case("knn", functools.partial(sweep.knn_case, nq=2048, num_verts=600, k=8)),
             sweep.Case("signed", functools.partial(sweep.signed_case, c=72, n=2048, stride=4))]
    assert sweep.run_cases(cases, ctx) == []
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["status"] for x in lines[:-1]] == ["PASS"] * 3
    assert lines[-1]["sweep"] == "OK" and lines[-1]["failed"] == []
    assert lines[0]["C"] == 36 and lines[0]["bit_equal_plain"]
    assert lines[1]["queries_a_thread"] == 2 and lines[1]["recall_nearest"] > 0.9


@pytest.mark.parametrize("fault", ["perturbed", "raises"])
def test_sweep_fails_a_case_whose_kernel_disagrees(monkeypatch, capsys, fault):
    """One case's kernel returns a perturbed answer (or raises): the sweep
    prints FAIL for that case, goes on with the next, and main's exit code
    is 1 (`run_cases` returns the failed names)."""
    plain = kmq.ericson_select

    def faulty(p3, rows9, cand, stride=1):
        if fault == "raises":
            raise RuntimeError("launch failed")
        d2, f_id, cp = plain(p3, rows9, cand, stride)
        return d2 + 1e-4, f_id, cp

    monkeypatch.setattr(kmq, "ericson_select", faulty)
    ctx = sweep.Context("cpu", subdivisions=3)
    cases = [_small_select_case(),
             sweep.Case("knn", functools.partial(sweep.knn_case, nq=512, num_verts=None, k=4))]
    failed = sweep.run_cases(cases, ctx)
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(x) for x in out if x.startswith("{")]
    assert failed == [cases[0].name]
    assert lines[0]["status"] == "FAIL" and lines[1]["status"] == "PASS"
    assert lines[-1]["sweep"] == "FAILED" and lines[-1]["failed"] == [cases[0].name]
    if fault == "raises":
        assert "launch failed" in lines[0]["error"]
    monkeypatch.setattr(sweep, "cases", lambda: cases)
    monkeypatch.setattr(sweep, "phase_build", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sweep.card, "smi_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(sweep, "Context", lambda *a, **kw: ctx)
    assert sweep.main([]) == 1


@pytest.mark.parametrize("fault", ["ids_shifted", "ids_of_another_query"])
def test_sweep_fails_a_knn_case_whose_ids_do_not_carry_their_scores(monkeypatch, capsys, fault):
    """The kernel's scores are the plain version's, its vertex ids are not
    (an off-by-one, or another query's): the sweep holds each id to the
    score it comes with and prints FAIL."""
    plain = kknn.bucketed_knn_plain

    def faulty(points, verts, k):
        idx, score = plain(points, verts, k)
        bad = (idx + 1) % verts.shape[0] if fault == "ids_shifted" else idx.roll(1, dims=0)
        return bad, score

    monkeypatch.setattr(kknn, "bucketed_knn", faulty)
    ctx = sweep.Context("cpu", subdivisions=3)
    case = sweep.Case("knn", functools.partial(sweep.knn_case, nq=1024, num_verts=600, k=8))
    assert sweep.run_cases([case], ctx) == ["knn"]
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["status"] == "FAIL" and line["score_max_abs_err"] == 0.0
    assert not line["idx_diff_ties_only"] and line["in_range"]


def test_hold_knn_fails_a_first_pick_that_is_not_the_nearest():
    """Kernel and plain agree, but their first pick is each point's second
    nearest vertex: hold_knn's nearest check fails it (the bucketed KNN
    always finds the nearest vertex, which is its bucket's minimum)."""
    verts = torch.tensor(synthetic_body_mesh(subdivisions=3)[0], dtype=torch.float32)
    pts = sweep._ray_samples(verts, 8, 128, torch.Generator().manual_seed(2))
    idx, score = kknn.bucketed_knn_plain(pts, verts, 4)
    exact = sweep.knn_exact(verts, pts, 4)
    rec, ok = sweep.hold_knn(verts, pts, (idx, score), (idx, score), exact)
    assert ok and rec["nearest_up_to_ties"] and rec["recall_nearest"] > 0.99
    skipped = (idx[:, 1:], score[:, 1:])
    rec, ok = sweep.hold_knn(verts, pts, skipped, skipped, exact)
    assert not ok and not rec["nearest_up_to_ties"] and rec["bit_equal_plain"]


def test_sweep_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--quick"]) != 0


def test_sweep_cases_cover_the_envelope():
    """The full run's cases: every C of SMPL and the proxy, strides 1, 4
    and 8, k = 8 at V = 6,890, S from 16 to 256, both tapes; --quick is
    chip_smoke.py's phase 17."""
    cases = sweep.cases()
    names = [c.name for c in cases]
    assert len(set(names)) == len(names)
    for c in (24, 36, 48, 72):
        assert f"ericson_select C={c} N=262144 stride=1" in names
        assert any(n.startswith(f"ericson_signed_select_tables C={c} ") for n in names)
    assert "ericson_select C=24 N=196608 stride=8" in names
    assert "bucketed_knn Nq=196608 V=6890 k=8" in names
    for s in (16, 32, 64, 128, 256):
        assert f"nerf_mlp S={s} dirs=per_sample bf16" in names
    assert "nerf_mlp_bwd S=128 dirs=per_ray tape=hbm bf16" in names
    assert "offset_mlp S=128 tape=hbm f32" in names
    assert [c.name for c in cases if c.quick] == [
        "ericson_select C=36 N=262144 stride=1", "ericson_select C=72 N=262144 stride=1",
        "ericson_signed_select_tables C=36 N=196608 stride=1",
        "ericson_signed_select_tables C=36 N=196608 stride=4",
        "bucketed_knn Nq=196608 V=6890 k=8",
        "nerf_mlp S=16 dirs=per_ray bf16", "nerf_mlp S=16 dirs=per_sample bf16"]


class _Pose:
    def __init__(self, c2w):
        self.camera_to_world = c2w
        self.extrinsic_matrix = np.linalg.inv(c2w)[:3]


class _Pinhole:
    def __init__(self, h, w, f):
        self.shape = (h, w)
        self.intrinsic_matrix = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])


def _camera(rng, h=24, w=32):
    angles = rng.uniform(-0.2, 0.2, 3)
    cx, cy, cz = np.cos(angles)
    sx, sy, sz = np.sin(angles)
    rot = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
           @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
           @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    c2w = np.eye(4)
    c2w[:3, :3], c2w[:3, 3] = rot, rng.uniform(-0.3, 0.3, 3) + [0, 0, -3.0]
    return _Pinhole(h, w, 30.0), _Pose(c2w)


@pytest.fixture(scope="module")
def view():
    rng = np.random.default_rng(4)
    pinhole, pose = _camera(rng)
    depth = rng.uniform(0.5, 4.0, pinhole.shape)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    img = rng.integers(0, 256, (*pinhole.shape, 3)).astype(np.float64)
    cloud = np.concatenate([rng.uniform(-1, 1, (300, 3)), rng.integers(0, 256, (300, 3))], 1)
    return pinhole, pose, depth, img, cloud


def test_unprojection_matches_jax(view):
    pinhole, pose, depth, img, _ = view
    k, c2w = pinhole.intrinsic_matrix, pose.camera_to_world
    for kw in ({}, {"img": img}, {"cam2world": c2w}, {"img": img, "cam2world": c2w}):
        got, want = tpcd.img_to_pcd_3d(depth, k, **kw), jpcd.img_to_pcd_3d(depth, k, **kw)
        assert got.shape == want.shape == ((depth > 0).sum(), 6 if "img" in kw else 3)
        np.testing.assert_allclose(got, want, atol=1e-6)
    xy = np.array([[3.0, 4.0, 9.0], [10.5, 2.0, 8.0], [1.0, 1.0, 7.0]])
    z = np.array([[1.5], [-1.0], [2.0]])  # the point behind the camera drops
    np.testing.assert_allclose(tpcd.pcd_2d_to_pcd_3d(xy, z, k, c2w),
                               jpcd.pcd_2d_to_pcd_3d(xy, z, k, c2w), atol=1e-6)


class _Capture:
    def __init__(self, pinhole, pose):
        self.intrinsic_matrix = pinhole.intrinsic_matrix
        self.extrinsic_matrix = pose.extrinsic_matrix
        self.size = pinhole.shape


@pytest.mark.parametrize("render_type", ["pcd", "rgb", "bw", "depth"])
def test_project_point_cloud_at_capture_matches_jax(view, render_type):
    pinhole, pose, _, _, cloud = view
    cap = _Capture(pinhole, pose)
    got = tpcd.project_point_cloud_at_capture(cloud, cap, render_type)
    want = jpcd.project_point_cloud_at_capture(cloud, cap, render_type)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    if render_type == "pcd":
        assert got.shape[1] == 3 and len(got) > 50
    else:
        assert got.shape[:2] == pinhole.shape and (got != 0).any()
    with pytest.raises(ValueError):
        tpcd.project_point_cloud_at_capture(cloud[:, :3], cap, "rgb")


def test_pcd_2d_to_img_matches_jax(view):
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(-2, 40, (200, 2)), rng.uniform(0.5, 3, (200, 1)),
                          rng.uniform(0, 1, (200, 2))], 1)
    for kw in ({}, {"has_z": True}, {"has_z": True, "keep_z": True}):
        np.testing.assert_array_equal(tpcd.pcd_2d_to_img(pts, (24, 32), **kw),
                                      jpcd.pcd_2d_to_img(pts, (24, 32), **kw))
    np.testing.assert_array_equal(tpcd.pcd_2d_to_img(pts[:, :2], (24, 32)),
                                  jpcd.pcd_2d_to_img(pts[:, :2], (24, 32)))


def test_capture_mvp_mat_and_point_cloud_world_match_jax(synthetic_scene_dir, smpl_data_root):
    from neuman_tpu.data_io import neuman as jneuman
    from neuman_tpu_torch.data_io import neuman as tneuman

    jcaps = jneuman.NeuManReader.read_captures(synthetic_scene_dir, None)[0]
    tcaps = tneuman.NeuManReader.read_captures(synthetic_scene_dir, None)[0]
    for jcap, tcap in zip(jcaps[:3], tcaps[:3]):
        np.testing.assert_allclose(tcap.mvp_mat, jcap.mvp_mat, atol=1e-6)
        got, want = tcap.point_cloud_world(), jcap.point_cloud_world()
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)
