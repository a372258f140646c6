"""The telegathering's render (`render_hybrid_nerf_multi_persons`, the path
`render_gathering.run` takes) against the benchmark's plain reference
(benchmark/reference/gathering.py) on the CPU at a small size: three actors,
each with its own canonical net and betas, placed so that some rays pass
two of them and some pass none. Also: prebuilt topologies give the same
frame, `render_gathering.run` builds one topology, and the multi-person
spans and counters."""

import json
import math
import os
import types

import numpy as np
import pytest
import torch

from benchmark import cells, inputs
from benchmark.reference import gathering as gathering_ref
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import nerf as nerf_ref
from neuman_tpu_torch import render_gathering
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.render import renderer
from neuman_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FOCAL = 24, 40, 40.0
BKG_NEAR, BKG_FAR = 0.5, 6.0
GEO = 0.12
# the second actor stands partly behind the first, the third apart
OFFSETS = [(0.0, 0.0, 0.0), (0.3, -0.05, 0.8), (-1.2, 0.05, 0.4)]
CHUNK = 256


@pytest.fixture(scope="module")
def scene():
    with open(os.path.join(REPO, "benchmark", "configs", "neuman-gathering.json")) as f:
        config = json.load(f)
    config["config"].update(nerf_width=32, samples_per_ray=16, importance_samples_per_ray=16)
    cfg = config["config"]
    # the body proxy (642 vertices): the reference's hit test holds [rays, V] in f64
    body = tsmpl.body_proxy_smpl_model(subdivisions=3)
    faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.int64)
    num_verts = body.v_template.shape[0]
    pose = torch.zeros(1, 72)
    pose[0, 3:] = torch.randn(69, generator=torch.Generator().manual_seed(7)) * 0.1
    spec = hn.build_human_nerf_spec(cells.port_config(config, render=True))
    bkg = hn.HumanNeRF(spec).requires_grad_(False)
    actors, models = [], []
    for k, off in enumerate(OFFSETS):
        gen = torch.Generator().manual_seed(11 + k)
        w = inputs.weights(cfg, gen, inputs.NETS[:3])
        if k == 0:
            for net, mod in (("bkg_coarse", bkg.coarse_bkg_net), ("bkg_fine", bkg.fine_bkg_net)):
                mod.nerf.load_state_dict(w[net])
            bkg_w = w
        verts, ts = tsmpl.da_pose_to_scene(body, pose, torch.randn(1, 10, generator=gen))
        ts = ts[:num_verts].clone()
        off = torch.tensor(off)
        ts[:, :3, 3] += off
        actors.append({"can": w["can"], "verts": verts + off, "ts": ts, "faces": faces,
                       "inc": mesh_ref.incidence(faces, num_verts)})
        model = hn.HumanNeRF(spec).requires_grad_(False)
        model.coarse_human_net.nerf.load_state_dict(w["can"])
        models.append(model)
    k = inputs.intrinsics(FOCAL, H, W)
    c2w = inputs.look_at((0.2, 0.1, -3.0), (0.0, 0.0, 0.0))
    cap = types.SimpleNamespace(shape=(H, W), intrinsic_matrix=k,
                                cam_pose=types.SimpleNamespace(camera_to_world=c2w),
                                near={"bkg": BKG_NEAR}, far={"bkg": BKG_FAR})
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    o, d = nerf_ref.rays(xy, f32(k), f32(c2w))
    # how many actors each ray passes, and the rays whose hit test f32 cannot settle
    passes = sum((mesh_ref.near_far(o, d, a["verts"], GEO)[0] < math.inf).long() for a in actors)
    unsettled = torch.zeros(o.shape[0], dtype=torch.bool)
    for a in actors:
        unsettled |= mesh_ref.unsettled(o, d, a["verts"], GEO)
    return types.SimpleNamespace(cfg=cfg, spec=spec, bkg=bkg, bkg_w=bkg_w, actors=actors, models=models,
                                 cap=cap, o=o, d=d, faces=faces.numpy(), num_verts=num_verts,
                                 topo=mesh_ops.MeshTopology.build(faces.numpy(), num_verts),
                                 passes=passes, unsettled=unsettled)


def _render(s, dtype=torch.float32, topologies=True):
    n = len(s.actors)
    return renderer.render_hybrid_nerf_multi_persons(
        s.spec, s.bkg, s.cap, [s.spec] * n, s.models, [a["verts"] for a in s.actors], [s.faces] * n,
        [a["ts"] for a in s.actors], "cpu", rays_per_batch=CHUNK, samples_per_ray=s.cfg["samples_per_ray"],
        importance_samples_per_ray=s.cfg["importance_samples_per_ray"], geo_threshold=GEO,
        knn_stride=s.cfg["knn_stride"], compute_dtype=dtype,
        topologies=[s.topo] * n if topologies else None)[0].reshape(-1, 3)


@pytest.fixture(scope="module")
def frame(scene):
    return _render(scene)


@pytest.fixture(scope="module")
def reference(scene):
    return gathering_ref.gathering(scene.bkg_w, scene.actors, scene.o, scene.d, BKG_NEAR, BKG_FAR, GEO,
                                   scene.cfg)


@pytest.fixture(scope="module")
def frame_bf16(scene):
    return _render(scene, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_persons_matches_the_plain_reference(scene, frame, frame_bf16, reference, dtype):
    passes = scene.passes
    assert int((passes >= 2).sum()) > 0 and int((passes == 1).sum()) > 0 and int((passes == 0).sum()) > 0
    keep = ~scene.unsettled
    assert int(scene.unsettled.sum()) <= 8
    rgb = frame if dtype == "float32" else frame_bf16
    if dtype == "float32":
        # the same arithmetic in f32 on both sides, in another order (the
        # planar products, the hit test in f32 against f64, the placeholders'
        # ~1e8 last interval): the gaps are rounding, a few f32 ulps of 1
        assert float((rgb[keep] - reference[keep]).abs().max()) <= 1e-5
    else:
        mse = float(((rgb[keep] - reference[keep]) ** 2).mean())
        assert -10.0 * math.log10(max(mse, 1e-30)) >= 40.0


def test_prebuilt_topologies_give_the_same_frame(scene, frame):
    assert torch.equal(_render(scene, topologies=False), frame)


def test_counters_and_the_merge_span(scene):
    """The frame-level dispatch, counted exactly: one hit test and one host
    wait a frame; each actor's branch over the union's hit list in calls of
    CHUNK rows, and one merge a call."""
    tracing.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _render(scene)
        snap = tracing.snapshot()
    finally:
        tracing.reset()
    n = len(scene.actors)
    counters, spans = snap["counters"], snap["spans"]
    own = 0
    union = torch.zeros(scene.o.shape[0], dtype=torch.bool)
    for a in scene.actors:
        near, far = ray_ops.geometry_guided_near_far_plain(scene.o, scene.d, a["verts"], GEO)
        own += int((near < far).sum())
        union |= near < far
    hit_rays = int(union.sum())
    assert counters["render.hit_rays"] == hit_rays > CHUNK
    assert counters["render.branch_rays"] == n * hit_rays
    assert counters["render.actor_rays"] == own < counters["render.branch_rays"]
    assert spans["render.hit_test"]["calls"] == spans["render.hit_sync"]["calls"] == 1
    calls = math.ceil(hit_rays / CHUNK)
    assert spans["render.human_branch"]["calls"] == n * calls
    assert spans["render.merge"]["calls"] == calls


def test_render_gathering_builds_one_topology(scene, frame_bf16, monkeypatch):
    """`render_gathering.run` over a stub scene: two frames of three actors,
    one MeshTopology built."""
    frames = 2
    built, saved = [], []
    build = mesh_ops.MeshTopology.build.__func__

    def counted(cls, *a, **k):
        built.append(a[1] if len(a) > 1 else k["num_verts"])
        return build(cls, *a, **k)

    opt = cells.port_config({"config": dict(scene.cfg, rays_per_batch=CHUNK)}, render=True)
    opt.actors, opt.motion_name, opt.use_pallas = ["seattle", "citron", "parkinglot"], "dance_together", False
    stub = types.SimpleNamespace(faces=scene.faces, captures=[scene.cap])
    actors = {name: (scene.spec, m, a["verts"][None].expand(frames, -1, -1),
                     a["ts"][None].expand(frames, -1, -1, -1))
              for name, m, a in zip(opt.actors, scene.models, scene.actors)}
    monkeypatch.setattr(mesh_ops.MeshTopology, "build", classmethod(counted))
    monkeypatch.setattr(render_gathering.cli, "read_scene", lambda opt, smpl_type: stub)
    monkeypatch.setattr(render_gathering, "auto_geo_threshold", lambda sc: (GEO, GEO))
    monkeypatch.setattr(render_gathering, "read_actor", lambda opt, name, device: actors[name])
    monkeypatch.setattr(render_gathering, "read_novel_caps", lambda opt, n, sc: [sc.captures[0]] * n)
    monkeypatch.setattr(render_gathering.cli, "load_net", lambda opt, spec, device: scene.bkg)
    monkeypatch.setattr(render_gathering.cli, "save_frame",
                        lambda rgb, what, i: saved.append(rgb.reshape(-1, 3)) or f"{what}/{i}")
    assert render_gathering.run(opt, "cpu") == ["gathering/dance_together/0", "gathering/dance_together/1"]
    assert built == [scene.num_verts]
    assert torch.equal(saved[0], frame_bf16)
