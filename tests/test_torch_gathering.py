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
from neuman_tpu_torch.ops import volume
from neuman_tpu_torch.parallel.mesh import ChunkRows
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


def _traced(render):
    tracing.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = render()
        return out, tracing.snapshot()
    finally:
        tracing.reset()


def _own_hits(s, verts_list):
    """Each actor's hit rays and their union, by the plain hit test."""
    hits = [ray_ops.geometry_guided_near_far_plain(s.o, s.d, v, GEO) for v in verts_list]
    hits = [near < far for near, far in hits]
    union = torch.zeros(s.o.shape[0], dtype=torch.bool)
    for h in hits:
        union |= h
    return [int(h.sum()) for h in hits], int(union.sum())


def test_counters_and_the_merge_span(scene):
    """The frame-level dispatch, counted exactly: one hit test and one host
    wait a frame; each actor's branch over its own hits in calls of CHUNK
    rows, all of them rows it hits; one merge a CHUNK of the union's list."""
    _, snap = _traced(lambda: _render(scene))
    counters, spans = snap["counters"], snap["spans"]
    own, hit_rays = _own_hits(scene, [a["verts"] for a in scene.actors])
    assert counters["render.hit_rays"] == hit_rays > CHUNK
    assert counters["render.branch_rays"] == sum(own) == counters["render.actor_rays"]
    assert sum(own) > hit_rays  # some rays pass two actors
    assert spans["render.hit_test"]["calls"] == spans["render.hit_sync"]["calls"] == 1
    assert spans["render.human_branch"]["calls"] == sum(math.ceil(n / CHUNK) for n in own)
    assert spans["render.merge"]["calls"] == math.ceil(hit_rays / CHUNK)


def union_dispatch(bkg_spec, bkg_model, cap, actors, device, rays_per_batch, samples, importance,
                   geo, knn_stride, dtype, use_kernels):
    """rgb [H*W, 3] of the frame as the union dispatch renders it: every
    actor's branch (`actors`: `renderer._actor`s) over every row of the
    union's hit list, chunk by chunk, then its samples on the rows it misses
    replaced by placeholders (z = linspace(1, 2) x 1e8, sigma -1e9), merged
    with the background's. The arguments as `_hybrid_frame`'s, k = 4."""
    origins, dirs = renderer.cap_rays(cap, device)
    rows = ChunkRows(origins.shape[0], rays_per_batch, None, device)
    _, bounds_h = renderer._frame_hit_test(origins, dirs, [a[3] for a in actors], rows, geo,
                                           use_kernels)
    hit_h = [near < far for near, far in bounds_h]
    hits, bounds, _ = renderer._hit_list(hit_h, rows)
    rgb, _, kept = renderer._bkg_frame(
        bkg_spec.bkg, bkg_model.coarse_bkg_net.nerf, bkg_model.fine_bkg_net.nerf, cap, origins, dirs,
        rows, (hits, bounds), samples, importance, True, dtype, use_kernels)
    dummy_z = torch.linspace(1.0, 2.0, samples, device=device)[None] * 1e8
    for first in range(0, hits.numel(), rays_per_batch):
        at = slice(first, first + rays_per_batch)
        sel = hits[at]
        f_z, f_sigma, f_rgb_c, dir_norm = renderer._rows(kept, at)
        zs, sigmas, rgbs = [f_z], [f_sigma], [f_rgb_c]
        for (spec_h, net_h, topo_h, verts_h, ts_h), (near, far), hit in zip(actors, bounds_h, hit_h):
            h_z, h_sigma, h_rgb_c = renderer._human_branch(
                spec_h, net_h, topo_h, origins[sel], dirs[sel], near[sel], far[sel], verts_h, ts_h,
                samples, 4, dtype, knn_stride, use_kernels)
            zs.append(torch.where(hit[sel, None], h_z, dummy_z))
            sigmas.append(torch.where(hit[sel, None], h_sigma, -1e9))
            rgbs.append(h_rgb_c)
        z, sigma, rgb_c = volume.sort_merge_planar(zs, sigmas, rgbs)
        rgb[sel] = volume.integrate_planar(sigma, rgb_c, z, dir_norm, True)[0]
    return rgb


# which actors of the scene, and how far the second of them is moved aside
DISPATCH_FRAMES = {
    "three": ((0, 1, 2), 0.0),  # rays that pass none, one and two actors
    "one_out_of_view": ((0, 1, 2), 50.0),  # an actor without hits: no branch call
    "one_alone": ((0,), 0.0),  # its hits are the union's: render_hybrid_nerf's path
}


@pytest.mark.parametrize("frame", list(DISPATCH_FRAMES))
def test_own_hits_dispatch_equals_the_union_dispatch(scene, frame):
    """Each actor's branch over its own hits gives the frame that the union
    dispatch gives, in f32 on the plain path; the branch calls are each
    actor's own hits in CHUNK rows, none for an actor out of view, and one
    actor alone runs as `render_hybrid_nerf` does."""
    picked, away = DISPATCH_FRAMES[frame]
    actors = []
    for i, k in enumerate(picked):
        a, shift = scene.actors[k], torch.tensor([away if i == 1 else 0.0, 0.0, 0.0])
        ts = a["ts"].clone()
        ts[:, :3, 3] += shift
        actors.append((scene.models[k], a["verts"] + shift, ts))
    n = len(actors)
    kw = dict(rays_per_batch=CHUNK, samples_per_ray=scene.cfg["samples_per_ray"],
              importance_samples_per_ray=scene.cfg["importance_samples_per_ray"], geo_threshold=GEO,
              knn_stride=scene.cfg["knn_stride"], compute_dtype=torch.float32, use_kernels=False)
    (rgb, depth), snap = _traced(lambda: renderer.render_hybrid_nerf_multi_persons(
        scene.spec, scene.bkg, scene.cap, [scene.spec] * n, [m for m, _, _ in actors],
        [v for _, v, _ in actors], [scene.faces] * n, [ts for _, _, ts in actors], "cpu",
        topologies=[scene.topo] * n, **kw))
    own, hit_rays = _own_hits(scene, [v for _, v, _ in actors])
    assert {"three": sum(own) > hit_rays > max(own), "one_out_of_view": 0 in own and hit_rays > 0,
            "one_alone": n == 1}[frame]
    calls = snap["spans"]["render.human_branch"]["calls"]
    assert calls == sum(math.ceil(k / CHUNK) for k in own)
    assert snap["counters"]["render.branch_rays"] == sum(own)
    # each row's values are computed row by row on both sides (the plain
    # nets' GEMMs over fewer rows round alike on the CPU), the placeholders
    # are the same, and a placeholder's colour has weight 0 exactly
    union = union_dispatch(
        scene.spec, scene.bkg, scene.cap,
        [renderer._actor(scene.spec, m, v, scene.faces, ts, scene.topo, "cpu") for m, v, ts in actors],
        "cpu", CHUNK, kw["samples_per_ray"], kw["importance_samples_per_ray"], GEO, kw["knn_stride"],
        torch.float32, False)
    assert torch.equal(rgb.reshape(-1, 3), union)
    if frame == "one_alone":
        model, verts, ts = actors[0]
        one = types.SimpleNamespace(coarse_bkg_net=scene.bkg.coarse_bkg_net,
                                    fine_bkg_net=scene.bkg.fine_bkg_net,
                                    coarse_human_net=model.coarse_human_net)
        (rgb1, depth1, _), snap1 = _traced(lambda: renderer.render_hybrid_nerf(
            scene.spec, one, scene.cap, verts, scene.faces, ts, "cpu", topology=scene.topo, **kw))
        assert torch.equal(rgb1, rgb) and torch.equal(depth1, depth)
        assert snap1["spans"]["render.human_branch"]["calls"] == calls
        assert snap1["counters"]["render.branch_rays"] == snap["counters"]["render.branch_rays"]


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
