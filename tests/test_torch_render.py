"""The port's ray ops, volume ops and renderers vs neuman_tpu."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.cameras.capture import ResizedPinholeCapture
from neuman_tpu.cameras.pinhole import PinholeCamera
from neuman_tpu.cameras.pose import CameraPose
from neuman_tpu.geometry.rotation import Rotation, Translation
from neuman_tpu.ops import fused as jfused
from neuman_tpu.ops import rays as jrays
from neuman_tpu.render import renderer as jrenderer
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.ops import rays as trays
from neuman_tpu_torch.ops import volume as tvolume
from neuman_tpu_torch.render import renderer as trenderer
from neuman_tpu_torch.utils import tracing
from tests.torch_parity import hybrid_pair, t

torch.set_num_threads(1)

S, I = 16, 16  # coarse / importance samples per ray


def _sorted_z(rng, r, s, lo=0.5, hi=4.0):
    return np.sort(rng.uniform(lo, hi, size=(r, s)), axis=-1).astype(np.float32)


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(0)
    bins = _sorted_z(rng, 12, 15)
    weights = rng.uniform(0, 1, size=(12, 14)).astype(np.float32)
    weights[:3, 4:] = 0.0  # mass concentrated: most u land in few bins
    ref = jrays.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, det=True)
    out = trays.sample_pdf(t(bins), t(weights), 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_importance_z_matches_jax():
    rng = np.random.default_rng(1)
    z = _sorted_z(rng, 8, S)
    w = rng.uniform(0, 1, size=(8, S)).astype(np.float32)
    ref = jfused.importance_z(jnp.asarray(z), jnp.asarray(w), I, det=True)
    out = tvolume.importance_z(t(z), t(w), I)
    assert torch.all(out[:, 1:] >= out[:, :-1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("white_bkg", [True, False])
def test_integrate_planar_matches_jax(white_bkg):
    rng = np.random.default_rng(2)
    z = _sorted_z(rng, 8, S)
    sigma = rng.normal(size=(8, S)).astype(np.float32) * 3
    rgb_c = [rng.normal(size=(8, S)).astype(np.float32) for _ in range(3)]
    dn = rng.uniform(0.8, 1.2, size=8).astype(np.float32)
    ref = jfused.integrate_planar(jnp.asarray(sigma), [jnp.asarray(c) for c in rgb_c],
                                  jnp.asarray(z), jnp.asarray(dn), white_bkg=white_bkg)
    out = tvolume.integrate_planar(t(sigma), [t(c) for c in rgb_c], t(z), t(dn), white_bkg)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_sort_merge_planar_matches_jax():
    rng = np.random.default_rng(3)
    za, zb = _sorted_z(rng, 6, S), _sorted_z(rng, 6, 8)
    zb[:, 2] = za[:, 5]  # ties: the first list wins
    zb.sort(axis=-1)
    sa, sb = rng.normal(size=(6, S)), rng.normal(size=(6, 8))
    ca = [rng.normal(size=(6, S)) for _ in range(3)]
    cb = [rng.normal(size=(6, 8)) for _ in range(3)]
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))
    rz, rs, rc = jfused.sort_merge_planar([j(za), j(zb)], [j(sa), j(sb)],
                                          [[j(c) for c in ca], [j(c) for c in cb]])
    oz, os_, oc = tvolume.sort_merge_planar([t(za), t(zb)], [t(sa), t(sb)],
                                            [[t(c) for c in ca], [t(c) for c in cb]])
    np.testing.assert_array_equal(oz.numpy(), np.asarray(rz))
    np.testing.assert_array_equal(os_.numpy(), np.asarray(rs))
    for a, b in zip(oc, rc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def scene():
    """Tiny HybridNeRF on both sides + a posed body-proxy mesh."""
    # a dense canonical body (alpha bias +2) so hit rays show the human
    jspec, params, tspec, model = hybrid_pair(seed=0, human_alpha_bias=2.0)
    body = tsmpl.body_proxy_smpl_model(subdivisions=2)
    pose = torch.zeros(1, 72)
    pose[0, 3:] = torch.tensor(np.random.default_rng(4).normal(size=69) * 0.05, dtype=torch.float32)
    verts, ts = tsmpl.da_pose_to_scene(body, pose, torch.zeros(1, 10))
    return jspec, params, tspec, model, body.faces, verts.numpy(), ts.numpy()


def _aimed_rays(verts, n=16, seed=5):
    """Rays from a camera point: even ones aimed at body vertices (hit),
    odd ones aimed well to the side (miss)."""
    rng = np.random.default_rng(seed)
    origin = np.array([0.1, 0.2, -2.5], np.float32)
    targets = verts[rng.integers(0, len(verts), n)].copy()
    targets[1::2, 0] += 1.5
    d = targets - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.tile(origin, (n, 1)).astype(np.float32), d.astype(np.float32)


def test_geometry_guided_near_far_matches_jax(scene):
    verts = scene[5]
    o, d = _aimed_rays(verts)
    jn, jf = jrays.geometry_guided_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), 0.2)
    tn, tf = trays.geometry_guided_near_far(t(o), t(d), t(verts), 0.2)
    hit = np.asarray(jn < jf)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal((tn < tf).numpy(), hit)
    np.testing.assert_allclose(tn.numpy()[hit], np.asarray(jn)[hit], atol=1e-5)
    np.testing.assert_allclose(tf.numpy()[hit], np.asarray(jf)[hit], atol=1e-5)
    # CPU tensors take the plain version (the kernel's twin on the card)
    pn, pf = trays.geometry_guided_near_far_plain(t(o), t(d), t(verts), 0.2)
    assert torch.equal(tn, pn) and torch.equal(tf, pf)


def _capture(h=24, w=16):
    cam = PinholeCamera(w, h, 16.0, 16.0, w / 2, h / 2)
    pose = CameraPose(Translation(np.array([0.0, 0.0, 2.5], np.float32)),
                      Rotation(np.array([1.0, 0, 0, 0])))
    cap = ResizedPinholeCapture(cam, pose, (h, w))
    cap.near = {"bkg": 0.5}
    cap.far = {"bkg": 6.0}
    return cap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_hybrid_nerf_matches_jax(scene, dtype):
    """The frame at the test_image_parity bar, in f32 and in bf16 (both
    sides round to bf16 at the same points)."""
    jspec, params, tspec, model, faces, verts, ts = scene
    cap = _capture()
    kw = dict(rays_per_batch=128, samples_per_ray=S, importance_samples_per_ray=I,
              geo_threshold=0.2, knn_k=4, knn_stride=4)
    ref_rgb, ref_depth, ref_acc = jrenderer.render_hybrid_nerf(
        jspec, params, cap, verts, faces, ts, return_acc=True, dispatch="compact",
        compute_dtype_name=dtype, use_pallas=False, **kw,
    )
    rgb, depth, acc = trenderer.render_hybrid_nerf(tspec, model, cap, verts, faces, ts,
                                                   device="cpu", compute_dtype=getattr(torch, dtype),
                                                   **kw)
    assert rgb.shape == (24, 16, 3)
    hit = ref_acc > 0
    assert 0.05 < hit.mean() < 0.95, hit.mean()
    mse = float(np.mean((rgb.numpy() - ref_rgb) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    assert psnr >= 40.0, psnr
    np.testing.assert_array_equal(acc.numpy() > 0, hit)
    if dtype == "float32":
        np.testing.assert_allclose(depth.numpy(), ref_depth, rtol=1e-3, atol=1e-3)


def _psnr(a, b):
    return -10.0 * np.log10(max(float(np.mean((np.asarray(a) - np.asarray(b)) ** 2)), 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("render_can", [False, True], ids=["posed", "canonical"])
def test_render_smpl_nerf_matches_jax(scene, dtype, render_can):
    """The human-only frame, posed (warp, per-sample directions) and in
    canonical space (no warp, per-ray directions, Ts=None), with a density
    scale, at the test_image_parity bar; misses are white with depth 0 and
    acc 0 on both sides."""
    jspec, params, tspec, model, faces, verts, ts = scene
    cap = _capture()
    kw = dict(rays_per_batch=128, samples_per_ray=S, geo_threshold=0.2, knn_k=4, knn_stride=4,
              render_can=render_can, interval_comp=1.3)
    Ts = None if render_can else ts
    ref_rgb, ref_depth, ref_acc = jrenderer.render_smpl_nerf(
        jspec, params, cap, verts, faces, Ts, return_depth=True, return_mask=True,
        compute_dtype_name=dtype, dispatch="compact", **kw)
    rgb, depth, acc = trenderer.render_smpl_nerf(
        tspec, model, cap, verts, faces, Ts, device="cpu", compute_dtype=getattr(torch, dtype), **kw)
    assert rgb.shape == (24, 16, 3) and depth.shape == acc.shape == (24, 16)
    assert _psnr(rgb, ref_rgb) >= 40.0
    hit = ref_acc > 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(acc.numpy() > 0, hit)
    assert (rgb.numpy()[~hit] == 1.0).all() and (depth.numpy()[~hit] == 0.0).all()
    tol = 1e-3 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(acc.numpy(), ref_acc, atol=tol)
    np.testing.assert_allclose(depth.numpy(), ref_depth, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_multi_persons_matches_jax(scene, dtype):
    """Two actors (the body, and a copy 0.6 to the side) composited into the
    scene at the test_image_parity bar; rays outside every actor equal the
    background-only render."""
    jspec, params, tspec, model, faces, verts, ts = scene
    cap = _capture()
    shift = np.array([0.6, 0.0, 0.0], np.float32)
    ts2 = ts.copy()
    ts2[:, :3, 3] += shift
    kw = dict(rays_per_batch=128, samples_per_ray=S, importance_samples_per_ray=I,
              geo_threshold=0.2, knn_k=4, knn_stride=4)
    ref_rgb, ref_depth = jrenderer.render_hybrid_nerf_multi_persons(
        jspec, params, cap, [jspec, jspec], [params, params], [verts, verts + shift],
        [faces, faces], [ts, ts2], return_depth=True, compute_dtype_name=dtype,
        dispatch="compact", **kw)
    cd = getattr(torch, dtype)
    rgb, depth = trenderer.render_hybrid_nerf_multi_persons(
        tspec, model, cap, [tspec, tspec], [model, model], [verts, verts + shift],
        [faces, faces], [ts, ts2], device="cpu", compute_dtype=cd, **kw)
    assert rgb.shape == (24, 16, 3) and depth.shape == (24, 16)
    assert _psnr(rgb, ref_rgb) >= 40.0
    if dtype == "float32":
        np.testing.assert_allclose(depth.numpy(), ref_depth, rtol=1e-3, atol=1e-3)
    bkg = trenderer.render_vanilla(
        tspec.bkg, model.coarse_bkg_net.nerf, cap, model.fine_bkg_net.nerf, "cpu",
        rays_per_batch=128, samples_per_ray=S, importance_samples_per_ray=I, compute_dtype=cd)
    o, d = trenderer.cap_rays(cap, "cpu")
    miss = torch.ones(o.shape[0], dtype=torch.bool)
    for v in (verts, verts + shift):
        near, far = trays.geometry_guided_near_far(o, d, t(v), 0.2)
        miss &= ~(near < far)
    assert 0.05 < miss.float().mean() < 0.95
    assert torch.equal(rgb.reshape(-1, 3)[miss], bkg.reshape(-1, 3)[miss])
    # one actor alone is the hybrid frame of that actor
    one, _ = trenderer.render_hybrid_nerf_multi_persons(
        tspec, model, cap, [tspec], [model], [verts], [faces], [ts], device="cpu",
        compute_dtype=cd, **kw)
    hybrid = trenderer.render_hybrid_nerf(tspec, model, cap, verts, faces, ts, device="cpu",
                                          compute_dtype=cd, **kw)[0]
    assert _psnr(one, hybrid) >= 40.0


# rays_per_batch, and how far every actor stands to the side of its place
HIT_LIST_FRAMES = {
    "several_calls": (24, 0.0),  # the hit list spans several branch calls
    "chunk_gap": (4, 0.0),  # chunks with no hit between chunks with hits
    "no_hit": (128, 10.0),  # the actors out of the frame
}


def _traced(render):
    tracing.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = render()
        return out, tracing.snapshot()
    finally:
        tracing.reset()


@pytest.mark.parametrize("renderer", ["hybrid", "two_actors", "smpl"])
@pytest.mark.parametrize("frame", list(HIT_LIST_FRAMES))
def test_frame_hit_list_dispatch(scene, frame, renderer):
    """The renderers' frame-level hit list (`render_hybrid_nerf` for one
    actor, `render_hybrid_nerf_multi_persons` for two, the second 0.6 to
    the side, and the posed `render_smpl_nerf`) at the JAX frame's bars in
    f32, on a frame whose hit list spans several branch calls, one with
    chunks without hits between chunks with hits, and one with no hit;
    traced: one hit test and one host wait a frame, each actor's branch
    over its own hits in calls of rays_per_batch rows."""
    jspec, params, tspec, model, faces, verts, ts = scene
    rays_per_batch, away = HIT_LIST_FRAMES[frame]
    actors = 2 if renderer == "two_actors" else 1
    cap = _capture()
    vs, tss = [], []
    for k in range(actors):
        shift = np.array([0.6 * k + away, 0.0, 0.0], np.float32)
        ts_k = ts.copy()
        ts_k[:, :3, 3] += shift
        vs.append(verts + shift)
        tss.append(ts_k)
    o, d = trenderer.cap_rays(cap, "cpu")
    union = torch.zeros(o.shape[0], dtype=torch.bool)
    own = []
    for v in vs:
        near, far = trays.geometry_guided_near_far(o, d, t(v), 0.2)
        union |= near < far
        own.append(int((near < far).sum()))
    hits = int(union.sum())
    chunk_hit = [bool(c.any()) for c in union.split(rays_per_batch)]
    gaps = [i for i in range(1, len(chunk_hit) - 1)
            if not chunk_hit[i] and any(chunk_hit[:i]) and any(chunk_hit[i + 1:])]
    assert {"several_calls": hits > 2 * rays_per_batch, "chunk_gap": len(gaps) > 0,
            "no_hit": hits == 0}[frame]
    kw = dict(samples_per_ray=S, geo_threshold=0.2, knn_k=4, knn_stride=4)
    if renderer == "smpl":
        ref_rgb, ref_depth, ref_acc = jrenderer.render_smpl_nerf(
            jspec, params, cap, vs[0], faces, tss[0], return_depth=True, return_mask=True,
            compute_dtype_name="float32", dispatch="compact", rays_per_batch=128, **kw)
        (rgb, depth, acc), snap = _traced(lambda: trenderer.render_smpl_nerf(
            tspec, model, cap, vs[0], faces, tss[0], device="cpu", compute_dtype=torch.float32,
            rays_per_batch=rays_per_batch, **kw))
        hit = ref_acc > 0
        np.testing.assert_array_equal(acc.numpy() > 0, hit)
        assert (rgb.numpy()[~hit] == 1.0).all() and (depth.numpy()[~hit] == 0.0).all()
        np.testing.assert_allclose(acc.numpy(), ref_acc, atol=1e-3)
    elif actors == 1:
        ref_rgb, ref_depth, ref_acc = jrenderer.render_hybrid_nerf(
            jspec, params, cap, vs[0], faces, tss[0], return_acc=True, dispatch="compact",
            compute_dtype_name="float32", use_pallas=False, rays_per_batch=128,
            importance_samples_per_ray=I, **kw)
        (rgb, depth, acc), snap = _traced(lambda: trenderer.render_hybrid_nerf(
            tspec, model, cap, vs[0], faces, tss[0], device="cpu", compute_dtype=torch.float32,
            rays_per_batch=rays_per_batch, importance_samples_per_ray=I, **kw))
        np.testing.assert_array_equal(acc.numpy() > 0, ref_acc > 0)
    else:
        ref_rgb, ref_depth = jrenderer.render_hybrid_nerf_multi_persons(
            jspec, params, cap, [jspec] * actors, [params] * actors, vs, [faces] * actors, tss,
            return_depth=True, compute_dtype_name="float32", dispatch="compact",
            rays_per_batch=128, importance_samples_per_ray=I, **kw)
        (rgb, depth), snap = _traced(lambda: trenderer.render_hybrid_nerf_multi_persons(
            tspec, model, cap, [tspec] * actors, [model] * actors, vs, [faces] * actors, tss,
            device="cpu", compute_dtype=torch.float32, rays_per_batch=rays_per_batch,
            importance_samples_per_ray=I, **kw))
    assert _psnr(rgb, ref_rgb) >= 40.0
    np.testing.assert_allclose(depth.numpy(), ref_depth, rtol=1e-3, atol=1e-3)
    calls = lambda name: snap["spans"].get(name, {}).get("calls", 0)
    counters = snap["counters"]
    assert counters["render.hit_rays"] == hits
    assert calls("render.hit_test") == calls("render.hit_sync") == 1
    assert calls("render.human_branch") == sum(math.ceil(n / rays_per_batch) for n in own)
    if renderer != "smpl":  # the hybrid frame's counter
        assert counters.get("render.branch_rays", 0) == sum(own)
