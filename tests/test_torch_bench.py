"""The port's benchmark (`python -m neuman_tpu_torch.bench`) on the CPU, at
tiny widths (`--device cpu`, one timed call a section): its JSON line
against root bench.py's keys, the stage runner's fault paths, and each
section's workload against what bench.py builds through the JAX package.
On the CPU the kernel wrappers run their plain versions, so "kernels" reads
"off"; the times are the CPU's and are not checked."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuman_tpu.cameras.capture import ResizedPinholeCapture as JCapture
from neuman_tpu.cameras.pinhole import PinholeCamera as JPinhole
from neuman_tpu.cameras.pose import CameraPose as JPose
from neuman_tpu.geometry.rotation import Rotation as JRotation, Translation as JTranslation
from neuman_tpu.models import human_nerf as jhn
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.ops import rays as jrays
from neuman_tpu.ops import volume as jvolume
from neuman_tpu.options.config import NeuManConfig as JConfig
from neuman_tpu.options.config import apply_mode_defaults as japply
from neuman_tpu.parallel.dryrun import synthetic_arrays as jsynthetic_arrays
from neuman_tpu.render import renderer as jrenderer
from neuman_tpu.utils.synthetic_body import body_proxy_smpl_model as jbody_proxy
from neuman_tpu_torch import bench
from neuman_tpu_torch import convert
from neuman_tpu_torch.models import nerf as tnerf
from tests.torch_parity import t

torch.set_num_threads(1)

CPU = torch.device("cpu")
# root bench.py's JSON line (bench.py:243-321), "pallas" read as "kernels"
BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline", "protocol", "human_train_step_ms",
                 "bkg_train_step_ms", "hybrid_render_ms", "hybrid_sec_per_frame",
                 "hybrid_frame_hit_frac", "kernels")
WIDTHS = {"nerf_depth": 2, "nerf_width": 32}
TINY_ARGV = ["--device", "cpu", "--iters", "1", "--train_iters", "1", "--rays", "16",
             "--samples", "8", "--importance", "8"]
TINY_SIZES = {
    "render": {"overrides": WIDTHS},
    # the LPIPS patch needs more than 1024 rays
    "human_step": {"overrides": {**WIDTHS, "rays_per_batch": 1056, "samples_per_ray": 4,
                                 "dilation": 0},
                   "views": 2, "hw": (36, 48), "body_subdivisions": 0},
    "bkg_step": {"overrides": {**WIDTHS, "rays_per_batch": 32, "samples_per_ray": 8,
                               "importance_samples_per_ray": 8}, "views": 2, "hw": (36, 48)},
    "hybrid_render": {"rays": 16, "samples": 8, "importance": 8, "overrides": WIDTHS,
                      "body_subdivisions": 1},
    "hybrid_frame": {"h": 18, "w": 32, "focal": 20.0, "rays_per_batch": 256, "samples": 8,
                     "importance": 8, "frames": 1, "overrides": WIDTHS, "body_subdivisions": 1},
}
SECTIONS = {"render": "bench_render", "human_step": "bench_human_train_step",
            "bkg_step": "bench_bkg_train_step", "hybrid_render": "bench_hybrid_render",
            "hybrid_frame": "bench_hybrid_frame"}


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny_run():
    """(result, exit code, printed lines) of one tiny bench run."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result, rc, _ = bench.run(TINY_ARGV, sizes=TINY_SIZES)
    return result, rc, buf.getvalue().splitlines()


def test_json_line_has_bench_py_keys(tiny_run):
    result, rc, lines = tiny_run
    assert rc == 0
    assert lines[0] == "device: cpu"
    assert json.loads(lines[-1]) == result
    assert tuple(result) == BENCH_PY_KEYS
    assert result["metric"] == "ray_samples_per_sec_per_chip"
    assert result["unit"] == "ray-samples/s"
    assert result["protocol"] == "wall_clock"
    assert result["kernels"] == "off"  # the CPU runs the plain versions
    assert result["vs_baseline"] == result["value"] / 1e7
    for k in BENCH_PY_KEYS[5:-1]:
        assert np.isfinite(result[k]) and result[k] > 0, k
    assert 0 < result["hybrid_frame_hit_frac"] < 1


@pytest.fixture
def fast_sections(monkeypatch):
    """Each section replaced by one that returns fixed numbers: the stage
    runner alone is under test."""
    for name in SECTIONS.values():
        out = (2.0, 0.25) if name == "bench_hybrid_frame" else 1.5
        monkeypatch.setattr(bench, name, lambda *a, out=out, **k: out)


@pytest.mark.parametrize("stage", list(SECTIONS))
def test_break_stage_nulls_its_keys(stage, fast_sections, capsys):
    result, rc, _ = bench.run(["--device", "cpu", "--break-stage", stage])
    assert rc == 1
    assert _json_line(capsys) == result
    assert result["kernels"] == f"failed:{stage}:RuntimeError"
    for name, keys in bench.STAGE_KEYS.items():
        for k in keys:
            if name == stage:
                assert result[k] is None, k
            else:
                assert isinstance(result[k], float), k


def test_unhandled_error_prints_one_line(monkeypatch, capsys):
    def broken(device):
        raise ValueError("card query broke")

    monkeypatch.setattr(bench, "card_line", broken)
    result, rc, _ = bench.run(["--device", "cpu"])
    line = _json_line(capsys)
    assert rc == 1 and line == result
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["error"].startswith("unhandled:ValueError: card query broke")


def test_no_cuda_device_exits_without_running(monkeypatch, fast_sections, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result, rc, launches = bench.run([])
    assert rc == 1 and launches == {}
    assert _json_line(capsys)["error"].startswith("no CUDA device")
    assert "kernels" not in result


@pytest.mark.parametrize("floor,rc", [(1e-7, 0), (1e9, 1)])
def test_assert_floor(floor, rc, fast_sections, capsys):
    result, code, _ = bench.run(["--device", "cpu", "--assert-floor", str(floor)])
    assert result["vs_baseline"] == 1.5 / 1e7
    assert code == rc


def test_human_workload_matches_bench_py():
    """The human section's inputs equal those bench.py:431-476 builds
    through the JAX package, at 4 views of 36x48 on the subdivision-1 proxy."""
    views, hw = 4, (36, 48)
    s = bench.human_setup(CPU, views=views, hw=hw, body_subdivisions=1)
    jbody = jbody_proxy(subdivisions=1)
    jcfg = japply(JConfig(), "smpl_and_offset")
    jcfg.geo_threshold = 0.25
    arrays = jsynthetic_arrays(num_views=views, h=hw[0], w=hw[1], num_verts=jbody.num_verts)
    proxy = jnp.asarray(jbody.v_template)
    arrays = arrays.replace(verts=jnp.tile(proxy[None], (views, 1, 1)) + arrays.verts * 0.02)
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(views, 72)).astype(np.float32) * 0.05
    betas = rng.normal(size=(views, 10)).astype(np.float32) * 0.05

    jfields = [f.name for f in dataclasses.fields(arrays)]
    assert jfields == [f.name for f in dataclasses.fields(s.arrays)]
    for name in jfields:
        np.testing.assert_array_equal(getattr(s.arrays, name).numpy(),
                                      np.asarray(getattr(arrays, name)), err_msg=name)
    np.testing.assert_array_equal(s.body.v_template.numpy(), np.asarray(jbody.v_template))
    np.testing.assert_array_equal(np.asarray(s.body.faces), np.asarray(jbody.faces))
    np.testing.assert_array_equal(s.model.poses.detach().numpy(), poses)
    np.testing.assert_array_equal(s.model.betas.numpy(), betas)
    np.testing.assert_array_equal(s.model.alignments.numpy(), np.tile(np.eye(4), (views, 1, 1)))
    for f in dataclasses.fields(jcfg):
        assert getattr(s.cfg, f.name) == getattr(jcfg, f.name), f.name
    ctx = s.ctx
    assert (ctx["scale"], ctx["interval_comp"], ctx["knn_k"], ctx["can_hw"]) == (1.0, 1.0, 4, hw)
    assert ctx["knn_stride"] == jcfg.knn_stride
    np.testing.assert_array_equal(ctx["da_smpl"].numpy(), np.asarray(jhn.da_pose_params(24)))
    np.testing.assert_array_equal(ctx["can_verts"].numpy(), np.asarray(arrays.verts))
    np.testing.assert_array_equal(ctx["can_k"].numpy(), np.asarray(arrays.intrinsics[:2]))
    np.testing.assert_array_equal(ctx["can_c2w"].numpy(), np.asarray(arrays.c2w[:2]))
    np.testing.assert_array_equal(ctx["scene_ids"].numpy(), np.arange(views))
    np.testing.assert_array_equal(ctx["grad_masks"].numpy(), np.ones((views, 72)))
    assert ctx["lpips_params"] is not None and jcfg.penalize_lpips == 0.01


def test_render_chunk_matches_bench_py_reference_chunk():
    """One render chunk with the JAX weights carried across equals bench.py's
    reference-shaped chunk (bench.py:183-198) in f32, within the hybrid
    chunk's port-vs-JAX bar of tests/test_torch_render.py."""
    r, s, i = 16, 16, 16
    jcfg = JConfig(pe_recurrence=False, **WIDTHS)
    spec = jnerf.build_nerf_specs(jcfg)
    key = jax.random.PRNGKey(0)
    nets = [jnerf.init_nerf_params(key, spec.nerf),
            jnerf.init_nerf_params(jax.random.fold_in(key, 1), spec.nerf)]
    rng = np.random.default_rng(2)
    d = rng.normal(size=(r, 3)).astype(np.float32) * 0.1 + np.array([0, 0, 1], np.float32)
    dirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    origins = np.zeros((r, 3), np.float32)
    origins[:, 2] = -2.0
    near, far = np.full((r, 1), 0.5, np.float32), np.full((r, 1), 4.0, np.float32)

    @jax.jit
    def reference_chunk(coarse, fine, o, dj, near, far):
        pts, sdirs, z = jrays.ray_to_samples(o, dj, near, far, s)
        out = jnerf.apply_joiner(spec, coarse, pts, sdirs, compute_dtype=jnp.float32)
        _, _, _, w, _ = jvolume.raw2outputs(out, z, sdirs[:, 0, :])
        f_pts, f_dirs, f_z = jrays.ray_to_importance_samples(o, dj, z, w, i, det=True)
        f_out = jnerf.apply_joiner(spec, fine, f_pts, f_dirs, compute_dtype=jnp.float32)
        f_rgb, _, _, _, f_depth = jvolume.raw2outputs(f_out, f_z, f_dirs[:, 0, :])
        return f_rgb, f_depth

    ref_rgb, ref_depth = reference_chunk(*nets, origins, dirs, near, far)

    tspec = tnerf.build_nerf_specs(bench._config(overrides=WIDTHS))
    joiners = []
    for params in nets:
        joiner = tnerf.Joiner(tspec)
        joiner.load_state_dict(convert.joiner_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                                params)))
        joiners.append(joiner.nerf)
    with torch.no_grad():
        rgb, depth = bench.render_chunk(tspec, *joiners, t(origins), t(dirs), t(near), t(far), s,
                                        i, torch.float32)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), atol=1e-4)


def test_frame_hit_fraction_matches_jax():
    """The frame camera at 64x36 (f = 40: bench.py's 800 at 1280 wide per
    pixel) on the subdivision-5 proxy: the rays within geo_threshold of a
    vertex agree with JAX `_hit_frame`'s to one pixel."""
    h, w, focal, chunk = 36, 64, 40.0, 1024
    verts = np.array(jbody_proxy(subdivisions=5).v_template, np.float32)
    cap = JCapture(JPinhole(w, h, focal, focal, w / 2, h / 2),
                   JPose(JTranslation(np.array([0, 0, 3.5], dtype=np.float32)),
                         JRotation(np.array([1.0, 0, 0, 0]))), (h, w))
    origins, dirs = jrenderer._cap_rays(cap)
    o_st, d_st = jrenderer._stack_chunks([origins, dirs], h * w, chunk)
    hit = jrenderer._unstack(jrenderer._hit_frame(o_st, d_st, jnp.asarray(verts),
                                                  jnp.float32(0.25)), h * w)
    frac = bench.frame_hit_fraction(bench.frame_capture(h, w, focal), verts, 0.25, chunk, CPU)
    assert 0.05 < hit.mean() < 0.5
    assert abs(frac * h * w - hit.sum()) <= 1
