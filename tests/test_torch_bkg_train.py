"""The port's background train step (stage 1) vs neuman_tpu's, on the CPU.

Tiny configuration (depth 2, width 32, PE 4 + 2 bands, 8 + 8 samples, 64
rays; as tests/test_trainers.py) on a duck-typed in-memory scene. The JAX
step draws its batch from its own key split; the port's step is fed that
batch, so the two steps see the same rays. On the CPU the port's MLPs run
the kernels' plain versions.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.datasets import arrays as jarrays
from neuman_tpu.datasets import sampler as jsampler
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.options.config import NeuManConfig as JaxConfig
from neuman_tpu.options.config import apply_mode_defaults as jax_mode_defaults
from neuman_tpu.render import renderer as jrenderer
from neuman_tpu.trainers import background as jbkg
from neuman_tpu.trainers import checkpoint as jckpt
from neuman_tpu_torch import convert
from neuman_tpu_torch import train as ttrain
from neuman_tpu_torch.datasets import arrays as tarrays
from neuman_tpu_torch.datasets import sampler as tsampler
from neuman_tpu_torch.models import nerf as tnerf
from neuman_tpu_torch.ops.kernels.nerf_mlp import nerf_mlp_plain
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn
from neuman_tpu_torch.options.config import NeuManConfig as TorchConfig
from neuman_tpu_torch.options.config import apply_mode_defaults as torch_mode_defaults
from neuman_tpu_torch.render import renderer as trenderer
from neuman_tpu_torch.trainers import background as tbkg
from tests.torch_parity import to_numpy

torch.set_num_threads(1)

TINY = dict(nerf_depth=2, nerf_width=32, pos_N_freqs=4, pos_max_freq=3, dir_N_freqs=2,
            dir_max_freq=1, samples_per_ray=8, importance_samples_per_ray=8, rays_per_batch=64,
            max_iter=3, valid_iter=100, name="test")
H, W, VIEWS = 12, 16, 4
TOL = 1e-5


def _configs(tmp_path, use_pallas=False, **overrides):
    fields = {**TINY, "out_dir": str(tmp_path), **overrides}
    jcfg = jax_mode_defaults(JaxConfig(), "bkg")
    tcfg = torch_mode_defaults(TorchConfig(), "bkg")
    for k, v in fields.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jcfg.use_pallas, jcfg.pe_recurrence = use_pallas, False
    return jcfg.finalize(), tcfg.finalize()


class _Pose:
    def __init__(self, c2w):
        self.camera_to_world = c2w


class _Capture:
    """The attributes both packages' scene staging and renderers read."""

    def __init__(self, rng, i):
        self.shape = (H, W)
        self.image = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
        self.mask = np.zeros((H, W), np.uint8)
        self.mask[H // 3: 2 * H // 3, W // 3: 2 * W // 3] = 1
        self.border_mask = np.zeros((H, W), np.uint8)
        self.border_mask[H // 3 - 1: 2 * H // 3 + 1, W // 3 - 1: 2 * W // 3 + 1] = 1
        self.depth_map = rng.uniform(1, 3, (H, W)).astype(np.float32)
        self.fused_depth_map = rng.uniform(1, 3, (H, W)).astype(np.float32)
        self.intrinsic_matrix = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]],
                                         np.float32)
        c2w = np.eye(4, dtype=np.float32)  # rotation identity: the camera looks along +z
        c2w[:3, 3] = [0.1 * i, -0.05 * i, -2.5]
        self.cam_pose = _Pose(c2w)
        self.near = {"bkg": 0.5, "human": 1.5}
        self.far = {"bkg": 4.0, "human": 3.5}
        self.frame_id = {"frame_id": i, "total_frames": VIEWS}


class _Scene:
    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.captures = [_Capture(rng, i) for i in range(VIEWS)]
        self.verts = [rng.normal(size=(32, 3)).astype(np.float32) * 0.3 for _ in range(VIEWS)]


def _staged(scene, views=(0, 1, 2)):
    j = jarrays.build_scene_arrays(scene, list(views), use_fused_depth=True)
    t = tarrays.build_scene_arrays(scene, list(views), use_fused_depth=True, device="cpu")
    return j, t


def _nets(jspec, tspec, seed=0):
    """JAX param trees of both nets and the port's Joiners with equal weights."""
    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    jparams = {"coarse": jnerf.init_nerf_params(kc, jspec.nerf),
               "fine": jnerf.init_nerf_params(kf, jspec.nerf)}
    tparams = {}
    for k, p in jparams.items():
        tparams[k] = tnerf.Joiner(tspec)
        tparams[k].load_state_dict(convert.joiner_state_dict(to_numpy(p)))
    return jparams, tparams


def _torch_batch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _close(got, want, what, tol=TOL):
    fg, tg = jax.tree_util.tree_flatten(got)
    fw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw, what
    for i, (a, b) in enumerate(zip(fg, fw)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=f"{what} leaf {i}")


def _port_tree(named):
    """{net: {name: tensor}} (params or an Adam moment) -> the JAX tree."""
    return {k: convert.to_jax_params(v) for k, v in named.items()}


ARRAY_FIELDS = ("images", "masks", "depths", "fused_depths", "intrinsics", "c2w", "near_bkg",
                "far_bkg", "near_human", "far_human", "viewf", "perm", "body_count",
                "border_count", "verts")


def test_build_scene_arrays_matches_jax():
    j, t = _staged(_Scene())
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_synthetic_arrays_match_jax():
    from neuman_tpu.parallel.dryrun import synthetic_arrays

    j = synthetic_arrays(num_views=3, h=H, w=W, num_verts=20, seed=5)
    t = tarrays.synthetic_arrays(num_views=3, h=H, w=W, num_verts=20, seed=5, device="cpu")
    for name in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-7, err_msg=name)


def test_arrays_scene_stages_back_to_its_arrays():
    """ArraysScene (the scene the card run trains on) is build_scene_arrays'
    inverse: staging it again gives the same arrays, bit for bit."""
    a = tarrays.synthetic_arrays(num_views=3, h=H, w=W, num_verts=20, seed=5, device="cpu")
    b = tarrays.build_scene_arrays(tarrays.ArraysScene(a), device="cpu")
    for name in ARRAY_FIELDS:
        assert torch.equal(getattr(b, name), getattr(a, name)), name


def test_rays_from_pixels_matches_jax():
    j, t = _staged(_Scene())
    rng = np.random.default_rng(1)
    vids = rng.integers(0, 3, 200)
    pix = rng.integers(0, H * W, 200)
    want = jsampler._rays_from_pixels(j, jnp.asarray(vids), jnp.asarray(pix))
    got = tsampler._rays_from_pixels(t, torch.as_tensor(vids), torch.as_tensor(pix))
    for name, a, b in zip(("origin", "direction", "color", "mask", "x", "y"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)


def test_background_batch_draws_the_mask0_pool():
    """Every ray starts on a pixel outside the human mask and its border,
    and the batch's colour and depth are that pixel's."""
    scene = _Scene()
    _, t = _staged(scene)
    gen = torch.Generator().manual_seed(0)
    batch = tsampler.sample_background_batch(gen, t, torch.tensor([0, 2]), 512)
    d = batch["direction"]
    k = t.intrinsics[0]
    x = torch.round(k[0, 0] * d[:, 0] / d[:, 2] + k[0, 2]).long()
    y = torch.round(k[1, 1] * d[:, 1] / d[:, 2] + k[1, 2]).long()
    view = torch.as_tensor([int(np.flatnonzero(np.isclose(t.c2w[:, 0, 3].numpy(), o))[0])
                            for o in batch["origin"][:, 0].numpy()])
    assert set(view.tolist()) == {0, 2}
    assert (t.masks[view, y, x] == 0).all()
    border = torch.as_tensor(np.stack([c.border_mask for c in scene.captures]))
    assert (border[view, y, x] == 0).all()
    torch.testing.assert_close(batch["color"], t.images[view, y, x].float() / 255.0)
    torch.testing.assert_close(batch["depth"], t.fused_depths[view, y, x])


@pytest.mark.parametrize("mlp", [nerf_mlp_fn, functools.partial(nerf_mlp_fn, plain=True),
                                 nerf_mlp_plain], ids=["kernel_fn", "plain_fn", "plain_autograd"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["jax_pallas", "jax_xla"])
def test_bkg_loss_fn_matches_jax(tmp_path, use_pallas, mlp):
    jcfg, tcfg = _configs(tmp_path, use_pallas=use_pallas)
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    jparams, tparams = _nets(jspec, tspec)
    j, _ = _staged(_Scene())
    batch = jsampler.sample_background_batch(jax.random.PRNGKey(5), j, jnp.arange(3), 64)
    keys = tuple(jax.random.split(jax.random.PRNGKey(6), 3))

    def total(p):
        c_rgb, c_emp, f_rgb, f_emp, _ = jbkg.bkg_loss_fn(p, jspec, batch, jcfg, 0.1, keys)
        return c_rgb + c_emp + f_rgb + f_emp, (c_rgb, c_emp, f_rgb, f_emp)

    (_, want), want_g = jax.value_and_grad(total, has_aux=True)(jparams)
    got = tbkg.bkg_loss_fn(tparams, tspec, _torch_batch(batch), tcfg, 0.1, mlp=mlp)[:4]
    _close([x.detach().numpy() for x in got], [np.asarray(x) for x in want], "losses")
    named = tbkg.named_params(tparams)
    flat = [p for ps in named.values() for p in ps.values()]
    g = iter(torch.autograd.grad(sum(got), flat))
    got_g = _port_tree({k: {n: next(g) for n in ps} for k, ps in named.items()})
    _close(got_g, to_numpy(want_g), "grads")


def _jax_run(jcfg, jspec, jparams, j, steps, nan_at=None):
    """The JAX step `steps` times; returns (state, metrics per step, the
    batch each step drew). nan_at: that step's arrays have a NaN near."""
    opt = jbkg.make_optimizer()
    make = lambda arrays: jbkg.make_bkg_train_step(jspec, jcfg, arrays, [0, 1, 2], opt)
    bad_arrays = j.replace(near_bkg=j.near_bkg * jnp.nan) if nan_at is not None else None
    step, bad_step = make(j), make(bad_arrays) if nan_at is not None else None
    state = {"params": jparams, "opt_state": opt.init(jparams), "iteration": jnp.int32(0),
             "rng": jax.random.PRNGKey(jcfg.seed)}
    metrics, batches = [], []
    for i in range(steps):
        arrays = bad_arrays if i == nan_at else j
        k_batch = jax.random.split(state["rng"], 6)[1]  # as the step splits it
        batches.append(jsampler.sample_background_batch(
            k_batch, arrays, jnp.asarray(np.array([0, 1, 2], np.int32)), jcfg.rays_per_batch,
            use_fused_depth=jcfg.use_fused_depth))
        state = jax.tree_util.tree_map(jnp.copy, state)  # the step donates its input
        state, m = (bad_step if i == nan_at else step)(state)
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    return state, metrics, batches


def _port_run(tcfg, tspec, tparams, batches):
    opt = tbkg.make_optimizer()
    state = {"params": tparams, "opt_state": opt.init(tbkg.named_params(tparams)),
             "iteration": 0, "generator": torch.Generator().manual_seed(tcfg.seed),
             "init_generator": torch.Generator().manual_seed(tcfg.seed + 1)}
    step = tbkg.make_bkg_train_step(tspec, tcfg, opt)
    metrics = []
    for b in batches:
        state, m = step(state, _torch_batch(b))
        metrics.append(m)
    return state, metrics


def _assert_states_close(tstate, jstate):
    named = tbkg.named_params(tstate["params"])
    _close(_port_tree({k: {n: p.detach() for n, p in ps.items()} for k, ps in named.items()}),
           to_numpy(jstate["params"]), "params")
    adam = jstate["opt_state"][0]
    assert int(tstate["opt_state"]["count"]) == int(adam.count)
    _close(_port_tree(tstate["opt_state"]["mu"]), to_numpy(adam.mu), "mu")
    _close(_port_tree(tstate["opt_state"]["nu"]), to_numpy(adam.nu), "nu")
    assert tstate["iteration"] == int(jstate["iteration"])


@pytest.mark.parametrize("use_pallas", [True, False], ids=["jax_pallas", "jax_xla"])
def test_three_steps_match_jax(tmp_path, use_pallas):
    """Losses every step, then params and Adam mu / nu / count, at 1e-5."""
    jcfg, tcfg = _configs(tmp_path, use_pallas=use_pallas)
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    jparams, tparams = _nets(jspec, tspec)
    j, _ = _staged(_Scene())
    jstate, jmetrics, batches = _jax_run(jcfg, jspec, jparams, j, 3)
    tstate, tmetrics = _port_run(tcfg, tspec, tparams, batches)
    for jm, tm in zip(jmetrics, tmetrics):
        for k in ("coarse_rgb_loss", "fine_rgb_loss", "coarse_empty_space_loss",
                  "fine_empty_space_loss", "total_loss"):
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    _assert_states_close(tstate, jstate)


def test_nan_step_is_skipped_as_in_jax(tmp_path):
    """A NaN loss: the params stay, the moments decay with zero gradients
    and the count advances, as optax does inside the JAX step."""
    jcfg, tcfg = _configs(tmp_path)
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    jparams, tparams = _nets(jspec, tspec)
    j, _ = _staged(_Scene())
    jstate, jmetrics, batches = _jax_run(jcfg, jspec, jparams, j, 2, nan_at=1)
    assert np.isnan(jmetrics[1]["total_loss"])
    tstate, _ = _port_run(tcfg, tspec, tparams, batches[:1])
    mu1 = {n: m.clone() for n, m in tstate["opt_state"]["mu"]["fine"].items()}
    before = {n: p.detach().clone() for n, p in tparams["fine"].named_parameters()}
    step = tbkg.make_bkg_train_step(tspec, tcfg, tbkg.make_optimizer())
    tstate, m = step(tstate, _torch_batch(batches[1]))
    assert torch.isnan(m["total_loss"])
    for n, p in tparams["fine"].named_parameters():
        assert torch.equal(p.detach(), before[n]), n
        torch.testing.assert_close(tstate["opt_state"]["mu"]["fine"][n], 0.9 * mu1[n])
    assert int(tstate["opt_state"]["count"]) == 2
    _assert_states_close(tstate, jstate)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """train_background on the CPU writes metrics and a checkpoint.npz that
    the JAX package's load_checkpoint + restore_like read into its own
    state: the same params, Adam state and iteration."""
    _, tcfg = _configs(tmp_path, max_iter=2)
    trainer = ttrain.train_background(tcfg, _Scene(), [0, 1, 2], [3], device="cpu")
    assert trainer.iteration == 2 and trainer.last_val_rgb.shape == (H, W, 3)
    lines = open(f"{tcfg.out}/metrics.jsonl").read().splitlines()
    assert len(lines) == 4  # two validations, two pushes of train losses
    jcfg, _ = _configs(tmp_path)
    jspec = jnerf.build_nerf_specs(jcfg)
    data = jckpt.load_checkpoint(f"{tcfg.out}/checkpoint.npz")
    template = {k: jnerf.init_nerf_params(jax.random.PRNGKey(0), jspec.nerf)
                for k in ("coarse", "fine")}
    adam = jckpt.restore_like(jbkg.make_optimizer().init(template), data["optim_state"])[0]
    st = trainer.state["opt_state"]
    assert int(adam.count) == int(st["count"]) == 2
    _close(to_numpy(adam.mu), _port_tree(st["mu"]), "mu", tol=0)
    _close(to_numpy(adam.nu), _port_tree(st["nu"]), "nu", tol=0)
    for k in ("coarse", "fine"):
        merged, missing = jckpt.safe_merge_params(template[k], data[f"{k}_model"])
        assert not missing
        _close(to_numpy(merged), convert.to_jax_params(trainer.state["params"][k].state_dict()),
               k, tol=0)
    assert int(data["iteration"]) == 2


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint.npz in the layout the JAX trainer's save_model writes
    resumes the port's trainer: params, Adam state and iteration."""
    jcfg, tcfg = _configs(tmp_path, resume=True)
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    jparams, _ = _nets(jspec, tspec, seed=3)
    jstate, _, _ = _jax_run(jcfg, jspec, jparams, _staged(_Scene())[0], 2)
    jckpt.save_checkpoint(f"{jcfg.out}/checkpoint.npz", {
        "epoch": np.int64(0), "iteration": np.int64(int(jstate["iteration"])),
        "optim_state": jstate["opt_state"], "coarse_model": jstate["params"]["coarse"],
        "fine_model": jstate["params"]["fine"]})
    trainer = tbkg.NeRFTrainer(tcfg, tspec, ttrain.init_bkg_params(tspec, 0, "cpu"), _Scene(),
                               [0, 1, 2], [3], device="cpu")
    _assert_states_close(trainer.state, jstate)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_render_vanilla_matches_jax(tmp_path, use_kernels):
    """The validation render, f32: >= 40 dB against the JAX render_vanilla."""
    jcfg, tcfg = _configs(tmp_path)
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    jparams, tparams = _nets(jspec, tspec, seed=1)
    for k in ("coarse", "fine"):  # denser nets, so the picture is not all white
        jparams[k]["alpha_linear"]["b"] = jparams[k]["alpha_linear"]["b"] + 2.0
        tparams[k].nerf.alpha_linear.bias.data += 2.0
    cap = _Scene().captures[3]
    kw = dict(rays_per_batch=64, samples_per_ray=8, importance_samples_per_ray=8)
    want = np.asarray(jrenderer.render_vanilla(jspec, jparams["coarse"], cap,
                                               fine_params=jparams["fine"],
                                               compute_dtype_name="float32", **kw))
    got = trenderer.render_vanilla(tspec, tparams["coarse"].nerf, cap, tparams["fine"].nerf,
                                   "cpu", compute_dtype=torch.float32, use_kernels=use_kernels,
                                   **kw).numpy()
    assert got.shape == want.shape == (H, W, 3)
    assert want.std() > 1e-2
    mse = float(np.mean((got - want) ** 2))
    assert -10 * np.log10(max(mse, 1e-20)) >= 40.0
