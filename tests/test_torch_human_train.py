"""The port's human train slice (stage 2) vs neuman_tpu: sampler, losses,
gradients, schedules, optimiser steps, skip rules and checkpoints.

One tiny configuration on both sides (nets 6 x 32 with the skip after
layer 4, PE 4 + 2 bands, 8 samples a ray, a 64-vertex body, 4 views of
36 x 48): the JAX weights go into the port through `from_jax_params`, the
batches are drawn by the JAX sampler and handed to both as numpy, and
`perturb=0` with `parity_inject` pins every other draw. On the CPU the
port's wrappers run the kernels' plain versions (`KERNELS`), and `PLAIN`
is autograd of the plain forwards.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from neuman_tpu.datasets import sampler as jsampler
from neuman_tpu.models import human_nerf as jhn
from neuman_tpu.models import lpips as jlpips
from neuman_tpu.models import smpl as jsmpl
from neuman_tpu.ops import mesh as jmesh
from neuman_tpu.options.config import NeuManConfig as JaxConfig
from neuman_tpu.options.config import apply_mode_defaults as jax_mode_defaults
from neuman_tpu.parallel.dryrun import synthetic_arrays as jax_synthetic_arrays
from neuman_tpu.trainers import checkpoint as jckpt
from neuman_tpu.trainers import human as jhuman
from neuman_tpu.trainers.background import make_optimizer as jax_make_optimizer
from neuman_tpu_torch import convert
from neuman_tpu_torch.datasets import arrays as tarrays
from neuman_tpu_torch.datasets import sampler as tsampler
from neuman_tpu_torch.models import human_nerf as thn
from neuman_tpu_torch.models import lpips as tlpips
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.ops import mesh as tmesh
from neuman_tpu_torch.options.config import NeuManConfig as TorchConfig
from neuman_tpu_torch.options.config import apply_mode_defaults as torch_mode_defaults
from neuman_tpu_torch.trainers import human as thuman
from neuman_tpu_torch.utils import canonical_cameras
from tests.torch_parity import t, to_numpy

torch.set_num_threads(1)

VIEWS, H, W, NUM_VERTS = 4, 36, 48, 64
RAYS = 1024 + 32  # the 32 x 32 LPIPS patch and 32 stratified rays
TINY = dict(nerf_depth=6, nerf_width=32, pos_N_freqs=4, pos_max_freq=3, dir_N_freqs=2,
            dir_max_freq=1, samples_per_ray=8, importance_samples_per_ray=8,
            rays_per_batch=RAYS, geo_threshold=0.5, dilation=0, body_rays_ratio=0.95,
            border_rays_ratio=0.0, bkg_rays_ratio=0.05, perturb=0.0, max_iter=3,
            valid_iter=100, name="test", offset_delay=0, offset_scale=0.05)
# the JAX trainer's own parity bar on losses
LOSS_RTOL = 1e-5


def _configs(out_dir="./out", use_pallas=False, **overrides):
    fields = {**TINY, "out_dir": str(out_dir), **overrides}
    jcfg = jax_mode_defaults(JaxConfig(), "smpl_and_offset")
    tcfg = torch_mode_defaults(TorchConfig(), "smpl_and_offset")
    for k, v in fields.items():
        setattr(jcfg, k, v)
        setattr(tcfg, k, v)
    jcfg.use_pallas, jcfg.pe_recurrence, jcfg.compute_dtype = use_pallas, False, "float32"
    return jcfg.finalize(), tcfg.finalize()


@functools.lru_cache(maxsize=None)
def _scene():
    """The shared scene: body models, staged arrays and SMPL state."""
    jbody = jsmpl.synthetic_smpl_model(num_verts=NUM_VERTS, num_joints=24)
    tbody = tsmpl.SMPLModel.from_numpy(
        np.asarray(jbody.v_template), np.asarray(jbody.shapedirs), np.asarray(jbody.J_regressor),
        np.asarray(jbody.lbs_weights), jbody.parents, np.asarray(jbody.faces))
    rng = np.random.default_rng(0)
    smpl = dict(poses=rng.normal(size=(VIEWS, 72)).astype(np.float32) * 0.1,
                betas=rng.normal(size=(VIEWS, 10)).astype(np.float32) * 0.1,
                alignments=np.tile(np.eye(4, dtype=np.float32)[None], (VIEWS, 1, 1)))
    jarr = jax_synthetic_arrays(num_views=VIEWS, h=H, w=W, num_verts=NUM_VERTS)
    tarr = tarrays.synthetic_arrays(VIEWS, H, W, num_verts=NUM_VERTS, device="cpu")
    return jbody, tbody, smpl, jarr, tarr


@functools.lru_cache(maxsize=None)
def _batches(n=3):
    """Batches drawn by the JAX sampler (patch first), as numpy dicts."""
    jarr = _scene()[3]
    out = []
    for i in range(n):
        b = jsampler.sample_human_batch(
            jax.random.PRNGKey(7 + i), jarr, jnp.arange(VIEWS, dtype=jnp.int32),
            TINY["geo_threshold"], RAYS, ratios=(0.95, 0.0, 0.05), use_patch=True, dilation=0)
        b = to_numpy(b)
        # the synthetic scene's default human range (1.5, 3.5), which the
        # rays that miss the body get, lands exactly on the background's z
        # grid (0.5 + 0.5 i): at an exact tie the merged order, and with it
        # which sample's density owns the next interval, hangs on the last
        # bit of a linspace. Move those rays' range off the grid.
        miss = (b["is_hit"] == 0)[:, None]
        b["human_near"] = np.where(miss, np.float32(1.53), b["human_near"])
        b["human_far"] = np.where(miss, np.float32(3.47), b["human_far"])
        out.append(b)
    return out


def _torch_batch(b):
    as_t = lambda k, v: (torch.as_tensor(np.asarray(v)) if k in ("cap_id", "is_bkg", "is_hit",
                                                                  "patch_counter") else t(v))
    return {k: as_t(k, v).long() if k == "cap_id" else as_t(k, v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _inject():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(RAYS, 8, 3))
    return {"color_dirs": (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
            "dummy_pts": rng.uniform(-1.5, 1.5, size=(RAYS, 8, 3)).astype(np.float32),
            "can_cam": 1,
            "can_x": rng.integers(0, W, 128).astype(np.float32),
            "can_y": rng.integers(0, H, 128).astype(np.float32)}


def _jax_side(jcfg):
    """(spec, params, ctx) of the JAX package."""
    jbody, _, smpl, jarr, _ = _scene()
    spec = jhn.build_human_nerf_spec(jcfg)
    params = jhn.init_human_nerf_params(jax.random.PRNGKey(0), spec, **smpl)
    # a live canonical net: a random narrow net's density is near its bias
    params["coarse_human_net"]["alpha_linear"]["b"] = jnp.full((1,), 0.3)
    ctx = {
        "body_model": jbody, "da_smpl": jhn.da_pose_params(24), "scale": 1.0,
        "topo": jmesh.MeshTopology.build(jbody.faces, jbody.num_verts),
        "can_verts": jarr.verts, "can_k": jarr.intrinsics[:2], "can_c2w": jarr.c2w[:2],
        "can_hw": (H, W), "interval_comp": 1.3,
        "lpips_params": jlpips.init_lpips_params(jax.random.PRNGKey(9)),
        "scene_ids": jnp.arange(VIEWS, dtype=jnp.int32), "grad_masks": jnp.ones((VIEWS, 72)),
        "knn_k": 4, "knn_stride": jcfg.knn_stride,
    }
    return spec, params, ctx


def _torch_side(tcfg, params, lpips_params, grad_masks=None):
    """(model, ctx) of the port with the JAX weights."""
    _, tbody, smpl, _, tarr = _scene()
    model = thn.HumanNeRF(thn.build_human_nerf_spec(tcfg), **smpl)
    model.load_state_dict(convert.from_jax_params(to_numpy(params)))
    ctx = {
        "body_model": tbody, "da_smpl": thn.da_pose_params(24), "scale": 1.0,
        "topo": tmesh.MeshTopology.build(tbody.faces, tbody.num_verts),
        "can_verts": tarr.verts, "can_k": tarr.intrinsics[:2], "can_c2w": tarr.c2w[:2],
        "can_hw": (H, W), "interval_comp": 1.3,
        "lpips_params": tlpips.lpips_params_from_jax(to_numpy(lpips_params)),
        "scene_ids": torch.arange(VIEWS),
        "grad_masks": torch.ones(VIEWS, 72) if grad_masks is None else grad_masks,
        "knn_k": 4, "knn_stride": tcfg.knn_stride,
    }
    return model, ctx


def _jax_anneals(jcfg, it):
    return jhuman.compute_anneals(jcfg, jnp.int32(it))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(use_pallas):
    """Losses and gradients of batch 0 at iteration 30,000 from the JAX
    package (use_pallas=True runs its Pallas kernels in interpret mode)."""
    jcfg, _ = _configs(use_pallas=use_pallas)
    spec, params, ctx = _jax_side(jcfg)
    fn = jhuman.make_human_loss_fn(spec, jcfg, ctx, parity_inject=_inject())
    keys = {n: jax.random.PRNGKey(0) for n in ("perturb", "offset", "color", "dummy", "can_cam",
                                               "can_pix", "can_perturb")}
    batch = jax.tree_util.tree_map(jnp.asarray, _batches()[0])
    (_, aux), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, batch, keys, _jax_anneals(jcfg, 30000))
    return to_numpy(params), to_numpy(ctx["lpips_params"]), to_numpy(aux), to_numpy(grads)


def _model_grads(model, total):
    named = dict(model.named_parameters())
    trained = [n for n, p in named.items() if p.requires_grad]
    g = torch.autograd.grad(total, [named[n] for n in trained], allow_unused=True)
    sd = {n: torch.zeros_like(p) for n, p in named.items()}
    sd.update({n: x for n, x in zip(trained, g) if x is not None})
    return convert.to_jax_params(sd)


@pytest.mark.parametrize("ops", ["KERNELS", "PLAIN"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_losses_and_gradients_match_jax(use_pallas, ops):
    """Every entry of LOSS_NAMES at 1e-5 relative (the JAX trainer's own
    parity bar) and every parameter gradient. Within each package the
    formulations agree far closer (JAX XLA vs interpret-mode Pallas 2e-5,
    the port's kernels' plain versions vs autograd of the plain forward
    3e-7, both measured on this batch), so the bars below are about the two
    packages' arithmetic, not the port's wiring. The nets' gradients are sums
    over ~34k samples of terms that largely cancel (the rgb and LPIPS
    terms' leaves are ~1e-3 of their summands), which magnifies the last-bit
    differences of the two packages' exp, sigmoid and sums: measured 8e-4
    (canonical net) and 3.5e-3 (offset net) of a leaf's largest element,
    held to 1e-2. The poses' gradient also comes through the warp's face
    choice: most points outside a coarse mesh project onto an edge or a
    vertex, where the faces that share it tie in distance and the last bit
    picks one; the blended transform is the same there but its derivative in
    the vertices is not, so the poses are held to 2e-2 of the largest
    element (3.7e-3 measured)."""
    params, lpips_params, jaux, jgrads = _jax_loss_and_grads(use_pallas)
    _, tcfg = _configs()
    model, ctx = _torch_side(tcfg, params, lpips_params)
    model.coarse_bkg_net.requires_grad_(False)
    model.fine_bkg_net.requires_grad_(False)
    fn = thuman.make_human_loss_fn(model, tcfg, ctx, parity_inject=_inject(),
                                   ops=getattr(thuman, ops))
    total, aux = fn(_torch_batch(_batches()[0]), torch.Generator().manual_seed(0),
                    thuman.compute_anneals(tcfg, 30000))
    assert not bool(aux["dead"]) and not bool(jaux["dead"])
    for name in thuman.LOSS_NAMES + ["rgb_loss", "can_loss", "total_loss"]:
        want = float(jaux["losses"][name])
        assert want != 0.0, name
        np.testing.assert_allclose(float(aux["losses"][name].detach()), want, rtol=LOSS_RTOL, atol=1e-8,
                                   err_msg=name)
    got = _model_grads(model, total)
    for key in ("coarse_human_net", "offset_nets", "poses", "coarse_bkg_net", "fine_bkg_net"):
        fg, tg = jax.tree_util.tree_flatten(got[key])
        fw, tw = jax.tree_util.tree_flatten(jgrads[key])
        assert tg == tw, key
        rel = 2e-2 if key == "poses" else 1e-2
        for i, (a, b) in enumerate(zip(fg, fw)):
            np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-12),
                                       err_msg=f"{key} leaf {i}")
    assert np.abs(jgrads["poses"]).max() > 0 and np.abs(got["betas"]).max() == 0
    assert max(np.abs(x).max() for x in jax.tree_util.tree_leaves(got["offset_nets"])) > 0


def test_three_optimiser_steps_match_the_written_out_update(tmp_path):
    """Three steps on pinned batches: the port's train step against the JAX
    package's update (trainers/human.py: value_and_grad of the loss, the
    DensePose gating, zeroed gradients on a bad step, optax Adam, the
    trainable mask times the per-group learning rates) written out here with
    the JAX loss and optax. Adam's first steps move every weight by ~lr
    whatever its gradient's size, so the gradients' deviation (see
    test_losses_and_gradients_match_jax) shows as a fraction of lr: after
    each step at least 95% of a leaf's elements agree to 1e-5 of its largest
    element, and every element to 2 lr per step (a weight whose gradient is
    within rounding of zero may step the other way)."""
    jcfg, tcfg = _configs(tmp_path)
    spec, params, ctx = _jax_side(jcfg)
    masks_np = np.ones((VIEWS, 72), np.float32)
    masks_np[:, 9:15] = 0.0
    ctx["grad_masks"] = jnp.asarray(masks_np)
    model, tctx = _torch_side(tcfg, params, ctx["lpips_params"], t(masks_np))
    optimizer = jax_make_optimizer()
    opt_state = optimizer.init(params)
    jfn = jhuman.make_human_loss_fn(spec, jcfg, ctx, parity_inject=_inject())
    vg = jax.jit(jax.value_and_grad(jfn, has_aux=True))
    keys = {n: jax.random.PRNGKey(0) for n in ("perturb", "offset", "color", "dummy", "can_cam",
                                               "can_pix", "can_perturb")}
    toptimizer = thuman.make_optimizer()
    state = {"opt_state": toptimizer.init(thuman.trained_params(model)), "iteration": 0,
             "generator": torch.Generator().manual_seed(0),
             "init_generator": torch.Generator().manual_seed(1)}
    step = thuman.make_human_train_step(model, tcfg, toptimizer, tctx, parity_inject=_inject())
    for it, b in enumerate(_batches()):
        anneals = _jax_anneals(jcfg, it)
        (total, aux), grads = vg(params, jax.tree_util.tree_map(jnp.asarray, b), keys, anneals)
        assert not bool(aux["dead"]) and not bool(jnp.isnan(total))
        grads["poses"] = grads["poses"] * ctx["grad_masks"]
        updates, opt_state = optimizer.update(grads, opt_state, params)
        mask = jhuman.trainable_mask(params, jcfg.train_mode)
        lrs = jhuman.lr_tree(params, anneals)
        updates = jax.tree_util.tree_map(lambda u, m, lr: u * m * lr, updates, mask, lrs)
        params = optax.apply_updates(params, updates)

        state, metrics = step(state, _torch_batch(b))
        assert metrics["dead_restart"] == 0.0
        np.testing.assert_allclose(float(metrics["total_loss"]), float(total), rtol=1e-4)
        got = convert.to_jax_params(model.state_dict())
        lr = float(anneals["lr"])
        for key in ("coarse_human_net", "offset_nets", "poses", "betas", "coarse_bkg_net"):
            fg = jax.tree_util.tree_leaves(got[key])
            fw = jax.tree_util.tree_leaves(to_numpy(params[key]))
            for i, (a, w) in enumerate(zip(fg, fw)):
                diff = np.abs(a - w)
                assert diff.max() <= 2.0 * lr * (it + 1) + 1e-7, f"step {it} {key} leaf {i}"
                assert (diff <= 1e-5 * np.abs(w).max()).mean() >= 0.95, f"step {it} {key} leaf {i}"
    assert state["iteration"] == 3 and int(state["opt_state"]["count"]) == 3
    # the gated joints' pose rows did not move
    np.testing.assert_array_equal(got["poses"][:, 9:15], _scene()[2]["poses"][:, 9:15])
    assert np.abs(got["poses"] - _scene()[2]["poses"]).max() > 0

    # checkpoint.npz round trips, both ways, on this state
    trainer = _Trainer(tcfg, model, toptimizer, state)
    trainer.save_model()
    data = jckpt.load_checkpoint(str(tmp_path / "test" / "checkpoint.npz"))
    merged, missing = jckpt.safe_merge_params(params, data["hybrid_model"])
    assert not missing and int(data["iteration"]) == 3
    # the moments of the trained groups; the port keeps none for the frozen
    # betas and alignments (the JAX package tracks theirs and never uses
    # them: its trainable mask zeroes their updates) and writes zeros
    restored = jckpt.restore_like(opt_state, data["optim_state"])
    assert int(restored[0].count) == 3
    for got_m, want_m in ((restored[0].mu, opt_state[0].mu), (restored[0].nu, opt_state[0].nu)):
        for key in thuman.TRAINED:
            for a, w in zip(jax.tree_util.tree_leaves(got_m[key]),
                            jax.tree_util.tree_leaves(want_m[key])):
                w = np.asarray(w)
                np.testing.assert_allclose(np.asarray(a), w, atol=1e-2 * np.abs(w).max() + 1e-12)
        assert float(jnp.abs(got_m["betas"]).max()) == 0.0
    for a, w in zip(jax.tree_util.tree_leaves(merged), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), w)
    # the JAX trainer's checkpoint resumes in the port
    jckpt.save_checkpoint(str(tmp_path / "test" / "checkpoint.npz"), {
        "epoch": np.int64(0), "iteration": np.int64(3), "optim_state": opt_state,
        "hybrid_model": params})
    model2, _ = _torch_side(tcfg, _jax_side(jcfg)[1], ctx["lpips_params"])
    state2 = {"opt_state": toptimizer.init(thuman.trained_params(model2)), "iteration": 0}
    resumed = _Trainer(tcfg, model2, toptimizer, state2)
    resumed.resume()
    assert resumed.iteration == 3 and int(state2["opt_state"]["count"]) == 3
    for a, w in zip(jax.tree_util.tree_leaves(convert.to_jax_params(model2.state_dict())),
                    jax.tree_util.tree_leaves(to_numpy(params))):
        np.testing.assert_array_equal(a, w)
    mu = state2["opt_state"]["mu"]["poses"]["poses"].numpy()
    np.testing.assert_array_equal(mu, np.asarray(opt_state[0].mu["poses"]))


class _Trainer(thuman.HumanNeRFTrainer):
    """The trainer's checkpoint methods over a given model and state."""

    def __init__(self, opt, model, optimizer, state):
        self.opt, self.model, self.optimizer, self.state = opt, model, optimizer, state
        self.out, self.device = opt.out, torch.device("cpu")


def test_dead_net_step_is_skipped_and_the_nets_restart():
    """A canonical net whose density is <= 0 everywhere: every loss is zero,
    Adam's moments take zero gradients and its count advances, the poses
    stay, and the canonical and offset nets are drawn afresh."""
    jcfg, tcfg = _configs()
    model, ctx = _torch_side(tcfg, *_jax_loss_and_grads(False)[:2])
    with torch.no_grad():
        model.coarse_human_net.nerf.alpha_linear.weight.zero_()
        model.coarse_human_net.nerf.alpha_linear.bias.fill_(-1.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = thuman.make_optimizer()
    state = {"opt_state": optimizer.init(thuman.trained_params(model)), "iteration": 5,
             "generator": torch.Generator().manual_seed(0),
             "init_generator": torch.Generator().manual_seed(1)}
    step = thuman.make_human_train_step(model, tcfg, optimizer, ctx, parity_inject=_inject())
    state, metrics = step(state, _torch_batch(_batches()[0]))
    assert metrics["dead_restart"] == 1.0 and state["iteration"] == 6
    assert all(float(metrics[k]) == 0.0 for k in thuman.LOSS_NAMES + ["total_loss"])
    assert int(state["opt_state"]["count"]) == 1
    assert all(float(v.abs().max()) == 0.0 for ps in state["opt_state"]["mu"].values()
               for v in ps.values())
    after = model.state_dict()
    for k, v in before.items():
        restarted = k.startswith(("coarse_human_net.", "offset_nets."))
        assert torch.equal(v, after[k]) != restarted, k


def test_nan_loss_step_is_skipped():
    jcfg, tcfg = _configs()
    model, ctx = _torch_side(tcfg, *_jax_loss_and_grads(False)[:2])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = thuman.make_optimizer()
    state = {"opt_state": optimizer.init(thuman.trained_params(model)), "iteration": 0,
             "generator": torch.Generator().manual_seed(0),
             "init_generator": torch.Generator().manual_seed(1)}
    step = thuman.make_human_train_step(model, tcfg, optimizer, ctx, parity_inject=_inject())
    batch = _torch_batch(_batches()[0])
    batch["color"][5, 1] = float("nan")
    state, metrics = step(state, batch)
    assert np.isnan(float(metrics["total_loss"])) and metrics["dead_restart"] == 0.0
    for k, v in before.items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert int(state["opt_state"]["count"]) == 1


@pytest.mark.parametrize("it", [0, 100, 20000, 30000, 59999, 70000, 250000])
@pytest.mark.parametrize("decay", [False, True])
def test_compute_anneals_match_jax(it, decay):
    jcfg, tcfg = _configs(prior_knowledge_decay=decay, offset_delay=20000, offset_scale=0.0)
    want = _jax_anneals(jcfg, it)
    got = thuman.compute_anneals(tcfg, it)
    assert set(got) == set(want)
    for k, v in want.items():
        # atol: JAX takes 1 - it / 60000 in f32, 6e-8 off next to 1
        np.testing.assert_allclose(got[k], float(v), rtol=2e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("train_mode", ["smpl_only", "smpl_and_offset"])
def test_trainable_mask_and_lr_tree_match_jax(train_mode):
    jcfg, tcfg = _configs()
    _, params, _ = _jax_side(jcfg)
    model = thn.HumanNeRF(thn.build_human_nerf_spec(tcfg), **_scene()[2])
    anneals = thuman.compute_anneals(tcfg, 1000)
    as_tree = lambda d: convert.to_jax_params({k: np.full(v.shape, d[k], np.float32)
                                               for k, v in model.state_dict().items()})
    for got, want in (
        (as_tree(thuman.trainable_mask(model, train_mode)), jhuman.trainable_mask(params, train_mode)),
        (as_tree(thuman.lr_tree(model, anneals)), jhuman.lr_tree(params, _jax_anneals(jcfg, 1000))),
    ):
        want = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                                      to_numpy(params), to_numpy(want))
        fg, tg = jax.tree_util.tree_flatten(got)
        fw, tw = jax.tree_util.tree_flatten(want)
        assert tg == tw
        for a, b in zip(fg, fw):
            np.testing.assert_allclose(a, b, rtol=2e-6)


def test_densepose_masks_match_jax():
    rng = np.random.default_rng(4)
    for parts in ([1, 2, 23], [3, 4, 5, 6, 15, 16], list(range(1, 25)), []):
        dp = np.zeros((H, W), np.uint8)
        for p in parts:
            dp[rng.integers(0, H, 20), rng.integers(0, W, 20)] = p
        np.testing.assert_array_equal(thuman.turn_smpl_gradient_off(dp),
                                      jhuman.turn_smpl_gradient_off(dp))
    dp = np.zeros((H, W), np.uint8)
    dp[:4] = 1  # the torso only: every limb joint is gated
    scene = tarrays.ArraysScene(_scene()[4], densepose=[dp, None, dp, None])
    masks = thuman.build_pose_grad_masks(scene, range(VIEWS))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jhuman.build_pose_grad_masks(scene, range(VIEWS))))
    assert masks[0].sum() < 72 and masks[1].sum() == 72


@pytest.mark.parametrize("num,ratios,dilation", [
    (1024, (0.95, 0.05, 0.0), 30), (512, (0.95, 0.05, 0.0), 0), (1536 - 1024, (0.8, 0.1, 0.1), 30),
    (33, (0.5, 0.25, 0.25), 30), (64, (0.0, 0.0, 1.0), 30)])
def test_num_rays_split_matches_jax(num, ratios, dilation):
    assert tsampler.num_rays_split(num, *ratios, dilation) == jsampler.num_rays_split(
        num, *ratios, dilation)


def test_human_batch_of_given_pixels_matches_jax(monkeypatch):
    """Rays, colours, near/far and is_hit of the same view and pixel ids:
    the JAX sampler with its pixel draw replaced by fixed ids."""
    _, _, _, jarr, tarr = _scene()
    pix = np.random.default_rng(5).integers(0, H * W, 48)
    monkeypatch.setattr(jsampler, "_stratified_coords", lambda *a: jnp.asarray(pix, jnp.int32))
    want = to_numpy(jsampler.sample_human_batch.__wrapped__(
        jax.random.PRNGKey(2), jarr, jnp.arange(VIEWS, dtype=jnp.int32), 0.5, 48,
        ratios=(0.95, 0.0, 0.05), use_patch=False, dilation=0))
    got = tsampler.human_batch_from_pixels(tarr, torch.tensor(int(want["cap_id"])),
                                           torch.as_tensor(pix), 0.5, torch.tensor(0))
    assert set(got) == set(want)
    assert 0 < want["is_hit"].sum() < 48
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, err_msg=k)


def test_sample_human_batch_draw():
    """The port's own draw: the stratified pixels come from their class
    pools, and a patch batch leads with a 32 x 32 block inside the image
    that holds a body pixel."""
    tarr = tarrays.synthetic_arrays(VIEWS, 64, 80, num_verts=NUM_VERTS, device="cpu")
    views = torch.arange(VIEWS)
    gen = torch.Generator().manual_seed(0)
    b = tsampler.sample_human_batch(gen, tarr, views, 0.5, 200, ratios=(0.6, 0.0, 0.4),
                                    use_patch=False, dilation=0)
    assert int(b["patch_counter"]) == 0 and b["origin"].shape == (200, 3)
    np.testing.assert_array_equal(b["is_bkg"].numpy(), np.r_[np.zeros(120), np.ones(80)])
    np.testing.assert_allclose(b["direction"].norm(dim=-1).numpy(), 1.0, atol=1e-6)
    seen = set()
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        vid = views[torch.randint(0, VIEWS, (), generator=gen)]
        coords = tsampler._patch_coords(gen, tarr, vid)
        ys, xs = (coords // 80).reshape(32, 32), (coords % 80).reshape(32, 32)
        assert (ys[:, 0] == ys[0, 0] + torch.arange(32)).all()
        assert (xs[0] == xs[0, 0] + torch.arange(32)).all()
        assert 0 <= ys.min() and ys.max() < 64 and 0 <= xs.min() and xs.max() < 80
        assert tarr.masks[vid].reshape(-1)[coords].any()
        b = tsampler.sample_human_batch(torch.Generator().manual_seed(seed), tarr, views, 0.5,
                                        1024 + 40, ratios=(0.95, 0.0, 0.05), dilation=0)
        seen.add(int(b["patch_counter"]))
        assert b["color"].shape == (1064, 3)
    assert 1 in seen


def test_clustered_box_points():
    gen = torch.Generator().manual_seed(3)
    p = thuman.clustered_box_points(gen, 128, 64, group=4)
    assert p.shape == (128, 64, 3) and p.min() >= -1.5 and p.max() <= 1.5
    assert abs(p.mean()) < 3e-2 and abs(p.std() - 3.0 / np.sqrt(12.0)) < 3e-2
    g = p.reshape(128, 16, 4, 3)
    assert (g - g[:, :, 2:3]).norm(dim=-1).max() < 2 * 0.005 * np.sqrt(3) + 1e-6
    a = thuman.clustered_box_points(torch.Generator().manual_seed(3), 8, 16, group=1)
    b = (torch.rand(8, 16, 3, generator=torch.Generator().manual_seed(3)) - 0.5) * 3.0
    assert torch.equal(a, b)


def test_lpips_matches_jax():
    params = to_numpy(jlpips.init_lpips_params(jax.random.PRNGKey(9)))
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(-1, 1, size=(2, 3, 32, 32)).astype(np.float32) for _ in range(2))
    want = jlpips.lpips(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(a), jnp.asarray(b))
    got = tlpips.lpips(tlpips.lpips_params_from_jax(params), t(a), t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    seeded = tlpips.init_lpips_params(0)
    assert [tuple(c["w"].shape) for c in seeded["convs"]] == [c["w"].shape for c in params["convs"]]
    assert float(tlpips.lpips(seeded, t(a), t(b)).min()) > 0


def test_canonical_cameras_match_jax():
    from neuman_tpu.render import paths
    from neuman_tpu.utils.misc import smpl_verts_to_center_and_up

    jbody, tbody = _scene()[:2]
    verts = np.asarray(jbody.v_template) * 1.5 + 0.1
    center, up = canonical_cameras.smpl_verts_to_center_and_up(verts, tbody.J_regressor.numpy())
    jc, ju = smpl_verts_to_center_and_up(verts, jbody)
    np.testing.assert_allclose(center, jc, atol=1e-6)
    np.testing.assert_allclose(up, ju, atol=1e-6)
    want = np.stack([p.camera_to_world for p in paths.default_360_path(jc, ju, 3.0, 8)])
    got = np.stack(canonical_cameras.default_360_path(center, up, 3.0, 8))
    np.testing.assert_allclose(got, want, atol=1e-6)
    k, c2w = canonical_cameras.canonical_cameras(verts, tbody.J_regressor.numpy(), (H, W), res=8)
    assert k.shape == (8, 3, 3) and c2w.shape == (8, 4, 4)
    np.testing.assert_allclose(k[0], [[W * 1000 / 1280, 0, W / 2], [0, W * 1000 / 1280, H / 2],
                                      [0, 0, 1]], rtol=1e-6)


def test_train_human_runs_on_the_cpu_when_asked(tmp_path):
    """The entry point: 2 steps with validations and a checkpoint on
    device="cpu", a background loaded from a stage-1 checkpoint, and a
    resumed trainer with the same state."""
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.trainers import checkpoint as tckpt

    _, tcfg = _configs(tmp_path, max_iter=2, valid_iter=1, load_background="bkg",
                       penalize_lpips=0.0, rays_per_batch=40)
    _, tbody, smpl, _, tarr = _scene()
    bkg = thn.HumanNeRF(thn.build_human_nerf_spec(tcfg), generator=torch.Generator().manual_seed(9))
    tckpt.save_checkpoint(str(tmp_path / "bkg" / "checkpoint.npz"), {
        "coarse_model": convert.to_jax_params(bkg.coarse_bkg_net.state_dict()),
        "fine_model": convert.to_jax_params(bkg.fine_bkg_net.state_dict())})
    scene = tarrays.ArraysScene(
        tarr, static_vert=list(tarr.verts.numpy()), faces=tbody.faces, scale=1.0,
        smpls=[{"pose": p, "betas": b} for p, b in zip(smpl["poses"], smpl["betas"])],
        alignments=smpl["alignments"])
    trainer = ttrain.train_human(tcfg, scene, [0, 1, 2], [3], tbody, device="cpu")
    assert trainer.iteration == 2 and trainer.device.type == "cpu"
    assert all(np.isfinite(v) for v in trainer.last_val_losses.values())
    for (k, a), b in zip(trainer.model.coarse_bkg_net.state_dict().items(),
                         bkg.coarse_bkg_net.state_dict().values()):
        assert torch.equal(a, b), k
    data = tckpt.load_checkpoint(str(tmp_path / "test" / "checkpoint.npz"))
    assert int(data["iteration"]) == 2 and set(data["hybrid_model"]) == {
        "coarse_bkg_net", "fine_bkg_net", "coarse_human_net", "offset_nets", "poses", "betas",
        "alignments"}


def test_validate_writes_four_decodable_pngs(tmp_path):
    """The visual half of the validation: the canonical render with its
    depth and acc maps and the SMPL overlay, as PNGs beside metrics.jsonl
    that an independent decoder (imageio) and the port's own read back at
    the frame's size; the canonical frame shows the body on white."""
    import imageio.v2 as imageio

    from neuman_tpu_torch.trainers import logging as tlog

    _, tcfg = _configs(tmp_path, max_iter=1, valid_iter=1, penalize_lpips=0.0, rays_per_batch=40)
    _, tbody, smpl, _, tarr = _scene()
    scene = tarrays.ArraysScene(
        tarr, static_vert=list(tarr.verts.numpy()), faces=tbody.faces, scale=1.0,
        smpls=[{"pose": p, "betas": b} for p, b in zip(smpl["poses"], smpl["betas"])],
        alignments=smpl["alignments"])
    model = thn.HumanNeRF(thn.build_human_nerf_spec(tcfg),
                          generator=torch.Generator().manual_seed(0), **smpl)
    with torch.no_grad():
        model.coarse_human_net.nerf.alpha_linear.bias.fill_(3.0)
    trainer = thuman.HumanNeRFTrainer(tcfg, model, scene, [0, 1, 2], [3], tbody, device="cpu")
    trainer.validate()
    names = [p.rsplit("/", 1)[1] for p in trainer.last_val_images]
    assert names == [f"{n}_00000000.png" for n in ("val_can", "val_depth", "val_acc",
                                                   "val_smpl_overlay")]
    images = {}
    for path, name in zip(trainer.last_val_images, names):
        assert path == str(tmp_path / "test" / name)
        own = tlog.decode_png(open(path, "rb").read())
        assert own.shape == (H, W, 3) and own.dtype == np.uint8
        np.testing.assert_array_equal(own, np.asarray(imageio.imread(path))[..., :3])
        images[name.split("_0")[0]] = own
    body = images["val_acc"][..., 0] > 127
    assert 0.01 < body.mean() < 0.9
    assert (images["val_can"][~body].min(axis=-1) > 200).all()  # white where nothing is
    # the overlay is the training view with the shaded body composited in
    view = scene.captures[trainer.all_views[int(trainer.train_ids[1])]].image
    changed = (images["val_smpl_overlay"] != view).any(-1)
    assert changed.mean() > 0.005 and not changed.all()


def test_png_round_trip_and_push_images(tmp_path):
    from neuman_tpu_torch.trainers import logging as tlog

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tlog.decode_png(tlog.encode_png(img)), img)
    with pytest.raises(ValueError):
        tlog.encode_png(img.astype(np.float32))
    with pytest.raises(ValueError):
        tlog.decode_png(tlog.encode_png(img)[:-6] + b"\x00" * 6)
    _, tcfg = _configs(tmp_path)
    pusher = tlog.MetricsPusher(tcfg)
    depth = np.linspace(2.0, 4.0, 12, dtype=np.float32).reshape(3, 4)
    paths = pusher.push_images(12, {"rgb": img / 255.0 * 1.5 - 0.1, "depth": depth})
    assert [p.rsplit("/", 1)[1] for p in paths] == ["rgb_00000012.png", "depth_00000012.png"]
    got = tlog.decode_png(open(paths[0], "rb").read())
    want = (np.clip(np.float32(img / 255.0 * 1.5 - 0.1), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    d = tlog.decode_png(open(paths[1], "rb").read())
    assert d[0, 0].tolist() == [0, 0, 0] and d[-1, -1].tolist() == [255, 255, 255]


def test_overlay_smpl_matches_jax():
    """The port's copy of the numpy rasteriser against the JAX package's,
    on one capture: exactly the same image."""
    from neuman_tpu.render import rasterize as jrast
    from neuman_tpu_torch.render import rasterize as trast

    _, tbody, _, _, tarr = _scene()
    scene = tarrays.ArraysScene(tarr)
    cap = scene.captures[1]
    verts = np.asarray(tbody.v_template) * 0.8
    faces = np.asarray(tbody.faces)
    got = trast.overlay_smpl(cap.image, verts, faces, cap)
    want = jrast.overlay_smpl(cap.image, verts, faces, cap)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    assert 0.01 < (got != cap.image).any(-1).mean() < 0.9
    np.testing.assert_array_equal(trast.rasterize_mesh(verts, faces[:, :3], cap),
                                  jrast.rasterize_mesh(verts, faces[:, :3], cap))


@pytest.mark.parametrize("flag", [True, False])
def test_train_step_is_deterministic_and_keeps_the_cudnn_flags(flag):
    """The step scopes cuDNN's deterministic convolutions (TF32 off) itself:
    after a step the process's `deterministic`, `benchmark` and
    `allow_tf32` are what the caller set, True or False, and the step's
    losses and parameters do not depend on them (two steps from one state
    give the same bits)."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    jcfg, tcfg = _configs()
    params, lpips_params = _jax_loss_and_grads(False)[:2]
    runs = []
    try:
        for _ in range(2):
            cudnn.deterministic = cudnn.benchmark = cudnn.allow_tf32 = flag
            model, ctx = _torch_side(tcfg, params, lpips_params)
            optimizer = thuman.make_optimizer()
            state = {"opt_state": optimizer.init(thuman.trained_params(model)), "iteration": 0,
                     "generator": torch.Generator().manual_seed(0),
                     "init_generator": torch.Generator().manual_seed(1)}
            step = thuman.make_human_train_step(model, tcfg, optimizer, ctx,
                                                parity_inject=_inject())
            # a copy: another test writes a NaN into its batch 0
            batch = _torch_batch({k: np.array(v) for k, v in _batches()[1].items()})
            _, metrics = step(state, batch)
            assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32) == (flag,) * 3
            runs.append(([metrics[k] for k in thuman.LOSS_NAMES + ["total_loss"]],
                         [p.detach().clone() for p in model.parameters()]))
            # LPIPS alone (the validation's) keeps TF32 off in its own scope
            img = torch.rand(1, 3, 32, 32) * 2 - 1
            tlpips.lpips(ctx["lpips_params"], img, -img)
            assert cudnn.allow_tf32 == flag
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved
    assert float(runs[0][0][-1]) > 0
    for a, b in zip(*[r[0] + r[1] for r in runs]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
