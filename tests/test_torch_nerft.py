"""The NeRF-T ablation (`--ablate_nerft`, stage 1 with the time channel) of
the port against neuman_tpu's, on the CPU.

The tiny background configuration of tests/test_torch_bkg_train.py with
raw_pos_dim 4: the nets take (x, y, z, t) through a 4-D PE (4 bands: 36
columns), plain PyTorch against the JAX package's reference-shaped joiner.
The JAX validation does not pass the time channel to its render, which
then raises; the port's passes it (test_jax_validate_raises_without_the_time_channel).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.datasets import sampler as jsampler
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.render import renderer as jrenderer
from neuman_tpu.trainers import background as jbkg
from neuman_tpu_torch import train as ttrain
from neuman_tpu_torch.models import nerf as tnerf
from neuman_tpu_torch.render import renderer as trenderer
from neuman_tpu_torch.trainers import background as tbkg
from tests import test_torch_bkg_train as bkg_case
from tests.torch_parity import to_numpy

torch.set_num_threads(1)

NERFT = dict(ablate_nerft=True, raw_pos_dim=4)
# losses and gradients, relative and absolute: the port's plain f32 net
# against XLA's, sums of the same terms in other orders (measured on the
# loss test's batch: losses 1.8e-7 relative, gradients 3e-8 absolute)
TOL = 1e-5


def _setup(tmp_path, seed=0, density_shift=0.0, **overrides):
    """Both packages' configs, specs and nets (equal weights); the nets'
    density bias shifted by density_shift."""
    jcfg, tcfg = bkg_case._configs(tmp_path, **NERFT, **overrides)
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    assert tspec.pos_pe.input_dims == 4 and tspec.nerf.input_ch == jspec.nerf.input_ch
    jparams, tparams = bkg_case._nets(jspec, tspec, seed=seed)
    for k in ("coarse", "fine"):
        jparams[k]["alpha_linear"]["b"] = jparams[k]["alpha_linear"]["b"] + density_shift
        tparams[k].nerf.alpha_linear.bias.data += density_shift
    return jcfg, tcfg, jspec, tspec, jparams, tparams


def test_loss_and_gradients_match_jax(tmp_path):
    """Coarse and fine losses and empty-space penalties, and every
    parameter gradient, at 1e-5, on a batch whose rays come from three
    views (three times); denser nets, so that both penalties are on."""
    jcfg, tcfg, jspec, tspec, jparams, tparams = _setup(tmp_path, density_shift=1.0)
    j, _ = bkg_case._staged(bkg_case._Scene())
    batch = jsampler.sample_background_batch(jax.random.PRNGKey(5), j, jnp.arange(3), 64)
    assert len(np.unique(np.asarray(batch["viewf_list"]))) == 3
    keys = tuple(jax.random.split(jax.random.PRNGKey(6), 3))

    def total(p):
        c_rgb, c_emp, f_rgb, f_emp, _ = jbkg.bkg_loss_fn(p, jspec, batch, jcfg, 0.1, keys)
        return c_rgb + c_emp + f_rgb + f_emp, (c_rgb, c_emp, f_rgb, f_emp)

    (_, want), want_g = jax.value_and_grad(total, has_aux=True)(jparams)
    got = tbkg.bkg_loss_fn(tparams, tspec, bkg_case._torch_batch(batch), tcfg, 0.1)[:4]
    assert all(float(w) > 0 for w in want)
    bkg_case._close([x.detach().numpy() for x in got], [np.asarray(x) for x in want], "losses",
                    tol=TOL)
    named = tbkg.named_params(tparams)
    flat = [p for ps in named.values() for p in ps.values()]
    g = iter(torch.autograd.grad(sum(got), flat))
    got_g = bkg_case._port_tree({k: {n: next(g) for n in ps} for k, ps in named.items()})
    bkg_case._close(got_g, to_numpy(want_g), "grads", tol=TOL)


def test_three_steps_match_jax(tmp_path):
    """The train step under the ablation: every step's losses, then the
    parameters and Adam's moments and count, at 1e-5."""
    jcfg, tcfg, jspec, tspec, jparams, tparams = _setup(tmp_path)
    j, _ = bkg_case._staged(bkg_case._Scene())
    jstate, jmetrics, batches = bkg_case._jax_run(jcfg, jspec, jparams, j, 3)
    tstate, tmetrics = bkg_case._port_run(tcfg, tspec, tparams, batches)
    for jm, tm in zip(jmetrics, tmetrics):
        for k in ("coarse_rgb_loss", "fine_rgb_loss", "coarse_empty_space_loss",
                  "fine_empty_space_loss", "total_loss"):
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=TOL, atol=TOL, err_msg=k)
    bkg_case._assert_states_close(tstate, jstate)


def _psnr(a, b):
    return -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))


@pytest.mark.parametrize("view", [1, 3])
def test_render_vanilla_with_the_time_channel_matches_jax(tmp_path, view):
    """render_vanilla(ablate_nerft=True): the frame's time frame_id /
    total_frames as the fourth input; >= 40 dB and within 1e-5 of the JAX
    render_vanilla(ablate_nerft=True), and not the frame of another time."""
    # denser nets, so the picture is not all white
    _, _, jspec, tspec, jparams, tparams = _setup(tmp_path, seed=1, density_shift=2.0)
    cap = bkg_case._Scene().captures[view]
    kw = dict(rays_per_batch=64, samples_per_ray=8, importance_samples_per_ray=8)
    want = np.asarray(jrenderer.render_vanilla(jspec, jparams["coarse"], cap,
                                               fine_params=jparams["fine"], ablate_nerft=True,
                                               **kw))
    render = lambda c: trenderer.render_vanilla(
        tspec, tparams["coarse"].nerf, c, tparams["fine"].nerf, "cpu", ablate_nerft=True,
        **kw).numpy()
    got = render(cap)
    assert got.shape == want.shape == (bkg_case.H, bkg_case.W, 3) and want.std() > 1e-2
    assert _psnr(got, want) >= 40.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    cap.frame_id = {"frame_id": 0, "total_frames": bkg_case.VIEWS}
    assert np.abs(render(cap) - got).max() > 1e-3


def test_port_trains_and_validates(tmp_path):
    """train_background under the ablation: two steps with finite losses,
    three validations, each writing its PNG, and a checkpoint."""
    _, tcfg = bkg_case._configs(tmp_path, max_iter=2, valid_iter=1, **NERFT)
    trainer = ttrain.train_background(tcfg, bkg_case._Scene(), [0, 1, 2], [3], device="cpu")
    assert trainer.iteration == 2
    assert trainer.last_val_images == [f"{tcfg.out}/val_00000002.png"]
    for it in range(3):
        assert (tmp_path / "test" / f"val_{it:08d}.png").is_file()
    assert (tmp_path / "test" / "checkpoint.npz").is_file()
    assert np.isfinite(trainer.last_val_rgb.numpy()).all()


def test_jax_validate_raises_without_the_time_channel(tmp_path):
    """The JAX NeRFTrainer's validation calls render_vanilla without
    ablate_nerft (neuman_tpu/trainers/background.py:370), so its 4-D net
    gets a 3-D PE and the render raises; the port's validation passes the
    time channel instead (test_port_trains_and_validates)."""
    jcfg, _, jspec, _, jparams, _ = _setup(tmp_path)
    trainer = jbkg.NeRFTrainer(jcfg, jspec, jparams, bkg_case._Scene(), [0, 1, 2], [3])
    with pytest.raises(TypeError, match="dot_general"):
        trainer.validate()
