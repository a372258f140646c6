"""The `mlp_tape="hbm"` configuration of the port's fused MLPs vs neuman_tpu.

The forward writes the post-ReLU output of every trunk layer to a tape
[R*S, depth*W] (the JAX tape is its transpose, [depth*W, R*S]) and the
backward reads it instead of recomputing the trunk. Checked here, on the CPU
(the wrappers run the plain versions; the CUDA kernels are held to those on
the card, tests/test_torch_cuda.py and chip_smoke.py): the tape against
`nerf_mlp_pallas(emit_tape=True, interpret=True)`, the gradients against
`make_mlp_vjp` / `make_offset_mlp_vjp(tape_mode="hbm", interpret=True)` at
the bars of test_torch_nerf_mlp_vjp.py and test_torch_offset_mlp.py, "hbm"
bit-equal to "recompute" inside the port, and both trainers' losses with
`mlp_tape="hbm"` against the JAX trainers' with the same setting. R=8 x S=16
is a shape the JAX kernels do not pad (they drop the tape when they pad).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.datasets import sampler as jsampler
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.ops.pallas import raymarch, raymarch_vjp
from neuman_tpu.trainers import background as jbkg
from neuman_tpu.trainers import human as jhuman
from neuman_tpu_torch.models import nerf as tnerf
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
from neuman_tpu_torch.ops.kernels import offset_mlp as koff
from neuman_tpu_torch.options.config import NeuManConfig
from neuman_tpu_torch.trainers import background as tbkg
from neuman_tpu_torch.trainers import human as thuman
from tests import test_torch_bkg_train as bkg_case
from tests import test_torch_human_train as human_case
from tests import test_torch_nerf_mlp_vjp as mlp_case
from tests import test_torch_offset_mlp as offset_case
from tests.torch_parity import t, to_numpy

torch.set_num_threads(1)

R, S = mlp_case.R, mlp_case.S
MODES = ["per_ray-posenc", "per_sample-rotate"]


def _mlp_inputs(mode):
    case = mlp_case._case(mode)
    net = mlp_case._joiner(case).nerf
    kw = ({"dir_planes": [t(x) for x in case["dir_in"]]} if case["per_sample"]
          else {"dir_part": t(case["dir_in"])})
    return case, net, [t(p) for p in case["planes"]], kw


@pytest.mark.parametrize("mode", MODES)
def test_tape_matches_jax_kernel(mode):
    """Outputs and tape of the tape-writing forward, 1e-5 (f32 on both
    sides; another order of the sums)."""
    case, net, planes, kw = _mlp_inputs(mode)
    jspec = mlp_case._specs(mode.split("-")[1])[0]
    jplanes = [jnp.asarray(p) for p in case["planes"]]
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    if case["per_sample"]:
        jkw = dict(dir_part=None, dir_planes=tuple(jnp.asarray(x) for x in case["dir_in"]))
    else:
        jkw = dict(dir_part=jnp.asarray(case["dir_in"]))
    dir_part = jkw.pop("dir_part")
    (jsigma, jrgb), jtape = raymarch.nerf_mlp_pallas(
        jspec, params, *jplanes, dir_part, jnp.float32, interpret=True, emit_tape=True, **jkw)
    assert jtape is not None and jtape.shape == (8 * 256, R * S)
    (sigma, rgb), tape = kmlp.nerf_mlp(case["tspec"], net, *planes, emit_tape=True, **kw)
    assert tape.shape == (R * S, 8 * 256) and tape.dtype == torch.float32
    np.testing.assert_allclose(tape.numpy(), np.asarray(jtape).T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sigma.detach().numpy(), np.asarray(jsigma), rtol=0, atol=1e-4)
    assert (tape >= 0).all() and (tape > 0).float().mean() > 0.1
    # the tape-less call returns the same outputs, and no tape
    sigma2, rgb2 = kmlp.nerf_mlp(case["tspec"], net, *planes, **kw)
    assert torch.equal(sigma, sigma2) and all(torch.equal(a, b) for a, b in zip(rgb, rgb2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_bwd_with_tape_is_bit_equal_to_recompute(mode, dtype):
    case, net, planes, kw = _mlp_inputs(mode)
    g = t(case["g"])
    _, tape = kmlp.nerf_mlp(case["tspec"], net, *planes, compute_dtype=dtype, emit_tape=True, **kw)
    assert tape.dtype == dtype
    run = lambda tape: kvjp.nerf_mlp_bwd(case["tspec"], net, *planes, g[0], list(g[1:]),
                                         compute_dtype=dtype, tape=tape, **kw)
    flat = lambda out: [x for wb in out[0] for x in wb] + list(out[1]) + (
        list(out[2]) if isinstance(out[2], list) else [out[2]])
    for i, (a, b) in enumerate(zip(flat(run(tape)), flat(run(None)))):
        assert torch.equal(a, b), f"output {i}"


@functools.lru_cache(maxsize=None)
def _jax_hbm_grads(mode):
    """Gradients of the JAX custom-VJP pair with tape_mode="hbm"."""
    case = mlp_case._case(mode)
    jspec = mlp_case._specs(mode.split("-")[1])[0]
    f = raymarch_vjp.make_mlp_vjp(jspec, compute_dtype=jnp.float32,
                                  per_sample=case["per_sample"], interpret=True, tape_mode="hbm")
    g = case["g"]

    def loss(out):
        sigma, rgb = out
        return jnp.sum(sigma * g[0]) + sum(jnp.sum(rgb[c] * g[1 + c]) for c in range(3))

    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    jp = [jnp.asarray(p) for p in case["planes"]]
    dir_in = jax.tree_util.tree_map(jnp.asarray, case["dir_in"])
    if case["per_sample"]:
        fn = lambda p, pl, di: loss(f(p, *pl, *di))
    else:
        fn = lambda p, pl, dp: loss(f(p, *pl, dp))
    return to_numpy(jax.grad(fn, argnums=(0, 1, 2))(params, jp, dir_in))


@pytest.mark.parametrize("mode", MODES)
def test_function_hbm_matches_jax_hbm_and_recompute(mode):
    """nerf_mlp_fn(tape_mode="hbm") against jax.grad through
    make_mlp_vjp(tape_mode="hbm") at 2e-3 / 2e-4 (the JAX kernel-vs-oracle
    bar), and bit-equal to tape_mode="recompute"."""
    case, net, _, _ = _mlp_inputs(mode)
    want = _jax_hbm_grads(mode)
    outs = {}
    for tape_mode in ("hbm", "recompute"):
        planes = [t(p).requires_grad_(True) for p in case["planes"]]
        if case["per_sample"]:
            dirs = [t(x).requires_grad_(True) for x in case["dir_in"]]
            kw = {"dir_planes": dirs}
        else:
            dirs = [t(case["dir_in"]).requires_grad_(True)]
            kw = {"dir_part": dirs[0]}
        sigma, rgb = kvjp.nerf_mlp_fn(case["tspec"], net, *planes, tape_mode=tape_mode, **kw)
        g = t(case["g"])
        loss = (sigma * g[0]).sum() + sum((rgb[c] * g[1 + c]).sum() for c in range(3))
        outs[tape_mode] = torch.autograd.grad(loss, list(net.parameters()) + planes + dirs)
    for i, (a, b) in enumerate(zip(outs["hbm"], outs["recompute"])):
        assert torch.equal(a, b), f"output {i}"
    n = len(list(net.parameters()))
    got = outs["hbm"]
    got_params = mlp_case.to_jax_params({f"nerf.{name}": x for (name, _), x in
                                         zip(net.named_parameters(), got[:n])})
    if not case["per_sample"]:
        # dir_part is a leaf here: the direction rows of the views weight
        # get their gradient outside the pair, in both packages
        w = case["tspec"].nerf.width
        for tree in (got_params, want[0]):
            tree["views_linears"][0]["w"] = np.asarray(tree["views_linears"][0]["w"])[:w]
    mlp_case._assert_trees_close(got_params, want[0], "params")
    mlp_case._assert_trees_close([x.numpy() for x in got[n:n + 3]], want[1], "planes")
    got_dirs = [x.numpy() for x in got[n + 3:]]
    mlp_case._assert_trees_close(got_dirs if case["per_sample"] else got_dirs[0], want[2], "dirs")


def test_no_tape_without_grad(monkeypatch):
    """Under torch.no_grad(), or when nothing asks for a gradient, the
    Functions run the tape-less forward."""
    case, net, planes, kw = _mlp_inputs("per_ray-posenc")
    seen = []
    real = kmlp.nerf_mlp
    monkeypatch.setattr(kvjp.kmlp, "nerf_mlp",
                        lambda *a, **k: seen.append(k["emit_tape"]) or real(*a, **k))
    with torch.no_grad():
        kvjp.nerf_mlp_fn(case["tspec"], net, *planes, tape_mode="hbm", **kw)
    kvjp.nerf_mlp_fn(case["tspec"], net, *planes, tape_mode="hbm", **kw)
    net.requires_grad_(False)
    kvjp.nerf_mlp_fn(case["tspec"], net, *planes, tape_mode="hbm", **kw)
    net.requires_grad_(True)
    kvjp.nerf_mlp_fn(case["tspec"], net, *planes, tape_mode="recompute", **kw)
    assert seen == [False, True, False, False]
    with pytest.raises(ValueError):
        kvjp.nerf_mlp_fn(case["tspec"], net, *planes, tape_mode="vmem", **kw)
    with pytest.raises(ValueError):
        NeuManConfig(mlp_tape="vmem").finalize()
    assert NeuManConfig().mlp_tape == "recompute"


# ---------------------------------------------------------------- offset net

@functools.lru_cache(maxsize=None)
def _offset_case():
    """The offset net of test_torch_offset_mlp.py on R=8 x S=16 planes (its
    own R=6 makes the JAX kernel pad, which drops the tape), with the JAX
    gradients of the pair in tape_mode="hbm"."""
    base = offset_case._case()
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(4, R, S)).astype(np.float32)
    axes[3] = 0.37
    g = rng.normal(size=(3, R, S)).astype(np.float32)
    f = raymarch_vjp.make_offset_mlp_vjp(base["jspec"], compute_dtype=jnp.float32,
                                         interpret=True, tape_mode="hbm")
    loss = lambda out: sum(jnp.sum(out[c] * g[c]) for c in range(3))
    jax_axes = [jnp.asarray(a) for a in axes]
    _, jtape = raymarch_vjp._offset_fwd_impl(
        base["jspec"], base["jparams"], tuple(jax_axes), jnp.float32, 8, True, emit_tape=True)
    grads = jax.grad(lambda p, ax: loss(f(p, *ax)), argnums=(0, 1))(base["jparams"], jax_axes)
    return dict(base, axes=axes, g=g, grads=to_numpy(grads), jtape=np.asarray(jtape))


def test_offset_tape_and_gradients_match_jax_hbm():
    case = _offset_case()
    net = offset_case._net(case).nerf
    axes = [t(a).requires_grad_(True) for a in case["axes"]]
    _, tape = koff.offset_mlp(case["tspec"], net, [a.detach() for a in axes], emit_tape=True)
    assert case["jtape"].shape == (4 * 64, R * S)
    np.testing.assert_allclose(tape.numpy(), case["jtape"].T, rtol=0, atol=1e-5)
    outs = {}
    for tape_mode in ("hbm", "recompute"):
        out = koff.offset_mlp_fn(case["tspec"], net, axes, tape_mode=tape_mode)
        loss = sum((o * t(g)).sum() for o, g in zip(out, case["g"]))
        outs[tape_mode] = torch.autograd.grad(loss, list(net.parameters()) + axes)
    for i, (a, b) in enumerate(zip(outs["hbm"], outs["recompute"])):
        assert torch.equal(a, b), f"output {i}"
    n = len(list(net.parameters()))
    got_params = offset_case.to_jax_params({f"nerf.{name}": x for (name, _), x in
                                            zip(net.named_parameters(), outs["hbm"][:n])})
    offset_case._assert_trees_close(got_params, case["grads"][0], "params")
    offset_case._assert_trees_close([x.numpy() for x in outs["hbm"][n:]], case["grads"][1], "axes")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_offset_bwd_with_tape_is_bit_equal_to_recompute(dtype):
    case = _offset_case()
    net = offset_case._net(case).nerf
    axes, g = [t(a) for a in case["axes"]], [t(x) for x in case["g"]]
    _, tape = koff.offset_mlp(case["tspec"], net, axes, dtype, emit_tape=True)
    assert tape.dtype == dtype and tape.shape == (R * S, 4 * 64)
    flat = lambda out: [x for wb in out[0] for x in wb] + list(out[1])
    got = flat(koff.offset_mlp_bwd(case["tspec"], net, axes, g, dtype, tape=tape))
    want = flat(koff.offset_mlp_bwd(case["tspec"], net, axes, g, dtype))
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"output {i}"


# ------------------------------------------------------------- the trainers

def test_bkg_loss_fn_hbm_matches_jax_hbm(tmp_path):
    """`bkg_loss_fn` with mlp_tape="hbm" against the JAX loss with the same
    setting on its Pallas path (interpret mode), losses and gradients at
    1e-5, and bit-equal to the port's recompute configuration."""
    jcfg, tcfg = bkg_case._configs(tmp_path, use_pallas=True, mlp_tape="hbm")
    jspec, tspec = jnerf.build_nerf_specs(jcfg), tnerf.build_nerf_specs(tcfg)
    jparams, tparams = bkg_case._nets(jspec, tspec)
    j, _ = bkg_case._staged(bkg_case._Scene())
    batch = jsampler.sample_background_batch(jax.random.PRNGKey(5), j, jnp.arange(3), 64)
    keys = tuple(jax.random.split(jax.random.PRNGKey(6), 3))

    def total(p):
        c_rgb, c_emp, f_rgb, f_emp, _ = jbkg.bkg_loss_fn(p, jspec, batch, jcfg, 0.1, keys)
        return c_rgb + c_emp + f_rgb + f_emp, (c_rgb, c_emp, f_rgb, f_emp)

    (_, want), want_g = jax.value_and_grad(total, has_aux=True)(jparams)
    named = tbkg.named_params(tparams)
    flat = [p for ps in named.values() for p in ps.values()]
    grads = {}
    for tape in ("hbm", "recompute"):
        tcfg.mlp_tape = tape
        got = tbkg.bkg_loss_fn(tparams, tspec, bkg_case._torch_batch(batch), tcfg, 0.1)[:4]
        grads[tape] = torch.autograd.grad(sum(got), flat)
    assert all(torch.equal(a, b) for a, b in zip(grads["hbm"], grads["recompute"]))
    bkg_case._close([x.detach().numpy() for x in got], [np.asarray(x) for x in want], "losses")
    g = iter(grads["hbm"])
    got_g = bkg_case._port_tree({k: {n: next(g) for n in ps} for k, ps in named.items()})
    bkg_case._close(got_g, to_numpy(want_g), "grads")


def test_human_loss_hbm_matches_jax_hbm():
    """The human loss with mlp_tape="hbm" against the JAX loss with the
    same setting on its Pallas path (interpret mode) at the bars of
    test_torch_human_train.py (losses 1e-5, gradients 1e-2 of a leaf's
    largest element, 2e-2 for the poses: see there), and its gradients
    bit-equal to the port's recompute configuration."""
    jcfg, tcfg = human_case._configs(use_pallas=True, mlp_tape="hbm")
    spec, params, ctx = human_case._jax_side(jcfg)
    fn = jhuman.make_human_loss_fn(spec, jcfg, ctx, parity_inject=human_case._inject())
    keys = {n: jax.random.PRNGKey(0) for n in ("perturb", "offset", "color", "dummy", "can_cam",
                                               "can_pix", "can_perturb")}
    batch = jax.tree_util.tree_map(jnp.asarray, human_case._batches()[0])
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        params, batch, keys, human_case._jax_anneals(jcfg, 30000))
    jaux, jgrads = to_numpy(jaux), to_numpy(jgrads)
    model, tctx = human_case._torch_side(tcfg, to_numpy(params), to_numpy(ctx["lpips_params"]))
    model.coarse_bkg_net.requires_grad_(False)
    model.fine_bkg_net.requires_grad_(False)
    got = {}
    for tape in ("hbm", "recompute"):
        tcfg.mlp_tape = tape
        tfn = thuman.make_human_loss_fn(model, tcfg, tctx, parity_inject=human_case._inject())
        total, aux = tfn(human_case._torch_batch(human_case._batches()[0]),
                         torch.Generator().manual_seed(0), thuman.compute_anneals(tcfg, 30000))
        got[tape] = (aux, human_case._model_grads(model, total))
    for a, b in zip(jax.tree_util.tree_leaves(got["hbm"][1]),
                    jax.tree_util.tree_leaves(got["recompute"][1])):
        assert np.array_equal(a, b)
    aux, grads = got["hbm"]
    for name in thuman.LOSS_NAMES + ["total_loss"]:
        np.testing.assert_allclose(float(aux["losses"][name].detach()),
                                   float(jaux["losses"][name]), rtol=human_case.LOSS_RTOL,
                                   atol=1e-8, err_msg=name)
    for key in ("coarse_human_net", "offset_nets", "poses"):
        rel = 2e-2 if key == "poses" else 1e-2
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(grads[key]),
                                       jax.tree_util.tree_leaves(jgrads[key]))):
            np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-12),
                                       err_msg=f"{key} leaf {i}")
