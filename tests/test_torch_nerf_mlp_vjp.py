"""The port's NeRF MLP backward vs neuman_tpu's `make_mlp_vjp` (interpret mode).

Full width (8x256, skip after layer 4, PE 10 + 4 bands), R=8 x S=16, as
tests/test_raymarch_vjp.py runs the JAX pair. On the CPU `nerf_mlp_bwd`
runs `nerf_mlp_bwd_plain`; the CUDA kernel is held to that plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.models import embedder as jemb
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.ops.pallas import raymarch, raymarch_vjp
from neuman_tpu_torch.convert import joiner_state_dict, to_jax_params
from neuman_tpu_torch.models import embedder as temb
from neuman_tpu_torch.models import nerf as tnerf
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
from tests.torch_parity import t, to_numpy

torch.set_num_threads(1)

R, S = 8, 16
# the JAX kernel-vs-oracle bar of tests/test_raymarch_vjp.py
RTOL, ATOL = 2e-3, 2e-4
MODES = ["per_ray-posenc", "per_sample-posenc", "per_sample-rotate"]


def _specs(mapping):
    def build(emb, nerf):
        return nerf.JoinerSpec(
            pos_pe=emb.make_embedder(3, 9, 10, mapping=mapping),
            dir_pe=emb.make_embedder(3, 3, 4, mapping=mapping),
            nerf=nerf.NeRFSpec(depth=8, width=256, input_ch=63, input_ch_views=27,
                               skips=(4,), use_viewdirs=True),
        )

    return build(jemb, jnerf), build(temb, tnerf)


@functools.lru_cache(maxsize=None)
def _case(mode):
    """Weights, inputs and cotangents from numpy seeds, and the JAX
    gradients: w.r.t. (params, planes, dir_part or dir planes) of the bare
    custom-VJP pair, and per-ray also w.r.t. (params, planes, dirs) through
    `dir_projection`."""
    per_sample, mapping = mode.startswith("per_sample"), mode.split("-")[1]
    jspec, tspec = _specs(mapping)
    params = jnerf.init_nerf_params(jax.random.PRNGKey(0), jspec.nerf)
    rng = np.random.default_rng(0)
    planes = rng.normal(size=(3, R, S)).astype(np.float32)
    d = rng.normal(size=(R, S, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    g = rng.normal(size=(4, R, S)).astype(np.float32)
    f = raymarch_vjp.make_mlp_vjp(jspec, compute_dtype=jnp.float32, per_sample=per_sample,
                                  interpret=True)

    def loss(out):
        sigma, rgb = out
        return jnp.sum(sigma * g[0]) + sum(jnp.sum(rgb[c] * g[1 + c]) for c in range(3))

    jp = [jnp.asarray(p) for p in planes]
    if per_sample:
        dir_in = [jnp.asarray(d[..., a]) for a in range(3)]
        bare = jax.grad(lambda p, pl, di: loss(f(p, *pl, *di)), argnums=(0, 1, 2))(
            params, jp, dir_in)
        through = None
    else:
        dirs = jnp.asarray(d[:, 0, :])
        dirp = raymarch.dir_projection(jspec, params, dirs, jnp.float32)
        bare = jax.grad(lambda p, pl, dp: loss(f(p, *pl, dp)), argnums=(0, 1, 2))(
            params, jp, dirp)
        through = jax.grad(
            lambda p, pl, di: loss(f(p, *pl, raymarch.dir_projection(jspec, p, di, jnp.float32))),
            argnums=(0, 1, 2))(params, jp, dirs)
        dir_in = dirp
    return dict(per_sample=per_sample, tspec=tspec, params=to_numpy(params), planes=planes,
                d=d, g=g, dir_in=jax.tree_util.tree_map(np.asarray, dir_in),
                bare=to_numpy(bare), through=None if through is None else to_numpy(through))


def _joiner(case):
    joiner = tnerf.Joiner(case["tspec"])
    joiner.load_state_dict(joiner_state_dict(case["params"]))
    return joiner


def _grads_tree(net, grads):
    """[(dW [out, in], db)] in net_layers order -> the JAX param tree."""
    by_param = {id(p): x for (w, b), gwb in zip(kvjp.net_layers(net), grads)
                for p, x in zip((w, b), gwb)}
    return to_jax_params({f"nerf.{n}": by_param[id(p)] for n, p in net.named_parameters()})


def _assert_trees_close(got, want, what):
    fg, tg = jax.tree_util.tree_flatten(got)
    fw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw, what
    for i, (a, b) in enumerate(zip(fg, fw)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} leaf {i}")


def _np(x):
    return x.detach().numpy()


@pytest.mark.parametrize("mode", MODES)
def test_bwd_plain_matches_jax_vjp(mode):
    case = _case(mode)
    net = _joiner(case).nerf
    kw = ({"dir_planes": [t(x) for x in case["dir_in"]]} if case["per_sample"]
          else {"dir_part": t(case["dir_in"])})
    g = t(case["g"])
    grads, d_planes, d_dir = kvjp.nerf_mlp_bwd(case["tspec"], net, *map(t, case["planes"]),
                                               g[0], list(g[1:]), **kw)
    jp, jplanes, jdir = case["bare"]
    _assert_trees_close(_grads_tree(net, grads), jp, "params")
    _assert_trees_close([_np(x) for x in d_planes], jplanes, "planes")
    if case["per_sample"]:
        _assert_trees_close([_np(x) for x in d_dir], jdir, "dir planes")
    else:
        assert d_dir.shape == (R, 128)
        _assert_trees_close(_np(d_dir), jdir, "dir_part")


@pytest.mark.parametrize("mode", MODES)
def test_autograd_function_matches_jax_grad(mode):
    """nerf_mlp_fn under torch.autograd; per-ray through dir_projection, so
    the direction rows of views_linears[0] and the ray directions get their
    gradient from plain autograd, as in the JAX wrapper."""
    case = _case(mode)
    joiner = _joiner(case)
    net = joiner.nerf
    planes = [t(p).requires_grad_(True) for p in case["planes"]]
    if case["per_sample"]:
        dirs = [t(x).requires_grad_(True) for x in case["dir_in"]]
        kw, want = {"dir_planes": dirs}, case["bare"]
    else:
        dirs = [t(case["d"][:, 0, :]).requires_grad_(True)]
        kw = {"dir_part": kmlp.dir_projection(case["tspec"], net, dirs[0])}
        want = case["through"]
    sigma, rgb = kvjp.nerf_mlp_fn(case["tspec"], net, *planes, **kw)
    g = t(case["g"])
    loss = (sigma * g[0]).sum() + sum((rgb[c] * g[1 + c]).sum() for c in range(3))
    params = list(net.parameters())
    out = torch.autograd.grad(loss, params + planes + dirs)
    got_params = to_jax_params({f"nerf.{n}": x for (n, _), x in
                                zip(net.named_parameters(), out[:len(params)])})
    _assert_trees_close(got_params, want[0], "params")
    _assert_trees_close([_np(x) for x in out[len(params):len(params) + 3]], want[1], "planes")
    got_dirs = [_np(x) for x in out[len(params) + 3:]]
    _assert_trees_close(got_dirs if case["per_sample"] else got_dirs[0], want[2], "dirs")


@pytest.mark.parametrize("per_sample", [False, True], ids=["per_ray", "per_sample"])
def test_bwd_plain_matches_torch_autograd(per_sample):
    """f32: the explicit backward is the gradient of nerf_mlp_plain (1e-5)."""
    case = _case("per_sample-rotate" if per_sample else "per_ray-posenc")
    net = _joiner(case).nerf
    planes = [t(p).requires_grad_(True) for p in case["planes"]]
    if per_sample:
        dirs = [t(x).requires_grad_(True) for x in case["dir_in"]]
        kw = {"dir_planes": dirs}
    else:
        dirs = [t(case["dir_in"]).requires_grad_(True)]
        kw = {"dir_part": dirs[0]}
    g = t(case["g"])
    sigma, rgb = kmlp.nerf_mlp_plain(case["tspec"], net, *planes, **kw)
    loss = (sigma * g[0]).sum() + sum((rgb[c] * g[1 + c]).sum() for c in range(3))
    layers = kvjp.net_layers(net)
    flat = [x for wb in layers for x in wb]
    auto = torch.autograd.grad(loss, flat + planes + dirs)
    grads, d_planes, d_dir = kvjp.nerf_mlp_bwd_plain(
        case["tspec"], net, *[p.detach() for p in planes], g[0], list(g[1:]),
        **{k: ([x.detach() for x in v] if isinstance(v, list) else v.detach())
           for k, v in kw.items()})
    got = [x for wb in grads for x in wb] + list(d_planes) + (
        list(d_dir) if per_sample else [d_dir])
    width = case["tspec"].nerf.width
    for i, (a, b) in enumerate(zip(got, auto)):
        if not per_sample and i == 2 * (len(layers) - 2):  # views weight
            # per-ray: its direction columns get their gradient outside
            assert torch.equal(a[:, width:], torch.zeros_like(a[:, width:]))
            a, b = a[:, :width], b[:, :width]
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0,
                                   msg=f"output {i}")


@pytest.mark.parametrize("mode", MODES)
def test_bwd_plain_bf16_near_f32(mode):
    """bf16 (every product on bf16 operands, cotangents included) against
    f32: each ReLU mask that the bf16 rounding flips moves a whole sample's
    term, and the flips compound down the 8 layers, so the gradients agree
    to ~4-13% in L2 (measured at this size); 0.25 bounds it."""
    case = _case(mode)
    net = _joiner(case).nerf
    kw = ({"dir_planes": [t(x) for x in case["dir_in"]]} if case["per_sample"]
          else {"dir_part": t(case["dir_in"])})
    g = t(case["g"])
    args = (case["tspec"], net, *map(t, case["planes"]), g[0], list(g[1:]))
    f32 = kvjp.nerf_mlp_bwd_plain(*args, **kw)
    bf = kvjp.nerf_mlp_bwd_plain(*args, **kw, compute_dtype=torch.bfloat16)
    flat = lambda out: [x for wb in out[0] for x in wb] + list(out[1])
    for i, (a, b) in enumerate(zip(flat(f32), flat(bf))):
        assert torch.isfinite(b).all(), f"output {i}"
        assert (a - b).norm() <= 0.25 * a.norm() + 1e-7, f"output {i}"
