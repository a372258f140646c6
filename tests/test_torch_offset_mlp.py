"""The port's offset-net MLP (forward and backward) vs neuman_tpu.

`offset_mlp_plain`, `offset_mlp_bwd_plain` and the autograd Function
`offset_mlp_fn` against `make_offset_mlp_vjp(interpret=True)` and against
`fused.offset_net_planar`, on (x, y, z, t) planes at R=6 x S=16 with a
depth-4, width-64 net that has a skip after layer 1 (so the [PE, h] concat
and its fan-in are exercised). On the CPU the wrappers run the plain
versions; the CUDA kernels are held to those on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neuman_tpu.models import embedder as jemb
from neuman_tpu.models import nerf as jnerf
from neuman_tpu.ops import fused
from neuman_tpu.ops.pallas import raymarch_vjp
from neuman_tpu_torch.convert import joiner_state_dict, to_jax_params
from neuman_tpu_torch.models import embedder as temb
from neuman_tpu_torch.models import nerf as tnerf
from neuman_tpu_torch.ops.kernels import offset_mlp as koff
from tests.torch_parity import t, to_numpy

torch.set_num_threads(1)

R, S = 6, 16
# the JAX kernel-vs-oracle bar of tests/test_raymarch_vjp.py, as
# tests/test_torch_nerf_mlp_vjp.py holds the NeRF pair to
RTOL, ATOL = 2e-3, 2e-4
SCALE_TYPES = ["linear", "tanh", "no"]


def _specs(scale_type="linear"):
    def build(emb, nerf):
        pe = emb.make_embedder(4, 9, 10)
        return nerf.OffsetNetSpec(
            pos_pe=pe,
            nerf=nerf.NeRFSpec(depth=4, width=64, input_ch=pe.out_dim, input_ch_views=0,
                               output_ch=3, skips=(1,), use_viewdirs=False,
                               scale_type=scale_type))

    return build(jemb, jnerf), build(temb, tnerf)


@functools.lru_cache(maxsize=None)
def _case():
    """Weights, planes and cotangents from numpy seeds; the JAX values and
    gradients of the custom-VJP pair in interpret mode."""
    jspec, tspec = _specs()
    params = jnerf.init_nerf_params(jax.random.PRNGKey(0), jspec.nerf)
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(4, R, S)).astype(np.float32)
    axes[3] = 0.37  # the time plane is constant over a batch
    g = rng.normal(size=(3, R, S)).astype(np.float32)
    f = raymarch_vjp.make_offset_mlp_vjp(jspec, compute_dtype=jnp.float32, interpret=True)
    loss = lambda out: sum(jnp.sum(out[c] * g[c]) for c in range(3))
    jax_axes = [jnp.asarray(a) for a in axes]
    out = f(params, *jax_axes)
    grads = jax.grad(lambda p, ax: loss(f(p, *ax)), argnums=(0, 1))(params, jax_axes)
    return dict(jspec=jspec, tspec=tspec, jparams=params, params=to_numpy(params), axes=axes,
                g=g, out=to_numpy(out), grads=to_numpy(grads))


def _net(case, scale_type="linear"):
    net = tnerf.OffsetNet(_specs(scale_type)[1])
    net.load_state_dict(joiner_state_dict(case["params"]))
    return net


def _grads_tree(net, grads):
    """[(dW [out, in], db)] in net_layers order -> the JAX param tree."""
    by_param = {id(p): x for (w, b), gwb in zip(koff.net_layers(net), grads)
                for p, x in zip((w, b), gwb)}
    return to_jax_params({f"nerf.{n}": by_param[id(p)] for n, p in net.named_parameters()})


def _assert_trees_close(got, want, what, rtol=RTOL, atol=ATOL):
    fg, tg = jax.tree_util.tree_flatten(got)
    fw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw, what
    for i, (a, b) in enumerate(zip(fg, fw)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")


def _np(x):
    return x.detach().numpy()


def test_forward_matches_jax_kernel():
    """f32 values of the raw planes: 1e-4 (another order of the sums)."""
    case = _case()
    out = koff.offset_mlp(case["tspec"], _net(case).nerf, [t(a) for a in case["axes"]])
    assert len(out) == 3 and out[0].shape == (R, S)
    _assert_trees_close([_np(x) for x in out], case["out"], "raw planes", rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale_type", SCALE_TYPES)
def test_offset_net_forward_matches_offset_net_planar(scale_type):
    """OffsetNet.forward (scale modes applied) vs the XLA formulation."""
    case = _case()
    jspec = _specs(scale_type)[0]
    want = fused.offset_net_planar(jspec, case["jparams"], [jnp.asarray(a) for a in case["axes"]],
                                   jnp.float32(0.25), jnp.float32)
    net = _net(case, scale_type)
    got = net([t(a) for a in case["axes"]], torch.tensor(0.25))
    _assert_trees_close([_np(x) for x in got], to_numpy(want), scale_type, rtol=1e-4, atol=1e-4)


def test_bwd_plain_matches_jax_vjp():
    case = _case()
    net = _net(case).nerf
    grads, d_axes = koff.offset_mlp_bwd(case["tspec"], net, [t(a) for a in case["axes"]],
                                        [t(x) for x in case["g"]])
    jp, jaxes = case["grads"]
    _assert_trees_close(_grads_tree(net, grads), jp, "params")
    _assert_trees_close([_np(x) for x in d_axes], jaxes, "d_axes")


def test_autograd_function_matches_jax_grad():
    """offset_mlp_fn under torch.autograd: weights, biases and d_axes."""
    case = _case()
    net = _net(case).nerf
    axes = [t(a).requires_grad_(True) for a in case["axes"]]
    out = koff.offset_mlp_fn(case["tspec"], net, axes)
    g = t(case["g"])
    loss = sum((out[c] * g[c]).sum() for c in range(3))
    params = list(net.parameters())
    got = torch.autograd.grad(loss, params + axes)
    got_params = to_jax_params({f"nerf.{n}": x for (n, _), x in
                                zip(net.named_parameters(), got[:len(params)])})
    _assert_trees_close(got_params, case["grads"][0], "params")
    _assert_trees_close([_np(x) for x in got[len(params):]], case["grads"][1], "d_axes")


def test_autograd_function_skips_d_axes_not_asked_for():
    """In the train step the input planes need no gradient."""
    case = _case()
    net = _net(case).nerf
    axes = [t(a) for a in case["axes"]]
    axes[0].requires_grad_(True)
    out = koff.offset_mlp_fn(case["tspec"], net, axes)
    sum(o.sum() for o in out).backward()
    assert axes[0].grad is not None and axes[1].grad is None
    assert all(p.grad is not None for p in net.parameters())


def test_bwd_plain_matches_torch_autograd():
    """f32: the explicit backward is the gradient of offset_mlp_plain (1e-5)."""
    case = _case()
    net = _net(case).nerf
    axes = [t(a).requires_grad_(True) for a in case["axes"]]
    g = t(case["g"])
    out = koff.offset_mlp_plain(case["tspec"], net, axes)
    loss = sum((out[c] * g[c]).sum() for c in range(3))
    flat = [x for wb in koff.net_layers(net) for x in wb]
    auto = torch.autograd.grad(loss, flat + axes)
    grads, d_axes = koff.offset_mlp_bwd_plain(case["tspec"], net, [a.detach() for a in axes],
                                              list(g))
    got = [x for wb in grads for x in wb] + list(d_axes)
    for i, (a, b) in enumerate(zip(got, auto)):
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, b.abs().max().item()), rtol=0,
                                   msg=f"output {i}")


def test_bf16_matches_xla_bf16_formulation():
    """bf16 against `offset_net_planar` in bf16 (interpret mode promotes
    bf16 to f32, so the XLA formulation is the bf16 reference). Both round
    weights and activations to bf16 at the same points; values on a rounding
    boundary land on either side, so the raw planes agree in L2: 2e-2."""
    case = _case()
    jspec = _specs("no")[0]
    want = fused.offset_net_planar(jspec, case["jparams"], [jnp.asarray(a) for a in case["axes"]],
                                   1.0, jnp.bfloat16)
    got = koff.offset_mlp_plain(case["tspec"], _net(case).nerf, [t(a) for a in case["axes"]],
                                torch.bfloat16)
    a, b = np.stack([_np(x) for x in got]), np.stack(to_numpy(want)).astype(np.float32)
    assert np.isfinite(a).all()
    assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)


def test_bwd_plain_bf16_near_f32():
    """bf16 backward (every product on bf16 operands, cotangents included)
    against f32: flipped ReLU masks compound down the layers, as for the
    NeRF pair; 0.25 in L2 bounds it."""
    case = _case()
    net = _net(case).nerf
    args = (case["tspec"], net, [t(a) for a in case["axes"]], [t(x) for x in case["g"]])
    f32 = koff.offset_mlp_bwd_plain(*args)
    bf = koff.offset_mlp_bwd_plain(*args, compute_dtype=torch.bfloat16)
    flat = lambda out: [x for wb in out[0] for x in wb] + list(out[1])
    for i, (a, b) in enumerate(zip(flat(f32), flat(bf))):
        assert torch.isfinite(b).all(), f"output {i}"
        assert (a - b).norm() <= 0.25 * a.norm() + 1e-7, f"output {i}"


def test_wrappers_raise_off_cpu_and_cuda():
    case = _case()
    net = _net(case).nerf
    axes = [t(a).to("meta") for a in case["axes"]]
    with pytest.raises(ValueError, match="no kernel for device"):
        koff.offset_mlp(case["tspec"], net, axes)
    with pytest.raises(ValueError, match="no kernel for device"):
        koff.offset_mlp_bwd(case["tspec"], net, axes, axes[:3])
