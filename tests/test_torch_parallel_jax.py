"""The port's data-parallel train steps against the JAX package's steps, on
the CPU.

Three gloo ranks, spawned once for the module (the rendezvous a file under
tmp_path, one torch thread each, a join timeout that kills the ranks), run
the port's background and human train steps with a mesh on the batches the
JAX package draws, handed over as numpy, the human step with its other
draws pinned by `parity_inject` (tests/test_torch_human_train.py). The
JAX steps on the same inputs in this process are the reference. Three
ranks: the human batch's 1056 rays give 352 a rank, so the 32x32 LPIPS
patch (rays 0-1023) spans all three ranks, and the sparsity term's 128
canonical rays do not split over them.

The ranks import this module: its JAX helpers are imported in the fixture
alone, so that the ranks run the port without JAX.
"""

import numpy as np
import pytest
import torch

from neuman_tpu_torch import convert
from neuman_tpu_torch.datasets import arrays as tarrays
from neuman_tpu_torch.models import human_nerf as thn
from neuman_tpu_torch.models import lpips as tlpips
from neuman_tpu_torch.models import nerf as tnerf
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.ops import mesh as tmesh
from neuman_tpu_torch.parallel import dryrun
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.trainers import background as tbkg
from neuman_tpu_torch.trainers import human as thuman
from neuman_tpu_torch.utils.constants import PATCH_SIZE_SQUARED

torch.set_num_threads(1)

WORLD, STEPS = 3, 2
SPAWN_TIMEOUT_S = 300.0
BKG_RAYS = 96  # 32 a rank
# the JAX package's sharded-vs-unsharded bars (tests/test_parallel.py)
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5


def _tensors(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _bkg_rank(tcfg, jparams, batches):
    """The port's background step with this rank's mesh on the JAX
    batches, from the JAX weights: each step's metrics, the parameters
    and Adam's state after the steps."""
    mesh = pmesh.resolve_mesh(tcfg)
    spec = tnerf.build_nerf_specs(tcfg)
    params = {}
    for k, p in jparams.items():
        params[k] = tnerf.Joiner(spec)
        params[k].load_state_dict(convert.joiner_state_dict(p))
    opt = tbkg.make_optimizer()
    state = {"params": params, "opt_state": opt.init(tbkg.named_params(params)),
             "iteration": 0, "generator": torch.Generator().manual_seed(tcfg.seed),
             "init_generator": torch.Generator().manual_seed(tcfg.seed + 1)}
    step = tbkg.make_bkg_train_step(spec, tcfg, opt, mesh=mesh)
    metrics = []
    for b in batches:
        state, m = step(state, _tensors(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {k: {n: p.detach().clone() for n, p in net.state_dict().items()}
                       for k, net in params.items()},
            "count": int(state["opt_state"]["count"])}


def _human_rank(tcfg, side, batches, inject):
    """The port's human step with this rank's mesh on the JAX batches and
    pinned draws, from the JAX weights (side: the body model's, SMPL
    state's and LPIPS weights' arrays): each step's metrics, the gradients
    step 1 updated with (state_dict names) and the state_dict after the
    steps."""
    mesh = pmesh.resolve_mesh(tcfg)
    body = tsmpl.SMPLModel.from_numpy(*side["body"])
    views, h, w, nv = side["shape"]
    arrays = tarrays.synthetic_arrays(views, h, w, num_verts=nv, device="cpu")
    model = thn.HumanNeRF(thn.build_human_nerf_spec(tcfg), **side["smpl"])
    model.load_state_dict(convert.from_jax_params(side["params"]))
    ctx = {
        "body_model": body, "da_smpl": thn.da_pose_params(24), "scale": 1.0,
        "topo": tmesh.MeshTopology.build(body.faces, body.num_verts),
        "can_verts": arrays.verts, "can_k": arrays.intrinsics[:2], "can_c2w": arrays.c2w[:2],
        "can_hw": (h, w), "interval_comp": side["interval_comp"],
        "lpips_params": tlpips.lpips_params_from_jax(side["lpips"]),
        "scene_ids": torch.arange(views), "grad_masks": torch.ones(views, 72),
        "knn_k": side["knn_k"], "knn_stride": tcfg.knn_stride,
    }
    optimizer = thuman.make_optimizer()
    recorded, update = [], optimizer.step

    def recording(named, grads, *args, **kwargs):
        if not recorded:
            recorded.append({thuman._full_name(k, n): g.detach().clone()
                             for k, gs in grads.items() for n, g in gs.items()})
        return update(named, grads, *args, **kwargs)

    optimizer.step = recording
    state = {"opt_state": optimizer.init(thuman.trained_params(model)), "iteration": 0,
             "generator": torch.Generator().manual_seed(0),
             "init_generator": torch.Generator().manual_seed(1)}
    step = thuman.make_human_train_step(model, tcfg, optimizer, ctx, parity_inject=inject,
                                        mesh=mesh)
    metrics = []
    for b in batches:
        as_t = {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
        as_t["cap_id"] = as_t["cap_id"].long()
        state, m = step(state, as_t)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": recorded[0],
            "state_dict": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def _rank_work(bkg_args, human_args):
    return {"bkg": _bkg_rank(*bkg_args), "human": _human_rank(*human_args)}


def _jax_bkg(tmp):
    """The JAX background step STEPS times: (the port's config, the JAX
    weights and batches as numpy, its metrics and final state)."""
    from tests import test_torch_bkg_train as bkg_case
    from tests.torch_parity import to_numpy
    from neuman_tpu.models import nerf as jnerf

    jcfg, tcfg = bkg_case._configs(tmp, rays_per_batch=BKG_RAYS)
    jspec = jnerf.build_nerf_specs(jcfg)
    jparams, _ = bkg_case._nets(jspec, tnerf.build_nerf_specs(tcfg))
    j, _ = bkg_case._staged(bkg_case._Scene())
    jstate, jmetrics, batches = bkg_case._jax_run(jcfg, jspec, jparams, j, STEPS)
    return ((tcfg, to_numpy(jparams), [to_numpy(b) for b in batches]),
            {"metrics": jmetrics, "params": to_numpy(jstate["params"]),
             "count": int(jstate["opt_state"][0].count), "rays": len(batches[0]["origin"])})


def _jax_human(out_dir):
    """The JAX human update STEPS times on the pinned batches, written out
    as in tests/test_torch_human_train.py (value_and_grad of the loss with
    parity_inject, optax Adam, the trainable mask times the learning
    rates): (the ranks' arguments, each step's losses, the step-1
    gradients and the final parameters)."""
    import jax
    import jax.numpy as jnp
    import optax
    from neuman_tpu.trainers import human as jhuman
    from neuman_tpu.trainers.background import make_optimizer as jax_make_optimizer
    from tests import test_torch_human_train as human_case
    from tests.torch_parity import to_numpy

    jcfg, tcfg = human_case._configs(out_dir)
    spec, params, ctx = human_case._jax_side(jcfg)
    jbody, _, smpl, _, _ = human_case._scene()
    side = {"body": [np.asarray(a) for a in (jbody.v_template, jbody.shapedirs,
                                             jbody.J_regressor, jbody.lbs_weights)]
            + [np.asarray(jbody.parents), np.asarray(jbody.faces)],
            "shape": (human_case.VIEWS, human_case.H, human_case.W, human_case.NUM_VERTS),
            "smpl": smpl, "params": to_numpy(params), "lpips": to_numpy(ctx["lpips_params"]),
            "interval_comp": ctx["interval_comp"], "knn_k": ctx["knn_k"]}
    batches = human_case._batches()[:STEPS]
    inject = human_case._inject()
    optimizer = jax_make_optimizer()
    opt_state = optimizer.init(params)
    vg = jax.jit(jax.value_and_grad(
        jhuman.make_human_loss_fn(spec, jcfg, ctx, parity_inject=inject), has_aux=True))
    keys = {n: jax.random.PRNGKey(0) for n in ("perturb", "offset", "color", "dummy", "can_cam",
                                               "can_pix", "can_perturb")}
    losses, first_grads = [], None
    for it, b in enumerate(batches):
        anneals = jhuman.compute_anneals(jcfg, jnp.int32(it))
        (total, aux), grads = vg(params, jax.tree_util.tree_map(jnp.asarray, b), keys, anneals)
        assert not bool(aux["dead"]) and not bool(jnp.isnan(total))
        grads["poses"] = grads["poses"] * ctx["grad_masks"]
        first_grads = first_grads or to_numpy(grads)
        losses.append({**{k: float(v) for k, v in aux["losses"].items()},
                       "total_loss": float(total), "lr": float(anneals["lr"])})
        updates, opt_state = optimizer.update(grads, opt_state, params)
        mask = jhuman.trainable_mask(params, jcfg.train_mode)
        lrs = jhuman.lr_tree(params, anneals)
        updates = jax.tree_util.tree_map(lambda u, m, lr: u * m * lr, updates, mask, lrs)
        params = optax.apply_updates(params, updates)
    return ((tcfg, side, batches, inject),
            {"metrics": losses, "grads": first_grads, "params": to_numpy(params),
             "rays": len(batches[0]["origin"])})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({"bkg", "human"}: each rank's results, {"bkg", "human"}: the JAX
    reference)."""
    root = tmp_path_factory.mktemp("parallel_jax")
    bkg_args, bkg_ref = _jax_bkg(root)
    human_args, human_ref = _jax_human(root)
    ranks = dryrun.spawn_ranks(WORLD, _rank_work, (bkg_args, human_args),
                               timeout_s=SPAWN_TIMEOUT_S, workdir=str(root))
    return ranks, {"bkg": bkg_ref, "human": human_ref}


BKG_LOSSES = ("coarse_rgb_loss", "fine_rgb_loss", "coarse_empty_space_loss",
              "fine_empty_space_loss", "total_loss")
HUMAN_PARAMS = ("coarse_human_net", "offset_nets", "poses", "betas", "coarse_bkg_net")
HUMAN_GRADS = ("coarse_human_net", "offset_nets", "poses")
# the human step across the two packages (measured on these batches): the
# step-1 gradients differ by last bits summed over ~34k samples (<= 4.3e-4
# of a leaf's largest element, poses; 2.2e-4 canonical net), and Adam's
# first steps move an element by ~lr whatever its gradient's size, which
# magnifies them where a gradient is near 0: after 2 steps 4 of 25,939
# elements are more than 1e-5 apart, the worst 3.1e-5 (lr 5e-4). Losses
# 3.4e-5 relative at most. The bars:
HUMAN_GRAD_REL = 5e-3  # of the leaf's largest element
HUMAN_PARAM_ATOL_ALL = 1e-4  # every element
HUMAN_PARAM_SHARE = 1e-3  # the share of elements over PARAM_ATOL


def _leaves(tree):
    """A param tree's leaves in the JAX package's order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def _ranks_equal(ranks, kind, key):
    """Every rank's `key` tensors (a state_dict, or one per net) equal to
    rank 0's."""
    flat = lambda d: dict(_flatten(d))
    r0 = flat(ranks[0][kind][key])
    return all(torch.equal(flat(r[kind][key])[k], v) for r in ranks[1:] for k, v in r0.items())


def _flatten(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_bkg_steps_on_three_ranks_match_jax(runs):
    """Each step's losses within rtol 1e-4 and every parameter within atol
    1e-5 of the JAX step's on the same batches (measured: losses 1.2e-6
    relative, parameters 1.6e-6 apart); the ranks' parameters equal."""
    ranks, ref = runs
    got, want = ranks[0]["bkg"], ref["bkg"]
    assert len(got["metrics"]) == len(want["metrics"]) == STEPS
    for gm, jm in zip(got["metrics"], want["metrics"]):
        assert jm["coarse_empty_space_loss"] > 0
        for k in BKG_LOSSES:
            np.testing.assert_allclose(gm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    assert got["count"] == want["count"] == STEPS
    for k in ("coarse", "fine"):
        for a, w in zip(_leaves(convert.to_jax_params(got["params"][k])),
                        _leaves(want["params"][k])):
            np.testing.assert_allclose(a, w, rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert _ranks_equal(ranks, "bkg", "params")


def test_human_steps_on_three_ranks_match_jax(runs):
    """Each step's losses, the perceptual one over the patch that spans the
    three ranks and the sparsity term over 128 canonical rays included,
    within rtol 1e-4 of the JAX update's on the same batches and draws; the
    step-1 gradients within HUMAN_GRAD_REL of each leaf's largest element;
    every parameter after 2 steps within HUMAN_PARAM_ATOL_ALL, and at most
    HUMAN_PARAM_SHARE of them over 1e-5; the ranks' parameters equal."""
    ranks, ref = runs
    got, want = ranks[0]["human"], ref["human"]
    assert len(got["metrics"]) == len(want["metrics"]) == STEPS
    assert want["metrics"][0]["lpips_loss"] > 0  # batch 1 has its patch
    for gm, jm in zip(got["metrics"], want["metrics"]):
        assert jm["sparsity_reg"] > 0
        for k in thuman.LOSS_NAMES + ["total_loss"]:
            np.testing.assert_allclose(gm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    sd = {n: torch.zeros_like(v) for n, v in got["state_dict"].items()}
    sd.update(got["grads"])
    grads = convert.to_jax_params(sd)
    for key in HUMAN_GRADS:
        for i, (a, w) in enumerate(zip(_leaves(grads[key]), _leaves(want["grads"][key]))):
            assert np.abs(w).max() > 0, f"{key} leaf {i}"
            np.testing.assert_allclose(a, w, rtol=0, atol=HUMAN_GRAD_REL * np.abs(w).max(),
                                       err_msg=f"{key} leaf {i}")
    params = convert.to_jax_params(got["state_dict"])
    over = total = 0
    for key in HUMAN_PARAMS:
        for i, (a, w) in enumerate(zip(_leaves(params[key]), _leaves(want["params"][key]))):
            np.testing.assert_allclose(a, w, rtol=0, atol=HUMAN_PARAM_ATOL_ALL,
                                       err_msg=f"{key} leaf {i}")
            over += int((np.abs(a - w) > PARAM_ATOL).sum())
            total += a.size
    assert over <= HUMAN_PARAM_SHARE * total, (over, total)
    assert _ranks_equal(ranks, "human", "state_dict")


def test_the_patch_and_the_canonical_rays_span_the_ranks(runs):
    """What the three ranks exercise: the human batch's LPIPS patch spans
    every rank's rows, the 128 canonical rays do not split over the ranks,
    and both batches split into equal blocks."""
    _, ref = runs
    human_rays, bkg_rays = ref["human"]["rays"], ref["bkg"]["rays"]
    assert human_rays % WORLD == 0 and bkg_rays == BKG_RAYS and bkg_rays % WORLD == 0
    assert (WORLD - 1) * human_rays // WORLD < PATCH_SIZE_SQUARED < human_rays
    assert thuman.NUM_CAN_RAYS % WORLD
