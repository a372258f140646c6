"""The port's stage-1 step against the benchmark's plain reference
(`benchmark/reference/steps.bkg_step`, f32, TF32 off), on the CPU, in both
compute dtypes the configurations train in.

At the published widths (two 8x256 nets, skip after layer 4, PE 10 + 4
bands) on 32 rays x (16 + 16) samples, from the benchmark's seeded
weights, two steps through `make_bkg_train_step` with the MLP kernels'
plain versions (what the kernels compute, rounded at the same points). The
iteration is inside the 60k anneal, so the empty-space penalty is on. The
numbers are the benchmark's (`benchmark/cells.py`): each step's loss as a
relative gap, and the worst kept leaf's gap of norms of the first gradient
(from Adam's first moment) and of the change after the two steps.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import cells, inputs
from benchmark.reference import Precision
from benchmark.reference import steps as steps_ref
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.trainers.background import make_bkg_train_step, make_optimizer, named_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAYS, SAMPLES, STEPS, ITERATION, SEED = 32, 16, 2, 20000, 2707
# the bars, and why:
# - float32: the same function in the same precision, summed in another
#   order (the kernels' planar layout, Adam's fused form). Losses and the
#   first gradient read 1e-7 to 4e-7 (3 seeds), so 1e-5 leaves room for
#   another BLAS and no more. The change reads up to 2.7e-4: Adam's first
#   steps move each parameter by about the learning rate, signed, so a
#   gradient element near zero whose sign the summation order flips moves
#   the other way; 2e-3.
# - bfloat16: every product takes operands rounded to bf16's 8 bits, with
#   f32 sums, against exact f32. Read on 3 seeds: losses 1.0e-5 to 3.4e-5,
#   the first gradient 1.7e-3 to 3.1e-3, the change 2.9e-3 to 3.9e-3. The
#   bars sit ~4-6x above those and far under float8 e4m3 (the next
#   precision down, 4 bits; gaps of 1.4e-2 on the losses and 1.0 on the
#   leaves, whose small cotangents it flushes to zero), which fails them.
BARS = {"float32": {"loss": 1e-5, "grad": 1e-5, "change": 2e-3},
        "bfloat16": {"loss": 2e-4, "grad": 1.5e-2, "change": 1.5e-2}}


def _config(dtype):
    with open(os.path.join(REPO, "benchmark", "configs", "neuman-bkg.json")) as f:
        cfg = json.load(f)
    cfg["config"].update(rays_per_batch=RAYS, samples_per_ray=SAMPLES,
                         importance_samples_per_ray=SAMPLES, compute_dtype=dtype)
    return cfg


def _batches(gen):
    """Seeded stage-1 batches: rays from near the origin looking along +z."""
    out = []
    for _ in range(STEPS):
        d = torch.cat([(torch.rand(RAYS, 2, generator=gen) - 0.5) * 0.8, torch.ones(RAYS, 1)], -1)
        out.append({"origin": (torch.rand(RAYS, 3, generator=gen) - 0.5) * 0.2,
                    "direction": d / torch.linalg.norm(d, dim=-1, keepdim=True),
                    "color": torch.rand(RAYS, 3, generator=gen),
                    "depth": 1.0 + 4.0 * torch.rand(RAYS, generator=gen),
                    "near": torch.full((RAYS, 1), 0.5), "far": torch.full((RAYS, 1), 6.0)})
    return out


def _program(cfg, w0, batches):
    """(losses, first gradient, parameters after the steps) of the port."""
    ncfg = cells.port_config(cfg)
    spec = nerf_module.build_nerf_specs(ncfg)
    params = {}
    for k in ("coarse", "fine"):
        params[k] = nerf_module.Joiner(spec, device="cpu")
        params[k].nerf.load_state_dict(w0[f"bkg_{k}"])
    optimizer = make_optimizer()
    state = {"params": params, "opt_state": optimizer.init(named_params(params)),
             "iteration": ITERATION, "generator": torch.Generator().manual_seed(SEED),
             "init_generator": torch.Generator().manual_seed(SEED + 1)}
    step = make_bkg_train_step(spec, ncfg, optimizer)
    ref_name = lambda k, n: f"{k}.{n[len('nerf.'):]}"
    losses, grad1 = [], None
    for i, b in enumerate(batches):
        _, m = step(state, b)
        losses.append(float(m["total_loss"]))
        if i == 0:
            grad1 = {ref_name(k, n): mu / (1.0 - steps_ref.B1)
                     for k, ps in state["opt_state"]["mu"].items() for n, mu in ps.items()}
    trained = {ref_name(k, n): p.detach().clone()
               for k, ps in named_params(params).items() for n, p in ps.items()}
    return losses, grad1, trained


def _reference(cfg, w0, batches, prec):
    w = {f"{k}.{n}": t.clone().requires_grad_(True) for k in ("coarse", "fine")
         for n, t in w0[f"bkg_{k}"].items()}
    adam = steps_ref.Adam({k: v.detach() for k, v in w.items()})
    losses, grad1 = [], None
    for i, b in enumerate(batches):
        losses.append(steps_ref.bkg_step(w, adam, b, cfg["config"], ITERATION + i, prec))
        if i == 0:
            grad1 = {k: m / (1.0 - steps_ref.B1) for k, m in adam.mu.items()}
    return losses, grad1, {k: v.detach() for k, v in w.items()}


def _gaps(got, ref, w0):
    """{"loss", "grad", "change"}: the largest relative loss gap, the worst
    kept leaf's gap of the first gradient and of the change."""
    first = {f"{k}.{n}": t for k in ("coarse", "fine") for n, t in w0[f"bkg_{k}"].items()}
    keep = cells.TrainRunner._kept_leaves(ref[1])
    change = lambda trained: {k: trained[k] - first[k] for k in first}
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0])),
            "grad": cells.leaf_gap(got[1], ref[1], keep),
            "change": cells.leaf_gap(change(got[2]), change(ref[2]), keep)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage1_step_matches_the_plain_reference(dtype):
    cfg = _config(dtype)
    gen = torch.Generator().manual_seed(SEED)
    w0 = inputs.weights(cfg["config"], gen, ("bkg_coarse", "bkg_fine"))
    batches = _batches(gen)
    ref = _reference(cfg, w0, batches, Precision("float32"))
    got = _program(cfg, w0, batches)
    assert np.all(np.isfinite(got[0])) and got[0][0] > 0
    gaps, bars = _gaps(got, ref, w0), BARS[dtype]
    assert all(gaps[k] <= bars[k] for k in bars), gaps
    if dtype == "bfloat16":
        # one precision down fails the bf16 bars
        fp8 = _gaps(_reference(cfg, w0, batches, Precision("fp8")), ref, w0)
        assert any(fp8[k] > bars[k] for k in bars), fp8
