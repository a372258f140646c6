"""Data-parallel dry runs: both train steps on N ranks against one process
(counterpart of neuman_tpu/parallel/dryrun.py).

`dryrun_equality(n, jobs)` spawns n ranks (torch.multiprocessing, spawn),
joins them into one process group with an explicit backend (gloo on the
CPU; on one GPU gloo too, since NCCL cannot put two ranks on one GPU),
builds on every rank the same trainer from the same seeds with
data_parallel "on", runs each job's steps, and then runs the same steps in
this process without a mesh. A job is one trainer (background or human)
on the synthetic staged scene of `datasets.arrays.synthetic_arrays` (the
JAX package's `synthetic_arrays`), at a configuration the caller gives
(`tiny_bkg_config` / `tiny_human_config` are the test widths). Sharding the
ray axis must not change the math: the results carry each step's loss,
the step-1 gradients, the parameters after the steps and each rank's
kernel launches, on both sides.

    eq = dryrun_step_equality("human", 2, steps=2)   # tiny, on the CPU, JAX's bars
"""

import copy
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults
from neuman_tpu_torch.utils.constants import PATCH_SIZE_SQUARED

# the tests' tiny widths, as tests/test_parallel.py and the JAX dryrun's
TINY = dict(nerf_depth=2, nerf_width=32, pos_N_freqs=4, pos_max_freq=3, dir_N_freqs=2,
            dir_max_freq=1, samples_per_ray=8, importance_samples_per_ray=8)


def tiny_bkg_config(out_dir, n_devices=2, **fields):
    """The background stage at the tiny widths, 32 rays a rank."""
    cfg = apply_mode_defaults(NeuManConfig(), "bkg")
    for k, v in {**TINY, "rays_per_batch": 32 * n_devices, "out_dir": out_dir,
                 "valid_iter": 1000, **fields}.items():
        setattr(cfg, k, v)
    return cfg.finalize()


def tiny_human_config(out_dir, n_devices=2, **fields):
    """The human stage at the tiny widths (the JAX dryrun's, with the LPIPS
    loss on): the 32x32 patch and 32 more rays, rounded up to a multiple of
    n_devices, so that the patch straddles the ranks."""
    cfg = apply_mode_defaults(NeuManConfig(), "smpl_and_offset")
    rays = -(-(PATCH_SIZE_SQUARED + 32) // n_devices) * n_devices
    for k, v in {**TINY, "rays_per_batch": rays, "out_dir": out_dir, "valid_iter": 1000,
                 "geo_threshold": 0.5, "dilation": 0, "body_rays_ratio": 0.95,
                 "border_rays_ratio": 0.0, "bkg_rays_ratio": 0.05, **fields}.items():
        setattr(cfg, k, v)
    return cfg.finalize()


@dataclasses.dataclass
class Job:
    """One trainer's `steps` train steps: `kind` "bkg" or "human", its
    config, the synthetic scene's views, height x width and seed, and for
    the human stage the body proxy's subdivisions (V=42 at 1, 10,242 at 5)
    and the seed of its LPIPS weights (the LPIPS loss is on when
    cfg.penalize_lpips > 0)."""

    kind: str
    cfg: NeuManConfig
    steps: int = 2
    views: int = 4
    hw: tuple = (36, 48)
    seed: int = 0
    body_subdivisions: int = 1

    def trainer(self, device, data_parallel):
        cfg = copy.copy(self.cfg)
        cfg.data_parallel = data_parallel
        if self.kind == "bkg":
            return bkg_training_setup(cfg, device, self.views, self.hw, self.seed)
        return human_training_setup(cfg, device, self.views, self.hw, self.seed,
                                    self.body_subdivisions)


def bkg_training_setup(cfg, device, views=4, hw=(36, 48), seed=0):
    """A NeRFTrainer on the synthetic staged scene: views 0..views-2 train,
    the last validates; nets drawn from cfg.seed."""
    from neuman_tpu_torch.datasets import arrays as darrays
    from neuman_tpu_torch.models import nerf as nerf_module
    from neuman_tpu_torch.train import init_bkg_params
    from neuman_tpu_torch.trainers.background import NeRFTrainer

    scene = darrays.ArraysScene(darrays.synthetic_arrays(views, *hw, seed=seed, device=device))
    spec = nerf_module.build_nerf_specs(cfg)
    return NeRFTrainer(cfg, spec, init_bkg_params(spec, cfg.seed, device), scene,
                       list(range(views - 1)), [views - 1], device=device)


def human_training_setup(cfg, device, views=4, hw=(36, 48), seed=0, body_subdivisions=1):
    """A HumanNeRFTrainer on `synthetic_human_scene` with the body proxy;
    nets drawn from cfg.seed, the canonical net's density bias at 0.5 (a
    random net can be dead everywhere), LPIPS weights drawn from cfg.seed."""
    from neuman_tpu_torch.datasets import arrays as darrays
    from neuman_tpu_torch.models import human_nerf as hn
    from neuman_tpu_torch.models import lpips as lpips_module
    from neuman_tpu_torch.models import smpl
    from neuman_tpu_torch.trainers.human import HumanNeRFTrainer

    body = smpl.body_proxy_smpl_model(subdivisions=body_subdivisions, device=device)
    scene = darrays.synthetic_human_scene(body, views, *hw, seed=seed, device=device)
    model = hn.HumanNeRF(hn.build_human_nerf_spec(cfg), device=device,
                         generator=torch.Generator().manual_seed(cfg.seed),
                         poses=np.stack([s["pose"] for s in scene.smpls]),
                         betas=np.stack([s["betas"] for s in scene.smpls]),
                         alignments=scene.alignments)
    with torch.no_grad():
        model.coarse_human_net.nerf.alpha_linear.bias.fill_(0.5)
    lpips_params = (lpips_module.init_lpips_params(cfg.seed, device)
                    if cfg.penalize_lpips > 0 else None)
    return HumanNeRFTrainer(cfg, model, scene, list(range(views - 1)), [views - 1], body,
                            lpips_params=lpips_params, device=device)


def trained_parameters(trainer):
    """{name: parameter} of a trainer's model (both nets of the background
    stage, the whole HumanNeRF of the human stage)."""
    if hasattr(trainer, "model"):
        return dict(trainer.model.named_parameters())
    return {f"{k}.{n}": p for k, net in trainer.state["params"].items()
            for n, p in net.named_parameters()}


def run_steps(trainer, steps):
    """`steps` train steps: {"losses": each step's total loss, "metrics":
    each step's losses by name, "grads": the gradients step 1 updated with
    (the all-reduced ones under a mesh), "params": the parameters after
    the steps, "launches": each kernel's launches in the steps}; tensors
    on the host."""
    from neuman_tpu_torch.ops import kernels

    recorded, update = [], trainer.optimizer.step

    def recording(named, grads, *args, **kwargs):
        if not recorded:
            recorded.append({f"{k}.{n}": g.detach().cpu().clone()
                             for k, gs in grads.items() for n, g in gs.items()})
        return update(named, grads, *args, **kwargs)

    trainer.optimizer.step = recording
    counters = kernels.wrappers()
    for c in counters.values():
        c.launches = 0
    metrics = []
    for _ in range(steps):
        m = trainer.train_step()
        metrics.append({k: float(v) for k, v in m.items() if "loss" in k or "reg" in k})
    return {"losses": [m["total_loss"] for m in metrics], "metrics": metrics,
            "grads": recorded[0],
            "params": {k: p.detach().cpu().clone() for k, p in trained_parameters(trainer).items()},
            "launches": {k: c.launches for k, c in counters.items()}}


def run_jobs(jobs, device, data_parallel="on"):
    """run_steps of each job's trainer, built with `data_parallel`."""
    return [run_steps(job.trainer(device, data_parallel), job.steps) for job in jobs]


def _rank_entry(rank, world, workdir, backend, cpu, timeout_s, fn, args):
    """One spawned rank: join the group (file:// rendezvous in `workdir`),
    run fn(*args), save its result as workdir/rank<rank>.pt."""
    import datetime

    if cpu:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        torch.save(fn(*args), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(n, fn, args=(), backend="gloo", cpu=True, timeout_s=600.0, workdir=None):
    """fn(*args) on n spawned ranks of one process group (fn and args
    picklable: fn a module-level function); returns each rank's result.
    `cpu`: one torch thread a rank. A rank that raises fails the call with
    its traceback; past `timeout_s` every rank is killed and TimeoutError
    raised, so that a hang cannot outlive the call."""
    workdir = tempfile.mkdtemp(prefix="neuman_dryrun_", dir=workdir)
    try:
        ctx = mp.start_processes(_rank_entry,
                                 args=(n, workdir, backend, cpu, timeout_s, fn, tuple(args)),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the {n} ranks did not finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _rel_l2(a, b):
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def compare(ranks, single, atol=1e-5):
    """The comparison values of one job: the ranks' run_steps results
    against the unsharded one (`param_share_over_atol`: the share of
    parameter elements that differ by more than atol)."""
    r0 = ranks[0]
    return {
        "steps": len(single["losses"]),
        "loss_unsharded": single["losses"],
        "loss_sharded": r0["losses"],
        "max_loss_rel_diff": max(abs(a - b) / max(abs(b), 1e-30)
                                 for a, b in zip(r0["losses"], single["losses"])),
        "max_param_abs_diff": max(float((r0["params"][k] - v).abs().max())
                                  for k, v in single["params"].items()),
        "param_share_over_atol": (sum(int(((r0["params"][k] - v).abs() > atol).sum())
                                      for k, v in single["params"].items())
                                  / sum(v.numel() for v in single["params"].values())),
        "grad_rel_l2": {k: _rel_l2(r0["grads"][k], v) for k, v in single["grads"].items()},
        "ranks_equal": all(torch.equal(r["params"][k], v) for r in ranks[1:]
                           for k, v in r0["params"].items()),
        "metrics": r0["metrics"],
        "launches": [r["launches"] for r in ranks],
    }


def dryrun_equality(n, jobs, backend="gloo", device="cpu", timeout_s=600.0):
    """Each job on n ranks (spawn_ranks) and in this process without a
    mesh: a list of `compare` dicts, one a job."""
    cpu = torch.device(device).type == "cpu"
    ranks = spawn_ranks(n, run_jobs, (jobs, device), backend, cpu, timeout_s)
    single = run_jobs(jobs, device, "off")
    return [compare([r[i] for r in ranks], s) for i, s in enumerate(single)]


def check_bars(eq, rtol=1e-4, atol=1e-5):
    """Raise AssertionError unless a `compare` dict meets the JAX
    package's sharded-vs-unsharded bars (tests/test_parallel.py: each
    step's loss within rtol 1e-4, every parameter within atol 1e-5) and
    the ranks' parameters are equal. Returns eq."""
    np.testing.assert_allclose(eq["loss_sharded"], eq["loss_unsharded"], rtol=rtol)
    if eq["max_param_abs_diff"] > atol:
        raise AssertionError(f"parameters {eq['max_param_abs_diff']} apart, over {atol}")
    if not eq["ranks_equal"]:
        raise AssertionError("the ranks' parameters differ")
    return eq


def tiny_jobs(kind, n_devices, steps, out_dir):
    """[the Job of stage `kind` ("bkg" or "human") at the tiny widths]."""
    config = {"bkg": tiny_bkg_config, "human": tiny_human_config}[kind]
    return [Job(kind, config(out_dir, n_devices), steps=steps)]


def dryrun_train_step(kind, n_devices):
    """One train step of stage `kind` at the tiny widths on n gloo ranks on
    the CPU (the JAX package's dryrun_human_train_step): rank 0's total
    loss, which must be finite."""
    with tempfile.TemporaryDirectory(prefix="neuman_dryrun_out_") as out:
        ranks = spawn_ranks(n_devices, run_jobs, (tiny_jobs(kind, n_devices, 1, out), "cpu"))
    loss = ranks[0][0]["losses"][0]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss in the dry run: {loss}")
    return loss


def dryrun_step_equality(kind, n_devices, steps=2):
    """`steps` train steps of stage `kind` at the tiny widths on n gloo
    ranks on the CPU against one process (the JAX package's
    dryrun_human_equality; the human stage with the LPIPS loss on and its
    patch over the ranks' rows), held to `check_bars`: the compare dict."""
    with tempfile.TemporaryDirectory(prefix="neuman_dryrun_out_") as out:
        return check_bars(dryrun_equality(n_devices, tiny_jobs(kind, n_devices, steps, out))[0])
