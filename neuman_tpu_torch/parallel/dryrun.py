"""Data-parallel dry runs: both train steps, and renders, on N ranks
against one process (counterpart of neuman_tpu/parallel/dryrun.py).

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

A `RenderJob` is one render (a function that calls the renderers of
render/renderer.py, or a command line's `main`) run on the ranks with the
process group's mesh and in this process without one; `render_equality`
records every renderer call on both sides (its outputs and seconds), the
PNGs each process left in its own working directory, each rank's kernel
launches and the rays it ran through the human branch, and compares the
frames (`compare_renders`; `render_faults`: the JAX package's
sharded-render bars).

    eq = render_equality(2, [RenderJob("hybrid", tiny_render, ("hybrid",))])
"""

import copy
import dataclasses
import os
import shutil
import tempfile
import time
import warnings

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
    before = kernels.launches()
    metrics = []
    for _ in range(steps):
        m = trainer.train_step()
        metrics.append({k: float(v) for k, v in m.items() if "loss" in k or "reg" in k})
    return {"losses": [m["total_loss"] for m in metrics], "metrics": metrics,
            "grads": recorded[0],
            "params": {k: p.detach().cpu().clone() for k, p in trained_parameters(trainer).items()},
            "launches": kernels.launches(before)}


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


# the renderers a RenderJob records
RENDERERS = ("render_vanilla", "render_hybrid_nerf", "render_smpl_nerf",
             "render_hybrid_nerf_multi_persons")
# the names of a renderer's outputs, in order
OUTPUTS = ("rgb", "depth", "acc")
# the JAX package's sharded-vs-unsharded render bars (tests/test_parallel.py):
# rgb 1e-5, depth 1e-4 for render_vanilla and the multi-person render, the
# hybrid render's 1e-5 for the others
RENDER_BARS = {"render_vanilla": {"rgb": 1e-5, "depth": 1e-4},
               "render_hybrid_nerf": {"rgb": 1e-5, "depth": 1e-5, "acc": 1e-5},
               "render_smpl_nerf": {"rgb": 1e-5, "depth": 1e-5, "acc": 1e-5},
               "render_hybrid_nerf_multi_persons": {"rgb": 1e-5, "depth": 1e-4}}


@dataclasses.dataclass
class RenderJob:
    """fn(device, mesh, *args): a module-level function that renders
    through the renderers (every rank calls it with the process group's
    DataMesh, this process with None). Each process calls it from a fresh
    working directory of its own, where the command lines write ./demo;
    it links every entry of `workdir` (the inputs that the command lines
    read from ./, such as the gathering's ./out and ./data; None: none)."""

    name: str
    fn: object
    args: tuple = ()
    workdir: str = None


def _synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _pngs(root):
    """{path relative to `root`: bytes} of every PNG under `root`, links
    left out."""
    found = {}
    for folder, _, files in os.walk(root):
        for f in files:
            path = os.path.join(folder, f)
            if f.endswith(".png") and not os.path.islink(path):
                with open(path, "rb") as fh:
                    found[os.path.relpath(path, root)] = fh.read()
    return found


def run_render(job, device):
    """`job` in this process, recorded: {"calls": [(renderer, its outputs
    on the host)], "seconds": each call's wall time (synchronised on the
    card), "human_rays": the rays this process ran through the human
    branch, "launches": each kernel's launches, "pngs": {path: bytes} of
    the PNGs it left in its working directory (which is then removed),
    "warnings", "returned": what fn returned}."""
    from neuman_tpu_torch.ops import kernels
    from neuman_tpu_torch.parallel.mesh import DataMesh
    from neuman_tpu_torch.render import renderer

    mesh = DataMesh.of_process_group() if dist.is_initialized() else None
    rec = {"calls": [], "seconds": [], "human_rays": 0}
    saved = {name: getattr(renderer, name) for name in RENDERERS}
    branch = renderer._human_branch

    def timed(name, fn):
        def call(*args, **kwargs):
            _synchronize(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _synchronize(device)
            rec["seconds"].append(time.perf_counter() - t0)
            outs = out if isinstance(out, tuple) else (out,)
            rec["calls"].append((name, tuple(t.detach().cpu().clone() for t in outs)))
            return out
        return call

    def counted(*args, **kwargs):
        rec["human_rays"] += args[3].shape[0]  # origins
        return branch(*args, **kwargs)

    before = kernels.launches()
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="neuman_render_")
    for entry in os.listdir(job.workdir) if job.workdir is not None else ():
        os.symlink(os.path.abspath(os.path.join(job.workdir, entry)), os.path.join(work, entry))
    for name, fn in saved.items():
        setattr(renderer, name, timed(name, fn))
    renderer._human_branch = counted
    try:
        os.chdir(work)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec["returned"] = job.fn(device, mesh, *job.args)
    finally:
        os.chdir(cwd)
        for name, fn in saved.items():
            setattr(renderer, name, fn)
        renderer._human_branch = branch
        rec["pngs"] = _pngs(work)
        shutil.rmtree(work)
    rec["warnings"] = [str(w.message) for w in caught]
    rec["launches"] = kernels.launches(before)
    return rec


def run_renders(jobs, device):
    return [run_render(job, device) for job in jobs]


def compare_renders(ranks, single):
    """The comparison values of one RenderJob: each rank's run_render
    result against the unsharded one's. `calls`: rank 0's renderer calls
    and their outputs; `max_abs`: {output: the largest absolute difference
    of rank 0's frames from the unsharded ones}, over the job's renderer
    calls; `bit_equal`: every output torch.equal; `ranks_equal`: every
    rank holds rank 0's frames."""
    r0 = ranks[0]
    if [n for n, _ in r0["calls"]] != [n for n, _ in single["calls"]]:
        raise AssertionError(f"the ranks called {[n for n, _ in r0['calls']]}, one process "
                             f"{[n for n, _ in single['calls']]}")
    max_abs, bit_equal = {}, True
    for (name, got), (_, want) in zip(r0["calls"], single["calls"]):
        for out, a, b in zip(OUTPUTS, got, want):
            if a.shape != b.shape:
                raise AssertionError(f"{name} {out}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            max_abs[out] = max(max_abs.get(out, 0.0), float((a - b).abs().max()))
            bit_equal = bit_equal and torch.equal(a, b)
    return {
        "renderers": [n for n, _ in single["calls"]],
        "calls": r0["calls"],
        "max_abs": max_abs,
        "bit_equal": bit_equal,
        "ranks_equal": all(torch.equal(a, b) for r in ranks[1:]
                           for (_, outs), (_, outs0) in zip(r["calls"], r0["calls"])
                           for a, b in zip(outs, outs0)),
        "hw": list(single["calls"][0][1][0].shape[:2]) if single["calls"] else None,
        "seconds": [r["seconds"] for r in ranks], "single_seconds": single["seconds"],
        "human_rays": [r["human_rays"] for r in ranks], "single_human_rays": single["human_rays"],
        "launches": [r["launches"] for r in ranks],
        "pngs_equal": r0["pngs"] == single["pngs"],
        "pngs_written": [len(r["pngs"]) for r in ranks], "single_pngs": len(single["pngs"]),
        "warnings": [r["warnings"] for r in ranks],
        "returned": [r["returned"] for r in ranks], "single_returned": single["returned"],
    }


def render_faults(eq):
    """What a `compare_renders` dict breaks of the JAX package's
    sharded-render contract: an output over its bar (RENDER_BARS, by
    renderer), ranks that hold different frames, PNGs written by a rank
    other than 0 or other than one process's. [] when none."""
    faults = [f"{name} {out}: {eq['max_abs'][out]} apart, over {atol}"
              for name in sorted(set(eq["renderers"]))
              for out, atol in RENDER_BARS[name].items() if eq["max_abs"].get(out, 0.0) > atol]
    if not eq["ranks_equal"]:
        faults.append("the ranks hold different frames")
    if not eq["pngs_equal"] or any(eq["pngs_written"][1:]):
        faults.append(f"PNGs: rank 0's equal one process's: {eq['pngs_equal']}; written by "
                      f"each rank {eq['pngs_written']}")
    return faults


def render_equality(n, jobs, backend="gloo", device="cpu", timeout_s=600.0):
    """Each RenderJob on n ranks (spawn_ranks), then in this process
    without a mesh: a list of `compare_renders` dicts, one a job."""
    cpu = torch.device(device).type == "cpu"
    ranks = spawn_ranks(n, run_renders, (jobs, device), backend, cpu, timeout_s)
    single = run_renders(jobs, device)
    return [compare_renders([r[i] for r in ranks], s) for i, s in enumerate(single)]


def tiny_render_scene(device="cpu", seed=0):
    """A tiny frame to render: (spec, HumanNeRF at the TINY widths drawn
    from `seed`, density biases +0.5 background and +2 body so that both
    branches show; a 16x16 capture 2.5 in front of the body proxy at
    subdivision 1 (V=42) posed by a random pose; its posed vertices, faces
    and Ts)."""
    from neuman_tpu_torch.cameras.capture import ResizedPinholeCapture
    from neuman_tpu_torch.cameras.pinhole import PinholeCamera
    from neuman_tpu_torch.cameras.pose import CameraPose
    from neuman_tpu_torch.geometry.rotation import Rotation, Translation
    from neuman_tpu_torch.models import human_nerf as hn
    from neuman_tpu_torch.models import smpl

    cfg = NeuManConfig(**TINY)
    spec = hn.build_human_nerf_spec(cfg)
    model = hn.HumanNeRF(spec, device=device, generator=torch.Generator().manual_seed(seed))
    model.requires_grad_(False)
    for net, bias in ((model.coarse_bkg_net, 0.5), (model.fine_bkg_net, 0.5),
                      (model.coarse_human_net, 2.0)):
        net.nerf.alpha_linear.bias.add_(bias)
    body = smpl.body_proxy_smpl_model(subdivisions=1, device=device)
    pose = torch.zeros(1, 72, device=device)
    pose[0, 3:] = torch.as_tensor(np.random.default_rng(seed + 4).normal(size=69) * 0.05,
                                  dtype=torch.float32, device=device)
    verts, ts = smpl.da_pose_to_scene(body, pose, torch.zeros(1, 10, device=device))
    cap = ResizedPinholeCapture(
        PinholeCamera(16, 16, 16.0, 16.0, 8.0, 8.0),
        CameraPose(Translation(np.array([0.0, 0.0, 2.5], np.float32)),
                   Rotation(np.array([1.0, 0.0, 0.0, 0.0]))), (16, 16))
    cap.near, cap.far = {"bkg": 0.5}, {"bkg": 6.0}
    return spec, model, cap, verts.cpu().numpy(), np.asarray(body.faces), ts.cpu().numpy()


def tiny_render(device, mesh, what, rays_per_batch=64):
    """One tiny frame (`tiny_render_scene`) in f32 at TINY's samples, k=4,
    stride 4, geo_threshold 0.3: `what` "vanilla" (render_vanilla),
    "hybrid", "smpl" (posed), "smpl_can" (the vertices as canonical ones,
    no Ts) or "multi" (the body and a copy 0.6 to its side). Returns the
    renderer's outputs."""
    from neuman_tpu_torch.render import renderer

    spec, model, cap, verts, faces, ts = tiny_render_scene(device)
    kw = dict(rays_per_batch=rays_per_batch, samples_per_ray=TINY["samples_per_ray"],
              compute_dtype=torch.float32, mesh=mesh)
    human = dict(geo_threshold=0.3, knn_k=4, knn_stride=4)
    bkg_samples = TINY["importance_samples_per_ray"]
    if what == "vanilla":
        return renderer.render_vanilla(spec.bkg, model.coarse_bkg_net.nerf, cap,
                                       model.fine_bkg_net.nerf, device,
                                       importance_samples_per_ray=bkg_samples, **kw)
    if what == "hybrid":
        return renderer.render_hybrid_nerf(spec, model, cap, verts, faces, ts, device,
                                           importance_samples_per_ray=bkg_samples, **human, **kw)
    if what in ("smpl", "smpl_can"):
        can = what == "smpl_can"
        return renderer.render_smpl_nerf(spec, model, cap, verts, faces, None if can else ts,
                                         device, render_can=can, interval_comp=1.3, **human, **kw)
    if what == "multi":
        shift = np.array([0.6, 0.0, 0.0], np.float32)
        ts2 = ts.copy()
        ts2[:, :3, 3] += shift
        return renderer.render_hybrid_nerf_multi_persons(
            spec, model, cap, [spec, spec], [model, model], [verts, verts + shift],
            [faces, faces], [ts, ts2], device, importance_samples_per_ray=bkg_samples,
            **human, **kw)
    raise ValueError(f"unknown tiny render {what!r}")


def command_line(device, mesh, module, argv):
    """`neuman_tpu_torch.<module>.main(argv)` on `device`, with
    --data_parallel on under a mesh and off without one. Returns what main
    returns."""
    import importlib

    main = importlib.import_module(f"neuman_tpu_torch.{module}").main
    return main([*argv, "--data_parallel", "on" if mesh is not None else "off"], device=device)
