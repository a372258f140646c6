"""Background-scene NeRF trainer, stage 1 (counterpart of
neuman_tpu/trainers/background.py).

Per step, as the JAX trainer: coarse and fine MSE colour losses; the
empty-space penalty (density before margin * depth pushed to zero through
tanh(relu(sigma))), its weight annealed linearly to 0 over 60k iterations
and gated by `delay_iters`; Adam with the learning rate decayed as
0.1 ** (it / (lrate_decay * 1000)); a step whose loss is NaN or whose net
is dead (max sigma <= 0) is skipped, and a dead net is re-initialised.

The step takes (state, batch); `NeRFTrainer.draw_batch` draws the batch on
the device. Both MLP applications of a step run the `nerf_mlp` kernel
forward and the `nerf_mlp_bwd` kernel backward (`nerf_mlp_fn`) on the card,
or, given `mlp=nerf_mlp_plain`, autograd of the plain forward.
The step reads one scalar back (whether a net died); the skip itself is
decided on the device. Its backward, Adam update and read-back are the
spans `step.backward`, `step.optimizer` and `step.readback` of
utils/tracing.py; `--profile_dir` traces `--profile_steps` steps from
iteration 1 (`tracing.StepProfile`).
"""

import os

import numpy as np
import torch

from neuman_tpu_torch import convert
from neuman_tpu_torch.datasets import sampler
from neuman_tpu_torch.datasets.arrays import build_scene_arrays
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.ops import volume
from neuman_tpu_torch.ops.kernels.nerf_mlp import dir_projection
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn, with_tape_mode
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.render import renderer
from neuman_tpu_torch.trainers import checkpoint as ckpt
from neuman_tpu_torch.trainers import logging as tlog
from neuman_tpu_torch.utils import tracing

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ScaleByAdam:
    """optax.chain(scale_by_adam(0.9, 0.999, eps=1e-8), scale(-1)) followed
    by the JAX trainer's `u * lr` and skip rule, written out: the moments
    update and the count advances on every step, a skipped step (`bad`)
    updates them with zero gradients and leaves the parameters where they
    are. eps is added outside the square root (eps_root = 0) and the
    moments are bias-corrected by the count, as optax does;
    torch.optim.Adam would move the parameters on a skipped step."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(self, named):
        """named: {net: {name: parameter}} -> state {count, mu, nu}."""
        zeros = lambda: {k: {n: torch.zeros_like(p) for n, p in ps.items()}
                         for k, ps in named.items()}
        device = next(iter(next(iter(named.values())).values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, named, grads, state, lr, bad):
        """In place: grads like `named`; lr a float, or one float per
        group of `named`; bad a bool tensor."""
        count = state["count"] + 1
        c = count.float()
        bc1, bc2 = 1.0 - torch.pow(self.b1, c), 1.0 - torch.pow(self.b2, c)
        for k, ps in named.items():
            lr_k = lr[k] if isinstance(lr, dict) else lr
            for n, p in ps.items():
                g = torch.where(bad, 0.0, grads[k][n])
                mu, nu = state["mu"][k][n], state["nu"][k][n]
                mu.mul_(self.b1).add_((1.0 - self.b1) * g)
                nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
                u = -((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
                p.add_(torch.where(bad, 0.0, u * lr_k))
        state["count"] = count


def make_optimizer():
    return ScaleByAdam()


def named_params(params):
    """{"coarse": Joiner, "fine": Joiner} -> {net: {name: parameter}}."""
    return {k: dict(net.named_parameters()) for k, net in params.items()}


def _masked_penalty(sigma, mask, loss_fn_name, mesh=None):
    val = torch.tanh(torch.relu(sigma))
    val = val**2 if loss_fn_name == "mse" else val.abs()
    return pmesh.masked_mean(val, mask, mesh)


def bkg_loss_fn(params, spec, batch, opt, penalty_weight, generator=None, mlp=nerf_mlp_fn,
                mesh=None):
    """Coarse + fine losses of one ray batch: (coarse_rgb, coarse_empty,
    fine_rgb, fine_empty, aux). params {"coarse", "fine"} Joiners; the
    perturbation and density noise (both 0 at the bkg defaults) draw from
    `generator`. `mlp` is the differentiable MLP: `nerf_mlp_fn` (the kernel
    pair); checks pass `nerf_mlp_fn` with plain=True (the kernels' plain
    versions) or `nerf_mlp_plain` (autograd of the plain forward). The
    Functions run in the configuration `opt.mlp_tape` names. With a data
    `mesh` the batch is this rank's rows and each loss is this rank's share
    of the global one (parallel/mesh.py); aux's max_sigma_* are this rank's.

    Under `opt.ablate_nerft` (NeRF-T) the nets take (x, y, z, t), t the
    ray's `viewf_list`, through the Joiner: autograd of the plain PyTorch
    net, on the card too, as the JAX package runs this path without its
    kernels (use_pallas ... and not use_time). This is the configuration,
    not a fallback: the 4-D input has 84 PE columns and the NeRF kernels
    take one 64-column block (`check_envelope`), so no kernel is tried."""
    compute_dtype = DTYPES[opt.compute_dtype]
    origin, direction, color = batch["origin"], batch["direction"], batch["color"]
    dir_norm = torch.linalg.norm(direction, dim=-1)
    depth = batch["depth"][:, None]

    if opt.ablate_nerft:
        def run(joiner, z):
            r, s = z.shape
            pts = origin[:, None, :] + direction[:, None, :] * z[..., None]
            pts = torch.cat([pts, batch["viewf_list"][:, None].expand(r, s, 1)], dim=-1)
            out = joiner(pts, direction[:, None, :].expand(r, s, 3))
            return out[..., 3], [out[..., c] for c in range(3)]
    else:
        mlp = with_tape_mode(mlp, opt.mlp_tape)

        def run(joiner, z):
            net = joiner.nerf
            planes = [origin[:, a, None] + direction[:, a, None] * z for a in range(3)]
            dirp = dir_projection(spec, net, direction, compute_dtype)
            return mlp(spec, net, *planes, dir_part=dirp, compute_dtype=compute_dtype)

    def losses(joiner, z):
        sigma, rgb_c = run(joiner, z)
        rgb, _, _, weights, _ = volume.integrate_planar(
            sigma, rgb_c, z, dir_norm, opt.white_bkg, opt.raw_noise_std, generator,
            randn=pmesh.sharded_draw(torch.randn, mesh))
        closer = (z < depth * opt.margin).float()
        empty = _masked_penalty(sigma, closer, opt.empty_space_loss_fn, mesh) * penalty_weight
        return pmesh.mean((rgb - color) ** 2, mesh), empty, weights, sigma.detach().max()

    z = ray_ops.sample_z_vals(batch["near"], batch["far"], opt.samples_per_ray,
                              perturb=opt.perturb, generator=generator,
                              rand=pmesh.sharded_draw(torch.rand, mesh))
    c_rgb, c_emp, weights, c_max = losses(params["coarse"], z)
    f_z = volume.importance_z(z, weights, opt.importance_samples_per_ray)
    f_rgb, f_emp, _, f_max = losses(params["fine"], f_z)
    aux = {
        "coarse_rgb_loss": c_rgb, "coarse_empty_space_loss": c_emp,
        "fine_rgb_loss": f_rgb, "fine_empty_space_loss": f_emp,
        "rgb_loss": c_rgb + f_rgb, "empty_space_loss": c_emp + f_emp,
        "max_sigma_coarse": c_max, "max_sigma_fine": f_max,
    }
    return c_rgb, c_emp, f_rgb, f_emp, aux


def make_bkg_train_step(spec, opt, optimizer, mlp=nerf_mlp_fn, mesh=None):
    """train_step(state, batch) -> (state, metrics), updating in place;
    `mlp` the differentiable MLP, as in bkg_loss_fn.

    state: {"params": {"coarse", "fine"} Joiners, "opt_state", "iteration"
    (int), "generator" (the device draws), "init_generator" (a CPU
    generator for the dead-net restart)}. metrics are tensors, not read.

    With a data `mesh` (parallel/mesh.py) `batch` is the whole batch, as
    every rank draws it; the step takes this rank's rows, sums the
    gradients and the losses over the ranks in one all-reduce and takes the
    maxima of the densities in another, so every rank makes the unsharded
    step's update, skip and restart; metrics are the global values."""

    def train_step(state, batch):
        batch = pmesh.shard_leading_axis(batch, mesh)
        it = state["iteration"]
        penalty_weight = opt.penalize_empty_space * max(0.0, 1.0 - it / 60000.0)
        lr = opt.learning_rate * 0.1 ** (it / (opt.lrate_decay * 1000.0))
        named = named_params(state["params"])
        c_rgb, c_emp, f_rgb, f_emp, aux = bkg_loss_fn(
            state["params"], spec, batch, opt, penalty_weight, state["generator"], mlp=mlp,
            mesh=mesh)
        total = c_rgb + f_rgb + (c_emp + f_emp if it >= opt.delay_iters else 0.0)
        aux["total_loss"] = total.detach()
        flat = [(k, n, p) for k, ps in named.items() for n, p in ps.items()]
        with tracing.span("step.backward"):
            g = torch.autograd.grad(total, [p for _, _, p in flat])
        if mesh is not None:
            sums = [k for k in aux if "sigma" not in k]
            reduced = pmesh.all_reduce_flat(mesh, list(g) + [aux[k].detach() for k in sums])
            g = reduced[:len(g)]
            aux.update(zip(sums, reduced[len(g):]))
            maxima = mesh.all_reduce(torch.stack([aux["max_sigma_coarse"], aux["max_sigma_fine"]]),
                                     op="max")
            aux["max_sigma_coarse"], aux["max_sigma_fine"] = maxima[0], maxima[1]
        grads = {k: {} for k in named}
        for (k, n, _), gk in zip(flat, g):
            grads[k][n] = gk
        dead = (aux["max_sigma_coarse"] <= 0.0) | (aux["max_sigma_fine"] <= 0.0)
        bad = dead | torch.isnan(aux["total_loss"])
        with tracing.span("step.optimizer"):
            optimizer.step(named, grads, state["opt_state"], lr, bad)
        with tracing.span("step.readback"):  # the step's one read back
            dead_now = bool(dead.item())
        if dead_now:  # dead-network restart; the optimizer state is kept
            for net in state["params"].values():
                net.nerf.reset_parameters(state["init_generator"])
        state["iteration"] = it + 1
        metrics = {k: v.detach() for k, v in aux.items() if "sigma" not in k}
        metrics.update({"lr": lr, "penalize_empty_space": penalty_weight,
                        "dead_restart": float(dead_now)})
        return state, metrics

    return train_step


class NeRFTrainer:
    """Host loop: validation cadence, checkpoints, metrics (structure of
    the JAX NeRFTrainer). `params` {"coarse", "fine"} Joiners on `device`;
    `mlp` the differentiable MLP of the loss (bkg_loss_fn).

    The data mesh comes from `resolve_mesh(opt)`: with one, every rank
    trains on its rows of each batch, rank 0 alone validates and writes
    checkpoints and metrics while the others wait at a barrier, and a
    resume reads the checkpoint on every rank."""

    def __init__(self, opt, spec, params, scene, train_views, val_views, device="cuda",
                 mlp=nerf_mlp_fn):
        self.opt, self.spec, self.scene, self.device = opt, spec, scene, torch.device(device)
        self.mlp = mlp
        self.out = opt.out
        os.makedirs(self.out, exist_ok=True)
        all_views = sorted(set(train_views) | set(val_views))
        self.arrays = build_scene_arrays(scene, all_views, use_fused_depth=opt.use_fused_depth,
                                         device=self.device)
        remap = {v: i for i, v in enumerate(all_views)}
        ids = lambda views: torch.tensor([remap[v] for v in views], device=self.device)
        self.train_ids, self.val_ids = ids(train_views), ids(val_views)
        self.val_views = list(val_views)
        self.optimizer = make_optimizer()
        self.state = {
            "params": params,
            "opt_state": self.optimizer.init(named_params(params)),
            "iteration": 0,
            "generator": torch.Generator(self.device).manual_seed(opt.seed),
            "init_generator": torch.Generator().manual_seed(opt.seed + 1),
        }
        self.mesh = pmesh.resolve_mesh(opt)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.step_fn = make_bkg_train_step(spec, opt, self.optimizer, mlp, mesh=self.mesh)
        self.pusher = tlog.MetricsPusher(opt)
        self.meter = tlog.ThroughputMeter(
            opt.rays_per_batch * (2 * opt.samples_per_ray + 2 * opt.importance_samples_per_ray))
        if opt.resume:
            self.resume()
        elif opt.load_weights:
            self.load_pretrained_weights()
        pmesh.put_replicated([self.state["params"], self.state["opt_state"]], self.mesh)

    @property
    def iteration(self):
        return self.state["iteration"]

    def draw_batch(self, view_ids=None, generator=None):
        """A whole batch (with a mesh, each rank draws it; the step keeps
        the rank's rows)."""
        return sampler.sample_background_batch(
            generator or self.state["generator"], self.arrays,
            self.train_ids if view_ids is None else view_ids, self.opt.rays_per_batch,
            use_fused_depth=self.opt.use_fused_depth)

    def train_step(self):
        self.state, metrics = self.step_fn(self.state, self.draw_batch())
        self.meter.tick()
        return metrics

    def train(self):
        opt = self.opt
        push_every = max(1, min(100, opt.max_iter // 5))
        with tracing.StepProfile(opt.profile_dir, opt.profile_steps, self.device, "bkg",
                                 write=self.is_main) as profile:
            while self.iteration < opt.max_iter:
                if self.iteration % opt.valid_iter == 0:
                    self.validate()
                profile.before(self.iteration)
                metrics = self.train_step()
                profile.after(self.iteration)
                if self.is_main and self.iteration % push_every == 0:
                    scalars = {f"train_loss/{k}": float(v) for k, v in metrics.items() if "loss" in k}
                    scalars["params/lr"] = metrics["lr"]
                    scalars["params/penalize_empty_space"] = metrics["penalize_empty_space"]
                    scalars.update({f"perf/{k}": v for k, v in self.meter.rates().items()})
                    self.pusher.push_scalars(self.iteration, scalars)
        self.validate()

    def validate(self):
        """Losses on a batch of the validation views, a background render of
        the middle one (written as `val_<iteration:08d>.png` beside
        metrics.jsonl; `last_val_images` keeps its path), and a checkpoint.
        With a mesh every rank joins the render, each its share of each
        chunk's rays, and rank 0 alone does the rest while the other ranks
        wait. Under the NeRF-T ablation the render takes the view's time
        channel, which the JAX validation leaves out (and so raises there)."""
        rgb = self._render_validation()
        if self.is_main:
            self._validate(rgb)
        if self.mesh is not None:
            self.mesh.barrier()

    def _render_validation(self):
        """rgb [H, W, 3] of the middle validation view (None without one)."""
        if not self.val_views:
            return None
        opt = self.opt
        cap = self.scene.captures[self.val_views[len(self.val_views) // 2]]
        return renderer.render_vanilla(
            self.spec, self.state["params"]["coarse"].nerf, cap,
            self.state["params"]["fine"].nerf, self.device,
            rays_per_batch=opt.rays_per_batch, samples_per_ray=opt.samples_per_ray,
            importance_samples_per_ray=opt.importance_samples_per_ray,
            white_bkg=opt.white_bkg, ablate_nerft=opt.ablate_nerft, mesh=self.mesh)

    def _validate(self, rgb):
        opt = self.opt
        gen = torch.Generator(self.device).manual_seed(self.iteration)
        pw = opt.penalize_empty_space * max(0.0, 1.0 - self.iteration / 60000.0)
        with torch.no_grad():
            batch = self.draw_batch(self.val_ids, gen)
            aux = bkg_loss_fn(self.state["params"], self.spec, batch, opt, pw, gen,
                              mlp=self.mlp)[4]
        self.pusher.push_scalars(
            self.iteration, {f"val_loss/{k}": float(v) for k, v in aux.items()
                             if "sigma" not in k}, training=False)
        if rgb is not None:
            self.last_val_rgb = rgb
            self.last_val_images = self.pusher.push_images(self.iteration,
                                                           {"val": rgb.cpu().numpy()})
        self.save_model()

    def save_model(self):
        """`checkpoint.npz` in the JAX package's layout."""
        params, st = self.state["params"], self.state["opt_state"]
        jax_tree = lambda named: {k: convert.to_jax_params(v) for k, v in named.items()}
        ckpt.save_checkpoint(os.path.join(self.out, "checkpoint.npz"), {
            "epoch": np.int64(0),
            "iteration": np.int64(self.iteration),
            # optax.chain state: (ScaleByAdamState(count, mu, nu), EmptyState())
            "optim_state": [[st["count"], jax_tree(st["mu"]), jax_tree(st["nu"])], []],
            "coarse_model": convert.to_jax_params(params["coarse"].state_dict()),
            "fine_model": convert.to_jax_params(params["fine"].state_dict()),
        })

    def resume(self):
        data = ckpt.load_checkpoint(os.path.join(self.out, "checkpoint.npz"))
        self._load_from(data)
        count, mu, nu = data["optim_state"][0]
        st = self.state["opt_state"]
        st["count"] = torch.tensor(int(count), dtype=torch.int32, device=self.device)
        for name, tree in (("mu", mu), ("nu", nu)):
            for k in ("coarse", "fine"):
                for n, v in convert.joiner_state_dict(tree[k]).items():
                    st[name][k][n].copy_(v)
        self.state["iteration"] = int(data["iteration"])

    def load_pretrained_weights(self):
        self._load_from(ckpt.load_checkpoint(self.opt.load_weights_path))

    def _load_from(self, data):
        missing = []
        for k, key in (("coarse", "coarse_model"), ("fine", "fine_model")):
            net = self.state["params"][k]
            merged, miss = ckpt.safe_merge_params(convert.to_jax_params(net.state_dict()),
                                                  data[key])
            net.load_state_dict(convert.joiner_state_dict(merged))
            missing += miss
        if missing:
            print(f"partial load; missing: {missing}")
