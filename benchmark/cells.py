"""The runners of the four kinds of traffic, by the `kind` of a traffic
file: "train_bkg", "train_human", "render_hybrid", "render_canonical".

A runner is built from (configuration, traffic, seed, device): it makes
the inputs (benchmark/inputs.py), builds the program's objects on them,
warms up every shape the traffic uses (the train runners by their first
steps, which the reference then follows) and is ready for the window.
`unit()` runs one step (a batch draw and a train step) or one frame (its
RGB copied to the host); `work()` gives a unit's NeRF-MLP and model work;
`check()`, after the window, frees the program's state and returns the
numbers compared with the reference, {name: value}.

This is the one module of the benchmark that imports the program.
"""

import random
import types

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.reference import F32
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import nerf as nerf_ref
from benchmark.reference import render as render_ref
from benchmark.reference import steps as steps_ref
from neuman_tpu_torch.datasets import sampler
from neuman_tpu_torch.datasets.arrays import RaySceneArrays
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.models.smpl import SMPLModel
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults
from neuman_tpu_torch.render import renderer
from neuman_tpu_torch.trainers import human as human_trainer
from neuman_tpu_torch.trainers.background import make_bkg_train_step, make_optimizer, named_params

PATCH = 32


def port_config(cfg, render=False):
    """The program's NeuManConfig of a configuration file: the train mode's
    defaults, then every field the file gives."""
    ncfg = NeuManConfig(offset_scale=1.0) if render else apply_mode_defaults(NeuManConfig(), cfg["train_mode"])
    for k, v in cfg["config"].items():
        if hasattr(ncfg, k) and not (render and k in ("offset_scale",)):
            setattr(ncfg, k, v)
    return ncfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mlp_macs(c, net):
    w, d = c["nerf_width"], c["nerf_depth"]
    if net == "off":
        return flops.mlp_macs(w, d, (4,), inputs.pe_channels(4, c["pos_N_freqs"]), 0, 3), \
            flops.mlp_params(w, d, (4,), inputs.pe_channels(4, c["pos_N_freqs"]), 0, 3)
    args = (w, d, (4,), inputs.pe_channels(3, c["pos_N_freqs"]), inputs.pe_channels(3, c["dir_N_freqs"]))
    return flops.mlp_macs(*args), flops.mlp_params(*args)


def _relative_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(prog, ref, keep=None, over=max):
    """The worst (or, with over=np.median, the median) leaf's gap between the
    norms |prog| and |ref|, over the larger of the leaf's reference norm and
    the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    pn = {k: float(torch.linalg.norm(prog[k].float())) for k in names}
    rn = {k: float(torch.linalg.norm(ref[k].float())) for k in names}
    med = float(np.median(list(rn.values())))
    return float(over([abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names]))


def sign_flips(prog, ref, keep):
    """The share of the first gradient's elements (of the kept leaves, the
    reference's nonzero ones) whose sign differs from the reference's: the
    parameters that the first Adam step moves the other way (a first step
    moves each by the learning rate, signed)."""
    flips = total = 0
    for k in keep:
        nz = ref[k] != 0
        flips += int(((prog[k] > 0) != (ref[k] > 0))[nz].sum())
        total += int(nz.sum())
    return flips / max(total, 1)


class Runner:
    unit_name = "step"

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.c, self.traffic, self.seed = cfg, cfg["config"], traffic, int(seed)
        self.device = torch.device(device)
        self.failed = 0
        self.restarts = 0


# ---------------------------------------------------------------- training


class TrainRunner(Runner):
    """Set-up runs the first `reference_steps` steps through the window's
    own draw and step, recording what the reference follows: each batch,
    the step's generator state, its loss, the first gradient (from Adam's
    first moment after step 1) and the parameters before and after."""

    unit_name = "step"

    def _record_first_steps(self):
        self.trained0 = {k: p.detach().clone() for k, p in self._trained().items()}
        self.batches, self.gen_states, self.losses = [], [], []
        for i in range(self.traffic["reference_steps"]):
            batch = self._draw()
            self.batches.append({k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()})
            self.gen_states.append(self.state["generator"].get_state())
            loss = self._step(batch)
            self.losses.append(float(loss))
            if i == 0:
                self.grad1 = {k: m / (1.0 - steps_ref.B1) for k, m in self._moments().items()}
        self.trained3 = {k: p.detach().clone() for k, p in self._trained().items()}
        _sync(self.device)

    def unit(self, draw_events=None):
        with torch.profiler.record_function("batch_draw"):
            if draw_events is not None:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                batch = self._draw()
                end.record()
                draw_events.append((start, end))
            else:
                batch = self._draw()
        with torch.profiler.record_function("train_step"):
            loss = self._step(batch)
        self.window_losses.append(loss)

    def finish_window(self):
        losses = torch.stack(self.window_losses) if self.window_losses else torch.zeros(0)
        self.failed = int((~torch.isfinite(losses)).sum())
        self.window_losses = []

    @staticmethod
    def _kept_leaves(ref_grad1):
        """Leaves whose reference gradient is not nought to rounding: norm at
        least a thousandth of the median leaf's."""
        norms = {k: float(torch.linalg.norm(g)) for k, g in ref_grad1.items()}
        med = float(np.median(list(norms.values())))
        return {k for k, n in norms.items() if n >= 1e-3 * med}

    def _recover_pixels(self, batch, views):
        """(pixel x, y, and the count of rays whose direction does not land
        on a pixel centre) of a batch's rays in staged views `views` [B]."""
        k, c2w = self.scene["intrinsics"][views], self.scene["c2w"][views]
        cam = (c2w[:, :3, :3] * batch["direction"][:, :, None]).sum(1)
        x = k[:, 0, 0] * cam[:, 0] / cam[:, 2] + k[:, 0, 2]
        y = k[:, 1, 1] * cam[:, 1] / cam[:, 2] + k[:, 1, 2]
        xi, yi = torch.round(x).long(), torch.round(y).long()
        h, w = self.traffic["height"], self.traffic["width"]
        off = ((x - xi).abs() > 0.05) | ((y - yi).abs() > 0.05) | (xi < 0) | (xi >= w) | (yi < 0) | (yi >= h)
        return xi.clamp(0, w - 1), yi.clamp(0, h - 1), int(off.sum())

    def _rebuild_common(self, views, xi, yi):
        k, c2w = self.scene["intrinsics"], self.scene["c2w"]
        o = c2w[views, :3, 3]
        cam = torch.stack([(xi.float() - k[views, 0, 2]) / k[views, 0, 0],
                           (yi.float() - k[views, 1, 2]) / k[views, 1, 1], torch.ones_like(xi, dtype=torch.float32)], -1)
        d = (c2w[views, :3, :3] * cam[:, None, :]).sum(-1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        color = self.scene["images"][views, yi, xi].float() / 255.0
        return o, d, color

    def check(self, control=None):
        """{number: value} of the program against the reference; with a
        `control` Precision, also {number: value} of the reference computed
        in it against the reference (the control's readings)."""
        self.release()
        ref_batches, wrong, gap = [], 0, 0.0
        for b in self.batches:
            rb, w_, g_ = self._rebuild(b)
            ref_batches.append(rb)
            wrong, gap = wrong + w_, max(gap, g_)
        ref = self._reference(ref_batches, F32)
        out = {"batch_rays_wrong": float(wrong), "batch_gap": gap}
        out.update(self._compare((self.losses, self.grad1, self.trained3), ref))
        if control is None:
            return out
        ctrl = dict(out, **self._compare(self._reference(ref_batches, control), ref))
        return out, ctrl

    def _compare(self, prog, ref):
        (p_losses, p_grad1, p_trained3), (r_losses, r_grad1, r_trained3) = prog, ref
        keep = self._kept_leaves(r_grad1)
        change_p = {k: p_trained3[k] - self.trained0[k] for k in self.trained0}
        change_r = {k: r_trained3[k] - self.trained0[k] for k in self.trained0}
        return {
            "loss1_gap": _relative_gap(p_losses[0], r_losses[0]),
            "loss_gap": max(_relative_gap(p, r) for p, r in zip(p_losses, r_losses)),
            "grad_gap": leaf_gap(p_grad1, r_grad1, keep),
            "change_gap": leaf_gap(change_p, change_r, keep),
            "grad_sign_flips": sign_flips(p_grad1, r_grad1, keep),
            "grad_gap_median": leaf_gap(p_grad1, r_grad1, keep, np.median),
            "change_gap_median": leaf_gap(change_p, change_r, keep, np.median),
        }


class TrainBkg(TrainRunner):
    """Stage-1 steps over the staged train views of the video."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        gen = inputs.generator(seed, self.device)
        self.w0 = inputs.weights(self.c, gen, ("bkg_coarse", "bkg_fine"))
        bod = inputs.body(self.device)
        fr = inputs.frames(traffic, gen, bod)
        views = [i for i in range(traffic["frames"]) if i % traffic["test_every"] != traffic["test_offset"]]
        self.scene = inputs.scene_views(traffic, gen, fr, views, traffic["dilation"])
        fields = {k: v for k, v in self.scene.items() if k != "classes"}
        self.arrays = RaySceneArrays(**fields)
        self.ids = torch.arange(len(views), device=self.device)
        self.ncfg = port_config(cfg)
        spec = nerf_module.build_nerf_specs(self.ncfg)
        params = {}
        for k, net in (("coarse", "bkg_coarse"), ("fine", "bkg_fine")):
            params[k] = nerf_module.Joiner(spec, device=self.device)
            params[k].nerf.load_state_dict(self.w0[net])
        self.optimizer = make_optimizer()
        self.state = {"params": params, "opt_state": self.optimizer.init(named_params(params)),
                      "iteration": traffic["iteration"],
                      "generator": torch.Generator(self.device).manual_seed(self.seed),
                      "init_generator": torch.Generator().manual_seed(self.seed + 1)}
        self.step_fn = make_bkg_train_step(spec, self.ncfg, self.optimizer)
        self.window_losses = []
        self._record_first_steps()

    def _draw(self):
        return sampler.sample_background_batch(self.state["generator"], self.arrays, self.ids,
                                               self.ncfg.rays_per_batch, use_fused_depth=True)

    def _step(self, batch):
        _, m = self.step_fn(self.state, batch)
        self.restarts += int(m["dead_restart"])
        return m["total_loss"]

    def _trained(self):
        return {f"{k}.{n[len('nerf.'):]}": p for k, ps in named_params(self.state["params"]).items()
                for n, p in ps.items()}

    def _moments(self):
        return {f"{k}.{n[len('nerf.'):]}": m for k, ps in self.state["opt_state"]["mu"].items()
                for n, m in ps.items()}

    def release(self):
        self.state = self.step_fn = self.arrays = self.optimizer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _rebuild(self, b):
        """(the reference's batch rebuilt from the pixels the rays land on,
        the count of rays that are wrong, the largest gap of a field)."""
        viewf = self.scene["viewf"]
        views = torch.argmin((b["viewf_list"][:, :1] - viewf[None]).abs(), dim=1)
        wrong = int(((b["viewf_list"][:, 0] - viewf[views]).abs() > 0).sum())
        xi, yi, off = self._recover_pixels(b, views)
        w = self.traffic["width"]
        cls = self.scene["classes"][views, yi * w + xi]
        wrong += off + int((cls != 2).sum())
        o, d, color = self._rebuild_common(views, xi, yi)
        ref = {"origin": o, "direction": d, "color": color,
               "depth": self.scene["fused_depths"][views, yi, xi],
               "near": self.scene["near_bkg"][views][:, None], "far": self.scene["far_bkg"][views][:, None]}
        gap = max(float((ref[k] - b[k]).abs().max()) for k in ref)
        return ref, wrong, gap

    def _reference(self, batches, prec):
        w = {f"{k}.{n}": t.clone().requires_grad_(True)
             for k, net in (("coarse", "bkg_coarse"), ("fine", "bkg_fine")) for n, t in self.w0[net].items()}
        adam = steps_ref.Adam({k: v.detach() for k, v in w.items()})
        losses, grad1 = [], None
        for i, b in enumerate(batches):
            losses.append(steps_ref.bkg_step(w, adam, b, self.c, self.traffic["iteration"], prec))
            if i == 0:
                grad1 = {k: m / (1.0 - steps_ref.B1) for k, m in adam.mu.items()}
        return losses, grad1, {k: v.detach() for k, v in w.items()}

    def work(self):
        c = self.c
        macs, params = _mlp_macs(c, "bkg")
        r, s, i = c["rays_per_batch"], c["samples_per_ray"], c["importance_samples_per_ray"]
        f, b = flops.mlp_work(macs, params, r * (2 * s + i), 2 * r, False, True)
        return {"nerf_mlp": (f, b), "model_flops": f, "dtype": c["compute_dtype"]}


class TrainHuman(TrainRunner):
    """Stage-2 steps over the staged train views, the person in them."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        dev = self.device
        gen = inputs.generator(seed, dev)
        self.w0 = inputs.weights(self.c, gen, inputs.NETS)
        self.lpips = inputs.lpips_weights(gen)
        self.body = inputs.body(dev)
        fr = self.fr = inputs.frames(traffic, gen, self.body)
        views = [i for i in range(traffic["frames"]) if i % traffic["test_every"] != traffic["test_offset"]]
        self.views = views
        self.scene = inputs.scene_views(traffic, gen, fr, views, self.c["dilation"])
        self.arrays = RaySceneArrays(**{k: v for k, v in self.scene.items() if k != "classes"})
        self.ids = torch.arange(len(views), device=dev)
        self.geo = fr["bone"]
        self.can_k, self.can_c2w = inputs.canonical_cameras(
            fr["can_verts"], self.body, traffic["canonical_cameras"], traffic["canonical_distance"],
            traffic["canonical_focal"], traffic["height"], traffic["width"])
        self.ncfg = port_config(cfg)
        self.ncfg.geo_threshold = self.geo
        b = self.body
        smpl = SMPLModel.from_numpy(*(t.cpu().numpy() for t in (b["v_template"], b["shapedirs"],
                                                                  b["J_regressor"], b["lbs_weights"])),
                                    b["parents"], b["faces"].cpu().numpy(), device=dev)
        n = traffic["frames"]
        model = hn.HumanNeRF(hn.build_human_nerf_spec(self.ncfg), device=dev,
                             poses=fr["poses"].cpu().numpy(),
                             betas=np.tile(fr["betas"].cpu().numpy()[None], (n, 1)),
                             alignments=np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1)))
        for net, mod in (("bkg_coarse", model.coarse_bkg_net), ("bkg_fine", model.fine_bkg_net),
                         ("can", model.coarse_human_net), ("off", model.offset_nets[0])):
            mod.nerf.load_state_dict(self.w0[net])
        self.model = model
        faces = b["faces"].cpu().numpy()
        can_verts = fr["can_verts"][None].expand(len(views), -1, -1).contiguous()
        self.ctx = {
            "body_model": smpl, "da_smpl": hn.da_pose_params(24, dev), "scale": 1.0,
            "topo": mesh_ops.MeshTopology.build(faces, smpl.num_verts, dev), "can_verts": can_verts,
            "can_k": self.can_k, "can_c2w": self.can_c2w, "can_hw": (traffic["height"], traffic["width"]),
            "interval_comp": self.geo / fr["bone"], "lpips_params": self.lpips,
            "scene_ids": torch.as_tensor(views, device=dev), "grad_masks": torch.ones(n, 72, device=dev),
            "knn_k": self.c["knn_k"], "knn_stride": self.c["knn_stride"],
        }
        self.optimizer = make_optimizer()
        self.state = {"opt_state": self.optimizer.init(human_trainer.trained_params(model)),
                      "iteration": traffic["iteration"],
                      "generator": torch.Generator(dev).manual_seed(self.seed),
                      "init_generator": torch.Generator().manual_seed(self.seed + 1)}
        self.step_fn = human_trainer.make_human_train_step(model, self.ncfg, self.optimizer, self.ctx)
        self.window_losses = []
        self._record_first_steps()

    def _draw(self):
        c = self.ncfg
        return sampler.sample_human_batch(
            self.state["generator"], self.arrays, self.ids, c.geo_threshold, c.rays_per_batch,
            ratios=(c.body_rays_ratio, c.border_rays_ratio, c.bkg_rays_ratio),
            use_patch=c.penalize_lpips > 0, dilation=c.dilation)

    def _step(self, batch):
        _, m = self.step_fn(self.state, batch)
        self.restarts += int(m["dead_restart"])
        return m["total_loss"]

    @staticmethod
    def _ref_name(group, name):
        """The reference's leaf name of the program's (group, name)."""
        if group == "poses":
            return "poses"
        if group == "coarse_human_net":
            return "can." + name[len("nerf."):]
        return "off." + name[len("0.nerf."):]

    def _trained(self):
        return {self._ref_name(g, n): p for g, ps in human_trainer.trained_params(self.model).items()
                for n, p in ps.items()}

    def _moments(self):
        return {self._ref_name(g, n): m for g, ps in self.state["opt_state"]["mu"].items()
                for n, m in ps.items()}

    def release(self):
        self.state = self.step_fn = self.arrays = self.optimizer = self.model = self.ctx = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _rebuild(self, b):
        view = int(b["cap_id"])
        n = b["origin"].shape[0]
        views = torch.full((n,), view, dtype=torch.long, device=self.device)
        xi, yi, off = self._recover_pixels(b, views)
        w = self.traffic["width"]
        cls = self.scene["classes"][view, yi * w + xi]
        # the strata: [patch or stratified 1024 | stratified rest] (without
        # the LPIPS patch one stratified run), each [body | border |
        # background (outside the mask)]
        c = self.c
        wrong = off
        if c["penalize_lpips"] <= 0:
            segments = [(0, n)]
        elif int(b["patch_counter"]):
            x0, y0 = int(xi[0]), int(yi[0])
            d = torch.arange(PATCH * PATCH, device=self.device)
            wrong += int(((xi[:PATCH * PATCH] != x0 + d % PATCH) | (yi[:PATCH * PATCH] != y0 + d // PATCH)).sum())
            segments = [(PATCH * PATCH, n - PATCH * PATCH)]
        else:
            segments = [(0, PATCH * PATCH), (PATCH * PATCH, n - PATCH * PATCH)]
        for lo, num in segments:
            counts = sampler.num_rays_split(num, c["body_rays_ratio"], c["border_rays_ratio"],
                                            c["bkg_rays_ratio"], c["dilation"])
            at = lo
            for cnt, ok in zip(counts, ((0,), (1,), (1, 2))):
                seg = cls[at:at + cnt]
                wrong += int((~torch.isin(seg, torch.tensor(ok, device=seg.device, dtype=seg.dtype))).sum())
                at += cnt
        o, d, color = self._rebuild_common(views, xi, yi)
        near, far = mesh_ref.near_far(o, d, self.scene["verts"][view], self.geo)
        hit = near < far
        wrong += int((hit != b["is_hit"].bool()).sum())
        ref = {
            "origin": o, "direction": d, "color": color,
            "human_near": torch.where(hit, near, self.scene["near_human"][view])[:, None],
            "human_far": torch.where(hit, far, self.scene["far_human"][view])[:, None],
            "bkg_near": self.scene["near_bkg"][view].expand(n)[:, None],
            "bkg_far": self.scene["far_bkg"][view].expand(n)[:, None],
            "is_bkg": (self.scene["masks"][view, yi, xi] == 0).to(torch.int32),
            "is_hit": hit.to(torch.int32),
        }
        gap = max(float((ref[k].float() - b[k].float()).abs().max()) for k in ref)
        # judged above, the human near and far are taken as the program drew
        # them: near the spheres' rims they are differences of nearly equal
        # numbers, and f32 rounding there moves every sample of the ray
        ref.update(human_near=b["human_near"], human_far=b["human_far"],
                   cur_view_f=self.scene["viewf"][view], cap_id=view, patch_counter=b["patch_counter"])
        return ref, wrong, gap

    def _reference(self, batches, prec):
        w = {"poses": self.fr["poses"].clone().requires_grad_(True)}
        for short, net in (("can.", "can"), ("off.", "off")):
            w.update({short + n: t.clone().requires_grad_(True) for n, t in self.w0[net].items()})
        adam = steps_ref.Adam({k: v.detach() for k, v in w.items()})
        faces = self.body["faces"]
        scene = {"bkg_coarse": self.w0["bkg_coarse"], "bkg_fine": self.w0["bkg_fine"], "body": self.body,
                 "betas": self.fr["betas"], "faces": faces,
                 "inc": mesh_ref.incidence(faces, self.body["v_template"].shape[0]),
                 "can_verts": self.fr["can_verts"], "can_k": self.can_k, "can_c2w": self.can_c2w,
                 "can_hw": (self.traffic["height"], self.traffic["width"]), "interval_comp": 1.0,
                 "lpips": self.lpips, "frame_ids": torch.as_tensor(self.views, device=self.device),
                 "grad_masks": torch.ones(self.traffic["frames"], 72, device=self.device)}
        losses, grad1 = [], None
        for i, (b, st) in enumerate(zip(batches, self.gen_states)):
            gen = torch.Generator(self.device)
            gen.set_state(st)
            losses.append(steps_ref.human_step(w, adam, scene, b, gen, self.c, self.traffic["iteration"],
                                               prec))
            if i == 0:
                grad1 = {k: m / (1.0 - steps_ref.B1) for k, m in adam.mu.items()}
        return losses, grad1, {k: v.detach() for k, v in w.items()}

    def work(self):
        c = self.c
        r, s, i = c["rays_per_batch"], c["samples_per_ray"], c["importance_samples_per_ray"]
        macs, params = _mlp_macs(c, "can")
        can = flops.mlp_work(macs, params, 4 * r * s, 4 * r, True, True)
        sparsity = flops.mlp_work(macs, params, steps_ref.NUM_CAN_RAYS * s, steps_ref.NUM_CAN_RAYS, False, True)
        bkg = flops.mlp_work(macs, params, r * (2 * s + i), 2 * r, False, False)
        omacs, oparams = _mlp_macs(c, "off")
        off = flops.mlp_work(omacs, oparams, r * s, r, False, True, planes_in=4, outs=3)
        nerf_f = can[0] + sparsity[0] + bkg[0]
        return {"nerf_mlp": (nerf_f, can[1] + sparsity[1] + bkg[1]), "model_flops": nerf_f + off[0],
                "dtype": c["compute_dtype"]}


# ---------------------------------------------------------------- rendering


class RenderRunner(Runner):
    """Frames of the traffic's cameras, cycled; one warm-up frame in the
    set-up. A seeded reservoir keeps `check_frames` of the window's frames
    (RGB on the host) for the check."""

    unit_name = "frame"

    def _setup_model(self):
        gen = inputs.generator(self.seed, self.device)
        self.w0 = inputs.weights(self.c, gen, inputs.NETS)
        self.body = inputs.body(self.device)
        self.fr = inputs.frames(self.traffic, gen, self.body)
        self.geo = self.fr["bone"]
        self.ncfg = port_config(self.cfg, render=True)
        self.spec = hn.build_human_nerf_spec(self.ncfg)
        self.model = hn.HumanNeRF(self.spec, device=self.device)
        for net, mod in (("bkg_coarse", self.model.coarse_bkg_net), ("bkg_fine", self.model.fine_bkg_net),
                         ("can", self.model.coarse_human_net), ("off", self.model.offset_nets[0])):
            mod.nerf.load_state_dict(self.w0[net])
        self.model.requires_grad_(False)
        self.faces = self.body["faces"].cpu().numpy()
        self.topo = mesh_ops.MeshTopology.build(self.faces, self.body["v_template"].shape[0], self.device)
        self.kept, self.done, self.order = [], 0, []
        self.rng = random.Random(self.seed)

    def _cap(self, k, c2w):
        h, w = self.traffic["height"], self.traffic["width"]
        return types.SimpleNamespace(
            shape=(h, w), intrinsic_matrix=k.cpu().numpy(),
            cam_pose=types.SimpleNamespace(camera_to_world=c2w.cpu().numpy()),
            near={"bkg": self.traffic["bkg_near"]}, far={"bkg": self.traffic["bkg_far"]})

    def unit(self, draw_events=None):
        i = self.done % len(self.cams)
        self.order.append(i)
        rgb = self._frame(i).cpu()
        if not bool(torch.isfinite(rgb).all()):
            self.failed += 1
        # reservoir sampling of the frames kept for the check
        n = self.traffic["check_frames"]
        if len(self.kept) < n:
            self.kept.append((i, rgb))
        else:
            j = self.rng.randrange(self.done + 1)
            if j < n:
                self.kept[j] = (i, rgb)
        self.done += 1

    def finish_window(self):
        self.window_frames = self.done

    def release(self):
        self.model = self.spec = self.topo = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample_rays(self, i, hit_mask):
        """Pixels of frame i to check: half drawn over the frame, half over
        the pixels whose rays pass the body, from the seed."""
        gen = torch.Generator(self.device).manual_seed(self.seed * 1000 + i)
        n = self.traffic["check_rays"] // 2
        total = hit_mask.numel()
        every = torch.randint(0, total, (n,), generator=gen, device=self.device)
        hits = torch.nonzero(hit_mask).squeeze(1)
        if hits.numel():
            every = torch.cat([every, hits[torch.randint(0, hits.numel(), (n,), generator=gen, device=self.device)]])
        return every

    def check(self, control=None):
        """{number: value} of the kept frames against the reference; with a
        `control` Precision, also those of the reference computed in it.
        Each frame's readings stay in `self.frame_gaps`."""
        self.release()
        self.unsettled = 0
        gaps = {"rgb_max_gap": [], "rgb_mean_gap": []}
        ctrl = {"rgb_max_gap": [], "rgb_mean_gap": []}
        self.frame_gaps = (gaps, ctrl)
        for i, rgb in self.kept:
            px, rays = self._check_rays(i)
            ref = self._reference(i, rays, F32)
            for out, got in ((gaps, rgb.to(self.device).reshape(-1, 3)[px]),
                             (ctrl, None if control is None else self._reference(i, rays, control))):
                if got is not None:
                    diff = (got - ref).abs()
                    out["rgb_max_gap"].append(float(diff.max()))
                    out["rgb_mean_gap"].append(float(diff.mean()))
        numbers = {k: max(v) for k, v in gaps.items()}
        return numbers if control is None else (numbers, {k: max(v) for k, v in ctrl.items()})

    def _check_rays(self, i):
        """(pixel ids, their rays) of frame i that the check renders: the
        seeded sample less its rays whose hit test f32 cannot settle
        (`mesh_ref.unsettled`), counted in `self.unsettled`."""
        o, d = self._pixels(i)
        v = self._verts(i)
        near, _ = mesh_ref.near_far(o, d, v, self.geo)
        px = self._sample_rays(i, torch.isfinite(near))
        keep = ~mesh_ref.unsettled(o[px], d[px], v, self.geo)
        self.unsettled += int((~keep).sum())
        px = px[keep]
        return px, (o[px], d[px])

    def _pixels(self, i):
        h, w = self.traffic["height"], self.traffic["width"]
        ys, xs = torch.meshgrid(torch.arange(h, device=self.device), torch.arange(w, device=self.device),
                                indexing="ij")
        xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
        return nerf_ref.rays(xy, self.cams[i][0], self.cams[i][1])

    @torch.no_grad()
    def hits(self, i):
        """Count of frame i's rays that pass within the radius of a vertex
        (products in f32, TF32 off): the human branch's rays."""
        o, d = self._pixels(i)
        v = self._verts(i)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        count = 0
        for oc, dc in zip(o.split(32768), d.split(32768)):
            z0 = dc @ v.T - (dc * oc).sum(-1, keepdim=True)
            dist2 = (v * v).sum(-1)[None] - 2.0 * (oc @ v.T) + (oc * oc).sum(-1, keepdim=True)
            count += int(((dist2 - z0**2) <= self.geo**2).any(1).sum())
        torch.backends.cuda.matmul.allow_tf32 = saved
        return count

    def trace_hits(self):
        """(mean hit rays a frame of the window, of the traced frames)."""
        cache = {i: self.hits(i) for i in set(self.order)}
        mean = lambda idx: sum(cache[i] for i in idx) / max(len(idx), 1)
        return mean(self.order[:self.window_frames]), mean(self.order[self.window_frames:])


class RenderHybrid(RenderRunner):
    """`render_hybrid_nerf` over the video's held-out frames."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self._setup_model()
        fr = self.fr
        self.frame_ids = [i for i in range(traffic["frames"]) if i % traffic["test_every"] == traffic["test_offset"]]
        self.cams = [(fr["k"][i], fr["c2w"][i]) for i in self.frame_ids]
        self.caps = [self._cap(*c) for c in self.cams]
        self.unit()
        self.kept, self.done, self.order = [], 0, []
        _sync(self.device)

    def _verts(self, i):
        return self.fr["verts"][self.frame_ids[i]]

    def _frame(self, i):
        c, f = self.c, self.frame_ids[i]
        return renderer.render_hybrid_nerf(
            self.spec, self.model, self.caps[i], self.fr["verts"][f], self.faces, self.fr["ts"][f],
            self.device, rays_per_batch=c["render_rays_per_batch"], samples_per_ray=c["samples_per_ray"],
            importance_samples_per_ray=c["importance_samples_per_ray"], geo_threshold=self.geo,
            knn_k=c["knn_k"], knn_stride=c["knn_stride"], topology=self.topo)[0]

    def _reference(self, i, rays, prec):
        f = self.frame_ids[i]
        faces = self.body["faces"]
        inc = mesh_ref.incidence(faces, self.body["v_template"].shape[0])
        return render_ref.hybrid(self.w0, *rays, self.traffic["bkg_near"], self.traffic["bkg_far"],
                                 self.fr["verts"][f], self.fr["ts"][f], faces, inc, self.geo, self.c, prec)

    def work(self, hits=None):
        c = self.c
        h, w = self.traffic["height"], self.traffic["width"]
        rays, s, imp = h * w, c["samples_per_ray"], c["importance_samples_per_ray"]
        macs, params = _mlp_macs(c, "can")
        bkg = flops.mlp_work(macs, params, rays * (2 * s + imp), 2 * rays, False, False)
        hits = 0 if hits is None else hits
        hum = flops.mlp_work(macs, params, hits * s, hits, True, False)
        f = bkg[0] + hum[0]
        return {"nerf_mlp": (f, bkg[1] + hum[1]), "model_flops": f, "dtype": c["render_compute_dtype"]}


class RenderCanonical(RenderRunner):
    """`render_smpl_nerf(render_can=True)` over the canonical 360 path."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self._setup_model()
        k, c2w = inputs.canonical_cameras(self.fr["can_verts"], self.body, traffic["cameras"],
                                          traffic["canonical_distance"], traffic["canonical_focal"],
                                          traffic["height"], traffic["width"])
        self.cams = list(zip(k, c2w))
        self.caps = [self._cap(*cam) for cam in self.cams]
        self.unit()
        self.kept, self.done, self.order = [], 0, []
        _sync(self.device)

    def _verts(self, i):
        return self.fr["can_verts"]

    def _frame(self, i):
        c = self.c
        return renderer.render_smpl_nerf(
            self.spec, self.model, self.caps[i], self.fr["can_verts"], self.faces, None, self.device,
            rays_per_batch=c["render_rays_per_batch"], samples_per_ray=c["samples_per_ray"], render_can=True,
            geo_threshold=self.geo, interval_comp=1.0, knn_k=c["knn_k"], knn_stride=c["knn_stride"],
            topology=self.topo)[0]

    def _reference(self, i, rays, prec):
        return render_ref.canonical(self.w0["can"], *rays, self.fr["can_verts"], self.geo, 1.0, self.c, prec)

    def work(self, hits=None):
        c = self.c
        macs, params = _mlp_macs(c, "can")
        hits = 0 if hits is None else hits
        f, b = flops.mlp_work(macs, params, hits * c["samples_per_ray"], hits, False, False)
        return {"nerf_mlp": (f, b), "model_flops": f, "dtype": c["render_compute_dtype"]}


KINDS = {"train_bkg": TrainBkg, "train_human": TrainHuman, "render_hybrid": RenderHybrid,
         "render_canonical": RenderCanonical}
