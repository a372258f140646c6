"""Human NeRF trainer, stage 2: SMPL poses, offset net and canonical volume
trained together (counterpart of neuman_tpu/trainers/human.py, its planar
production formulation).

Per step, all on the device:
- the frozen background branch (coarse -> fine, forward only);
- the human branch: stratified samples in the body's depth range -> offset
  net on (x, y, z, t) -> `vertex_forward` of the frame's SMPL pose -> the
  differentiable inverse-LBS warp (closest point by the bucketed vertex KNN
  and the Ericson kernel) -> the canonical net with finite-difference view
  directions; the main, symmetry, colour-range and shape-dummy applications
  of the canonical net run as one batch on the ray axis;
- losses (`LOSS_NAMES`): z-merged RGB on hit rays, LPIPS on the leading
  32x32 patch, colour range, SMPL symmetry, SMPL shape by the signed
  distance with clustered dummy points, mask, and sparsity (hard surface,
  sharp edge) on rays of a random canonical camera;
- the update: NaN / dead-net skip, DensePose gating of the pose gradient,
  Adam with per-group learning rates (`smpl_lr` for the poses), the penalty
  anneals and the offset-scale ramp, and a restart of the canonical and
  offset nets when the canonical net dies.

Trainable: `poses`, the canonical net and (unless train_mode is
"smpl_only") the offset nets; betas, alignments and both background nets
are frozen. Every MLP application and mesh query runs a hand-written
kernel on the card (`KERNELS`); `PLAIN_FUNCTIONS` and `PLAIN` run the
kernels' plain versions, to hold the kernels to.

Spans of utils/tracing.py: the background trainer's `step.backward`,
`step.optimizer` and `step.readback`, and `human.warp` (`vertex_forward`
and the warp) and `human.lpips`; while a profiler records, the warp adds
the most samples that share one closest face to `warp.face_pileup`.
`--profile_dir` traces `--profile_steps` steps from iteration 1.
"""

import dataclasses
import functools
import os
from typing import Callable

import numpy as np
import torch

from neuman_tpu_torch import convert
from neuman_tpu_torch.datasets import sampler
from neuman_tpu_torch.datasets.arrays import build_scene_arrays
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import lpips as lpips_module
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.ops import volume
from neuman_tpu_torch.ops.kernels.nerf_mlp import dir_projection, nerf_mlp_plain
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn, with_tape_mode
from neuman_tpu_torch.ops.kernels.offset_mlp import offset_mlp_fn, offset_mlp_plain
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.trainers import checkpoint as ckpt
from neuman_tpu_torch.trainers import logging as tlog
from neuman_tpu_torch.trainers.background import DTYPES, make_optimizer
from neuman_tpu_torch.render import rasterize, renderer
from neuman_tpu_torch.utils.canonical_cameras import canonical_cameras, canonical_capture
from neuman_tpu_torch.utils.constants import (
    CANONICAL_CAMERA_DIST,
    HARD_SURFACE_OFFSET,
    PATCH_SIZE,
    PATCH_SIZE_SQUARED,
)
from neuman_tpu_torch.utils import tracing

LOSS_NAMES = [
    "fine_rgb_loss",
    "lpips_loss",
    "color_range_reg",
    "smpl_sym_reg",
    "smpl_shape_reg",
    "mask_loss",
    "sparsity_reg",
]
NUM_CAN_RAYS = 128
# the groups of trainable parameters, by their prefix in the model
TRAINED = ("poses", "coarse_human_net", "offset_nets")


@dataclasses.dataclass(frozen=True)
class Ops:
    """Which implementation of each kernel-backed function a loss runs."""

    mlp: Callable  # the NeRF MLP, differentiable (the frozen background runs it without grad)
    offset: Callable  # the offset net's MLP, differentiable
    mesh_kernels: bool  # the closest-point and KNN kernels, or their plain versions
    # the shape regulariser's two signed-distance queries: closest point and
    # sign in one kernel (`ericson_signed_select`), or `ericson_select` and
    # the sign in PyTorch (the default, as in the JAX trainer)
    fused_signed_distance: bool = False


# the kernels (on CPU tensors each wrapper runs its plain version)
KERNELS = Ops(nerf_mlp_fn, offset_mlp_fn, True)
# the kernels, with the fused signed-distance query
KERNELS_FUSED = dataclasses.replace(KERNELS, fused_signed_distance=True)
# the kernels' plain versions inside the same autograd Functions: rounded at
# the kernels' points in bf16, forward and backward
PLAIN_FUNCTIONS = Ops(functools.partial(nerf_mlp_fn, plain=True),
                      functools.partial(offset_mlp_fn, plain=True), False)
# autograd of the plain forwards: independent of the backward kernels
PLAIN = Ops(nerf_mlp_plain, offset_mlp_plain, False)


def densepose_name_to_idx():
    return {
        "Torso": [1, 2], "Right Hand": [3], "Left Hand": [4],
        "Left Foot": [5], "Right Foot": [6],
        "Upper Leg Right": [7, 9], "Upper Leg Left": [8, 10],
        "Lower Leg Right": [11, 13], "Lower Leg Left": [12, 14],
        "Upper Arm Left": [15, 17], "Upper Arm Right": [16, 18],
        "Lower Arm Left": [19, 21], "Lower Arm Right": [20, 22],
        "Head": [23, 24],
    }


def turn_smpl_gradient_off(dp_mask):
    """[72] pose-gradient mask from the DensePose parts visible in `dp_mask`:
    the joints of a body part that is not seen get no gradient."""
    grad_mask = np.ones([24, 3])
    idx2name = {i: name for name, ids in densepose_name_to_idx().items() for i in ids}
    present = np.unique(dp_mask)
    visible = {idx2name[i] for i in range(1, 25) if i in present}
    rules = [
        ("Upper Leg Left", [1]), ("Upper Leg Right", [2]),
        ("Lower Leg Left", [4]), ("Lower Leg Right", [5]),
        ("Left Foot", [7, 10]), ("Right Foot", [8, 11]),
        ("Upper Arm Left", [16]), ("Upper Arm Right", [17]),
        ("Lower Arm Left", [18]), ("Lower Arm Right", [19]),
        ("Left Hand", [20, 22]), ("Right Hand", [21, 23]),
        ("Head", [12, 15]),
    ]
    for name, joints in rules:
        if name not in visible:
            grad_mask[joints] = 0
    return grad_mask.reshape(-1)


def build_pose_grad_masks(scene, view_indices, device=None):
    """[N, 72] per-frame pose gradient masks (ones without DensePose)."""
    masks = []
    for i in view_indices:
        dp = getattr(scene.captures[i], "densepose", None)
        masks.append(np.ones(72, np.float32) if dp is None
                     else turn_smpl_gradient_off(dp).astype(np.float32))
    return torch.as_tensor(np.stack(masks), device=device)


def clustered_box_points(generator, r, s, group=1, half=1.5, jitter=0.005, device=None):
    """[r, s, 3] uniform dummy samples in the [-half, half]^3 box (the
    shape regulariser's domain), drawn in groups of `group` consecutive
    points that lie close together, so that the group KNN stride applies to
    the signed-distance query on them. Each group shares a uniform anchor;
    members add uniform jitter in [-jitter, jitter]^3 and reflect at the
    walls, which keeps every point's marginal uniform over the box.
    group = 1 (or s % group != 0) is plain uniform sampling."""
    rand = lambda *shape: torch.rand(*shape, generator=generator, device=device)
    if group <= 1 or s % group:
        return (rand(r, s, 3) - 0.5) * (2.0 * half)
    a = (rand(r, s // group, 1, 3) - 0.5) * (2.0 * half)
    j = (rand(r, s // group, group, 3) - 0.5) * (2.0 * jitter)
    t = (a + j + half).abs()
    t = 2.0 * half - (2.0 * half - t).abs()
    return (t - half).reshape(r, s, 3)


def _hard_surface(x):
    return torch.mean(-torch.log(torch.exp(-x.abs()) + torch.exp(-(1 - x).abs()))
                      + HARD_SURFACE_OFFSET)


def make_human_loss_fn(model, opt, ctx, parity_inject=None, ops=KERNELS, mesh=None):
    """loss_fn(batch, generator, anneals) -> (total, {"losses", "dead"}) for
    the HumanNeRF `model` (nets and SMPL state).

    With a data `mesh` (parallel/mesh.py) the batch is this rank's rows
    and every loss is this rank's share of the global one: each draw is
    made at the global shape and sliced, each mean divides by the global
    count, the sparsity term's canonical rays (not rays of the batch) are
    rendered whole on every rank, which takes 1 / size of the term, the
    LPIPS patch's fine colours are gathered from every rank and rank 0
    scores the patch (its gradient comes back to every rank's rows), and
    the dead-net test is the maximum over the ranks. The pinned draws of
    `parity_inject` then hold every rank's rows (the canonical rays' are
    the same on every rank).

    ctx: body_model, da_smpl, scale, topo, can_verts [N, V, 3], can_k
    [C, 3, 3], can_c2w [C, 4, 4], can_hw, interval_comp, lpips_params,
    scene_ids, knn_k, knn_stride. Every random draw comes from `generator`
    (on the batch's device). parity_inject (tests): a dict that pins draws
    to given arrays, with the JAX package's keys: "color_dirs" [R, S, 3]
    unit directions, "dummy_pts" [R, S, 3] box points, "can_cam" int,
    "can_x" / "can_y" [128] pixel coordinates."""
    pi = parity_inject or {}
    spec = model.spec
    body_model, da_smpl, topo, knn_k = ctx["body_model"], ctx["da_smpl"], ctx["topo"], ctx["knn_k"]
    knn_stride = mesh_ops.stride_for(opt.samples_per_ray, ctx.get("knn_stride", 1))
    cd = DTYPES[opt.compute_dtype]
    ops = dataclasses.replace(ops, mlp=with_tape_mode(ops.mlp, opt.mlp_tape),
                              offset=with_tape_mode(ops.offset, opt.mlp_tape))
    mesh_kw = dict(k=knn_k, knn_stride=knn_stride, knn_impl="bucketed",
                   use_kernels=ops.mesh_kernels)
    # the canonical vertices are the same from step to step: their query
    # tables are built once, stacked over the views
    can_verts = torch.as_tensor(ctx["can_verts"])
    tables = [mesh_ops.build_query_tables(v, topo) for v in can_verts]
    can_vtab9 = torch.stack([t.vtab9 for t in tables])
    can_vn_pack = torch.stack([t.vn_pack for t in tables])
    can_vntab9 = (torch.stack([t.vntab9 for t in tables]) if ops.fused_signed_distance
                  else [None] * len(tables))
    incidence = tables[0].incidence
    del tables

    def ray_planes(origin, direction, z):
        return [origin[:, a, None] + direction[:, a, None] * z for a in range(3)]

    def eval_bkg(batch):
        origin, direction = batch["origin"], batch["direction"]
        dir_norm = torch.linalg.norm(direction, dim=-1)
        with torch.no_grad():
            def run(net, z):
                dirp = dir_projection(spec.bkg, net, direction, cd)
                return ops.mlp(spec.bkg, net, *ray_planes(origin, direction, z),
                               dir_part=dirp, compute_dtype=cd)

            z = ray_ops.sample_z_vals(batch["bkg_near"], batch["bkg_far"], opt.samples_per_ray)
            sg, rgb_c = run(model.coarse_bkg_net.nerf, z)
            w = volume.integrate_planar(sg, rgb_c, z, dir_norm, opt.white_bkg)[3]
            f_z = volume.importance_z(z, w, opt.importance_samples_per_ray)
            sgf, rgb_cf = run(model.fine_bkg_net.nerf, f_z)
        return dir_norm, f_z, sgf, rgb_cf

    def eval_human(batch, generator, offset_scale):
        origin, direction = batch["origin"], batch["direction"]
        z = ray_ops.sample_z_vals(batch["human_near"], batch["human_far"], opt.samples_per_ray,
                                  perturb=opt.perturb, generator=generator,
                                  rand=pmesh.sharded_draw(torch.rand, mesh))
        r, s = z.shape
        planes = ray_planes(origin, direction, z)
        t_plane = batch["cur_view_f"].expand(r, s).contiguous()
        which = 0
        if spec.num_offset_nets > 1:
            which = int(torch.randint(0, spec.num_offset_nets, (), generator=generator,
                                      device=z.device))
        off = model.offset_nets[which](planes + [t_plane], offset_scale, cd, mlp=ops.offset)
        scene_id = ctx["scene_ids"][batch["cap_id"]]
        with tracing.span("human.warp"):
            verts, ts = hn.vertex_forward(model, body_model, da_smpl, ctx["scale"], scene_id)
            flat = torch.stack([p.reshape(-1) for p in planes], dim=-1)  # [N, 3]
            can_flat, f_id = mesh_ops.warp_points_to_canonical_diff(flat, verts[0], ts[0], topo,
                                                                    **mesh_kw)
            if tracing.enabled():  # the most samples that share one closest face
                tracing.count("warp.face_pileup", torch.zeros(
                    topo.faces.shape[0], dtype=torch.int32, device=f_id.device).index_add_(
                        0, f_id, torch.ones_like(f_id, dtype=torch.int32)).max())
        can_planes = [can_flat[:, a].reshape(r, s) + off[a] for a in range(3)]
        diffs = [p[:, 1:] - p[:, :-1] for p in can_planes]
        diffs = [torch.cat([p, p[:, -1:]], dim=1) for p in diffs]
        norm = torch.sqrt(diffs[0] ** 2 + diffs[1] ** 2 + diffs[2] ** 2) + 1e-20
        return z, can_planes, [p / norm for p in diffs]

    def pinned(key, device):  # a pinned draw holds every rank's rows
        return lambda n: torch.as_tensor(pi[key], dtype=torch.float32, device=device)

    def color_dummy_dirs(generator, r, s, device):
        if "color_dirs" in pi:
            draw = pinned("color_dirs", device)
        else:
            def draw(n):
                dummy = torch.randn(n, s, 3, generator=generator, device=device)
                return dummy / torch.linalg.norm(dummy, dim=-1, keepdim=True)
        dummy = pmesh.draw_rows(draw, r, mesh)
        return [dummy[..., a] for a in range(3)]

    def shape_dummy_planes(generator, r, s, device):
        if "dummy_pts" in pi:
            draw = pinned("dummy_pts", device)
        else:
            # clustered, so that the group KNN stride applies to them too
            draw = lambda n: clustered_box_points(generator, n, s, group=knn_stride,
                                                  device=device)
        dummy = pmesh.draw_rows(draw, r, mesh)
        return [dummy[..., a] for a in range(3)]

    def color_range_reg(d_rgb, rgb_c, weight):
        r, s = rgb_c[0].shape
        rows = r if mesh is None else r * mesh.size
        se = sum(((torch.sigmoid(d_rgb[c]) - torch.sigmoid(rgb_c[c])) ** 2).sum()
                 for c in range(3))
        return se / (3 * rows * s) * weight

    def sym_reg(sg, sg_flip, weight):
        return pmesh.mean((torch.tanh(torch.relu(sg)) - torch.tanh(torch.relu(sg_flip))) ** 2,
                          mesh) * weight

    def shape_reg(batch, can_planes, sg, d_planes, d_sg, w_alpha, w_dummy):
        cap = batch["cap_id"]
        verts = can_verts[cap]
        tabs = mesh_ops.QueryTables(can_vtab9[cap], can_vn_pack[cap], can_vntab9[cap], incidence)
        sd_kw = dict(mesh_kw, tables=tabs, fused=ops.fused_signed_distance)
        flat = torch.stack([p.reshape(-1) for p in can_planes], dim=-1).detach()
        # warped ray samples stay consecutive along a ray: the stride applies
        with torch.no_grad():
            sd = mesh_ops.signed_distance(flat, verts, topo, **sd_kw)[0]
            dummy_flat = torch.stack([p.reshape(-1) for p in d_planes], dim=-1)
            sd_d = mesh_ops.signed_distance(dummy_flat, verts, topo, **sd_kw)[0]
        occ = 1.0 - torch.exp(-torch.relu(sg.reshape(-1)))
        reg = pmesh.masked_mean((occ - 1.0) ** 2, (sd < 0).float(), mesh) * w_alpha
        d_occ = 1.0 - torch.exp(-torch.relu(d_sg.reshape(-1)))
        reg = reg + pmesh.masked_mean((d_occ - 1.0) ** 2, (sd_d < 0).float(), mesh) * w_dummy
        outside_val = d_occ * torch.pow(sd_d.abs() * opt.penalize_outside_factor,
                                        opt.dist_exponent)
        outside_val = outside_val ** 2 if opt.penalize_outside_loss == "mse" else outside_val.abs()
        return reg + pmesh.masked_mean(outside_val, (sd_d > 0).float(), mesh) * w_dummy

    def sparsity_reg(generator, device):
        # not rays of the batch: every rank renders all of them from the
        # same draws (its generator stays in step) and takes 1 / size of
        # the term, so that the sum over the ranks is the unsharded term
        h, w = ctx["can_hw"]
        if "can_x" in pi:
            c = int(pi.get("can_cam", 0))
            x = torch.as_tensor(pi["can_x"], dtype=torch.float32, device=device)
            y = torch.as_tensor(pi["can_y"], dtype=torch.float32, device=device)
        else:
            draw = lambda hi, shape: torch.randint(0, hi, shape, generator=generator,
                                                   device=device)
            c = draw(ctx["can_k"].shape[0], ())
            x, y = draw(w, (NUM_CAN_RAYS,)).float(), draw(h, (NUM_CAN_RAYS,)).float()
        origin, direction = ray_ops.pixels_to_rays(torch.stack([x, y], dim=-1), ctx["can_k"][c],
                                                   ctx["can_c2w"][c])
        near = torch.zeros(NUM_CAN_RAYS, 1, device=device)
        far = torch.full((NUM_CAN_RAYS, 1), CANONICAL_CAMERA_DIST * 1.667, device=device)
        z = ray_ops.sample_z_vals(near, far, opt.samples_per_ray, perturb=opt.perturb,
                                  generator=generator)
        net = model.coarse_human_net.nerf
        dirp = dir_projection(spec.human, net, direction, cd)
        sg, rgb_c = ops.mlp(spec.human, net, *ray_planes(origin, direction, z), dir_part=dirp,
                            compute_dtype=cd)
        dir_norm = torch.linalg.norm(direction, dim=-1)
        _, _, can_mask, can_w, _ = volume.integrate_planar(
            sg * ctx["interval_comp"], rgb_c, z, dir_norm, white_bkg=True)
        reg = 0.0
        if opt.penalize_sharp_edge > 0:
            reg = reg + _hard_surface(can_mask.clamp(0.0, 1.0)) * opt.penalize_sharp_edge
        if opt.penalize_hard_surface > 0:
            reg = reg + _hard_surface(can_w.clamp(0.0, 1.0)) * opt.penalize_hard_surface
        return reg if mesh is None else reg / mesh.size

    def loss_fn(batch, generator, anneals):
        device = batch["origin"].device
        losses = {name: torch.zeros((), device=device) for name in LOSS_NAMES}
        dir_norm, fine_z, f_sg, f_rgb_c = eval_bkg(batch)
        human_z, can_planes, can_dir_planes = eval_human(batch, generator,
                                                         anneals["offset_scale"])

        # the main, symmetry, colour-range and shape-dummy applications run
        # the same net on [R, S] per-sample inputs: one application on the
        # concatenated ray axis, one dW pass in its backward
        r_app, s_app = can_planes[0].shape
        apps = [(can_planes, can_dir_planes)]
        do_sym = opt.penalize_symmetric_alpha > 0
        do_color = opt.penalize_color_range > 0
        do_shape = opt.penalize_smpl_alpha > 0
        if do_sym:
            apps.append(([-can_planes[0].detach(), can_planes[1].detach(),
                          can_planes[2].detach()], [p.detach() for p in can_dir_planes]))
        if do_color:
            apps.append((can_planes, color_dummy_dirs(generator, r_app, s_app, device)))
        if do_shape:
            d_planes_shape = shape_dummy_planes(generator, r_app, s_app, device)
            apps.append((d_planes_shape, can_dir_planes))
        big_p = [torch.cat([a[0][c] for a in apps], dim=0) for c in range(3)]
        big_d = [torch.cat([a[1][c] for a in apps], dim=0) for c in range(3)]
        big_sg, big_rgb = ops.mlp(spec.human, model.coarse_human_net.nerf, *big_p,
                                  dir_planes=big_d, compute_dtype=cd)
        chunks_sg = big_sg.split(r_app)
        chunks_rgb = list(zip(*[c.split(r_app) for c in big_rgb]))
        h_sg, h_rgb_c = chunks_sg[0], list(chunks_rgb[0])
        ai = 1
        if do_sym:
            losses["smpl_sym_reg"] = sym_reg(h_sg, chunks_sg[ai], anneals["sym_w"])
            ai += 1
        if do_color:
            losses["color_range_reg"] = color_range_reg(chunks_rgb[ai], h_rgb_c,
                                                        opt.penalize_color_range)
            ai += 1
        if do_shape:
            losses["smpl_shape_reg"] = shape_reg(batch, can_planes, h_sg, d_planes_shape,
                                                 chunks_sg[ai], anneals["smpl_alpha_w"],
                                                 anneals["dummy_w"])
        if opt.penalize_mask > 0:
            human_mask = volume.integrate_planar(h_sg, h_rgb_c, human_z, dir_norm,
                                                 opt.white_bkg)[2]
            tgt = (1 - batch["is_bkg"]).float()
            losses["mask_loss"] = pmesh.mean((human_mask.clamp(0.0, 1.0) - tgt) ** 2,
                                             mesh) * anneals["mask_w"]
        if opt.penalize_sharp_edge > 0 or opt.penalize_hard_surface > 0:
            losses["sparsity_reg"] = sparsity_reg(generator, device)

        total_z, total_sg, total_rgb_c = volume.sort_merge_planar(
            [fine_z, human_z], [f_sg, h_sg], [f_rgb_c, h_rgb_c])
        fine_rgb_map = volume.integrate_planar(total_sg, total_rgb_c, total_z, dir_norm,
                                               opt.white_bkg)[0]
        se = torch.mean((fine_rgb_map - batch["color"]) ** 2, dim=-1)
        losses["fine_rgb_loss"] = pmesh.masked_mean(se, batch["is_hit"].float(), mesh)

        if opt.penalize_lpips > 0 and ctx["lpips_params"] is not None:
            rgb_all, color_all = fine_rgb_map, batch["color"]
            if mesh is not None:  # the patch may straddle ranks: every rank's rows
                rgb_all, color_all = mesh.gather_rows(rgb_all), mesh.gather_rows(color_all)
            if mesh is None or mesh.rank == 0:
                as_img = lambda t: t[:PATCH_SIZE_SQUARED].reshape(
                    PATCH_SIZE, PATCH_SIZE, 3).permute(2, 0, 1)[None] * 2 - 1
                with tracing.span("human.lpips"):
                    d = lpips_module.lpips(ctx["lpips_params"], as_img(rgb_all),
                                           as_img(color_all))[0]
                losses["lpips_loss"] = d * opt.penalize_lpips * batch["patch_counter"].float()
            else:
                # rank 0 scores the patch; this rank's share is 0, but its loss
                # must reach gather_rows, whose backward every rank joins
                losses["lpips_loss"] = 0.0 * rgb_all[:PATCH_SIZE_SQUARED].sum()

        # a dead canonical net zeroes every loss and is restarted by the step
        h_max = h_sg.detach().max()
        if mesh is not None:
            h_max = mesh.all_reduce(h_max.clone(), op="max")
        dead = h_max <= 0.0
        losses = {k: torch.where(dead, 0.0, v) for k, v in losses.items()}
        losses["rgb_loss"] = (losses["fine_rgb_loss"] + losses["color_range_reg"]
                              + losses["lpips_loss"])
        losses["can_loss"] = losses["smpl_sym_reg"] + losses["smpl_shape_reg"]
        total = losses["can_loss"] + losses["mask_loss"] + losses["sparsity_reg"]
        if anneals["iteration"] >= opt.delay_iters:
            total = total + losses["rgb_loss"]
        losses["total_loss"] = total
        return total, {"losses": losses, "dead": dead}

    return loss_fn


def compute_anneals(opt, it):
    """The schedule scalars of iteration `it`: the penalty weights, linear
    to 0 over 60k iterations (the mask's always, the others with
    `prior_knowledge_decay`), the offset-scale ramp after `offset_delay`,
    and the two learning rates."""
    decay = max(0.0, 1.0 - it / 60000.0)
    prior = decay if opt.prior_knowledge_decay else 1.0
    ramp = (opt.offset_lim - opt.offset_scale) * max(0.0, (it - opt.offset_delay) / 60000.0
                                                     ) + opt.offset_scale
    lr_decay = 0.1 ** (it / ((opt.lrate_decay or 250) * 1000.0))
    return {
        "iteration": it,
        "mask_w": opt.penalize_mask * decay,
        "sym_w": opt.penalize_symmetric_alpha * prior,
        "dummy_w": opt.penalize_dummy * prior,
        "smpl_alpha_w": opt.penalize_smpl_alpha * prior,
        "offset_scale": min(ramp, opt.offset_lim) if it >= opt.offset_delay else 0.0,
        "lr": opt.learning_rate * lr_decay,
        "smpl_lr": opt.smpl_lr * lr_decay,
    }


def trainable_mask(model, train_mode):
    """{parameter name: 0.0 or 1.0}: poses and the canonical net train, the
    offset nets unless train_mode is "smpl_only"; betas, alignments and the
    background nets are frozen."""
    def value(name):
        if name == "poses" or name.startswith("coarse_human_net."):
            return 1.0
        if name.startswith("offset_nets."):
            return 0.0 if train_mode == "smpl_only" else 1.0
        return 0.0

    return {name: value(name) for name, _ in model.named_parameters()}


def lr_tree(model, anneals):
    """{parameter name: learning rate}: `smpl_lr` for the poses."""
    return {name: anneals["smpl_lr"] if name == "poses" else anneals["lr"]
            for name, _ in model.named_parameters()}


def trained_params(model):
    """{group: {name: parameter}} of the groups Adam steps (`TRAINED`)."""
    return {"poses": {"poses": model.poses},
            "coarse_human_net": dict(model.coarse_human_net.named_parameters()),
            "offset_nets": dict(model.offset_nets.named_parameters())}


def _full_name(group, name):
    return group if group == "poses" else f"{group}.{name}"


def warn_lpips_divergence(opt, ctx):
    """Say so, once per build, when the LPIPS patch loss is asked for but
    no LPIPS weights are given: the loss is then skipped and training
    leaves the reference objective. Returns whether it is skipped."""
    skipped = opt.penalize_lpips > 0 and ctx.get("lpips_params") is None
    if skipped:
        print(f"WARNING: penalize_lpips={opt.penalize_lpips:g} but no LPIPS weights are "
              "given: the perceptual patch loss is SKIPPED and training diverges from the "
              "reference objective.", flush=True)
    return skipped


def make_human_train_step(model, opt, optimizer, ctx, parity_inject=None, ops=KERNELS,
                          mesh=None):
    """train_step(state, batch) -> (state, metrics), updating `model` and
    the optimiser state in place. state: {"opt_state", "iteration" (int),
    "generator" (the device draws), "init_generator" (a CPU generator for
    the dead-net restart)}. The step reads one scalar back (whether the
    canonical net died); the skip itself is decided on the device. The
    step is deterministic: two runs from one seed give the same bits (on
    the card too: cuDNN's deterministic convolutions, TF32 off), and the
    caller's cuDNN flags are as they were after it.

    With a data `mesh` (parallel/mesh.py) `batch` is the whole batch, as
    every rank draws it; the step takes this rank's rows and sums the
    gradients and the losses over the ranks in one all-reduce, so every
    rank makes the unsharded step's update, skip and restart; metrics are
    the global values."""
    lpips_skipped = warn_lpips_divergence(opt, ctx)
    loss_fn = make_human_loss_fn(model, opt, ctx, parity_inject, ops, mesh=mesh)

    def train_step(state, batch):
        # the whole step (loss, autograd.grad, the update) in one scope:
        # cuDNN's default convolution backward (the LPIPS loss) sums in an
        # order that changes from run to run, and ATen reads the flags when
        # the backward runs; the caller's flags come back on exit
        with lpips_module.cudnn_scope(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False):
            return _step(state, batch)

    def _step(state, batch):
        batch = pmesh.shard_leading_axis(batch, mesh)
        it = state["iteration"]
        anneals = compute_anneals(opt, it)
        total, aux = loss_fn(batch, state["generator"], anneals)
        named = trained_params(model)
        flat = [(k, n, p) for k, ps in named.items() for n, p in ps.items()]
        with tracing.span("step.backward"):
            g = torch.autograd.grad(total, [p for _, _, p in flat], allow_unused=True)
        grads = {k: {} for k in named}
        g = [torch.zeros_like(p) if gk is None else gk for (_, _, p), gk in zip(flat, g)]
        if mesh is not None:
            names = list(aux["losses"])
            reduced = pmesh.all_reduce_flat(mesh, g + [aux["losses"][k].detach() for k in names])
            g = reduced[:len(g)]
            aux["losses"].update(zip(names, reduced[len(g):]))
        for (k, n, _), gk in zip(flat, g):
            grads[k][n] = gk
        dead = aux["dead"]
        bad = dead | torch.isnan(aux["losses"]["total_loss"].detach())
        # DensePose gating: joints of body parts a frame does not show
        if opt.block_grad:
            grads["poses"]["poses"] = grads["poses"]["poses"] * ctx["grad_masks"]
        # a group shares its mask and its rate: read them at its first parameter
        mask, lrs = trainable_mask(model, opt.train_mode), lr_tree(model, anneals)
        heads = {k: _full_name(k, next(iter(ps))) for k, ps in named.items()}
        lr = {k: mask[n] * lrs[n] for k, n in heads.items()}
        with tracing.span("step.optimizer"):
            optimizer.step(named, grads, state["opt_state"], lr, bad)
        with tracing.span("step.readback"):  # the step's one read back
            dead_now = bool(dead.item())
        if dead_now:  # fresh canonical and offset nets; the optimiser state is kept
            for net in (model.coarse_human_net, *model.offset_nets):
                net.nerf.reset_parameters(state["init_generator"])
        state["iteration"] = it + 1
        metrics = {k: v.detach() for k, v in aux["losses"].items()}
        metrics.update({"lr": anneals["lr"], "smpl_lr": anneals["smpl_lr"],
                        "offset_scale": anneals["offset_scale"],
                        "penalize_mask": anneals["mask_w"], "dead_restart": float(dead_now),
                        "lpips_skipped": float(lpips_skipped)})
        return state, metrics

    return train_step


class HumanNeRFTrainer:
    """Host loop of the human stage: validation cadence, checkpoints,
    metrics (structure of the JAX HumanNeRFTrainer). `model`: a HumanNeRF
    with its SMPL state, on `device`. `scene` is duck-typed as the JAX
    package's Scene: what `build_scene_arrays` reads, and static_vert
    [N][V, 3], faces, scale, and per capture an optional `densepose` map.

    The data mesh comes from `resolve_mesh(opt)`, as in NeRFTrainer: each
    rank trains on its rows of each batch; rank 0 alone validates and
    writes, the others waiting at a barrier."""

    def __init__(self, opt, model, scene, train_views, val_views, body_model,
                 interval_comp=1.0, lpips_params=None, device="cuda", ops=KERNELS):
        self.opt, self.model, self.scene = opt, model, scene
        self.device = torch.device(device)
        self.out = opt.out
        os.makedirs(self.out, exist_ok=True)
        all_views = sorted(set(train_views) | set(val_views))
        self.arrays = build_scene_arrays(scene, all_views, use_fused_depth=True,
                                         device=self.device)
        self.all_views, self.body_model, self.interval_comp = all_views, body_model, interval_comp
        remap = {v: i for i, v in enumerate(all_views)}
        ids = lambda views: torch.tensor([remap[v] for v in views], device=self.device)
        self.train_ids = ids(train_views)
        self.val_ids = ids(val_views) if len(val_views) else self.train_ids
        hw = scene.captures[0].shape
        can_k, can_c2w = canonical_cameras(np.asarray(scene.static_vert[0]), body_model, hw)
        self.can_cap = canonical_capture(can_k[0], can_c2w[0], hw)
        as_t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                           device=self.device)
        self.ctx = {
            "body_model": body_model,
            "da_smpl": hn.da_pose_params(body_model.num_joints, self.device),
            "scale": scene.scale,
            "topo": mesh_ops.MeshTopology.build(np.asarray(scene.faces)[:, :3],
                                                body_model.num_verts, self.device),
            "can_verts": as_t(np.stack([np.asarray(scene.static_vert[i]) for i in all_views])),
            "can_k": as_t(can_k),
            "can_c2w": as_t(can_c2w),
            "can_hw": hw,
            "interval_comp": interval_comp,
            "lpips_params": lpips_params,
            # poses and gradient masks have one row per capture of the
            # scene; scene_ids maps a staged view to its capture
            "scene_ids": as_t(all_views, torch.int64),
            "grad_masks": build_pose_grad_masks(scene, range(len(scene.captures)), self.device),
            "knn_k": 4,
            "knn_stride": opt.knn_stride,
        }
        self.optimizer = make_optimizer()
        self.state = {
            "opt_state": self.optimizer.init(trained_params(model)),
            "iteration": 0,
            "generator": torch.Generator(self.device).manual_seed(opt.seed),
            "init_generator": torch.Generator().manual_seed(opt.seed + 1),
        }
        self.mesh = pmesh.resolve_mesh(opt)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.step_fn = make_human_train_step(model, opt, self.optimizer, self.ctx, ops=ops,
                                             mesh=self.mesh)
        self.loss_fn = make_human_loss_fn(model, opt, self.ctx, ops=ops)
        self.pusher = tlog.MetricsPusher(opt)
        self.meter = tlog.ThroughputMeter(opt.rays_per_batch * 4 * opt.samples_per_ray)
        if opt.resume:
            self.resume()
        elif opt.load_weights:
            self.load_pretrained_weights()
        pmesh.put_replicated([model, self.state["opt_state"]], self.mesh)

    @property
    def iteration(self):
        return self.state["iteration"]

    def draw_batch(self, view_ids=None, generator=None):
        """A whole batch (with a mesh, each rank draws it; the step keeps
        the rank's rows)."""
        opt = self.opt
        return sampler.sample_human_batch(
            generator or self.state["generator"], self.arrays,
            self.train_ids if view_ids is None else view_ids, opt.geo_threshold,
            opt.rays_per_batch,
            ratios=(opt.body_rays_ratio, opt.border_rays_ratio, opt.bkg_rays_ratio),
            use_patch=opt.penalize_lpips > 0, dilation=opt.dilation)

    def train_step(self):
        self.state, metrics = self.step_fn(self.state, self.draw_batch())
        self.meter.tick()
        return metrics

    def train(self):
        opt = self.opt
        push_every = max(1, min(100, opt.max_iter // 5))
        with tracing.StepProfile(opt.profile_dir, opt.profile_steps, self.device, "human",
                                 write=self.is_main) as profile:
            while self.iteration < opt.max_iter:
                if self.iteration % opt.valid_iter == 0:
                    self.validate()
                profile.before(self.iteration)
                metrics = self.train_step()
                profile.after(self.iteration)
                if self.is_main and self.iteration % push_every == 0:
                    scalars = {f"train_loss/{k}": float(v) for k, v in metrics.items()
                               if "loss" in k or "reg" in k}
                    for k in ("lr", "offset_scale", "penalize_mask"):
                        scalars[f"hyper_params/{k}"] = metrics[k]
                    scalars.update({f"perf/{k}": v for k, v in self.meter.rates().items()})
                    self.pusher.push_scalars(self.iteration, scalars)
        self.validate()

    def validate(self):
        """The losses on a batch of the validation views; the canonical
        render of canonical camera 0 (white background, with its depth and
        acc maps, the depth clipped to the solid region) and the current body
        shaded over the middle training view, written as PNGs beside
        metrics.jsonl (`last_val_images` keeps their paths); a checkpoint.
        With a mesh every rank joins the render, each its share of each
        chunk's hit rays, and rank 0 alone does the rest while the other
        ranks wait."""
        opt = self.opt
        frame = renderer.render_smpl_nerf(
            self.model.spec, self.model, self.can_cap, np.asarray(self.scene.static_vert[0]),
            self.scene.faces, None, self.device, rays_per_batch=opt.rays_per_batch,
            samples_per_ray=opt.samples_per_ray, white_bkg=True, render_can=True,
            geo_threshold=opt.geo_threshold, interval_comp=self.interval_comp,
            knn_k=self.ctx["knn_k"], topology=self.ctx["topo"], mesh=self.mesh)
        if self.is_main:
            self._validate(*(t.cpu().numpy() for t in frame))
        if self.mesh is not None:
            self.mesh.barrier()

    def _validate(self, rgb, depth_map, acc_map):
        gen = torch.Generator(self.device).manual_seed(self.iteration + 1)
        with torch.no_grad():
            batch = self.draw_batch(self.val_ids, gen)
            aux = self.loss_fn(batch, gen, compute_anneals(self.opt, self.iteration))[1]
        self.last_val_losses = {k: float(v) for k, v in aux["losses"].items()}
        self.pusher.push_scalars(
            self.iteration, {f"val_loss/{k}": v for k, v in self.last_val_losses.items()},
            training=False)

        solid = acc_map >= 1.0 - 1e-10
        if solid.any():
            depth_map = np.clip(depth_map, depth_map[solid].min(), depth_map[solid].max())
        overfit_id = int(self.train_ids[len(self.train_ids) // 2])
        cap = self.scene.captures[self.all_views[overfit_id]]
        with torch.no_grad():
            verts = hn.vertex_forward(self.model, self.body_model, self.ctx["da_smpl"],
                                      self.ctx["scale"], self.ctx["scene_ids"][overfit_id])[0]
        overlay = rasterize.overlay_smpl(np.asarray(cap.image), verts[0].cpu().numpy(),
                                         np.asarray(self.scene.faces)[:, :3], cap)
        self.last_val_images = self.pusher.push_images(self.iteration, {
            "val_can": rgb, "val_depth": depth_map, "val_acc": acc_map,
            "val_smpl_overlay": overlay.astype(np.float32) / 255.0})
        self.save_model()

    def _moment_tree(self, name):
        """A moment of the optimiser as the JAX package's full param tree
        (zeros for the frozen parameters, as optax holds them)."""
        sd = {k: torch.zeros_like(v) for k, v in self.model.state_dict().items()}
        for group, ps in self.state["opt_state"][name].items():
            for n, v in ps.items():
                sd[_full_name(group, n)] = v
        return convert.to_jax_params(sd)

    def save_model(self):
        """`checkpoint.npz` in the JAX package's layout."""
        st = self.state["opt_state"]
        ckpt.save_checkpoint(os.path.join(self.out, "checkpoint.npz"), {
            "epoch": np.int64(0),
            "iteration": np.int64(self.iteration),
            # optax.chain state: (ScaleByAdamState(count, mu, nu), EmptyState())
            "optim_state": [[st["count"], self._moment_tree("mu"), self._moment_tree("nu")], []],
            "hybrid_model": convert.to_jax_params(self.model.state_dict()),
        })

    def _load_params(self, data):
        return convert.load_hybrid(self.model, data["hybrid_model"])

    def resume(self):
        data = ckpt.load_checkpoint(os.path.join(self.out, "checkpoint.npz"))
        missing = self._load_params(data)
        count, mu, nu = data["optim_state"][0]
        st = self.state["opt_state"]
        st["count"] = torch.tensor(int(count), dtype=torch.int32, device=self.device)
        for name, tree in (("mu", mu), ("nu", nu)):
            sd = convert.from_jax_params(tree)
            for group, ps in st[name].items():
                for n, v in ps.items():
                    v.copy_(sd[_full_name(group, n)])
        self.state["iteration"] = int(data["iteration"])
        if missing:
            print(f"partial resume; missing: {missing}")

    def load_pretrained_weights(self):
        missing = self._load_params(ckpt.load_checkpoint(self.opt.load_weights_path))
        if missing:
            print(f"partial load; missing: {missing}")
