"""Component times of the human train step at its size, on the GPU
(counterpart of tools/bench_step_parts.py).

    python -m neuman_tpu_torch.tools.bench_step_parts [all|smpl|sampler|merge|opt|offset|
                                                      mlpvjp|warpbwd|query]
                                                     [--dtype float32] [--device cuda]

On the setup of the bench's human section (`bench.human_setup`: the body
proxy, V=10,242; 4 views of 270x480; the smpl_and_offset defaults), R=1536
rays x S=128 samples:
- smpl: `vertex_forward` (SMPL LBS twice and the Da-pose -> scene
  transforms), forward;
- sampler: `sample_human_batch` with the LPIPS patch;
- merge: `sort_merge_planar` of [R, 256] and [R, S] sample sets and
  `integrate_planar` of the [R, 384] result;
- opt: `ScaleByAdam` over the step's trained parameters (poses, canonical
  net, offset net);
- offset: the offset net forward + backward (the offset_mlp pair);
- mlpvjp: the canonical net forward + backward at [R x {1, 4}, S] with
  per-sample directions (the nerf_mlp pair), `mlp_tape` recompute and hbm;
- warpbwd: `warp_points_to_canonical_diff` (bucketed KNN, stride 4) forward
  + backward in the points, N = R x S. One row: the port's warp stores its
  residuals; nothing on its path recomputes the query in the backward, as
  the JAX step's `jax.checkpoint` does, so there is no second mode;
- query: `signed_distance` (bucketed KNN, k=4), N = R x S, stride 1 and 4,
  without and with the query tables, and with the tables fused
  (`fused=True`, the ericson_signed_select kernel).
--dtype is the MLPs' compute dtype (float32, the human step's default, or
bfloat16, which the JAX tool fixes).

Each component is called REPS (20) times back to back between two CUDA
events, each call's output feeding the next call's input; after one warm-up
run, RUNS (3) runs, run r on the inputs moved by (r + 1) x 1e-6, and the
median ms per call is printed. The card's name and power limit first.
"""

import argparse
import sys

import torch

from neuman_tpu_torch import bench
from neuman_tpu_torch.datasets import sampler
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops import volume
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn, with_tape_mode
from neuman_tpu_torch.ops.kernels.offset_mlp import offset_mlp_fn
from neuman_tpu_torch.trainers import human
from neuman_tpu_torch.trainers.background import DTYPES, make_optimizer

COMPONENTS = ("smpl", "sampler", "merge", "opt", "offset", "mlpvjp", "warpbwd", "query")
# the human step's rays and samples; chained calls a run, and runs
RAYS, SAMPLES = 1536, 128
REPS, RUNS = 20, 3


def time_component(device, f, x0, reps=REPS, runs=RUNS):
    """Median over `runs` runs of the ms per call of `reps` chained calls
    x = f(x), run r from x0 + (r + 1) x 1e-6, after one warm-up run."""
    def chain(x):
        for _ in range(reps):
            x = f(x)
        return x

    chain(x0)
    times = []
    for r in range(runs):
        x = x0 + (r + 1) * 1e-6
        times.append(bench.time_ms(device, lambda: chain(x))[0] / reps)
    return sorted(times)[len(times) // 2]


def _grad_sum(loss, params):
    return sum(g.sum() for g in torch.autograd.grad(loss, params))


def components(s, which, rays, samples, dtype, device):
    """[(label, f, x0)] of the components in `which` on the setup `s`."""
    gen = torch.Generator(device).manual_seed(0)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    cfg, model, body = s.cfg, s.model, s.body
    cd = DTYPES[dtype]
    out = []
    if "smpl" in which:
        def smpl(poses):
            with torch.no_grad():
                model.poses.copy_(poses)
                verts, _ = hn.vertex_forward(model, body, s.ctx["da_smpl"], 1.0, 0)
            return poses + verts.sum() * 0.0 + 1e-6
        out.append(("vertex_forward (SMPL LBS x2)", smpl, model.poses.detach().clone()))
    if "sampler" in which:
        def sample(c):
            b = sampler.sample_human_batch(
                gen, s.arrays, s.ids, cfg.geo_threshold, rays,
                ratios=(cfg.body_rays_ratio, cfg.border_rays_ratio, cfg.bkg_rays_ratio),
                use_patch=True, dilation=cfg.dilation)
            return c + 1.0 + b["color"].sum() * 1e-12
        out.append(("sample_human_batch", sample, torch.zeros((), device=device)))
    if "merge" in which:
        z1 = torch.rand(rays, 2 * samples, generator=gen, device=device).sort(-1).values
        z2 = torch.rand(rays, samples, generator=gen, device=device).sort(-1).values
        sg1, sg2 = draw(rays, 2 * samples), draw(rays, samples)
        dirn = torch.ones(rays, device=device)

        def merge(z1c):
            tz, tsg, trgb = volume.sort_merge_planar([z1c, z2], [sg1, sg2],
                                                     [[sg1 * 0.1] * 3, [sg2 * 0.1] * 3])
            rgb = volume.integrate_planar(tsg, trgb, tz, dirn)[0]
            return z1c + rgb.sum() * 1e-9
        out.append((f"sort_merge+integrate [{rays}, {3 * samples}]", merge, z1))
    if "opt" in which:
        optimizer = make_optimizer()
        named = human.trained_params(model)
        state = optimizer.init(named)
        keep = torch.zeros((), dtype=torch.bool, device=device)

        def opt(c):
            grads = {k: {n: p.detach() * 1e-3 for n, p in ps.items()} for k, ps in named.items()}
            optimizer.step(named, grads, state, cfg.learning_rate, keep)
            return c + 1.0
        out.append(("optimizer grads+update", opt, torch.zeros((), device=device)))
    if "offset" in which:
        off_net = model.offset_nets[0]
        off_planes = [draw(rays, samples) for _ in range(3)]

        def offset(x):
            off = off_net([x] + off_planes, 1.0, cd, mlp=offset_mlp_fn)
            return x + _grad_sum(sum(o.sum() for o in off), list(off_net.parameters())) * 1e-9
        out.append((f"offset net fwd+bwd [{rays}, {samples}] {dtype}", offset,
                    draw(rays, samples)))
    if "mlpvjp" in which:
        can_net = model.coarse_human_net.nerf
        for tape in ("recompute", "hbm"):
            mlp = with_tape_mode(nerf_mlp_fn, tape)
            for mult in (1, 4):
                planes = [draw(rays * mult, samples) * 0.3 for _ in range(5)]

                def mlpvjp(x, planes=planes, mlp=mlp):
                    sg, rgb = mlp(model.spec.human, can_net, x, planes[0], planes[1],
                                  dir_planes=planes[2:], compute_dtype=cd)
                    loss = sg.sum() + sum(c.sum() for c in rgb)
                    return x + _grad_sum(loss, list(can_net.parameters())) * 1e-9
                out.append((f"canonical MLP fwd+bwd [{rays * mult}, {samples}] {dtype} "
                            f"tape={tape}", mlpvjp, draw(rays * mult, samples) * 0.3))
    n = rays * samples
    verts = body.v_template
    topo = s.ctx["topo"]
    if "warpbwd" in which:
        ts = torch.eye(4, device=device).repeat(body.num_verts, 1, 1)

        def warp(pts):
            p = pts.detach().requires_grad_(True)
            can, _ = mesh_ops.warp_points_to_canonical_diff(p, verts, ts, topo, k=4,
                                                            knn_stride=4, knn_impl="bucketed")
            (g,) = torch.autograd.grad((can * can).sum(), p)
            return pts + g * 1e-9
        out.append((f"warp fwd+bwd N={n} stride=4 [residuals stored]", warp, draw(n, 3) * 0.3))
    if "query" in which:
        tables = mesh_ops.build_query_tables(verts, topo)
        for stride in (1, 4):
            for label, tb, fused in (("", None, False), ("+tables", tables, False),
                                     ("+tables fused", tables, True)):
                def query(pts, stride=stride, tb=tb, fused=fused):
                    sd, _, _ = mesh_ops.signed_distance(pts, verts, topo, k=4, knn_stride=stride,
                                                        tables=tb, knn_impl="bucketed",
                                                        fused=fused)
                    return pts + (sd[:, None] * 0.0 + 1e-7)
                out.append((f"signed_distance N={n} k=4 stride={stride}{label}", query,
                            draw(n, 3) * 0.3))
    return out


def run(which="all", device="cuda", dtype="float32"):
    """Time the components (`which`: "all" or one name); print one line
    each and return {label: ms}."""
    if which != "all" and which not in COMPONENTS:
        raise ValueError(f"unknown component {which!r}; one of all, {', '.join(COMPONENTS)}")
    device = torch.device(device)
    chosen = COMPONENTS if which == "all" else (which,)
    s = bench.human_setup(device)
    times = {}
    for label, f, x0 in components(s, chosen, RAYS, SAMPLES, dtype, device):
        times[label] = time_component(device, f, x0)
        print(f"{label}: {times[label]:.4f} ms", flush=True)
    return times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="?", default="all", choices=("all",) + COMPONENTS)
    parser.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_step_parts: no CUDA device (--device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    print(bench.card_line(device), flush=True)
    run(args.which, device, args.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
