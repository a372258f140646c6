"""Where the device time of a rendered frame goes, on the GPU.

    python -m neuman_tpu_torch.tools.profile_frame [--render hybrid] [--dtype bfloat16]
                                                   [--height 270] [--width 480] [--seed 0]

--render hybrid: `render_hybrid_nerf` (the body in the scene); smpl:
`render_smpl_nerf` (the posed body alone); smpl_can: the same in canonical
space (no warp); multi: `render_hybrid_nerf_multi_persons` with the body
twice, the second copy moved 0.8 to the side. Full-width nets (8x256) from
--seed with the density biases of `chip_smoke.py` (background 0.5, body 5.0),
the body-proxy SMPL model (V=10,242) in a random pose, the camera 3 units
in front of it, 8192-ray chunks, 64 + 32 background samples, 64 human
samples, k=4, group stride 4. One warm-up frame, then one frame traced with
torch.profiler. Prints the card, the frame's wall time, the device time per
kernel (largest first, with its share and its calls) and the share of the
wall time the device was idle.
"""

import argparse
import time
import types

import torch

from neuman_tpu_torch.models import human_nerf, smpl
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.options.config import NeuManConfig
from neuman_tpu_torch.render import renderer
from neuman_tpu_torch.utils import card

RENDER = dict(rays_per_batch=8192, samples_per_ray=64, geo_threshold=0.2, knn_k=4, knn_stride=4)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build(args, device):
    """(render() -> outputs) for the chosen renderer."""
    spec = human_nerf.build_human_nerf_spec(NeuManConfig())
    model = human_nerf.HumanNeRF(spec, device=device,
                                 generator=torch.Generator().manual_seed(args.seed))
    model.requires_grad_(False)
    model.coarse_bkg_net.nerf.alpha_linear.bias.fill_(0.5)
    model.fine_bkg_net.nerf.alpha_linear.bias.fill_(0.5)
    model.coarse_human_net.nerf.alpha_linear.bias.fill_(5.0)
    body = smpl.body_proxy_smpl_model(subdivisions=5, device=device)
    gen = torch.Generator().manual_seed(args.seed + 2)
    pose = torch.zeros(1, 72)
    pose[0, 3:] = torch.randn(69, generator=gen) * 0.1
    verts, ts = smpl.da_pose_to_scene(body, pose.to(device), torch.zeros(1, 10, device=device))
    topo = mesh_ops.MeshTopology.build(body.faces, len(verts), device)
    h, w = args.height, args.width
    focal = 380.0 * w / 480
    cap = types.SimpleNamespace(
        shape=(h, w), near={"bkg": 0.5}, far={"bkg": 6.0},
        intrinsic_matrix=[[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]],
        cam_pose=types.SimpleNamespace(
            camera_to_world=[[1.0, 0, 0, 0], [0, -1.0, 0, 0], [0, 0, -1.0, 3.0], [0, 0, 0, 1.0]]))
    kw = dict(RENDER, compute_dtype=DTYPES[args.dtype])
    if args.render == "hybrid":
        return lambda: renderer.render_hybrid_nerf(
            spec, model, cap, verts, body.faces, ts, device, topology=topo,
            importance_samples_per_ray=32, **kw)
    if args.render in ("smpl", "smpl_can"):
        return lambda: renderer.render_smpl_nerf(
            spec, model, cap, verts, body.faces, ts, device, topology=topo,
            render_can=args.render == "smpl_can", **kw)
    shift = torch.tensor([0.8, 0.0, 0.0], device=device)
    ts2 = ts.clone()
    ts2[:, :3, 3] += shift
    return lambda: renderer.render_hybrid_nerf_multi_persons(
        spec, model, cap, [spec, spec], [model, model], [verts, verts + shift],
        [body.faces, body.faces], [ts, ts2], device, importance_samples_per_ray=32, **kw)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--render", default="hybrid",
                        choices=("hybrid", "smpl", "smpl_can", "multi"))
    parser.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    parser.add_argument("--height", type=int, default=270)
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    device = torch.device("cuda", 0)
    print(card.smi_line())
    render = build(args, device)
    render()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise SystemExit("profile_frame: the frame is not finite")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"render={args.render} dtype={args.dtype} H={args.height} W={args.width} "
          f"wall_ms_per_frame={wall_ms:.3f} device_ms_per_frame={device_ms:.3f} "
          f"idle_share={1 - device_ms / wall_ms:.4f} kernels={len(kernels)}")
    if not kernels:
        raise SystemExit("profile_frame: the trace holds no device time")
    for e in kernels[:args.top]:
        ms = e.device_time_total / 1e3
        print(f"{ms:10.3f} ms {ms / device_ms:7.2%} {e.count:8d} calls  {e.key[:100]}")
    rest = sum(e.device_time_total for e in kernels[args.top:]) / 1e3
    print(f"{rest:10.3f} ms {rest / device_ms:7.2%}  the other {len(kernels) - args.top} kernels")


if __name__ == "__main__":
    main()
