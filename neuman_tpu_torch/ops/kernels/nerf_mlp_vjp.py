"""Differentiable fused NeRF MLP: the `nerf_mlp` kernel forward and the
`nerf_mlp_bwd` kernel backward.

Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_mlp_bwd` (kernel :184,
pallas_call :371) and `make_mlp_vjp` (:417) in both direction modes:
per-ray (`dir_part` [R, W/2] from `dir_projection`; its gradient d_dir
[R, W/2] flows on through plain autograd into the direction rows of
`views_linears[0]`) and per-sample (direction planes 3x[R, S]). Source:
neuman_tpu_torch/csrc/nerf_mlp_bwd.cu, whose header says what bounds it on
the H100 and how the design answers that.

`nerf_mlp_fn` is a torch.autograd.Function whose inputs are the planes,
the direction input and every weight and bias of the net, so autograd
routes the weight gradients to the module's parameters. `nerf_mlp_bwd`
launches the kernel for CUDA tensors (or raises) and runs
`nerf_mlp_bwd_plain`, the same function in plain PyTorch, for CPU tensors.
Semantics (both): the forward is recomputed in the compute dtype; ReLU
masks are taken from the post-activation values; in bf16 every product
takes bf16 operands, cotangents included, with f32 sums, and per-ray d_dir
sums the bf16 d_pre2 of the ray's samples; the PE derivative is f32.

Two configurations, as `make_mlp_vjp(tape_mode=)`: "recompute" (the
backward recomputes the trunk) and "hbm" (the forward writes the trunk's
post-ReLU values to a tape [R*S, depth*W] in device memory, saved for the
backward, which reads them instead). The tape holds what the recompute
gives bit for bit, so the two configurations' gradients are bit-identical.
Under `torch.no_grad()` no tape is written.
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.models.embedder import embed, rotate_projection
from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.precision import matmul_f32
from neuman_tpu_torch.utils import tracing

# samples of whole rays per chunk of the kernel's tape (~10 KB a sample in
# bf16, ~20 KB in f32 at 8x256). Chunks whose tape stays in the 50 MB L2
# (4,096 samples in bf16) measured ~3x slower on an H100, and 65,536 2-5%
# faster for twice the memory (tools/sweep_bwd_chunk.py)
CHUNK_SAMPLES = 32768
# the most contiguous sample ranges of a chunk whose dW partials are summed
# in order (the kernel takes enough to fill the card, at most this many)
KSPLIT = 16


def check_tape_mode(tape_mode):
    """True for "hbm", False for "recompute"; anything else raises."""
    if tape_mode not in ("recompute", "hbm"):
        raise ValueError(f"tape_mode must be 'recompute' or 'hbm', not {tape_mode!r}")
    return tape_mode == "hbm"


def with_tape_mode(fn, tape_mode):
    """`fn` (an MLP forward of a loss: `nerf_mlp_fn`, `offset_mlp_fn`, also
    as partials, or a plain forward) with its tape configuration set. Raises
    on an unknown mode."""
    check_tape_mode(tape_mode)
    return functools.partial(fn, tape_mode=tape_mode)


def net_layers(net):
    """(weight, bias) of every layer in the kernels' order: trunk, alpha,
    feature, views (the whole [W/2, W + Cd] weight), rgb."""
    lins = [*net.pts_linears, net.alpha_linear, net.feature_linear, net.views_linears[0],
            net.rgb_linear]
    return [(lin.weight, lin.bias) for lin in lins]


def pe_bwd(pe_spec, x, d_pe):
    """Gradient of `embed(pe_spec, x)` w.r.t. x [N, D] for d_pe [N, C], f32
    (D = 3, or any D for 'posenc')."""
    d = x.shape[1]
    base = d if pe_spec.include_input else 0
    out = d_pe[:, :d].clone() if pe_spec.include_input else torch.zeros_like(x)
    if pe_spec.mapping == "posenc":
        for b, f in enumerate(pe_spec.freq_bands):
            d_sin = d_pe[:, base + 2 * d * b: base + 2 * d * b + d]
            d_cos = d_pe[:, base + 2 * d * b + d: base + 2 * d * (b + 1)]
            out = out + f * (torch.cos(x * f) * d_sin - torch.sin(x * f) * d_cos)
        return out
    bv = pe_spec.bvals_tensor(x.device)
    f = bv.shape[0]
    proj = rotate_projection(x, bv)  # as `embed` projects
    d_proj = torch.cos(proj) * d_pe[:, base:base + f] - torch.sin(proj) * d_pe[:, base + f:base + 2 * f]
    return out + matmul_f32(d_proj, bv)


def nerf_mlp_bwd_plain(spec, net, px, py, pz, g_sigma, g_rgb, dir_part=None,
                       dir_planes=None, compute_dtype=torch.float32, tape=None):
    """What the kernel computes, in plain PyTorch (f32 matmuls on operands
    rounded to the compute dtype). Returns (grads, d_planes, d_dir): grads
    [(dW [out, in], db)] in `net_layers` order (per-ray mode leaves the
    direction columns of the views weight 0), d_planes 3x[R, S], d_dir
    [R, W/2] (per-ray) or 3x[R, S] (per-sample). With `tape` (from
    `nerf_mlp_plain(emit_tape=True)`) the trunk posts are its columns."""
    rnd = kmlp._rounder(compute_dtype)
    nspec, width = spec.nerf, spec.nerf.width
    r, s = px.shape
    n = r * s
    with torch.no_grad():
        mm = lambda a, b: matmul_f32(rnd(a), rnd(b))
        trunk = net.pts_linears
        pts = torch.stack([px, py, pz], -1).reshape(n, 3)
        pe = rnd(embed(spec.pos_pe, pts))
        cp = pe.shape[1]
        hins, posts = [], []
        h = pe
        for i, lin in enumerate(trunk):
            hins.append(h)
            if tape is not None:
                post = tape[:, i * width:(i + 1) * width].float()
            else:
                post = rnd(torch.relu(mm(h, lin.weight.T) + lin.bias))
            posts.append(post)
            h = torch.cat([pe, post], dim=1) if i in nspec.skips else post
        feature = rnd(mm(h, net.feature_linear.weight.T) + net.feature_linear.bias)
        wv, bv = net.views_linears[0].weight, net.views_linears[0].bias
        if dir_planes is not None:
            dirs = torch.stack(list(dir_planes), -1).reshape(n, 3)
            dpe = rnd(embed(spec.dir_pe, dirs))
            pre2 = mm(torch.cat([feature, dpe], dim=1), wv.T) + bv
        else:
            pre2 = mm(feature, wv[:, :width].T) + bv
            pre2 = (pre2.reshape(r, s, -1) + dir_part[:, None, :]).reshape(n, -1)
        h2 = rnd(torch.relu(pre2))

        g_a = rnd(g_sigma.reshape(n, 1))
        g_c = rnd(torch.stack(list(g_rgb), -1).reshape(n, 3))
        d_pre2 = rnd(torch.where(h2 > 0, mm(g_c, net.rgb_linear.weight), 0.0))
        grads = {"rgb": (mm(g_c.T, h2), g_c.sum(0))}
        if dir_planes is not None:
            d_in = mm(d_pre2, wv)
            d_feature = rnd(d_in[:, :width])
            d_dir = pe_bwd(spec.dir_pe, dirs, d_in[:, width:])
            d_dir = [d_dir[:, a].reshape(r, s) for a in range(3)]
            dw_views = mm(d_pre2.T, torch.cat([feature, dpe], dim=1))
        else:
            d_feature = rnd(mm(d_pre2, wv[:, :width]))
            d_dir = d_pre2.reshape(r, s, -1).sum(1)
            dw_views = torch.cat([mm(d_pre2.T, feature),
                                  torch.zeros_like(wv[:, width:])], dim=1)
        grads["views"] = (dw_views, d_pre2.sum(0))
        grads["feature"] = (mm(d_feature.T, posts[-1]), d_feature.sum(0))
        grads["alpha"] = (mm(g_a.T, posts[-1]), g_a.sum(0))
        d_h = mm(d_feature, net.feature_linear.weight) + g_a * rnd(net.alpha_linear.weight)
        d_pe = torch.zeros(n, cp, device=px.device)
        trunk_grads = [None] * len(trunk)
        for i in reversed(range(len(trunk))):
            d_pre = rnd(torch.where(posts[i] > 0, d_h, 0.0))
            trunk_grads[i] = (mm(d_pre.T, hins[i]), d_pre.sum(0))
            d_in = mm(d_pre, trunk[i].weight)
            if i == 0:
                d_pe = d_pe + d_in
            elif (i - 1) in nspec.skips:
                d_pe = d_pe + d_in[:, :cp]
                d_h = d_in[:, cp:]
            else:
                d_h = d_in
        d_pts = pe_bwd(spec.pos_pe, pts, d_pe)
    order = trunk_grads + [grads[k] for k in ("alpha", "feature", "views", "rgb")]
    return order, [d_pts[:, a].reshape(r, s) for a in range(3)], d_dir


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("nerf_mlp_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_mlp_bwd_launch.argtypes = (
        [p] * 11 + [i] + [p] * 8 + [i] * 5 + [i, i, i, i, p] + [i, i, i, i, p] + [i] * 4 + [p]
    )
    lib.nerf_mlp_bwd_launch.restype = ctypes.c_int
    lib.nerf_mlp_bwd_tape_cols.argtypes = [i] * 3
    lib.nerf_mlp_bwd_tape_cols.restype = ctypes.c_int
    lib.nerf_mlp_bwd_shared_bytes.argtypes = [i] * 3
    lib.nerf_mlp_bwd_shared_bytes.restype = ctypes.c_int
    return lib


def _check_tape(tape, n, cols, device, compute_dtype, what):
    if (tape.device != device or tape.dtype != compute_dtype or tuple(tape.shape) != (n, cols)
            or not tape.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous {compute_dtype} tape {(n, cols)} on "
                         f"{device}, got {tape.dtype} {tuple(tape.shape)} on {tape.device}")


def _launch(spec, net, px, py, pz, g_sigma, g_rgb, dir_part, dir_planes, compute_dtype,
            fwd_tape):
    nspec = spec.nerf
    r, s = px.shape
    n, width, device = r * s, nspec.width, px.device
    half = width // 2
    per_sample = dir_planes is not None
    planes = [("px", px), ("py", py), ("pz", pz), ("g_sigma", g_sigma)]
    planes += [(f"g_rgb[{c}]", t) for c, t in enumerate(g_rgb)]
    if per_sample:
        planes += [(f"dir_planes[{a}]", t) for a, t in enumerate(dir_planes)]
    else:
        kmlp._check_plane(dir_part, (r, half), device, "dir_part")
    for name, t in planes:
        kmlp._check_plane(t, (r, s), device, name)
    kmlp._rounder(compute_dtype)  # raises on another dtype
    bf16 = compute_dtype == torch.bfloat16
    kmlp.check_envelope(spec, per_sample, "nerf_mlp_bwd", 12)
    if any(lin.weight.device != device for lin in kmlp._lins(net)):
        raise ValueError("nerf_mlp_bwd: weights and planes must be on one device")

    if fwd_tape is not None:
        _check_tape(fwd_tape, n, nspec.depth * width, device, compute_dtype, "nerf_mlp_bwd")
    img, slabs, n_trunk = kmlp.pack_slabs(spec, net, per_sample, compute_dtype, backward=True)
    if fwd_tape is not None:  # the chain pass reads the trunk's posts instead
        slabs = slabs[n_trunk:]
    head_a, head_rgb, bias = kmlp._heads(net, compute_dtype)
    g = torch.stack([g_sigma, *g_rgb]).reshape(4, n)
    shapes = [(w.shape, b.shape) for w, b in net_layers(net)]
    total = sum(ws.numel() + bs.numel() for ws, bs in shapes)
    lib = _lib()
    cols = lib.nerf_mlp_bwd_tape_cols(nspec.depth, width, int(per_sample))
    chunk_rays = max(1, min(r, CHUNK_SAMPLES // s))
    rows = -(-chunk_rays * s // 64) * 64
    tape = torch.empty(rows * cols, device=device, dtype=compute_dtype)
    partial = torch.empty(KSPLIT * total, device=device)
    grad = torch.empty(total, device=device)
    d_planes = torch.empty(3, n, device=device)
    d_dir = torch.empty(3, n, device=device) if per_sample else torch.empty(r, half, device=device)
    d = dir_planes if per_sample else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.nerf_mlp_bwd_launch(
        ptr(px), ptr(py), ptr(pz), ptr(d[0]), ptr(d[1]), ptr(d[2]),
        ptr(None if per_sample else dir_part), ptr(g), ptr(fwd_tape), ptr(img), ptr(slabs),
        slabs.shape[0], ptr(bias), ptr(head_a), ptr(head_rgb), ptr(d_planes), ptr(d_dir),
        ptr(grad), ptr(tape), ptr(partial), n, s, nspec.depth, width,
        sum(1 << i for i in nspec.skips),
        *kmlp._pe_args(spec.pos_pe, device), *kmlp._pe_args(spec.dir_pe, device),
        int(bf16), chunk_rays, KSPLIT, total, torch.cuda.current_stream(device).cuda_stream,
    )
    if err == -1:
        raise ValueError("nerf_mlp_bwd: the kernel's gradient layout disagrees with the net")
    if err == -2:
        raise RuntimeError("nerf_mlp_bwd: could not make the dW pass's tensor maps")
    _build.check(err, "nerf_mlp_bwd")
    tracing.count("launches.nerf_mlp_bwd")
    grads, at = [], 0
    for ws, bs in shapes:
        grads.append((grad[at:at + ws.numel()].view(ws), grad[at + ws.numel():at + ws.numel() + bs.numel()]))
        at += ws.numel() + bs.numel()
    d_dir = [d_dir[a].reshape(r, s) for a in range(3)] if per_sample else d_dir
    return grads, [d_planes[a].reshape(r, s) for a in range(3)], d_dir


def nerf_mlp_bwd(spec, net, px, py, pz, g_sigma, g_rgb, dir_part=None, dir_planes=None,
                 compute_dtype=torch.float32, tape=None):
    """Gradients of `nerf_mlp` for the cotangents g_sigma [R, S] and g_rgb
    3x[R, S]: (grads, d_planes, d_dir) as `nerf_mlp_bwd_plain` returns them.
    tape: the forward's `emit_tape` output [R*S, depth*W], read in place of
    recomputing the trunk; None recomputes."""
    if (dir_part is None) == (dir_planes is None):
        raise ValueError("pass exactly one of dir_part and dir_planes")
    if px.is_cuda:
        return _launch(spec, net, px, py, pz, g_sigma, g_rgb, dir_part, dir_planes,
                       compute_dtype, tape)
    if px.device.type != "cpu":
        raise ValueError(f"nerf_mlp_bwd: no kernel for device {px.device}")
    return nerf_mlp_bwd_plain(spec, net, px, py, pz, g_sigma, g_rgb, dir_part, dir_planes,
                              compute_dtype, tape)


class _NerfMlpFunction(torch.autograd.Function):
    """Inputs: px, py, pz, the direction tensors (1 per-ray, 3 per-sample),
    then every (weight, bias) of `net_layers(net)`, flattened."""

    @staticmethod
    def forward(ctx, spec, net, compute_dtype, plain, emit_tape, px, py, pz, *rest):
        n_dir = len(rest) - 2 * len(net_layers(net))
        dirs = rest[:n_dir]
        kw = {"dir_planes": list(dirs)} if n_dir == 3 else {"dir_part": dirs[0]}
        ctx.spec, ctx.net, ctx.compute_dtype, ctx.plain = spec, net, compute_dtype, plain
        fwd = kmlp.nerf_mlp_plain if plain else kmlp.nerf_mlp
        out = fwd(spec, net, px, py, pz, compute_dtype=compute_dtype, emit_tape=emit_tape, **kw)
        (sigma, rgb), tape = out if emit_tape else (out, None)
        ctx.n_dir = n_dir
        ctx.save_for_backward(px, py, pz, *dirs, *([tape] if emit_tape else []))
        return sigma, *rgb

    @staticmethod
    def backward(ctx, g_sigma, g_r, g_g, g_b):
        px, py, pz, *dirs = ctx.saved_tensors
        tape = dirs.pop() if len(dirs) > ctx.n_dir else None
        kw = {"dir_planes": dirs} if len(dirs) == 3 else {"dir_part": dirs[0]}
        bwd = nerf_mlp_bwd_plain if ctx.plain else nerf_mlp_bwd
        grads, d_planes, d_dir = bwd(
            ctx.spec, ctx.net, px, py, pz, g_sigma.contiguous(),
            [g.contiguous() for g in (g_r, g_g, g_b)], compute_dtype=ctx.compute_dtype,
            tape=tape, **kw)
        d_dirs = list(d_dir) if len(dirs) == 3 else [d_dir]
        return (None,) * 5 + (*d_planes, *d_dirs, *[t for wb in grads for t in wb])


def nerf_mlp_fn(spec, net, px, py, pz, dir_part=None, dir_planes=None,
                compute_dtype=torch.float32, plain=False, tape_mode="recompute"):
    """Differentiable `nerf_mlp`: (sigma [R, S], rgb 3x[R, S]); the backward
    runs `nerf_mlp_bwd` (the kernel on the card, its plain version on the
    CPU). Pass exactly one of dir_part [R, W/2] and dir_planes 3x[R, S].
    plain=True runs `nerf_mlp_plain` and `nerf_mlp_bwd_plain` on any
    device: the kernels' function, rounded at the same points, to hold the
    kernels to. tape_mode "hbm": the forward writes the trunk posts to a
    tape that the backward reads instead of recomputing them (not under
    `torch.no_grad()`, where nothing is saved); gradients are bit-identical
    to "recompute"."""
    if (dir_part is None) == (dir_planes is None):
        raise ValueError("pass exactly one of dir_part and dir_planes")
    dirs = list(dir_planes) if dir_planes is not None else [dir_part]
    params = [t for wb in net_layers(net) for t in wb]
    emit_tape = (check_tape_mode(tape_mode) and torch.is_grad_enabled()
                 and any(t.requires_grad for t in (px, py, pz, *dirs, *params)))
    sigma, *rgb = _NerfMlpFunction.apply(spec, net, compute_dtype, plain, emit_tape, px, py, pz,
                                         *dirs, *params)
    return sigma, rgb
