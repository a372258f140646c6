"""Fused PE + NeRF MLP over planar samples: the `nerf_mlp` CUDA kernel.

Replaces neuman_tpu/ops/pallas/raymarch.py `nerf_mlp_pallas` (kernel
:192, pallas_call :301) and keeps its contract: planes px, py, pz [R, S]
and either a per-ray direction term `dir_part` [R, W/2] (the background
nets) or per-sample direction planes (the warped canonical human net);
returns (sigma [R, S], rgb 3x[R, S]) raw outputs. Source:
neuman_tpu_torch/csrc/nerf_mlp.cu, whose header says what bounds it on
the H100 and how the design answers that.

`nerf_mlp` launches the kernel for CUDA tensors (or raises) and runs
`nerf_mlp_plain`, the same function in plain PyTorch, for CPU tensors.
With compute_dtype bfloat16 both round weights and activations to bf16
at the points the JAX kernel casts them and accumulate in f32; on the
card that dtype runs the tensor-core (mma.sync) kernel, float32 the FMA
kernel.

emit_tape=True (the `mlp_tape="hbm"` train configuration, the JAX
kernel's emit_tape) returns ((sigma, rgb), tape): tape [R*S, depth*W] in
the compute dtype holds the post-ReLU output of every trunk layer, layer i
in columns [i*W, (i+1)*W), for `nerf_mlp_bwd(tape=)` to read in place of
recomputing the trunk. The JAX tape is the transpose ([depth*W, R*S], a
TPU lane layout); the tape is written for every shape the kernel accepts.
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.models.embedder import embed
from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.ops.precision import matmul_f32

# the f32 kernel's dynamic shared memory: two [64, LD] f32 buffers <= 227 KB
_MAX_LD = 232448 // (2 * 64 * 4)


def _rounder(compute_dtype):
    if compute_dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    if compute_dtype == torch.float32:
        return lambda t: t
    raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")


def dir_projection(spec, net, dirs, compute_dtype=torch.float32):
    """Per-ray direction term W_dirs . PE(d): dirs [R, 3] -> [R, W/2] f32."""
    rnd = _rounder(compute_dtype)
    w_dirs = net.views_linears[0].weight[:, spec.nerf.width:]
    return matmul_f32(rnd(embed(spec.dir_pe, dirs)), rnd(w_dirs).T)


def nerf_mlp_plain(spec, net, px, py, pz, dir_part=None, dir_planes=None,
                   compute_dtype=torch.float32, emit_tape=False, tape_mode=None):
    """What the kernel computes, in plain PyTorch (f32 matmuls). `tape_mode`
    is taken so that a loss calls this like `nerf_mlp_fn`, and changes
    nothing: autograd keeps this forward's activations in either mode."""
    rnd = _rounder(compute_dtype)
    nspec = spec.nerf
    r, s = px.shape
    lin = lambda x, layer: matmul_f32(rnd(x), rnd(layer.weight).T) + layer.bias
    pe = rnd(embed(spec.pos_pe, torch.stack([px, py, pz], -1).reshape(-1, 3)))
    h = pe
    posts = []
    for i, layer in enumerate(net.pts_linears):
        h = rnd(torch.relu(lin(h, layer)))
        posts.append(h)
        if i in nspec.skips:
            h = torch.cat([pe, h], dim=-1)
    alpha = lin(h, net.alpha_linear)
    feature = rnd(lin(h, net.feature_linear))
    views = net.views_linears[0]
    if dir_planes is not None:
        dpe = rnd(embed(spec.dir_pe, torch.stack(list(dir_planes), -1).reshape(-1, 3)))
        h2 = torch.relu(lin(torch.cat([feature, dpe], dim=-1), views))
    else:
        w_feat = views.weight[:, : nspec.width]
        feat_part = matmul_f32(rnd(feature), rnd(w_feat).T) + views.bias
        h2 = torch.relu(feat_part.reshape(r, s, -1) + dir_part[:, None, :]).reshape(r * s, -1)
    rgb = lin(rnd(h2), net.rgb_linear)
    out = alpha.reshape(r, s), [rgb[:, c].reshape(r, s) for c in range(3)]
    if emit_tape:
        return out, torch.cat(posts, dim=1).detach().to(compute_dtype)
    return out


def _round16(x):
    return -(-x // 16) * 16


def _kernel_layers(spec, net, per_sample):
    """(weight [out, in], bias, input column blocks) of each layer in the
    kernel's order. The blocks name the input's parts: "pe" (the position
    PE), "h" (a hidden layer), "dpe" (the direction PE), "h2" (the views
    layer's output)."""
    nspec, w = spec.nerf, spec.nerf.width
    views = net.views_linears[0]
    after_skip = lambda i: i > 0 and (i - 1) in nspec.skips
    trunk_in = lambda i: ["pe"] if i == 0 else (["pe", "h"] if after_skip(i) else ["h"])
    return [
        *[(lin.weight, lin.bias, trunk_in(i)) for i, lin in enumerate(net.pts_linears)],
        (net.alpha_linear.weight, net.alpha_linear.bias, ["h"]),
        (net.feature_linear.weight, net.feature_linear.bias, ["h"]),
        (views.weight, views.bias, ["h", "dpe"]) if per_sample
        else (views.weight[:, :w], views.bias, ["h"]),
        (net.rgb_linear.weight, net.rgb_linear.bias, ["h2"]),
    ]


def _pack_weights(spec, layers, compute_dtype, backward=False):
    """One flat weight buffer in the layout the kernel reads: f32 layers
    transposed to [in, out]; bf16 layers [out, in] with the PE and dir-PE
    column blocks zero-padded to multiples of 16 (the MMA's k step).
    backward=True gives each layer the other way round (f32 [out, in], bf16
    [in, out] padded likewise), for the backward's input gradients."""
    if compute_dtype == torch.float32:
        return torch.cat([(w if backward else w.t()).reshape(-1) for w, _, _ in layers])
    widths = {"pe": spec.pos_pe.out_dim, "h": spec.nerf.width,
              "dpe": spec.dir_pe.out_dim, "h2": spec.nerf.width // 2}
    parts = []
    for w, _, blocks in layers:
        cols = w.split([widths[b] for b in blocks], dim=1)
        cols = [torch.nn.functional.pad(c, (0, _round16(c.shape[1]) - c.shape[1])) for c in cols]
        padded = torch.cat(cols, dim=1)
        parts.append((padded.t() if backward else padded).reshape(-1))
    return torch.cat(parts).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _pe_coef(pe_spec, device):
    vals = pe_spec.freq_bands if pe_spec.mapping == "posenc" else pe_spec.bvals
    return torch.tensor(vals, dtype=torch.float32, device=device)


def _pe_args(pe_spec, device):
    n_bands = (len(pe_spec.freq_bands) if pe_spec.mapping == "posenc"
               else len(pe_spec.bvals) // 9)
    return [int(pe_spec.mapping == "rotate"), int(pe_spec.include_input), n_bands,
            pe_spec.out_dim, _pe_coef(pe_spec, device).data_ptr()]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("nerf_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_mlp_launch.argtypes = (
        [p] * 11 + [i] * 5 + [i, i, i, i, p] + [i, i, i, i, p] + [i, p]
    )
    lib.nerf_mlp_launch.restype = ctypes.c_int
    return lib


def _check_plane(t, shape, device, what):
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected f32 {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(spec, net, px, py, pz, dir_part, dir_planes, compute_dtype, emit_tape):
    nspec = spec.nerf
    r, s = px.shape
    width, device = nspec.width, px.device
    per_sample = dir_planes is not None
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _check_plane(t, (r, s), device, name)
    if per_sample:
        for a, t in enumerate(dir_planes):
            _check_plane(t, (r, s), device, f"dir_planes[{a}]")
    else:
        _check_plane(dir_part, (r, width // 2), device, "dir_part")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
    bf16 = compute_dtype == torch.bfloat16
    # the f32 kernel keeps two [64, LD] f32 buffers in shared memory; the
    # bf16 kernel's MMA tiles need widths that are multiples of 64
    ld = max(spec.pos_pe.out_dim + width, width + spec.dir_pe.out_dim if per_sample else 0)
    if (width % 2 or width > 256 or ld > _MAX_LD or not 0 < nspec.depth <= 31
            or any(not 0 <= i < nspec.depth - 1 for i in nspec.skips) or (bf16 and width % 64)):
        raise ValueError(f"nerf_mlp kernel: unsupported net {nspec} for {compute_dtype}")
    layers = _kernel_layers(spec, net, per_sample)
    if any(w.device != device for w, _, _ in layers):
        raise ValueError("nerf_mlp: weights and planes must be on one device")

    with torch.no_grad():
        wt = _pack_weights(spec, layers, compute_dtype)
        bias = torch.cat([b.reshape(-1) for _, b, _ in layers]).float()
    out = torch.empty(4, r * s, device=device, dtype=torch.float32)
    tape = (torch.empty(r * s, nspec.depth * width, device=device, dtype=compute_dtype)
            if emit_tape else None)
    d = dir_planes if per_sample else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    skip_mask = sum(1 << i for i in nspec.skips)
    err = _lib().nerf_mlp_launch(
        ptr(px), ptr(py), ptr(pz), ptr(d[0]), ptr(d[1]), ptr(d[2]),
        ptr(None if per_sample else dir_part), ptr(wt), ptr(bias), ptr(out), ptr(tape),
        r * s, s, nspec.depth, width, skip_mask,
        *_pe_args(spec.pos_pe, device), *_pe_args(spec.dir_pe, device),
        int(bf16), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "nerf_mlp")
    nerf_mlp.launches += 1
    res = out[0].reshape(r, s), [out[1 + c].reshape(r, s) for c in range(3)]
    return (res, tape) if emit_tape else res


def nerf_mlp(spec, net, px, py, pz, dir_part=None, dir_planes=None,
             compute_dtype=torch.float32, emit_tape=False):
    """Raw (sigma [R, S], rgb 3x[R, S]) of the viewdirs NeRF `net` (the
    `NeRF` module of a Joiner with spec `spec`) at the samples px, py, pz
    [R, S]. Pass exactly one of dir_part [R, W/2] (per-ray, from
    `dir_projection`) and dir_planes (3x[R, S], per-sample). emit_tape=True
    returns ((sigma, rgb), tape [R*S, depth*W])."""
    if (dir_part is None) == (dir_planes is None):
        raise ValueError("pass exactly one of dir_part and dir_planes")
    if not spec.nerf.use_viewdirs:
        raise ValueError("nerf_mlp covers the view-direction head only")
    if px.is_cuda:
        return _launch(spec, net, px, py, pz, dir_part, dir_planes, compute_dtype, emit_tape)
    if px.device.type != "cpu":
        raise ValueError(f"nerf_mlp: no kernel for device {px.device}")
    return nerf_mlp_plain(spec, net, px, py, pz, dir_part, dir_planes, compute_dtype, emit_tape)


nerf_mlp.launches = 0
