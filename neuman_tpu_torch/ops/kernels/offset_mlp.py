"""Fused PE + no-viewdirs MLP (the offset net) over planar samples, forward
and backward: the `offset_mlp` and `offset_mlp_bwd` CUDA kernels.

Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_offset_fwd_impl` (kernel
:558, pallas_call :605), `_offset_bwd` (kernel :671, pallas_call :773) and
`make_offset_mlp_vjp` (:797), and keeps their contract: D input planes
[R, S] ((x, y, z, t) for the offset nets), a 'posenc' PE, the ReLU trunk
with the skip concat [PE, h] and the linear head; returns the O raw output
planes [R, S] (the offset net's output scaling is the caller's). Sources:
neuman_tpu_torch/csrc/offset_mlp.cu and offset_mlp_bwd.cu, whose headers
say what bounds them on the H100 and how the design answers that.

`offset_mlp` and `offset_mlp_bwd` launch the kernels for CUDA tensors (or
raise) and run `offset_mlp_plain` / `offset_mlp_bwd_plain`, the same
functions in plain PyTorch, for CPU tensors. `offset_mlp_fn` is the
torch.autograd.Function that ties the two. Semantics (kernel and plain):
with compute_dtype bfloat16, weights and activations are rounded to bf16
where the JAX kernel casts them, cotangents included, and sums are f32;
ReLU masks come from the recomputed post-activation values; the PE, its
derivative and the sum of the PE gradients are f32.

As for `nerf_mlp`, `offset_mlp(emit_tape=True)` also returns the trunk's
post-ReLU values as a tape [R*S, depth*W] in the compute dtype, which
`offset_mlp_bwd(tape=)` reads in place of recomputing the trunk, and
`offset_mlp_fn(tape_mode="hbm")` ties the two; gradients are bit-identical
to "recompute".
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.models.embedder import embed
from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import _check_tape, check_tape_mode, pe_bwd
from neuman_tpu_torch.ops.precision import matmul_f32

# samples per chunk of the backward kernel's tape (~550 MB in f32 at 8 x 256)
CHUNK_SAMPLES = 32768
# contiguous sample ranges of a chunk whose dW partials are summed in order
KSPLIT = 4


def net_layers(net):
    """(weight, bias) of every layer in the kernels' order: trunk, head."""
    return [(lin.weight, lin.bias) for lin in [*net.pts_linears, net.output_linear]]


def _flat_axes(axes):
    r, s = axes[0].shape
    return torch.stack(list(axes), -1).reshape(r * s, len(axes))


def offset_mlp_plain(spec, net, axes, compute_dtype=torch.float32, emit_tape=False,
                     tape_mode=None):
    """What the forward kernel computes, in plain PyTorch (f32 matmuls on
    operands rounded to the compute dtype): O raw planes [R, S]; with
    emit_tape (planes, tape [R*S, depth*W]). `tape_mode` is taken so that a
    loss calls this like `offset_mlp_fn`, and changes nothing."""
    rnd = kmlp._rounder(compute_dtype)
    r, s = axes[0].shape
    lin = lambda x, layer: matmul_f32(rnd(x), rnd(layer.weight).T) + layer.bias
    pe = rnd(embed(spec.pos_pe, _flat_axes(axes)))
    h = pe
    posts = []
    for i, layer in enumerate(net.pts_linears):
        h = rnd(torch.relu(lin(h, layer)))
        posts.append(h)
        if i in spec.nerf.skips:
            h = torch.cat([pe, h], dim=-1)
    out = lin(h, net.output_linear)
    planes = [out[:, c].reshape(r, s) for c in range(out.shape[1])]
    if emit_tape:
        return planes, torch.cat(posts, dim=1).detach().to(compute_dtype)
    return planes


def offset_mlp_bwd_plain(spec, net, axes, g_rows, compute_dtype=torch.float32, tape=None):
    """What the backward kernel computes, in plain PyTorch. g_rows: O
    cotangent planes [R, S]. Returns (grads, d_axes): grads [(dW [out, in],
    db)] in `net_layers` order, d_axes D x [R, S]. With `tape` (from
    `offset_mlp_plain(emit_tape=True)`) the trunk posts are its columns."""
    rnd = kmlp._rounder(compute_dtype)
    nspec = spec.nerf
    r, s = axes[0].shape
    n = r * s
    with torch.no_grad():
        mm = lambda a, b: matmul_f32(rnd(a), rnd(b))
        trunk = net.pts_linears
        x = _flat_axes(axes)
        pe = rnd(embed(spec.pos_pe, x))
        cp = pe.shape[1]
        hins, posts = [], []
        h = pe
        for i, lin in enumerate(trunk):
            hins.append(h)
            if tape is not None:
                post = tape[:, i * nspec.width:(i + 1) * nspec.width].float()
            else:
                post = rnd(torch.relu(mm(h, lin.weight.T) + lin.bias))
            posts.append(post)
            h = torch.cat([pe, post], dim=1) if i in nspec.skips else post
        g = rnd(torch.stack(list(g_rows), -1).reshape(n, len(g_rows)))
        head_grad = (mm(g.T, h), g.sum(0))
        d_h = mm(g, net.output_linear.weight)
        d_pe = torch.zeros(n, cp, device=x.device)
        trunk_grads = [None] * len(trunk)
        for i in reversed(range(len(trunk))):
            if i in nspec.skips:
                d_pe = d_pe + d_h[:, :cp]
                d_h = d_h[:, cp:]
            d_pre = rnd(torch.where(posts[i] > 0, d_h, 0.0))
            trunk_grads[i] = (mm(d_pre.T, hins[i]), d_pre.sum(0))
            d_h = mm(d_pre, trunk[i].weight)
        d_x = pe_bwd(spec.pos_pe, x, d_pe + d_h)
    return trunk_grads + [head_grad], [d_x[:, a].reshape(r, s) for a in range(x.shape[1])]


def _pack_trunk(spec, net, compute_dtype, backward=False):
    """The trunk's weights in one flat buffer as the kernels read them: f32
    layers transposed to [in, out]; bf16 layers [out, in] with the PE column
    block zero-padded to a multiple of 16 (the MMA's k step). backward=True
    gives each layer the other way round, for the input gradients."""
    if compute_dtype == torch.float32:
        return torch.cat([(lin.weight if backward else lin.weight.t()).reshape(-1)
                          for lin in net.pts_linears])
    cp, width = spec.pos_pe.out_dim, spec.nerf.width
    parts = []
    for lin in net.pts_linears:
        w = lin.weight
        if w.shape[1] != width:  # the input starts with the PE block
            pad = torch.nn.functional.pad(w[:, :cp], (0, kmlp._round16(cp) - cp))
            w = torch.cat([pad, w[:, cp:]], dim=1)
        parts.append((w.t() if backward else w).reshape(-1))
    return torch.cat(parts).to(torch.bfloat16)


def _check(spec, net, axes, compute_dtype, what):
    """Raise on what the kernels do not take; returns (rounder, bf16)."""
    nspec, pe = spec.nerf, spec.pos_pe
    r, s = axes[0].shape
    device = axes[0].device
    for a, t in enumerate(axes):
        kmlp._check_plane(t, (r, s), device, f"axes[{a}]")
    rnd = kmlp._rounder(compute_dtype)  # raises on another dtype
    bf16 = compute_dtype == torch.bfloat16
    width = nspec.width
    cp = kmlp._round16(pe.out_dim) if bf16 else pe.out_dim
    # two [64, LD] buffers (+ the backward's [64, Cp] f32) within 227 KB;
    # the f32 tile products reach 32 x 11 columns
    smem = 2 * 64 * (cp + width) * (2 if bf16 else 4) + 64 * cp * 4
    if (pe.mapping != "posenc" or not 1 <= len(axes) <= 4 or pe.input_dims != len(axes)
            or nspec.use_viewdirs or width > 256 or cp + width > 352 or smem > 232448
            or not 0 < nspec.depth <= 15 or not 1 <= nspec.output_ch <= 4
            or any(not 0 <= i < nspec.depth - 1 for i in nspec.skips)
            or (bf16 and width % 64)):
        raise ValueError(f"{what} kernel: unsupported net {nspec} / {pe.mapping} PE of "
                         f"{len(axes)} planes for {compute_dtype}")
    if any(w.device != device for w, _ in net_layers(net)):
        raise ValueError(f"{what}: weights and planes must be on one device")
    return rnd, bf16


def _pe_args(pe_spec, device):
    return [int(pe_spec.include_input), len(pe_spec.freq_bands), pe_spec.out_dim,
            kmlp._pe_coef(pe_spec, device).data_ptr()]


def _axes_ptrs(axes):
    return [axes[a].data_ptr() if a < len(axes) else None for a in range(4)] + [len(axes)]


@functools.lru_cache(maxsize=None)
def _lib_fwd():
    lib = _build.load("offset_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.offset_mlp_launch.argtypes = [p] * 4 + [i] + [p] * 5 + [i] * 5 + [i, i, i, p] + [i, p]
    lib.offset_mlp_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    lib = _build.load("offset_mlp_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.offset_mlp_bwd_launch.argtypes = (
        [p] * 4 + [i] + [p] * 10 + [i] * 5 + [i, i, i, p] + [i] * 4 + [p])
    lib.offset_mlp_bwd_launch.restype = ctypes.c_int
    lib.offset_mlp_bwd_tape_cols.argtypes = [i] * 4
    lib.offset_mlp_bwd_tape_cols.restype = ctypes.c_int
    return lib


def _launch_fwd(spec, net, axes, compute_dtype, emit_tape):
    nspec = spec.nerf
    rnd, bf16 = _check(spec, net, axes, compute_dtype, "offset_mlp")
    r, s = axes[0].shape
    device = axes[0].device
    with torch.no_grad():
        wt = _pack_trunk(spec, net, compute_dtype)
        bias = torch.cat([b.reshape(-1) for _, b in net_layers(net)]).float()
        head = rnd(net.output_linear.weight).contiguous()
    out = torch.empty(nspec.output_ch, r * s, device=device, dtype=torch.float32)
    tape = (torch.empty(r * s, nspec.depth * nspec.width, device=device, dtype=compute_dtype)
            if emit_tape else None)
    err = _lib_fwd().offset_mlp_launch(
        *_axes_ptrs(axes), wt.data_ptr(), bias.data_ptr(), head.data_ptr(), out.data_ptr(),
        None if tape is None else tape.data_ptr(),
        r * s, nspec.depth, nspec.width, sum(1 << i for i in nspec.skips), nspec.output_ch,
        *_pe_args(spec.pos_pe, device), int(bf16), torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "offset_mlp")
    offset_mlp.launches += 1
    planes = [out[c].reshape(r, s) for c in range(nspec.output_ch)]
    return (planes, tape) if emit_tape else planes


def offset_mlp(spec, net, axes, compute_dtype=torch.float32, emit_tape=False):
    """Raw output planes (O x [R, S]) of the no-viewdirs NeRF `net` (the
    `NeRF` module of an OffsetNet with spec `spec`) on the input planes
    `axes` (D x [R, S]); with emit_tape (planes, tape [R*S, depth*W])."""
    if axes[0].is_cuda:
        return _launch_fwd(spec, net, axes, compute_dtype, emit_tape)
    if axes[0].device.type != "cpu":
        raise ValueError(f"offset_mlp: no kernel for device {axes[0].device}")
    return offset_mlp_plain(spec, net, axes, compute_dtype, emit_tape)


offset_mlp.launches = 0


def _launch_bwd(spec, net, axes, g_rows, compute_dtype, fwd_tape):
    nspec = spec.nerf
    rnd, bf16 = _check(spec, net, axes, compute_dtype, "offset_mlp_bwd")
    r, s = axes[0].shape
    n, device = r * s, axes[0].device
    if len(g_rows) != nspec.output_ch:
        raise ValueError(f"offset_mlp_bwd: expected {nspec.output_ch} cotangent planes")
    for c, t in enumerate(g_rows):
        kmlp._check_plane(t, (r, s), device, f"g_rows[{c}]")
    if fwd_tape is not None:
        _check_tape(fwd_tape, n, nspec.depth * nspec.width, device, compute_dtype,
                    "offset_mlp_bwd")
    with torch.no_grad():
        wf = _pack_trunk(spec, net, compute_dtype)
        wb = _pack_trunk(spec, net, compute_dtype, backward=True)
        bias = torch.cat([lin.bias.reshape(-1) for lin in net.pts_linears]).float()
        head = rnd(net.output_linear.weight).contiguous()
    g = torch.stack(list(g_rows)).reshape(len(g_rows), n)
    shapes = [(w.shape, b.shape) for w, b in net_layers(net)]
    total = sum(ws.numel() + bs.numel() for ws, bs in shapes)
    lib = _lib_bwd()
    cols = lib.offset_mlp_bwd_tape_cols(nspec.depth, nspec.width, spec.pos_pe.out_dim, int(bf16))
    chunk = min(CHUNK_SAMPLES, -(-n // 64) * 64)
    tape = torch.empty(chunk * cols, device=device, dtype=compute_dtype)
    partial = torch.empty(KSPLIT * total, device=device)
    grad = torch.empty(total, device=device)
    d_axes = torch.empty(len(axes), n, device=device)
    err = lib.offset_mlp_bwd_launch(
        *_axes_ptrs(axes), g.data_ptr(), None if fwd_tape is None else fwd_tape.data_ptr(),
        wf.data_ptr(), wb.data_ptr(), bias.data_ptr(),
        head.data_ptr(), d_axes.data_ptr(), grad.data_ptr(), tape.data_ptr(),
        partial.data_ptr(), n, nspec.depth, nspec.width, sum(1 << i for i in nspec.skips),
        nspec.output_ch, *_pe_args(spec.pos_pe, device), int(bf16), chunk, KSPLIT, total,
        torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError("offset_mlp_bwd: the kernel's gradient layout disagrees with the net")
    _build.check(err, "offset_mlp_bwd")
    offset_mlp_bwd.launches += 1
    grads, at = [], 0
    for ws, bs in shapes:
        grads.append((grad[at:at + ws.numel()].view(ws),
                      grad[at + ws.numel():at + ws.numel() + bs.numel()]))
        at += ws.numel() + bs.numel()
    return grads, [d_axes[a].reshape(r, s) for a in range(len(axes))]


def offset_mlp_bwd(spec, net, axes, g_rows, compute_dtype=torch.float32, tape=None):
    """Gradients of `offset_mlp` for the cotangent planes g_rows (O x
    [R, S]): (grads, d_axes) as `offset_mlp_bwd_plain` returns them. tape:
    the forward's `emit_tape` output, read in place of recomputing the trunk."""
    if axes[0].is_cuda:
        return _launch_bwd(spec, net, axes, g_rows, compute_dtype, tape)
    if axes[0].device.type != "cpu":
        raise ValueError(f"offset_mlp_bwd: no kernel for device {axes[0].device}")
    return offset_mlp_bwd_plain(spec, net, axes, g_rows, compute_dtype, tape)


offset_mlp_bwd.launches = 0


class _OffsetMlpFunction(torch.autograd.Function):
    """Inputs: the D input planes, then every (weight, bias) of
    `net_layers(net)`, flattened."""

    @staticmethod
    def forward(ctx, spec, net, compute_dtype, plain, emit_tape, *rest):
        n_axes = len(rest) - 2 * len(net_layers(net))
        axes = list(rest[:n_axes])
        ctx.spec, ctx.net, ctx.compute_dtype, ctx.plain = spec, net, compute_dtype, plain
        fwd = offset_mlp_plain if plain else offset_mlp
        out = fwd(spec, net, axes, compute_dtype, emit_tape)
        planes, tape = out if emit_tape else (out, None)
        ctx.n_axes = n_axes
        ctx.save_for_backward(*axes, *([tape] if emit_tape else []))
        return tuple(planes)

    @staticmethod
    def backward(ctx, *g_rows):
        axes = list(ctx.saved_tensors)
        tape = axes.pop() if len(axes) > ctx.n_axes else None
        bwd = offset_mlp_bwd_plain if ctx.plain else offset_mlp_bwd
        grads, d_axes = bwd(ctx.spec, ctx.net, axes, [g.contiguous() for g in g_rows],
                            ctx.compute_dtype, tape)
        # the kernel always computes d_axes; autograd drops those not asked for
        d_axes = [d if need else None
                  for d, need in zip(d_axes, ctx.needs_input_grad[5:5 + len(axes)])]
        return (None,) * 5 + (*d_axes, *[t for wb in grads for t in wb])


def offset_mlp_fn(spec, net, axes, compute_dtype=torch.float32, plain=False,
                  tape_mode="recompute"):
    """Differentiable `offset_mlp`: O raw planes [R, S]; the backward runs
    `offset_mlp_bwd` (the kernel on the card, its plain version on the CPU).
    plain=True runs `offset_mlp_plain` and `offset_mlp_bwd_plain` on any
    device: the kernels' function, rounded at the same points, to hold the
    kernels to. tape_mode "hbm": the forward writes the trunk posts to a
    tape that the backward reads instead of recomputing them (not under
    `torch.no_grad()`); gradients are bit-identical to "recompute"."""
    params = [t for wb in net_layers(net) for t in wb]
    emit_tape = (check_tape_mode(tape_mode) and torch.is_grad_enabled()
                 and any(t.requires_grad for t in (*axes, *params)))
    return list(_OffsetMlpFunction.apply(spec, net, compute_dtype, plain, emit_tape,
                                         *axes, *params))
