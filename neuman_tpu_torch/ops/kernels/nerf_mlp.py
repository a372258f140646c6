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
card that dtype runs on the tensor cores (wgmma), float32 on FMAs.

The kernels read each layer's weights as "slabs" streamed into shared
memory (`slab_plan`, `pack_slabs`): the wrapper lays every slab out as
the kernel's shared-memory image of it, and the CPU tests unpack the
images back to the weights.

emit_tape=True (the `mlp_tape="hbm"` train configuration, the JAX
kernel's emit_tape) returns ((sigma, rgb), tape): tape [R*S, depth*W] in
the compute dtype holds the post-ReLU output of every trunk layer, layer i
in columns [i*W, (i+1)*W), for `nerf_mlp_bwd(tape=)` to read in place of
recomputing the trunk. The JAX tape is the transpose ([depth*W, R*S], a
TPU lane layout); the tape is written for every shape the kernel accepts.
"""

import ctypes
import functools

import numpy as np
import torch

from neuman_tpu_torch.models.embedder import embed
from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.ops.precision import matmul_f32
from neuman_tpu_torch.utils import tracing


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


# a block of activation columns in the kernels' tiles (a bf16 wgmma atom)
BLOCK = 64
# bytes of one slab row: 64 bf16 k values, or (f32) 32 k values of one output
SLAB_ROW_BYTES = 128
# widths the kernels are built for; the NeRF's PE and direction-PE blocks
# take <= 64 columns, the offset net's PE <= 2 blocks (128 columns)
KERNEL_WIDTHS = (64, 256)


def _block(first, real):
    """A range of a weight's rows or columns, (first, real, padded): its
    size zero-padded to whole 64-column blocks of the kernels' tiles."""
    return first, real, -(-real // BLOCK) * BLOCK


def mlp_products(width, depth, skips, pos_dim, dir_dim, per_sample, bf16, backward=False,
                 views=True):
    """The tile products of the kernels, in the order they run them:
    (layer, n_blocks, k_blocks, transposed). layer indexes `_lins` (trunk,
    alpha, feature, views, rgb); n_blocks are the product's outputs (each
    block one part, a product of its own in the kernel), k_blocks its
    inputs, both as `_block`s of the weight [out, in] (a PE of 84 columns
    is one part of two blocks); transposed: the outputs run over the
    weight's inputs (the backward's input gradients).
    The forward: trunk, feature, views (per-sample [feature, dir PE] in f32,
    the plain version's order; [dir PE, feature] in bf16, whose tiles keep
    the dir PE in the PE block); the backward then adds the transposed
    views, feature and trunk layers, top down, each with its PE or dir-PE
    part first (the other part writes over the product's input).
    views=False (the offset net: the trunk and a head on CUDA cores): the
    trunk alone, and backward its transposed layers."""
    half = width // 2
    skips = tuple(skips)

    def trunk_in(i):
        if i == 0:
            return [_block(0, pos_dim)]
        if (i - 1) in skips:
            return [_block(0, pos_dim), _block(pos_dim, width)]
        return [_block(0, width)]

    views_in = [_block(0, width)]
    if per_sample:
        views_in = ([_block(width, dir_dim)] + views_in if bf16
                    else views_in + [_block(width, dir_dim)])
    full = lambda m: [(0, m, m)]
    out = [(i, full(width), trunk_in(i), False) for i in range(depth)]
    if not views:
        if backward:
            out += [(i, trunk_in(i), [_block(0, width)], True) for i in reversed(range(depth))]
        return out
    out += [(depth + 1, full(width), [_block(0, width)], False),
            (depth + 2, full(half), views_in, False)]
    if backward:
        # the part that writes the tile (feature) comes last
        views_parts = sorted(views_in, key=lambda b: b[0] == 0)
        out += [(depth + 2, views_parts, [_block(0, half)], True),
                (depth + 1, [_block(0, width)], [_block(0, width)], True)]
        out += [(i, trunk_in(i), [_block(0, width)], True) for i in reversed(range(depth))]
    return out


def layer_shapes(width, depth, skips, pos_dim, dir_dim, views=True):
    """[out, in] of each weight of `_lins` (views=False: of the trunk)."""
    ins = [pos_dim if i == 0 else pos_dim + width if (i - 1) in tuple(skips) else width
           for i in range(depth)]
    trunk = [(width, k) for k in ins]
    if not views:
        return trunk
    return trunk + [(1, width), (width, width), (width // 2, width + dir_dim), (3, width // 2)]


def _axis(blocks):
    """Weight index along one axis of a product, -1 for padding."""
    return np.concatenate([np.r_[np.arange(first, first + real), -np.ones(pad - real, np.int64)]
                           for first, real, pad in blocks]).astype(np.int64)


def swizzle128(rows):
    """The 128-byte swizzle of `rows` 128-byte rows (16-byte chunk c of row
    r stored at chunk c ^ (r % 8)): phys[r, c] = the logical chunk there."""
    r = np.arange(rows)[:, None]
    return np.arange(8)[None, :] ^ (r & 7)


@functools.lru_cache(maxsize=32)
def slab_plan(width, depth, skips, pos_dim, dir_dim, per_sample, bf16, backward=False,
              views=True):
    """The weight image the kernels stream, as (index, slabs, n_trunk):
    index [elements] into [0, every weight of `_lins` (views=False: of the
    trunk) flattened row-major]
    (0 is a zero, weight w's element (o, i) is 1 + offset_w + o * in + i);
    slabs [count, 2] int32 (byte offset, bytes) in the order the kernel
    reads them; n_trunk: how many of them the forward's trunk takes (the
    first ones). One slab is one stage of the kernel's ring: N outputs x
    128 bytes of a product part. bf16: [N][64 k], each row 128-byte
    swizzled (the wgmma K-major layout); f32: [32 k][N]."""
    shapes = layer_shapes(width, depth, skips, pos_dim, dir_dim, views)
    starts = np.cumsum([1] + [o * i for o, i in shapes])
    esize, kc = (2, 64) if bf16 else (4, 32)
    parts, slabs, at, n_trunk = [], [], 0, 0
    for p, (layer, nb, kb, transposed) in enumerate(
            mlp_products(width, depth, skips, pos_dim, dir_dim, per_sample, bf16, backward,
                         views)):
        rows, cols = _axis(nb), _axis(kb)
        out_idx, in_idx = ((cols[None, :], rows[:, None]) if transposed
                           else (rows[:, None], cols[None, :]))
        src = np.where((out_idx >= 0) & (in_idx >= 0),
                       starts[layer] + out_idx * shapes[layer][1] + in_idx, 0)
        k = src.shape[1]
        n0 = 0
        for _, _, npart in nb:
            sub = src[n0:n0 + npart]
            n0 += npart
            if bf16:
                t = sub.reshape(npart, k // 64, 8, 8).transpose(1, 0, 2, 3)
                t = t[:, np.arange(npart)[:, None], swizzle128(npart), :]
            else:
                t = sub.reshape(npart, k // 32, 32).transpose(1, 2, 0)
            parts.append(t.reshape(-1))
            for _ in range(k // kc):
                slabs.append((at * esize, npart * SLAB_ROW_BYTES))
                at += npart * SLAB_ROW_BYTES // esize
                n_trunk += p < depth
    return np.concatenate(parts), np.array(slabs, dtype=np.int32), n_trunk


def _lins(net):
    return [*net.pts_linears, net.alpha_linear, net.feature_linear, net.views_linears[0],
            net.rgb_linear]


@functools.lru_cache(maxsize=32)
def _plan_on(device, *key):
    index, slabs, n_trunk = slab_plan(*key)
    return torch.from_numpy(index).to(device), torch.from_numpy(slabs).to(device), n_trunk


def pack_slabs(spec, net, per_sample, compute_dtype, backward=False):
    """(image, slabs, n_trunk) of `slab_plan` for the weights of `net`, on
    their device: the image in the compute dtype, slabs int32 [count, 2].
    A net without the view-direction head (the offset net) packs its trunk."""
    nspec = spec.nerf
    views = nspec.use_viewdirs
    lins = _lins(net) if views else list(net.pts_linears)
    device = lins[0].weight.device
    index, slabs, n_trunk = _plan_on(
        device, nspec.width, nspec.depth, tuple(nspec.skips), spec.pos_pe.out_dim,
        spec.dir_pe.out_dim if views else 0, per_sample, compute_dtype == torch.bfloat16,
        backward, views)
    with torch.no_grad():
        flat = torch.cat([torch.zeros(1, device=device)]
                         + [lin.weight.reshape(-1).float() for lin in lins])
        return flat.to(compute_dtype)[index], slabs, n_trunk


def _heads(net, compute_dtype):
    """The alpha [W] and rgb [3, W/2] weights rounded to the compute dtype
    (f32), and every bias in the kernels' order (trunk, alpha, feature,
    views, rgb)."""
    rnd = _rounder(compute_dtype)
    with torch.no_grad():
        head_a = rnd(net.alpha_linear.weight).reshape(-1).float().contiguous()
        head_rgb = rnd(net.rgb_linear.weight).float().contiguous()
        bias = torch.cat([lin.bias.reshape(-1) for lin in _lins(net)]).float()
    return head_a, head_rgb, bias


def check_envelope(spec, per_sample, what, max_depth, max_pe=BLOCK):
    """Raise ValueError for a net the kernels are not built for (PE of at
    most `max_pe` columns: the NeRF pair's one block, the offset pair's two)."""
    nspec = spec.nerf
    if (nspec.width not in KERNEL_WIDTHS or spec.pos_pe.out_dim > max_pe
            or (per_sample and spec.dir_pe.out_dim > BLOCK) or not 0 < nspec.depth <= max_depth
            or any(not 0 <= i < nspec.depth - 1 for i in nspec.skips)):
        raise ValueError(f"{what} kernel: unsupported net {nspec} (width in {KERNEL_WIDTHS}, "
                         f"PE widths <= {max_pe}, depth <= {max_depth})")


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
        [p] * 9 + [i] + [p] * 5 + [i] * 5 + [i, i, i, i, p] + [i, i, i, i, p] + [i, p]
    )
    lib.nerf_mlp_launch.restype = ctypes.c_int
    lib.nerf_mlp_shared_bytes.argtypes = [i, i]
    lib.nerf_mlp_shared_bytes.restype = ctypes.c_int
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
    check_envelope(spec, per_sample, "nerf_mlp", 31)
    if any(lin.weight.device != device for lin in _lins(net)):
        raise ValueError("nerf_mlp: weights and planes must be on one device")

    img, slabs, _ = pack_slabs(spec, net, per_sample, compute_dtype)
    head_a, head_rgb, bias = _heads(net, compute_dtype)
    out = torch.empty(4, r * s, device=device, dtype=torch.float32)
    tape = (torch.empty(r * s, nspec.depth * width, device=device, dtype=compute_dtype)
            if emit_tape else None)
    d = dir_planes if per_sample else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    skip_mask = sum(1 << i for i in nspec.skips)
    err = _lib().nerf_mlp_launch(
        ptr(px), ptr(py), ptr(pz), ptr(d[0]), ptr(d[1]), ptr(d[2]),
        ptr(None if per_sample else dir_part), ptr(img), ptr(slabs), slabs.shape[0], ptr(bias),
        ptr(head_a), ptr(head_rgb), ptr(out), ptr(tape),
        r * s, s, nspec.depth, width, skip_mask,
        *_pe_args(spec.pos_pe, device), *_pe_args(spec.dir_pe, device),
        int(compute_dtype == torch.bfloat16), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "nerf_mlp")
    tracing.count("launches.nerf_mlp")
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
