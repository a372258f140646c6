"""The layouts the Hopper fused-MLP kernels read, checked on the CPU.

The kernels (neuman_tpu_torch/csrc/nerf_mlp.cu, nerf_mlp_bwd.cu,
offset_mlp.cu, offset_mlp_bwd.cu, mlp_hopper.cuh) cannot run here, so what
surrounds them is held exact in numpy: the weight slab images the wrappers
pack (`slab_plan`, `pack_slabs`) unpack to the weights they came from, with
the PE and direction-PE blocks zero-padded (the offset net's 84-column PE
of (x, y, z, t) in two blocks); the offset backward's tape columns start on
8; the shared-memory addresses a wgmma
descriptor reads (128-byte swizzle, K-major for the layers, MN-major for
the dW pass) hold the element the kernel means; the persistent tile
schedule and the dW pass's sample ranges cover every sample once,
ragged ends included.
"""

import numpy as np
import pytest
import torch

from neuman_tpu_torch.models import embedder, nerf
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
from neuman_tpu_torch.ops.kernels import offset_mlp as koff

torch.set_num_threads(1)

NETS = {"8x256-skip4": (256, 8, (4,)), "6x64-skip1": (64, 6, (1,))}
# the offset nets of the card tests: (x, y, z, t), PE 4 + 4 x 2 x 10 = 84 columns
OFFSET_NETS = {"8x256-skip4": (256, 8, (4,)), "4x64-skip1": (64, 4, (1,))}


def _net(width, depth, skips, mapping="posenc"):
    spec = nerf.JoinerSpec(
        pos_pe=embedder.make_embedder(3, 9, 10, mapping=mapping),
        dir_pe=embedder.make_embedder(3, 3, 4, mapping=mapping),
        nerf=nerf.NeRFSpec(depth=depth, width=width, input_ch=63, input_ch_views=27,
                           skips=skips, use_viewdirs=True),
    )
    net = nerf.NeRF(spec.nerf).reset_parameters(torch.Generator().manual_seed(0))
    return spec, net.requires_grad_(False)


def _offset_net(width, depth, skips, n_freqs=10, planes=4):
    pe = embedder.make_embedder(planes, 9, n_freqs)
    spec = nerf.OffsetNetSpec(pos_pe=pe, nerf=nerf.NeRFSpec(
        depth=depth, width=width, input_ch=pe.out_dim, input_ch_views=0, output_ch=3,
        skips=skips, use_viewdirs=False, scale_type="linear"))
    net = nerf.NeRF(spec.nerf).reset_parameters(torch.Generator().manual_seed(0))
    return spec, net.requires_grad_(False)


def _padded(w, blocks_n, blocks_k, transposed):
    """The product's B [n, k]: the weight w [out, in] (transposed: its
    transpose), each axis cut into blocks and zero-padded as the tiles are."""
    b = w.t() if transposed else w
    axis = lambda blocks: np.concatenate(
        [np.r_[np.arange(f, f + r), -np.ones(p - r, np.int64)] for f, r, p in blocks])
    rows, cols = axis(blocks_n), axis(blocks_k)
    out = torch.zeros(len(rows), len(cols))
    keep_r, keep_c = rows >= 0, cols >= 0
    out[np.ix_(keep_r, keep_c)] = b[rows[keep_r]][:, cols[keep_c]]
    return out


def _unswizzle(slab, rows):
    """bf16 slab bytes [rows][128] as stored -> the logical [rows][64]."""
    chunks = slab.reshape(rows, 8, 8)
    r = np.arange(rows)[:, None]
    # physical chunk p of row r holds logical chunk p ^ (r % 8)
    logical = np.empty_like(chunks)
    logical[r, np.arange(8)[None, :] ^ (r & 7)] = chunks
    return logical.reshape(rows, 64)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("per_sample", [False, True], ids=["per_ray", "per_sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net_name", list(NETS))
def test_slab_images_unpack_to_weights(net_name, dtype, per_sample, backward):
    """Every slab of the image, read as the kernel reads it (bf16: N rows of
    64 swizzled k values; f32: 32 k rows of N values), is the next k chunk
    of its product part's zero-padded weight block, exactly; the slabs tile
    the image in order and the trunk's forward slabs come first."""
    width, depth, skips = NETS[net_name]
    spec, net = _net(width, depth, skips)
    products = kmlp.mlp_products(width, depth, skips, 63, 27, per_sample,
                                 dtype == torch.bfloat16, backward)
    _check_image(spec, net, kmlp._lins(net), products, per_sample, dtype, backward, depth)


def _check_image(spec, net, lins, products, per_sample, dtype, backward, depth):
    img, slabs, n_trunk = kmlp.pack_slabs(spec, net, per_sample, dtype, backward=backward)
    esize = 2 if dtype == torch.bfloat16 else 4
    raw = img.view(torch.uint8).numpy() if dtype == torch.bfloat16 else img.numpy().view(np.uint8)
    at, slab_i, trunk_slabs = 0, 0, 0
    for p, (layer, nb, kb, transposed) in enumerate(products):
        want = _padded(lins[layer].weight, nb, kb, transposed).to(dtype)
        n0 = 0
        for _, _, npart in nb:
            part = want[n0:n0 + npart]
            n0 += npart
            kc = 64 if esize == 2 else 32
            for k0 in range(0, part.shape[1], kc):
                off, nbytes = (int(v) for v in slabs[slab_i])
                assert (off, nbytes) == (at, npart * 128)
                data = raw[off:off + nbytes]
                if esize == 2:
                    got = torch.from_numpy(_unswizzle(data.view(np.uint16).copy(), npart)
                                           .astype(np.int16)).view(torch.bfloat16)
                    ref = part[:, k0:k0 + 64]
                else:
                    got = torch.from_numpy(data.view(np.float32).reshape(32, npart).copy())
                    ref = part[:, k0:k0 + 32].t()
                assert torch.equal(got, ref), (p, k0)
                at += nbytes
                slab_i += 1
                trunk_slabs += p < depth
    assert slab_i == len(slabs) and at == img.numel() * esize and trunk_slabs == n_trunk


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_padding_blocks_are_zero(bf16):
    """The PE block (63 columns) and the dir-PE block (27) take 64 columns
    of the tiles; the padding weights are zero, so the kernel's padded
    activation columns add nothing. The per-sample views layer reads
    [feature, dir PE] in f32 (the plain version's order) and [dir PE,
    feature] in bf16."""
    spec, net = _net(64, 6, (1,))
    products = kmlp.mlp_products(64, 6, (1,), 63, 27, True, bf16, backward=True)
    views_k = products[6 + 1][2]
    assert views_k == ([(64, 27, 64), (0, 64, 64)] if bf16 else [(0, 64, 64), (64, 27, 64)])
    assert products[6 + 2][1] == [(64, 27, 64), (0, 64, 64)]  # views^T: dir-PE part first
    pe_blocks = [b for _, nb, kb, _ in products for b in nb + kb if b[1] in (63, 27)]
    assert pe_blocks and all(pad == 64 for _, _, pad in pe_blocks)
    views = kmlp._lins(net)[6 + 2].weight  # [32, 64 + 27]
    b = _padded(views, [(0, 32, 32)], [(64, 27, 64), (0, 64, 64)], False)
    assert torch.equal(b[:, 27:64], torch.zeros(32, 37))
    assert torch.equal(b[:, :27], views[:, 64:]) and torch.equal(b[:, 64:], views[:, :64])


def _swizzle_addr(addr):
    """The 128-byte swizzle on a shared-memory byte address (base 1024-aligned):
    address bits [4, 7) xor bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _kmajor_addr(base, lbo, sbo, row, k):
    """Byte a K-major 128-byte-swizzled wgmma operand reads for (row, k) of a
    16-bit matrix, the descriptor at `base`: 8-row groups `sbo` apart, rows
    128 bytes apart, k contiguous."""
    return _swizzle_addr(base + (row // 8) * sbo + (row % 8) * 128 + 2 * k)


def _mnmajor_addr(base, lbo, sbo, k, mn):
    """The same for an MN-major operand: 64-element groups along M / N `lbo`
    apart, 8-row groups along K `sbo` apart, rows (one k) 128 bytes."""
    return _swizzle_addr(base + (mn // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 + 2 * (mn % 64))


def _act_at(r, c):
    """Byte offset of a bf16 tile's element (sample r, column c), as
    `Act<bf16>::at` in mlp_hopper.cuh computes it."""
    return (c >> 6) * 8192 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2


@pytest.mark.parametrize("npart", [32, 64, 128, 256])
def test_kmajor_descriptor_reads_the_slab(npart):
    """For each of a slab's four k16 steps (descriptor start + 32 q bytes),
    the byte the descriptor reads for B[n][16 q + kk] holds that element of
    the packed image."""
    rng = np.random.default_rng(npart)
    logical = rng.integers(0, 2 ** 16, size=(npart, 64), dtype=np.uint16)
    phys = np.empty_like(logical).reshape(npart, 8, 8)
    r = np.arange(npart)[:, None]
    phys[r, np.arange(8)[None, :] ^ (r & 7)] = logical.reshape(npart, 8, 8)
    flat = phys.reshape(-1)  # the slab as the wrapper packs it, at a 1024-aligned base
    base = 3 * 32768
    for q in range(4):
        for n in range(npart):
            for kk in range(16):
                addr = _kmajor_addr(base + 32 * q, 16, 1024, n, kk) - base
                assert flat[addr // 2] == logical[n, 16 * q + kk]


def test_tile_layout_is_what_the_descriptor_reads():
    """A bf16 tile's blocks (atoms of 64 columns, 8 KB apart) as the kernel
    writes them (`Act::at`) are what a K-major descriptor at block j, step q
    reads as A[s][64 j + 16 q + kk]."""
    for j in range(5):
        for q in range(4):
            for s in range(64):
                for kk in range(16):
                    c = 64 * j + 16 * q + kk
                    addr = _kmajor_addr(j * 8192 + 32 * q, 16, 1024, s, kk)
                    assert addr == _act_at(s, c)


def test_mnmajor_descriptor_reads_the_tma_boxes():
    """The dW pass: TMA writes a box [64 rows][64 columns] with the 128-byte
    swizzle (row r's 16-byte chunk c at chunk c ^ (r % 8)); B is two boxes
    side by side (128 columns, lbo 8192 bytes). The MN-major descriptor at
    step q (start + 2048 q bytes: 16 rows) reads element (k = 16 q + kk,
    n) from where TMA put it; the bias column sums read A the same way."""
    def tma_addr(box, r, c):
        return box * 8192 + r * 128 + (((c // 8) ^ (r % 8)) << 4) + (c % 8) * 2

    for q in range(4):
        for kk in range(16):
            k = 16 * q + kk
            for n in range(128):
                got = _mnmajor_addr(2048 * q, 8192, 1024, kk, n)
                assert got == tma_addr(n // 64, k, n % 64)
            for m in range(64):  # A: one box
                assert _mnmajor_addr(2048 * q, 8192, 1024, kk, m) == tma_addr(0, k, m)
    # the db sums: row r, column wt of A box g as dw_kernel reads it
    for r in range(64):
        for wt in range(64):
            assert r * 128 + (((wt >> 3) ^ (r & 7)) << 4) + (wt & 7) * 2 == tma_addr(0, r, wt)


@pytest.mark.parametrize("n", [37 * 24, 64, 65, 4096 * 16 + 37, 128 * 3])
@pytest.mark.parametrize("groups", [1, 2], ids=["f32", "bf16"])
def test_persistent_schedule_covers_every_tile_once(n, groups):
    """The kernels' loop (mlp_hopper.cuh, nerf_mlp.cu): `units` of `groups`
    64-sample tiles, block b takes units b, b + grid, ...; a group past the
    last tile drains the slabs; the producer repeats the slab list once per
    unit of its block. Every tile is run once; the consumers of a block take
    the producer's slabs as often as it sends them."""
    sms = 132
    tiles = -(-n // 64)
    units = -(-tiles // groups)
    grid = min(units, sms)
    seen = []
    for b in range(grid):
        reps = (units - 1 - b) // grid + 1 if b < units else 0
        visits = list(range(b, units, grid))
        assert len(visits) == reps
        for u in visits:
            seen += [u * groups + g for g in range(groups) if u * groups + g < tiles]
    assert sorted(seen) == list(range(tiles))
    last = tiles - 1
    assert n - 64 * last == (n - 1) % 64 + 1  # the ragged tile's real rows


@pytest.mark.parametrize("r,s", [(37, 24), (4096, 256), (6144, 128), (1000, 16)])
@pytest.mark.parametrize("chunk_samples", [240, 32768])
@pytest.mark.parametrize("ranges", [1, 5, 16])
def test_chunks_and_dw_ranges_cover_every_sample(r, s, chunk_samples, ranges):
    """Chunks hold whole rays (the last one may be shorter); the dW pass
    splits a chunk of cn samples into ranges of kper = 64 ceil(ceil(cn /
    ranges) / 64) rows (nerf_mlp_bwd.cu): disjoint, covering [0, cn), each
    starting at a multiple of 64, and its slabs (64 rows bf16, 32 f32)
    never read past the chunk's tiles, which the chain pass wrote."""
    chunk_rays = max(1, min(r, chunk_samples // s))
    rows = -(-chunk_rays * s // 64) * 64  # the tape the wrapper allocates
    covered = 0
    for c0 in range(0, r * s, chunk_rays * s):
        cn = min(r * s - c0, chunk_rays * s)
        assert c0 % s == 0 and cn % s == 0
        tiles_rows = -(-cn // 64) * 64
        assert tiles_rows <= rows
        kper = -(-(-(-cn // ranges)) // 64) * 64
        got = []
        for ks in range(ranges):
            k_lo, k_hi = ks * kper, min(cn, ks * kper + kper)
            if k_hi <= k_lo:
                continue
            assert k_lo % 64 == 0
            for sk in (64, 32):
                slabs = -(-(k_hi - k_lo) // sk)
                assert k_lo + slabs * sk <= tiles_rows
            got.append((k_lo, k_hi))
        assert got[0][0] == 0 and got[-1][1] == cn
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
        covered += cn
    assert covered == r * s
    assert kvjp.CHUNK_SAMPLES == 32768


@pytest.mark.parametrize("width", [64, 128, 192, 256])
def test_envelope_raises_outside_the_kernels(width):
    """Widths other than 64 and 256, PE blocks over 64 columns, deep nets:
    ValueError (never a fallback) on the card's path."""
    spec, _ = _net(width, 8, (4,))
    if width in kmlp.KERNEL_WIDTHS:
        kmlp.check_envelope(spec, True, "nerf_mlp", 31)
    else:
        with pytest.raises(ValueError):
            kmlp.check_envelope(spec, True, "nerf_mlp", 31)
    wide = nerf.JoinerSpec(pos_pe=embedder.make_embedder(3, 11, 12), dir_pe=spec.dir_pe,
                           nerf=spec.nerf)
    with pytest.raises(ValueError):
        kmlp.check_envelope(wide, False, "nerf_mlp", 31)
    with pytest.raises(ValueError):
        kmlp.check_envelope(spec, False, "nerf_mlp_bwd", 4)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net_name", list(OFFSET_NETS))
def test_offset_slab_images_unpack_to_weights(net_name, dtype, backward):
    """The offset net's image (`pack_slabs` of a net without the view head:
    its trunk; the 3-output head runs on CUDA cores from its own array),
    read as the kernels read it: the PE of 84 columns is one part of two
    64-column blocks, zero-padded to 128, in the forward's layer 0 and skip
    layer and in the transposed layers' PE parts, which come before the h
    parts; the forward's trunk slabs lead the backward's image."""
    width, depth, skips = OFFSET_NETS[net_name]
    spec, net = _offset_net(width, depth, skips)
    bf16 = dtype == torch.bfloat16
    products = kmlp.mlp_products(width, depth, skips, 84, 0, False, bf16, backward, views=False)
    pe = (0, 84, 128)
    assert products[0][2] == [pe] and products[skips[0] + 1][2] == [pe, (84, width, width)]
    if backward:
        top_down = products[depth:]
        assert [p[0] for p in top_down] == list(reversed(range(depth)))
        assert all(p[3] and p[2] == [(0, width, width)] for p in top_down)
        assert top_down[depth - 1 - (skips[0] + 1)][1] == [pe, (84, width, width)]
        assert top_down[-1][1] == [pe]
    else:
        assert len(products) == depth and not any(p[3] for p in products)
    _check_image(spec, net, list(net.pts_linears), products, False, dtype, backward, depth)
    _, _, n_trunk, bias, head = koff._lib_args(spec, net, dtype, backward)
    assert head.shape == (3, width) and head.dtype == torch.float32
    assert torch.equal(head, net.output_linear.weight.to(dtype).float())
    assert bias.numel() == depth * width + 3


@pytest.mark.parametrize("width,pos_dim", [(256, 84), (64, 84), (256, 63), (64, 128)])
def test_offset_tape_layout_starts_blocks_on_8_columns(width, pos_dim):
    """The offset backward's chunk tape (`offset_mlp.tape_layout`): PE, posts,
    cotangents (8 columns for O <= 4), d_pre, in that order, without
    overlap; every block and every dW operand (a layer's d_pre, a post, the
    PE, the cotangents) starts on a multiple of 8 columns, so the 16-byte
    stores and each TMA box start on 16 bytes in bf16 and f32."""
    depth = 8
    lay = koff.tape_layout(depth, width, pos_dim)
    assert lay["t_post"] >= pos_dim and lay["t_post"] == -(-pos_dim // 64) * 64
    assert lay["t_g"] == lay["t_post"] + depth * width
    assert lay["t_dpre"] >= lay["t_g"] + 4
    assert lay["ldt"] == lay["t_dpre"] + depth * width
    starts = [0, lay["t_g"], lay["ldt"]]
    starts += [lay["t_post"] + i * width for i in range(depth)]
    starts += [lay["t_dpre"] + i * width for i in range(depth)]
    assert all(c % 8 == 0 for c in starts)
    for esize in (2, 4):
        assert all(c * esize % 16 == 0 for c in starts)


@pytest.mark.parametrize("width", [64, 128, 192, 256])
def test_offset_envelope_raises_outside_the_kernels(width):
    """Widths 64 and 256 and PEs of up to two blocks pass; another width, a
    PE wider than 128 columns, or a view head: ValueError (never a
    fallback) on the card's path."""
    spec, net = _offset_net(width, 4, (1,))
    axes = [torch.zeros(2, 3) for _ in range(4)]
    if width in kmlp.KERNEL_WIDTHS:
        koff._check(spec, net, axes, torch.bfloat16, "offset_mlp")
    else:
        with pytest.raises(ValueError):
            koff._check(spec, net, axes, torch.float32, "offset_mlp")
    wide, wnet = _offset_net(64, 4, (1,), n_freqs=16)  # 4 + 128 columns
    with pytest.raises(ValueError):
        koff._check(wide, wnet, axes, torch.float32, "offset_mlp_bwd")
    three, tnet = _offset_net(64, 4, (1,), planes=3)  # 63 columns: one block
    koff._check(three, tnet, axes[:3], torch.float32, "offset_mlp")
