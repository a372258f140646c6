"""CUDA kernels of neuman_tpu_torch vs their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). This file imports nothing of JAX, so on the GPU machine it
runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from neuman_tpu_torch.models import embedder, nerf
from neuman_tpu_torch.models.smpl import body_proxy_smpl_model
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
from neuman_tpu_torch.ops.kernels import offset_mlp as koff

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _net(mapping, width, device, skips=(4,)):
    spec = nerf.JoinerSpec(
        pos_pe=embedder.make_embedder(3, 9, 10, mapping=mapping),
        dir_pe=embedder.make_embedder(3, 3, 4, mapping=mapping),
        nerf=nerf.NeRFSpec(depth=8, width=width, input_ch=63, input_ch_views=27,
                           skips=skips, use_viewdirs=True),
    )
    net = nerf.NeRF(spec.nerf, device=device).reset_parameters(torch.Generator().manual_seed(0))
    return spec, net.requires_grad_(False)


def _mlp_inputs(spec, net, per_sample, r, s, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    planes = [(torch.rand(r, s, generator=g) * 2 - 1).to(device) for _ in range(3)]
    d = torch.randn(3, r, s, generator=g)
    d = (d / d.norm(dim=0, keepdim=True)).to(device)
    if per_sample:
        return planes, {"dir_planes": [x.contiguous() for x in d]}
    return planes, {"dir_part": kmlp.dir_projection(spec, net, d[:, :, 0].T.contiguous(), dtype)}


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("mode", ["per_ray-posenc", "per_sample-rotate"])
def test_nerf_mlp_kernel_matches_plain(cuda, mode, width):
    per_sample = mode.startswith("per_sample")
    spec, net = _net(mode.split("-")[1], width, cuda)
    planes, kw = _mlp_inputs(spec, net, per_sample, 37, 24, cuda)  # N not a tile multiple
    before = kmlp.nerf_mlp.launches
    sigma, rgb = kmlp.nerf_mlp(spec, net, *planes, **kw)
    assert kmlp.nerf_mlp.launches == before + 1
    ref_s, ref_rgb = kmlp.nerf_mlp_plain(spec, net, *planes, **kw)
    # f32 products summed in another order than cuBLAS
    torch.testing.assert_close(sigma, ref_s, atol=1e-4, rtol=0)
    for c in range(3):
        torch.testing.assert_close(rgb[c], ref_rgb[c], atol=1e-4, rtol=0)


@pytest.mark.parametrize("width", [64, 256])
@pytest.mark.parametrize("per_sample", [False, True])
def test_nerf_mlp_kernel_bf16_matches_plain(cuda, per_sample, width):
    """The tensor-core (wgmma) kernel."""
    spec, net = _net("rotate" if per_sample else "posenc", width, cuda)
    planes, kw = _mlp_inputs(spec, net, per_sample, 37, 24, cuda, torch.bfloat16)
    s_k, rgb_k = kmlp.nerf_mlp(spec, net, *planes, compute_dtype=torch.bfloat16, **kw)
    s_p, rgb_p = kmlp.nerf_mlp_plain(spec, net, *planes, compute_dtype=torch.bfloat16, **kw)
    out_k, out_p = torch.stack([s_k, *rgb_k]), torch.stack([s_p, *rgb_p])
    # same bf16 rounding points; a value at a rounding boundary may round
    # to the neighbouring bf16 number on one side
    assert (out_k - out_p).abs().max() <= 5e-2 * out_p.abs().max()


def test_nerf_mlp_never_falls_back_on_card(cuda, monkeypatch):
    spec, net = _net("posenc", 64, cuda)
    planes, kw = _mlp_inputs(spec, net, False, 4, 8, cuda)

    def refuse(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(kmlp, "nerf_mlp_plain", refuse)
    kmlp.nerf_mlp(spec, net, *planes, **kw)
    with pytest.raises(ValueError):
        kmlp.nerf_mlp(spec, net, planes[0].t().contiguous().t(), *planes[1:], **kw)


def _bwd_case(spec, net, per_sample, r, s, device, dtype):
    planes, kw = _mlp_inputs(spec, net, per_sample, r, s, device, dtype)
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(r, s, generator=g).to(device) for _ in range(4)]
    run = lambda fn: fn(spec, net, *planes, cot[0], cot[1:], compute_dtype=dtype, **kw)
    return run


def _flat(out):
    grads, d_planes, d_dir = out
    d_dir = list(d_dir) if isinstance(d_dir, list) else [d_dir]
    return [t for wb in grads for t in wb] + list(d_planes) + d_dir


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["per_ray-posenc", "per_sample-rotate"])
def test_nerf_mlp_bwd_kernel_matches_plain(cuda, mode, dtype, monkeypatch):
    """Several tape chunks (whole rays, the last one ragged) and a sample
    count that is not a tile multiple; two runs are bit-identical."""
    monkeypatch.setattr(kvjp, "CHUNK_SAMPLES", 240)
    per_sample = mode.startswith("per_sample")
    spec, net = _net(mode.split("-")[1], 256, cuda)
    run = _bwd_case(spec, net, per_sample, 37, 24, cuda, dtype)
    before = kvjp.nerf_mlp_bwd.launches
    got = _flat(run(kvjp.nerf_mlp_bwd))
    assert kvjp.nerf_mlp_bwd.launches == before + 1
    again = _flat(run(kvjp.nerf_mlp_bwd))
    ref = _flat(run(kvjp.nerf_mlp_bwd_plain))
    # f32: sums over the samples in another order. bf16: the same rounding
    # points, but a value at a rounding boundary may round to the
    # neighbouring bf16 number on one side, and a ReLU mask further down
    # may flip with it, which moves one sample's whole term of a dW
    # element: the bound is on each output's L2 error (as chip_smoke.py)
    for i, (a, b, c) in enumerate(zip(got, again, ref)):
        assert torch.equal(a, b), f"output {i} differs between two runs"
        if dtype == torch.float32:
            assert (a - c).abs().max() <= 1e-4 * c.abs().max() + 1e-6, f"output {i}"
        else:
            assert (a - c).norm() <= 5e-2 * c.norm() + 1e-6, f"output {i}"


# (direction mode, PE mapping, width, skips, R, S): N = 4099 x 16 = 64k + 48
# samples is not a multiple of the 64-sample tile nor of the bf16 kernels'
# 128-sample pair of tiles; S = 256 runs over chunks of 100 rays, the last
# one 57 rays
HOPPER_CASES = [
    ("per_ray", "posenc", 256, (4,), 4099, 16),
    ("per_sample", "rotate", 256, (4,), 257, 256),
    ("per_ray", "rotate", 64, (1,), 257, 256),
    ("per_sample", "posenc", 64, (1,), 4099, 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", HOPPER_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-skip{c[3][0]}-S{c[5]}")
def test_hopper_mlp_pair_ragged(cuda, case, dtype, monkeypatch):
    """The wgmma / register-tile kernels at ragged sample counts, both
    direction modes and PE mappings, widths 64 and 256, a skip after layer 1
    or 4: the forward (and its tape) against the plain version, the
    backward against the plain version, two backward runs bit-identical,
    and the backward with the forward's tape equal to the recompute's."""
    mode, mapping, width, skips, r, s = case
    monkeypatch.setattr(kvjp, "CHUNK_SAMPLES", 100 * 256)
    per_sample = mode == "per_sample"
    spec, net = _net(mapping, width, cuda, skips)
    planes, kw = _mlp_inputs(spec, net, per_sample, r, s, cuda, dtype)
    (sig, rgb), tape = kmlp.nerf_mlp(spec, net, *planes, compute_dtype=dtype, emit_tape=True, **kw)
    (ref_s, ref_rgb), ref_tape = kmlp.nerf_mlp_plain(spec, net, *planes, compute_dtype=dtype,
                                                      emit_tape=True, **kw)
    out, ref = torch.stack([sig, *rgb]), torch.stack([ref_s, *ref_rgb])
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        torch.testing.assert_close(tape, ref_tape, atol=1e-4, rtol=0)
    else:
        assert (out - ref).abs().max() <= 5e-2 * ref.abs().max()
        assert (tape.float() - ref_tape.float()).abs().max() <= 5e-2 * ref_tape.float().abs().max()
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(r, s, generator=g).to(cuda) for _ in range(4)]
    run = lambda fn, t=None: _flat(fn(spec, net, *planes, cot[0], cot[1:], compute_dtype=dtype,
                                      tape=t, **kw))
    got, again, taped = run(kvjp.nerf_mlp_bwd), run(kvjp.nerf_mlp_bwd), run(kvjp.nerf_mlp_bwd, tape)
    want = run(kvjp.nerf_mlp_bwd_plain)
    for i, (a, b, c, w) in enumerate(zip(got, again, taped, want)):
        assert torch.equal(a, b), f"output {i} differs between two runs"
        assert torch.equal(a, c), f"output {i}: tape and recompute differ"
        if dtype == torch.float32:
            assert (a - w).abs().max() <= 1e-4 * w.abs().max() + 1e-6, f"output {i}"
        else:
            assert (a - w).norm() <= 5e-2 * w.norm() + 1e-6, f"output {i}"


def test_nerf_mlp_fn_routes_kernel_gradients(cuda):
    """The weight gradients that autograd routes to the module's parameters
    through nerf_mlp_fn are the kernel's (dir_part is a leaf here, so the
    direction columns of the views weight get none)."""
    spec, net = _net("posenc", 64, cuda)
    planes, kw = _mlp_inputs(spec, net, False, 16, 32, cuda)
    net.requires_grad_(True)
    sigma, rgb = kvjp.nerf_mlp_fn(spec, net, *planes, **kw)
    (sigma.sum() + sum(c.square().sum() for c in rgb)).backward()
    cot = [torch.ones_like(sigma)] + [2 * c.detach() for c in rgb]
    grads, _, _ = kvjp.nerf_mlp_bwd_plain(spec, net, *planes, cot[0], cot[1:], **kw)
    for (w, b), (gw, gb) in zip(kvjp.net_layers(net), grads):
        torch.testing.assert_close(w.grad, gw, atol=1e-4 * gw.abs().max().item() + 1e-6, rtol=0)
        torch.testing.assert_close(b.grad, gb, atol=1e-4 * gb.abs().max().item() + 1e-6, rtol=0)


@pytest.mark.parametrize("stride", [1, 4])
def test_ericson_kernel_matches_plain(cuda, stride):
    body = body_proxy_smpl_model(subdivisions=3, device=cuda)
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, cuda)
    g = torch.Generator().manual_seed(2)
    pts = (body.v_template[torch.randint(0, body.num_verts, (4096,), generator=g).to(cuda)]
           + 0.05 * torch.randn(4096, 3, generator=g).to(cuda))
    ops = mesh_ops.candidate_operands(pts, body.v_template, topo, k=4, knn_stride=stride)
    before = kmq.ericson_select.launches
    d2, f_id, cp = kmq.ericson_select(*ops)
    assert kmq.ericson_select.launches == before + 1
    rd2, rf, rcp = kmq.ericson_select_plain(*ops)
    # --fmad=false: the same IEEE operations as the plain version
    torch.testing.assert_close(d2, rd2, atol=1e-6, rtol=0)
    for a in range(3):
        torch.testing.assert_close(cp[a], rcp[a], atol=1e-6, rtol=0)
    diff = f_id != rf
    assert (kmq.tie_gap(*ops)[diff] <= 1e-6).all()


def test_ericson_kernel_gradient(cuda):
    body = body_proxy_smpl_model(subdivisions=2, device=cuda)
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, cuda)
    pts = body.v_template[:64] * 1.1
    p3, rows9, cand, stride = mesh_ops.candidate_operands(pts, body.v_template, topo, k=4)
    p3 = p3.clone().requires_grad_(True)
    d2, _, cp = kmq.ericson_select(p3, rows9, cand, stride)
    d2.sum().backward()
    torch.testing.assert_close(p3.grad, 2.0 * (p3 - torch.stack(cp)).detach())


def _offset_net(width, depth, skips, device):
    pe = embedder.make_embedder(4, 9, 10)
    spec = nerf.OffsetNetSpec(pos_pe=pe, nerf=nerf.NeRFSpec(
        depth=depth, width=width, input_ch=pe.out_dim, input_ch_views=0, output_ch=3,
        skips=skips, use_viewdirs=False, scale_type="linear"))
    net = nerf.NeRF(spec.nerf, device=device).reset_parameters(torch.Generator().manual_seed(0))
    return spec, net.requires_grad_(False)


def _offset_inputs(r, s, device):
    g = torch.Generator().manual_seed(4)
    axes = [(torch.rand(r, s, generator=g) * 2 - 1).to(device) for _ in range(3)]
    axes.append(torch.full((r, s), 0.37, device=device))
    return axes, [torch.randn(r, s, generator=g).to(device) for _ in range(3)]


# (R, S, chunk samples): 888 samples over 4 chunks of 256 (the last 120),
# and 65,584 (not a multiple of the bf16 kernels' 128-sample pair of tiles)
# over 3 chunks of 25,600 (the last 14,384)
OFFSET_SHAPES = [(37, 24, 256), (4099, 16, 25600)]


def _offset_case_net(net, device):
    return _offset_net(256, 8, (4,), device) if net == "8x256" else _offset_net(64, 4, (1,), device)


@pytest.mark.parametrize("shape", OFFSET_SHAPES, ids=lambda c: f"N{c[0] * c[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", ["8x256", "4x64"])
def test_offset_mlp_kernels_match_plain(cuda, net, dtype, shape, monkeypatch):
    """Forward and backward at a sample count that is not a tile multiple,
    the backward over several tape chunks (the last one ragged); two
    backward runs are bit-identical. Tolerances as for the nerf_mlp pair."""
    r, s, chunk = shape
    monkeypatch.setattr(koff, "CHUNK_SAMPLES", chunk)
    spec, net = _offset_case_net(net, cuda)
    axes, cot = _offset_inputs(r, s, cuda)
    before = (koff.offset_mlp.launches, koff.offset_mlp_bwd.launches)
    out = torch.stack(koff.offset_mlp(spec, net, axes, dtype))
    ref = torch.stack(koff.offset_mlp_plain(spec, net, axes, dtype))
    flat = lambda o: [t for wb in o[0] for t in wb] + list(o[1])
    got = flat(koff.offset_mlp_bwd(spec, net, axes, cot, dtype))
    again = flat(koff.offset_mlp_bwd(spec, net, axes, cot, dtype))
    assert (koff.offset_mlp.launches, koff.offset_mlp_bwd.launches) == (before[0] + 1, before[1] + 2)
    want = flat(koff.offset_mlp_bwd_plain(spec, net, axes, cot, dtype))
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        assert (out - ref).abs().max() <= 5e-2 * ref.abs().max()
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), f"output {i} differs between two runs"
        if dtype == torch.float32:
            assert (a - c).abs().max() <= 1e-4 * c.abs().max() + 1e-6, f"output {i}"
        else:
            assert (a - c).norm() <= 5e-2 * c.norm() + 1e-6, f"output {i}"


def test_offset_mlp_fn_routes_kernel_gradients(cuda, monkeypatch):
    spec, net = _offset_net(64, 4, (1,), cuda)
    axes, cot = _offset_inputs(16, 32, cuda)
    net.requires_grad_(True)

    def refuse(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    want, _ = koff.offset_mlp_bwd_plain(spec, net, axes, cot)
    monkeypatch.setattr(koff, "offset_mlp_plain", refuse)
    monkeypatch.setattr(koff, "offset_mlp_bwd_plain", refuse)
    out = koff.offset_mlp_fn(spec, net, axes)
    sum((o * c).sum() for o, c in zip(out, cot)).backward()
    for (w, b), (gw, gb) in zip(koff.net_layers(net), want):
        torch.testing.assert_close(w.grad, gw, atol=1e-4 * gw.abs().max().item() + 1e-6, rtol=0)
        torch.testing.assert_close(b.grad, gb, atol=1e-4 * gb.abs().max().item() + 1e-6, rtol=0)
    with pytest.raises(ValueError):
        koff.offset_mlp(spec, net, [axes[0].t().contiguous().t(), *axes[1:]])


@pytest.mark.parametrize("case", ["V=642,k=4", "V=640,k=4", "V=40,k=3", "V=2562,k=8"])
def test_bucketed_knn_kernel_matches_plain(cuda, case):
    """V a multiple of 64 and not, V < 64 (buckets of padding only, the
    clamp), k up to 8, a query count that is not a block multiple. The
    scores are the same f32 operations on both sides; an index may differ
    only where the two picked scores tie."""
    v, k = (int(x.split("=")[1]) for x in case.split(","))
    body = body_proxy_smpl_model(subdivisions=3 if v <= 642 else 4, device=cuda)
    verts = body.v_template[:v].contiguous()
    g = torch.Generator().manual_seed(5)
    pts = (verts[torch.randint(0, v, (1000,), generator=g).to(cuda)]
           + 0.05 * torch.randn(1000, 3, generator=g).to(cuda))
    before = kknn.bucketed_knn.launches
    idx, score = kknn.bucketed_knn(pts, verts, k)
    assert kknn.bucketed_knn.launches == before + 1
    ref_idx, ref_score = kknn.bucketed_knn_plain(pts, verts, k)
    assert idx.dtype == torch.int32 and idx.shape == (1000, k)
    assert ((idx >= 0) & (idx < v)).all()
    torch.testing.assert_close(score, ref_score, atol=1e-5, rtol=0)
    diff = idx != ref_idx
    assert ((score - ref_score).abs()[diff] <= 1e-5).all()
    assert diff.float().mean() <= 1e-2


def _tape_case(kind, dtype, device, r=37, s=24):
    """(forward with tape, backward(tape), plain forward with tape) of one
    net at a sample count that is not a tile multiple."""
    if kind.startswith("offset"):
        spec, net = _offset_case_net(kind.split("-")[1], device)
        axes, cot = _offset_inputs(r, s, device)
        fwd = lambda fn: fn(spec, net, axes, dtype, emit_tape=True)
        bwd = lambda tape: koff.offset_mlp_bwd(spec, net, axes, cot, dtype, tape=tape)
        flat = lambda o: [t for wb in o[0] for t in wb] + list(o[1])
        return fwd, koff.offset_mlp, koff.offset_mlp_plain, bwd, flat
    per_sample = kind == "per_sample"
    spec, net = _net("rotate" if per_sample else "posenc", 256, device)
    planes, kw = _mlp_inputs(spec, net, per_sample, 37, 24, device, dtype)
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(37, 24, generator=g).to(device) for _ in range(4)]
    fwd = lambda fn: fn(spec, net, *planes, compute_dtype=dtype, emit_tape=True, **kw)
    bwd = lambda tape: kvjp.nerf_mlp_bwd(spec, net, *planes, cot[0], cot[1:],
                                         compute_dtype=dtype, tape=tape, **kw)
    return fwd, kmlp.nerf_mlp, kmlp.nerf_mlp_plain, bwd, _flat


TAPE_CASES = [("per_ray", 37, 24, 256), ("per_sample", 37, 24, 256),
              ("offset-8x256", 37, 24, 256), ("offset-8x256", 4099, 16, 25600),
              ("offset-4x64", 4099, 16, 25600)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", TAPE_CASES, ids=lambda c: f"{c[0]}-N{c[1] * c[2]}")
def test_tape_backward_is_bit_identical_to_recompute(cuda, case, dtype, monkeypatch):
    """The forward kernels' tape holds what the backward's chain pass
    recomputes, bit for bit, so every gradient with the tape equals the
    recompute configuration's exactly, over several ragged chunks; the tape
    agrees with the plain version's at the forward's tolerances."""
    kind, r, s, chunk = case
    monkeypatch.setattr(kvjp, "CHUNK_SAMPLES", 240)
    monkeypatch.setattr(koff, "CHUNK_SAMPLES", chunk)
    fwd, kernel, plain, bwd, flat = _tape_case(kind, dtype, cuda, r, s)
    _, tape = fwd(kernel)
    _, ref_tape = fwd(plain)
    width = 64 if kind.endswith("4x64") else 256
    depth = 4 if kind.endswith("4x64") else 8
    assert tape.dtype == dtype and tape.shape == (r * s, depth * width)
    if dtype == torch.float32:
        torch.testing.assert_close(tape, ref_tape, atol=1e-4, rtol=0)
    else:
        assert (tape.float() - ref_tape.float()).abs().max() <= 5e-2 * ref_tape.float().abs().max()
    for i, (a, b) in enumerate(zip(flat(bwd(tape)), flat(bwd(None)))):
        assert torch.equal(a, b), f"output {i}: tape and recompute differ"


def test_tape_functions_route_gradients_and_skip_no_grad(cuda, monkeypatch):
    spec, net = _net("posenc", 64, cuda)
    planes, kw = _mlp_inputs(spec, net, False, 16, 32, cuda)
    net.requires_grad_(True)
    grads = {}
    for mode in ("recompute", "hbm"):
        net.zero_grad()
        sigma, rgb = kvjp.nerf_mlp_fn(spec, net, *planes, tape_mode=mode, **kw)
        (sigma.sum() + sum(c.square().sum() for c in rgb)).backward()
        grads[mode] = [p.grad.clone() for p in net.parameters() if p.grad is not None]
    assert all(torch.equal(a, b) for a, b in zip(grads["recompute"], grads["hbm"]))
    seen = []
    real = kmlp._launch
    monkeypatch.setattr(kmlp, "_launch", lambda *a: seen.append(a[-1]) or real(*a))
    with torch.no_grad():
        kvjp.nerf_mlp_fn(spec, net, *planes, tape_mode="hbm", **kw)
    kvjp.nerf_mlp_fn(spec, net, *planes, tape_mode="hbm", **kw)
    assert seen == [False, True]


@pytest.mark.parametrize("tables", [False, True], ids=["gathered", "tables"])
@pytest.mark.parametrize("stride", [1, 4])
def test_signed_select_kernel_matches_plain_and_unsigned(cuda, stride, tables):
    """sd and the closest point equal the plain version's bit for bit
    (--fmad=false), |sd|, closest point and face id the unsigned kernel's,
    and the gradient the plain Function's."""
    body = body_proxy_smpl_model(subdivisions=3, device=cuda)
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, cuda)
    g = torch.Generator().manual_seed(2)
    pts = (body.v_template[torch.randint(0, body.num_verts, (4096,), generator=g).to(cuda)]
           + 0.05 * torch.randn(4096, 3, generator=g).to(cuda))
    tabs = mesh_ops.build_query_tables(body.v_template, topo) if tables else None
    p3, rows9, vn9, cand, st = mesh_ops.candidate_operands(
        pts, body.v_template, topo, k=4, knn_stride=stride, tables=tabs, normals=True)
    before = kmq.ericson_signed_select.launches
    p3 = p3.clone().requires_grad_(True)
    sd, f_id, cp = kmq.ericson_signed_select(p3, rows9, vn9, cand, st)
    assert kmq.ericson_signed_select.launches == before + 1
    sd.sum().backward()
    grad, p3.grad = p3.grad, None
    rsd, rf, rcp = kmq.ericson_signed_select(p3, rows9, vn9, cand, st, plain=True)
    rsd.sum().backward()
    assert torch.equal(sd, rsd) and torch.equal(torch.stack(cp), torch.stack(rcp))
    assert torch.equal(grad, p3.grad)
    assert (kmq.tie_gap(p3.detach(), rows9, cand, st)[f_id != rf] <= 1e-6).all()
    d2, uf, ucp = kmq.ericson_select(p3.detach(), rows9, cand, st)
    assert torch.equal(sd.abs(), torch.sqrt(d2.clamp(min=0))) and torch.equal(f_id, uf)
    assert torch.equal(torch.stack(cp), torch.stack(ucp))
    assert (sd < 0).any() and (sd > 0).any()
    full = mesh_ops.signed_distance(pts, body.v_template, topo, k=4, knn_stride=stride,
                                    tables=tabs)[0]
    assert (torch.sign(full) != torch.sign(sd)).float().mean() <= 1e-3


@pytest.mark.parametrize("frame", ["smpl_posed", "smpl_canonical", "multi_persons"])
def test_render_frames_kernels_match_plain(cuda, frame):
    """The human-only and multi-person frames through the kernels against
    the plain path at the image-parity bar (40 dB), 36 x 48 in bf16."""
    import math
    import types

    from neuman_tpu_torch.models import human_nerf, smpl
    from neuman_tpu_torch.options.config import NeuManConfig
    from neuman_tpu_torch.render import renderer

    cfg = NeuManConfig(nerf_width=64, nerf_depth=6)  # the skip after layer 4 needs depth >= 6
    spec = human_nerf.build_human_nerf_spec(cfg)
    model = human_nerf.HumanNeRF(spec, device=cuda, generator=torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    model.coarse_bkg_net.nerf.alpha_linear.bias.fill_(0.5)
    model.fine_bkg_net.nerf.alpha_linear.bias.fill_(0.5)
    model.coarse_human_net.nerf.alpha_linear.bias.fill_(5.0)
    body = body_proxy_smpl_model(subdivisions=3, device=cuda)
    verts, ts = smpl.da_pose_to_scene(body, torch.zeros(1, 72, device=cuda),
                                      torch.zeros(1, 10, device=cuda))
    h, w = 36, 48
    cap = types.SimpleNamespace(
        shape=(h, w), near={"bkg": 0.5}, far={"bkg": 6.0},
        intrinsic_matrix=[[40.0, 0.0, w / 2], [0.0, 40.0, h / 2], [0.0, 0.0, 1.0]],
        cam_pose=types.SimpleNamespace(
            camera_to_world=[[1.0, 0, 0, 0], [0, -1.0, 0, 0], [0, 0, -1.0, 3.0], [0, 0, 0, 1.0]]))
    kw = dict(rays_per_batch=512, samples_per_ray=16, geo_threshold=0.2, knn_k=4, knn_stride=4)
    shift = torch.tensor([0.8, 0.0, 0.0], device=cuda)
    ts2 = ts.clone()
    ts2[:, :3, 3] += shift
    render = {
        "smpl_posed": lambda use: renderer.render_smpl_nerf(
            spec, model, cap, verts, body.faces, ts, cuda, use_kernels=use, **kw),
        "smpl_canonical": lambda use: renderer.render_smpl_nerf(
            spec, model, cap, body.v_template, body.faces, None, cuda, render_can=True,
            use_kernels=use, **kw),
        "multi_persons": lambda use: renderer.render_hybrid_nerf_multi_persons(
            spec, model, cap, [spec, spec], [model, model], [verts, verts + shift],
            [body.faces, body.faces], [ts, ts2], cuda, importance_samples_per_ray=16,
            use_kernels=use, **kw),
    }[frame]
    before = kmlp.nerf_mlp.launches
    out, ref = render(True), render(False)
    assert kmlp.nerf_mlp.launches > before
    assert out[0].shape == (h, w, 3) and all(torch.isfinite(x).all() for x in out)
    psnr = -10.0 * math.log10(max(torch.mean((out[0] - ref[0]) ** 2).item(), 1e-20))
    assert psnr >= 40.0, psnr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_human_is_deterministic_without_outside_flags(cuda, dtype, tmp_path):
    """Two train_human runs of 2 steps (and their validations) from one seed
    give the same parameters bit for bit, with no cuDNN flag set from
    outside: the step scopes cuDNN's deterministic convolutions (the LPIPS
    loss's backward) itself, and leaves the process's flags as it found
    them. A narrow net and a small scene keep it short."""
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.datasets import arrays as darrays
    from neuman_tpu_torch.options.config import NeuManConfig, apply_mode_defaults

    cudnn = torch.backends.cudnn
    flags = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    body = body_proxy_smpl_model(subdivisions=3, device=cuda)
    scene = darrays.synthetic_human_scene(body, 4, 64, 96, seed=0, device=cuda)
    params = []
    for run in range(2):
        cfg = apply_mode_defaults(NeuManConfig(), "smpl_and_offset")
        fields = dict(out_dir=str(tmp_path), name=f"run{run}", seed=0, max_iter=2,
                      valid_iter=1000, compute_dtype=dtype, nerf_depth=6, nerf_width=64,
                      rays_per_batch=1024 + 32, samples_per_ray=16, geo_threshold=0.25)
        for k, v in fields.items():
            setattr(cfg, k, v)
        trainer = ttrain.train_human(cfg.finalize(), scene, [0, 1, 2], [3], body, device=cuda)
        params.append([p.detach().clone() for p in trainer.model.parameters()])
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32) == flags
    assert all(torch.equal(a, b) for a, b in zip(*params))
