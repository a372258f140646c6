"""CUDA kernels of neuman_tpu_torch vs their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). This file imports nothing of JAX, so on the GPU machine it
runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import os

import pytest
import torch

from neuman_tpu_torch.models import embedder, nerf
from neuman_tpu_torch.models.smpl import body_proxy_smpl_model
from neuman_tpu_torch.ops import kernels as kernel_registry
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
    before = kernel_registry.launches()
    sigma, rgb = kmlp.nerf_mlp(spec, net, *planes, **kw)
    assert kernel_registry.launches(before)["nerf_mlp"] == 1
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
    before = kernel_registry.launches()
    got = _flat(run(kvjp.nerf_mlp_bwd))
    assert kernel_registry.launches(before)["nerf_mlp_bwd"] == 1
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
    before = kernel_registry.launches()
    d2, f_id, cp = kmq.ericson_select(*ops)
    assert kernel_registry.launches(before)["ericson_select"] == 1
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
    before = kernel_registry.launches()
    out = torch.stack(koff.offset_mlp(spec, net, axes, dtype))
    ref = torch.stack(koff.offset_mlp_plain(spec, net, axes, dtype))
    flat = lambda o: [t for wb in o[0] for t in wb] + list(o[1])
    got = flat(koff.offset_mlp_bwd(spec, net, axes, cot, dtype))
    again = flat(koff.offset_mlp_bwd(spec, net, axes, cot, dtype))
    counts = kernel_registry.launches(before)
    assert (counts["offset_mlp"], counts["offset_mlp_bwd"]) == (1, 2)
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
    before = kernel_registry.launches()
    idx, score = kknn.bucketed_knn(pts, verts, k)
    assert kernel_registry.launches(before)["bucketed_knn"] == 1
    ref_idx, ref_score = kknn.bucketed_knn_plain(pts, verts, k)
    assert idx.dtype == torch.int32 and idx.shape == (1000, k)
    assert ((idx >= 0) & (idx < v)).all()
    torch.testing.assert_close(score, ref_score, atol=1e-5, rtol=0)
    diff = idx != ref_idx
    assert ((score - ref_score).abs()[diff] <= 1e-5).all()
    assert diff.float().mean() <= 1e-2


def _grid_knn_case(num_verts, nq, device, seed=7):
    """Vertices and points on a coarse integer grid: scores tie exactly,
    inside buckets and across them."""
    g = torch.Generator().manual_seed(seed)
    verts = torch.randint(-3, 4, (num_verts, 3), generator=g).float().to(device)
    pts = torch.randint(-4, 5, (nq, 3), generator=g).float().to(device)
    return pts, verts


@pytest.mark.parametrize("plan", ["default", "grouped", "parts"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_bucketed_knn_kernel_equal_on_grid_ties(cuda, k, plan):
    """Where most scores tie exactly, the kernel's indices and scores equal
    the plain version's (the earliest position in a bucket, the lower
    bucket across buckets) under every plan: the resident table, 16
    buckets a stage, and parts of 8 x 8 entries."""
    pts, verts = _grid_knn_case(1000, 1001, cuda)
    kw = {"default": {}, "grouped": {"group": 16}, "parts": {"group": 8, "part": 8}}[plan]
    chosen = kknn.knn_plan(1001, 1000, k, torch.cuda.get_device_properties(0).multi_processor_count,
                           **kw)
    assert chosen["resident"] == (plan == "default")
    idx, score = kknn._launch(pts, verts, k, kknn.NUM_BUCKETS, chosen)
    ref_idx, ref_score = kknn.bucketed_knn_plain(pts, verts, k)
    assert torch.equal(idx, ref_idx) and torch.equal(score, ref_score)


@pytest.mark.parametrize("k", [1, 8])
def test_bucketed_knn_kernel_over_the_shared_budget(cuda, k):
    """V=40,962 (subdivision 6): the table does not fit in shared memory and
    is staged in groups of buckets; Nq=1001 is no tile multiple. Indices and
    scores equal the plain version's (the same roundings on both sides)."""
    body = body_proxy_smpl_model(subdivisions=6, device=cuda)
    verts = body.v_template
    plan = kknn.knn_plan(1001, verts.shape[0], k, 132)
    assert not plan["resident"]
    g = torch.Generator().manual_seed(11)
    pts = (verts[torch.randint(0, verts.shape[0], (1001,), generator=g).to(cuda)]
           + 0.05 * torch.randn(1001, 3, generator=g).to(cuda))
    before = kernel_registry.launches()
    idx, score = kknn.bucketed_knn(pts, verts, k)
    assert kernel_registry.launches(before)["bucketed_knn"] == 1
    ref_idx, ref_score = kknn.bucketed_knn_plain(pts, verts, k)
    assert torch.equal(idx, ref_idx) and torch.equal(score, ref_score)


def test_bucketed_knn_kernel_refuses_k_over_8(cuda, monkeypatch):
    """k > 8 is no instantiation of the kernel: a ValueError naming k, never
    the plain version."""
    verts = body_proxy_smpl_model(subdivisions=3, device=cuda).v_template
    monkeypatch.setattr(kknn, "bucketed_knn_plain", None)
    with pytest.raises(ValueError, match="k=9"):
        kknn.bucketed_knn(verts[:64] * 1.1, verts, 9)


@pytest.mark.parametrize("stride", [1, 4])
def test_mesh_kernels_on_a_degree9_mesh(cuda, stride):
    """SMPL's vertex degree: the proxy at subdivision 4 (V=2,562) with
    vertices of degree 9 (tools/sweep_kernel_envelope.degree9_mesh), k=8,
    C=72; N=4,096 ray samples. ericson_select and the signed table kernel
    equal their plain versions bit for bit."""
    from neuman_tpu_torch.tools import sweep_kernel_envelope as sweep

    ctx = sweep.Context(cuda, subdivisions=4, timed=False)
    assert ctx.meshes["deg9"].topo.incidence.shape[1] == 9
    for case in (sweep.select_case, sweep.signed_case):
        rec, ok = case(ctx, c=72, n=4096, stride=stride)
        assert ok and rec["bit_equal_plain"], rec


def _select_operands(num_cands, nq, stride, device, seed=3):
    """Random triangles around the points, some candidates duplicated (exact
    d2 ties), 20% invalid ids, group 1 all invalid."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(3, nq * stride, generator=g)
    centre = pts.reshape(3, nq, stride).mean(2)
    rows = centre[None, :, None, :] + 0.7 * torch.randn(3, 3, num_cands, nq, generator=g)
    rows = rows.permute(1, 0, 2, 3).reshape(9, num_cands, nq).contiguous()
    cand = torch.randint(0, 500, (num_cands, nq), generator=g, dtype=torch.int32)
    for ci in range(1, num_cands, 3):
        src = int(torch.randint(0, ci, (1,), generator=g))
        rows[:, ci, ::2], cand[ci, ::2] = rows[:, src, ::2], cand[src, ::2]
    cand[torch.rand(cand.shape, generator=g) < 0.2] = -1
    cand[:, 1] = -1
    return pts.to(device), rows.reshape(9 * num_cands, nq).to(device), cand.to(device)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("num_cands", [18, 36])
def test_ericson_kernel_slices_equal_plain(cuda, num_cands, stride):
    """Ragged C, ragged N (1,001 groups), every slice count: d2, closest
    point and face id equal the plain version's, the all-invalid group
    (candidate 0) and the duplicated candidates (the earlier one) too."""
    p3, rows9, cand = _select_operands(num_cands, 1001, stride, cuda)
    rd2, rf, rcp = kmq.ericson_select_plain(p3, rows9, cand, stride)
    for slices in (1, 2, 4, 8):
        plan = {**kmq.select_plan(p3.shape[1], num_cands, stride), "slices": slices,
                "bounds": [s * num_cands // slices for s in range(slices + 1)]}
        d2, f_id, cp = kmq._launch(p3, rows9, cand, stride, plan=plan)
        assert torch.equal(d2, rd2) and torch.equal(f_id, rf), slices
        assert torch.equal(cp, torch.stack(rcp)), slices
    assert torch.isinf(d2[stride:2 * stride]).all() and (f_id[stride:2 * stride] == 0).all()
    before = kernel_registry.launches()
    d2, f_id, cp = kmq.ericson_select(p3, rows9, cand, stride)
    assert kernel_registry.launches(before)["ericson_select"] == 1
    assert torch.equal(d2, rd2) and torch.equal(f_id, rf)


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
    """The table kernel: sd, the closest point and the face id equal the
    plain version's bit for bit (--fmad=false), and the planar plain
    version's on the same candidates gathered into planes (from the
    vertices, or from prebuilt tables); |sd|, closest point and face id the
    unsigned kernel's on those planes; the gradient the plain Function's;
    the signs the unfused query's but for a few points at |dot| ~ 0."""
    body = body_proxy_smpl_model(subdivisions=3, device=cuda)
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, cuda)
    g = torch.Generator().manual_seed(2)
    pts = (body.v_template[torch.randint(0, body.num_verts, (4096,), generator=g).to(cuda)]
           + 0.05 * torch.randn(4096, 3, generator=g).to(cuda))
    tabs = mesh_ops.build_query_tables(body.v_template, topo)
    knn_idx, st = mesh_ops._query_knn(pts, body.v_template, 4, stride)
    args = (knn_idx, tabs.incidence, tabs.vtab9, tabs.vntab9, st)
    before = kernel_registry.launches()
    p3 = pts.T.contiguous().requires_grad_(True)
    sd, f_id, cp = kmq.ericson_signed_select_tables(p3, *args)
    assert kernel_registry.launches(before)["ericson_signed_select"] == 1
    sd.sum().backward()
    grad, p3.grad = p3.grad, None
    rsd, rf, rcp = kmq.ericson_signed_select_tables(p3, *args, plain=True)
    rsd.sum().backward()
    assert torch.equal(sd, rsd) and torch.equal(f_id, rf)
    assert torch.equal(torch.stack(cp), torch.stack(rcp))
    assert torch.equal(grad, p3.grad)
    ops = mesh_ops.candidate_operands(pts, body.v_template, topo, k=4, knn_stride=stride,
                                      tables=tabs if tables else None, normals=True)
    qsd, qf, qcp = kmq.ericson_signed_select(*ops, plain=True)
    assert torch.equal(sd, qsd) and torch.equal(f_id, qf)
    assert torch.equal(torch.stack(cp), torch.stack(qcp))
    d2, uf, ucp = kmq.ericson_select(ops[0], ops[1], ops[3], ops[4])
    assert torch.equal(sd.abs(), torch.sqrt(d2.clamp(min=0))) and torch.equal(f_id, uf)
    assert torch.equal(torch.stack(cp), torch.stack(ucp))
    assert (sd < 0).any() and (sd > 0).any()
    full = mesh_ops.signed_distance(pts, body.v_template, topo, k=4, knn_stride=stride,
                                    tables=tabs if tables else None)[0]
    assert (torch.sign(full) != torch.sign(sd)).float().mean() <= 1e-3
    fused = mesh_ops.signed_distance(pts, body.v_template, topo, k=4, knn_stride=stride,
                                     tables=tabs if tables else None, fused=True)
    assert torch.equal(fused[0], sd) and torch.equal(fused[2], torch.stack(cp, dim=-1))
    with pytest.raises(ValueError, match="planar"):
        kmq.ericson_signed_select(*ops)


@pytest.fixture(scope="module")
def big_tables():
    """The V=40,962 body proxy's query tables (D = 6), with the incidence
    rows of 8 vertices set to -1 (faces nobody may pick)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    body = body_proxy_smpl_model(subdivisions=6, device=torch.device("cuda", 0))
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, body.v_template.device)
    tabs = mesh_ops.build_query_tables(body.v_template, topo)
    dead = torch.arange(100, 108, device=body.v_template.device)
    tabs.incidence[dead] = -1
    return body.v_template, tabs, dead


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("k", [3, 4, 6])
def test_signed_select_tables_kernel_equal_plain(cuda, big_tables, k, stride):
    """C = 18, 24, 36 (k = 3, 4, 6 on D = 6), ragged N (1,001 groups),
    int32 and int64 knn_idx, the tables as views into stacked tables (at an
    offset, as the human step's), every slice plan and the default: sd,
    face id and closest point `torch.equal` to the plain version's, with
    group 1 all invalid (candidate 0: f_id 0, |sd| = inf)."""
    verts, tabs, dead = big_tables
    g = torch.Generator().manual_seed(k + 10 * stride)
    idx = torch.randint(0, verts.shape[0], (1001 * stride,), generator=g).to(cuda)
    pts = verts[idx] + 0.02 * torch.randn(1001 * stride, 3, generator=g).to(cuda)
    knn_idx, st = mesh_ops._query_knn(pts, verts, k, stride)
    assert st == stride
    knn_idx[1] = dead[:k]
    stacked = lambda t: torch.stack([torch.zeros_like(t), t])[1]
    tables = tuple(stacked(t) for t in (tabs.incidence, tabs.vtab9, tabs.vntab9))
    assert tables[1].data_ptr() != tabs.vtab9.data_ptr()
    p3 = pts.T.contiguous()
    num_cands = k * tabs.incidence.shape[1]
    for index in (knn_idx.to(torch.int32), knn_idx):
        args = (index, *tables, stride)
        want = kmq.ericson_signed_select_tables_plain(p3, *args)
        want = (want[0], want[1], torch.stack(want[2]))
        for slices in (1, 2, 4, 8):
            plan = {**kmq.select_plan(p3.shape[1], num_cands, stride), "slices": slices,
                    "bounds": [s * num_cands // slices for s in range(slices + 1)]}
            got = kmq._launch_signed(p3, *args, plan=plan)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (index.dtype, slices)
        sd, f_id, cp = kmq.ericson_signed_select_tables(p3, *args)
        assert torch.equal(sd, want[0]) and torch.equal(f_id, want[1])
        assert torch.equal(torch.stack(cp), want[2])
    invalid = slice(stride, 2 * stride)
    assert torch.isinf(sd[invalid]).all() and (f_id[invalid] == 0).all()
    assert (sd < 0).any() and (sd > 0).any()


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
    before = kernel_registry.launches()
    out, ref = render(True), render(False)
    assert kernel_registry.launches(before)["nerf_mlp"] > 0
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


def test_cli_trains_both_stages_through_the_kernels(cuda, tmp_path, monkeypatch):
    """The command line's two stages on a 48x64 scene directory written by
    tools/synthetic_scene.py, at the narrowest net the kernels take (6 x 64):
    stage 1 launches the NeRF MLP pair, stage 2 (loading stage 1's
    background) every kernel of the default human step."""
    from neuman_tpu_torch import train as ttrain
    from neuman_tpu_torch.tools.synthetic_scene import build_synthetic_scene

    human = ("nerf_mlp", "nerf_mlp_bwd", "offset_mlp", "offset_mlp_bwd", "ericson_select",
             "bucketed_knn")
    scene_dir = build_synthetic_scene(tmp_path / "data_root")
    monkeypatch.setenv("NEUMAN_DATA_ROOT", str(tmp_path / "data_root" / "data"))
    net = ["--nerf_depth", "6", "--nerf_width", "64", "--samples_per_ray", "16",
           "--importance_samples_per_ray", "16", "--max_iter", "2", "--scene_dir", scene_dir,
           "--out_dir", str(tmp_path / "out"), "--dilation", "2"]
    stages = ((["--train_mode", "bkg", "--name", "bkg", "--rays_per_batch", "256"],
               ("nerf_mlp", "nerf_mlp_bwd")),
              (["--train_mode", "smpl_and_offset", "--name", "human", "--load_background", "bkg",
                "--rays_per_batch", "1056"], human))
    for argv, kernels in stages:
        before = kernel_registry.launches()
        trainer = ttrain.main(argv + net, device="cuda")
        counts = kernel_registry.launches(before)
        assert all(counts[k] > 0 for k in kernels), counts
        assert os.path.isfile(os.path.join(trainer.opt.out, "checkpoint.npz"))


def test_render_command_lines_launch_the_kernels(cuda, tmp_path, monkeypatch):
    """The four render command lines on a 48x64 scene directory written by
    tools/synthetic_scene.py (its rigged proxy), from a checkpoint of a
    random 6 x 64 HumanNeRF, run from a temporary working directory: each
    writes its PNGs, `nerf_mlp` launches in all of them and
    `ericson_select` in those that warp."""
    from neuman_tpu_torch import convert, render_360, render_gathering, render_reposing
    from neuman_tpu_torch import render_test_views
    from neuman_tpu_torch.models import human_nerf as hn
    from neuman_tpu_torch.options.config import NeuManConfig
    from neuman_tpu_torch.tools import synthetic_scene
    from neuman_tpu_torch.trainers import checkpoint as ckpt
    from neuman_tpu_torch.utils import png

    scene_dir = synthetic_scene.build_synthetic_scene(tmp_path / "data_root")
    monkeypatch.setenv("NEUMAN_DATA_ROOT", str(tmp_path / "data_root" / "data"))
    monkeypatch.chdir(tmp_path)
    net = dict(nerf_depth=6, nerf_width=64)
    model = hn.HumanNeRF(hn.build_human_nerf_spec(NeuManConfig(**net)),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.coarse_human_net.nerf.alpha_linear.bias.fill_(2.0)
    weights = str(tmp_path / "human" / "checkpoint.npz")
    ckpt.save_checkpoint(weights, {"hybrid_model": convert.to_jax_params(model.state_dict())})
    for actor in ("seattle", "citron"):
        os.makedirs(tmp_path / "out" / f"{actor}_human")
        ckpt.save_checkpoint(str(tmp_path / "out" / f"{actor}_human" / "checkpoint.npz"),
                             {"hybrid_model": convert.to_jax_params(model.state_dict())})
        os.makedirs(tmp_path / "data_root" / actor)
        synthetic = os.path.join(scene_dir, "smpl_output_optimized.pkl")
        with open(synthetic, "rb") as src, open(tmp_path / "data_root" / actor /
                                                "smpl_output_optimized.pkl", "wb") as dst:
            dst.write(src.read())
    synthetic_scene.write_mocap_npz("data/SFU/0018/0018_XinJiang002_poses.npz", 8)
    mocap = synthetic_scene.write_mocap_npz(str(tmp_path / "motion.npz"), 2)
    common = ["--scene_dir", scene_dir, "--weights_path", weights, "--nerf_depth", "6",
              "--nerf_width", "64", "--samples_per_ray", "16", "--importance_samples_per_ray",
              "16", "--rays_per_batch", "1024"]
    warp = ("nerf_mlp", "ericson_select")
    runs = ((render_test_views.main, [], warp, "test_views/scene", 1),
            (render_360.main, ["--mode", "canonical_360", "--trajectory_resolution", "2"],
             ("nerf_mlp",), "canonical_360/scene", 2),
            (render_360.main, ["--mode", "posed_360", "--trajectory_resolution", "2"], warp,
             "posed_360/scene", 2),
            (render_reposing.main, ["--mocap_path", mocap], warp, "reposing/scene", 2),
            (render_gathering.main, ["--actors", "seattle", "citron"], warp,
             "gathering/dance_together", 2))
    for main, argv, kernels, what, frames in runs:
        before = kernel_registry.launches()
        main(argv + common)
        counts = kernel_registry.launches(before)
        assert all(counts[k] > 0 for k in kernels), (what, counts)
        names = sorted(os.listdir(tmp_path / "demo" / what))
        assert len(names) == frames and all(n.startswith("out_") for n in names)
        assert all(png.read_png(str(tmp_path / "demo" / what / n)).shape == (48, 64, 3)
                   for n in names)


def test_preprocess_stages_on_the_card_match_the_cpu(cuda, tmp_path, monkeypatch):
    """Preprocessing stages 9 and 10 (3 steps a frame) on a 4-frame 48x64
    scene of tools/synthetic_scene.write_preprocess_inputs, on the card and
    on the CPU from copies of one scene: the alignments within 1e-4 of
    each matrix's largest entry (1000 f32 Adam steps of the translation in
    two summation orders) and the refined poses within 1e-4 rad (the
    port-vs-JAX bars of tests/test_torch_preprocess.py)."""
    import shutil

    import numpy as np

    from neuman_tpu_torch.data_io import smpl_pickle
    from neuman_tpu_torch.preprocess import cli as pcli
    from neuman_tpu_torch.tools.synthetic_scene import write_preprocess_inputs

    scene, _ = write_preprocess_inputs(str(tmp_path / "src"), num_frames=4, h=48, w=64)
    monkeypatch.setenv("NEUMAN_DATA_ROOT", str(tmp_path / "src" / "data"))
    out = {}
    for dev in ("cuda", "cpu"):
        d = str(tmp_path / dev)
        shutil.copytree(scene, d)
        align = pcli.run_alignment(os.path.join(d, "sparse"), os.path.join(d, "images"),
                                   os.path.join(d, "romp"), device=dev)
        pcli.run_optimize_smpl(d, num_iters=3, device=dev)
        out[dev] = align, smpl_pickle.load(os.path.join(d, "smpl_output_optimized.pkl"))[1]
    (ga, gfits), (ca, cfits) = out["cuda"], out["cpu"]
    for name, a in ga.items():
        assert np.abs(a - ca[name]).max() <= 1e-4 * np.abs(ca[name]).max()
    np.testing.assert_allclose(gfits["pose"], cfits["pose"], atol=1e-4)
