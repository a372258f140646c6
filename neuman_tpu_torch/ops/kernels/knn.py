"""Vertex KNN: the `bucketed_knn` and `exact_knn` CUDA kernels.

Replaces neuman_tpu/ops/pallas/meshquery.py `bucketed_knn_pallas` (kernel
:488, pallas_call :505) and keeps its contract: points [Nq, 3], verts
[V, 3] -> knn_idx [Nq, k]. Vertex i lies in bucket i % B (B = 64); each
bucket yields its nearest vertex (the earliest on equal scores), and the k
nearest of those B winners are returned, ties to the lower bucket,
clamped to V - 1. The score |v|^2 - 2 v.p orders a point's vertices as
their distances do. The [Nq, V] score matrix exists only inside the
kernel. Source: neuman_tpu_torch/csrc/bucketed_knn.cu, whose header says
what bounds it on the H100 and how the design answers that.

`bucketed_knn` launches the kernel for CUDA tensors (or raises) and runs
`bucketed_knn_plain`, the same function in plain PyTorch, for CPU
tensors. Both take |v|^2 as (x*x + y*y) + z*z and the score as three
FMAs seeded with it, fma(vz, qz, fma(vy, qy, fma(vx, qx, |v|^2))) with
q = -2p, each rounded once to f32, so they give the same scores bit for
bit and pick the same vertices.

`knn_plan` is the kernel's shared-memory plan (the whole table resident,
or groups of whole buckets, or parts of 8 buckets), computed here and
passed to the launch.

`exact_knn` is the render warp's exact KNN: the k vertices of least score
among all V, (score, index) ascending, equal scores to the lower index,
from the same score as the bucketed KNN's. No [Nq, V] tensor reaches
device memory. Source: neuman_tpu_torch/csrc/exact_knn.cu. There is no TPU
kernel behind it (the JAX package takes `lax.top_k` over a matrix
product); its plain twin `exact_knn_plain` runs for CPU tensors, chunk by
chunk. `exact_plan` is its launch plan (query tiles x vertex slices).
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.utils import tracing

NUM_BUCKETS = 64
# queries per chunk of the plain version's [chunk, V_pad] f64 score matrix
PLAIN_CHUNK = 2048

# the kernel's layout (csrc/bucketed_knn.cu): 16 warps a block; a warp's 32
# lanes are 4 query lanes x 8 bucket slices; a bucket's least score is
# tracked by chunks of 8 entries
KNN_WARPS = 16
KNN_SLICES = 8
KNN_QUERY_LANES = 4
KNN_CHUNK = 8
# dynamic shared memory a block may have on the H100 (227 KB)
SMEM_LIMIT = 232448
TABLE_ENTRY_BYTES = 16

# the exact kernel's layout (csrc/exact_knn.cu): 128 threads a block, each
# holding 4 queries for k <= 4, else 2; V / EXACT_MIN_SLICE_VERTS bounds the
# vertex slices, and the split aims at EXACT_BLOCKS_PER_SM
EXACT_THREADS = 128
EXACT_MIN_SLICE_VERTS = 64
EXACT_BLOCKS_PER_SM = 8
MAX_K = 8
# scores a chunk of the plain exact KNN: its f64 temporaries 8 MB each
EXACT_PLAIN_SCORES = 1 << 20


def bucket_size(num_verts, num_buckets=NUM_BUCKETS):
    """Entries of one bucket: ceil(V / B) rounded up to a multiple of 8, as
    in the JAX package."""
    return -(-(-(-num_verts // num_buckets)) // 8) * 8


def vertex_rows(verts):
    """[V, 4] rows (x, y, z, |v|^2) of the vertices, |v|^2 = (x*x + y*y) +
    z*z in f32, as both kernels stage them."""
    x, y, z = verts.unbind(-1)
    return torch.cat([verts, ((x * x + y * y) + z * z)[:, None]], dim=-1)


def bucket_table(verts, num_buckets=NUM_BUCKETS):
    """[B, VB, 4] `vertex_rows`, bucket-major: entry (b, j) is vertex
    j * B + b; padding rows are (0, 0, 0, 1e30): big and finite."""
    v = verts.shape[0]
    vb = bucket_size(v, num_buckets)
    tab = vertex_rows(verts)
    pad = torch.zeros(num_buckets * vb - v, 4, dtype=tab.dtype, device=tab.device)
    pad[:, 3] = 1e30
    tab = torch.cat([tab, pad])
    return tab.reshape(vb, num_buckets, 4).permute(1, 0, 2).contiguous()


def fma_f32(a, b, c):
    """fma(a, b, c) of f32 tensors rounded once to f32. The product of two
    f32 values is exact in f64; the f64 sum is made round-to-odd (its
    rounding error, by TwoSum, moves an even last bit one step towards the
    exact value), after which rounding to f32 equals rounding the exact
    a*b + c."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _scores(points, table):
    """[n, *table rows] f32 scores of points [n, 3] against a table of
    (x, y, z, |v|^2) rows ([B, VB, 4] or [V, 4]): fma(vz, qz, fma(vy, qy,
    fma(vx, qx, |v|^2))) with q = -2p, each FMA rounded once (what the
    kernels' FFMAs give)."""
    q = (-2.0 * points).reshape(points.shape[0], *(1,) * (table.ndim - 1), 3)
    acc = table[None, ..., 3]
    for a in range(3):
        acc = fma_f32(table[None, ..., a], q[..., a], acc)
    return acc


def bucketed_knn_plain(points, verts, k, num_buckets=NUM_BUCKETS):
    """What the kernel computes, in plain PyTorch: (knn_idx [Nq, k] int32,
    scores [Nq, k] f32, ascending)."""
    table = bucket_table(verts, num_buckets)
    idx_out, sc_out = [], []
    for pts in points.split(PLAIN_CHUNK):
        score = _scores(pts, table)
        best, pos = score.min(dim=2)  # the first minimum of each bucket
        order = torch.sort(best, dim=1, stable=True)  # ties to the lower bucket
        sel = order.indices[:, :k]
        idx = pos.gather(1, sel) * num_buckets + sel
        idx_out.append(idx.clamp(max=verts.shape[0] - 1).to(torch.int32))
        sc_out.append(order.values[:, :k])
    return torch.cat(idx_out), torch.cat(sc_out)


def knn_plan(nq, num_verts, k, num_sms, group=None, part=None):
    """The kernel's launch plan for Nq queries among V vertices on a card
    with `num_sms` SMs (group and part may be given, to reach the staged
    paths with a small table): a dict of

    - queries: query points a thread holds, fixed by k in the kernel (4
      for k <= 4, else 2: the thread's k-lists stay in registers);
    - resident: the whole table stays in shared memory for the block's
      life, and each warp walks over its own tiles of 4 x queries points;
      else the block stages the table in stages, each `group` whole
      buckets (a multiple of 8) times `part` entries of each (the whole
      bucket, or for very large V a multiple of 8 of it), for each tile of
      16 x 4 x queries points;
    - group, part, bucket_size; smem_bytes: group x (part + 1) x 16, one
      padding entry a bucket row so that the 8 slices read 8 distinct
      banks; stages: the stages of one pass over the table;
    - grid: persistent blocks, one an SM at most, none idle."""
    vb = bucket_size(num_verts)
    row = lambda part: (part + 1) * TABLE_ENTRY_BYTES
    if group is not None:
        part = part or vb
    elif NUM_BUCKETS * row(vb) <= SMEM_LIMIT:
        group, part = NUM_BUCKETS, vb
    elif KNN_SLICES * row(vb) <= SMEM_LIMIT:
        group, part = SMEM_LIMIT // row(vb) // KNN_SLICES * KNN_SLICES, vb
    else:
        group = KNN_SLICES
        part = (SMEM_LIMIT // (KNN_SLICES * TABLE_ENTRY_BYTES) - 1) // KNN_CHUNK * KNN_CHUNK
    queries = 4 if k <= 4 else 2
    warp_tiles = -(-nq // (KNN_QUERY_LANES * queries))
    stages = -(-NUM_BUCKETS // group) * -(-vb // part)
    return {"queries": queries, "resident": stages == 1, "group": group, "part": part,
            "bucket_size": vb, "smem_bytes": group * row(part), "stages": stages,
            "grid": max(1, min(num_sms, -(-warp_tiles // KNN_WARPS)))}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bucketed_knn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bucketed_knn_launch.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.bucketed_knn_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(points, verts, k, num_buckets, plan=None):
    device = points.device
    nq = points.shape[0]
    for t, what in ((points, "points"), (verts, "verts")):
        if t.device != device or t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"bucketed_knn: {what} must be f32 [N, 3] on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if num_buckets != NUM_BUCKETS:
        raise ValueError(f"bucketed_knn kernel: {NUM_BUCKETS} buckets, not {num_buckets}")
    if not 1 <= k <= 8:
        raise ValueError(f"bucketed_knn kernel: k={k} outside 1..8")
    if verts.shape[0] == 0:
        raise ValueError("bucketed_knn kernel: no vertices")
    points, verts = points.contiguous(), verts.contiguous()
    if plan is None:
        plan = knn_plan(nq, verts.shape[0], k, _num_sms(device.index or 0))
    idx = torch.empty(nq, k, device=device, dtype=torch.int32)
    score = torch.empty(nq, k, device=device, dtype=torch.float32)
    err = _lib().bucketed_knn_launch(
        points.data_ptr(), verts.data_ptr(), idx.data_ptr(), score.data_ptr(), nq,
        verts.shape[0], k, plan["group"], plan["part"], plan["bucket_size"],
        plan["smem_bytes"], plan["grid"], torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"bucketed_knn kernel: unsupported k={k} or plan {plan}")
    _build.check(err, "bucketed_knn")
    tracing.count("launches.bucketed_knn")
    return idx, score


def bucketed_knn(points, verts, k, num_buckets=NUM_BUCKETS):
    """(knn_idx [Nq, k] int32, scores [Nq, k]) of points [Nq, 3] among
    verts [V, 3]: the kernel for CUDA tensors, `bucketed_knn_plain` for
    CPU tensors. No gradient flows through either."""
    points, verts = points.detach(), verts.detach()
    if points.is_cuda:
        return _launch(points, verts, k, num_buckets)
    if points.device.type != "cpu":
        raise ValueError(f"bucketed_knn: no kernel for device {points.device}")
    return bucketed_knn_plain(points, verts, k, num_buckets)


def _check_exact(k, num_verts, what):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k={k} outside 1..{MAX_K}")
    if num_verts < k:
        raise ValueError(f"{what}: k={k} of {num_verts} vertices")


def _rank_keys(score):
    """int64 keys [n, V] that order each row's f32 scores as `<` does, equal
    scores by column: the score's bits made monotone (negative values' low
    31 bits flipped; -0 taken as +0), shifted above the column."""
    bits = (score + 0.0).view(torch.int32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits << 32 | torch.arange(score.shape[1], device=score.device)


def exact_knn_plain(points, verts, k):
    """What the `exact_knn` kernel computes, in plain PyTorch: knn_idx
    [Nq, k] int64 of points [Nq, 3] among verts [V, 3], the k least scores
    ascending (`_scores` on `vertex_rows`, bit for bit the kernel's), equal
    scores to the lower index; chunks of EXACT_PLAIN_SCORES scores."""
    _check_exact(k, verts.shape[0], "exact_knn_plain")
    table = vertex_rows(verts)
    rows = max(1, EXACT_PLAIN_SCORES // verts.shape[0])
    return torch.cat([torch.topk(_rank_keys(_scores(pts, table)), k, dim=1, largest=False).indices
                      for pts in points.split(rows)])


def exact_plan(nq, num_verts, k, num_sms):
    """The exact kernel's launch plan for Nq queries among V vertices on a
    card with `num_sms` SMs: a dict of

    - queries: queries a thread holds (4 for k <= 4, else 2);
    - tiles: blocks along the queries, one a tile of EXACT_THREADS x
      queries;
    - slices: blocks along the vertices, so that tiles x slices comes
      near EXACT_BLOCKS_PER_SM blocks an SM, and no more (what an SM holds
      at 64 registers a thread: one wave), where the tiles alone do not
      reach it; no more than V / EXACT_MIN_SLICE_VERTS rounded up, and none
      empty; with more than one, a second kernel merges the slices'
      k-lists;
    - slice_verts: vertices a slice (the last may hold fewer)."""
    queries = 4 if k <= 4 else 2
    tiles = -(-nq // (EXACT_THREADS * queries))
    want = EXACT_BLOCKS_PER_SM * num_sms // max(tiles, 1)
    slices = max(1, min(-(-num_verts // EXACT_MIN_SLICE_VERTS), want))
    slice_verts = max(1, -(-num_verts // slices))
    slices = max(1, -(-num_verts // slice_verts))
    return {"queries": queries, "tiles": tiles, "slices": slices, "slice_verts": slice_verts}


@functools.lru_cache(maxsize=None)
def _lib_exact():
    lib = _build.load("exact_knn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.exact_knn_launch.argtypes = [p, i, p, p, p, p] + [i] * 5 + [p]
    lib.exact_knn_launch.restype = ctypes.c_int
    return lib


def exact_knn(points, verts, k):
    """knn_idx [Nq, k] int64 of points [Nq, 3] among verts [V, 3], f32: the
    k vertices of least score, ascending, equal scores to the lower index.
    The kernel for CUDA tensors (one launch a call, and the merge of its
    vertex slices), `exact_knn_plain` for CPU tensors. The points' rows may
    lie any stride apart. No gradient flows."""
    points, verts = points.detach(), verts.detach()
    if points.device.type == "cpu":
        return exact_knn_plain(points, verts, k)
    if not points.is_cuda:
        raise ValueError(f"exact_knn: no kernel for device {points.device}")
    device = points.device
    for t, what in ((points, "points"), (verts, "verts")):
        if t.device != device or t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"exact_knn: {what} must be f32 [N, 3] on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check_exact(k, verts.shape[0], "exact_knn kernel")
    if points.stride(1) != 1 or points.stride(0) < 3:
        points = points.contiguous()
    verts = verts.contiguous()
    nq, v = points.shape[0], verts.shape[0]
    idx = torch.empty(nq, k, device=device, dtype=torch.int64)
    if not nq:
        return idx
    plan = exact_plan(nq, v, k, _num_sms(device.index or 0))
    slices = plan["slices"]
    # the slices' k-lists: scores, then indices, addressed by offsets
    part = torch.empty(2, slices, nq, k, device=device, dtype=torch.int32) if slices > 1 else None
    part_s = None if part is None else part.data_ptr()
    part_i = None if part is None else part_s + part[0].numel() * part.element_size()
    err = _lib_exact().exact_knn_launch(
        points.data_ptr(), points.stride(0), verts.data_ptr(), idx.data_ptr(), part_s, part_i, nq,
        v, k, slices, plan["slice_verts"], torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"exact_knn kernel: bad plan {plan} for V={v}, k={k}")
    _build.check(err, "exact_knn")
    tracing.count("launches.exact_knn")
    return idx
