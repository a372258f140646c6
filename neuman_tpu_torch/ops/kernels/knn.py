"""Bucketed vertex KNN: the `bucketed_knn` CUDA kernel.

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


def bucket_size(num_verts, num_buckets=NUM_BUCKETS):
    """Entries of one bucket: ceil(V / B) rounded up to a multiple of 8, as
    in the JAX package."""
    return -(-(-(-num_verts // num_buckets)) // 8) * 8


def bucket_table(verts, num_buckets=NUM_BUCKETS):
    """[B, VB, 4] rows (x, y, z, |v|^2) of the vertices, bucket-major:
    entry (b, j) is vertex j * B + b; |v|^2 = (x*x + y*y) + z*z in f32;
    padding rows are (0, 0, 0, 1e30): big and finite."""
    v = verts.shape[0]
    vb = bucket_size(v, num_buckets)
    x, y, z = verts.unbind(-1)
    tab = torch.cat([verts, ((x * x + y * y) + z * z)[:, None]], dim=-1)
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
    """[n, B, VB] f32 scores: fma(vz, qz, fma(vy, qy, fma(vx, qx, |v|^2)))
    with q = -2p, each FMA rounded once (what the kernel's FFMAs give)."""
    q = (-2.0 * points)[:, None, None, :]  # [n, 1, 1, 3]
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
