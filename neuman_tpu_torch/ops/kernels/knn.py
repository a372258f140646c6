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
tensors. Both take the score as the chain
fma(vz, -2 pz, fma(vy, -2 py, vx * -2 px)) + |v|^2 with a rounding to
f32 after each step, so they pick the same vertices unless two scores lie
within a rounding of each other.
"""

import ctypes
import functools

import torch

from neuman_tpu_torch.ops.kernels import _build

NUM_BUCKETS = 64
# queries per chunk of the plain version's [chunk, V_pad] f64 score matrix
PLAIN_CHUNK = 2048


def bucket_table(verts, num_buckets=NUM_BUCKETS):
    """[B, VB, 4] rows (x, y, z, |v|^2) of the vertices, bucket-major:
    entry (b, j) is vertex j * B + b; the bucket size VB is rounded up to a
    multiple of 8 as in the JAX package, and padding rows are (0, 0, 0,
    1e30): big and finite."""
    v = verts.shape[0]
    vb = -(-(-(-v // num_buckets)) // 8) * 8
    tab = torch.cat([verts, (verts * verts).sum(-1, keepdim=True)], dim=-1)
    pad = torch.zeros(num_buckets * vb - v, 4, dtype=tab.dtype, device=tab.device)
    pad[:, 3] = 1e30
    tab = torch.cat([tab, pad])
    return tab.reshape(vb, num_buckets, 4).permute(1, 0, 2).contiguous()


def _scores(points, table):
    """[n, B, VB] f32 scores, each step of the chain an exact f64 product
    and sum rounded once to f32 (what an f32 FMA gives)."""
    q = (-2.0 * points)[:, None, None, :]  # [n, 1, 1, 3]
    f64 = lambda t: t.double()
    acc = table[None, ..., 0] * q[..., 0]
    for a in (1, 2):
        acc = (f64(table[None, ..., a]) * f64(q[..., a]) + f64(acc)).float()
    return acc + table[None, ..., 3]


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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bucketed_knn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bucketed_knn_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.bucketed_knn_launch.restype = ctypes.c_int
    return lib


def _launch(points, verts, k, num_buckets):
    device = points.device
    nq = points.shape[0]
    for t, what in ((points, "points"), (verts, "verts")):
        if t.device != device or t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"bucketed_knn: {what} must be f32 [N, 3] on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= k <= min(8, num_buckets):
        raise ValueError(f"bucketed_knn kernel: k={k} outside 1..{min(8, num_buckets)}")
    points = points.contiguous()
    table = bucket_table(verts, num_buckets)
    idx = torch.empty(nq, k, device=device, dtype=torch.int32)
    score = torch.empty(nq, k, device=device, dtype=torch.float32)
    err = _lib().bucketed_knn_launch(
        points.data_ptr(), table.data_ptr(), idx.data_ptr(), score.data_ptr(), nq,
        verts.shape[0], num_buckets, table.shape[1], k,
        torch.cuda.current_stream(device).cuda_stream)
    if err == -1:
        raise ValueError(f"bucketed_knn kernel: unsupported k={k}")
    _build.check(err, "bucketed_knn")
    bucketed_knn.launches += 1
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


bucketed_knn.launches = 0
