"""Data parallelism over torch.distributed (counterpart of
neuman_tpu/parallel/mesh.py).

The reference trains with `nn.DataParallel` over the local GPUs; the JAX
package shards each ray batch over a 1-D `data` mesh and lets GSPMD
partition the unchanged step. Here no compiler partitions the step, so the
port does by hand what makes the sharded step compute the unsharded one's
result:

- parameters and optimiser state are replicated: every rank builds them
  from the same seed, and `put_replicated` broadcasts rank 0's;
- every rank draws the whole batch, and every random draw inside the loss,
  at the global shape from identical generators, and keeps its contiguous
  block of rows (`shard_leading_axis`, `draw_rows`, `sharded_draw`). Rows
  are rays, so the group-KNN stride's groups of consecutive samples along
  a ray stay whole;
- a mean over rays or samples divides this rank's sum by the global count
  (`mean`, `masked_mean`; a count that comes from a mask is all-reduced
  first), so that the losses of the ranks sum to the global loss, and their
  gradients sum to the global gradient (not DDP's mean of per-rank means);
- the gradients and the losses are summed over the ranks in one
  all-reduce (`all_reduce_flat`), and the dead-net tests are maxima over
  the ranks, so every rank takes the same skip, restart and update.

Renders shard each chunk's rays over the ranks (the JAX renderers'
`mesh=`): `ChunkRows` gives this rank its contiguous block of each chunk,
and one all_gather a frame joins the blocks.

Launch N processes, one GPU each, with

    torchrun --nproc_per_node N -m neuman_tpu_torch.train ...
    torchrun --nproc_per_node N -m neuman_tpu_torch.render_test_views ...

`maybe_init_distributed` joins them into one NCCL group; `resolve_mesh`
(training) and `resolve_render_mesh` (rendering) turn the config's
`data_parallel` into a `DataMesh` or None.

`DataMesh`'s collectives are traced (utils/tracing.py): the span
`mesh.all_reduce` around each all-reduce (its device ms include the wait
for the slowest rank), and the int counters `mesh.collectives` (the calls
of `all_reduce`, `broadcast` and `gather_rows`) and `mesh.all_reduce_bytes`
(the bytes handed to `all_reduce`). A stage-1 step makes 4 collectives: the
two penalty-mask counts, the flat sum of the gradients and the losses, and
the density maxima.
"""

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from neuman_tpu_torch.utils import tracing

# a collective that waits longer than this fails the run instead of hanging it
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def maybe_init_distributed(backend="nccl", timeout=COLLECTIVE_TIMEOUT):
    """Join the process group when the process was launched as one rank of
    several: under torchrun's contract (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT in the environment), or with
    NEUMAN_TPU_DISTRIBUTED=1 and those variables set by another launcher.
    With NCCL each rank takes the GPU `LOCAL_RANK`; NCCL cannot put two
    ranks of one group on one GPU, so that raises. Returns True when this
    call initialised the group (False without the variables, or when the
    group is up already). `timeout` bounds the rendezvous and each
    collective's wait."""
    env = os.environ
    want = env.get("NEUMAN_TPU_DISTRIBUTED", "") == "1" or ("RANK" in env and "WORLD_SIZE" in env)
    if not want or dist.is_initialized():
        return False
    if backend == "nccl":
        local_rank = int(env.get("LOCAL_RANK", "0"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(local_rank + 1)))
        gpus = torch.cuda.device_count()
        if local_rank >= gpus or local_world > gpus:
            raise RuntimeError(
                f"{local_world} NCCL ranks on this host but {gpus} GPUs: NCCL cannot put two "
                "ranks of one group on one GPU; start at most one process per GPU")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method="env://", timeout=timeout)
    return True


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This rank's place on the data axis: `rank` of the `size` processes
    of the default process group."""

    rank: int
    size: int
    axis: str = "data"

    @classmethod
    def of_process_group(cls, axis="data"):
        return cls(dist.get_rank(), dist.get_world_size(), axis)

    def rows(self, n):
        """This rank's contiguous block of n rows."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rays does not split over {self.size} ranks: "
                             "choose a rays_per_batch that the world size divides")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, x):
        return x[self.rows(x.shape[0])]

    def all_reduce(self, t, op="sum"):
        """The sum (or "max") of `t` over the ranks, reduced in place;
        returns `t`."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        tracing.count("mesh.collectives")
        tracing.count("mesh.all_reduce_bytes", t.numel() * t.element_size())
        with tracing.span("mesh.all_reduce"):
            dist.all_reduce(t, op=red)
        return t

    def broadcast(self, t):
        """Rank 0's `t` on every rank, in place; returns it."""
        tracing.count("mesh.collectives")
        dist.broadcast(t, src=0)
        return t

    def gather_rows(self, t):
        """Every rank's rows of `t`, concatenated in rank order (the
        unsharded tensor), differentiable: the gradient of the gathered
        tensor is summed over the ranks and each rank keeps its own rows."""
        tracing.count("mesh.collectives")
        return _GatherRows.apply(t, self)

    def broadcast_object(self, obj):
        """Rank 0's picklable `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        dist.barrier()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        src = t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return mesh.shard(mesh.all_reduce(grad.contiguous().clone())), None


def resolve_render_mesh(opt):
    """The run's data mesh from the config, as the JAX package resolves it:
    data_parallel "auto" gives a mesh over the process group when there
    is more than one process, "on" even with one, "off" none. "off" with
    more than one process raises: the ranks would each run apart. A
    mesh needs the process group (`maybe_init_distributed`). A chunk that
    the world size does not divide is the renderer's warning, not an
    error here."""
    dp = opt.data_parallel
    if dp not in ("auto", "on", "off"):
        raise ValueError(f"data_parallel must be auto, on or off, not {dp!r}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp == "off":
        if world > 1:
            raise ValueError(f"data_parallel off with {world} processes: each rank would run "
                             f"apart; use data_parallel auto or on, or start one process")
        return None
    if dp == "auto" and world == 1:
        return None
    if not dist.is_initialized():
        raise ValueError("data_parallel on needs a process group: launch with torchrun (or set "
                         "NEUMAN_TPU_DISTRIBUTED=1 and the torchrun variables)")
    return DataMesh.of_process_group(axis=opt.data_axis)


def resolve_mesh(opt):
    """The training mesh: `resolve_render_mesh`, and a rays_per_batch that
    the world size does not divide raises (every rank takes an equal share
    of each batch)."""
    mesh = resolve_render_mesh(opt)
    if mesh is not None:
        mesh.rows(opt.rays_per_batch)
    return mesh


class ChunkRows:
    """The rows of `total` rays, taken in chunks of `chunk`, that this rank
    renders (the JAX renderers' row-sharded chunks: `_chunked`,
    `_maybe_shard_stacked`). Iterating gives, chunk by chunk, (this rank's
    rows of the frame, where they go in its buffers of `local` rows, the
    whole chunk: slice(i, i + n) of the frame, the same rows as positions
    within the chunk). Without a mesh the rows are the whole chunk, at the
    same place. With one, the chunk is padded by
    repeating its last ray to a multiple of the mesh size, and this rank
    takes its contiguous block of it (an index tensor on `device`);
    `gather` joins the ranks' buffers into the frame in one all_gather."""

    def __init__(self, total, chunk, mesh=None, device=None):
        size = 1 if mesh is None else mesh.size
        self.total, self.mesh, self.device = total, mesh, device
        # (first row, rows, rows a rank) of each chunk
        self.spans = [(i, min(chunk, total - i), -(-min(chunk, total - i) // size))
                      for i in range(0, total, chunk)]
        self.local = sum(k for _, _, k in self.spans)

    def __iter__(self):
        at = 0
        for i, n, k in self.spans:
            if self.mesh is None:
                yield slice(i, i + n), slice(at, at + n), slice(i, i + n), slice(0, n)
            else:
                first = self.mesh.rank * k
                rows = torch.arange(first, first + k, device=self.device).clamp_(max=n - 1)
                yield rows + i, slice(at, at + k), slice(i, i + n), rows
            at += k

    def gather(self, *local):
        """Each of this rank's buffers (`local` rows each) as the frame's
        `total` rows, every rank's blocks in their places (the JAX order
        [ranks, chunks, chunk/ranks] -> [chunks, ranks, chunk/ranks] ->
        [:total]), the padding dropped: one all_gather of the buffers'
        columns side by side. Without a mesh (or rows), the buffers."""
        if self.mesh is None or not self.total:
            return local
        cols = [t.reshape(self.local, -1) for t in local]
        every = self.mesh.gather_rows(torch.cat(cols, 1))  # [size * local, columns]
        ranks = torch.arange(self.mesh.size)[:, None]
        pos = torch.cat([i + ranks * k + torch.arange(k) for i, _, k in self.spans], 1)
        real = torch.cat([ranks * k + torch.arange(k) < n for _, n, k in self.spans], 1)
        frame = every.new_empty(self.total, every.shape[1])
        frame[pos[real].to(every.device)] = every[real.reshape(-1).to(every.device)]
        out, at = [], 0
        for t, c in zip(local, cols):
            out.append(frame[:, at:at + c.shape[1]].reshape(self.total, *t.shape[1:]))
            at += c.shape[1]
        return tuple(out)


def shard_leading_axis(batch, mesh):
    """This rank's block of rows of every per-ray entry of `batch` (a dict);
    0-dim entries (the view id, its time) are kept whole. A ray count that
    the world size does not divide raises. No mesh: the batch as it is."""
    if mesh is None:
        return batch
    return {k: mesh.shard(v) if v.ndim else v for k, v in batch.items()}


def draw_rows(draw, n, mesh):
    """draw(rows) -> a tensor of `rows` leading rows: this rank's n rows of
    the draw at the global row count, so that the values equal those of the
    unsharded draw and the generator advances as it does there. No mesh:
    draw(n)."""
    if mesh is None:
        return draw(n)
    return mesh.shard(draw(n * mesh.size))


def sharded_draw(draw, mesh):
    """`draw` (torch.rand's signature: a shape, then keywords) made to give
    this rank's rows of the draw at the global row count (`draw_rows`):
    what the ops that draw (`sample_z_vals`, `integrate_planar`) take under
    a mesh. No mesh: `draw`."""
    if mesh is None:
        return draw
    return lambda shape, **kw: draw_rows(lambda n: draw((n, *shape[1:]), **kw), shape[0], mesh)


def mean(x, mesh):
    """The mean of `x` over every rank's rows: this rank's share of it."""
    if mesh is None:
        return torch.mean(x)
    return x.sum() / (x.numel() * mesh.size)


def masked_mean(values, mask, mesh):
    """sum(values * mask) / max(sum(mask), 1) over every rank's rows: this
    rank's share of it (the mask's count is all-reduced first)."""
    count = mask.sum()
    if mesh is not None:
        count = mesh.all_reduce(count.detach().clone())
    return (values * mask).sum() / torch.clamp(count, min=1.0)


def all_reduce_flat(mesh, tensors):
    """The sums over the ranks of a list of float tensors, in one
    all-reduce of their concatenation. No mesh: the list as it is."""
    if mesh is None:
        return list(tensors)
    flat = mesh.all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def put_replicated(tree, mesh):
    """Broadcast rank 0's tensors into every rank's, in place: `tree` is a
    module (its state_dict: parameters and buffers), a tensor, or dicts and
    lists of them (the optimiser state). Returns `tree`."""
    if mesh is not None:
        with torch.no_grad():
            for t in _leaves(tree):
                mesh.broadcast(t)
    return tree
