"""Renderers (counterpart of the planar paths of neuman_tpu/render/renderer.py:
`_bkg_branch_planar`, `_human_branch_planar`, `render_hybrid_nerf`,
`render_smpl_nerf`, `render_hybrid_nerf_multi_persons`, and
`render_vanilla`, the background-only render the background trainer
validates with).

One frame path behind the four renderers, by the compact dispatch:
- the hit test (`_frame_hit_test`): each actor's geometry-guided near and
  far over the frame's rays (a ray hits when it passes within
  geo_threshold of a body vertex), then one host wait for the frame's hit
  lists (`_hit_list`: the union of the actors' hits and each actor's own);
- the background loop (`_bkg_frame`): every ray through the background
  path, chunk by chunk, each chunk keeping the samples of its hit rays (a
  contiguous slice of the ascending list);
- the branches (`_hybrid_frame`): each actor's human branch (warp +
  canonical net) over its own hits in calls of `rays_per_batch` rows, and
  each chunk of the union's list merged by z with its kept background
  samples, one block of samples an actor (placeholders where it misses).
`render_vanilla` is the background loop without a hit list (and passes
NeRF-T's frame time); `render_hybrid_nerf` is the frame of one actor and
adds its acc; `render_hybrid_nerf_multi_persons` is the frame of several,
whose hit list is the union of theirs; `render_smpl_nerf` (the human
alone, posed or in canonical space) takes the hit test and runs its own
branch loop over the gathered hit list, the misses getting the constant
pixel.

The MLPs run through the `nerf_mlp` kernel, the warp's closest-point
query through the `ericson_select` kernel and the hit test through the
`hit_test` kernel, one call an actor over the frame's rows; `use_kernels=
False` runs their plain PyTorch versions instead (the reference the card
checks the kernels against; the plain hit test holds [rays, V] distances,
so it runs chunk by chunk).

The spans of utils/tracing.py mark a frame's hit test (`render.hit_test`,
once a frame), the host's wait for the hit list (`render.hit_sync`, once a
frame: `torch.nonzero` and the lists' bounds), the human
branches (`render.human_branch`, one a branch call) and, in the hybrid
frame, a hit chunk's merge and integration (`render.merge`). The counter
`render.hit_rays` adds the hit rays; in the hybrid frame
`render.branch_rays` adds the rows handed to each branch call, and
`render.actor_rays` (while a profiler records: a device sum) the rows of
them that the actor's own hit test hits: all of them, by the dispatch.

With a data `mesh` (parallel/mesh.py, the JAX renderers' `mesh=`) each
chunk's rays are split over the ranks (`ChunkRows`): every rank runs its
contiguous block of each chunk (and in the hybrid renderers tests its own
rows and branches over their hit lists), and one all_gather at the end of
the frame gives every rank the whole frame. A chunk size that the mesh
size does not divide warns "UNSHARDED", and every rank renders the whole
frame.
"""

import functools
import itertools
import warnings

import torch

from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.utils.constants import DEFAULT_GEO_THRESH
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops import rays as ray_ops
from neuman_tpu_torch.ops import volume
from neuman_tpu_torch.ops.kernels.nerf_mlp import dir_projection, nerf_mlp, nerf_mlp_plain
from neuman_tpu_torch.parallel.mesh import ChunkRows
from neuman_tpu_torch.utils import tracing


def _mlp(use_kernels):
    return nerf_mlp if use_kernels else nerf_mlp_plain


def _near_far(use_kernels):
    return (ray_ops.geometry_guided_near_far if use_kernels
            else ray_ops.geometry_guided_near_far_plain)


def _shard_mesh(mesh, chunk):
    """The mesh a frame's chunks split over: `mesh`, or None (with a
    warning) when its size does not divide the chunk size."""
    if mesh is not None and chunk % mesh.size:
        warnings.warn(
            f"render: chunk size {chunk} is not divisible by the mesh size {mesh.size}; "
            "rendering UNSHARDED on every rank. Pick rays_per_batch as a multiple of the rank "
            "count to parallelize.", stacklevel=3)
        return None
    return mesh


def _dir_term(spec, net, dir_chunk, compute_dtype):
    """The per-ray direction term of a branch's rays. dir_chunk: (the whole
    chunk's directions, the rows of it that the branch runs): the term is
    computed on the whole chunk, as one process computes it, and the rows
    taken, so that a rank of a mesh rounds as one process does (the GEMM
    kernel that cuBLAS picks, and with it the rounding, changes with the
    row count)."""
    whole, rows = dir_chunk
    return dir_projection(spec, net, whole, compute_dtype)[rows]


def _bkg_branch(bkg_spec, coarse_net, fine_net, origins, dirs, bkg_near, bkg_far,
                samples_per_ray, importance_samples_per_ray, white_bkg,
                compute_dtype, use_kernels=True, time_val=None, *, dir_chunk):
    """Background coarse -> importance -> fine. Returns (f_z, f_sigma,
    f_rgb_c, dir_norm): the fine samples' z [R, S+I], raw sigma [R, S+I],
    raw colour 3x[R, S+I], and |d| [R]. time_val: NeRF-T nets, which take
    the samples' (x, y, z, time_val) through the 4-D PE and the plain
    PyTorch net in f32, as the JAX package's `_vanilla_chunk(use_time=True)`
    (the NeRF kernels take one 64-column PE block; the 4-D PE has 84).
    dir_chunk: the rays' chunk, as `_dir_term` takes it."""
    mlp = _mlp(use_kernels)
    dir_norm = torch.linalg.norm(dirs, dim=-1)

    def run(net, z):
        if time_val is not None:
            r, s = z.shape
            pts = origins[:, None, :] + dirs[:, None, :] * z[..., None]
            pts = torch.cat([pts, torch.full((r, s, 1), time_val, device=z.device)], dim=-1)
            out = nerf_module.apply_joiner(bkg_spec, net, pts, dirs[:, None, :].expand(r, s, 3))
            return out[..., 3], [out[..., c] for c in range(3)]
        planes = [origins[:, a, None] + dirs[:, a, None] * z for a in range(3)]
        dirp = _dir_term(bkg_spec, net, dir_chunk, compute_dtype)
        return mlp(bkg_spec, net, *planes, dir_part=dirp, compute_dtype=compute_dtype)

    z = volume.sample_z(bkg_near, bkg_far, samples_per_ray)
    sigma, rgb_c = run(coarse_net, z)
    weights = volume.integrate_planar(sigma, rgb_c, z, dir_norm, white_bkg)[3]
    f_z = volume.importance_z(z, weights, importance_samples_per_ray)
    f_sigma, f_rgb_c = run(fine_net, f_z)
    return f_z, f_sigma, f_rgb_c, dir_norm


def _human_branch(human_spec, human_net, topology, origins, dirs, near, far, posed_verts,
                  Ts, samples_per_ray, knn_k, compute_dtype, knn_stride=1, use_kernels=True,
                  render_can=False, interval_comp=1.0, dir_chunk=None):
    """Samples between the geometry-guided near/far [R] -> warp to canonical
    -> canonical MLP with per-sample directions. Rays with near >= far miss
    the body and get placeholder samples on [0, 1]. render_can: the samples
    are canonical points already (no warp) and the net takes the ray's
    direction (dir_chunk: the rays' chunk, as `_dir_term` takes it). sigma
    is scaled by interval_comp. Returns (z [R, S], sigma [R, S], rgb_c 3x[R, S])."""
    hit = near < far
    z = ray_ops.sample_z_vals(torch.where(hit, near, 0.0), torch.where(hit, far, 1.0),
                              samples_per_ray)
    r, s = z.shape
    planes = [origins[:, a, None] + dirs[:, a, None] * z for a in range(3)]
    if render_can:
        sigma, rgb_c = _mlp(use_kernels)(
            human_spec, human_net, *planes, compute_dtype=compute_dtype,
            dir_part=_dir_term(human_spec, human_net, dir_chunk, compute_dtype))
        return z, sigma * interval_comp, rgb_c
    flat = torch.stack(planes, -1).reshape(-1, 3)
    _, f_id, closest = mesh_ops.point_mesh_closest_planar(
        flat, posed_verts, topology, k=knn_k,
        knn_stride=mesh_ops.stride_for(samples_per_ray, knn_stride),
        use_kernels=use_kernels,
    )
    aff = mesh_ops._blend_inverse_affine(closest, f_id, posed_verts, Ts, topology)
    can = mesh_ops.apply_affine_cols(aff, flat.unbind(1))
    can_planes = [c.reshape(r, s) for c in can]
    diffs = [p[:, 1:] - p[:, :-1] for p in can_planes]
    diffs = [torch.cat([p, p[:, -1:]], dim=1) for p in diffs]
    norm = torch.sqrt(diffs[0] ** 2 + diffs[1] ** 2 + diffs[2] ** 2) + 1e-20
    sigma, rgb_c = _mlp(use_kernels)(
        human_spec, human_net, *can_planes, dir_planes=[p / norm for p in diffs],
        compute_dtype=compute_dtype,
    )
    return z, sigma * interval_comp, rgb_c


def _frame_hit_test(origins, dirs, verts_list, rows, geo_threshold, use_kernels):
    """(this rank's rows of the frame: a slice or an index tensor, and for
    each actor of `verts_list` the geometry-guided (near, far) [rows.local]
    of those rows, in the order of the renderer's buffers), under one
    `render.hit_test` span. The kernel holds no [rays, V] distances: one
    call an actor over the rows at once; the plain version holds them:
    chunk by chunk."""
    mine = (slice(None) if rows.mesh is None
            else torch.cat([src for src, _, _, _ in rows]))
    with tracing.span("render.hit_test"):
        if use_kernels and origins.is_cuda:
            o, d = origins[mine], dirs[mine]
            bounds = [ray_ops.geometry_guided_near_far(o, d, v, geo_threshold)
                      for v in verts_list]
        else:
            bounds = [(torch.empty(rows.local, device=origins.device),
                       torch.empty(rows.local, device=origins.device)) for _ in verts_list]
            for src, dst, _, _ in rows:
                for v, (near, far) in zip(verts_list, bounds):
                    near[dst], far[dst] = _near_far(use_kernels)(origins[src], dirs[src], v,
                                                                 geo_threshold)
    return mine, bounds


def _hit_list(hit_h, rows):
    """The frame's hit lists, for the host's one wait a frame. hit_h: each
    actor's hits [rows.local] (bool). Returns (hits, bounds, own): the rows
    of this rank's buffers that any actor hits, ascending; for each chunk of
    `rows` the bounds (b0, b1) of its rows in that list, a contiguous slice
    since the chunks' rows follow each other; and for each actor the rows it
    hits, ascending (a subsequence of hits). One `nonzero` over the union's
    and the actors' masks gives every list, and one copy the lists' ends."""
    with tracing.span("render.hit_sync"):  # the host waits for the hit test
        masks = torch.stack([functools.reduce(torch.logical_or, hit_h), *hit_h])
        last = torch.tensor([s - 1 for s in itertools.accumulate(k for _, _, k in rows.spans)],
                            device=masks.device)
        # the lists' rows up to each chunk's end, counted over the lists in
        # order by one scan of the flat masks: a scan along the rows of
        # [lists, rows] added ~1.7 ms to a 1280x720 frame's wait on an H100
        ends = masks.view(-1).cumsum(0).view(masks.shape)[:, last]
        found = torch.nonzero(masks)[:, 1].contiguous()
        ends = ends.tolist()
    offsets = [0] + [e[-1] if e else 0 for e in ends]
    hits, *own = [found[a:b] for a, b in zip(offsets, offsets[1:])]
    tracing.count("render.hit_rays", hits.numel())
    return hits, list(zip([0] + ends[0][:-1], ends[0])), own


def _joined(parts):
    """Per-row outputs of consecutive slices of the hit list (tuples of
    tensors and lists of tensors) joined into one over the list."""
    return tuple([torch.cat(c) for c in zip(*col)] if isinstance(col[0], list)
                 else torch.cat(col) for col in zip(*parts))


def _rows(out, at):
    """Rows `at` (a slice) of each tensor of a per-row output."""
    return tuple([c[at] for c in x] if isinstance(x, list) else x[at] for x in out)


def _bkg_frame(bkg_spec, coarse_net, fine_net, cap, origins, dirs, rows, hit_list,
               samples_per_ray, importance_samples_per_ray, white_bkg, compute_dtype,
               use_kernels, time_val=None):
    """The background on every ray of this rank's rows, chunk by chunk
    (near and far from `cap`'s "bkg" entries): (rgb [rows.local, 3], depth
    [rows.local] of the background alone, and the hit rays' background
    samples (f_z, f_sigma, f_rgb_c, dir_norm, as `_bkg_branch` gives them)
    in the order of the hit list; None without hits). hit_list: (hits,
    bounds) as `_hit_list` gives them, or None to keep no samples.
    time_val: NeRF-T nets, as `_bkg_branch` takes it."""
    hits, bounds = (None, itertools.repeat((0, 0))) if hit_list is None else hit_list
    device = origins.device
    rgb = torch.empty(rows.local, 3, device=device)
    depth = torch.empty(rows.local, device=device)
    kept = []
    for (src, dst, whole, local), (b0, b1) in zip(rows, bounds):
        o, d = origins[src], dirs[src]
        n = o.shape[0]
        bkg_near = torch.full((n, 1), float(cap.near["bkg"]), device=device)
        bkg_far = torch.full((n, 1), float(cap.far["bkg"]), device=device)
        f_z, f_sigma, f_rgb_c, dir_norm = _bkg_branch(
            bkg_spec, coarse_net, fine_net, o, d, bkg_near, bkg_far, samples_per_ray,
            importance_samples_per_ray, white_bkg, compute_dtype, use_kernels, time_val,
            dir_chunk=(dirs[whole], local))
        rgb[dst], _, _, _, depth[dst] = volume.integrate_planar(
            f_sigma, f_rgb_c, f_z, dir_norm, white_bkg)
        if b1 > b0:
            sel = hits[b0:b1] - dst.start
            kept.append((f_z[sel], f_sigma[sel], [c[sel] for c in f_rgb_c], dir_norm[sel]))
    return rgb, depth, (_joined(kept) if kept else None)


def _own_rows(branch, own, hits, blank, rays_per_batch):
    """An actor's branch over the rows it hits, `own` (ascending, a
    subsequence of the union's `hits`), in calls of `rays_per_batch` of
    them: (planes [len(own) + 1, 5, S], each row's z, sigma and three raw
    colour planes in f32, the last row `blank`, the placeholder; slot
    [len(hits)], each union row's row of planes, the last where the actor
    misses). branch(rows) runs the actor's branch on rows of the buffers."""
    n = own.numel()
    planes = torch.empty(n + 1, *blank.shape, device=blank.device)
    planes[n] = blank
    for first in range(0, n, rays_per_batch):
        at = slice(first, min(first + rays_per_batch, n))
        z, sigma, rgb_c = branch(own[at])
        torch.stack([z, sigma, *rgb_c], 1, out=planes[at])
    slot = torch.full_like(hits, n)
    slot[torch.searchsorted(hits, own)] = torch.arange(n, device=hits.device)
    return planes, slot


def _actor(spec, model, posed_verts, faces, Ts, topology, device):
    """One actor of a frame: (its human spec, canonical net,
    topology (`topology`, or built from `faces`), vertices [V, 3] and
    transforms [V, 4, 4] in f32 on `device`)."""
    verts = torch.as_tensor(posed_verts, dtype=torch.float32, device=device)
    if topology is None:
        topology = mesh_ops.MeshTopology.build(faces, len(verts), device)
    Ts = torch.as_tensor(Ts, dtype=torch.float32, device=device)[: len(verts)]
    return spec.human, model.coarse_human_net.nerf, topology, verts, Ts


def _hybrid_frame(bkg_spec, bkg_model, cap, actors, device, rays_per_batch, samples_per_ray,
                  importance_samples_per_ray, white_bkg, geo_threshold, knn_k, knn_stride,
                  compute_dtype, use_kernels, mesh, *, with_acc=False):
    """The hybrid frame of `actors` (`_actor`s) in the scene of `bkg_model`'s
    background nets; the other arguments as `render_hybrid_nerf`'s.

    The merge takes, on every row of the union of the actors' hits, one
    block of samples an actor. An actor whose hits are the union (always
    with one actor) runs its branch on the union's chunks inside that loop.
    Another runs it first on its own hits only, in calls of
    `rays_per_batch` of them, and keeps the outputs compact (`_own_rows`);
    its block is then gathered from them, a placeholder on the rows it
    misses: z = linspace(1, 2) x 1e8, sigma -1e9 and raw colour 0.
    relu(sigma) = 0 gives the placeholders alpha 0 and weight 0, and behind
    every real sample they leave the real samples' transmittance as it is.
    They do shorten the last real sample's interval from 1e10 to ~1e8 (the
    distance to the first placeholder); its alpha, 1 -
    exp(-relu(sigma) |d| interval), rounds to 1 in f32 at both lengths
    once relu(sigma) |d| x 1e8 passes ~17, and is 0 at both for a zero
    density, so the RGB is that of the real samples alone unless the last
    real sample's density lies between 0 and ~2e-7.

    Returns (rgb [H, W, 3], depth [H, W]) on `device`, and with `with_acc`
    (one actor) its acc [H, W]: its samples integrated alone."""
    origins, dirs = cap_rays(cap, device)
    rows = ChunkRows(origins.shape[0], rays_per_batch, _shard_mesh(mesh, rays_per_batch),
                     device)
    mine, bounds_h = _frame_hit_test(origins, dirs, [a[3] for a in actors], rows,
                                     geo_threshold, use_kernels)
    hit_h = [near < far for near, far in bounds_h]
    hits, bounds, own = _hit_list(hit_h, rows)
    rgb, depth, kept = _bkg_frame(
        bkg_spec.bkg, bkg_model.coarse_bkg_net.nerf, bkg_model.fine_bkg_net.nerf, cap, origins,
        dirs, rows, (hits, bounds), samples_per_ray, importance_samples_per_ray, white_bkg,
        compute_dtype, use_kernels)
    acc = torch.zeros(rows.local, device=device) if with_acc else None
    o_mine, d_mine = origins[mine], dirs[mine]

    def branch(k, sel):
        spec_h, net_h, topo_h, verts_h, ts_h = actors[k]
        near, far = bounds_h[k]
        with tracing.span("render.human_branch"):
            out = _human_branch(spec_h, net_h, topo_h, o_mine[sel], d_mine[sel], near[sel],
                                far[sel], verts_h, ts_h, samples_per_ray, knn_k, compute_dtype,
                                knn_stride, use_kernels)
        tracing.count("render.branch_rays", sel.numel())
        if tracing.enabled():  # the sum is a launch: only while a profiler records
            tracing.count("render.actor_rays", hit_h[k][sel].sum())
        return out

    compact = [None] * len(actors)
    if any(own_k.numel() < hits.numel() for own_k in own):
        dummy_z = torch.linspace(1.0, 2.0, samples_per_ray, device=device)[None] * 1e8
        blank = torch.cat([dummy_z, torch.full_like(dummy_z, -1e9),
                           torch.zeros(3, samples_per_ray, device=device)])
        compact = [None if own_k.numel() == hits.numel() else
                   _own_rows(functools.partial(branch, k), own_k, hits, blank, rays_per_batch)
                   for k, own_k in enumerate(own)]
    for first in range(0, hits.numel(), rays_per_batch):  # the merges
        at = slice(first, first + rays_per_batch)
        sel = hits[at]
        f_z, f_sigma, f_rgb_c, dir_norm = _rows(kept, at)
        outs = [branch(k, sel) if c is None else None for k, c in enumerate(compact)]
        with tracing.span("render.merge"):
            zs, sigmas, rgbs = [f_z], [f_sigma], [f_rgb_c]
            for out, c in zip(outs, compact):
                if c is None:
                    h_z, h_sigma, h_rgb_c = out
                else:  # the actor's block, gathered from its compact outputs
                    planes, slot = c
                    h_z, h_sigma, *h_rgb_c = planes[slot[at]].unbind(1)
                zs.append(h_z)
                sigmas.append(h_sigma)
                rgbs.append(h_rgb_c)
            z, sigma, rgb_c = volume.sort_merge_planar(zs, sigmas, rgbs)
            rgb[sel], _, _, _, depth[sel] = volume.integrate_planar(
                sigma, rgb_c, z, dir_norm, white_bkg)
            if with_acc:  # one actor, whose hits are the union's
                acc[sel] = volume.integrate_planar(h_sigma, h_rgb_c, h_z, dir_norm, white_bkg)[2]
    out = (rgb, depth, acc) if with_acc else (rgb, depth)
    h, w = cap.shape
    return tuple(x.reshape(h, w, *x.shape[1:]) for x in rows.gather(*out))


def cap_rays(cap, device):
    """(origins, dirs) [H*W, 3] of every pixel of a capture (duck-typed:
    .shape, .intrinsic_matrix, .cam_pose.camera_to_world)."""
    h, w = cap.shape
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return ray_ops.pixels_to_rays(
        ray_ops.image_coords(h, w, device), f32(cap.intrinsic_matrix),
        f32(cap.cam_pose.camera_to_world),
    )


@torch.no_grad()
def render_vanilla(spec, coarse_net, cap, fine_net, device, rays_per_batch=32768,
                   samples_per_ray=64, importance_samples_per_ray=128, white_bkg=True,
                   compute_dtype=torch.bfloat16, use_kernels=True, ablate_nerft=False,
                   mesh=None):
    """Background-only frame: coarse -> importance -> fine over every pixel
    of `cap` (as render_hybrid_nerf reads it, near/far from the "bkg"
    entries), chunk by chunk. spec: the nets' JoinerSpec; coarse_net,
    fine_net: NeRF modules on `device`. ablate_nerft: NeRF-T nets, which
    take the frame's time frame_id / total_frames of `cap.frame_id` as a
    fourth input (plain PyTorch in f32, as in the JAX package). mesh: a
    DataMesh over which each chunk's rays are split (every rank calls).
    Returns rgb [H, W, 3] on `device`."""
    origins, dirs = cap_rays(cap, device)
    rows = ChunkRows(origins.shape[0], rays_per_batch, _shard_mesh(mesh, rays_per_batch),
                     device)
    time_val = cap.frame_id["frame_id"] / cap.frame_id["total_frames"] if ablate_nerft else None
    rgb, _, _ = _bkg_frame(spec, coarse_net, fine_net, cap, origins, dirs, rows, None,
                           samples_per_ray, importance_samples_per_ray, white_bkg,
                           compute_dtype, use_kernels, time_val)
    (rgb,) = rows.gather(rgb)
    h, w = cap.shape
    return rgb.reshape(h, w, 3)


@torch.no_grad()
def render_hybrid_nerf(spec, model, cap, posed_verts, faces, Ts, device,
                       rays_per_batch=32768, samples_per_ray=64,
                       importance_samples_per_ray=128, white_bkg=True,
                       geo_threshold=DEFAULT_GEO_THRESH, knn_k=4, knn_stride=1,
                       compute_dtype=torch.bfloat16, use_kernels=True,
                       topology=None, mesh=None):
    """Hybrid human + scene frame: the frame path of one actor
    (`_hybrid_frame`). The MLPs run in `compute_dtype` (bf16 storage and
    products with f32 accumulation by default, as the JAX renderer's
    default; float32 for exact f32).

    spec: HumanNeRFSpec; model: HumanNeRF on `device`; cap: a capture with
    .shape (H, W), .intrinsic_matrix, .cam_pose.camera_to_world and the
    .near / .far dicts (key "bkg"); posed_verts [V, 3], faces [F, 3+],
    Ts [V(+J), 4, 4] (arrays or tensors). `topology` may pass a prebuilt
    MeshTopology of `faces` to skip rebuilding it. mesh: a DataMesh over
    which each chunk's rays are split (every rank calls; each tests its
    own rows and branches over their hit list).
    Returns (rgb [H, W, 3], depth [H, W], acc [H, W]) on `device`.
    """
    actor = _actor(spec, model, posed_verts, faces, Ts, topology, device)
    return _hybrid_frame(spec, model, cap, [actor], device, rays_per_batch, samples_per_ray,
                         importance_samples_per_ray, white_bkg, geo_threshold, knn_k,
                         knn_stride, compute_dtype, use_kernels, mesh, with_acc=True)


@torch.no_grad()
def render_smpl_nerf(spec, model, cap, posed_verts, faces, Ts, device, rays_per_batch=32768,
                     samples_per_ray=64, white_bkg=True, render_can=False,
                     geo_threshold=DEFAULT_GEO_THRESH, interval_comp=1.0, knn_k=4,
                     knn_stride=1, compute_dtype=torch.bfloat16, use_kernels=True,
                     topology=None, mesh=None):
    """Human-only frame, compact dispatch: only the rays that pass within
    geo_threshold of a vertex run the human branch; the others get the white
    or black pixel, depth 0 and acc 0. render_can: `posed_verts` are the
    canonical vertices and the samples canonical points (no warp; Ts
    unused). Ts None: identity transforms. mesh: each chunk of the frame's
    rays is split over the ranks for the hit test, and each chunk of the
    hit list for the human branch. Arguments otherwise as
    `render_hybrid_nerf`. Returns (rgb [H, W, 3], depth
    [H, W], acc [H, W]) on `device`."""
    if Ts is None:
        Ts = torch.eye(4, device=device).repeat(len(posed_verts), 1, 1)
    human_spec, net, topology, verts, Ts = _actor(spec, model, posed_verts, faces, Ts, topology,
                                                  device)
    origins, dirs = cap_rays(cap, device)
    total = origins.shape[0]
    rgb = torch.full((total, 3), 1.0 if white_bkg else 0.0, device=device)
    depth = torch.zeros(total, device=device)
    acc = torch.zeros(total, device=device)
    mesh = _shard_mesh(mesh, rays_per_batch)
    rows = ChunkRows(total, rays_per_batch, mesh, device)
    _, ((near, far),) = _frame_hit_test(origins, dirs, [verts], rows, geo_threshold,
                                        use_kernels)
    near, far = rows.gather(near, far)
    with tracing.span("render.hit_sync"):  # the host waits for the hit test
        hits = torch.nonzero(near < far).squeeze(1)
        hit_rays = hits.numel()
    tracing.count("render.hit_rays", hit_rays)
    rows = ChunkRows(hit_rays, rays_per_batch, mesh, device)
    h_rgb = torch.empty(rows.local, 3, device=device)
    h_depth = torch.empty(rows.local, device=device)
    h_acc = torch.empty(rows.local, device=device)
    for src, dst, whole, local in rows:
        sel = hits[src]
        o, d = origins[sel], dirs[sel]
        with tracing.span("render.human_branch"):
            z, sigma, rgb_c = _human_branch(
                human_spec, net, topology, o, d, near[sel], far[sel], verts, Ts, samples_per_ray,
                knn_k, compute_dtype, knn_stride, use_kernels, render_can, interval_comp,
                (dirs[hits[whole]], local))
        h_rgb[dst], _, h_acc[dst], _, h_depth[dst] = volume.integrate_planar(
            sigma, rgb_c, z, torch.linalg.norm(d, dim=-1), white_bkg)
    rgb[hits], depth[hits], acc[hits] = rows.gather(h_rgb, h_depth, h_acc)
    h, w = cap.shape
    return rgb.reshape(h, w, 3), depth.reshape(h, w), acc.reshape(h, w)


@torch.no_grad()
def render_hybrid_nerf_multi_persons(bkg_spec, bkg_model, cap, human_specs, human_models,
                                     posed_verts_list, faces_list, Ts_list, device,
                                     rays_per_batch=32768, samples_per_ray=64,
                                     importance_samples_per_ray=128, white_bkg=True,
                                     geo_threshold=DEFAULT_GEO_THRESH, knn_k=4, knn_stride=1,
                                     compute_dtype=torch.bfloat16, use_kernels=True,
                                     topologies=None, mesh=None):
    """Several actors composited into one scene: the frame path
    (`_hybrid_frame`) of one actor a HumanNeRF of `human_models` (its
    canonical net) with its spec, vertices, faces and transforms; the
    background from the nets of `bkg_model`. topologies: one prebuilt
    MeshTopology per actor, of its faces (as `render_hybrid_nerf`'s
    `topology=`); None builds them from `faces_list`. mesh: as
    `render_hybrid_nerf`. Returns (rgb [H, W, 3], depth [H, W]) on
    `device`."""
    if topologies is None:
        topologies = [None] * len(posed_verts_list)
    actors = [_actor(*a, device) for a in zip(human_specs, human_models, posed_verts_list,
                                              faces_list, Ts_list, topologies)]
    return _hybrid_frame(bkg_spec, bkg_model, cap, actors, device, rays_per_batch,
                         samples_per_ray, importance_samples_per_ray, white_bkg, geo_threshold,
                         knn_k, knn_stride, compute_dtype, use_kernels, mesh)
