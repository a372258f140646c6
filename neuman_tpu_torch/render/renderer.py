"""Renderers (counterpart of the planar paths of neuman_tpu/render/renderer.py:
`_bkg_branch_planar`, `_human_branch_planar`, `_hybrid_chunk_planar`,
`render_hybrid_nerf`, `render_smpl_nerf`, `render_hybrid_nerf_multi_persons`,
and `render_vanilla`, the background-only render the background trainer
validates with).

`render_hybrid_nerf` renders a frame by the compact dispatch: every ray
goes through the background path, chunk by chunk; the rays of a chunk that
pass within geo_threshold of a body vertex (the hit mask) are selected by
boolean indexing, run the human branch (warp + canonical net), merge its
samples with their background samples by z, and are scattered back.
`render_smpl_nerf` (the human alone, posed or in canonical space) and
`render_hybrid_nerf_multi_persons` (several actors in one scene) dispatch
the same way: misses get the constant or background pixel, and the human
branches run on the hit rays only (for several actors, the union of theirs).

Per chunk the MLPs run through the `nerf_mlp` kernel and the warp's
closest-point query through the `ericson_select` kernel; `use_kernels=False`
runs their plain PyTorch versions instead (the reference the card checks
the kernels against).

The spans of utils/tracing.py mark a frame's hit tests (`render.hit_test`),
the host's wait for each hit list (`render.hit_sync`: `torch.nonzero`
syncs) and the human branches (`render.human_branch`); the counter
`render.hit_rays` adds the hit rays, which the host holds by then.

With a data `mesh` (parallel/mesh.py, the JAX renderers' `mesh=`) each
chunk's rays are split over the ranks (`ChunkRows`): every rank runs its
contiguous block of each chunk, and one all_gather at the end of the frame
gives every rank the whole frame. A chunk size that the mesh size does not
divide warns "UNSHARDED", and every rank renders the whole frame.
"""

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


def _merge_human(bkg, hit, h_z, h_sigma, h_rgb_c, bkg_far, white_bkg):
    """Background samples `bkg` (from _bkg_branch) and human samples merged
    along each ray: (rgb [R, 3], depth [R], acc [R]); rays that miss the
    body (hit False) get the background pixel and acc 0."""
    f_z, f_sigma, f_rgb_c, dir_norm = bkg
    # misses: dummy samples beyond the far plane with zero density
    t = torch.linspace(1.0, 2.0, h_z.shape[1], device=h_z.device)
    h_z = torch.where(hit[:, None], h_z, t[None] * bkg_far.reshape(-1, 1) * 2.0)
    h_sigma = torch.where(hit[:, None], h_sigma, -1e9)
    z, sigma, rgb_c = volume.sort_merge_planar([f_z, h_z], [f_sigma, h_sigma], [f_rgb_c, h_rgb_c])
    merged_rgb, _, _, _, merged_depth = volume.integrate_planar(sigma, rgb_c, z, dir_norm, white_bkg)
    bkg_rgb, _, _, _, bkg_depth = volume.integrate_planar(f_sigma, f_rgb_c, f_z, dir_norm, white_bkg)
    h_acc = volume.integrate_planar(h_sigma, h_rgb_c, h_z, dir_norm, white_bkg)[2]
    rgb = torch.where(hit[:, None], merged_rgb, bkg_rgb)
    depth = torch.where(hit, merged_depth, bkg_depth)
    return rgb, depth, torch.where(hit, h_acc, 0.0)


def _hybrid_chunk(spec, model, topology, origins, dirs, bkg_near, bkg_far, posed_verts,
                  Ts, geo_threshold, samples_per_ray, importance_samples_per_ray,
                  white_bkg, knn_k, compute_dtype, knn_stride=1, use_kernels=True):
    """Background and human samples merged along each ray of a chunk:
    (rgb [R, 3], depth [R], acc [R])."""
    bkg = _bkg_branch(
        spec.bkg, model.coarse_bkg_net.nerf, model.fine_bkg_net.nerf, origins, dirs,
        bkg_near, bkg_far, samples_per_ray, importance_samples_per_ray, white_bkg,
        compute_dtype, use_kernels, dir_chunk=(dirs, slice(None)),
    )
    near, far = ray_ops.geometry_guided_near_far(origins, dirs, posed_verts, geo_threshold)
    human = _human_branch(
        spec.human, model.coarse_human_net.nerf, topology, origins, dirs, near, far,
        posed_verts, Ts, samples_per_ray, knn_k, compute_dtype, knn_stride, use_kernels,
    )
    return _merge_human(bkg, near < far, *human, bkg_far, white_bkg)


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
    rgb = torch.empty(rows.local, 3, device=device)
    time_val = cap.frame_id["frame_id"] / cap.frame_id["total_frames"] if ablate_nerft else None
    for src, dst, whole, local in rows:
        o, d = origins[src], dirs[src]
        n = o.shape[0]
        near = torch.full((n, 1), float(cap.near["bkg"]), device=device)
        far = torch.full((n, 1), float(cap.far["bkg"]), device=device)
        f_z, f_sigma, f_rgb_c, dir_norm = _bkg_branch(
            spec, coarse_net, fine_net, o, d, near, far, samples_per_ray,
            importance_samples_per_ray, white_bkg, compute_dtype, use_kernels, time_val,
            dir_chunk=(dirs[whole], local))
        rgb[dst] = volume.integrate_planar(f_sigma, f_rgb_c, f_z, dir_norm, white_bkg)[0]
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
    """Hybrid human + scene frame, compact dispatch. The MLPs run in
    `compute_dtype` (bf16 storage and products with f32 accumulation by
    default, as the JAX renderer's default; float32 for exact f32).

    spec: HumanNeRFSpec; model: HumanNeRF on `device`; cap: a capture with
    .shape (H, W), .intrinsic_matrix, .cam_pose.camera_to_world and the
    .near / .far dicts (key "bkg"); posed_verts [V, 3], faces [F, 3+],
    Ts [V(+J), 4, 4] (arrays or tensors). `topology` may pass a prebuilt
    MeshTopology of `faces` to skip rebuilding it. mesh: a DataMesh over
    which each chunk's rays are split (every rank calls; each picks the
    hit rays of its own rows).
    Returns (rgb [H, W, 3], depth [H, W], acc [H, W]) on `device`.
    """
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    if topology is None:
        topology = mesh_ops.MeshTopology.build(faces, len(posed_verts), device)
    verts, Ts = f32(posed_verts), f32(Ts)[: len(posed_verts)]
    origins, dirs = cap_rays(cap, device)
    rows = ChunkRows(origins.shape[0], rays_per_batch, _shard_mesh(mesh, rays_per_batch),
                     device)
    rgb = torch.empty(rows.local, 3, device=device)
    depth = torch.empty(rows.local, device=device)
    acc = torch.zeros(rows.local, device=device)
    for src, dst, whole, local in rows:
        o, d = origins[src], dirs[src]
        n, i = o.shape[0], dst.start
        bkg_near = torch.full((n, 1), float(cap.near["bkg"]), device=device)
        bkg_far = torch.full((n, 1), float(cap.far["bkg"]), device=device)
        f_z, f_sigma, f_rgb_c, dir_norm = _bkg_branch(
            spec.bkg, model.coarse_bkg_net.nerf, model.fine_bkg_net.nerf, o, d, bkg_near,
            bkg_far, samples_per_ray, importance_samples_per_ray, white_bkg, compute_dtype,
            use_kernels, dir_chunk=(dirs[whole], local),
        )
        rgb[dst], _, _, _, depth[dst] = volume.integrate_planar(
            f_sigma, f_rgb_c, f_z, dir_norm, white_bkg)
        # the human branch runs only on the chunk's rays that pass near the body
        with tracing.span("render.hit_test"):
            near, far = ray_ops.geometry_guided_near_far(o, d, verts, geo_threshold)
        with tracing.span("render.hit_sync"):  # the host waits for the hit test
            sel = torch.nonzero(near < far).squeeze(1)
            hit_rays = sel.numel()
        tracing.count("render.hit_rays", hit_rays)
        if hit_rays:
            with tracing.span("render.human_branch"):
                human = _human_branch(
                    spec.human, model.coarse_human_net.nerf, topology, o[sel], d[sel], near[sel],
                    far[sel], verts, Ts, samples_per_ray, knn_k, compute_dtype, knn_stride,
                    use_kernels,
                )
            hit_bkg = (f_z[sel], f_sigma[sel], [c[sel] for c in f_rgb_c], dir_norm[sel])
            hit = torch.ones_like(sel, dtype=torch.bool)
            rgb[i + sel], depth[i + sel], acc[i + sel] = _merge_human(
                hit_bkg, hit, *human, bkg_far[sel], white_bkg)
    rgb, depth, acc = rows.gather(rgb, depth, acc)
    h, w = cap.shape
    return rgb.reshape(h, w, 3), depth.reshape(h, w), acc.reshape(h, w)


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
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    verts = f32(posed_verts)
    if topology is None:
        topology = mesh_ops.MeshTopology.build(faces, len(verts), device)
    Ts = (torch.eye(4, device=device).repeat(len(verts), 1, 1) if Ts is None
          else f32(Ts)[: len(verts)])
    origins, dirs = cap_rays(cap, device)
    total = origins.shape[0]
    rgb = torch.full((total, 3), 1.0 if white_bkg else 0.0, device=device)
    depth = torch.zeros(total, device=device)
    acc = torch.zeros(total, device=device)
    mesh = _shard_mesh(mesh, rays_per_batch)
    # the hit test holds [rays, V] distances: chunk by chunk, like the branch
    rows = ChunkRows(total, rays_per_batch, mesh, device)
    near = torch.empty(rows.local, device=device)
    far = torch.empty(rows.local, device=device)
    with tracing.span("render.hit_test"):  # one span over the loop: nothing else runs in it
        for src, dst, _, _ in rows:
            near[dst], far[dst] = ray_ops.geometry_guided_near_far(origins[src], dirs[src], verts,
                                                                   geo_threshold)
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
                spec.human, model.coarse_human_net.nerf, topology, o, d, near[sel], far[sel],
                verts, Ts, samples_per_ray, knn_k, compute_dtype, knn_stride, use_kernels,
                render_can, interval_comp, (dirs[hits[whole]], local))
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
                                     compute_dtype=torch.bfloat16, use_kernels=True, mesh=None):
    """Several actors composited into one scene, compact dispatch: the
    background (the nets of `bkg_model`) on every ray, chunk by chunk; on the
    rays within geo_threshold of any actor, every actor's human branch (the
    canonical net of its HumanNeRF in `human_models`, its vertices, faces
    and transforms), and one merge by z over the background and all actors.
    An actor that a ray misses contributes samples at z = linspace(1, 2) x
    1e8 with sigma -1e9: far behind every real sample, so the last real
    sample keeps its own interval. mesh: as `render_hybrid_nerf`. Returns
    (rgb [H, W, 3], depth [H, W]) on `device`."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    actors = []
    for spec_h, model_h, verts_h, faces_h, ts_h in zip(human_specs, human_models,
                                                       posed_verts_list, faces_list, Ts_list):
        verts_h = f32(verts_h)
        actors.append((spec_h.human, model_h.coarse_human_net.nerf,
                       mesh_ops.MeshTopology.build(faces_h, len(verts_h), device), verts_h,
                       f32(ts_h)[: len(verts_h)]))
    origins, dirs = cap_rays(cap, device)
    rows = ChunkRows(origins.shape[0], rays_per_batch, _shard_mesh(mesh, rays_per_batch),
                     device)
    rgb = torch.empty(rows.local, 3, device=device)
    depth = torch.empty(rows.local, device=device)
    dummy_z = torch.linspace(1.0, 2.0, samples_per_ray, device=device)[None] * 1e8
    for src, dst, whole, local in rows:
        o, d = origins[src], dirs[src]
        n, i = o.shape[0], dst.start
        bkg_near = torch.full((n, 1), float(cap.near["bkg"]), device=device)
        bkg_far = torch.full((n, 1), float(cap.far["bkg"]), device=device)
        f_z, f_sigma, f_rgb_c, dir_norm = _bkg_branch(
            bkg_spec.bkg, bkg_model.coarse_bkg_net.nerf, bkg_model.fine_bkg_net.nerf, o, d,
            bkg_near, bkg_far, samples_per_ray, importance_samples_per_ray, white_bkg,
            compute_dtype, use_kernels, dir_chunk=(dirs[whole], local))
        rgb[dst], _, _, _, depth[dst] = volume.integrate_planar(
            f_sigma, f_rgb_c, f_z, dir_norm, white_bkg)
        with tracing.span("render.hit_test"):
            bounds = [ray_ops.geometry_guided_near_far(o, d, a[3], geo_threshold)
                      for a in actors]
        any_hit = torch.zeros(n, dtype=torch.bool, device=device)
        for near, far in bounds:
            any_hit |= near < far
        with tracing.span("render.hit_sync"):  # the host waits for the hit test
            sel = torch.nonzero(any_hit).squeeze(1)
            hit_rays = sel.numel()
        tracing.count("render.hit_rays", hit_rays)
        if not hit_rays:
            continue
        zs, sigmas, rgbs = [f_z[sel]], [f_sigma[sel]], [[c[sel] for c in f_rgb_c]]
        for (spec_h, net_h, topo_h, verts_h, ts_h), (near, far) in zip(actors, bounds):
            with tracing.span("render.human_branch"):
                h_z, h_sigma, h_rgb_c = _human_branch(
                    spec_h, net_h, topo_h, o[sel], d[sel], near[sel], far[sel], verts_h, ts_h,
                    samples_per_ray, knn_k, compute_dtype, knn_stride, use_kernels)
            hit = (near < far)[sel, None]
            zs.append(torch.where(hit, h_z, dummy_z))
            sigmas.append(torch.where(hit, h_sigma, -1e9))
            rgbs.append(h_rgb_c)
        z, sigma, rgb_c = volume.sort_merge_planar(zs, sigmas, rgbs)
        rgb[i + sel], _, _, _, depth[i + sel] = volume.integrate_planar(
            sigma, rgb_c, z, dir_norm[sel], white_bkg)
    rgb, depth = rows.gather(rgb, depth)
    h, w = cap.shape
    return rgb.reshape(h, w, 3), depth.reshape(h, w)
