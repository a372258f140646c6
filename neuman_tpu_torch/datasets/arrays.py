"""A scene staged on the device for device-side ray sampling (counterpart of
neuman_tpu/datasets/arrays.py).

Every pixel of the staged views lives in tensors on one device, and the
pixel classes are one per-view permutation of flat pixel ids sorted by
class [body | border | strict background] plus the class counts, so
"uniform over class-c pixels of view v" is one gather:
perm[v, offset_c(v) + floor(u * count_c(v))].
"""

from dataclasses import dataclass, fields

import numpy as np
import torch


@dataclass
class RaySceneArrays:
    images: torch.Tensor  # [N, H, W, 3] uint8
    masks: torch.Tensor  # [N, H, W] uint8 (human > 0)
    depths: torch.Tensor  # [N, H, W] f32 (MVS), or [N, 1, 1] when not staged
    fused_depths: torch.Tensor  # [N, H, W] f32, or [N, 1, 1]
    intrinsics: torch.Tensor  # [N, 3, 3] f32
    c2w: torch.Tensor  # [N, 4, 4] f32
    near_bkg: torch.Tensor  # [N]
    far_bkg: torch.Tensor  # [N]
    near_human: torch.Tensor  # [N]
    far_human: torch.Tensor  # [N]
    viewf: torch.Tensor  # [N] frame_id / total_frames
    perm: torch.Tensor  # [N, H*W] int64, class-sorted flat pixel ids
    body_count: torch.Tensor  # [N] int64
    border_count: torch.Tensor  # [N] int64
    verts: torch.Tensor  # [N, V, 3] posed SMPL verts in scene space

    @property
    def num_views(self):
        return self.images.shape[0]

    @property
    def hw(self):
        return self.images.shape[1], self.images.shape[2]


def class_perm(mask, border):
    """Class-sorted flat pixel permutation of one view and its (body, border)
    counts: the numpy branch of neuman_tpu.native_bridge.build_class_perm."""
    body = np.asarray(mask).reshape(-1) != 0
    bord = (np.asarray(border).reshape(-1) == 1) & ~body
    cls = np.where(body, 0, np.where(bord, 1, 2)).astype(np.int8)
    return np.argsort(cls, kind="stable"), int(body.sum()), int(bord.sum())


def _to_device(device, **arrays):
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype == np.uint8:
            out[name] = as_t(a, torch.uint8)
        elif np.issubdtype(a.dtype, np.integer):
            out[name] = as_t(a, torch.int64)
        else:
            out[name] = as_t(a, torch.float32)
    return RaySceneArrays(**out)


def build_scene_arrays(scene, view_indices=None, use_fused_depth=None, device="cuda"):
    """Stage (a subset of) a scene on `device`.

    `scene` is duck-typed as neuman_tpu's Scene: .captures (each with
    .image [H, W, 3+], .mask, .depth_map / .fused_depth_map, .border_mask,
    .intrinsic_matrix, .cam_pose.camera_to_world, .near / .far dicts and
    .frame_id {frame_id, total_frames}) and .verts [N][V, 3]. As in the JAX
    package, use_fused_depth True / False stages only the depth source the
    sampler reads ([N, 1, 1] placeholders for the other); None keeps both.
    """
    if view_indices is None:
        view_indices = list(range(len(scene.captures)))
    caps = [scene.captures[i] for i in view_indices]
    placeholder = np.zeros((1, 1), np.float32)
    cols = {k: [] for k in ("images", "masks", "depths", "fused_depths", "intrinsics", "c2w",
                            "near_bkg", "far_bkg", "near_human", "far_human", "viewf", "perm",
                            "body_count", "border_count", "verts")}
    for i, cap in zip(view_indices, caps):
        mask = np.asarray(cap.mask)
        cols["images"].append(np.asarray(cap.image[..., :3], dtype=np.uint8))
        cols["masks"].append(mask.astype(np.uint8))
        cols["depths"].append(np.asarray(cap.depth_map, np.float32)
                              if use_fused_depth is not True else placeholder)
        cols["fused_depths"].append(np.asarray(cap.fused_depth_map, np.float32)
                                    if use_fused_depth is not False else placeholder)
        cols["intrinsics"].append(np.asarray(cap.intrinsic_matrix, np.float32))
        cols["c2w"].append(np.asarray(cap.cam_pose.camera_to_world, np.float32))
        cols["near_bkg"].append(cap.near["bkg"])
        cols["far_bkg"].append(cap.far["bkg"])
        cols["near_human"].append(cap.near.get("human", 0.0))
        cols["far_human"].append(cap.far.get("human", 1.0))
        cols["viewf"].append(cap.frame_id["frame_id"] / cap.frame_id["total_frames"])
        border = getattr(cap, "border_mask", np.zeros_like(mask))
        perm, n_body, n_border = class_perm(mask, border)
        cols["perm"].append(perm)
        cols["body_count"].append(n_body)
        cols["border_count"].append(n_border)
        cols["verts"].append(np.asarray(scene.verts[i], np.float32))
    stacked = {k: np.stack(v) if k not in ("near_bkg", "far_bkg", "near_human", "far_human",
                                           "viewf") else np.array(v, np.float32)
               for k, v in cols.items()}
    return _to_device(device, **stacked)


def synthetic_arrays(num_views=4, h=36, w=48, num_verts=64, seed=0, device="cuda"):
    """Random staged scene, the counterpart of
    neuman_tpu.parallel.dryrun.synthetic_arrays: the same numpy draws from
    `seed`, so both packages hold the same values."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((num_views, h, w), np.uint8)
    masks[:, h // 3: 2 * h // 3, w // 3: 2 * w // 3] = 1
    perms, body_counts = [], []
    for v in range(num_views):
        perm, n_body, _ = class_perm(masks[v], np.zeros_like(masks[v]))
        perms.append(perm)
        body_counts.append(n_body)
    intr = np.tile(np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]], np.float32)[None],
                   (num_views, 1, 1))
    c2w = np.tile(np.eye(4, dtype=np.float32)[None], (num_views, 1, 1))
    c2w[:, 2, 3] = -2.5
    verts = rng.normal(size=(num_views, num_verts, 3)).astype(np.float32) * 0.3
    images = rng.integers(0, 255, size=(num_views, h, w, 3), dtype=np.uint8)
    depths = rng.uniform(1, 3, (num_views, h, w)).astype(np.float32)
    fused = rng.uniform(1, 3, (num_views, h, w)).astype(np.float32)
    return _to_device(
        device, images=images, masks=masks, depths=depths, fused_depths=fused,
        intrinsics=intr, c2w=c2w, near_bkg=np.full(num_views, 0.5, np.float32),
        far_bkg=np.full(num_views, 4.0, np.float32),
        near_human=np.full(num_views, 1.5, np.float32),
        far_human=np.full(num_views, 3.5, np.float32),
        viewf=np.linspace(0, 1, num_views).astype(np.float32), perm=np.stack(perms),
        body_count=np.array(body_counts), border_count=np.zeros(num_views, np.int64),
        verts=verts,
    )


class _Pose:
    def __init__(self, c2w):
        self.camera_to_world = c2w

    @property
    def world_to_camera(self):
        return np.linalg.inv(self.camera_to_world)


class _Capture:
    """One view of an ArraysScene: the capture attributes that
    build_scene_arrays and the renderers read."""

    def __init__(self, a, i):
        self.shape = a["images"].shape[1:3]
        self.image, self.mask = a["images"][i], a["masks"][i]
        self.border_mask = np.zeros_like(self.mask)
        self.depth_map, self.fused_depth_map = a["depths"][i], a["fused_depths"][i]
        self.intrinsic_matrix = a["intrinsics"][i]
        self.cam_pose = _Pose(a["c2w"][i])
        self.near = {"bkg": float(a["near_bkg"][i]), "human": float(a["near_human"][i])}
        self.far = {"bkg": float(a["far_bkg"][i]), "human": float(a["far_human"][i])}
        # staged as viewf = frame_id / total_frames: this keeps viewf exact
        self.frame_id = {"frame_id": float(a["viewf"][i]), "total_frames": 1}


class ArraysScene:
    """The duck-typed scene that build_scene_arrays and the trainers read,
    over staged arrays (synthetic_arrays, say), copied to host numpy:
    build_scene_arrays stages it back to the same arrays, as long as the
    border class is empty, as it is in synthetic_arrays. The human stage
    also reads the canonical vertices `static_vert` [N][V, 3], `faces`, the
    scene `scale`, the per-frame SMPL estimates `smpls` ([{"pose", "betas"}])
    and `alignments` [N, 4, 4], and per capture an optional `densepose` map
    (`densepose`: one [H, W] part-label map per view)."""

    def __init__(self, arrays, static_vert=None, faces=None, scale=1.0, smpls=None,
                 alignments=None, densepose=None):
        a = {f.name: getattr(arrays, f.name).cpu().numpy() for f in fields(arrays)}
        self.captures = [_Capture(a, i) for i in range(a["images"].shape[0])]
        self.verts = list(a["verts"])
        self.static_vert, self.faces, self.scale = static_vert, faces, scale
        self.smpls, self.alignments = smpls, alignments
        for cap, dp in zip(self.captures, densepose or []):
            cap.densepose = dp


def synthetic_human_scene(body, num_views=4, h=270, w=480, seed=0, device="cuda"):
    """A synthetic scene for the human stage, the one the JAX package's
    bench.py trains on: `synthetic_arrays` views whose posed vertices (also
    the canonical ones) are the SMPL-like `body`'s template + 0.02 x the
    synthetic noise, poses and betas 0.05 x normal draws from `seed`,
    identity alignments, scale 1."""
    arrays = synthetic_arrays(num_views, h, w, num_verts=body.num_verts, seed=seed, device=device)
    arrays.verts = body.v_template.to(arrays.verts.device)[None] + arrays.verts * 0.02
    rng = np.random.default_rng(seed)
    poses = rng.normal(size=(num_views, 72)).astype(np.float32) * 0.05
    betas = rng.normal(size=(num_views, 10)).astype(np.float32) * 0.05
    return ArraysScene(
        arrays, static_vert=list(arrays.verts.cpu().numpy()), faces=body.faces, scale=1.0,
        smpls=[{"pose": p, "betas": b} for p, b in zip(poses, betas)],
        alignments=np.tile(np.eye(4, dtype=np.float32)[None], (num_views, 1, 1)))
