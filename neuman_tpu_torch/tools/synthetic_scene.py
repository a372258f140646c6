"""Write a synthetic NeuMan scene directory, as preprocessing leaves one
for `data_io.neuman.NeuManReader` (the port's counterpart of
tests/fixtures.build_synthetic_scene with renderable=True and
photometric_human=True, with no imageio, PIL or joblib):

    <root>/scene/images/00000.png ...       a textured backdrop plane at z=1
                                            seen from a small arc of cameras,
                                            the posed body drawn over it in
                                            view-consistent vertex colours
    <root>/scene/segmentations/*.png        255 on the background, 0 where
                                            the posed body covers the pixel
    <root>/scene/depth_maps/*.geometric.bin the plane's depth (COLMAP array)
    <root>/scene/mono_depth/*.png           the same with a horizontal ripple
                                            (a mono depth is not metric),
                                            x 10000, 16-bit
    <root>/scene/sparse/{cameras,images,points3D}.txt
    <root>/scene/smpl_output_{optimized,romp}.pkl   per-frame pose and betas
                                            (a plain pickle)
    <root>/scene/alignments.npy             identity alignments
    <root>/data/smplx/smpl/SMPL_NEUTRAL.pkl the body model: by default the
                                            body proxy with its spine rigged
                                            (`rig_body_proxy`)

`write_mocap_npz` writes a motion in the AMASS layout the reposing and
gathering command lines read. `write_preprocess_inputs` writes what
preprocessing stages 9 and 10 read (COLMAP text with a ground plane, ROMP
npz files, keypoints, DensePose labels, masks) and returns the truth:

    <root>/scene/{images,segmentations}/00000.png ...
    <root>/scene/sparse/{cameras,images,points3D}.txt
    <root>/scene/romp/00000.npz ...           ROMP's `results`, one person
    <root>/scene/keypoints/00000.png.npy      COCO-17 [17, 3]
    <root>/scene/densepose/dp_00000.png.npy   part labels 0-24
    <root>/data/smplx/smpl/SMPL_NEUTRAL.pkl

Readers find the body model through NEUMAN_DATA_ROOT=<root>/data (or
`smpl_model_path`). The masks are drawn with render/rasterize.py on the
posed vertices that the port's reader gives back, so the body rays of a
training batch hit the body.

    python -m neuman_tpu_torch.tools.synthetic_scene <root> [--height 270
        --width 480 --frames 10 --subdivisions 5]
"""

import argparse
import dataclasses
import os
import pickle
import types

import numpy as np
import torch

from neuman_tpu_torch.cameras.contents import write_colmap_depth_bin
from neuman_tpu_torch.geometry import transforms
from neuman_tpu_torch.models import smpl as smpl_module
from neuman_tpu_torch.models.smpl import body_proxy_smpl_model
from neuman_tpu_torch.render.rasterize import rasterize_mesh
from neuman_tpu_torch.utils import png

NUM_BETAS = 10
# the spine joints (pelvis, spine1, spine2, spine3) of SMPL's J_regressor,
# and its hip bone (pelvis -> spine1, ~0.1 m) as a share of its ~1.7 m height
SPINE_JOINTS = (0, 3, 6, 9)
HIP_BONE_SHARE = 0.06
SPINE_BAND = 0.03
Z_PLANE = 1.0  # the backdrop plane, behind the point cloud's z range [0, 1]
CAMERA_Z = -2.5


def mono_depth_png(h, w):
    """The mono depth map the scene holds, as its 16-bit PNG stores it: the
    plane's depth plus a ripple across the width, so that the mono -> MVS
    line fit of the fused depth is well posed."""
    ripple = 0.1 * np.sin(np.linspace(0.0, 2.0 * np.pi, w))
    return np.tile(((Z_PLANE - CAMERA_Z + ripple) * 10000).astype(np.uint16), (h, 1))


def rig_body_proxy(body):
    """The SMPL-like `body` with its spine joints placed as SMPL's are: the
    J_regressor rows of joints 0, 3, 6 and 9 become uniform weights over the
    vertices within +-SPINE_BAND of the body's height of the levels c,
    c + s, c + 2s, c + 3s (c the centroid's height, s = HIP_BONE_SHARE of
    the height). So those joints lie on the body's vertical axis (within
    0.2% of the height at subdivision 3 and above), the hip bone that sets
    the automatic geo_threshold is ~6% of the height, and the spine gives
    the 360 orbits their up direction. The other rows stay as they are."""
    v = body.v_template.detach().cpu().numpy().astype(np.float64)
    y = v[:, 1]
    height = y.max() - y.min()
    j_reg = body.J_regressor.detach().cpu().numpy().copy()
    for k, j in enumerate(SPINE_JOINTS):
        band = np.abs(y - (y.mean() + k * HIP_BONE_SHARE * height)) <= SPINE_BAND * height
        j_reg[j] = band / band.sum()
    return dataclasses.replace(body, J_regressor=torch.tensor(
        j_reg, dtype=torch.float32, device=body.J_regressor.device))


def rigged_body_proxy(subdivisions=3):
    """`models.smpl.body_proxy_smpl_model(subdivisions)`, rigged."""
    return rig_body_proxy(body_proxy_smpl_model(subdivisions=subdivisions))


def write_mocap_npz(path, frames, seed=0):
    """A motion in the AMASS layout: poses [frames, 156] (axis-angle of 52
    joints, N(0, 0.1)) and trans [frames, 3] (N(0, 0.1)), float64."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, poses=rng.normal(size=(frames, 156)) * 0.1,
             trans=rng.normal(size=(frames, 3)) * 0.1)
    return path


def write_smpl_pickle(path, body):
    """An SMPL_NEUTRAL.pkl of the SMPLModel `body` that both packages'
    load_smpl read back to it (pose blend shapes zero: no reader uses them)."""
    j = body.num_joints
    kintree = np.stack([np.array(body.parents, np.int64) % 2**32,
                        np.arange(j)]).astype(np.uint32)  # the root's parent 2^32 - 1
    as_np = lambda t: t.detach().cpu().numpy().astype(np.float32)
    data = {"v_template": as_np(body.v_template), "shapedirs": as_np(body.shapedirs),
            "posedirs": np.zeros((body.num_verts, 3, (j - 1) * 9), np.float32),
            "J_regressor": as_np(body.J_regressor), "weights": as_np(body.lbs_weights),
            "kintree_table": kintree, "f": np.asarray(body.faces, np.int32)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


def _backdrop_color(x, y):
    r = 0.5 + 0.45 * np.sin(2.2 * x + 0.7)
    g = 0.5 + 0.45 * np.cos(1.7 * y - 0.3)
    b = 0.5 + 0.45 * np.sin(1.3 * (x + y))
    return np.stack([r, g, b], axis=-1)


def _vertex_colors(template):
    t = (template - template.mean(axis=0)) / (template.std(axis=0) + 1e-9)
    r = 0.5 + 0.4 * np.sin(2.0 * t[:, 0] + 0.5)
    g = 0.5 + 0.4 * np.cos(1.6 * t[:, 1])
    b = 0.5 + 0.4 * np.sin(1.8 * (t[:, 0] + t[:, 2]))
    return np.clip(np.stack([r, g, b], axis=-1), 0.05, 0.95)


def _write_sparse(sparse_dir, fnames, h, w, f, rng):
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n")
        fh.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        fh.write("# Number of cameras: 1\n")
        fh.write(f"1 PINHOLE {w} {h} {f} {f} {w / 2.0} {h / 2.0}\n")
    n = len(fnames)
    with open(os.path.join(sparse_dir, "images.txt"), "w") as fh:
        fh.write("# Image list with two lines of data per image:\n")
        fh.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        fh.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        fh.write(f"# Number of images: {n}, mean observations per image: 100.0\n")
        for i, fname in enumerate(fnames):
            # identity rotation: the camera centre is -t
            fh.write(f"{i + 1} 1 0 0 0 {-0.05 * (i - n / 2)} 0.0 {-CAMERA_Z} 1 {fname}\n\n")
    pts = rng.uniform([-1.2, -0.9, 0.0], [1.2, 0.9, 1.0], size=(200, 3))
    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n")
        fh.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        fh.write(f"# Number of points: {len(pts)}, mean track length: 2.0\n")
        for i, p in enumerate(pts):
            fh.write(f"{i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 128 128 128 0.5\n")


def build_synthetic_scene(root, num_frames=10, h=48, w=64, seed=3, body=None):
    """Write the scene under `root` (see the module docstring) with
    `num_frames` frames of h x w, the SMPL-like `body` (default: the rigged
    body proxy at subdivision 3) and its fits drawn from `seed`; returns the
    scene directory. The focal length is 35 / 64 of the width (the test
    fixture's 35 at 64 pixels)."""
    from neuman_tpu_torch.data_io.neuman import NeuManReader

    root = str(root)
    scene_dir = os.path.join(root, "scene")
    smpl_path = os.path.join(root, "data", "smplx", "smpl", "SMPL_NEUTRAL.pkl")
    body = body if body is not None else rigged_body_proxy()
    write_smpl_pickle(smpl_path, body)
    for sub in ("images", "sparse", "depth_maps", "mono_depth", "segmentations"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    rng = np.random.default_rng(seed)

    focal = 35.0 * w / 64.0
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    fnames = [f"{i:05d}.png" for i in range(num_frames)]
    blob = np.full((h, w), 255, np.uint8)  # replaced by the body's coverage below
    blob[h // 2 - h // 8: h // 2 + h // 8, w // 2 - w // 8: w // 2 + w // 8] = 0
    for i, fname in enumerate(fnames):
        s = Z_PLANE - CAMERA_Z
        hit_x = 0.05 * (i - num_frames / 2) + (px - w / 2.0) / focal * s
        hit_y = (py - h / 2.0) / focal * s
        img = (np.clip(_backdrop_color(hit_x, hit_y), 0, 1) * 255).astype(np.uint8)
        depth = np.full((h, w), s, dtype=np.float32)
        png.write_png(os.path.join(scene_dir, "images", fname), img)
        png.write_png(os.path.join(scene_dir, "segmentations", fname), blob)
        write_colmap_depth_bin(os.path.join(scene_dir, "depth_maps", fname + ".geometric.bin"),
                               depth)
        png.write_png(os.path.join(scene_dir, "mono_depth", fname), mono_depth_png(h, w))
    _write_sparse(os.path.join(scene_dir, "sparse"), fnames, h, w, focal, rng)

    poses = rng.normal(size=(num_frames, body.num_joints * 3)).astype(np.float32) * 0.05
    betas = rng.normal(size=(num_frames, NUM_BETAS)).astype(np.float32) * 0.1
    for kind in ("optimized", "romp"):
        with open(os.path.join(scene_dir, f"smpl_output_{kind}.pkl"), "wb") as f:
            pickle.dump({0: {"pose": poses, "betas": betas}}, f)
    np.save(os.path.join(scene_dir, "alignments.npy"),
            {fname: np.eye(4)[:, :3] for fname in fnames})

    # the body as the reader places it: colours over the backdrop, coverage as the mask
    scene = NeuManReader.read_scene(scene_dir, normalize=True, smpl_type="optimized",
                                    smpl_model_path=smpl_path)
    faces = np.asarray(scene.faces)[:, :3]
    colors = _vertex_colors(np.asarray(scene.static_vert[0]))
    for cap, verts, fname in zip(scene.captures, scene.verts, fnames):
        rgba = rasterize_mesh(np.asarray(verts), faces, cap, vert_colors=colors)
        if not (rgba[..., 3] > 0.5).any():
            raise ValueError(f"the body is out of view in {fname}")
        a = rgba[..., 3:]
        out = cap.image.astype(np.float64) / 255.0 * (1 - a) + rgba[..., :3] * a
        png.write_png(cap.image_path, (np.clip(out, 0, 1) * 255).astype(np.uint8))
        png.write_png(os.path.join(scene_dir, "segmentations", fname),
                      np.where(rgba[..., 3] > 0.5, 0, 255).astype(np.uint8))
    return scene_dir


def _rotation(rng, scale):
    """A rotation by N(0, scale) about each axis, as one axis-angle."""
    axis_angle = rng.normal(size=3) * scale
    return transforms.rotation_matrix(np.linalg.norm(axis_angle), axis_angle)[:3, :3]


def _colmap_text(sparse_dir, fnames, h, w, f, w2cs, points):
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n")
        fh.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        fh.write("# Number of cameras: 1\n")
        fh.write(f"1 PINHOLE {w} {h} {float(f)!r} {float(f)!r} {w / 2.0!r} {h / 2.0!r}\n")
    with open(os.path.join(sparse_dir, "images.txt"), "w") as fh:
        fh.write("# Image list with two lines of data per image:\n")
        fh.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        fh.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        fh.write(f"# Number of images: {len(fnames)}, mean observations per image: 100.0\n")
        for i, (fname, w2c) in enumerate(zip(fnames, w2cs)):
            q = transforms.quaternion_from_matrix(w2c)
            fh.write(f"{i + 1} " + " ".join(repr(float(x)) for x in (*q, *w2c[:3, 3]))
                     + f" 1 {fname}\n\n")
    with open(os.path.join(sparse_dir, "points3D.txt"), "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n")
        fh.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        fh.write(f"# Number of points: {len(points)}, mean track length: 2.0\n")
        for i, p in enumerate(points):
            fh.write(f"{i} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r} 128 128 128 0.5\n")


def write_preprocess_inputs(root, num_frames=4, h=48, w=64, seed=0, body=None):
    """Write a preprocessing scene under `root` (see the module docstring)
    and return (scene directory, truth).

    The COLMAP cameras stand 2.5 in front of the person, each turned a
    little. ROMP's fits: pose = the true pose plus N(0, 0.15) on the limb
    components stage 10 refines (inside the joint limits), betas N(0, 0.1),
    `verts` and 54 joints (the body's 24, then 30 fixed vertices) posed by
    LBS, `pj2d_org` their projections through a known SMPL camera. The
    truth's alignment maps the fit into the COLMAP world as
    world = c2w([p, 1] @ (s x smpl_w2c)^T), with s chosen so that the
    fit's lowest joint stands on the ground plane y = y_g; points3D.txt
    holds 300 points on that plane (N(0, 1 mm) off it) and 100 above it.
    The masks, keypoints (COCO slots of the SMPL joints, confidence 1) and
    DensePose labels (1-24 over the mask) are of the true pose.

    truth: {"alignments": {image name: [4, 3]}, "plane": (a, b, c, d),
    "pose": [frames, 72] true, "romp_pose": [frames, 72], "betas"}.
    """
    from neuman_tpu_torch.preprocess import optimize_smpl as osm

    root = str(root)
    scene_dir = os.path.join(root, "scene")
    smpl_path = os.path.join(root, "data", "smplx", "smpl", "SMPL_NEUTRAL.pkl")
    body = body if body is not None else rigged_body_proxy()
    write_smpl_pickle(smpl_path, body)
    for sub in ("images", "sparse", "segmentations", "romp", "keypoints", "densepose"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    focal = 35.0 * w / 64.0
    k = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1]])
    fnames = [f"{i:05d}.png" for i in range(num_frames)]
    extra = rng.choice(body.num_verts, 54 - body.num_joints, replace=False)

    limits = osm.clip_smpl_vals()
    enabled = osm.turn_smpl_gradient_on(np.arange(25)).astype(bool)
    margin = np.minimum(0.05, (limits[:, 1] - limits[:, 0]) / 4)
    poses = np.clip(rng.normal(size=(num_frames, 72)) * 0.1, limits[:, 0] + margin,
                    limits[:, 1] - margin).astype(np.float32)
    delta = np.where(enabled, rng.normal(size=(num_frames, 72)) * 0.15, 0.0)
    start_margin = np.minimum(0.02, (limits[:, 1] - limits[:, 0]) / 8)
    romp_poses = np.clip(poses + delta, limits[:, 0] + start_margin,
                         limits[:, 1] - start_margin).astype(np.float32)
    betas = (rng.normal(size=(num_frames, NUM_BETAS)) * 0.1).astype(np.float32)

    def posed(pose, beta):
        with torch.no_grad():
            v, j = smpl_module.smpl_forward(body, torch.as_tensor(pose[None]),
                                            torch.as_tensor(beta[None]))
        return v[0].numpy().astype(np.float64), j[0].numpy().astype(np.float64)

    flip = np.diag([1.0, -1.0, -1.0])  # SMPL's y up -> the camera's y down
    w2cs, smpl_cams, alignments, y_ground = [], [], {}, None
    for i, fname in enumerate(fnames):
        r_c = _rotation(rng, 0.1)
        w2c = np.eye(4)
        w2c[:3, :3] = r_c
        w2c[:3, 3] = -r_c @ np.array([0.2 * (i - num_frames / 2), 0.0, CAMERA_Z])
        r_s = flip @ _rotation(rng, 0.2)
        t_s = np.array([0.0, 0.0, -CAMERA_Z]) + rng.normal(size=3) * 0.05
        verts, joints = posed(romp_poses[i], betas[i])
        j54 = np.concatenate([joints, verts[extra]])
        rays = (j54 @ r_s.T + t_s) @ r_c  # camera -> joint, in world axes, at scale 1
        centre = -r_c.T @ w2c[:3, 3]
        if y_ground is None:
            y_ground = centre[1] + rays[:, 1].max()
        s = (y_ground - centre[1]) / rays[:, 1].max()
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = s * r_s, s * t_s
        alignments[fname] = (np.linalg.inv(w2c)[:3] @ m).T
        cam = j54 @ r_s.T + t_s
        pj2d = cam[:, :2] / cam[:, 2:3] * focal + k[:2, 2]
        res = np.empty(1, dtype=object)
        res[0] = {"verts": verts.astype(np.float32), "j3d_all54": j54.astype(np.float32),
                  "pj2d_org": pj2d.astype(np.float32), "poses": romp_poses[i],
                  "betas": betas[i]}
        np.savez(os.path.join(scene_dir, "romp", fname[:-4] + ".npz"), results=res)
        w2cs.append(w2c)

    ground = np.stack([rng.uniform(-1.5, 1.5, 300), y_ground + rng.normal(size=300) * 1e-3,
                       rng.uniform(-0.5, 2.0, 300)], axis=1)
    above = np.stack([rng.uniform(-1.5, 1.5, 100), y_ground - rng.uniform(0.1, 2.0, 100),
                      rng.uniform(-0.5, 2.0, 100)], axis=1)
    _colmap_text(os.path.join(scene_dir, "sparse"), fnames, h, w, focal, w2cs,
                 np.concatenate([ground, above]))

    faces = np.asarray(body.faces)
    for i, fname in enumerate(fnames):
        a = np.eye(4)
        a[:, :3] = alignments[fname]
        verts, joints = posed(poses[i], betas[i])
        to_world = lambda p: np.concatenate([p, np.ones_like(p[:, :1])], axis=1) @ a[:, :3]
        view = types.SimpleNamespace(intrinsic_matrix=k, shape=(h, w),
                                     cam_pose=types.SimpleNamespace(world_to_camera=w2cs[i]))
        rgba = rasterize_mesh(to_world(verts), faces, view)
        covered = rgba[..., 3] > 0.5
        if covered.sum() < 16:
            raise ValueError(f"the body covers {covered.sum()} pixels of {fname}")
        img = np.full((h, w, 3), 0.5) * (1 - rgba[..., 3:]) + rgba[..., :3] * rgba[..., 3:]
        png.write_png(os.path.join(scene_dir, "images", fname),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
        png.write_png(os.path.join(scene_dir, "segmentations", fname),
                      np.where(covered, 0, 255).astype(np.uint8))
        cam = to_world(joints) @ w2cs[i][:3, :3].T + w2cs[i][:3, 3]
        pj = cam[:, :2] / cam[:, 2:3] * focal + k[:2, 2]
        coco = np.zeros((17, 3))
        for smpl_slot, coco_slot in osm.COCO_OF_SMPL.items():
            coco[coco_slot] = [*pj[smpl_slot], 1.0]
        np.save(os.path.join(scene_dir, "keypoints", fname + ".npy"), coco)
        parts = np.zeros((h, w), np.int64)
        parts[covered] = 1 + np.arange(covered.sum()) % 24
        np.save(os.path.join(scene_dir, "densepose", f"dp_{fname}.npy"), parts)
    truth = {"alignments": alignments, "plane": (0.0, 1.0, 0.0, -y_ground), "pose": poses,
             "romp_pose": romp_poses, "betas": betas}
    return scene_dir, truth


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root")
    parser.add_argument("--height", type=int, default=48)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--subdivisions", type=int, default=3)
    parser.add_argument("--seed", type=int, default=3)
    args = parser.parse_args(argv)
    scene_dir = build_synthetic_scene(args.root, args.frames, args.height, args.width,
                                      args.seed, rigged_body_proxy(args.subdivisions))
    print(scene_dir)


if __name__ == "__main__":
    main()
