"""Preprocessing stages 9 and 10 (the port's counterpart of
neuman_tpu/preprocess/cli.py; the generated run.sh calls them).

    run_alignment(sparse_dir, images_dir, romp_dir)   stage 9: ROMP's npz
        outputs -> <romp_dir>/../smpl_output_romp.pkl, then
        <sparse_dir>/../alignments.npy
    run_optimize_smpl(scene_dir)                      stage 10: the ROMP
        fits of <scene_dir> refined -> smpl_output_optimized.pkl

Both run on the card unless device="cpu" is given, and raise without one.
The pickles are plain pickles (`data_io/smpl_pickle.dump`), which
joblib.load reads too. With gen_run's layout (`romp_dir` = <scene>/output/
romp) stage 9's pickle lands in the scene directory stage 10 reads.
"""

import os

import numpy as np

from neuman_tpu_torch.data_io import smpl_pickle
from neuman_tpu_torch.data_io.colmap import ColmapAsciiReader
from neuman_tpu_torch.data_io.neuman import NeuManReader
from neuman_tpu_torch.preprocess.alignment import export_alignments
from neuman_tpu_torch.preprocess.optimize_smpl import optimize_smpl_frame
from neuman_tpu_torch.train import require_device


def _device(device, what):
    device = "cuda" if device is None else device
    require_device(device, what)
    return device


def romp_pickle_path(romp_dir):
    """Where stage 9 writes the collected ROMP fits: beside `romp_dir`."""
    return os.path.abspath(os.path.join(romp_dir, "..", "smpl_output_romp.pkl"))


def load_romp_estimates(romp_output_dir, dump_path):
    """The per-frame ROMP results (one `results` entry in each npz of
    `romp_output_dir`, in file-name order) as float32 arrays 'verts',
    'joints3d', 'joints2d_img_coord', 'pose', 'betas', dumped to
    `dump_path` as {1: fits}; read back from there when it exists."""
    if os.path.isfile(dump_path):
        return smpl_pickle.load(dump_path)[1]
    est = {"verts": [], "joints3d": [], "joints2d_img_coord": [], "pose": [], "betas": []}
    files = sorted(f for f in os.listdir(romp_output_dir) if f.endswith("npz"))
    for file in files:
        res = np.load(os.path.join(romp_output_dir, file), allow_pickle=True)["results"]
        if len(res) != 1:
            raise ValueError(f"{file}: expected one person, ROMP found {len(res)}")
        res = res[0]
        est["verts"].append(res["verts"])
        est["joints3d"].append(res["j3d_all54"])
        est["joints2d_img_coord"].append(res["pj2d_org"])
        est["pose"].append(res["poses"])
        est["betas"].append(res["betas"])
    est = {k: np.array(v).astype(np.float32) for k, v in est.items()}
    smpl_pickle.dump({1: est}, dump_path)
    return est


def run_alignment(sparse_dir, images_dir, romp_dir, device=None):
    """Stage 9: the SMPL <-> scene alignments -> alignments.npy beside
    `sparse_dir`. Returns {image name: [4, 3]}."""
    device = _device(device, "run_alignment")
    scene = ColmapAsciiReader.read_scene(sparse_dir, images_dir, order="video")
    raw_smpl = load_romp_estimates(romp_dir, romp_pickle_path(romp_dir))
    if len(raw_smpl["pose"]) != len(scene.captures):
        raise ValueError(f"{len(raw_smpl['pose'])} ROMP fits for {len(scene.captures)} images")
    save_path = os.path.abspath(os.path.join(sparse_dir, "..", "alignments.npy"))
    alignments = export_alignments(scene, raw_smpl, save_path, device=device)
    print(f"alignment matrix saved at: {save_path}")
    return alignments


def run_optimize_smpl(scene_dir, num_iters=100, device=None):
    """Stage 10: refine the pose of every frame with keypoints and
    DensePose -> smpl_output_optimized.pkl in `scene_dir`. Returns the
    fits written."""
    device = _device(device, "run_optimize_smpl")
    scene = NeuManReader.read_scene(scene_dir, smpl_type="romp", normalize=False)
    body_model = NeuManReader._body_model()
    raw_alignments = np.load(os.path.join(scene_dir, "alignments.npy"),
                             allow_pickle=True).item()
    raw = smpl_pickle.load(os.path.join(scene_dir, "smpl_output_romp.pkl"))
    key = list(raw.keys())[0]
    optimized = {k: np.array(v) for k, v in raw[key].items()}
    for cap in scene.captures:
        if cap.keypoints is None or cap.densepose is None:
            continue
        fname = os.path.basename(cap.image_path)
        align = np.eye(4)
        align[:, :3] = raw_alignments[fname]
        frame_id = int(fname[:-4])
        frame = {"pose": optimized["pose"][frame_id], "betas": optimized["betas"][frame_id]}
        optimized["pose"][frame_id] = optimize_smpl_frame(
            cap, frame, body_model, align, scene.scale, num_iters=num_iters, device=device)
    out_path = os.path.join(scene_dir, "smpl_output_optimized.pkl")
    smpl_pickle.dump({key: optimized}, out_path)
    print(f"optimized SMPL saved at: {out_path}")
    return optimized
