#!/usr/bin/env python
"""Write `run.sh`, the 10-stage preprocessing of one video, with stages 9
and 10 on the port (the counterpart of neuman_tpu/preprocess/gen_run.py).

    python -m neuman_tpu_torch.preprocess.gen_run --video <dir>/<name>.mp4
    bash run.sh

Stages 1-8 are outside tools whose outputs are the input contract: the
frame dump (cv2), Detectron2 masks, COLMAP, DensePose, mmpose keypoints,
BoostingMonocularDepth and ROMP. Stage 3 runs COLMAP's commands; the
others are comments naming the step and where its output goes. Stages 9
and 10 call neuman_tpu_torch.preprocess.cli on the card.

ROMP's directory is <scene>/output/romp (the JAX generator has
<scene>/romp): stage 9 writes its pickle beside that directory, in
<scene>/output, which is the scene directory stage 10 reads.
"""

import argparse
import os
import sys


def scene_paths(video):
    """(scene directory, stage 10's scene directory <scene>/output, ROMP's
    directory <scene>/output/romp) of a video path."""
    video_name = os.path.basename(video).split(".")[0]
    scene = os.path.join(os.path.dirname(os.path.abspath(video)), video_name)
    out = os.path.join(scene, "output")
    return scene, out, os.path.join(out, "romp")


def build_commands(opt):
    scene, out, romp = scene_paths(opt.video)
    code = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    steps = 10
    c = ["#!/bin/bash", "set -e"]

    def banner(i, title):
        c.append("echo ========================================")
        c.append(f"echo {i}/{steps}: {title}")
        c.append("echo ========================================")

    banner(1, "Extract frames (cv2, external)")
    c.append(f"# every 10th frame of {opt.video} at 1280x720 -> {scene}/raw_720p/*.png "
             "(a cv2 frame dump, external step)")
    banner(2, "Masks (Detectron2, external)")
    c.append(f"# detectron2 demo.py --input {scene}/raw_720p/*.png "
             f"--output {scene}/raw_masks (external tool)")
    banner(3, "Sparse + dense reconstruction (COLMAP, external)")
    c += [
        f"cd {scene}",
        "mkdir -p recon/sparse recon/dense",
        "colmap feature_extractor --database_path ./recon/db.db --image_path ./raw_720p --ImageReader.mask_path ./raw_masks --SiftExtraction.estimate_affine_shape=true --SiftExtraction.domain_size_pool=true --ImageReader.camera_model SIMPLE_RADIAL --ImageReader.single_camera 1",
        "colmap exhaustive_matcher --database_path ./recon/db.db --SiftMatching.guided_matching=true",
        "colmap mapper --database_path ./recon/db.db --image_path ./raw_720p --output_path ./recon/sparse",
        'if [ -d "./recon/sparse/1" ]; then echo "Bad reconstruction"; exit 1; fi',
        "colmap image_undistorter --image_path raw_720p --input_path ./recon/sparse/0/ --output_path ./recon/dense",
        "colmap patch_match_stereo --workspace_path ./recon/dense",
        "colmap model_converter --input_path ./recon/dense/sparse/ --output_path ./recon/dense/sparse --output_type=TXT",
        "mkdir -p ./output",
        "cp -r ./recon/dense/images ./output/images",
        "cp -r ./recon/dense/stereo/depth_maps ./output/depth_maps",
        "cp -r ./recon/dense/sparse ./output/sparse",
    ]
    banner(4, "Masks for rectified images (Detectron2, external)")
    c.append(f"# detectron2 -> {out}/segmentations (external tool)")
    banner(5, "DensePose (external)")
    c.append(f"# densepose -> {out}/densepose/dp_*.npy (external tool)")
    banner(6, "2D keypoints (mmpose, external)")
    c.append(f"# mmpose -> {out}/keypoints/*.npy (external tool)")
    banner(7, "Monocular depth (BoostingMonocularDepth, external)")
    c.append(f"# mono depth -> {out}/mono_depth (external tool)")
    banner(8, "SMPL estimates (ROMP, external)")
    c.append(f"# ROMP -> {romp} (external tool)")

    banner(9, "SMPL-scene alignment (neuman_tpu_torch, GPU)")
    c.append(f"python -c \"import sys; sys.path.insert(0, '{code}');"
             f"from neuman_tpu_torch.preprocess.cli import run_alignment;"
             f"run_alignment('{out}/sparse', '{out}/images', '{romp}')\"")
    banner(10, "SMPL pose optimization (neuman_tpu_torch, GPU)")
    c.append(f"python -c \"import sys; sys.path.insert(0, '{code}');"
             f"from neuman_tpu_torch.preprocess.cli import run_optimize_smpl;"
             f"run_optimize_smpl('{out}')\"")
    return c


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--video", required=True, type=str)
    opt = parser.parse_args(argv)
    with open("run.sh", "w") as f:
        f.write("\n".join(build_commands(opt)) + "\n")
    print("wrote run.sh")


if __name__ == "__main__":
    main(sys.argv[1:])
