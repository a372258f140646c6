"""`neuman_tpu_torch.visualize_scene` against the JAX script
(visualize_scene.py): the cameras' corner rays, and the PNG it draws of
tools/synthetic_scene.py's scene."""

import os

import numpy as np
import pytest
import torch

import visualize_scene as jvis
from neuman_tpu.data_io import neuman as jneuman
from neuman_tpu_torch import visualize_scene as tvis
from neuman_tpu_torch.data_io import neuman as tneuman
from neuman_tpu_torch.tools import synthetic_scene
from neuman_tpu_torch.utils.png import read_png

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The tool's scene, its sparse points given random colours, with
    NEUMAN_DATA_ROOT at its body model for the module's tests."""
    root = str(tmp_path_factory.mktemp("visualize"))
    path = synthetic_scene.build_synthetic_scene(root)
    points = os.path.join(path, "sparse", "points3D.txt")
    rng = np.random.default_rng(0)
    with open(points) as fh:
        lines = fh.read().splitlines()
    with open(points, "w") as fh:
        for line in lines:
            if not line.startswith("#"):
                f = line.split()
                f[4:7] = map(str, rng.integers(0, 256, 3))
                line = " ".join(f)
            fh.write(line + "\n")
    before = os.environ.get("NEUMAN_DATA_ROOT")
    os.environ["NEUMAN_DATA_ROOT"] = os.path.join(root, "data")
    yield path
    if before is None:
        os.environ.pop("NEUMAN_DATA_ROOT", None)
    else:
        os.environ["NEUMAN_DATA_ROOT"] = before


def test_camera_poly_matches_jax(scene_dir):
    jcaps = jneuman.NeuManReader.read_captures(scene_dir, None)[0]
    tcaps = tneuman.NeuManReader.read_captures(scene_dir, None)[0]
    for jcap, tcap in zip(jcaps, tcaps):
        for size in (1.0, 0.2):
            got = np.array(tvis.camera_poly(tcap, size=size, device="cpu"))
            want = np.array(jvis.camera_poly(jcap, size=size))
            assert got.shape == want.shape == (5, 3)
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_main_draws_the_scene(scene_dir, tmp_path):
    """The PNG is the view's size; the nearest cloud point's pixel carries
    its colour (it is nearer than every body point and camera edge there),
    and red body points and blue camera edges are drawn."""
    out = tvis.main(["--scene_dir", scene_dir, "--save_to", str(tmp_path / "view.png")],
                    device="cpu")
    image = read_png(out)
    assert image.shape == (*tvis.IMAGE_HW, 3)
    scene = tneuman.NeuManReader.read_scene(scene_dir, normalize=True, bkg_range_scale=3,
                                            human_range_scale=1.5, smpl_type="optimized")
    geometry = tvis.scene_geometry(scene, "cpu")
    assert len(geometry.segments) == 4 * len(scene.captures)
    view = tvis.View(geometry.points(), tvis.IMAGE_HW)
    col, row, depth = view.project(geometry.cloud)
    i = np.argmin(depth)
    others = np.concatenate([geometry.body, geometry.segments.reshape(-1, 3)])
    assert depth[i] < view.project(others)[2].min()
    np.testing.assert_array_equal(image[row[i], col[i]], geometry.colors[i])
    colours = {tuple(c) for c in image.reshape(-1, 3)}
    assert tvis.RED in colours and tvis.BLUE in colours and tvis.WHITE in colours


def test_main_needs_a_card_unless_asked_for_the_cpu(scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.main(["--scene_dir", scene_dir, "--save_to", str(tmp_path / "v.png")])
    assert not (tmp_path / "v.png").exists()
