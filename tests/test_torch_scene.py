"""The port's scene reader (data_io/, cameras/, geometry/, scenes/,
utils/png.py, utils/resize.py, data_io/smpl_pickle.py) vs neuman_tpu's.

Both packages read one module-scoped `tests/fixtures.build_synthetic_scene`
(48 x 64, 10 frames), at the native size and at tgt_size (24, 32). Bit
for bit: images, masks, binary and border masks, MVS and mono depth,
intrinsics, camera_to_world, the background near/far, scale, frame ids,
faces, SMPL pose and betas, the point cloud and the split files. To 1e-5
absolute: the posed and Da-pose vertices, Ts and the joints (the port's
skinning runs in torch, the JAX package's in XLA, both f32). To 1e-5
relative: the human near/far (from the projected posed vertices) and the
fused depth (the JAX package fits it by f64 normal equations in its native
library, the port by np.polyfit). The PNG codec is held to imageio, the
resize to PIL, the joblib reader to joblib.
"""

import io
import os
import pickle
import shutil
import struct
import zlib

import imageio.v2 as imageio
import joblib
import numpy as np
import pytest
import torch
from PIL import Image

from neuman_tpu.data_io import neuman as jneuman
from neuman_tpu.datasets import arrays as jarrays
from neuman_tpu.models import smpl as jsmpl
from neuman_tpu.utils import misc as jmisc
from neuman_tpu_torch.data_io import neuman as tneuman
from neuman_tpu_torch.data_io import smpl_pickle
from neuman_tpu_torch.datasets import arrays as tarrays
from neuman_tpu_torch.models import smpl as tsmpl
from neuman_tpu_torch.tools import synthetic_scene
from neuman_tpu_torch.utils import misc as tmisc
from neuman_tpu_torch.utils import png
from neuman_tpu_torch.utils.resize import resize
from tests.fixtures import build_synthetic_scene

torch.set_num_threads(1)

ABS = 1e-5  # skinned vertices, transforms, joints
REL = 1e-5  # human near/far, fused depth
READ = dict(normalize=True, bkg_range_scale=3.0, human_range_scale=1.5, smpl_type="optimized")
SIZES = [None, (24, 32)]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The fixture scene, with NEUMAN_DATA_ROOT at its body model for the
    module (the builder sets it; the caller's value comes back after)."""
    before = os.environ.get("NEUMAN_DATA_ROOT")
    path = build_synthetic_scene(tmp_path_factory.mktemp("torch_scene"))
    yield path
    if before is None:
        os.environ.pop("NEUMAN_DATA_ROOT", None)
    else:
        os.environ["NEUMAN_DATA_ROOT"] = before


@pytest.fixture(scope="module")
def scenes(scene_dir):
    """{tgt_size: (JAX scene, port scene)}, border masks added by each
    package (dilation 3)."""
    out = {}
    for tgt in SIZES:
        js = jneuman.NeuManReader.read_scene(scene_dir, tgt_size=tgt, **READ)
        ts = tneuman.NeuManReader.read_scene(scene_dir, tgt_size=tgt, **READ)
        jmisc.add_border_mask(js, iterations=3)
        tmisc.add_border_mask(ts, iterations=3)
        out[tgt] = (js, ts)
    return out


def _caps(scenes, tgt):
    js, ts = scenes[tgt]
    assert len(js.captures) == len(ts.captures) == 10
    return zip(js.captures, ts.captures)


EXACT_CAPTURE = {
    "image": lambda c: c.image,
    "mask": lambda c: c.mask,
    "binary_mask": lambda c: c.binary_mask,
    "border_mask": lambda c: c.border_mask,
    "depth_map": lambda c: c.depth_map,
    "mono_depth_map": lambda c: c.mono_depth_map,
    "intrinsic_matrix": lambda c: c.intrinsic_matrix,
    "camera_to_world": lambda c: c.cam_pose.camera_to_world,
    "near_far_bkg": lambda c: np.array([c.near["bkg"], c.far["bkg"]]),
    "frame_id": lambda c: np.array([c.frame_id["frame_id"], c.frame_id["total_frames"]]),
    "image_path": lambda c: np.array([c.image_path]),
}


@pytest.mark.parametrize("tgt", SIZES, ids=["native", "24x32"])
@pytest.mark.parametrize("name", sorted(EXACT_CAPTURE))
def test_capture_contents_equal(scenes, tgt, name):
    for jc, tc in _caps(scenes, tgt):
        a, b = EXACT_CAPTURE[name](jc), EXACT_CAPTURE[name](tc)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tgt", SIZES, ids=["native", "24x32"])
def test_human_near_far_and_fused_depth_close(scenes, tgt):
    for jc, tc in _caps(scenes, tgt):
        for k in ("near", "far"):
            np.testing.assert_allclose(getattr(tc, k)["human"], getattr(jc, k)["human"],
                                       rtol=REL, atol=0)
        a, b = jc.fused_depth_map, tc.fused_depth_map
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=REL, atol=0)


SCENE_EXACT = {
    "scale": lambda s: np.array([s.scale]),
    "faces": lambda s: s.faces,
    "point_cloud": lambda s: s.point_cloud,
    "pose": lambda s: np.stack([x["pose"] for x in s.smpls]),
    "betas": lambda s: np.stack([x["betas"] for x in s.smpls]),
    "fname_to_index": lambda s: np.array(sorted(s.fname_to_index_dict.items())),
}
SCENE_CLOSE = {
    "verts": lambda s: np.stack(s.verts),
    "static_vert": lambda s: np.stack(s.static_vert),
    "Ts": lambda s: np.stack(s.Ts),
    "joints_3d": lambda s: np.stack([x["joints_3d"] for x in s.smpls]),
    "static_joints_3d": lambda s: np.stack([x["static_joints_3d"] for x in s.smpls]),
}


@pytest.mark.parametrize("tgt", SIZES, ids=["native", "24x32"])
@pytest.mark.parametrize("name", sorted(SCENE_EXACT) + sorted(SCENE_CLOSE))
def test_scene_state(scenes, tgt, name):
    js, ts = scenes[tgt]
    if name in SCENE_EXACT:
        a, b = SCENE_EXACT[name](js), SCENE_EXACT[name](ts)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    else:
        a, b = np.asarray(SCENE_CLOSE[name](js)), SCENE_CLOSE[name](ts)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        np.testing.assert_allclose(b, a, rtol=0, atol=ABS)


ARRAY_CLOSE = {"fused_depths": ("rel", REL), "near_human": ("rel", REL),
               "far_human": ("rel", REL), "verts": ("abs", ABS)}


@pytest.mark.parametrize("tgt", SIZES, ids=["native", "24x32"])
def test_build_scene_arrays_match(scenes, tgt):
    """Both packages' staged arrays of the two scenes: the pixel classes'
    permutation and counts too."""
    js, ts = scenes[tgt]
    ja = jarrays.build_scene_arrays(js)
    ta = tarrays.build_scene_arrays(ts, device="cpu")
    for field in ("images", "masks", "depths", "fused_depths", "intrinsics", "c2w", "near_bkg",
                  "far_bkg", "near_human", "far_human", "viewf", "perm", "body_count",
                  "border_count", "verts"):
        a, b = np.asarray(getattr(ja, field)), getattr(ta, field).numpy()
        assert a.shape == b.shape, field
        kind, tol = ARRAY_CLOSE.get(field, ("exact", 0))
        if kind == "exact":
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=field)
        else:
            np.testing.assert_allclose(b, a, rtol=tol if kind == "rel" else 0,
                                       atol=tol if kind == "abs" else 0, err_msg=field)


def test_split_files_byte_identical(scene_dir):
    port = [open(p, "rb").read() for p in tneuman.create_split_files(scene_dir)]
    jax_ = [open(p, "rb").read() for p in jneuman.create_split_files(scene_dir)]
    assert port == jax_ and all(port)


def test_load_smpl_matches_jax(scene_dir):
    path = tneuman.default_smpl_path()
    jm, tm = jsmpl.load_smpl(path), tsmpl.load_smpl(path)
    for name in ("v_template", "shapedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    assert tm.parents == jm.parents and np.array_equal(tm.faces, jm.faces)


def test_npy_mask_is_preferred(scene_dir, tmp_path):
    """segmentations/<fname>.npy is read in place of the PNG (np.load; the
    JAX reader hands it to imageio, which has no .npy reader)."""
    copy = shutil.copytree(scene_dir, tmp_path / "scene")
    seg = os.path.join(copy, "segmentations")
    m = np.full((48, 64), 255, np.uint8)
    m[5:9, 7:20] = 0
    np.save(os.path.join(seg, "00003.png.npy"), m)
    scene = tneuman.NeuManReader.read_scene(copy, **READ)
    np.testing.assert_array_equal(scene.captures[3].mask, (m == 0).astype(np.uint8))
    np.testing.assert_array_equal(scene.captures[2].mask,
                                  (imageio.imread(os.path.join(seg, "00002.png")) == 0))


def test_fused_depth_needs_two_valid_pixels():
    mvs = np.zeros((4, 5), np.float32)
    mvs[1, 1] = 2.0
    with pytest.raises(ValueError, match="fewer than 2"):
        tmisc.fused_depth(mvs, np.ones_like(mvs), np.zeros((4, 5), np.uint8))


# ---- PNG codec against imageio ----

FORMATS = {  # name: (bit depth, colour type, an image)
    "gray8": (8, 0, lambda rng: rng.integers(0, 256, (13, 17), dtype=np.uint8)),
    "gray16": (16, 0, lambda rng: rng.integers(0, 65536, (13, 17)).astype(np.uint16)),
    "rgb8": (8, 2, lambda rng: rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)),
    "rgba8": (8, 6, lambda rng: rng.integers(0, 256, (13, 17, 4), dtype=np.uint8)),
}


def _png_with_filter(img, depth, colour, filt, interlace=0):
    """PNG bytes of `img` with every row filtered by `filt` (the PNG
    specification's filters, written out byte by byte)."""
    h, w = img.shape[:2]
    data = (img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8)
    bpp = data.shape[1] // w
    rows, prev = [], np.zeros(data.shape[1], np.int64)
    for r in range(h):
        x = data[r].astype(np.int64)
        out = np.zeros_like(x)
        for i in range(len(x)):
            a = x[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if filt == 0:
                pred = 0
            elif filt == 1:
                pred = a
            elif filt == 2:
                pred = b
            elif filt == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (x[i] - pred) % 256
        rows.append(bytes([filt]) + out.astype(np.uint8).tobytes())
        prev = x

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("filt", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_png_filters_decode_as_imageio(fmt, filt, tmp_path):
    depth, colour, make = FORMATS[fmt]
    img = make(np.random.default_rng(filt))
    path = tmp_path / "x.png"
    path.write_bytes(_png_with_filter(img, depth, colour, filt))
    ref = imageio.imread(path)
    got = png.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_png_encode_reads_back_in_imageio(fmt, tmp_path):
    img = FORMATS[fmt][2](np.random.default_rng(7))
    png.write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "x.png"), img)
    assert png.png_size(tmp_path / "x.png") == (img.shape[1], img.shape[0])


@pytest.mark.parametrize("sub", ["images", "segmentations", "mono_depth"])
def test_png_decodes_fixture_files_as_imageio(scene_dir, sub):
    """The files imageio (Pillow's adaptive filters) wrote for the fixture."""
    folder = os.path.join(scene_dir, sub)
    for name in sorted(os.listdir(folder)):
        ref = imageio.imread(os.path.join(folder, name))
        got = png.read_png(os.path.join(folder, name))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_png_decodes_photo_like_rgb_as_imageio(tmp_path):
    """A smooth noisy RGB image, for which Pillow picks Paeth on most rows."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:40, 0:56]
    img = (128 + 60 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None]
           + rng.normal(0, 3, (40, 56, 3))).clip(0, 255).astype(np.uint8)
    imageio.imwrite(tmp_path / "x.png", img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png"), imageio.imread(tmp_path / "x.png"))


@pytest.mark.parametrize("case", ["interlaced", "palette", "gray_alpha", "jpeg"])
def test_png_raises_on_unsupported(case, tmp_path):
    img = np.zeros((4, 5), np.uint8)
    if case == "interlaced":
        data = _png_with_filter(img, 8, 0, 0, interlace=1)
    elif case == "palette":
        data = _png_with_filter(img, 8, 3, 0)
    elif case == "gray_alpha":
        data = _png_with_filter(np.zeros((4, 5, 2), np.uint8), 8, 4, 0)
    else:
        Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(tmp_path / "x.jpg")
        data = (tmp_path / "x.jpg").read_bytes()
    with pytest.raises(ValueError):
        png.decode_png(data)


# ---- resize against PIL ----

RESIZE_CASES = [((48, 64), (24, 32)), ((48, 64), (17, 29)), ((37, 53), (48, 64)),
                ((270, 480), (135, 240)), ((270, 480), (100, 333)), ((48, 64), (48, 31))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_matches_pil(src, dst):
    """BILINEAR on uint8 RGB and grayscale within 1 level of PIL (bit-equal
    as measured); NEAREST on a uint8 mask and a float32 depth map equal."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    size = dst[::-1]
    for img in (rng.integers(0, 256, src + (3,), dtype=np.uint8),
                rng.integers(0, 256, src, dtype=np.uint8)):
        ref = np.array(Image.fromarray(img).resize(size, Image.BILINEAR))
        got = resize(img, dst, "bilinear")
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.abs(got.astype(int) - ref).max() <= 1
    for img in ((rng.integers(0, 2, src) * 255).astype(np.uint8),
                rng.uniform(0, 5, src).astype(np.float32)):
        ref = np.array(Image.fromarray(img).resize(size, Image.NEAREST))
        got = resize(img, dst, "nearest")
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_nearest_source_index_is_pils_running_sum():
    """PIL's NEAREST (its affine scaling) takes source index floor(s_x),
    s_0 = in / out / 2 and s_x = s_(x-1) + in / out, a running sum in
    double: floor((x + 0.5) * in / out), except where that product is a
    whole number, which the sum can fall short of by a rounding (64 -> 6,
    x = 4: 47, not 48). Read off a float32 image of its own column indices
    for every target width 1..80 of a 64-wide and a 480-wide source; the
    port's resize picks the same columns."""
    short = 0
    for w_in in (64, 480):
        cols = np.tile(np.arange(w_in, dtype=np.float32), (2, 1))
        for w_out in range(1, 81):
            picked = np.array(Image.fromarray(cols).resize((w_out, 2), Image.NEAREST))[0]
            np.testing.assert_array_equal(resize(cols, (2, w_out), "nearest")[0], picked)
            product = (np.arange(w_out) + 0.5) * w_in / w_out
            off = picked != np.floor(product)
            assert (picked[off] == product[off] - 1).all() and (product[off] % 1 == 0).all()
            short += int(off.sum())
    assert short > 0


# ---- the joblib reader against joblib ----

def _equal_trees(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.hasobject:
            assert a.tolist() == b.tolist()
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("kind", ["optimized", "romp"])
def test_smpl_pickle_reads_fixture_joblib_files(scene_dir, kind):
    path = os.path.join(scene_dir, f"smpl_output_{kind}.pkl")
    _equal_trees(joblib.load(path), smpl_pickle.load(path))


class _NoTell(io.BytesIO):
    def tell(self):
        raise io.UnsupportedOperation("tell")


def test_smpl_pickle_reads_what_joblib_reads(tmp_path):
    """Fortran order, a big-endian array, an object array, scalars; files
    of joblib's aligned layout and of the layout without padding (what
    joblib writes where it cannot tell the file position, and what joblib
    before 1.2 wrote); a plain pickle."""
    rng = np.random.default_rng(0)
    tree = {0: {"pose": rng.normal(size=(10, 72)).astype(np.float32),
                "betas": np.asfortranarray(rng.normal(size=(10, 10))),
                "big_endian": np.arange(6, dtype=">i2").reshape(2, 3),
                "objects": np.array([None, "a", 3], dtype=object),
                "scalar": np.float64(3.5), "list": [1, 2], "empty": np.zeros((0, 3))}}
    joblib.dump(tree, tmp_path / "aligned.pkl")
    fh = _NoTell()
    joblib.dump(tree, fh)
    (tmp_path / "unaligned.pkl").write_bytes(fh.getvalue())
    with open(tmp_path / "plain.pkl", "wb") as f:
        pickle.dump(tree, f)
    for name in ("aligned", "unaligned", "plain"):
        path = tmp_path / f"{name}.pkl"
        got = smpl_pickle.load(path)
        _equal_trees(joblib.load(path), got)
        assert got[0]["betas"].flags.f_contiguous


def test_smpl_pickle_raises_on_compressed(tmp_path):
    joblib.dump({0: {"pose": np.zeros((2, 72))}}, tmp_path / "z.pkl", compress=3)
    with pytest.raises(ValueError, match="compressed"):
        smpl_pickle.load(tmp_path / "z.pkl")


# ---- the port's scene writer, read by both packages ----

@pytest.fixture(scope="module")
def tool_scenes(tmp_path_factory):
    """tools/synthetic_scene.py's 48 x 64 scene read by each package (the
    JAX reader with imageio, PIL and joblib)."""
    root = tmp_path_factory.mktemp("tool_scene")
    scene_dir = synthetic_scene.build_synthetic_scene(root)
    smpl_path = os.path.join(root, "data", "smplx", "smpl", "SMPL_NEUTRAL.pkl")
    kw = dict(READ, smpl_model_path=smpl_path)
    return (jneuman.NeuManReader.read_scene(scene_dir, **kw),
            tneuman.NeuManReader.read_scene(scene_dir, **kw))


@pytest.mark.parametrize("name", ["image", "mask", "depth_map", "mono_depth_map",
                                  "camera_to_world", "near_far_bkg"])
def test_tool_scene_reads_alike(tool_scenes, name):
    js, ts = tool_scenes
    assert js.scale == ts.scale
    for jc, tc in zip(js.captures, ts.captures):
        np.testing.assert_array_equal(EXACT_CAPTURE[name](tc), EXACT_CAPTURE[name](jc))
    if name == "mask":  # the body covers part of every frame, not all of it
        assert all(0 < c.mask.mean() < 1 for c in ts.captures)


def test_tool_scene_body_alike(tool_scenes):
    js, ts = tool_scenes
    np.testing.assert_allclose(np.stack(ts.verts), np.stack(js.verts), rtol=0, atol=ABS)
    np.testing.assert_array_equal(ts.faces, js.faces)
    for jc, tc in zip(js.captures, ts.captures):
        np.testing.assert_allclose(tc.far["human"], jc.far["human"], rtol=REL)
        np.testing.assert_allclose(tc.fused_depth_map, jc.fused_depth_map, rtol=REL)
