"""neuman_tpu_torch and chip_smoke.py import nothing of the JAX package.

Neither `neuman_tpu` (not even its numpy-only modules: the port keeps its
own copies) nor jax, flax, imageio, PIL, joblib, skimage, matplotlib,
open3d, cv2 or optax, which the machine with the GPU does not have.
`m.split('.')[0]` keeps `neuman_tpu_torch` apart from `neuman_tpu`. One
interpreter imports every module in turn (a subprocess a module took ~5 s
each, most of it importing torch).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("neuman_tpu", "jax", "jaxlib", "flax", "imageio", "PIL", "joblib", "skimage",
           "matplotlib", "open3d", "cv2", "optax")
MODULES = (
    "neuman_tpu_torch.render.renderer",
    "neuman_tpu_torch.ops.kernels._build",
    "neuman_tpu_torch.ops.kernels.nerf_mlp",
    "neuman_tpu_torch.ops.kernels.meshquery",
    "neuman_tpu_torch.models.human_nerf",
    "neuman_tpu_torch.models.smpl",
    "neuman_tpu_torch.convert",
    "neuman_tpu_torch.options.config",
    "neuman_tpu_torch.utils.constants",
    "neuman_tpu_torch.utils.synthetic_body",
    "neuman_tpu_torch.ops.kernels.nerf_mlp_vjp",
    "neuman_tpu_torch.ops.rays",
    "neuman_tpu_torch.ops.volume",
    "neuman_tpu_torch.datasets.arrays",
    "neuman_tpu_torch.datasets.sampler",
    "neuman_tpu_torch.trainers.checkpoint",
    "neuman_tpu_torch.trainers.logging",
    "neuman_tpu_torch.trainers.background",
    "neuman_tpu_torch.train",
    "neuman_tpu_torch.tools.profile_bkg_step",
    "neuman_tpu_torch.ops.kernels.offset_mlp",
    "neuman_tpu_torch.ops.kernels.knn",
    "neuman_tpu_torch.ops.mesh",
    "neuman_tpu_torch.models.lpips",
    "neuman_tpu_torch.models.nerf",
    "neuman_tpu_torch.utils.canonical_cameras",
    "neuman_tpu_torch.trainers.human",
    "neuman_tpu_torch.render.rasterize",
    "neuman_tpu_torch.tools.profile_frame",
    "neuman_tpu_torch.tools.sweep_bwd_chunk",
    "neuman_tpu_torch.geometry.transforms",
    "neuman_tpu_torch.geometry.rotation",
    "neuman_tpu_torch.geometry.pcd",
    "neuman_tpu_torch.cameras.pinhole",
    "neuman_tpu_torch.cameras.pose",
    "neuman_tpu_torch.cameras.contents",
    "neuman_tpu_torch.cameras.capture",
    "neuman_tpu_torch.utils.png",
    "neuman_tpu_torch.utils.resize",
    "neuman_tpu_torch.utils.misc",
    "neuman_tpu_torch.scenes.scene",
    "neuman_tpu_torch.data_io.colmap",
    "neuman_tpu_torch.data_io.smpl_pickle",
    "neuman_tpu_torch.data_io.neuman",
    "neuman_tpu_torch.tools.synthetic_scene",
    "neuman_tpu_torch.render.paths",
    "neuman_tpu_torch.render.cli",
    "neuman_tpu_torch.utils.metrics",
    "neuman_tpu_torch.render_test_views",
    "neuman_tpu_torch.render_360",
    "neuman_tpu_torch.render_reposing",
    "neuman_tpu_torch.render_gathering",
    "neuman_tpu_torch.ops.precision",
    "neuman_tpu_torch.preprocess.pnp",
    "neuman_tpu_torch.preprocess.soft_raster",
    "neuman_tpu_torch.preprocess.optimize_smpl",
    "neuman_tpu_torch.preprocess.alignment",
    "neuman_tpu_torch.preprocess.cli",
    "neuman_tpu_torch.preprocess.gen_run",
    "neuman_tpu_torch.parallel.mesh",
    "neuman_tpu_torch.parallel.dryrun",
    "neuman_tpu_torch.tools.sweep_kernel_envelope",
    "neuman_tpu_torch.visualize_scene",
    "neuman_tpu_torch.bench",
    "neuman_tpu_torch.tools.bench_step_parts",
    "neuman_tpu_torch.tools.bench_step_ablate",
    "neuman_tpu_torch.tools.bench_step_windows",
    "neuman_tpu_torch.utils.card",
    "neuman_tpu_torch.utils.tracing",
    "chip_smoke",
)


@pytest.fixture(scope="module")
def import_errors():
    """{module: error or None}: every module imported in turn by one fresh
    interpreter in which the blocked packages cannot be imported (each entry
    of sys.modules set to None, so an import of one raises wherever it
    happens, whichever module came first), and the blocked packages found
    in sys.modules after each import."""
    code = (
        "import json, sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "out = {}\n"
        f"for name in {MODULES!r}:\n"
        "    try:\n"
        "        __import__(name)\n"
        "        leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None)\n"
        "        out[name] = f'leaked {leaked}' if leaked else None\n"
        "    except Exception as e:\n"
        "        out[name] = repr(e)\n"
        "print(json.dumps(out))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax_stack(module, import_errors):
    assert import_errors[module] is None, import_errors[module]
