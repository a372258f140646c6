"""The controls on the card, at the cells' widths and a smaller video: the
control (the reference in the precision below the configuration's) comes
out beyond a limit that the program keeps. Needs a CUDA card; skips
without one:

    python -m pytest -p no:cacheprovider -q -m cuda benchmark/tests
"""

import pytest
import torch

from benchmark import control, run as brun

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    brun.caches()
    return torch.device("cuda", 0)


def _small(cell):
    c, cfg, traffic = brun.find_cell(brun.load_manifest(), cell)
    traffic.update(frames=10, height=180, width=320, focal=200.0, canonical_focal=250.0,
                   cameras=4, canonical_cameras=10, check_rays=2048, dilation=8)
    if cfg["train_mode"] == "bkg":
        cfg["config"]["rays_per_batch"] = 1024
    return c, cfg, traffic


@pytest.mark.parametrize("cell", ["bkg-train", "canonical-360-720p"])
def test_the_control_fails_and_the_program_passes(card, cell):
    c, cfg, traffic = _small(cell)
    prog, ctrl = control.readings(c, cfg, traffic, 1234567891, 1.0, "none")
    limits = traffic["limits"]
    failed = [k for k, v in limits.items() if ctrl[k] > v]
    assert failed, ctrl
    assert all(prog[k] <= limits[k] for k in failed), prog
