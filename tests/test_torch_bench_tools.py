"""The bench's step tools on the CPU at tiny sizes: every component of
`neuman_tpu_torch.tools.bench_step_parts` runs, and the loss families of
`neuman_tpu_torch.tools.bench_step_ablate` reach the config that the human
step is built from (in this process; the tool itself runs each family in a
process of its own); `bench_step_windows` runs on the card only."""

import math

import pytest
import torch

from neuman_tpu_torch import bench
from neuman_tpu_torch.tools import bench_step_ablate, bench_step_parts, bench_step_windows

torch.set_num_threads(1)

CPU = torch.device("cpu")
# the patch batch of the sampler needs more than 1024 rays
TINY = dict(overrides={"nerf_depth": 2, "nerf_width": 32, "rays_per_batch": 1056,
                       "samples_per_ray": 4, "dilation": 0},
            views=2, hw=(36, 48), body_subdivisions=0)
ROWS = {"mlpvjp": 4, "query": 6}


@pytest.fixture(scope="module")
def setup():
    return bench.human_setup(CPU, **TINY)


@pytest.mark.parametrize("component", bench_step_parts.COMPONENTS)
def test_step_part_runs(component, setup):
    parts = bench_step_parts.components(setup, (component,), 1056, 4, "float32", CPU)
    assert len(parts) == ROWS.get(component, 1)
    for label, f, x0 in parts:
        ms = bench_step_parts.time_component(CPU, f, x0, reps=1, runs=1)
        assert math.isfinite(ms) and ms > 0, label


class _Built(Exception):
    """Raised once the human step's config is seen: the step need not run."""


@pytest.fixture
def built_configs(monkeypatch):
    """The config of every human step the bench builds, in order; with
    `stop` set, building one raises _Built."""
    seen = []
    make = bench.make_human_train_step

    def recording(model, opt, *args, **kwargs):
        seen.append(opt)
        if recording.stop:
            raise _Built
        return make(model, opt, *args, **kwargs)

    recording.stop = False
    monkeypatch.setattr(bench, "make_human_train_step", recording)
    return seen, recording


@pytest.mark.parametrize("family", list(bench_step_ablate.ABLATIONS))
def test_ablation_reaches_the_step_config(family, built_configs):
    """The family's weights are 0 in the config its step is built from, and
    every other field is the bench's human config."""
    seen, recording = built_configs
    recording.stop = True
    with pytest.raises(_Built):
        bench_step_ablate.run_one(family, "cpu", 1, **TINY)
    zeroed = bench_step_ablate.ABLATIONS[family]
    want = bench._config("smpl_and_offset", {"geo_threshold": 0.25, **TINY["overrides"]})
    for k, v in zeroed.items():
        assert getattr(seen[0], k) == v == 0.0 and getattr(want, k) > 0, k
        setattr(want, k, v)
    assert vars(seen[0]) == vars(want)


def test_ablation_times_full_and_one_family(built_configs, capsys):
    """`full` and `lpips` each time one step and print their RESULT line."""
    seen, _ = built_configs
    for name in ("full", "lpips"):
        ms = bench_step_ablate.run_one(name, "cpu", 1, **TINY)
        assert math.isfinite(ms) and ms > 0
        assert capsys.readouterr().out.strip().endswith(f"RESULT {name} {ms:.3f}")
    assert [c.penalize_lpips for c in seen] == [0.01, 0.0]


def test_step_windows_needs_the_card(monkeypatch, capsys):
    """The tool times CUDA streams: without a card it exits 1 before any setup."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_step_windows.bench, "human_setup", None)
    assert bench_step_windows.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
