"""The four-rank cell (`bkg-train-dp4`, kind `train_bkg_dp` from
benchmark/kinds/) shrunk for the CPU, on 4 gloo ranks: it runs through
run.py traced and through control.readings, correct, its replicas equal; a
worker killed or stuck ends the run non-zero with no result line; a
program without the distributed timeout stops it before any set-up; the
new readers read nothing off the cell or without a trace; and the
manifest asks for 4 chips in few cells."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import cells, control, run as brun
from benchmark import trace as btrace
from benchmark.tests import tiny
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.utils import tracing

CELL = "bkg-train-dp4"
READERS = ("allreduce_ms.train", "collectives_per_step", "allreduce_roofline.train")

# a tiny run of the cell in which rank 2 is killed ("kill") or stopped
# ("stop", the command's deadline then cut to 5 s) at the third unit
FAULTY_RUN = '''
import os, signal, sys
from benchmark import run as brun
from benchmark.tests import tiny

how, real = sys.argv[1], brun.runner_class


def runner_class(kind, bench=brun.BENCH):
    class Faulty(real(kind, bench)):
        units = 0

        def unit(self, draw_events=None):
            Faulty.units += 1
            if Faulty.units == 3:
                self.timeout_s = 5.0
                os.kill(self.workers[1].pid, signal.SIGKILL if how == "kill" else signal.SIGSTOP)
            return super().unit(draw_events)
    return Faulty


brun.runner_class = runner_class
result, _ = tiny.run("bkg-train-dp4", seconds=60.0)
brun.emit(result)
'''


def _line(result, capsys):
    brun.emit(result)
    out, _ = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1])


def test_a_traced_tiny_run_on_four_ranks_and_its_control(capsys):
    tracing.reset()
    result, numbers = tiny.run(CELL, trace=1)
    line = _line(result, capsys)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert numbers["replica_gap"] == 0.0 and line["checks"]["replica_gap"]["limit"] == 0.0
    # the counter is host-held; the span's device time and the NCCL kernels need the card
    assert line["metrics"]["collectives_per_step"]["value"] == 4.0
    assert "allreduce_ms.train" not in line["metrics"] and "allreduce_roofline.train" not in line["metrics"]
    _, c, cfg, small = tiny.tiny(CELL)
    prog, ctrl = control.readings(c, cfg, small, 5, 0.3, "none", device="cpu")
    assert all(prog[k] <= v for k, v in small["limits"].items()), prog
    assert set(ctrl) == set(prog) and ctrl["replica_gap"] == 0.0


@pytest.mark.parametrize("how", ["kill", "stop"])
def test_a_lost_worker_ends_the_run_non_zero(how):
    """A worker killed, or stopped past the command's deadline, at the third
    unit of a 60-s window: every rank ends within the deadline, non-zero,
    with no result line."""
    env = dict(os.environ, PYTHONPATH=brun.ROOT)
    start = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", FAULTY_RUN, how], cwd=brun.ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    took = time.monotonic() - start
    assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stderr[-2000:]
    assert "every rank stopped, no result" in proc.stderr
    assert took < 60.0
    assert "rank 2 exited" in proc.stderr if how == "kill" else "within 5 s" in proc.stderr


def test_a_program_without_the_timeout_stops_before_any_set_up(monkeypatch, capsys):
    def untimed(backend="nccl"):
        raise AssertionError("joined")

    monkeypatch.setattr(pmesh, "maybe_init_distributed", untimed)
    manifest, c, cfg, traffic = tiny.tiny(CELL)
    args = brun.parse_args(["--workload", CELL, "--seed", "3", "--seconds", "0.3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="takes no timeout"):
        brun.run(args, manifest, c, cfg, traffic)
    assert capsys.readouterr().out == ""


def _context(runner, tr):
    return btrace.context(runner, tr, 0.1, None, 0)


def test_the_new_readers_read_nothing_off_the_cell_or_without_a_trace():
    tracing.reset()
    _, _, cfg, traffic = tiny.tiny("bkg-train")
    runner = cells.TrainBkg(cfg, traffic, 3, "cpu")
    off_cell = _context(runner, btrace.profile(runner, 2, runner.device))
    no_trace = _context(runner, btrace.Trace([], 2, "step"))
    for name in READERS:
        read = brun.metric_reader(name)
        assert read(off_cell) is None and read(no_trace) is None, name
    tracing.reset()


def test_few_cells_ask_for_four_chips():
    """At most max(1, a quarter of the cells, rounded down) cells ask for 4
    chips; this one does, and its traffic's ranks fit them."""
    manifest = brun.load_manifest()
    cells_ = manifest["workloads"]
    four = [w["name"] for w in cells_ if w["chips"] == 4]
    assert len(four) <= max(1, len(cells_) // 4), four
    cell, _, traffic = brun.find_cell(manifest, CELL)
    assert cell["chips"] == 4 and traffic["ranks"] == 4 and traffic["limits"]["replica_gap"] == 0.0
