"""train_bkg_dp: NeuMan stage 1 on `ranks` processes, one GPU each, as
upstream's `nn.DataParallel` runs it (apple/ml-neuman train.py:26-28): the
global batch of `rays_per_batch` rays, each rank its contiguous share of
it, the gradients summed over the ranks. The published schedule and batch
are unchanged.

Rank 0 is the harness's own process, on cuda:0. Ranks 1.. are workers on
cuda:1.., each this file run as a script with one torch thread:

    python3 benchmark/kinds/train_bkg_dp.py --rank r --port p --seed s --device cuda

Rank 0 loads the step's kernel libraries before it starts them, so that a
checkout's first run builds each once, and hosts the group's store on a
port of its own choosing, as torchrun's agent does. Every rank builds the
step as the port's trainer does: `maybe_init_distributed` (NCCL on the
card, gloo on the CPU) under torchrun's variables (with
`TORCHELASTIC_USE_AGENT_STORE`, so that each rank meets at rank 0's store), `resolve_mesh` of the configuration
(`data_parallel: "on"`), `make_bkg_train_step(mesh=)` and `put_replicated`
of the parameters and Adam's state. Every rank then draws the whole batch
from the same generator, and the step trains on its rows.

The workers follow rank 0's commands, one a line on their standard input:
the set-up (the configuration and the traffic as JSON), then `unit`,
`finish`, `check` and `stop`. Each answers on its standard output (`ready`,
`done`) and prints anything else to standard error. So every rank runs the
same units in the same order: the set-up's recorded steps, the window, the
traced units. Only rank 0 times, traces and records what the reference
follows.

No hangs: a worker that exits, or a set-up or command that every rank has
not finished within `timeout_s` (120 s), ends the run. Rank 0 then kills
every worker and exits non-zero with no result line. The process group's
timeout is the same, and a worker whose rank 0 is gone exits. A program
whose `maybe_init_distributed` takes no timeout stops the run before any
set-up.

`check()` gives the nine numbers of `train_bkg`, taken on rank 0: the
recorded batches (the whole batch, as every rank drew it) rebuilt from
their pixels, and the unsharded reference `reference/steps.bkg_step` over
the global batch, from the same weights, for the same steps. The ranks'
summed step is defined to compute what that step computes, so the cell
needs no reference of its own. It adds `replica_gap`: the largest absolute
difference, over every parameter and both of Adam's moments, of any rank's
from rank 0's, after the set-up's steps and again at the check. All-reduce
gives every rank the same sums and the dead-net tests are maxima over the
ranks, so it is 0.

`work()` is rank 0's own share (its rows of the batch), so that the MFU
and the roofline read per chip, and `"allreduce"`, the step's all-reduce
bus bytes from the widths (benchmark/collectives.py).
"""

import argparse
import datetime
import inspect
import json
import os
import subprocess
import sys
import threading
import time
import traceback

if __name__ == "__main__":
    # a worker: its answers alone take the pipe on standard output, and
    # whatever the imports, NCCL or the program print goes to standard error
    ANSWER = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)

import torch
import torch.distributed as dist

from benchmark import cells, collectives, flops
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.ops.kernels import _build
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.trainers.background import make_bkg_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 120.0
# the libraries of a stage-1 step's kernels
LIBRARIES = ("nerf_mlp", "nerf_mlp_bwd")


class Runner(cells.TrainBkg):
    """`train_bkg` on `traffic["ranks"]` ranks; `rank` 0 (the harness's
    process) starts and commands the others."""

    timeout_s = TIMEOUT_S

    def __init__(self, cfg, traffic, seed, device, rank=0, port=None):
        if "timeout" not in inspect.signature(pmesh.maybe_init_distributed).parameters:
            raise SystemExit("the program's maybe_init_distributed takes no timeout: it cannot bound "
                             "the ranks' waits")
        device = torch.device(device)
        self.rank, self.ranks = rank, traffic["ranks"]
        self.workers, self.saved_env, self.joined, self.store = [], None, False, None
        if rank == 0:
            # rank 0 hosts the group's store from the start, as torchrun's
            # agent does, so no other socket can take its port before the
            # ranks meet there
            self.store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                                       timeout=datetime.timedelta(seconds=self.timeout_s))
            port = self.store.port
        self.port = port
        self.phase, self.deadline, self.stopping = None, None, False
        if device.type == "cuda":
            device = torch.device("cuda", rank)
            if rank == 0:
                for name in LIBRARIES:
                    _build.load(name)
        if rank == 0:
            self._start_workers(cfg, traffic, seed, device)
        try:
            super().__init__(cfg, traffic, seed, device)
            if rank == 0:
                self._collect("ready")
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------ the ranks

    def _start_workers(self, cfg, traffic, seed, device):
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=ROOT if not path else ROOT + os.pathsep + path)
        setup = json.dumps({"cfg": cfg, "traffic": traffic}) + "\n"
        self.phase, self.deadline = "set-up", time.monotonic() + self.timeout_s
        for r in range(1, self.ranks):
            self.workers.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(self.port),
                 "--seed", str(seed), "--device", device.type],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, cwd=ROOT, text=True))
        threading.Thread(target=self._watch, daemon=True).start()
        for r, p in enumerate(self.workers, 1):
            self._write(r, p, setup)

    def _watch(self):
        """Rank 0's watchdog: a worker that exits, or a phase past its
        deadline, ends the run."""
        while not self.stopping:
            for r, p in enumerate(self.workers, 1):
                if p.poll() is not None and not self.stopping:
                    self._abort(f"rank {r} exited with code {p.returncode} during {self.phase!r}")
            deadline = self.deadline
            if deadline is not None and time.monotonic() > deadline and not self.stopping:
                self._abort(f"{self.phase!r} not done by every rank within {self.timeout_s:g} s")
            time.sleep(0.1)

    def _abort(self, why):
        for p in self.workers:
            if p.poll() is None:
                p.kill()
        print(f"train_bkg_dp: {why}; every rank stopped, no result", file=sys.stderr, flush=True)
        os._exit(1)

    def _write(self, r, p, line):
        try:
            p.stdin.write(line)
            p.stdin.flush()
        except (BrokenPipeError, OSError):
            self._abort(f"rank {r} exited during {self.phase!r}")

    def _send(self, command):
        self.phase, self.deadline = command, time.monotonic() + self.timeout_s
        for r, p in enumerate(self.workers, 1):
            self._write(r, p, command + "\n")

    def _collect(self, answer):
        for r, p in enumerate(self.workers, 1):
            got = p.stdout.readline().strip()
            if got != answer:
                self._abort(f"rank {r} answered {got!r} to {self.phase!r}" if got
                            else f"rank {r} exited during {self.phase!r}")
        self.deadline = None

    def _together(self, command, fn):
        """fn() on rank 0 while every worker runs `command`; a failure of
        rank 0's ends the run as a worker's does."""
        if self.rank:
            return fn()
        self._send(command)
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            self._abort(f"rank 0 failed during {command!r}")
        self._collect("done")
        return out

    def _join(self):
        """Join the process group and build the step as the trainer does."""
        env = {"RANK": self.rank, "WORLD_SIZE": self.ranks, "LOCAL_RANK": self.rank,
               "LOCAL_WORLD_SIZE": self.ranks, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": self.port,
               "TORCHELASTIC_USE_AGENT_STORE": True, "TORCHELASTIC_RESTART_COUNT": 0}
        self.saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update({k: str(v) for k, v in env.items()})
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        self.joined = pmesh.maybe_init_distributed(backend, timeout=datetime.timedelta(seconds=self.timeout_s))
        if not self.joined:
            raise RuntimeError("a process group is up already: the cell's ranks need their own")
        mesh = pmesh.resolve_mesh(self.ncfg)
        spec = nerf_module.build_nerf_specs(self.ncfg)
        self.step_fn = make_bkg_train_step(spec, self.ncfg, self.optimizer, mesh=mesh)
        pmesh.put_replicated([self.state["params"], self.state["opt_state"]], mesh)

    def replica_gap(self):
        """The largest absolute difference, over the parameters and both
        moments, of any rank's from rank 0's (a collective of every rank)."""
        st = self.state["opt_state"]
        leaves = list(self._trained().values()) + [t for m in ("mu", "nu") for ps in st[m].values()
                                                   for t in ps.values()]
        mine = torch.cat([t.detach().reshape(-1).float() for t in leaves])
        first = mine.clone()
        dist.broadcast(first, src=0)
        gap = (mine - first).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def leave(self):
        """Stop the workers (rank 0), leave the process group and put the
        environment back."""
        self.stopping = True
        for r, p in enumerate(self.workers, 1):
            self._write(r, p, "stop\n")
        self._leave_group()
        for r, p in enumerate(self.workers, 1):
            try:
                code = p.wait(timeout=self.timeout_s)
            except subprocess.TimeoutExpired:
                self._abort(f"rank {r} did not stop within {self.timeout_s:g} s")
            if code:
                self._abort(f"rank {r} stopped with code {code}")
        self.workers, self.store = [], None

    def close(self):
        """After a failure in the set-up: kill the workers, leave the group."""
        self.stopping = True
        for p in self.workers:
            if p.poll() is None:
                p.kill()
            p.wait()
        self.workers = []
        self._leave_group()
        self.store = None

    def _leave_group(self):
        if self.joined:
            dist.destroy_process_group()
            self.joined = False
        for k, v in (self.saved_env or {}).items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.saved_env = None

    # ------------------------------------------------------------ the protocol

    def _record_first_steps(self):
        self._join()
        super()._record_first_steps()
        self.gaps = [self.replica_gap()]

    def unit(self, draw_events=None):
        self._together("unit", lambda: super(Runner, self).unit(draw_events))

    def finish_window(self):
        self._together("finish", super().finish_window)

    def check(self, control=None):
        self.gaps.append(self._together("check", self.replica_gap))
        self.leave()
        got = super().check(control)
        gap = {"replica_gap": max(self.gaps)}
        return {**got, **gap} if control is None else ({**got[0], **gap}, {**got[1], **gap})

    def work(self):
        c = self.c
        macs, params = cells._mlp_macs(c, "bkg")
        r = c["rays_per_batch"] // self.ranks
        s, i = c["samples_per_ray"], c["importance_samples_per_ray"]
        f, b = flops.mlp_work(macs, params, r * (2 * s + i), 2 * r, False, True)
        return {"nerf_mlp": (f, b), "model_flops": f, "dtype": c["compute_dtype"],
                "allreduce": collectives.bus_bytes(collectives.bkg_step_bytes(params), self.ranks)}


def _exit_with_rank_0(parent):
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(1)


def main(argv=None):
    """A worker: rank `--rank` of the cell, commanded by rank 0."""
    p = argparse.ArgumentParser(description="a worker rank of the train_bkg_dp cell")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    threading.Thread(target=_exit_with_rank_0, args=(os.getppid(),), daemon=True).start()
    torch.set_num_threads(1)
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
    setup = json.loads(sys.stdin.readline())
    runner = Runner(setup["cfg"], setup["traffic"], args.seed, args.device, rank=args.rank, port=args.port)
    ANSWER.write("ready\n")
    commands = {"unit": runner.unit, "finish": runner.finish_window, "check": runner.replica_gap}
    while True:
        command = sys.stdin.readline().strip()
        if command in ("stop", ""):
            break
        commands[command]()
        ANSWER.write("done\n")
    runner.leave()
    # the group is gone: end without the interpreter's teardown of CUDA,
    # whose faults would read as a failed rank
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
