"""The port's data parallelism (neuman_tpu_torch/parallel/) on the CPU.

Two gloo ranks, spawned once for the module (the rendezvous a file under
tmp_path, one torch thread each, a join timeout that kills the ranks),
run both train steps at the dry run's tiny widths, the human one with the
LPIPS loss on and its 32x32 patch straddling the ranks, a short
background training with validations, and checks of `resolve_mesh` and the
collectives. The same steps in this process without a mesh are the
reference, held at the JAX package's bars (tests/test_parallel.py): each
step's loss within rtol 1e-4, every parameter within atol 1e-5 after 2
steps; the ranks' parameters equal bit for bit.

Four gloo ranks, spawned once more, run the port's stage-1 step as the
trainer builds it (`make_bkg_train_step(mesh=)`, as upstream's
nn.DataParallel over four GPUs), held at the same bars to the benchmark's
plain reference (`benchmark/reference/steps.bkg_step`) over each whole
batch in this process; with and without a profiler they also record what
the mesh's collectives trace.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from benchmark import collectives, flops
from benchmark.reference import steps as steps_ref
from neuman_tpu_torch.parallel import dryrun
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.utils import tracing
from neuman_tpu_torch.utils.constants import PATCH_SIZE_SQUARED

torch.set_num_threads(1)

WORLD = 2
SPAWN_TIMEOUT_S = 300.0
KINDS = ("bkg", "human")
# upstream's DataParallel on a four-GPU host
DP4 = 4
# the configuration fields the reference's stage-1 step reads
REF_FIELDS = ("pos_N_freqs", "dir_N_freqs", "nerf_depth", "white_bkg", "margin", "samples_per_ray",
              "importance_samples_per_ray", "penalize_empty_space", "learning_rate", "lrate_decay")


class _Opt:
    def __init__(self, data_parallel, data_axis="data", rays_per_batch=64):
        self.data_parallel, self.data_axis = data_parallel, data_axis
        self.rays_per_batch = rays_per_batch


def _train_with_validations(out_dir):
    """A background trainer of 2 steps with a validation every step, on the
    rank's group: what each rank's output directory holds after it."""
    cfg = dryrun.tiny_bkg_config(out_dir, WORLD, name="trained", max_iter=2, valid_iter=1)
    trainer = dryrun.Job("bkg", cfg).trainer("cpu", "on")
    trainer.train()
    return {"iteration": trainer.iteration,
            "params": {k: p.detach().clone()
                       for k, p in dryrun.trained_parameters(trainer).items()}}


def _rank_work(jobs, out_dir):
    """Everything the module checks on a rank."""
    mesh = pmesh.resolve_mesh(_Opt("auto"))
    modes = {"auto": (mesh.rank, mesh.size)}
    on = pmesh.resolve_mesh(_Opt("on", "rays"))
    modes["on"] = (on.rank, on.size, on.axis)
    try:
        pmesh.resolve_mesh(_Opt("off"))
        modes["off"] = "no error"
    except ValueError as e:
        modes["off"] = str(e)
    try:
        pmesh.resolve_mesh(_Opt("on", rays_per_batch=63))
        modes["odd"] = "no error"
    except ValueError as e:
        modes["odd"] = str(e)
    # the gathered rows and their gradient
    rows = torch.arange(6.0).reshape(3, 2) + 10 * mesh.rank
    rows.requires_grad_(True)
    gathered = mesh.gather_rows(rows)
    (gathered * torch.arange(1.0, 13.0).reshape(6, 2)).sum().backward()
    # rank 0's tensors broadcast into every rank's
    state = {"w": torch.full((3,), float(mesh.rank)), "n": [torch.tensor(mesh.rank + 5)]}
    pmesh.put_replicated(state, mesh)
    return {"modes": modes, "gathered": gathered.detach(), "row_grad": rows.grad,
            "replicated": state, "jobs": dryrun.run_jobs(jobs, "cpu"),
            "trained": _train_with_validations(out_dir)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the unsharded results of the same jobs, the
    trained run's output directory)."""
    root = str(tmp_path_factory.mktemp("parallel"))
    jobs = [job for kind in KINDS for job in dryrun.tiny_jobs(kind, WORLD, 2, root)]
    trained_root = os.path.join(root, "trained_run")
    ranks = dryrun.spawn_ranks(WORLD, _rank_work, (jobs, trained_root),
                               timeout_s=SPAWN_TIMEOUT_S, workdir=root)
    single = dryrun.run_jobs(jobs, "cpu", "off")
    return ranks, dict(zip(KINDS, single)), os.path.join(trained_root, "trained")


def _job(ranks, kind):
    return [r["jobs"][KINDS.index(kind)] for r in ranks]


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_one_process(runs, kind):
    """Losses of 2 steps within rtol 1e-4 and every parameter within atol
    1e-5 of the unsharded steps (measured: 1.5e-7 and 3e-8)."""
    ranks, single, _ = runs
    eq = dryrun.check_bars(dryrun.compare(_job(ranks, kind), single[kind]))
    assert max(eq["grad_rel_l2"].values()) < 1e-4
    moved = [k for k, v in single[kind]["grads"].items() if float(v.abs().max()) > 0]
    assert moved


@pytest.mark.parametrize("kind", KINDS)
def test_a_steps_losses_keep_no_gradients_alive(runs, kind):
    """The losses a sharded step returns are summed over the ranks with its
    gradients in one flat all-reduce, yet hold a buffer of their own, as
    the unsharded step's do: a caller that keeps them (the benchmark keeps
    every step's loss) keeps no gradient alive."""
    ranks, single, _ = runs
    assert single[kind]["metric_bytes"] <= 64
    for r in _job(ranks, kind):
        assert r["metric_bytes"] <= 64


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_parameters_equal(runs, kind):
    ranks, _, _ = runs
    assert dryrun.compare(_job(ranks, kind), runs[1][kind])["ranks_equal"]


def test_human_step_scores_the_straddling_patch(runs):
    """The human batch's LPIPS patch (its first 1024 rays) spans both
    ranks' rows, and every loss of both steps, the perceptual one
    included, matches the unsharded step's."""
    ranks, single, _ = runs
    rays = dryrun.tiny_human_config("out", WORLD).rays_per_batch
    assert rays // WORLD < PATCH_SIZE_SQUARED < rays
    for got, want in zip(_job(ranks, "human")[0]["metrics"], single["human"]["metrics"]):
        assert want["lpips_loss"] > 0 and want["sparsity_reg"] > 0
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value, rtol=1e-4, atol=1e-7, err_msg=name)


def test_resolve_mesh_on_two_ranks(runs):
    """"auto" and "on" give this rank's place on the axis; "off" with two
    processes raises, and so does a batch that does not split over them."""
    ranks, _, _ = runs
    for rank, r in enumerate(ranks):
        assert r["modes"]["auto"] == (rank, WORLD)
        assert r["modes"]["on"] == (rank, WORLD, "rays")
        assert "each rank would run apart" in r["modes"]["off"]
        assert "63 rays does not split over 2 ranks" in r["modes"]["odd"]


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_resolve_mesh_in_one_process(mode):
    """Without a process group: "auto" and "off" give no mesh, "on" asks
    for one."""
    assert not dist.is_initialized()
    if mode == "on":
        with pytest.raises(ValueError, match="needs a process group"):
            pmesh.resolve_mesh(_Opt(mode))
    else:
        assert pmesh.resolve_mesh(_Opt(mode)) is None


def test_gather_rows_and_its_gradient(runs):
    """gather_rows gives every rank the rows in rank order, and each rank
    the gathered gradient's sum over the ranks at its own rows."""
    ranks, _, _ = runs
    want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(WORLD)])
    weights = torch.arange(1.0, 13.0).reshape(6, 2)
    for rank, r in enumerate(ranks):
        assert torch.equal(r["gathered"], want)
        assert torch.equal(r["row_grad"], WORLD * weights[3 * rank:3 * rank + 3])


def test_put_replicated_broadcasts_rank_0(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert torch.equal(r["replicated"]["w"], torch.zeros(3))
        assert int(r["replicated"]["n"][0]) == 5


def test_rank_0_alone_writes_the_outputs(runs):
    """A trainer with a validation every step on two ranks: one metrics
    record per push (not one per rank), the checkpoints and validation
    PNGs of rank 0, and the same parameters on both ranks."""
    ranks, _, out = runs
    records = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["iteration"] for r in records if not r["training"]] == [0, 1, 2]
    assert [r["iteration"] for r in records if r["training"]] == [1, 2]
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == [
        "val_00000000.png", "val_00000001.png", "val_00000002.png"]
    assert os.path.isfile(os.path.join(out, "checkpoint.npz"))
    assert all(r["trained"]["iteration"] == 2 for r in ranks)
    for k, v in ranks[0]["trained"]["params"].items():
        assert torch.equal(ranks[1]["trained"]["params"][k], v), k


def test_shards_and_draws_are_the_unsharded_rows():
    """shard_leading_axis keeps the 0-dim entries whole and gives each
    rank a contiguous block; draw_rows and sharded_draw give a rank its
    rows of the unsharded draw; an indivisible ray count raises."""
    batch = {"origin": torch.arange(24.0).reshape(8, 3), "cap_id": torch.tensor(3)}
    gen = lambda: torch.Generator().manual_seed(4)
    whole = torch.rand(8, 5, generator=gen())
    for rank in range(4):
        mesh = pmesh.DataMesh(rank, 4)
        part = pmesh.shard_leading_axis(batch, mesh)
        assert torch.equal(part["origin"], batch["origin"][2 * rank:2 * rank + 2])
        assert torch.equal(part["cap_id"], batch["cap_id"])
        g = gen()
        drawn = pmesh.draw_rows(lambda n: torch.rand(n, 5, generator=g), 2, mesh)
        assert torch.equal(drawn, whole[2 * rank:2 * rank + 2])
        g = gen()
        drawn = pmesh.sharded_draw(torch.rand, mesh)((2, 5), generator=g)
        assert torch.equal(drawn, whole[2 * rank:2 * rank + 2])
    assert pmesh.sharded_draw(torch.rand, None) is torch.rand
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_leading_axis({"origin": torch.zeros(6, 3)}, pmesh.DataMesh(0, 4))


def test_means_without_a_mesh_are_the_plain_means():
    x = torch.rand(7, 3, generator=torch.Generator().manual_seed(1))
    mask = (x > 0.5).float()
    assert torch.equal(pmesh.mean(x, None), torch.mean(x))
    assert torch.equal(pmesh.masked_mean(x, mask, None),
                       (x * mask).sum() / torch.clamp(mask.sum(), min=1.0))


def test_maybe_init_distributed(monkeypatch):
    """No launcher variables: nothing to join. NCCL with more local ranks
    than GPUs raises before it joins anything."""
    for k in ("RANK", "WORLD_SIZE", "NEUMAN_TPU_DISTRIBUTED", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert pmesh.maybe_init_distributed() is False
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cannot put two ranks of one group on one GPU"):
        pmesh.maybe_init_distributed("nccl")
    assert not dist.is_initialized()


# ---------------------------------------------------------------- four ranks


def _mesh_records():
    """The recorder's mesh spans and counters (tracing.snapshot)."""
    snap = tracing.snapshot()
    return {"spans": {k: v for k, v in snap["spans"].items() if k.startswith("mesh.")},
            "counters": {k: v for k, v in snap["counters"].items() if k.startswith("mesh.")}}


def _dp4_rank_work(out_dir, steps):
    """On each rank: a background trainer of the tiny widths with data
    parallelism on (its step is `make_bkg_train_step(mesh=)`); `steps` steps
    with no profiler, then one under a profiler. Returns the first
    parameters, each step's whole batch and global loss, the parameters and
    Adam's moments after `steps`, and what the mesh traced: the recorder
    and the host total of `mesh.collectives` after the plain steps, and the
    recorder after the profiled one."""
    cfg = dryrun.tiny_bkg_config(out_dir, DP4, name=f"dp4_{dist.get_rank()}")
    trainer = dryrun.Job("bkg", cfg).trainer("cpu", "on")
    first = {k: p.detach().clone() for k, p in dryrun.trained_parameters(trainer).items()}
    tracing.reset()
    collectives_before = tracing.total("mesh.collectives")
    batches, losses = [], []
    for _ in range(steps):
        batch = trainer.draw_batch()
        batches.append({k: v.clone() for k, v in batch.items()})
        _, metrics = trainer.step_fn(trainer.state, batch)
        losses.append(float(metrics["total_loss"]))
    loss_bytes = metrics["total_loss"].untyped_storage().nbytes()
    untraced = {"records": _mesh_records(),
                "collectives": tracing.total("mesh.collectives") - collectives_before}
    params = {k: p.detach().clone() for k, p in dryrun.trained_parameters(trainer).items()}
    moments = {f"{m}.{k}.{n}": t.clone() for m in ("mu", "nu")
               for k, ts in trainer.state["opt_state"][m].items() for n, t in ts.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.step_fn(trainer.state, trainer.draw_batch())
    traced = _mesh_records()
    tracing.reset()
    return {"first": first, "batches": batches, "losses": losses, "params": params, "moments": moments,
            "untraced": untraced, "traced": traced, "rays": cfg.rays_per_batch, "loss_bytes": loss_bytes,
            "ref_cfg": {k: getattr(cfg, k) for k in REF_FIELDS}}


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    """(the four ranks' results, the reference's losses and parameters over
    the same whole batches from the same first parameters)."""
    root = str(tmp_path_factory.mktemp("dp4"))
    ranks = dryrun.spawn_ranks(DP4, _dp4_rank_work, (root, 2), timeout_s=SPAWN_TIMEOUT_S, workdir=root)
    r0 = ranks[0]
    # the reference's leaf names: the Joiner's "nerf." left out
    w = {k.replace(".nerf.", "."): v.clone().requires_grad_(True) for k, v in r0["first"].items()}
    adam = steps_ref.Adam({k: v.detach() for k, v in w.items()})
    losses = [steps_ref.bkg_step(w, adam, b, r0["ref_cfg"], i) for i, b in enumerate(r0["batches"])]
    return ranks, {"losses": losses, "params": {k: v.detach() for k, v in w.items()}}


def test_four_ranks_match_the_unsharded_reference(dp4):
    """Each global loss within rtol 1e-4, every parameter within atol 1e-5
    of the plain reference's unsharded steps on the whole batches; the
    batch is split 4 ways and the parameters moved."""
    ranks, ref = dp4
    assert ranks[0]["rays"] % DP4 == 0 and len(ranks[0]["batches"]) == 2
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-4)
    moved = 0.0
    for k, v in ranks[0]["params"].items():
        want = ref["params"][k.replace(".nerf.", ".")]
        assert float((v - want).abs().max()) <= 1e-5, k
        moved = max(moved, float((v - ranks[0]["first"][k]).abs().max()))
    assert moved > 1e-4
    # the global loss holds the step's losses alone, not the gradients' flat sum
    assert all(r["loss_bytes"] <= 64 for r in ranks)


def test_four_ranks_replicas_are_bit_equal(dp4):
    ranks, _ = dp4
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for what in ("first", "params", "moments"):
            for k, v in ranks[0][what].items():
                assert torch.equal(r[what][k], v), (what, k)


def test_a_step_traces_its_four_collectives_under_a_profiler(dp4):
    """Span `mesh.all_reduce` and counters `mesh.collectives` and
    `mesh.all_reduce_bytes` on every rank: the two mask counts, the flat
    gradient and loss sum and the maxima, whose bytes are the yardstick's
    count from the widths (benchmark/collectives.py); no device time on the
    CPU."""
    ranks, _ = dp4
    cfg = dryrun.tiny_bkg_config("unused", DP4)
    pe = lambda n: 3 + 3 * 2 * n
    per_net = flops.mlp_params(cfg.nerf_width, cfg.nerf_depth, (4,), pe(cfg.pos_N_freqs),
                               pe(cfg.dir_N_freqs))
    assert sum(v.numel() for v in ranks[0]["params"].values()) == 2 * per_net
    for r in ranks:
        traced = r["traced"]
        assert traced["counters"] == {"mesh.collectives": 4,
                                      "mesh.all_reduce_bytes": collectives.bkg_step_bytes(per_net)}
        assert set(traced["spans"]) == {"mesh.all_reduce"}
        assert traced["spans"]["mesh.all_reduce"]["calls"] == 4
        assert traced["spans"]["mesh.all_reduce"]["device_ms"] is None


def test_collectives_record_nothing_without_a_profiler(dp4):
    """Off, the recorder holds nothing of the mesh; the int counter still
    adds to the host total, 4 a step."""
    ranks, _ = dp4
    for r in ranks:
        assert r["untraced"]["records"] == {"spans": {}, "counters": {}}
        assert r["untraced"]["collectives"] == 4 * len(r["batches"])
