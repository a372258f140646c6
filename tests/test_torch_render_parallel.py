"""The port's renders on N ranks (the renderers' `mesh=`, the render
command lines and the trainers' validation renders under a process group)
on the CPU.

Two gloo ranks, spawned once for the module (the rendezvous a file under
tmp_path, one torch thread each, a join timeout that kills the ranks), run
`parallel/dryrun.py`'s RenderJobs: the four renderers at the tiny widths on
a 16x16 capture of the body proxy at subdivision 1 (`render_smpl_nerf`
posed and canonical, two actors), a chunk size the ranks do not divide,
`render_test_views.main` on `tools/synthetic_scene.py`'s scene, and each
trainer's validation. This process runs the same jobs without a mesh: the
reference, held at the JAX package's sharded-render bars
(tests/test_parallel.py: rgb 1e-5, depth 1e-4 for render_vanilla and the
multi-person render, 1e-5 for the others). One hybrid frame of the ranks
is also held to the JAX package's `render_hybrid_nerf(mesh=make_mesh(8))`
on the same weights, at tests/test_torch_render.py's bars.

The ranks import this module: JAX is imported in the tests alone, so that
the ranks run the port without it.
"""

import os

import numpy as np
import pytest
import torch

from neuman_tpu_torch import convert
from neuman_tpu_torch.parallel import dryrun
from neuman_tpu_torch.parallel import mesh as pmesh
from neuman_tpu_torch.trainers import checkpoint as ckpt

torch.set_num_threads(1)

WORLD = 2
SPAWN_TIMEOUT_S = 300.0
TINY_RENDERS = ("vanilla", "hybrid", "smpl", "smpl_can", "multi")
ODD_CHUNK = 51  # 16 x 16 rays in chunks that 2 ranks do not divide
TINY_FLAGS = ["--nerf_depth", "2", "--nerf_width", "32", "--pos_N_freqs", "4",
              "--pos_max_freq", "3", "--dir_N_freqs", "2", "--dir_max_freq", "1",
              "--samples_per_ray", "8", "--importance_samples_per_ray", "8"]
VIEWS_FLAGS = ["--render_h", "24", "--render_w", "32", "--rays_per_batch", "256"]
VAL_KINDS = ("bkg", "human")


class _Opt:
    def __init__(self, data_parallel, rays_per_batch=64):
        self.data_parallel, self.data_axis = data_parallel, "data"
        self.rays_per_batch = rays_per_batch


def _resolve_modes(device, mesh):
    """resolve_render_mesh on a rank: "auto", "off" and an indivisible
    rays_per_batch (None in one process)."""
    if mesh is None:
        return None
    modes = {"auto": pmesh.resolve_render_mesh(_Opt("auto")).size,
             "odd": pmesh.resolve_render_mesh(_Opt("on", rays_per_batch=63)).size}
    try:
        pmesh.resolve_render_mesh(_Opt("off"))
        modes["off"] = "no error"
    except ValueError as e:
        modes["off"] = str(e)
    return modes


def _validation(device, mesh, kind, out_dir):
    """One validation of a tiny trainer of stage `kind` (every rank joins
    its render); returns the iteration."""
    config = {"bkg": dryrun.tiny_bkg_config, "human": dryrun.tiny_human_config}[kind]
    cfg = config(out_dir, WORLD, name=f"val_{kind}", penalize_lpips=0.0)
    trainer = dryrun.Job(kind, cfg).trainer(device, "on" if mesh is not None else "off")
    trainer.validate()
    return trainer.iteration


def _held(eq):
    """eq, asserted free of render_faults."""
    faults = dryrun.render_faults(eq)
    assert not faults, faults
    return eq


def _port_checkpoint(path, seed=1):
    """tiny_render_scene's HumanNeRF (TINY widths) saved as a human-stage
    checkpoint in the JAX layout."""
    model = dryrun.tiny_render_scene("cpu", seed)[1]
    ckpt.save_checkpoint(path, {"hybrid_model": convert.to_jax_params(model.state_dict())})
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{job name: compare_renders dict} of every job on two ranks."""
    from neuman_tpu_torch.tools import synthetic_scene

    root = str(tmp_path_factory.mktemp("render_parallel"))
    before = os.environ.get("NEUMAN_DATA_ROOT")
    os.environ["NEUMAN_DATA_ROOT"] = os.path.join(root, "data")  # the spawned ranks inherit it
    try:
        scene_dir = synthetic_scene.build_synthetic_scene(root)
        weights = _port_checkpoint(os.path.join(root, "human.npz"))
        work = os.path.join(root, "render_cwd")
        os.makedirs(work)
        views = ["--scene_dir", scene_dir, "--weights_path", weights, *TINY_FLAGS, *VIEWS_FLAGS]
        jobs = [dryrun.RenderJob(w, dryrun.tiny_render, (w,)) for w in TINY_RENDERS]
        jobs += [dryrun.RenderJob("unsharded", dryrun.tiny_render, ("vanilla", ODD_CHUNK)),
                 dryrun.RenderJob("test_views", dryrun.command_line,
                                  ("render_test_views", views), work),
                 dryrun.RenderJob("resolve", _resolve_modes)]
        # each process validates into ./out of its own working directory
        jobs += [dryrun.RenderJob(f"val_{k}", _validation, (k, "out")) for k in VAL_KINDS]
        eqs = dryrun.render_equality(WORLD, jobs, timeout_s=SPAWN_TIMEOUT_S)
    finally:
        if before is None:
            os.environ.pop("NEUMAN_DATA_ROOT", None)
        else:
            os.environ["NEUMAN_DATA_ROOT"] = before
    return {job.name: eq for job, eq in zip(jobs, eqs)}


@pytest.mark.parametrize("what", TINY_RENDERS)
def test_two_ranks_render_the_one_process_frame(runs, what):
    """Every renderer's frame on two ranks equals one process's at the JAX
    package's bars; both ranks hold it; each ran the human branch on its
    share of the hit rays (the union of two actors' for "multi")."""
    eq = _held(runs[what])
    assert eq["hw"] == [16, 16] and not any(eq["warnings"])
    if what != "vanilla":
        rays = eq["human_rays"]
        assert all(r > 0 for r in rays) and sum(rays) >= eq["single_human_rays"] > 0
        assert max(rays) < eq["single_human_rays"]


def test_smpl_hit_list_splits_evenly(runs):
    """render_smpl_nerf splits each chunk of the hit list over the ranks:
    an odd hit count is padded by one repeated ray."""
    eq = runs["smpl"]
    rays = eq["human_rays"]
    assert rays[0] == rays[1] == -(-eq["single_human_rays"] // WORLD)


def test_indivisible_chunk_warns_unsharded(runs):
    """A chunk size the ranks do not divide warns "UNSHARDED" on every rank
    and gives the one-process pixels."""
    eq = _held(runs["unsharded"])
    assert eq["bit_equal"]
    for caught in eq["warnings"]:
        assert any("UNSHARDED" in w for w in caught), caught


def test_render_test_views_on_two_ranks(runs):
    """render_test_views.main: rank 0 alone writes the PNGs, byte for byte
    one process's, and every rank returns the same scores."""
    eq = _held(runs["test_views"])
    assert eq["renderers"] == ["render_hybrid_nerf"] and eq["hw"] == [24, 32]
    assert eq["pngs_written"] == [1, 0] and eq["single_pngs"] == 1
    scores = eq["single_returned"]
    assert np.isfinite(scores["psnr"]) and np.isfinite(scores["ssim"])
    assert all(r == scores for r in eq["returned"])


@pytest.mark.parametrize("kind", VAL_KINDS)
def test_validation_renders_on_two_ranks(runs, kind):
    """Each trainer's validation under two ranks: every rank joins the
    render (the background one, the canonical human one), rank 0 alone
    writes its PNGs, byte for byte one process's, and no rank hangs."""
    eq = _held(runs[f"val_{kind}"])
    want = {"bkg": ["render_vanilla"], "human": ["render_smpl_nerf"]}[kind]
    assert eq["renderers"] == want
    pngs = {"bkg": 1, "human": 4}[kind]
    assert eq["pngs_written"] == [pngs, 0] and eq["single_pngs"] == pngs
    assert eq["returned"] == [0, 0]


def test_resolve_render_mesh_on_two_ranks(runs):
    """"auto" and "on" give a mesh over both ranks whatever rays_per_batch
    (the renderer warns instead); "off" with two processes raises."""
    for modes in runs["resolve"]["returned"]:
        assert modes["auto"] == WORLD and modes["odd"] == WORLD
        assert "each rank would run apart" in modes["off"]


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_resolve_render_mesh_in_one_process(mode):
    if mode == "on":
        with pytest.raises(ValueError, match="needs a process group"):
            pmesh.resolve_render_mesh(_Opt(mode))
    else:
        assert pmesh.resolve_render_mesh(_Opt(mode, rays_per_batch=63)) is None


class _StubMesh(pmesh.DataMesh):
    """A DataMesh whose all_gather is every rank's buffer, given."""

    def gather_rows(self, t):
        return torch.cat(self.buffers)


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("total,chunk", [(256, 64), (225, 64), (7, 12), (1, 8)])
def test_chunk_rows_gather_is_the_frame(size, total, chunk):
    """Each rank's rows of every chunk (the last padded by its last ray),
    gathered, give the frame's rows in order; every rank holds as many
    rows, within its chunk, also as positions within it; without a mesh the
    rows are each chunk's slice of the frame."""
    frame = torch.arange(total * 2.0).reshape(total, 2)
    buffers, locals_ = [], set()
    for rank in range(size):
        rows = pmesh.ChunkRows(total, chunk, pmesh.DataMesh(rank, size))
        buf = torch.empty(rows.local, 2)
        for src, dst, whole, local in rows:
            assert whole.start <= int(src.min()) and int(src.max()) < whole.stop
            assert torch.equal(frame[whole][local], frame[src])
            buf[dst] = frame[src]
        buffers.append(buf)
        locals_.add(rows.local)
    assert len(locals_) == 1
    mesh = _StubMesh(0, size)
    mesh.buffers = buffers
    (got,) = pmesh.ChunkRows(total, chunk, mesh).gather(buffers[0])
    assert torch.equal(got, frame)
    plain = pmesh.ChunkRows(total, chunk)
    assert plain.local == total
    want = [slice(i, min(i + chunk, total)) for i in range(0, total, chunk)]
    assert [(src, whole, local) for src, _, whole, local in plain] == [
        (w, w, slice(0, w.stop - w.start)) for w in want]


def test_two_rank_hybrid_matches_jax_mesh_render(runs):
    """The ranks' hybrid frame against the JAX package's
    render_hybrid_nerf(mesh=make_mesh(8)) on the same weights and capture,
    at tests/test_torch_render.py's bars: >= 40 dB, the same hit pixels,
    depth within 1e-3."""
    from neuman_tpu.models import human_nerf as jhn
    from neuman_tpu.options.config import NeuManConfig as JaxConfig
    from neuman_tpu.parallel.mesh import make_mesh
    from neuman_tpu.render import renderer as jrenderer

    spec, model, cap, verts, faces, ts = dryrun.tiny_render_scene("cpu", 0)
    jspec = jhn.build_human_nerf_spec(JaxConfig(pe_recurrence=False, **dryrun.TINY))
    params = convert.to_jax_params(model.state_dict())
    ref_rgb, ref_depth, ref_acc = jrenderer.render_hybrid_nerf(
        jspec, params, cap, verts, faces, ts, rays_per_batch=64,
        samples_per_ray=dryrun.TINY["samples_per_ray"],
        importance_samples_per_ray=dryrun.TINY["importance_samples_per_ray"],
        geo_threshold=0.3, knn_k=4, knn_stride=4, compute_dtype_name="float32",
        return_acc=True, dispatch="compact", use_pallas=False, mesh=make_mesh(8))
    ((_, (rgb, depth, acc)),) = runs["hybrid"]["calls"]
    hit = ref_acc > 0
    assert 0.05 < hit.mean() < 0.95
    mse = float(np.mean((rgb.numpy() - ref_rgb) ** 2))
    assert -10.0 * np.log10(max(mse, 1e-12)) >= 40.0
    np.testing.assert_array_equal(acc.numpy() > 0, hit)
    np.testing.assert_allclose(depth.numpy(), ref_depth, rtol=1e-3, atol=1e-3)
