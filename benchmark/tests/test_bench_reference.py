"""The plain reference against the program at small sizes on the CPU:
the body's skinning, the warp, the closest faces, the offset and canonical
networks with their gradients. The reference imports nothing of the
program; these tests hold the two side by side."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import body, inputs
from benchmark.reference import mesh as mesh_ref
from benchmark.reference import nerf as nerf_ref
from benchmark.reference import smpl as smpl_ref
from benchmark.run import BENCH
from neuman_tpu_torch.models import human_nerf as hn
from neuman_tpu_torch.models import nerf as nerf_module
from neuman_tpu_torch.models.smpl import SMPLModel
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops.kernels.nerf_mlp_vjp import nerf_mlp_fn
from neuman_tpu_torch.ops.kernels.offset_mlp import offset_mlp_fn
from neuman_tpu_torch.options.config import NeuManConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bod():
    return inputs.body("cpu")


@pytest.fixture(scope="module")
def human_cfg():
    with open(os.path.join(BENCH, "configs", "neuman-human.json")) as f:
        return json.load(f)["config"]


def _pose(gen):
    pose = torch.randn(72, generator=gen) * 0.2
    pose[:3] = 0.0
    return pose, torch.randn(10, generator=gen)


def test_body_counts_and_closed_surface():
    verts, faces = body.mesh()
    assert verts.shape == (6890, 3) and faces.shape == (13776, 3)
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    tri = verts[faces]
    assert np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() > 0  # outward
    assert np.bincount(faces.reshape(-1)).max() <= 9


def test_skinning_matches_the_program(bod):
    gen = torch.Generator().manual_seed(1)
    pose, betas = _pose(gen)
    smpl = SMPLModel.from_numpy(*(bod[k].numpy() for k in ("v_template", "shapedirs", "J_regressor",
                                                           "lbs_weights")), bod["parents"],
                                bod["faces"].numpy())
    model = type("M", (), {})()
    model.poses, model.betas = pose[None].clone().requires_grad_(True), betas[None]
    model.alignments = torch.eye(4)[None]
    vp, tp = hn.vertex_forward(model, smpl, hn.da_pose_params(24), 1.0, 0)
    pr = pose.clone().requires_grad_(True)
    vr, tr, _ = smpl_ref.da_to_posed(bod, betas, pr)
    assert torch.allclose(vp[0], vr, atol=2e-6) and torch.allclose(tp[0], tr, atol=2e-6)
    w1, w2 = torch.randn(vr.shape, generator=gen), torch.randn(tr.shape, generator=gen)
    gp = torch.autograd.grad((vp[0] * w1).sum() + (tp[0] * w2).sum(), model.poses)[0][0]
    gr = torch.autograd.grad((vr * w1).sum() + (tr * w2).sum(), pr)[0]
    assert float((gp - gr).norm() / gr.norm()) < 1e-5


@pytest.mark.parametrize("bucketed", [False, True])
def test_closest_faces_and_warp_match_the_program(bod, bucketed):
    gen = torch.Generator().manual_seed(2)
    pose, betas = _pose(gen)
    pr = pose.clone().requires_grad_(True)
    verts, ts, _ = smpl_ref.da_to_posed(bod, betas, pr)
    faces = bod["faces"]
    topo = mesh_ops.MeshTopology.build(faces.numpy(), 6890, "cpu")
    inc = mesh_ref.incidence(faces, 6890)
    assert torch.equal(inc, topo.incidence)
    pts = verts.detach()[torch.randint(0, 6890, (4096,), generator=gen)]
    pts = pts + torch.randn(4096, 3, generator=gen) * 0.05
    impl = "bucketed" if bucketed else "exact"
    d2p, fp, _ = mesh_ops.point_mesh_closest_planar(pts, verts.detach(), topo, k=4, knn_stride=4,
                                                    use_kernels=False, knn_impl=impl)
    d2r, fr, _ = mesh_ref.closest(pts, verts, faces, inc, 4, 4, bucketed)
    assert int((fp.long() != fr).sum()) <= 4 and float((d2p - d2r).abs().max()) < 1e-6
    cp, _ = mesh_ops.warp_points_to_canonical_diff(pts, verts, ts, topo, k=4, knn_stride=4,
                                                   knn_impl=impl, use_kernels=False)
    cr = mesh_ref.warp(pts, verts, ts, faces, inc, 4, 4, bucketed)
    assert float((cp - cr).abs().max()) < 1e-5
    a = torch.randn(4096, 3, generator=gen)
    gp = torch.autograd.grad((cp * a).sum(), pr, retain_graph=True)[0]
    gr = torch.autograd.grad((cr * a).sum(), pr)[0]
    assert float((gp - gr).norm() / gr.norm()) < 1e-4


def test_signed_distance_matches_the_program(bod):
    gen = torch.Generator().manual_seed(3)
    verts, faces = bod["v_template"], bod["faces"]
    topo = mesh_ops.MeshTopology.build(faces.numpy(), 6890, "cpu")
    pts = (torch.rand(4096, 3, generator=gen) - 0.5) * torch.tensor([0.6, 1.9, 0.4])
    sp = mesh_ops.signed_distance(pts, verts, topo, k=4, knn_stride=4, knn_impl="bucketed",
                                  use_kernels=False)[0]
    sr = mesh_ref.signed_distance(pts, verts, faces, mesh_ref.incidence(faces, 6890), 4, 4, True)
    assert float((sp - sr).abs().max()) < 1e-6 and bool(((sr < 0) == (sp < 0)).all())
    assert 0 < int((sr < 0).sum()) < 4096


def test_networks_and_their_gradients_match_the_program(human_cfg):
    cfg = dict(human_cfg, nerf_width=64)
    gen = torch.Generator().manual_seed(0)
    w = inputs.weights(cfg, gen, inputs.NETS)
    spec = hn.build_human_nerf_spec(NeuManConfig(nerf_width=64))
    can = nerf_module.Joiner(spec.human)
    can.nerf.load_state_dict(w["can"])
    r, s = 32, 16
    pts = (torch.rand(r, s, 3, generator=gen) - 0.5).requires_grad_(True)
    dirs = torch.nn.functional.normalize(torch.randn(r, s, 3, generator=gen), dim=-1).requires_grad_(True)
    sg, rgb = nerf_mlp_fn(spec.human, can.nerf, *pts.unbind(-1), dir_planes=list(dirs.unbind(-1)))
    sr, rr = nerf_ref.nerf(w["can"], nerf_ref.encode(pts.reshape(-1, 3), 10, "rotate"),
                           nerf_ref.encode(dirs.reshape(-1, 3), 4, "rotate"))
    assert float((sg - sr.reshape(r, s)).abs().max()) < 1e-5
    a, b = torch.randn(r, s, generator=gen), torch.randn(r, s, 3, generator=gen)
    gp = torch.autograd.grad((sg * a).sum() + (torch.stack(rgb, -1) * b).sum(), [pts, dirs])
    gr = torch.autograd.grad((sr.reshape(r, s) * a).sum() + (rr.reshape(r, s, 3) * b).sum(), [pts, dirs])
    for x, y in zip(gp, gr):
        assert float((x - y).norm() / y.norm()) < 1e-3
    off = nerf_module.OffsetNet(spec.offset)
    off.nerf.load_state_dict(w["off"])
    x4 = torch.rand(r, s, 4, generator=gen) - 0.5
    op = torch.stack(off(list(x4.unbind(-1)), 1.0, torch.float32, mlp=offset_mlp_fn), -1)
    assert float((op - nerf_ref.offset_net(w["off"], x4.reshape(-1, 4)).reshape(r, s, 3)).abs().max()) < 1e-6


def _unit(x, y):
    d = torch.tensor([x, y, 1.0], dtype=torch.float64)
    return d / d.norm()


def test_rays_whose_hit_test_turns_on_rounding_are_unsettled():
    """A ray a hair inside the outermost sphere, or grazing the front sphere
    of an occlusion edge, is unsettled; one through the middle of a sphere,
    a clean miss, and one well inside at an edge are not."""
    r = 0.1
    graze = np.arcsin(r * (1 - 1e-5) / 2.0)  # grazes the sphere at z=2, through the one at z=3
    rim = np.arcsin(r * (1 - 1e-5) / np.hypot(0.35, 3.0))  # grazes the lone sphere at y=0.35
    verts = torch.tensor([[3.0 * np.tan(graze), 0.0, 3.0], [0.0, 0.0, 2.0], [0.0, 0.35, 3.0]],
                         dtype=torch.float64)
    lone = np.arctan2(0.35, 3.0)
    dirs = torch.stack([
        _unit(0.0, 0.0),
        _unit(np.tan(graze), 0.0),
        _unit(0.0, np.tan(lone + rim)),
        _unit(0.5, 0.0),
        _unit(np.tan(np.arcsin(0.5 * r / 2.0)), 0.0),
    ])
    origins = torch.zeros_like(dirs)
    near, far = mesh_ref.near_far(origins, dirs, verts, r)
    assert bool((near[[0, 1, 2, 4]] < far[[0, 1, 2, 4]]).all()) and near[3] > far[3]
    assert mesh_ref.unsettled(origins, dirs, verts, r).tolist() == [False, True, True, False, False]
