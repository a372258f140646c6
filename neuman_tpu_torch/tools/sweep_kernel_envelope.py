"""Hold every kernel to its plain version over the shape envelope the
command lines reach, on the GPU.

    python -m neuman_tpu_torch.tools.sweep_kernel_envelope [--quick] [--seed 0]

The counterpart of tools/sweep_pallas_envelope.py, which compiles and runs
the JAX package's Pallas kernels at the candidate-count, sample-count and
dtype corners of its command lines and asks only for finite outputs. Here
each case runs a kernel through its public wrapper and its plain PyTorch
version on the same inputs, and holds the one to the other by the
comparison chip_smoke.py's phases make, one function a kernel:

- mesh kernels (`ericson_select`, `ericson_signed_select_tables`):
  `hold_closest`, d2 (or sd) and the closest point within MESH_ATOL; a
  face id may differ only where another candidate face ties within
  MESH_ATOL (`kmq.tie_gap`);
- `bucketed_knn`: `hold_knn`, scores within KNN_SCORE_ATOL, indices in
  range, and where one differs from the plain version's, the score of the
  vertex it names ties with the plain score there; the first pick an exact
  nearest vertex up to a tie; the recall of the exact top k printed;
- MLP forwards: `_fwd_compare` / `hold_offset_fwd` at `_fwd_ok`'s bars
  (f32 1e-3 absolute, bf16 5e-2 of the output scale);
- MLP backwards: `hold_grads` (f32: the largest error within 1e-3 of each
  output's largest value; bf16: L2 error within 5e-2 of the L2 norm); with
  the tape ("hbm") every gradient `torch.equal` to the recompute's.

The candidate counts C = k x incidence width: the body proxy (an
icosphere, degree 6) gives C = 24 at k = 4 and 48 at k = 8; SMPL's mesh
has vertices of degree 9, so C = 36 and 72. `degree9_mesh` builds such a
mesh from the proxy by edge flips. SMPL's V = 6,890 (not a multiple of the
KNN's 64 buckets) is taken as the first 6,890 vertices of the proxy.

Prints the card (nvidia-smi's name and power limit), then one JSON line a
case (its shape, plan, errors, `device_ms` by torch.profiler, `plain_ms`
by CUDA events, `bound_ms` and what bounds it, PASS or FAIL), then a
summary line. Exits 0 only if every case passed; a case that raises has
failed. --quick runs the cases marked quick (chip_smoke.py's phase
`envelope` runs them untimed). Run from the repo root: the timers,
`_ray_samples`, the comparisons and the bounds are chip_smoke.py's.
"""

import argparse
import dataclasses
import functools
import json
import sys
import time
import traceback

import numpy as np
import torch

from chip_smoke import (HUMAN_STEP_TOL, MESH_ATOL, _flat_grads, _fwd_compare, _fwd_ok,
                        _ray_samples, build_model, cuda_ms, device_ms, ericson_bound,
                        hold_closest, hold_grads, hold_knn, hold_offset_fwd, knn_bound, knn_exact,
                        mlp_bound, offset_bound, phase_build, signed_bound)
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from neuman_tpu_torch.ops.kernels import nerf_mlp as kmlp
from neuman_tpu_torch.ops.kernels import nerf_mlp_vjp as kvjp
from neuman_tpu_torch.ops.kernels import offset_mlp as koff
from neuman_tpu_torch.utils import card
from neuman_tpu_torch.utils.synthetic_body import synthetic_body_mesh

# the body proxy's subdivisions (V = 10,242) and SMPL's vertex count
BODY_SUBDIVISIONS = 5
SMPL_VERTS = 6890
# C -> (mesh, k): the proxy's incidence width is 6, the degree-9 mesh's 9
C_MESHES = {24: ("proxy", 4), 36: ("deg9", 4), 48: ("proxy", 8), 72: ("deg9", 8)}
# degree-9 vertices are made at least this many edges apart, so that no
# other vertex gains more than one face
DEG9_SPACING = 5
# rays of the MLP cases (the human step's 1536)
MLP_RAYS = 1536
# the gradient of d2 is 2 (p - cp) g with g in [0.5, 1.5]: cp's MESH_ATOL
# times 2 * 1.5, and the rounding of p - cp
SELECT_GRAD_ATOL = 4 * MESH_ATOL
# the warp's canonical points: the barycentric blend of the corner
# transforms at the closest point, inverted; on a face tie the blend at a
# shared edge moves by rounding only
WARP_ATOL = 1e-5
# device kernels each wrapper launches, as torch.profiler names them
KERNEL_NAMES = {
    "ericson_select": ("ericson_select_kernel",),
    "ericson_signed_select": ("ericson_signed_select_kernel",),
    "bucketed_knn": ("bucketed_knn_kernel",),
    "nerf_mlp": ("nerf_mlp_kernel",),
    "nerf_mlp_bwd": ("bwd_chain_kernel", "bwd_ddir_kernel", "dw_kernel", "dw_reduce_kernel"),
    "offset_mlp": ("offset_mlp_kernel",),
    "offset_mlp_bwd": ("offset_chain_kernel", "dw_kernel", "dw_reduce_kernel"),
}


def degree9_mesh(verts, faces, spacing=DEG9_SPACING):
    """A copy of the closed, outward-oriented triangle mesh (verts, faces)
    in which vertices of degree 6 become vertices of degree 9, SMPL's
    largest: for each, the three alternate edges of its 1-ring are flipped
    towards it (faces (v, a, b) and (b, a, d) become (v, a, d) and (v, d,
    b)), which takes one face from each of its six neighbours and gives one
    to each of the three vertices d across. A vertex is taken only if it
    and its neighbours have degree 6, no d is already its neighbour, and it
    lies `spacing` or more edges from every vertex taken before. The
    vertices stay where they are; every edge stays in two faces, with one
    orientation each. Returns (faces [F, 3] int64, the degree-9 vertices)."""
    faces = np.array(faces, dtype=np.int64)
    incident = [[] for _ in range(len(verts))]
    neighbours = [set() for _ in range(len(verts))]
    for f, (a, b, c) in enumerate(faces):
        for v, others in ((a, (b, c)), (b, (a, c)), (c, (a, b))):
            incident[v].append(f)
            neighbours[v].update(int(u) for u in others)
    degree = np.array([len(fs) for fs in incident])
    blocked = np.zeros(len(verts), bool)
    targets = []
    for v in range(len(verts)):
        if blocked[v] or degree[v] != 6 or any(degree[u] != 6 for u in neighbours[v]):
            continue
        after = {}  # ring vertex a -> (the next one b, face (v, a, b))
        for f in incident[v]:
            tri = [int(x) for x in faces[f]]
            i = tri.index(v)
            after[tri[(i + 1) % 3]] = (tri[(i + 2) % 3], f)
        ring = [next(iter(after))]
        while len(ring) < 6:
            ring.append(after[ring[-1]][0])
        flips = []
        for a, b in zip(ring[0::2], ring[1::2]):
            inner = after[a][1]
            outer = [f for f in incident[a] if f != inner and b in faces[f]]
            if len(outer) != 1:
                break
            d = [int(x) for x in faces[outer[0]] if x not in (a, b)][0]
            if d in neighbours[v]:
                break
            flips.append((inner, outer[0], a, b, d))
        if len(flips) != 3:
            continue
        for inner, outer, a, b, d in flips:
            faces[inner], faces[outer] = (v, a, d), (v, d, b)
        targets.append(v)
        near = {v}
        for _ in range(spacing - 1):
            near |= {u for w in near for u in neighbours[w]}
        blocked[list(near)] = True
    return faces, targets


@dataclasses.dataclass
class Mesh:
    verts: torch.Tensor  # [V, 3] f32
    topo: mesh_ops.MeshTopology
    tables: mesh_ops.QueryTables


class Context:
    """What the cases share: the device, a generator from the seed, the
    meshes (the body proxy at `subdivisions` and its degree-9 copy) and the
    full-width model, each built on first use; `timed` (on the card by
    default) times the kernels by the profiler over `iters` calls, the
    plain versions by CUDA events."""

    def __init__(self, device, seed=0, subdivisions=BODY_SUBDIVISIONS, model=None, iters=20,
                 timed=None):
        self.device = torch.device(device)
        self.seed = seed
        self.gen = torch.Generator().manual_seed(seed)
        self.subdivisions = subdivisions
        self.timed = self.device.type == "cuda" if timed is None else timed
        self.iters = iters
        self._model = model

    @functools.cached_property
    def meshes(self):
        verts, faces = synthetic_body_mesh(subdivisions=self.subdivisions)
        out = {}
        for name, f in (("proxy", faces), ("deg9", degree9_mesh(verts, faces)[0])):
            v = torch.tensor(verts, dtype=torch.float32, device=self.device)
            topo = mesh_ops.MeshTopology.build(f, len(verts), self.device)
            out[name] = Mesh(v, topo, mesh_ops.build_query_tables(v, topo))
        return out

    def mesh_for(self, num_cands):
        name, k = C_MESHES[num_cands]
        return self.meshes[name], k

    @property
    def model(self):
        if self._model is None:
            self._model = build_model(self.device, self.seed)
        return self._model

    def samples(self, verts, n):
        """n ray-ordered samples through the surface (rays of 128 samples
        where n allows)."""
        s = next(d for d in (128, 125, 64, 16, 8, 4, 2, 1) if n % d == 0)
        return _ray_samples(verts, n // s, s, self.gen)

    def planes(self, r, s, count):
        return [(torch.rand(r, s, generator=self.gen) * 3 - 1.5).to(self.device)
                for _ in range(count)]

    def randn(self, *shape):
        return torch.randn(*shape, generator=self.gen).to(self.device)

    def kernel_ms(self, fn, *wrappers):
        """Device ms a call of fn of the wrappers' kernels (None off the
        card)."""
        names = sum((KERNEL_NAMES[w] for w in wrappers), ())
        return device_ms(fn, names, self.iters) if self.timed else None

    def plain_ms(self, fn, iters=2):
        return cuda_ms(fn, iters=iters, warmup=0) if self.timed else None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _bound(pair):
    return {"bound_ms": pair[0], "bound_by": pair[1]}


def select_case(ctx, c, n, stride, grad=False):
    """`ericson_select` on planar operands from a mesh of C = c candidates
    (the exact KNN's k nearest vertices of each group's middle sample, their
    incident faces); grad: also d(sum(d2 g))/dp through the wrapper, the
    formula 2 (p - cp) g on the kernel's cp exactly and within
    SELECT_GRAD_ATOL of it on the plain version's."""
    mesh, k = ctx.mesh_for(c)
    pts = ctx.samples(mesh.verts, n)
    ops = mesh_ops.candidate_operands(pts, mesh.verts, mesh.topo, k=k, knn_stride=stride)
    p3, rows9, cand, st = ops
    if cand.shape[0] != c:
        raise ValueError(f"the mesh gives C={cand.shape[0]}, not {c}")
    run_k = lambda: kmq.ericson_select(*ops)
    run_p = lambda: kmq.ericson_select_plain(*ops)
    got, want = run_k(), run_p()
    ctx.sync()
    plan = kmq.select_plan(n, c, st)
    rec, ok = hold_closest(got, want, kmq.tie_gap(*ops))
    rec = {"kernel": "ericson_select", "C": c, "N": n, "stride": st,
           "members": plan["members"], "slices": plan["slices"], **rec}
    if grad:
        g = (torch.rand(n, generator=ctx.gen) + 0.5).to(ctx.device)
        q = p3.clone().requires_grad_(True)
        d2, _, cp = kmq.ericson_select(q, rows9, cand, st)
        gk = torch.autograd.grad((d2 * g).sum(), q)[0]
        formula = 2.0 * (p3 - torch.stack(cp)) * g
        grad_err = (gk - 2.0 * (p3 - torch.stack(want[2])) * g).abs().max().item()
        rec.update(grad_equal_formula=torch.equal(gk, formula), grad_max_abs_err=grad_err)
        ok = ok and rec["grad_equal_formula"] and grad_err <= SELECT_GRAD_ATOL
    rec.update(device_ms=ctx.kernel_ms(run_k, "ericson_select"), plain_ms=ctx.plain_ms(run_p),
               **_bound(ericson_bound(n, c, st)))
    return rec, ok


def signed_case(ctx, c, n, stride):
    """`ericson_signed_select_tables` on a mesh's query tables and the exact
    KNN's knn_idx (int64 at stride > 1, as the query gives it; int32 at
    stride 1, the kernel's other index type)."""
    mesh, k = ctx.mesh_for(c)
    pts = ctx.samples(mesh.verts, n)
    p3 = pts.T.contiguous()
    knn_idx, st = mesh_ops._query_knn(pts, mesh.verts, k, stride)
    if st == 1:
        knn_idx = knn_idx.to(torch.int32)
    tabs = mesh.tables
    targs = (knn_idx, tabs.incidence, tabs.vtab9, tabs.vntab9, st)
    run_k = lambda: kmq.ericson_signed_select_tables(p3, *targs)
    run_p = lambda: kmq.ericson_signed_select_tables_plain(p3, *targs)
    got, want = run_k(), run_p()
    ctx.sync()
    nq = knn_idx.shape[0]
    rows9 = kmq.planar_rows(tabs.vtab9[knn_idx], nq)
    cand = tabs.incidence[knn_idx].reshape(nq, -1).T.contiguous()
    if cand.shape[0] != c:
        raise ValueError(f"the mesh gives C={cand.shape[0]}, not {c}")
    rec, ok = hold_closest(got, want, kmq.tie_gap(p3, rows9, cand, st))
    plan = kmq.select_plan(n, c, st)
    rec = {"kernel": "ericson_signed_select", "C": c, "N": n, "stride": st,
           "D": tabs.incidence.shape[1], "k": k, "knn_idx": str(knn_idx.dtype)[6:],
           "members": plan["members"], "slices": plan["slices"], **rec,
           "inside_share": (got[0] < 0).float().mean().item(),
           "device_ms": ctx.kernel_ms(run_k, "ericson_signed_select"),
           "plain_ms": ctx.plain_ms(run_p), **_bound(signed_bound(n, knn_idx, tabs))}
    return rec, ok


def knn_case(ctx, nq, num_verts, k):
    """`bucketed_knn` of nq ray samples among the proxy's first `num_verts`
    vertices (all of them for None)."""
    verts = ctx.meshes["proxy"].verts[:num_verts].contiguous()
    pts = ctx.samples(verts, nq)
    run_k = lambda: kknn.bucketed_knn(pts, verts, k)
    run_p = lambda: kknn.bucketed_knn_plain(pts, verts, k)
    got, want = run_k(), run_p()
    ctx.sync()
    held, ok = hold_knn(verts, pts, got, want, knn_exact(verts, pts, k))
    del got, want
    on_card = ctx.device.type == "cuda"
    sms = torch.cuda.get_device_properties(ctx.device).multi_processor_count if on_card else 132
    plan = kknn.knn_plan(nq, verts.shape[0], k, sms)
    work = knn_bound(nq, verts.shape[0], k)
    rec = {"kernel": "bucketed_knn", "Nq": nq, "V": verts.shape[0], "k": k,
           "queries_a_thread": plan["queries"],
           "table": "resident" if plan["resident"] else f"staged in {plan['stages']}",
           "smem_bytes": plan["smem_bytes"], "grid": plan["grid"], **held,
           "device_ms": ctx.kernel_ms(run_k, "bucketed_knn"),
           "plain_ms": ctx.plain_ms(run_p, iters=1), **_bound(work)}
    return rec, ok


def _nerf_inputs(ctx, mode, r, s, dtype):
    """(spec, net, planes, direction kwargs): the background net with a
    direction a ray, the canonical net with one a sample."""
    spec, model = ctx.model
    if mode == "per_sample":
        d = torch.randn(3, r, s, generator=ctx.gen)
        d = (d / d.norm(dim=0, keepdim=True)).to(ctx.device)
        return (spec.human, model.coarse_human_net.nerf, ctx.planes(r, s, 3),
                {"dir_planes": [x.contiguous() for x in d]})
    net = model.coarse_bkg_net.nerf
    d = torch.randn(r, 3, generator=ctx.gen)
    d = (d / d.norm(dim=1, keepdim=True)).to(ctx.device)
    return (spec.bkg, net, ctx.planes(r, s, 3),
            {"dir_part": kmlp.dir_projection(spec.bkg, net, d, dtype)})


def _dtype_name(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


def mlp_case(ctx, s, mode, dtype, r=MLP_RAYS):
    """`nerf_mlp` at R x S in one direction mode and compute dtype."""
    spec, net, planes, kw = _nerf_inputs(ctx, mode, r, s, dtype)
    err, scale, run_k, run_p = _fwd_compare(spec, net, planes, kw, dtype)
    name = _dtype_name(dtype)
    ok = _fwd_ok(err, scale, name)
    rec = {"kernel": "nerf_mlp", "R": r, "S": s, "dirs": mode, "dtype": name,
           "max_abs_err": err, "out_scale": scale, "device_ms": ctx.kernel_ms(run_k, "nerf_mlp"),
           "plain_ms": ctx.plain_ms(run_p),
           **_bound(mlp_bound(spec, net, mode == "per_sample", r, s, name, backward=False))}
    return rec, ok


def mlp_bwd_case(ctx, s, mode, tape, dtype, r=MLP_RAYS):
    """`nerf_mlp_bwd` at R x S: the recompute's gradients against the plain
    backward's; tape "hbm": the backward reading the forward kernel's tape,
    every gradient `torch.equal` to the recompute's."""
    spec, net, planes, kw = _nerf_inputs(ctx, mode, r, s, dtype)
    cot = [ctx.randn(r, s) for _ in range(4)]
    bwd = lambda t=None, fn=kvjp.nerf_mlp_bwd: fn(spec, net, *planes, cot[0], cot[1:],
                                                  compute_dtype=dtype, tape=t, **kw)
    got, want = _flat_grads(bwd()), _flat_grads(bwd(fn=kvjp.nerf_mlp_bwd_plain))
    ctx.sync()
    name = _dtype_name(dtype)
    held, ok = hold_grads(got, want, name)
    rec = {"kernel": "nerf_mlp_bwd", "R": r, "S": s, "dirs": mode, "tape": tape, "dtype": name,
           **held}
    run_k = bwd
    if tape == "hbm":
        tape_t = kmlp.nerf_mlp(spec, net, *planes, compute_dtype=dtype, emit_tape=True, **kw)[1]
        equal = all(torch.equal(a, b) for a, b in zip(_flat_grads(bwd(tape_t)), got))
        rec["grads_equal_recompute"] = equal
        ok = ok and equal
        run_k = lambda: bwd(tape_t)
    del got, want
    rec.update(device_ms=ctx.kernel_ms(run_k, "nerf_mlp_bwd"),
               plain_ms=ctx.plain_ms(lambda: bwd(fn=kvjp.nerf_mlp_bwd_plain), iters=1),
               **_bound(mlp_bound(spec, net, mode == "per_sample", r, s, name, backward=True,
                                  tape=tape == "hbm")))
    return rec, ok


def offset_case(ctx, tape, dtype, r=MLP_RAYS, s=128):
    """`offset_mlp` and `offset_mlp_bwd` at R x S on (x, y, z, t): the
    forward against its plain version, the recompute's gradients against
    the plain backward's; tape "hbm": the forward's tape against the plain
    forward's, the backward reading it `torch.equal` to the recompute."""
    spec, model = ctx.model
    ospec, net = spec.offset, model.offset_nets[0].nerf
    axes = ctx.planes(r, s, 3) + [torch.full((r, s), 0.37, device=ctx.device)]
    cot = [ctx.randn(r, s) for _ in range(3)]
    hbm = tape == "hbm"
    fwd = lambda fn: fn(ospec, net, axes, dtype, emit_tape=hbm)
    out_k, out_p = fwd(koff.offset_mlp), fwd(koff.offset_mlp_plain)
    (out_k, tape_k), (out_p, tape_p) = (out_k, out_p) if hbm else ((out_k, None), (out_p, None))
    ctx.sync()
    name = _dtype_name(dtype)
    f_rec, f_ok = hold_offset_fwd(torch.stack(out_k), torch.stack(out_p), name)
    rec = {"kernel": "offset_mlp+offset_mlp_bwd", "R": r, "S": s, "tape": tape, "dtype": name,
           **f_rec}
    if hbm:
        t_err = (tape_k.float() - tape_p.float()).abs().max().item()
        t_ok = _fwd_ok(t_err, tape_p.float().abs().max().item(), name)
        rec.update(tape_max_abs_err=t_err)
        f_ok = f_ok and t_ok
    del tape_p
    flat = lambda out: [t for wb in out[0] for t in wb] + list(out[1])
    bwd = lambda t=None, fn=koff.offset_mlp_bwd: fn(ospec, net, axes, cot, dtype, tape=t)
    got, want = flat(bwd()), flat(bwd(fn=koff.offset_mlp_bwd_plain))
    held, b_ok = hold_grads(got, want, name)
    rec.update(fwd_ok=f_ok, **{f"bwd_{k}": v for k, v in held.items()})
    ok = f_ok and b_ok
    if hbm:
        equal = all(torch.equal(a, b) for a, b in zip(flat(bwd(tape_k)), got))
        rec["grads_equal_recompute"] = equal
        ok = ok and equal
    del got, want
    fb = offset_bound(ospec, net, r * s, name, backward=False, tape=hbm)
    bb = offset_bound(ospec, net, r * s, name, backward=True, tape=hbm)
    rec.update(fwd_device_ms=ctx.kernel_ms(lambda: fwd(koff.offset_mlp), "offset_mlp"),
               bwd_device_ms=ctx.kernel_ms(lambda: bwd(tape_k), "offset_mlp_bwd"),
               fwd_plain_ms=ctx.plain_ms(lambda: fwd(koff.offset_mlp_plain)),
               bwd_plain_ms=ctx.plain_ms(lambda: bwd(fn=koff.offset_mlp_bwd_plain), iters=1),
               fwd_bound_ms=fb[0], bwd_bound_ms=bb[0], bound_by=bb[1])
    return rec, ok


def signed_distance_case(ctx, k, n, stride=4):
    """`ops/mesh.py` `signed_distance` on the degree-9 mesh with its query
    tables and the bucketed KNN, the kernels' path against the plain path
    (use_kernels=False): sd and the closest point within MESH_ATOL; a face
    id may differ only at a tie among the kernels' path's candidates."""
    mesh = ctx.meshes["deg9"]
    pts = ctx.samples(mesh.verts, n)
    kw = dict(k=k, knn_stride=stride, tables=mesh.tables, knn_impl="bucketed")
    run = lambda kernels: mesh_ops.signed_distance(pts, mesh.verts, mesh.topo,
                                                   use_kernels=kernels, **kw)
    got, want = run(True), run(False)
    ctx.sync()
    ops = mesh_ops.candidate_operands(pts, mesh.verts, mesh.topo, k, stride, "bucketed",
                                      tables=mesh.tables)
    rec, ok = hold_closest(tuple(got[:2]) + (got[2].T,), tuple(want[:2]) + (want[2].T,),
                            kmq.tie_gap(*ops[:4]))
    rec = {"path": "signed_distance", "mesh": "deg9", "C": ops[2].shape[0], "N": n,
           "stride": ops[3], **rec, "inside_share": (got[0] < 0).float().mean().item(),
           "device_ms": ctx.kernel_ms(lambda: run(True), "bucketed_knn", "ericson_select"),
           "path_ms": ctx.plain_ms(lambda: run(True), iters=5),
           "plain_ms": ctx.plain_ms(lambda: run(False))}
    return rec, ok


def warp_case(ctx, k, n, stride=4):
    """`warp_points_to_canonical_diff` on the degree-9 mesh with the
    bucketed KNN, the kernels' path against the plain path: the canonical
    points within WARP_ATOL, and the gradients of sum(can * g) in the
    points, the vertices and the per-vertex transforms within PERF.md
    section 2's f32 bar of the poses (the face choice at a tie moves a
    point's gradient to another corner)."""
    mesh = ctx.meshes["deg9"]
    num_verts = mesh.verts.shape[0]
    pts = ctx.samples(mesh.verts, n)
    eye = torch.eye(4).expand(num_verts, 4, 4)
    jitter = torch.randn(num_verts, 4, 4, generator=ctx.gen) * 0.05
    jitter[:, 3] = 0.0
    T = (eye + jitter).to(ctx.device)
    g = ctx.randn(n, 3)

    def run(kernels):
        leaves = [x.clone().requires_grad_(True) for x in (pts, mesh.verts, T)]
        can, f_id = mesh_ops.warp_points_to_canonical_diff(
            leaves[0], leaves[1], leaves[2], mesh.topo, k=k, knn_stride=stride,
            knn_impl="bucketed", use_kernels=kernels)
        return can.detach(), f_id, torch.autograd.grad((can * g).sum(), leaves)

    (can, f_id, grads), (pcan, pf, pgrads) = run(True), run(False)
    ctx.sync()
    err = (can - pcan).abs().max().item()
    bar = HUMAN_STEP_TOL["float32"][1]["poses"]
    l2 = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item() for a, b in zip(grads, pgrads))
    g_ok = l2 <= bar and all(bool(torch.isfinite(a).all()) for a in grads)
    rec = {"path": "warp_points_to_canonical_diff", "mesh": "deg9",
           "C": k * mesh.topo.incidence.shape[1], "N": n,
           "stride": stride, "max_abs_err": err, "f_id_diff": int((f_id != pf).sum()),
           "grad_l2_rel_err": l2, "grad_bar": bar,
           "device_ms": ctx.kernel_ms(lambda: run(True), "bucketed_knn", "ericson_select"),
           "path_ms": ctx.plain_ms(lambda: run(True), iters=5),
           "plain_ms": ctx.plain_ms(lambda: run(False))}
    return rec, err <= WARP_ATOL and g_ok and bool(torch.isfinite(can).all())


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    run: object  # run(ctx) -> (fields, ok)
    quick: bool = False


def cases():
    """Every case of the full run; those marked quick make --quick."""
    out = []
    add = lambda name, fn, quick=False, **kw: out.append(
        Case(name, functools.partial(fn, **kw), quick))
    for c, n, quick in ((24, 262144, False), (36, 262144, True), (48, 262144, False),
                        (72, 262144, True), (48, 3000, False)):
        add(f"ericson_select C={c} N={n} stride=1", select_case, quick, c=c, n=n, stride=1)
    for c, n, st in ((24, 196608, 4), (36, 196608, 4), (48, 262144, 4), (72, 262144, 4),
                     (24, 196608, 8)):
        add(f"ericson_select C={c} N={n} stride={st}", select_case, c=c, n=n, stride=st)
    for c in (24, 72):
        for st in (1, 4):
            add(f"ericson_select grad C={c} N=196608 stride={st}", select_case, c=c, n=196608,
                stride=st, grad=True)
    for c in (24, 48, 36, 72):
        for st in (1, 4):
            add(f"ericson_signed_select_tables C={c} N=196608 stride={st}", signed_case,
                c == 36, c=c, n=196608, stride=st)
    for nq, v, k in ((49152, None, 4), (4096, SMPL_VERTS, 8), (196608, SMPL_VERTS, 8),
                     (196608, None, 4)):
        vname = v or "all"
        add(f"bucketed_knn Nq={nq} V={vname} k={k}", knn_case, (nq, v, k) == (196608, 6890, 8),
            nq=nq, num_verts=v, k=k)
    for s in (16, 32, 64, 128, 256):
        for mode in ("per_ray", "per_sample"):
            for dtype in (torch.bfloat16,) + ((torch.float32,) if s == 128 else ()):
                add(f"nerf_mlp S={s} dirs={mode} {_dtype_name(dtype)}", mlp_case, s == 16,
                    s=s, mode=mode, dtype=dtype)
    for s in (64, 128):
        for mode in ("per_ray", "per_sample"):
            for tape in ("recompute", "hbm"):
                for dtype in (torch.float32, torch.bfloat16):
                    add(f"nerf_mlp_bwd S={s} dirs={mode} tape={tape} {_dtype_name(dtype)}",
                        mlp_bwd_case, s=s, mode=mode, tape=tape, dtype=dtype)
    for tape in ("recompute", "hbm"):
        for dtype in (torch.float32, torch.bfloat16):
            add(f"offset_mlp S=128 tape={tape} {_dtype_name(dtype)}", offset_case, tape=tape,
                dtype=dtype)
    for k in (4, 8):
        add(f"signed_distance deg9 k={k} N=196608", signed_distance_case, k=k, n=196608)
    add("warp_points_to_canonical_diff deg9 k=4 N=196608", warp_case, k=4, n=196608)
    return out


def run_cases(selected, ctx):
    """Run each case, print its JSON line, then the summary; returns the
    names of the cases that failed."""
    failed, t0 = [], time.perf_counter()
    for case in selected:
        t = time.perf_counter()
        try:
            rec, ok = case.run(ctx)
        except Exception as e:  # a case that raises has failed; the sweep goes on
            traceback.print_exc()
            rec, ok = {"error": f"{type(e).__name__}: {e}".splitlines()[0][:300]}, False
        if not ok:
            failed.append(case.name)
        print(json.dumps({"case": case.name, "status": "PASS" if ok else "FAIL", **rec,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"sweep": "FAILED" if failed else "OK", "cases": len(selected),
                      "failed": failed, "seconds": time.perf_counter() - t0}), flush=True)
    return failed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true", help="only the cases marked quick")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_kernel_envelope: no CUDA device; this sweep runs on the GPU only",
              file=sys.stderr)
        return 2
    print(card.smi_line(), flush=True)
    phase_build()  # every library, in parallel, with each kernel's ptxas report
    ctx = Context(torch.device("cuda", 0), args.seed, iters=5 if args.quick else 20)
    selected = [c for c in cases() if c.quick or not args.quick]
    return 1 if run_cases(selected, ctx) else 0


if __name__ == "__main__":
    sys.exit(main())
