"""Time the mesh-query kernels at the main path's shapes, on the GPU.

    python -m neuman_tpu_torch.tools.sweep_mesh_kernels [--plans] [--seed 0]

Run from the repo root: the timers, the ray samples and the exact KNN's
case are chip_smoke.py's (`cuda_ms_min`, `device_ms`, `_ray_samples`,
`exact_knn_case`). On the body-proxy mesh at subdivision 5 (V=10,242):
`bucketed_knn` at Nq=49,152 and 196,608 ray samples with k=4;
`ericson_select` at N=65,536 and 196,608, strides 4 and 1, C=24;
`ericson_signed_select_tables` at N=196,608, strides 4 and 1 (on the query
tables); `exact_knn` at a render branch call's Nq=65,536 on V=6,890 of the
proxy's vertices, k=4, beside the GEMM + torch.topk it replaced
(`library_ms`) and its bound. Each through its public wrapper, timed two
ways: `ms` by CUDA events (the least of 5 means of 20 calls after 20 warm-ups),
which counts the host's launch where that is the longer, and `device_ms`,
the kernel's mean device time over 20 calls by torch.profiler. Only the
wrappers' public signatures are used, so the same script times an older
checkout of the package: copy this file and chip_smoke.py into that
checkout and run it from there (a checkout older than the table form of
the signed select lacks its wrapper: time that with each tree's
`chip_smoke.py --phases signed`).

--plans also runs `ericson_select` and the table kernel with 1, 2, 4 and
8 candidate slices (`meshquery.select_plan` picks the count), and
`exact_knn` with 1, 2, 4, 8, 16 and 32 vertex slices (`knn.exact_plan`
picks the count), each held to the default plan's output (`torch.equal`).
Prints the card, then one JSON line per kernel, shape and plan (the
exact KNN's default plan as chip_smoke's `[exact_knn]` line).
"""

import argparse
import json

import torch

from chip_smoke import (_ray_samples, cuda_ms_min, device_ms, exact_knn_case,
                        exact_knn_inputs)
from neuman_tpu_torch.models.smpl import body_proxy_smpl_model
from neuman_tpu_torch.ops import mesh as mesh_ops
from neuman_tpu_torch.ops.kernels import knn as kknn
from neuman_tpu_torch.ops.kernels import meshquery as kmq
from neuman_tpu_torch.utils import card


def _report(kernel, fn, name, **fields):
    ms, dev = cuda_ms_min(fn), device_ms(fn, name)
    print(json.dumps({"kernel": kernel, **fields, "ms": round(ms, 4), "device_ms": round(dev, 4)}),
          flush=True)


def _plans(kernel, launch, name, shape):
    """`launch(plan)` with 1, 2, 4 and 8 candidate slices, each held to the
    default plan's output."""
    want = launch(None)
    default = kmq.select_plan(shape["N"], shape["C"], shape["stride"])
    for slices in (1, 2, 4, 8):
        plan = {**default, "slices": slices,
                "bounds": [s * shape["C"] // slices for s in range(slices + 1)]}
        run = lambda: launch(plan)
        equal = all(torch.equal(a, b) for a, b in zip(run(), want))
        _report(kernel, run, name, **shape, members=plan["members"], slices=slices,
                equal_default=equal)


def exact_plans(mesh_verts, gen):
    """exact_knn on chip_smoke's `exact_knn_inputs` with 1, 2, 4, 8, 16 and
    32 vertex slices, each held to the default plan's indices."""
    verts, q = exact_knn_inputs(mesh_verts, gen)
    nq, nv = q.shape[0], verts.shape[0]
    want = kknn.exact_knn(q, verts, 4)
    default = kknn.exact_plan(nq, nv, 4, torch.cuda.get_device_properties(0).multi_processor_count)
    plan_fn = kknn.exact_plan
    try:
        for slices in (1, 2, 4, 8, 16, 32):
            sv = -(-nv // slices)
            plan = {**default, "slices": -(-nv // sv), "slice_verts": sv}
            kknn.exact_plan = lambda *_, plan=plan: plan
            run = lambda: kknn.exact_knn(q, verts, 4)
            _report("exact_knn", run, ("exact_knn_kernel", "exact_knn_combine_kernel"), Nq=nq,
                    V=nv, k=4, slices=plan["slices"], default_slices=default["slices"],
                    equal_default=torch.equal(run(), want))
    finally:
        kknn.exact_plan = plan_fn


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plans", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_mesh_kernels: no CUDA device")
    device = torch.device("cuda", 0)
    print(card.smi_line())
    body = body_proxy_smpl_model(subdivisions=5, device=device)
    verts = body.v_template
    topo = mesh_ops.MeshTopology.build(body.faces, body.num_verts, device)
    gen = torch.Generator().manual_seed(args.seed)
    for nq in (49152, 196608):
        pts = _ray_samples(verts, nq // 128, 128, gen)
        _report("bucketed_knn", lambda: kknn.bucketed_knn(pts, verts, 4), "bucketed_knn",
                Nq=nq, V=verts.shape[0], k=4)
    for n in (65536, 196608):
        pts = _ray_samples(verts, n // 128, 128, gen)
        for stride in (4, 1):
            p3, rows9, cand, st = mesh_ops.candidate_operands(pts, verts, topo, k=4,
                                                              knn_stride=stride)
            shape = {"N": n, "C": cand.shape[0], "stride": st}
            _report("ericson_select", lambda: kmq.ericson_select(p3, rows9, cand, st),
                    "ericson_select_kernel", **shape)
            if args.plans:
                _plans("ericson_select", lambda plan: kmq._launch(p3, rows9, cand, st, plan=plan),
                       "ericson_select_kernel", shape)
    exact_knn_case(verts, gen)  # prints its `[exact_knn]` line
    if args.plans:
        exact_plans(verts, gen)
    pts = _ray_samples(verts, 1536, 128, gen)
    tables = mesh_ops.build_query_tables(verts, topo)
    p3 = pts.T.contiguous()
    for stride in (4, 1):
        knn_idx, st = mesh_ops._query_knn(pts, verts, 4, stride, "bucketed")
        targs = (knn_idx, tables.incidence, tables.vtab9, tables.vntab9, st)
        num_cands = knn_idx.shape[1] * tables.incidence.shape[1]
        shape = {"N": pts.shape[0], "C": num_cands, "stride": st}
        _report("ericson_signed_select", lambda: kmq.ericson_signed_select_tables(p3, *targs),
                "ericson_signed_select_kernel", **shape)
        if args.plans:
            _plans("ericson_signed_select", lambda plan: kmq._launch_signed(p3, *targs, plan=plan),
                   "ericson_signed_select_kernel", shape)


if __name__ == "__main__":
    main()
