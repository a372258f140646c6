"""Triangle-mesh queries for the warps and the signed distance (counterpart
of neuman_tpu/ops/mesh.py).

Closest point on the body mesh by vertex KNN + Ericson's test on the faces
incident to the k nearest vertices, then either the inverse of the
barycentric blend of the per-vertex LBS transforms at that point (the warp
into canonical space: plain for the render, differentiable in the vertices
and the transforms for training) or the pseudonormal sign (the signed
distance; `signed_distance(fused=True)` takes closest point and sign in one
kernel, `ericson_signed_select_tables`, which reads the candidates from the
query tables by KNN index). The candidate phase is the `ericson_select`
kernel. The KNN is
the `exact_knn` kernel for the render (the k nearest of all vertices) and
the `bucketed_knn` kernel for training (knn_impl="bucketed").
"""

from dataclasses import dataclass

import numpy as np
import torch

from neuman_tpu_torch.ops.kernels.knn import (bucketed_knn, bucketed_knn_plain, exact_knn,
                                               exact_knn_plain)
from neuman_tpu_torch.ops.kernels.meshquery import (barycentric_planar, ericson_select,
                                                     ericson_select_plain,
                                                     ericson_signed_select_tables, planar_rows)


def build_vertex_face_incidence(faces, num_verts):
    """[V, D] face indices incident to each vertex, padded with -1."""
    faces = np.asarray(faces)
    incidence = [[] for _ in range(num_verts)]
    for f_id, f in enumerate(faces):
        for v in f:
            incidence[int(v)].append(f_id)
    max_deg = max(1, max(len(lst) for lst in incidence))
    table = np.full((num_verts, max_deg), -1, dtype=np.int32)
    for v, lst in enumerate(incidence):
        table[v, : len(lst)] = lst
    return table


@dataclass
class MeshTopology:
    """Mesh connectivity on the device: faces and vertex->face incidence."""

    faces: torch.Tensor  # [F, 3] int64
    incidence: torch.Tensor  # [V, D] int64, -1 padded

    @classmethod
    def build(cls, faces, num_verts, device=None):
        faces = np.asarray(faces, dtype=np.int64)[:, :3]
        inc = build_vertex_face_incidence(faces, num_verts).astype(np.int64)
        return cls(torch.as_tensor(faces, device=device), torch.as_tensor(inc, device=device))


def stride_for(samples_per_ray, knn_stride):
    """Group-KNN stride for [R, S]-flattened ray samples: a group must not
    straddle two rays, so fall back to 1 unless S % stride == 0."""
    if knn_stride > 1 and samples_per_ray % knn_stride == 0:
        return knn_stride
    return 1


@dataclass
class QueryTables:
    """Per-mesh tables of the closest-point and signed-distance queries,
    for a mesh whose vertices are the same from query to query (the
    canonical body). Build with `build_query_tables`."""

    vtab9: torch.Tensor  # [V, D*9] corner coordinates of each vertex's incident faces
    vn_pack: torch.Tensor  # [F, 9] angle-weighted pseudonormals of each face's corners
    vntab9: torch.Tensor  # [V, D*9] those pseudonormals, laid out as vtab9
    incidence: torch.Tensor  # [V, D] int32 the incident faces' ids, -1 padded


def _incident_rows(values, topology: MeshTopology):
    """([F, 9] per-vertex `values` [V, 3] at each face's corners, [V, D*9]
    those rows for each vertex's incident faces, padding as face 0)."""
    pack = values[topology.faces].reshape(-1, 9)
    return pack, pack[topology.incidence.clamp(min=0)].reshape(values.shape[0], -1)


def build_query_tables(verts, topology: MeshTopology):
    verts = verts.detach()
    vtab9 = _incident_rows(verts, topology)[1]
    vn_pack, vntab9 = _incident_rows(angle_weighted_vertex_normals(verts, topology.faces),
                                     topology)
    return QueryTables(vtab9=vtab9, vn_pack=vn_pack, vntab9=vntab9,
                       incidence=topology.incidence.to(torch.int32).contiguous())


def angle_weighted_vertex_normals(verts, faces):
    """[V, 3] pseudonormals: the unit face normals summed into their
    corners with the corner angles as weights (the Baerentzen-Aanaes sign
    test needs these, not area weights)."""
    tri = verts[faces]  # [F, 3, 3]
    e0, e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 2]
    unit = lambda u: u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-20)
    n_unit = unit(torch.linalg.cross(e0, -e2))
    angle = lambda u, v: torch.arccos(((unit(u) * unit(v)).sum(-1)).clamp(-1.0, 1.0))
    vn = torch.zeros_like(verts)
    for j, a in enumerate((angle(e0, -e2), angle(e1, -e0), angle(e2, -e1))):
        vn = vn.index_add(0, faces[:, j], n_unit * a[:, None])
    return unit(vn)


def _query_knn(points, verts, k, knn_stride=1, knn_impl="exact", use_kernels=True):
    """k nearest vertices of each group of `knn_stride` consecutive points,
    represented by its middle point. knn_impl "exact": the `exact_knn`
    kernel, the k nearest of every vertex; "bucketed": the `bucketed_knn`
    kernel, the k nearest of 64 per-bucket winners. Each takes its plain
    version with use_kernels=False (and on CPU tensors); neither kernel
    holds the [Nq, V] scores in device memory. Returns (knn_idx [Nq, k] int64,
    stride)."""
    n_pts = points.shape[0]
    stride = knn_stride if (knn_stride > 1 and n_pts % knn_stride == 0) else 1
    q = points if stride == 1 else points.reshape(-1, stride, 3)[:, stride // 2]
    if knn_impl == "bucketed":
        knn = bucketed_knn if use_kernels else bucketed_knn_plain
        return knn(q.detach().contiguous(), verts, k)[0].long(), stride
    if knn_impl != "exact":
        raise ValueError(f"knn_impl must be 'exact' or 'bucketed', not {knn_impl!r}")
    return (exact_knn if use_kernels else exact_knn_plain)(q.detach(), verts.detach(), k), stride


def point_mesh_closest_planar(points, verts, topology: MeshTopology, k=4,
                              knn_stride=1, use_kernels=True, knn_impl="exact", tables=None):
    """points [N, 3], verts [V, 3] -> (d2 [N], f_id [N], closest (x, y, z)).

    The candidates of a point are the faces incident to the k nearest
    vertices of its group (C = k * incidence width), laid out
    coordinate-major for the kernel: rows9 [9C, Nq], cand [C, Nq]. No
    gradient reaches `verts` (the closest point and the face choice carry
    none, as in the JAX package); d2 is differentiable in `points`.
    """
    select = ericson_select if use_kernels else ericson_select_plain
    return select(*candidate_operands(points, verts, topology, k, knn_stride, knn_impl,
                                      use_kernels, tables))


def candidate_operands(points, verts, topology: MeshTopology, k=4, knn_stride=1,
                       knn_impl="exact", use_kernels=True, tables=None, normals=False):
    """The closest-point kernel's operands: (p3 [3, N], rows9 [9C, Nq],
    cand [C, Nq] int32, stride). With `tables` the corner rows come from k
    row gathers a group (vtab9) in place of C face gathers. normals=True
    gives the signed kernel's: (p3, rows9, vn9 [9C, Nq], cand, stride), vn9
    the candidates' corner pseudonormals laid out as rows9."""
    verts = verts.detach()
    knn_idx, stride = _query_knn(points, verts, k, knn_stride, knn_impl, use_kernels)
    nq = knn_idx.shape[0]
    cand = topology.incidence[knn_idx].reshape(nq, -1)  # [Nq, C]
    if tables is not None:
        rows = tables.vtab9[knn_idx]  # [Nq, k, D*9]
    else:
        rows = verts[topology.faces[cand.clamp(min=0).reshape(-1)]]  # [Nq*C, 3, 3]
    p3, cand_t = points.T.contiguous(), cand.T.to(torch.int32).contiguous()
    if not normals:
        return p3, planar_rows(rows, nq), cand_t, stride
    vntab9 = (tables.vntab9 if tables is not None else
              _incident_rows(angle_weighted_vertex_normals(verts, topology.faces), topology)[1])
    return p3, planar_rows(rows, nq), planar_rows(vntab9[knn_idx], nq), cand_t, stride


def _blend_inverse_affine(closest, f_id, verts, Ts, topology: MeshTopology):
    """Barycentric blend of the per-vertex affine transforms Ts [V(+J), 4, 4]
    at the closest points, inverted in closed form (R' = adj(R)/det,
    t' = -R' t). Returns 12 [N] columns (i00..i22, t0', t1', t2')."""
    fv = topology.faces[f_id.long()]  # [N, 3]
    corners = [tuple(verts[fv[:, j], a] for a in range(3)) for j in range(3)]
    u, v, w = barycentric_planar(closest, *corners)
    t12 = Ts.reshape(Ts.shape[0], 16)[:, :12]
    rows = [t12[fv[:, j]] for j in range(3)]  # 3 x [N, 12]
    m = [u * rows[0][:, j] + v * rows[1][:, j] + w * rows[2][:, j] for j in range(12)]
    m00, m01, m02, t0, m10, m11, m12, t1, m20, m21, m22, t2 = m
    det = (
        m00 * (m11 * m22 - m12 * m21)
        - m01 * (m10 * m22 - m12 * m20)
        + m02 * (m10 * m21 - m11 * m20)
    )
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    i00 = (m11 * m22 - m12 * m21) / det
    i01 = (m02 * m21 - m01 * m22) / det
    i02 = (m01 * m12 - m02 * m11) / det
    i10 = (m12 * m20 - m10 * m22) / det
    i11 = (m00 * m22 - m02 * m20) / det
    i12 = (m02 * m10 - m00 * m12) / det
    i20 = (m10 * m21 - m11 * m20) / det
    i21 = (m01 * m20 - m00 * m21) / det
    i22 = (m00 * m11 - m01 * m10) / det
    tp0 = -(i00 * t0 + i01 * t1 + i02 * t2)
    tp1 = -(i10 * t0 + i11 * t1 + i12 * t2)
    tp2 = -(i20 * t0 + i21 * t1 + i22 * t2)
    return (i00, i01, i02, i10, i11, i12, i20, i21, i22, tp0, tp1, tp2)


def apply_affine_cols(aff, p):
    """Apply a 12-column affine transform to an (x, y, z) column tuple."""
    (i00, i01, i02, i10, i11, i12, i20, i21, i22, t0, t1, t2) = aff
    return (
        i00 * p[0] + i01 * p[1] + i02 * p[2] + t0,
        i10 * p[0] + i11 * p[1] + i12 * p[2] + t1,
        i20 * p[0] + i21 * p[1] + i22 * p[2] + t2,
    )


def signed_distance(points, verts, topology: MeshTopology, k=4, knn_stride=1, tables=None,
                    knn_impl="exact", use_kernels=True, fused=False):
    """Signed distance to a watertight mesh, negative inside: the closest
    point (KNN + Ericson) and the sign of (p - closest) . n, n the
    barycentric blend of the face's corner pseudonormals; sign(0) = +1.
    `tables`: QueryTables when `verts` are the same from query to query.
    fused=True takes closest point and sign in one kernel
    (`ericson_signed_select_tables`; its plain version with
    use_kernels=False), which reads the candidates' corners and corner
    pseudonormals from the tables by KNN index (built here without
    `tables`); same contract.
    Returns (signed_dist [N], f_id [N], closest [N, 3])."""
    if fused:
        verts = verts.detach()
        tables = build_query_tables(verts, topology) if tables is None else tables
        knn_idx, stride = _query_knn(points, verts, k, knn_stride, knn_impl, use_kernels)
        sd, f_id, closest = ericson_signed_select_tables(
            points.T.contiguous(), knn_idx, tables.incidence, tables.vtab9, tables.vntab9,
            stride, plain=not use_kernels)
        return sd, f_id, torch.stack(closest, dim=-1)
    d2, f_id, closest = point_mesh_closest_planar(
        points, verts, topology, k=k, knn_stride=knn_stride, use_kernels=use_kernels,
        knn_impl=knn_impl, tables=tables)
    side = pseudonormal_side(points, verts, topology, f_id, closest, tables)
    sign = torch.where(side < 0, -1.0, 1.0)
    sd = sign * torch.sqrt(torch.clamp(d2, min=0.0))
    return sd, f_id, torch.stack(closest, dim=-1)


def pseudonormal_side(points, verts, topology: MeshTopology, f_id, closest, tables=None):
    """(p - closest) . n [N], n the barycentric blend of the pseudonormals of
    face f_id's corners at `closest` (an (x, y, z) tuple): negative inside."""
    verts = verts.detach()
    fv = topology.faces[f_id.long()]  # [N, 3]
    corners = [tuple(verts[fv[:, j], a] for a in range(3)) for j in range(3)]
    u, v, w = barycentric_planar(closest, *corners)
    if tables is not None:
        vrows = tables.vn_pack[f_id.long()]  # [N, 9]
    else:
        vrows = angle_weighted_vertex_normals(verts, topology.faces)[fv].reshape(-1, 9)
    normal = [u * vrows[:, a] + v * vrows[:, 3 + a] + w * vrows[:, 6 + a] for a in range(3)]
    return sum((points[:, a] - closest[a]) * normal[a] for a in range(3))


def warp_points_to_canonical_diff(pts, verts, T, topology: MeshTopology, k=4, knn_stride=1,
                                  knn_impl="exact", use_kernels=True):
    """Training-time warp: pts [N, 3] -> (can [N, 3], f_id [N]). The closest
    point and the face choice carry no gradient; the barycentric blend of
    the transforms T [V, 4, 4] is differentiable in `verts` and `T` (and so
    in the SMPL pose through LBS)."""
    _, f_id, closest = point_mesh_closest_planar(
        pts, verts, topology, k=k, knn_stride=knn_stride, use_kernels=use_kernels,
        knn_impl=knn_impl)
    closest = tuple(c.detach() for c in closest)
    aff = _blend_inverse_affine(closest, f_id, verts, T, topology)
    can = apply_affine_cols(aff, (pts[:, 0], pts[:, 1], pts[:, 2]))
    return torch.stack(can, dim=-1), f_id
