// Closest point over per-point candidate triangles (Ericson, RTCD 5.1.5),
// without and with the pseudonormal sign.
//
// `ericson_select_kernel` replaces neuman_tpu/ops/pallas/meshquery.py
// `_kernel` (called through `_ericson_select_impl` :314 and
// `ericson_select_pallas` :390), the candidate phase of the warps'
// closest-point query. `ericson_signed_select_kernel` replaces
// `_signed_kernel` (:119, through `_signed_select_impl` :191 and
// `ericson_signed_select_pallas` :276), the fused signed-distance query.
// Both call one device function for the region test, so on the same
// candidates their d2, closest point and face id are equal bit for bit.
//
// Operands of `ericson_select_kernel`: p3 [3, N]; rows9 [9C, Nq]
// coordinate-major (row j*C + ci, column g: coordinate j of candidate ci of
// group g); cand [C, Nq] face ids, -1 = invalid; `stride` consecutive
// points form one group (group-KNN) and share its C candidates. Result per
// point (both kernels): the first candidate with the least d2 (strict <,
// the JAX earliest-candidate tie-break); invalid candidates count as +inf;
// an all-invalid group returns candidate 0.
//
// What bounds `ericson_select` on the H100: the rows9/cand reads, 40 bytes a
// candidate and group, against ~60 f32 operations a candidate and point; the
// operands mostly come from L2, written just before by the gather.
// Its design:
// - Members folded into one thread: a thread takes M consecutive points of
//   one group (M = 4, 2 or 1, the largest that divides the stride), loads
//   each candidate's nine corners and face id once and runs the region test
//   for its M points, kept in registers (the TPU kernel's [C, TN] planes
//   read them once per point).
// - Coalesced: consecutive lanes take consecutive units of M points, so a
//   warp reads 128 contiguous bytes of each rows9 / cand row.
// - Candidates split across threads: the C candidates go in S contiguous
//   slices (S from N and C: 2 at least where C >= 12, two slices beat one
//   on the card even with a full grid; doubled, up to 8 and no slice under
//   6 candidates, until 131,072 threads are in flight; 1 for C < 12).
//   Slice 0 takes its first candidate unconditionally, as the sequential
//   scan takes candidate 0; the other slices keep their first candidate
//   with d2 below +inf. Slice 0's thread merges the others' results in
//   slice order through shared memory with the same strict <: the first
//   candidate with the least d2, bit for bit the sequential result. The
//   plan (M, S, the slice bounds) is made in
//   Python (meshquery.select_plan) and passed to the launch.
// - A unit's M results are consecutive: one 16-byte store (M = 4) of each
//   output row.
//
// Build with --fmad=false: every a*b+c then rounds twice, exactly as the
// plain PyTorch version's separate elementwise ops do, so region decisions
// on an edge and the selected face agree with it bit for bit.
//
// `ericson_signed_select_kernel` reads its candidates straight from the
// mesh's query tables by KNN index: knn [N/stride, k] (int32 or int64, as
// the KNN gives it), incidence [V, D] face ids, the corners of each
// vertex's D incident faces (vtab9 [V, 9D]) and their corner pseudonormals
// (vntab9 [V, 9D]). Candidate ci = j*D + d
// of group g is face incidence[knn[g, j], d], the order in which the TPU
// path lays out its planes, so the earliest-candidate tie-break picks the
// same face. The TPU kernel cannot gather: it takes [9C, Nq] planes of
// corners and of pseudonormals built by XLA, and so did this kernel's first
// version; building them (two [9C, Nq] f32 permuted gathers, 170 MB each
// at N=196,608 stride 1) cost 10-30x the kernel. The tables (2.2 MB each
// for the body proxy) stay in L2. Its design:
// - ericson_select_kernel's: M points a thread, the candidates in S
//   slices (one KNN vertex's D faces, a contiguous table row, at C = 24
//   stride 4) merged in slice order with the same strict <; the region test
//   for every candidate, the same device function.
// - The sign once a point, after the merge, for the winner only: the
//   merged winners go back through shared memory and member m of a unit
//   goes to its slice m % S, which reloads the winner's nine corners and
//   nine pseudonormals and takes the barycentric weights (u, v, w) of the
//   closest point, the blend u na + v nb + w nc and its dot with
//   p - closest: the plain version's operations on the selected candidate,
//   hence its sign; sd = (dot < 0 ? -1 : 1) * sqrt(max(d2, 0)).
// The sign at |dot| ~ 0 hangs on the last bit, and --fmad=false keeps it
// the plain version's. What bounds it on the H100: the region test, as
// ericson_select's (IEEE divisions, divergent regions), ~60 operations a
// candidate and point against ~2.3 loads for 4 points (one face id and
// nine corners, scalar: an entry sits at byte 36 d of its row, and the
// lanes' rows are scattered, but the tables stay in L1 and L2). At N =
// 196,608, C = 24 it takes within ~7% of ericson_select on the same
// candidates' planes at stride 4 and ~25% less at stride 1, whose planes
// (170 MB) come from device memory; a padded [V, D, 12] table with 16-byte
// loads was 3-7% faster, too little to keep a second copy of the table.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float safe_den(float d) {
  return fabsf(d) < 1e-20f ? 1e-20f : d;
}

// Closest point (ox, oy, oz) to p on the triangle a, b, c. Region priority:
// vertices, then edges, then the face.
__device__ __forceinline__ void ericson_closest(
    float px, float py, float pz, float ax, float ay, float az, float bx_, float by_,
    float bz_, float cx, float cy, float cz, float& ox, float& oy, float& oz) {
  const float abx = bx_ - ax, aby = by_ - ay, abz = bz_ - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float bpx = px - bx_, bpy = py - by_, bpz = pz - bz_;
  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;

  if (d1 <= 0.f && d2 <= 0.f) {  // vertex a
    ox = ax; oy = ay; oz = az;
  } else if (d3 >= 0.f && d4 <= d3) {  // vertex b
    ox = bx_; oy = by_; oz = bz_;
  } else if (d6 >= 0.f && d5 <= d6) {  // vertex c
    ox = cx; oy = cy; oz = cz;
  } else if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {  // edge ab
    const float v = d1 / safe_den(d1 - d3);
    ox = ax + v * abx; oy = ay + v * aby; oz = az + v * abz;
  } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {  // edge ac
    const float w = d2 / safe_den(d2 - d6);
    ox = ax + w * acx; oy = ay + w * acy; oz = az + w * acz;
  } else if (va <= 0.f && (d4 - d3) >= 0.f && (d5 - d6) >= 0.f) {  // edge bc
    const float w = (d4 - d3) / safe_den((d4 - d3) + (d5 - d6));
    ox = bx_ + w * (cx - bx_); oy = by_ + w * (cy - by_); oz = bz_ + w * (cz - bz_);
  } else {  // face interior
    const float denom = safe_den(va + vb + vc);
    const float v = vb / denom, w = vc / denom;
    ox = (ax + v * abx) + w * acx;
    oy = (ay + v * aby) + w * acy;
    oz = (az + v * abz) + w * acz;
  }
}

constexpr int SELECT_THREADS = 256;
constexpr int MAX_SLICES = 8;

struct SlicePlan {
  int bounds[MAX_SLICES + 1];  // slice s: candidates [bounds[s], bounds[s + 1])
};

// M consecutive values of a unit: one vector access for M = 4 or 2.
template <int M, typename T>
__device__ __forceinline__ void load_unit(const T* __restrict__ src, int u, T (&v)[M]) {
  if constexpr (M == 4) {
    using V4 = typename std::conditional<std::is_same<T, int>::value, int4, float4>::type;
    const V4 x = reinterpret_cast<const V4*>(src)[u];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (M == 2) {
    using V2 = typename std::conditional<std::is_same<T, int>::value, int2, float2>::type;
    const V2 x = reinterpret_cast<const V2*>(src)[u];
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = src[u];
  }
}

template <int M, typename T>
__device__ __forceinline__ void store_unit(T* __restrict__ dst, int u, const T (&v)[M]) {
  if constexpr (M == 4) {
    using V4 = typename std::conditional<std::is_same<T, int>::value, int4, float4>::type;
    V4 x;
    x.x = v[0]; x.y = v[1]; x.z = v[2]; x.w = v[3];
    reinterpret_cast<V4*>(dst)[u] = x;
  } else if constexpr (M == 2) {
    using V2 = typename std::conditional<std::is_same<T, int>::value, int2, float2>::type;
    V2 x;
    x.x = v[0]; x.y = v[1];
    reinterpret_cast<V2*>(dst)[u] = x;
  } else {
    dst[u] = v[0];
  }
}

// One thread per (unit of M points, candidate slice); SELECT_THREADS / S
// units a block, slice s in threads [s * units, (s + 1) * units).
template <int M>
__global__ void __launch_bounds__(SELECT_THREADS) ericson_select_kernel(
    const float* __restrict__ p3, const float* __restrict__ rows9, const int* __restrict__ cand,
    float* __restrict__ d2_out, int* __restrict__ fid_out, float* __restrict__ cp_out, int n,
    int nq, int num_cands, int stride, int slices, SlicePlan plan) {
  // the results of slices 1..S-1: [5 fields][M][(slice - 1) * units + unit]
  __shared__ float merge[5][M][SELECT_THREADS];
  const int units_per_block = SELECT_THREADS / slices;
  const int s = threadIdx.x / units_per_block, ul = threadIdx.x % units_per_block;
  const int u = blockIdx.x * units_per_block + ul;
  const bool live = u < n / M;
  const int g = live ? u * M / stride : 0;
  const size_t plane = (size_t)num_cands * nq;  // one coordinate's block

  float px[M], py[M], pz[M];
  if (live) {
    load_unit<M>(p3, u, px);
    load_unit<M>(p3 + n, u, py);
    load_unit<M>(p3 + 2 * (size_t)n, u, pz);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) px[m] = py[m] = pz[m] = 0.f;
  }
  float best[M], bx[M], by[M], bz[M];
  int best_f[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    best[m] = INFINITY; bx[m] = by[m] = bz[m] = 0.f; best_f[m] = 0;
  }
  const int c0 = plan.bounds[s], c1 = plan.bounds[s + 1];
  for (int ci = c0; live && ci < c1; ++ci) {
    const int f = cand[(size_t)ci * nq + g];
    const float* r = rows9 + (size_t)ci * nq + g;
    const float ax = r[0], ay = r[plane], az = r[2 * plane];
    const float bx_ = r[3 * plane], by_ = r[4 * plane], bz_ = r[5 * plane];
    const float cx = r[6 * plane], cy = r[7 * plane], cz = r[8 * plane];
    const bool first = s == 0 && ci == c0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float ox, oy, oz;
      ericson_closest(px[m], py[m], pz[m], ax, ay, az, bx_, by_, bz_, cx, cy, cz, ox, oy, oz);
      const float ex = ox - px[m], ey = oy - py[m], ez = oz - pz[m];
      const float dist2 = f >= 0 ? ex * ex + ey * ey + ez * ez : INFINITY;
      if (first || dist2 < best[m]) {
        best[m] = dist2;
        best_f[m] = f > 0 ? f : 0;
        bx[m] = ox; by[m] = oy; bz[m] = oz;
      }
    }
  }
  if (slices > 1) {
    if (s > 0) {
      const int at = (s - 1) * units_per_block + ul;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        merge[0][m][at] = best[m];
        merge[1][m][at] = __int_as_float(best_f[m]);
        merge[2][m][at] = bx[m]; merge[3][m][at] = by[m]; merge[4][m][at] = bz[m];
      }
    }
    __syncthreads();
    if (s > 0) return;
    for (int o = 1; o < slices; ++o) {
      const int at = (o - 1) * units_per_block + ul;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float d = merge[0][m][at];
        if (d < best[m]) {
          best[m] = d;
          best_f[m] = __float_as_int(merge[1][m][at]);
          bx[m] = merge[2][m][at]; by[m] = merge[3][m][at]; bz[m] = merge[4][m][at];
        }
      }
    }
  }
  if (!live) return;
  store_unit<M>(d2_out, u, best);
  store_unit<M>(fid_out, u, best_f);
  store_unit<M>(cp_out, u, bx);
  store_unit<M>(cp_out + n, u, by);
  store_unit<M>(cp_out + 2 * (size_t)n, u, bz);
}

// The nine floats of table entry e (a face's corners or its corner
// normals): scalar loads, the entry at byte 36 d of its row.
__device__ __forceinline__ void load_face(const float* __restrict__ tab, size_t e,
                                          float (&t)[9]) {
  const float* q = tab + e * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) t[i] = __ldg(q + i);
}

// The sign of the selected candidate ci of one point, and the point's
// outputs: the candidate's corners and corner normals reloaded, the
// barycentric weights of the closest point o (cross / dot formulation), the
// blend u na + v nb + w nc and its dot with p - o; the operations of
// meshquery._select_plain on the selected candidate, in its order.
template <typename Idx>
__device__ __forceinline__ void signed_point(
    float px, float py, float pz, int ci, float d2, float ox, float oy, float oz,
    const Idx* __restrict__ kg, const int* __restrict__ incidence,
    const float* __restrict__ vtab9, const float* __restrict__ vntab9, int deg, size_t i,
    int n, float* __restrict__ sd_out, int* __restrict__ fid_out,
    float* __restrict__ cp_out) {
  const int j = ci / deg;
  const size_t e = (size_t)kg[j] * deg + (ci - j * deg);
  const int f = __ldg(incidence + e);
  float t[9], nm[9];
  load_face(vtab9, e, t);
  load_face(vntab9, e, nm);
  const float ax = t[0], ay = t[1], az = t[2], bx_ = t[3], by_ = t[4], bz_ = t[5];
  const float cx = t[6], cy = t[7], cz = t[8];
  const float e1x = bx_ - ax, e1y = by_ - ay, e1z = bz_ - az;
  const float e2x = cx - ax, e2y = cy - ay, e2z = cz - az;
  const float nx = e1y * e2z - e1z * e2y, ny = e1z * e2x - e1x * e2z,
              nz = e1x * e2y - e1y * e2x;
  const float denom = safe_den(nx * nx + ny * ny + nz * nz);
  const float bcx = cx - bx_, bcy = cy - by_, bcz = cz - bz_;
  const float qbx = ox - bx_, qby = oy - by_, qbz = oz - bz_;
  const float ux = bcy * qbz - bcz * qby, uy = bcz * qbx - bcx * qbz,
              uz = bcx * qby - bcy * qbx;
  const float u = (nx * ux + ny * uy + nz * uz) / denom;
  const float cax = ax - cx, cay = ay - cy, caz = az - cz;
  const float qcx = ox - cx, qcy = oy - cy, qcz = oz - cz;
  const float vx = cay * qcz - caz * qcy, vy = caz * qcx - cax * qcz,
              vz = cax * qcy - cay * qcx;
  const float v = (nx * vx + ny * vy + nz * vz) / denom;
  const float w = 1.0f - u - v;
  const float mx = u * nm[0] + v * nm[3] + w * nm[6];
  const float my = u * nm[1] + v * nm[4] + w * nm[7];
  const float mz = u * nm[2] + v * nm[5] + w * nm[8];
  const float dot = (px - ox) * mx + (py - oy) * my + (pz - oz) * mz;
  const float dist = sqrtf(fmaxf(d2, 0.f));
  sd_out[i] = dot < 0.f ? -dist : dist;
  fid_out[i] = f > 0 ? f : 0;
  cp_out[i] = ox;
  cp_out[n + i] = oy;
  cp_out[2 * (size_t)n + i] = oz;
}

// One thread per (unit of M points, candidate slice), as
// ericson_select_kernel, on table operands: candidate ci = j * deg + d of
// group g is face incidence[row, d], row = knn[g, j], its corners at entry
// row * deg + d of vtab9. After the merge the winners go through shared
// memory to the unit's S threads, member m to slice m % S, which compute
// the sign.
template <int M, typename Idx>
__global__ void __launch_bounds__(SELECT_THREADS) ericson_signed_select_kernel(
    const float* __restrict__ p3, const Idx* __restrict__ knn, const int* __restrict__ incidence,
    const float* __restrict__ vtab9, const float* __restrict__ vntab9, float* __restrict__ sd_out,
    int* __restrict__ fid_out, float* __restrict__ cp_out, int n, int k, int deg, int stride,
    int slices, SlicePlan plan) {
  // the results of slices 1..S-1: [5 fields][M][(slice - 1) * units + unit];
  // after the merge the winners at [field][m][unit]
  __shared__ float merge[5][M][SELECT_THREADS];
  const int units_per_block = SELECT_THREADS / slices;
  const int s = threadIdx.x / units_per_block, ul = threadIdx.x % units_per_block;
  const int u = blockIdx.x * units_per_block + ul;
  const bool live = u < n / M;
  const int g = live ? u * M / stride : 0;
  const Idx* __restrict__ kg = knn + (size_t)g * k;

  float px[M], py[M], pz[M];
  if (live) {
    load_unit<M>(p3, u, px);
    load_unit<M>(p3 + n, u, py);
    load_unit<M>(p3 + 2 * (size_t)n, u, pz);
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) px[m] = py[m] = pz[m] = 0.f;
  }
  float best[M], bx[M], by[M], bz[M];
  int best_c[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    best[m] = INFINITY; bx[m] = by[m] = bz[m] = 0.f; best_c[m] = 0;
  }
  const int c0 = plan.bounds[s], c1 = plan.bounds[s + 1];
  int j = c0 / deg, d = c0 - j * deg;
  size_t row = live ? (size_t)kg[j] * deg : 0;
  for (int ci = c0; live && ci < c1; ++ci) {
    const size_t e = row + d;
    const int f = __ldg(incidence + e);
    float t[9];
    load_face(vtab9, e, t);
    const bool first = s == 0 && ci == c0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float ox, oy, oz;
      ericson_closest(px[m], py[m], pz[m], t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8],
                      ox, oy, oz);
      const float ex = ox - px[m], ey = oy - py[m], ez = oz - pz[m];
      const float dist2 = f >= 0 ? ex * ex + ey * ey + ez * ez : INFINITY;
      if (first || dist2 < best[m]) {
        best[m] = dist2;
        best_c[m] = ci;
        bx[m] = ox; by[m] = oy; bz[m] = oz;
      }
    }
    if (++d == deg && ci + 1 < c1) {
      d = 0;
      row = (size_t)kg[++j] * deg;
    }
  }
  if (slices > 1) {
    if (s > 0) {
      const int at = (s - 1) * units_per_block + ul;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        merge[0][m][at] = best[m];
        merge[1][m][at] = __int_as_float(best_c[m]);
        merge[2][m][at] = bx[m]; merge[3][m][at] = by[m]; merge[4][m][at] = bz[m];
      }
    }
    __syncthreads();
    if (s == 0) {
      for (int o = 1; o < slices; ++o) {
        const int at = (o - 1) * units_per_block + ul;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float dd = merge[0][m][at];
          if (dd < best[m]) {
            best[m] = dd;
            best_c[m] = __float_as_int(merge[1][m][at]);
            bx[m] = merge[2][m][at]; by[m] = merge[3][m][at]; bz[m] = merge[4][m][at];
          }
        }
      }
      // the winners, over slice 1's results of this unit (read just above)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        merge[0][m][ul] = best[m];
        merge[1][m][ul] = __int_as_float(best_c[m]);
        merge[2][m][ul] = bx[m]; merge[3][m][ul] = by[m]; merge[4][m][ul] = bz[m];
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      best[m] = merge[0][m][ul];
      best_c[m] = __float_as_int(merge[1][m][ul]);
      bx[m] = merge[2][m][ul]; by[m] = merge[3][m][ul]; bz[m] = merge[4][m][ul];
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (m % slices != s) continue;
    signed_point(px[m], py[m], pz[m], best_c[m], best[m], bx[m], by[m], bz[m], kg, incidence,
                 vtab9, vntab9, deg, (size_t)u * M + m, n, sd_out, fid_out, cp_out);
  }
}

// Checks a plan (meshquery.select_plan) and copies its bounds into `plan`:
// members 1, 2 or 4 dividing the stride, 1 <= slices <= 8 dividing the
// block, 0 = bounds[0] < ... < bounds[slices] = C.
bool make_plan(int n, int num_cands, int stride, int members, int slices, const int* bounds,
               SlicePlan& plan) {
  if (stride < 1 || n % stride || (members != 1 && members != 2 && members != 4) ||
      stride % members || slices < 1 || slices > MAX_SLICES || SELECT_THREADS % slices ||
      bounds[0] != 0 || bounds[slices] != num_cands)
    return false;
  plan = {};
  for (int i = 0; i <= slices; ++i) {
    if (i > 0 && bounds[i] <= bounds[i - 1]) return false;
    plan.bounds[i] = bounds[i];
  }
  return true;
}

template <int M, typename Idx>
void signed_launch(int blocks, cudaStream_t st, const float* p3, const void* knn,
                   const int* incidence, const float* vtab9, const float* vntab9, float* sd,
                   int* f_id, float* cp, int n, int k, int deg, int stride, int slices,
                   const SlicePlan& plan) {
  ericson_signed_select_kernel<M, Idx><<<blocks, SELECT_THREADS, 0, st>>>(
      p3, static_cast<const Idx*>(knn), incidence, vtab9, vntab9, sd, f_id, cp, n, k, deg,
      stride, slices, plan);
}

}  // namespace

// p3 [3, N] f32; rows9 [9C, N/stride] f32; cand [C, N/stride] int32.
// Writes d2 [N] f32, f_id [N] int32, cp [3, N] f32 on `stream`. The plan
// (meshquery.select_plan): `members` points a thread (1, 2 or 4, dividing
// the stride; the pointers 4 x members-byte aligned), `slices` candidate
// slices (1, 2, 4 or 8) with bounds[0..slices], 0 = bounds[0] < ... <
// bounds[slices] = C. Returns the cudaError_t of the launch (0 on
// success), -1 for a bad plan.
extern "C" int ericson_select_launch(const float* p3, const float* rows9,
                                     const int* cand, float* d2, int* f_id,
                                     float* cp, int n, int num_cands,
                                     int stride, int members, int slices,
                                     const int* bounds, void* stream) {
  if (n == 0) return 0;
  SlicePlan plan;
  if (!make_plan(n, num_cands, stride, members, slices, bounds, plan)) return -1;
  const int units_per_block = SELECT_THREADS / slices;
  const int blocks = (n / members + units_per_block - 1) / units_per_block;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nq = n / stride;
  if (members == 4)
    ericson_select_kernel<4><<<blocks, SELECT_THREADS, 0, st>>>(
        p3, rows9, cand, d2, f_id, cp, n, nq, num_cands, stride, slices, plan);
  else if (members == 2)
    ericson_select_kernel<2><<<blocks, SELECT_THREADS, 0, st>>>(
        p3, rows9, cand, d2, f_id, cp, n, nq, num_cands, stride, slices, plan);
  else
    ericson_select_kernel<1><<<blocks, SELECT_THREADS, 0, st>>>(
        p3, rows9, cand, d2, f_id, cp, n, nq, num_cands, stride, slices, plan);
  return (int)cudaGetLastError();
}

// The fused signed distance on table operands: p3 [3, N] f32; knn [N/stride,
// k] int32 (idx64 = 0) or int64 (idx64 = 1), the k nearest vertices of each
// group; incidence [V, deg] int32 face ids, -1 = padding; vtab9 [V, deg * 9]
// f32 the corners of each vertex's incident faces, vntab9 [V, deg * 9] f32
// their corner pseudonormals. Candidate ci = j * deg + d (C = k * deg).
// Writes sd [N] f32 (signed distance), f_id [N] int32, cp [3, N] f32 on
// `stream`; the plan as ericson_select_launch's, over the C candidates.
// Returns the cudaError_t of the launch (0 on success), -1 for a bad plan.
extern "C" int ericson_signed_select_launch(const float* p3, const void* knn, int idx64,
                                            const int* incidence, const float* vtab9,
                                            const float* vntab9, float* sd, int* f_id, float* cp,
                                            int n, int k, int deg, int stride, int members,
                                            int slices, const int* bounds, void* stream) {
  if (n == 0) return 0;
  SlicePlan plan;
  if (!make_plan(n, k * deg, stride, members, slices, bounds, plan)) return -1;
  const int units_per_block = SELECT_THREADS / slices;
  const int blocks = (n / members + units_per_block - 1) / units_per_block;
  using Launch = void (*)(int, cudaStream_t, const float*, const void*, const int*, const float*,
                         const float*, float*, int*, float*, int, int, int, int, int,
                         const SlicePlan&);
  static const Launch launches[3][2] = {{signed_launch<1, int>, signed_launch<1, long long>},
                                        {signed_launch<2, int>, signed_launch<2, long long>},
                                        {signed_launch<4, int>, signed_launch<4, long long>}};
  launches[members == 4 ? 2 : members - 1][idx64 != 0](
      blocks, (cudaStream_t)stream, p3, knn, incidence, vtab9, vntab9, sd, f_id, cp, n, k, deg,
      stride, slices, plan);
  return (int)cudaGetLastError();
}
