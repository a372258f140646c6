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
// operands their d2, closest point and face id are equal bit for bit.
//
// One thread per query point n. Its group g = n / stride shares one
// candidate set with the stride-1 points next to it (group-KNN). The thread
// loops over the C candidates, reading the nine corner coordinates from the
// coordinate-major rows9 [9C, Nq] (row j*C + ci, column g: neighbouring
// threads read neighbouring columns), runs the region test and keeps the
// first minimum (strict <, the JAX earliest-candidate tie-break).
// Candidates with face id < 0 count as +inf; candidate 0 is taken first
// unconditionally so an all-invalid set returns candidate 0, as in JAX.
//
// What bounds it on the H100: the rows9/cand reads, 40 bytes per candidate
// per group (~2 KB per group at C = 48), read once per member; the region
// test is ~60 FLOPs per candidate. The design streams each candidate once
// through registers and writes 5 words per point; no shared memory.
//
// Build with --fmad=false: every a*b+c then rounds twice, exactly as the
// plain PyTorch version's separate elementwise ops do, so region decisions
// on an edge and the selected face agree with it bit for bit.
//
// The signed kernel adds, for the selected candidate, the barycentric
// weights (u, v, w) of the closest point and the dot of (p - closest) with
// the blend u na + v nb + w nc of the corner pseudonormals (vn9, laid out as
// rows9); sd = (dot < 0 ? -1 : 1) * sqrt(max(d2, 0)). The TPU kernel
// evaluates that dot for all C candidates as [C, TN] planes and mask-reduces
// the winner's; a thread here evaluates it only when a candidate becomes the
// running minimum, so the nine normal rows of the other candidates are
// never read: the same operations on the winner, hence the same sign. The
// sign at |dot| ~ 0 hangs on the last bit, and --fmad=false keeps it the
// plain version's. Bound by bytes: rows9 + vn9 + cand are 76 bytes a
// candidate and group (1,824 at C = 24) against ~100 FLOPs.

#include <cuda_runtime.h>
#include <math.h>

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

__global__ void ericson_select_kernel(const float* __restrict__ p3,
                                      const float* __restrict__ rows9,
                                      const int* __restrict__ cand,
                                      float* __restrict__ d2_out,
                                      int* __restrict__ fid_out,
                                      float* __restrict__ cp_out, int n,
                                      int nq, int num_cands, int stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / stride;
  const float px = p3[i], py = p3[n + i], pz = p3[2 * (size_t)n + i];
  const size_t plane = (size_t)num_cands * nq;  // one coordinate's block

  float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
  int best_f = 0;
  for (int ci = 0; ci < num_cands; ++ci) {
    const int f = cand[(size_t)ci * nq + g];
    const float* r = rows9 + (size_t)ci * nq + g;
    const float ax = r[0], ay = r[plane], az = r[2 * plane];
    const float bx_ = r[3 * plane], by_ = r[4 * plane], bz_ = r[5 * plane];
    const float cx = r[6 * plane], cy = r[7 * plane], cz = r[8 * plane];

    float ox, oy, oz;
    ericson_closest(px, py, pz, ax, ay, az, bx_, by_, bz_, cx, cy, cz, ox, oy, oz);
    const float ex = ox - px, ey = oy - py, ez = oz - pz;
    const float dist2 = f >= 0 ? ex * ex + ey * ey + ez * ez : INFINITY;
    if (ci == 0 || dist2 < best) {
      best = dist2;
      best_f = f > 0 ? f : 0;
      bx = ox; by = oy; bz = oz;
    }
  }
  d2_out[i] = best;
  fid_out[i] = best_f;
  cp_out[i] = bx;
  cp_out[n + i] = by;
  cp_out[2 * (size_t)n + i] = bz;
}

__global__ void ericson_signed_select_kernel(const float* __restrict__ p3,
                                             const float* __restrict__ rows9,
                                             const float* __restrict__ vn9,
                                             const int* __restrict__ cand,
                                             float* __restrict__ sd_out,
                                             int* __restrict__ fid_out,
                                             float* __restrict__ cp_out, int n,
                                             int nq, int num_cands, int stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / stride;
  const float px = p3[i], py = p3[n + i], pz = p3[2 * (size_t)n + i];
  const size_t plane = (size_t)num_cands * nq;

  float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f, best_dot = 0.f;
  int best_f = 0;
  for (int ci = 0; ci < num_cands; ++ci) {
    const int f = cand[(size_t)ci * nq + g];
    const float* r = rows9 + (size_t)ci * nq + g;
    const float ax = r[0], ay = r[plane], az = r[2 * plane];
    const float bx_ = r[3 * plane], by_ = r[4 * plane], bz_ = r[5 * plane];
    const float cx = r[6 * plane], cy = r[7 * plane], cz = r[8 * plane];
    float ox, oy, oz;
    ericson_closest(px, py, pz, ax, ay, az, bx_, by_, bz_, cx, cy, cz, ox, oy, oz);
    const float ex = ox - px, ey = oy - py, ez = oz - pz;
    const float dist2 = f >= 0 ? ex * ex + ey * ey + ez * ez : INFINITY;
    if (ci == 0 || dist2 < best) {
      best = dist2;
      best_f = f > 0 ? f : 0;
      bx = ox; by = oy; bz = oz;
      // barycentric weights of the closest point (cross / dot formulation)
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
      const float* m = vn9 + (size_t)ci * nq + g;
      const float mx = u * m[0] + v * m[3 * plane] + w * m[6 * plane];
      const float my = u * m[plane] + v * m[4 * plane] + w * m[7 * plane];
      const float mz = u * m[2 * plane] + v * m[5 * plane] + w * m[8 * plane];
      best_dot = (px - ox) * mx + (py - oy) * my + (pz - oz) * mz;
    }
  }
  const float dist = sqrtf(fmaxf(best, 0.f));
  sd_out[i] = best_dot < 0.f ? -dist : dist;
  fid_out[i] = best_f;
  cp_out[i] = bx;
  cp_out[n + i] = by;
  cp_out[2 * (size_t)n + i] = bz;
}

}  // namespace

// p3 [3, N] f32; rows9 [9C, N/stride] f32; cand [C, N/stride] int32.
// Writes d2 [N] f32, f_id [N] int32, cp [3, N] f32 on `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ericson_select_launch(const float* p3, const float* rows9,
                                     const int* cand, float* d2, int* f_id,
                                     float* cp, int n, int num_cands,
                                     int stride, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  ericson_select_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p3, rows9, cand, d2, f_id, cp, n, n / stride, num_cands, stride);
  return (int)cudaGetLastError();
}

// As above plus vn9 [9C, N/stride] f32, the corner pseudonormals laid out as
// rows9. Writes sd [N] f32 (signed distance), f_id [N] int32, cp [3, N] f32.
extern "C" int ericson_signed_select_launch(const float* p3, const float* rows9,
                                            const float* vn9, const int* cand,
                                            float* sd, int* f_id, float* cp, int n,
                                            int num_cands, int stride, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  ericson_signed_select_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p3, rows9, vn9, cand, sd, f_id, cp, n, n / stride, num_cands, stride);
  return (int)cudaGetLastError();
}
