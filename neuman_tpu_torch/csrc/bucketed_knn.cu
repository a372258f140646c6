// Bucketed vertex KNN: the k best of B per-bucket nearest vertices of each
// query point, without a [Nq, V] score matrix in global memory.
//
// Replaces neuman_tpu/ops/pallas/meshquery.py `bucketed_knn_pallas` (kernel
// body :488, pallas_call :505) together with the top-k of bucket winners
// that its wrapper takes outside the kernel. Vertex i lies in bucket i % B
// (interleaved, so that neighbours on the mesh fall into different buckets).
// The score of vertex v for point p is |v|^2 - 2 v.p (|p|^2 is the same for
// every vertex), taken as the chain
//     fma(vz, -2 pz, fma(vy, -2 py, vx * -2 px)) + |v|^2
// with explicit roundings, the operations of the plain PyTorch version, so
// that both pick the same vertex unless two scores are within a rounding of
// each other. Per bucket: the least score and the earliest position that
// reaches it. Then the k best buckets, ties to the lower bucket, and the
// clamp min(index, V - 1) for buckets that hold only padding.
//
// Design: one thread per query point, 128 points a block. The vertex table
// arrives bucket-major ([B, VB] rows of (x, y, z, |v|^2), padding rows
// (0, 0, 0, 1e30)) and is staged through shared memory in tiles of whole
// buckets (or parts of one, when a bucket is larger than a tile); every
// thread of a block reads the same table entry at the same time, a
// shared-memory broadcast of one float4. A thread keeps the running best of
// the current bucket and a sorted k-entry list in registers. Work: Nq x
// V_pad scores of ~6 operations; the table is re-read from L2 by every
// block, never from device memory. Bound by f32 issue, not by bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 2048;  // table entries staged at a time (32 KB)

template <int K>
__global__ void __launch_bounds__(THREADS) bucketed_knn_kernel(
    const float* __restrict__ pts, const float4* __restrict__ vtab, int* __restrict__ idx_out,
    float* __restrict__ score_out, int nq, int num_verts, int buckets, int vb) {
  __shared__ float4 tile[TILE];
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool live = q < nq;
  const float qx = live ? -2.f * pts[3 * (size_t)q] : 0.f;
  const float qy = live ? -2.f * pts[3 * (size_t)q + 1] : 0.f;
  const float qz = live ? -2.f * pts[3 * (size_t)q + 2] : 0.f;
  float ts[K];
  int ti[K];
#pragma unroll
  for (int i = 0; i < K; ++i) { ts[i] = INFINITY; ti[i] = 0; }

  // nb whole buckets a tile when a bucket fits, else one bucket in jt-entry parts
  const int nb = vb <= TILE ? TILE / vb : 1;
  const int jt = vb <= TILE ? vb : TILE;
  float best = INFINITY;
  int pos = 0;
  for (int b0 = 0; b0 < buckets; b0 += nb) {
    const int nbc = min(nb, buckets - b0);
    for (int j0 = 0; j0 < vb; j0 += jt) {
      const int jn = min(jt, vb - j0);
      __syncthreads();
      for (int e = threadIdx.x; e < nbc * jn; e += THREADS) {
        const int bb = e / jn, jj = e % jn;
        tile[e] = vtab[(size_t)(b0 + bb) * vb + j0 + jj];
      }
      __syncthreads();
      for (int bb = 0; bb < nbc; ++bb) {
        if (j0 == 0) { best = INFINITY; pos = 0; }
        const float4* row = tile + bb * jn;
        for (int jj = 0; jj < jn; ++jj) {
          const float4 v = row[jj];
          const float s = __fadd_rn(
              __fmaf_rn(v.z, qz, __fmaf_rn(v.y, qy, __fmul_rn(v.x, qx))), v.w);
          if (s < best) { best = s; pos = j0 + jj; }
        }
        if (j0 + jn >= vb) {
          // insert (best, index) after every entry with a score <= best
          float cs = best;
          int ci = pos * buckets + b0 + bb;
          bool moved = false;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            if (moved || cs < ts[i]) {
              const float fs = ts[i]; ts[i] = cs; cs = fs;
              const int fi = ti[i]; ti[i] = ci; ci = fi;
              moved = true;
            }
          }
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      idx_out[(size_t)q * K + i] = min(ti[i], num_verts - 1);
      score_out[(size_t)q * K + i] = ts[i];
    }
  }
}

}  // namespace

// pts [Nq, 3] f32; vtab [B, VB, 4] f32 (bucket-major, see above); idx_out
// [Nq, k] int32; score_out [Nq, k] f32; 1 <= k <= 8, k <= B.
// Returns the cudaError_t of the launch (0 on success), -1 for a bad k.
extern "C" int bucketed_knn_launch(const float* pts, const float* vtab, int* idx_out,
                                   float* score_out, int nq, int num_verts, int buckets,
                                   int vb, int k, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > 8 || k > buckets) return -1;
  const int blocks = (nq + THREADS - 1) / THREADS;
  const cudaStream_t st = (cudaStream_t)stream;
  const float4* tab = reinterpret_cast<const float4*>(vtab);
  switch (k) {
#define KNN_CASE(K)                                                                     \
  case K:                                                                               \
    bucketed_knn_kernel<K><<<blocks, THREADS, 0, st>>>(pts, tab, idx_out, score_out, nq, \
                                                       num_verts, buckets, vb);         \
    break;
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6) KNN_CASE(7)
    KNN_CASE(8)
#undef KNN_CASE
  }
  return (int)cudaGetLastError();
}
