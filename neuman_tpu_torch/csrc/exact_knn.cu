// Exact vertex KNN: the k vertices of least score among all V of each query
// point, without a [Nq, V] score matrix in device memory.
//
// Replaces no TPU kernel: the JAX package takes the render warp's exact KNN
// in plain jnp (neuman_tpu/ops/mesh.py `_query_knn`: an [Nq, V] matrix
// product and `lax.top_k`, `approx_max_k` on the TPU). The port carried
// that over as an f32 GEMM, four elementwise passes and `torch.topk` over
// [8192, V] chunks in device memory; `knn.exact_knn_plain` is this
// kernel's plain twin and the CPU path.
//
// The score of vertex v for point p is |v|^2 - 2 v.p (|p|^2 is the same
// for every vertex, so it orders a point's vertices as their distances do),
// taken as three FMAs seeded with |v|^2,
//     fma(vz, qz, fma(vy, qy, fma(vx, qx, |v|^2))),  q = -2p,
// with |v|^2 = (x*x + y*y) + z*z, each step rounded once, as the bucketed
// KNN and the plain twin take it: both give the same scores bit for bit.
// Equal scores go to the lower vertex index. Each list is (score, index)
// ascending.
//
// What bounds it on the H100: instruction issue. Each (point, vertex) pair
// needs at least 3 FFMA for its score and 1 compare against the point's
// current k-th best: 4 instructions. The render's branch call holds 65,536
// queries x 6,890 vertices = 4.5e8 pairs: 0.054 ms at the card's 3.35e13
// instructions a second. The bytes (queries in, k indices out, the
// vertices) are a few MB: microseconds.
//
// Design:
// - A thread holds Q queries (4 for k <= 4, else 2) and each one's sorted
//   k-list of (score, index) in registers; a block of 128 threads holds a
//   tile of 128 Q queries.
// - The vertices are staged in shared memory, 512 at a time, as float4 rows
//   (x, y, z, |v|^2), |v|^2 taken once a vertex as it is staged. Every
//   thread of the block reads the same row (a broadcast); one LDS.128 feeds
//   Q scores.
// - A score is compared with the query's k-th best first; the insertion
//   into the sorted list is the rare branch. Vertices are scanned in index
//   order and a score enters only below the k-th best, after every entry of
//   equal score: the lower index keeps a tie.
// - The grid is (query tiles, vertex slices). At the render's 65,536
//   queries the tiles alone fill 128 blocks of 132 SMs, so the vertex axis
//   is split too, up to 8 blocks an SM (what an SM holds at 64 registers a
//   thread: one wave; 9 slices, a second wave, took 0.211 ms on the H100
//   against 8 slices' 0.191) but into slices of no fewer than 64
//   vertices. Each slice writes its k-list to a scratch row, and a
//   second small kernel merges each query's slices in order by (score,
//   index), so the result does not depend on the split. The plan (slices,
//   vertices a slice) is computed in Python (knn.exact_plan) from Nq, V
//   and the SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int STAGE = 512;  // vertices in shared memory at a time (8 KB)
constexpr int COMBINE_THREADS = 128;

// A sorted k-list: (s[0], i[0]) is the least score, the lower index first
// among equal scores. Empty slots hold (+inf, -1).
template <int K>
struct TopK {
  float s[K];
  int i[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < K; ++t) { s[t] = INFINITY; i[t] = -1; }
  }

  // Insert (cs, ci), cs < s[K - 1], after every entry of score <= cs; the
  // last entry drops out.
  __device__ __forceinline__ void insert(float cs, int ci) {
#pragma unroll
    for (int t = K - 1; t > 0; --t) {
      const bool shift = cs < s[t - 1], here = cs < s[t];
      const float ns = shift ? s[t - 1] : (here ? cs : s[t]);
      const int ni = shift ? i[t - 1] : (here ? ci : i[t]);
      s[t] = ns;
      i[t] = ni;
    }
    if (cs < s[0]) { s[0] = cs; i[0] = ci; }
  }

  __device__ __forceinline__ void offer(float cs, int ci) {
    if (cs < s[K - 1]) insert(cs, ci);
  }
};

template <int Q, int K>
__global__ void __launch_bounds__(THREADS) exact_knn_kernel(
    const float* __restrict__ pts, int p_stride, const float* __restrict__ verts,
    long long* __restrict__ idx_out, float* __restrict__ part_s, int* __restrict__ part_i, int nq,
    int num_verts, int slice_verts) {
  __shared__ float4 tab[STAGE];
  const int v0 = blockIdx.y * slice_verts;
  const int v1 = min(num_verts, v0 + slice_verts);
  float qx[Q], qy[Q], qz[Q];
  TopK<K> best[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = blockIdx.x * (THREADS * Q) + i * THREADS + threadIdx.x;
    const size_t row = (size_t)p_stride * (q < nq ? q : 0);
    qx[i] = -2.f * pts[row];
    qy[i] = -2.f * pts[row + 1];
    qz[i] = -2.f * pts[row + 2];
    best[i].init();
  }
  for (int s0 = v0; s0 < v1; s0 += STAGE) {
    const int n = min(STAGE, v1 - s0);
    __syncthreads();  // the previous stage has been read
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const size_t k = 3 * (size_t)(s0 + j);
      const float x = verts[k], y = verts[k + 1], z = verts[k + 2];
      tab[j] = make_float4(x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                              __fmul_rn(z, z)));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 v = tab[j];
#pragma unroll
      for (int i = 0; i < Q; ++i)
        best[i].offer(__fmaf_rn(v.z, qz[i], __fmaf_rn(v.y, qy[i], __fmaf_rn(v.x, qx[i], v.w))),
                      s0 + j);
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = blockIdx.x * (THREADS * Q) + i * THREADS + threadIdx.x;
    if (q >= nq) continue;
    if (gridDim.y == 1) {
#pragma unroll
      for (int t = 0; t < K; ++t) idx_out[(size_t)q * K + t] = best[i].i[t];
    } else {
      const size_t row = ((size_t)blockIdx.y * nq + q) * K;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        part_s[row + t] = best[i].s[t];
        part_i[row + t] = best[i].i[t];
      }
    }
  }
}

// Each query's k-list: its `slices` partial lists merged in slice order
// (slice s holds lower indices than slice s + 1, so an entry that ties the
// k-th best of the earlier slices stays out).
template <int K>
__global__ void __launch_bounds__(COMBINE_THREADS) exact_knn_combine_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i,
    long long* __restrict__ idx_out, int nq, int slices) {
  const int q = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (q >= nq) return;
  TopK<K> best;
  best.init();
  for (int s = 0; s < slices; ++s) {
    const size_t row = ((size_t)s * nq + q) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) best.offer(part_s[row + t], part_i[row + t]);
  }
#pragma unroll
  for (int t = 0; t < K; ++t) idx_out[(size_t)q * K + t] = best.i[t];
}

template <int Q, int K>
int launch(const float* pts, int p_stride, const float* verts, long long* idx_out, float* part_s,
           int* part_i, int nq, int num_verts, int slices, int slice_verts, cudaStream_t st) {
  const int tiles = (nq + THREADS * Q - 1) / (THREADS * Q);
  exact_knn_kernel<Q, K><<<dim3(tiles, slices), THREADS, 0, st>>>(
      pts, p_stride, verts, idx_out, part_s, part_i, nq, num_verts, slice_verts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  exact_knn_combine_kernel<K><<<(nq + COMBINE_THREADS - 1) / COMBINE_THREADS, COMBINE_THREADS,
                                0, st>>>(part_s, part_i, idx_out, nq, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [Nq, 3] f32, rows `p_stride` floats apart, each row's 3 floats
// contiguous; verts [V, 3] f32, contiguous; idx_out [Nq, k] int64; part_s,
// part_i [slices, Nq, k] f32 and int32 scratch (unused with one slice).
// 1 <= k <= 8 and k <= V; a thread holds 4 queries for k <= 4, else 2. The
// plan (knn.exact_plan): `slices` slices of `slice_verts` vertices (the
// last may hold fewer), none empty.
// Returns the cudaError_t of the launches (0 on success), -1 for a bad k or
// plan.
extern "C" int exact_knn_launch(const float* pts, int p_stride, const float* verts,
                                long long* idx_out, float* part_s, int* part_i, int nq,
                                int num_verts, int k, int slices, int slice_verts, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > 8 || num_verts < k || p_stride < 3 || slices < 1 || slice_verts < 1 ||
      slices > 65535 || (long long)slices * slice_verts < num_verts ||
      (long long)(slices - 1) * slice_verts >= num_verts || (slices > 1 && (!part_s || !part_i)))
    return -1;
  const cudaStream_t st = (cudaStream_t)stream;
#define EXACT_KNN_CASE(Q, K)                                                                \
  if (k == K)                                                                               \
    return launch<Q, K>(pts, p_stride, verts, idx_out, part_s, part_i, nq, num_verts, slices, \
                        slice_verts, st);
  EXACT_KNN_CASE(4, 1) EXACT_KNN_CASE(4, 2) EXACT_KNN_CASE(4, 3) EXACT_KNN_CASE(4, 4)
  EXACT_KNN_CASE(2, 5) EXACT_KNN_CASE(2, 6) EXACT_KNN_CASE(2, 7) EXACT_KNN_CASE(2, 8)
#undef EXACT_KNN_CASE
  return -1;
}
