// Bucketed vertex KNN: the k best of B = 64 per-bucket nearest vertices of
// each query point, without a [Nq, V] score matrix in global memory.
//
// Replaces neuman_tpu/ops/pallas/meshquery.py `bucketed_knn_pallas` (kernel
// body :488, pallas_call :505) together with the top-k of bucket winners
// that its wrapper takes outside the kernel. Vertex i lies in bucket i % 64
// (interleaved, so that neighbours on the mesh fall into different buckets).
// The score of vertex v for point p is |v|^2 - 2 v.p (|p|^2 is the same for
// every vertex), taken as three FMAs seeded with |v|^2,
//     fma(vz, qz, fma(vy, qy, fma(vx, qx, |v|^2))),  q = -2p,
// with |v|^2 = (x*x + y*y) + z*z, every step rounded as the plain PyTorch
// version rounds it, so both give the same scores bit for bit. Per bucket:
// the least score and the earliest position that reaches it. Then the k best
// buckets, ties to the lower bucket, and the clamp min(index, V - 1) for
// buckets that hold only padding.
//
// What bounds it on the H100: instruction issue. Nq x V_pad scores
// (V_pad = 64 x VB, VB = ceil(V / 64) rounded up to 8) of 3 FFMA and 1
// FMNMX each; the bytes (points, vertices, results) are a few MB.
//
// Design:
// - The kernel builds the bucket-major table itself from verts [V, 3] into
//   shared memory: (x, y, z, |v|^2) entries, padding (0, 0, 0, 1e30), each
//   bucket a row of VB entries plus one unused entry, so that rows of
//   neighbouring buckets start in different banks. While the whole table
//   fits (V_pad x 16 B <= 227 KB: V <= 14,336) it stays resident in
//   persistent blocks, one an SM, built once; each warp walks over its own
//   tiles of queries. A larger table is staged in groups of whole buckets
//   (or, past 116k vertices, parts of 8 buckets) for each block tile of
//   queries. The plan (resident or grouped, group, part, bytes, grid) is
//   computed in Python (knn.knn_plan).
// - A warp's 32 lanes are 4 query lanes x 8 bucket slices: slice s holds
//   buckets s, s + 8, ..., s + 56. Each lane holds Q query points (4 for
//   k <= 4, else 2; 4 beat 2 at k = 4 on the card); one LDS.128 of a table
//   entry feeds Q scores, and the 8 slices read 8
//   distinct float4 in 8 distinct bank groups.
// - The scan keeps only the least score of each chunk of 8 entries (FMNMX)
//   and, per chunk, whether it lowered the bucket's least score (strict <,
//   so the earliest chunk that reaches the least score is kept). After a
//   bucket the lane inserts (least score, chunk, bucket) into each query's
//   sorted k-list (ties to the earlier bucket).
// - The 8 slices' k-lists merge by warp shuffles on (score, bucket), the
//   lower bucket first on equal scores. Then the 8 lanes rescan the chosen
//   chunk of each of the k buckets, one entry a lane, and a ballot gives the
//   first entry whose score equals the bucket's least: the earliest
//   position, as a sequential scan finds it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NB = 64;        // buckets: vertex i lies in bucket i % 64
constexpr int SLICES = 8;     // bucket slices of a warp; slice s: buckets s + 8 m
constexpr int QLANES = 4;     // query lanes of a warp (32 / SLICES)
constexpr int CHUNK = 8;      // table entries of one position-tracking chunk
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
// k-list keys are chunk << 7 | bucket; an empty slot has bucket 127
constexpr int BUCKET_BITS = 7;
constexpr int BUCKET_MASK = (1 << BUCKET_BITS) - 1;

// Table entry of vertex vi: (x, y, z, |v|^2), or padding past the last vertex.
__device__ __forceinline__ float4 table_entry(const float* __restrict__ verts, int vi,
                                              int num_verts) {
  if (vi >= num_verts) return make_float4(0.f, 0.f, 0.f, 1e30f);
  const float x = verts[3 * (size_t)vi], y = verts[3 * (size_t)vi + 1],
              z = verts[3 * (size_t)vi + 2];
  return make_float4(x, y, z,
                     __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

__device__ __forceinline__ float entry_score(float4 v, float qx, float qy, float qz) {
  return __fmaf_rn(v.z, qz, __fmaf_rn(v.y, qy, __fmaf_rn(v.x, qx, v.w)));
}

// (s, k) before (cs, ck): the lower score, then the lower bucket
__device__ __forceinline__ bool before(float s, int k, float cs, int ck) {
  return s < cs || (s == cs && (k & BUCKET_MASK) < (ck & BUCKET_MASK));
}

// Buckets [g0, g0 + gn) x entries [j0, j0 + jn) into tab; bucket g0 + r at
// row r of `stride` entries. Threads walk the vertices in index order.
__device__ __forceinline__ void stage_table(float4* tab, const float* __restrict__ verts,
                                            int num_verts, int g0, int gn, int j0, int jn,
                                            int stride) {
  for (int e = threadIdx.x; e < gn * jn; e += THREADS) {
    const int jj = e / gn, r = e % gn;
    tab[r * stride + jj] = table_entry(verts, (j0 + jj) * NB + g0 + r, num_verts);
  }
}

template <int Q, int K>
struct WarpTile {
  float qx[Q], qy[Q], qz[Q];
  float best[Q];  // least score of the lane's current bucket
  int chunk[Q];   // the earliest chunk that reaches it
  float ls[Q][K];  // sorted k-list: scores
  int lk[Q][K];    // keys: chunk << 7 | bucket

  __device__ __forceinline__ void init(const float* __restrict__ pts, int tile, int nq, int ql) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int q = tile * QLANES * Q + i * QLANES + ql;
      const bool live = q < nq;
      qx[i] = live ? -2.f * pts[3 * (size_t)q] : 0.f;
      qy[i] = live ? -2.f * pts[3 * (size_t)q + 1] : 0.f;
      qz[i] = live ? -2.f * pts[3 * (size_t)q + 2] : 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) { ls[i][t] = INFINITY; lk[i][t] = BUCKET_MASK; }
    }
  }

  // Insert (cs, ck) into query i's list after every entry before it.
  __device__ __forceinline__ void insert(int i, float cs, int ck) {
    bool moved = false;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      if (moved || before(cs, ck, ls[i][t], lk[i][t])) {
        const float fs = ls[i][t]; ls[i][t] = cs; cs = fs;
        const int fk = lk[i][t]; lk[i][t] = ck; ck = fk;
        moved = true;
      }
    }
  }

  // The lane's buckets among the staged [g0, g0 + gn) x [j0, j0 + jn).
  __device__ __forceinline__ void scan(const float4* tab, int s, int g0, int gn, int j0, int jn,
                                       int stride, int vb) {
#pragma unroll 1
    for (int bb = 0; bb < gn / SLICES; ++bb) {
      const int r = bb * SLICES + s;
      const float4* row = tab + r * stride;
      if (j0 == 0) {
#pragma unroll
        for (int i = 0; i < Q; ++i) { best[i] = INFINITY; chunk[i] = 0; }
      }
#pragma unroll 1
      for (int c = 0; c < jn / CHUNK; ++c) {
        float cm[Q];
#pragma unroll
        for (int e = 0; e < CHUNK; ++e) {
          const float4 v = row[c * CHUNK + e];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float sc = entry_score(v, qx[i], qy[i], qz[i]);
            cm[i] = e == 0 ? sc : fminf(cm[i], sc);
          }
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          if (cm[i] < best[i]) { best[i] = cm[i]; chunk[i] = j0 / CHUNK + c; }
        }
      }
      if (j0 + jn == vb) {
#pragma unroll
        for (int i = 0; i < Q; ++i) insert(i, best[i], chunk[i] << BUCKET_BITS | (g0 + r));
      }
    }
  }

  // Merge the 8 slices' lists, find each chosen bucket's earliest position
  // in its chunk, store.
  __device__ __forceinline__ void finish(const float* __restrict__ verts, int num_verts,
                                         int* __restrict__ idx_out, float* __restrict__ score_out,
                                         int tile, int nq, int s, int ql) {
#pragma unroll
    for (int off = 1; off < SLICES; off <<= 1) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        float ps[K];
        int pk[K];
#pragma unroll
        for (int t = 0; t < K; ++t) {
          ps[t] = __shfl_xor_sync(FULL, ls[i][t], off);
          pk[t] = __shfl_xor_sync(FULL, lk[i][t], off);
        }
#pragma unroll
        for (int t = 0; t < K; ++t) insert(i, ps[t], pk[t]);
      }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      int my_idx = 0;
      float my_score = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const int b = lk[i][t] & BUCKET_MASK, c = lk[i][t] >> BUCKET_BITS;
        const int vi = b < NB ? (c * CHUNK + s) * NB + b : num_verts;
        const float sc = entry_score(table_entry(verts, vi, num_verts), qx[i], qy[i], qz[i]);
        const unsigned hit = (__ballot_sync(FULL, sc == ls[i][t]) >> (ql * SLICES)) & 0xffu;
        const int pos = c * CHUNK + (hit ? __ffs(hit) - 1 : 0);
        if (t == s) {
          my_idx = min(pos * NB + b, num_verts - 1);
          my_score = ls[i][t];
        }
      }
      const int q = tile * QLANES * Q + i * QLANES + ql;
      if (s < K && q < nq) {
        idx_out[(size_t)q * K + s] = my_idx;
        score_out[(size_t)q * K + s] = my_score;
      }
    }
  }
};

template <int Q, int K>
__global__ void __launch_bounds__(THREADS, 1) bucketed_knn_kernel(
    const float* __restrict__ pts, const float* __restrict__ verts, int* __restrict__ idx_out,
    float* __restrict__ score_out, int nq, int num_verts, int group, int part, int vb) {
  extern __shared__ float4 tab[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = lane & (SLICES - 1), ql = lane / SLICES;
  const int warp_tiles = (nq + QLANES * Q - 1) / (QLANES * Q);
  const int stride = part + 1;
  WarpTile<Q, K> w;
  if (group == NB && part == vb) {
    // resident: build the table once, then each warp walks its own tiles
    stage_table(tab, verts, num_verts, 0, NB, 0, vb, stride);
    __syncthreads();
    for (int t = warp * gridDim.x + blockIdx.x; t < warp_tiles; t += gridDim.x * WARPS) {
      w.init(pts, t, nq, ql);
      w.scan(tab, s, 0, NB, 0, vb, stride, vb);
      w.finish(verts, num_verts, idx_out, score_out, t, nq, s, ql);
    }
    return;
  }
  // grouped: stage the table for each block tile of WARPS warp tiles
  const int block_tiles = (warp_tiles + WARPS - 1) / WARPS;
  for (int bt = blockIdx.x; bt < block_tiles; bt += gridDim.x) {
    const int t = bt * WARPS + warp;
    w.init(pts, t, nq, ql);
    for (int g0 = 0; g0 < NB; g0 += group) {
      const int gn = min(group, NB - g0);
      for (int j0 = 0; j0 < vb; j0 += part) {
        const int jn = min(part, vb - j0);
        __syncthreads();
        stage_table(tab, verts, num_verts, g0, gn, j0, jn, stride);
        __syncthreads();
        w.scan(tab, s, g0, gn, j0, jn, stride, vb);
      }
    }
    w.finish(verts, num_verts, idx_out, score_out, t, nq, s, ql);
  }
}

template <int Q, int K>
int launch(const float* pts, const float* verts, int* idx_out, float* score_out, int nq,
           int num_verts, int group, int part, int vb, int smem_bytes, int grid,
           cudaStream_t st) {
  static int allowed = 0;  // dynamic shared memory this instantiation may take
  if (smem_bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucketed_knn_kernel<Q, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = smem_bytes;
  }
  bucketed_knn_kernel<Q, K><<<grid, THREADS, smem_bytes, st>>>(
      pts, verts, idx_out, score_out, nq, num_verts, group, part, vb);
  return (int)cudaGetLastError();
}

}  // namespace

// pts [Nq, 3] f32; verts [V, 3] f32; idx_out [Nq, k] int32; score_out
// [Nq, k] f32; 1 <= k <= 8; a thread holds 4 query points for k <= 4, else
// 2 (its k-lists stay in registers). The plan (knn.knn_plan): the table
// staged as `group` buckets (a multiple of 8, 64 when resident) x `part`
// entries (a multiple of 8; the bucket size vb unless group is 8), in
// smem_bytes >= group x (part + 1) x 16 of dynamic shared memory; `grid`
// persistent blocks of 512 threads.
// Returns the cudaError_t of the launch (0 on success), -1 for a bad k or plan.
extern "C" int bucketed_knn_launch(const float* pts, const float* verts, int* idx_out,
                                   float* score_out, int nq, int num_verts, int k, int group,
                                   int part, int vb, int smem_bytes, int grid, void* stream) {
  if (nq == 0) return 0;
  const bool plan_ok = num_verts > 0 && vb % CHUNK == 0 && vb * NB >= num_verts &&
                       group >= SLICES && group <= NB && group % SLICES == 0 &&
                       part >= CHUNK && part <= vb && part % CHUNK == 0 &&
                       (part == vb || group == SLICES) && grid >= 1 &&
                       (long long)smem_bytes >= (long long)group * (part + 1) * 16;
  if (k < 1 || k > 8 || !plan_ok) return -1;
  const cudaStream_t st = (cudaStream_t)stream;
#define KNN_CASE(Q, K)                                                                   \
  if (k == K)                                                                            \
    return launch<Q, K>(pts, verts, idx_out, score_out, nq, num_verts, group, part, vb,  \
                        smem_bytes, grid, st);
  KNN_CASE(4, 1) KNN_CASE(4, 2) KNN_CASE(4, 3) KNN_CASE(4, 4)
  KNN_CASE(2, 5) KNN_CASE(2, 6) KNN_CASE(2, 7) KNN_CASE(2, 8)
#undef KNN_CASE
  return -1;
}
