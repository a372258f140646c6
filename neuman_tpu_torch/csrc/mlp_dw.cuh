// The weight-gradient passes shared by nerf_mlp_bwd.cu and offset_mlp_bwd.cu.
//
// dW[o, k] = sum_s d_pre[s, o] h_in[s, k] of every layer, read from the
// chunk's tape, as 64 x 64 output tiles; the chunk's samples are split into
// KSPLIT contiguous ranges, one block per tile and range, each writing its
// own partial (`bwd_dw_*_kernel`), and `bwd_reduce_kernel` adds the partials
// in order. No atomics: two runs give bit-identical gradients.
//
// The trunk's post-ReLU values, B operands of most layers, are read through a
// base pointer and row stride of their own (`post`, `ldp`): the chunk tape's
// post columns in the recompute configuration, the chunk's rows of the tape
// that the forward kernel wrote in the "hbm" one.

#pragma once

#include "mlp_tiles.cuh"

namespace {

struct DwLayer {
  int a_off, m;                  // A = tape[:, a_off : a_off + m]
  int b_off1, n1, b_off2, n2;    // B = [src1[:, b_off1 : +n1], src2[:, b_off2 : +n2], 1]
  int p1, p2;                    // a block's source: the posts (1) or the tape (0)
  int ldc, c_off, bias_off;      // dW[m][n] at c_off + m ldc + n, db[m] at bias_off + m
  int tiles_n, tile0;            // 64 x 64 output tiles: n-tiles, first tile id
};

struct DwArgs {
  const void* tape;
  const void* post;  // the trunk posts of the chunk's first row
  int ldt, ldp, k, kper;  // row strides; rows of the chunk, rows per split
  int n_layers, total;
  float* partial;    // [KSPLIT, total]
  DwLayer L[MAX_LAYERS];
};

// A thread stages the same column of a tile in every k step (THREADS is a
// multiple of the tile width), so where column c of B comes from is found
// once: element [row] is base[row * ld + off], or the constant 1 (the bias
// column) or 0 (past the layer's columns).
static_assert(THREADS % 64 == 0, "a thread's staged column must not change");
template <typename T>
struct BCol {
  const T* base;
  int ld, off;
  float fill;  // the constant when base is null
};

template <typename T>
__device__ __forceinline__ BCol<T> b_col(const DwArgs& a, const DwLayer& l, int c) {
  const T* tape = static_cast<const T*>(a.tape);
  const T* post = static_cast<const T*>(a.post);
  if (c < l.n1) return {l.p1 ? post : tape, l.p1 ? a.ldp : a.ldt, l.b_off1 + c, 0.f};
  if (c < l.n1 + l.n2)
    return {l.p2 ? post : tape, l.p2 ? a.ldp : a.ldt, l.b_off2 + c - l.n1, 0.f};
  return {nullptr, 0, 0, c == l.n1 + l.n2 ? 1.f : 0.f};
}

__device__ __forceinline__ void dw_store(const DwArgs& a, const DwLayer& l, int ks, int m,
                                         int c, float v) {
  if (m >= l.m) return;
  float* p = a.partial + (size_t)ks * a.total;
  if (c < l.n1 + l.n2) p[l.c_off + (size_t)m * l.ldc + c] = v;
  else if (c == l.n1 + l.n2) p[l.bias_off + m] = v;
}

__device__ __forceinline__ int find_layer(const DwArgs& a, int tile) {
  int li = 0;
  while (li + 1 < a.n_layers && tile >= a.L[li + 1].tile0) ++li;
  return li;
}

// f32: 16 x 16 threads, 4 x 4 outputs each, k in steps of 16 through smem
__global__ void __launch_bounds__(THREADS) bwd_dw_f32_kernel(DwArgs a) {
  __shared__ float as[16][64];
  __shared__ float bs[16][64];
  const int li = find_layer(a, blockIdx.x);
  const DwLayer l = a.L[li];
  const int tile = blockIdx.x - l.tile0, m0 = (tile / l.tiles_n) * 64,
            n0 = (tile % l.tiles_n) * 64, ks = blockIdx.y;
  const int k_lo = ks * a.kper, k_hi = min(a.k, k_lo + a.kper);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c = threadIdx.x % 64;  // the column this thread stages
  const BCol<float> bc = b_col<float>(a, l, n0 + c);
  const float* acol = m0 + c < l.m ? static_cast<const float*>(a.tape) + l.a_off + m0 + c : nullptr;
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
    for (int kk = threadIdx.x / 64; kk < 16; kk += THREADS / 64) {
      const int row = k0 + kk;
      const bool in = row < k_hi;
      as[kk][c] = in && acol != nullptr ? acol[(size_t)row * a.ldt] : 0.f;
      bs[kk][c] = !in ? 0.f : bc.base != nullptr ? bc.base[(size_t)row * bc.ld + bc.off] : bc.fill;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) { av[i] = as[kk][ty * 4 + i]; bv[i] = bs[kk][tx * 4 + i]; }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) dw_store(a, l, ks, m0 + ty * 4 + i, n0 + tx * 4 + j, acc[i][j]);
}

// bf16: 8 warps as 4 (m16) x 2 (4 n8 tiles), k in steps of 32 through smem,
// stored transposed ([m][k], [n][k]) so each fragment is a pair along k
constexpr int DW_BK = 32, DW_LDS = DW_BK + 8;
__global__ void __launch_bounds__(THREADS) bwd_dw_bf16_kernel(DwArgs a) {
  __shared__ __align__(16) bf16 as[64][DW_LDS];
  __shared__ __align__(16) bf16 bs[64][DW_LDS];
  const int li = find_layer(a, blockIdx.x);
  const DwLayer l = a.L[li];
  const int tile = blockIdx.x - l.tile0, m0 = (tile / l.tiles_n) * 64,
            n0 = (tile % l.tiles_n) * 64, ks = blockIdx.y;
  const int k_lo = ks * a.kper, k_hi = min(a.k, k_lo + a.kper);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wm = warp % 4, wn = warp / 4;
  const int c = threadIdx.x % 64;  // the column this thread stages
  const BCol<bf16> bc = b_col<bf16>(a, l, n0 + c);
  const bf16* acol = m0 + c < l.m ? static_cast<const bf16*>(a.tape) + l.a_off + m0 + c : nullptr;
  const bf16 zero = __float2bfloat16(0.f), fill = __float2bfloat16(bc.fill);
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += DW_BK) {
    for (int kk = threadIdx.x / 64; kk < DW_BK; kk += THREADS / 64) {
      const int row = k0 + kk;
      const bool in = row < k_hi;
      as[c][kk] = in && acol != nullptr ? acol[(size_t)row * a.ldt] : zero;
      bs[c][kk] = !in ? zero : bc.base != nullptr ? bc.base[(size_t)row * bc.ld + bc.off] : fill;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 16) {
      uint32_t af[4];
      const bf16* p = &as[wm * 16 + g][kk + 2 * t];
      af[0] = lds32(p);
      af[1] = lds32(p + 8 * DW_LDS);
      af[2] = lds32(p + 8);
      af[3] = lds32(p + 8 * DW_LDS + 8);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* q = &bs[wn * 32 + ni * 8 + g][kk + 2 * t];
        const uint32_t bfrag[2] = {lds32(q), lds32(q + 8)};
        mma_bf16(acc[ni], af, bfrag);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = n0 + wn * 32 + ni * 8 + 2 * t, m = m0 + wm * 16 + g;
    dw_store(a, l, ks, m, c, acc[ni][0]);
    dw_store(a, l, ks, m, c + 1, acc[ni][1]);
    dw_store(a, l, ks, m + 8, c, acc[ni][2]);
    dw_store(a, l, ks, m + 8, c + 1, acc[ni][3]);
  }
}

// grad[e] += partial[0][e] + ... + partial[ksplit - 1][e], in that order
__global__ void bwd_reduce_kernel(const float* partial, float* grad, int total, int ksplit) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partial[(size_t)k * total + e];
  grad[e] += s;
}

}  // namespace
