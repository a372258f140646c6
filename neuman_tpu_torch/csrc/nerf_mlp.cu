// Fused positional encoding + NeRF MLP over planar samples.
//
// Replaces neuman_tpu/ops/pallas/raymarch.py `nerf_mlp_pallas` (kernel body
// :192, pallas_call :301) in both direction modes:
//   per-ray    - dir_part [R, W/2] (W_dirs . PE(d), one row per ray) is added
//                before the views ReLU; sample n belongs to ray n / S;
//   per-sample - the direction planes are encoded in the kernel and the
//                views layer reads [feature, PE(d)].
// Both PE mappings: 'posenc' (bands f_b: [x, sin f0 x, cos f0 x, ...]) and
// 'rotate' ([x, sin(B x) all, cos(B x) all]); the bands or the basis B come
// in as a small array.
//
// One block of 256 threads (8 warps) runs a tile of TN = 64 samples through
// the whole network. The tile's activations never leave shared memory: two
// ping-pong buffers [TN][LD]. Columns [0, Cp) of both hold the tile's PE and
// columns [Cp, Cp + W) the layer output, so the skip concat [PE, h] is a
// column range and costs nothing. Weights stay in global memory (at most
// ~1.2 MB at W = 256), where the 50 MB L2 and each SM's L1 hold them after
// the first tiles. Two instantiations of that plan, by compute dtype:
//
// f32 (`nerf_mlp_f32_kernel`): f32 activations (LD = max(Cp + W, W + Cd) =
//   319 at W = 256: 163 KB of shared memory) and f32 FMAs on CUDA cores.
//   Warp w owns samples w + 8i (i < 8), lane l outputs l + 32j, so each
//   weight row read ([in, out] layout) is one coalesced 128-byte line per j
//   and each activation read a shared-memory broadcast. Bound by f32 FMA
//   issue: ~0.59 M multiply-adds per sample at W = 256.
//
// bf16 (`nerf_mlp_bf16_kernel`): bf16 activations (84 KB of shared memory,
//   two blocks per SM) and tensor cores via mma.sync m16n8k16 (bf16 inputs,
//   f32 accumulation). Warps tile the [64 x out] layer output 2 x 4; A
//   fragments come from shared memory as 32-bit pairs (LD = 8 mod 64
//   elements makes the 8 rows of a fragment hit distinct banks), B
//   fragments straight from the [out, in] weights in global memory. The PE
//   block and the dir-PE block are zero-padded to multiples of 16 columns
//   (the MMA's k step) and the wrapper inserts matching zero weight columns.
//   The 1-wide alpha and 3-wide rgb heads run on CUDA cores. Activations are
//   rounded to bf16 where the JAX kernel casts them (PE, trunk outputs,
//   feature, dir PE, views output). Bound by the B-fragment loads from L1
//   and by mma.sync issue (wgmma + TMA-staged weights is the next step).
//
// With a tape pointer (the `mlp_tape="hbm"` train configuration; the TPU
// kernel's emit_tape) every trunk layer also writes its post-ReLU output, in
// the compute dtype, to tape[n][i * W + o], sample-major rows of depth * W
// values: what the backward's chain pass otherwise recomputes, bit for bit
// (same products in the same order, same rounding). 8 KB a sample in f32 and
// 4 KB in bf16 at 8 x 256; each warp writes whole 128-byte lines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TN = 64;  // samples per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SPW = TN / WARPS;  // samples per warp (f32 kernel)

struct PE {
  int mapping;  // 0 posenc, 1 rotate
  int include_input;
  int n_bands;
  int out_dim;
  const float* coef;  // posenc: [n_bands] bands; rotate: [3 n_bands, 3] basis
};

struct MlpArgs {
  const float *px, *py, *pz;  // [N] sample positions
  const float *dx, *dy, *dz;  // [N] per-sample directions, or null
  const float* dir_part;      // [R, W/2] per-ray direction term, or null
  const void* wt;             // packed weights (layout per kernel, see wrapper)
  const float* bias;          // packed biases
  float* out;                 // [4, N]: sigma, r, g, b
  void* tape;                 // [N, depth * W] trunk posts, compute dtype, or null
  PE pos, dir;
  int n, spr, depth, width, skip_mask;
  int ld;              // activation row stride, elements
  int cp, cd;          // PE / dir-PE block widths in the buffers (padded for bf16)
};

// b . v as the FMA chain fma(b2, v2, fma(b1, v1, b0 v0)), spelled out so
// that the compiler cannot reorder it: the operations of the plain PyTorch
// version (`embedder.rotate_projection`), so both take the sin and cos of
// the same argument, which reaches ~10^3 at the top band.
__device__ __forceinline__ float rot_proj(const float* b, const float* v) {
  return __fmaf_rn(b[2], v[2], __fmaf_rn(b[1], v[1], __fmul_rn(b[0], v[0])));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// Encode (x, y, z) of the tile's samples into buf[s][off + c], c < width;
// columns from pe.out_dim up to width are zero padding.
template <typename T>
__device__ void pe_fill(T* buf, int ld, int off, int width, PE pe, const float* x,
                        const float* y, const float* z, int n0, int n) {
  const int base = pe.include_input ? 3 : 0;
  for (int idx = threadIdx.x; idx < TN * width; idx += blockDim.x) {
    const int s = idx / width, c = idx % width;
    const int g = n0 + s;
    float v[3] = {0.f, 0.f, 0.f};
    if (g < n) { v[0] = x[g]; v[1] = y[g]; v[2] = z[g]; }
    float out = 0.f;
    if (c >= pe.out_dim) {
      out = 0.f;
    } else if (c < base) {
      out = v[c];
    } else if (pe.mapping == 0) {
      const int r = c - base, band = r / 6, k = r % 6;
      const float a = v[k % 3] * pe.coef[band];
      out = k < 3 ? sinf(a) : cosf(a);
    } else {
      const int f = 3 * pe.n_bands, r = c - base, j = r < f ? r : r - f;
      const float* b = pe.coef + 3 * j;
      const float a = rot_proj(b, v);
      out = r < f ? sinf(a) : cosf(a);
    }
    store(buf + s * ld + off + c, out);
  }
}

// ---------------------------------------------------------------- f32 path

// out = in[:, in_off:in_off+in_dim] @ wt + bias [+ dir_part row] [relu] for
// the tile; wt is [in, out]. Shared-memory output: dst[s][dst_off + o].
// Global output (gout != nullptr): gout[(dst_off + o) * n + n0 + s].
// TAPE: the shared-memory outputs also go to gtape[g][o] (a trunk layer's
// posts); a template flag, so that the tape-less call keeps its code.
template <int NJ, bool TAPE>
__device__ void dense_f32(const float* src, int ld, int in_off, int in_dim,
                          const float* __restrict__ wt, const float* __restrict__ bias,
                          int out_dim, float* dst, int dst_off, bool relu,
                          float* gout, const float* dir_part, int spr, int n0, int n,
                          float* gtape, int ldtape) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[SPW][NJ];
#pragma unroll
  for (int i = 0; i < SPW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const float* row0 = src + warp * ld + in_off;
#pragma unroll 2
  for (int k = 0; k < in_dim; ++k) {
    float w[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = lane + 32 * j;
      w[j] = o < out_dim ? __ldg(wt + (size_t)k * out_dim + o) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const float xv = row0[i * WARPS * ld + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] += xv * w[j];
    }
  }

#pragma unroll
  for (int i = 0; i < SPW; ++i) {
    const int s = warp + i * WARPS, g = n0 + s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = lane + 32 * j;
      if (o >= out_dim) continue;
      float v = acc[i][j] + bias[o];
      if (dir_part != nullptr && g < n) v += dir_part[(size_t)(g / spr) * out_dim + o];
      if (relu) v = fmaxf(v, 0.f);
      if (gout != nullptr) {
        if (g < n) gout[(size_t)(dst_off + o) * n + g] = v;
      } else {
        dst[s * ld + dst_off + o] = v;
        if (TAPE && g < n) gtape[(size_t)g * ldtape + o] = v;
      }
    }
  }
}

__device__ void dense_f32_any(const float* src, int ld, int in_off, int in_dim,
                              const float* wt, const float* bias, int out_dim,
                              float* dst, int dst_off, bool relu, float* gout,
                              const float* dir_part, int spr, int n0, int n,
                              float* gtape = nullptr, int ldtape = 0) {
  switch ((out_dim + 31) / 32) {
#define NERF_DENSE_CASE(NJ)                                                    \
  case NJ:                                                                     \
    if (gtape != nullptr)                                                      \
      dense_f32<NJ, true>(src, ld, in_off, in_dim, wt, bias, out_dim, dst,     \
                          dst_off, relu, gout, dir_part, spr, n0, n, gtape,    \
                          ldtape);                                             \
    else                                                                       \
      dense_f32<NJ, false>(src, ld, in_off, in_dim, wt, bias, out_dim, dst,    \
                           dst_off, relu, gout, dir_part, spr, n0, n, gtape,   \
                           ldtape);                                            \
    break;
    NERF_DENSE_CASE(1) NERF_DENSE_CASE(2) NERF_DENSE_CASE(3)
    NERF_DENSE_CASE(4) NERF_DENSE_CASE(5) NERF_DENSE_CASE(6)
    NERF_DENSE_CASE(7) NERF_DENSE_CASE(8)
#undef NERF_DENSE_CASE
  }
}

// wt: every layer [in, out] row-major (transposed), unpadded.
__global__ void __launch_bounds__(THREADS) nerf_mlp_f32_kernel(MlpArgs a) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + TN * a.ld;
  const int n0 = blockIdx.x * TN;
  const int cp = a.cp, w = a.width;
  const float* wt = static_cast<const float*>(a.wt);
  const float* bias = a.bias;
  float* tape = static_cast<float*>(a.tape);
  const int ldtape = a.depth * w;

  pe_fill(cur, a.ld, 0, cp, a.pos, a.px, a.py, a.pz, n0, a.n);
  pe_fill(nxt, a.ld, 0, cp, a.pos, a.px, a.py, a.pz, n0, a.n);
  __syncthreads();

  // trunk: layer i reads [PE] (i = 0), [PE, h] (after a skip) or [h]
  for (int i = 0; i < a.depth; ++i) {
    const bool after_skip = i > 0 && ((a.skip_mask >> (i - 1)) & 1);
    const int in_off = (i == 0 || after_skip) ? 0 : cp;
    const int in_dim = i == 0 ? cp : (after_skip ? cp + w : w);
    dense_f32_any(cur, a.ld, in_off, in_dim, wt, bias, w, nxt, cp, true, nullptr,
                  nullptr, 1, n0, a.n, tape == nullptr ? nullptr : tape + i * w, ldtape);
    wt += (size_t)in_dim * w;
    bias += w;
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  // heads read the trunk output h; alpha -> out row 0, feature -> nxt[:, 0:W]
  dense_f32_any(cur, a.ld, cp, w, wt, bias, 1, nullptr, 0, false, a.out, nullptr,
                1, n0, a.n);
  wt += w;
  bias += 1;
  dense_f32_any(cur, a.ld, cp, w, wt, bias, w, nxt, 0, false, nullptr, nullptr, 1,
                n0, a.n);
  wt += (size_t)w * w;
  bias += w;
  const bool per_sample = a.dx != nullptr;
  if (per_sample) pe_fill(nxt, a.ld, w, a.cd, a.dir, a.dx, a.dy, a.dz, n0, a.n);
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }

  // views: [feature, PE(d)] (per-sample) or feature + dir_part (per-ray)
  const int v_dim = per_sample ? w + a.cd : w;
  dense_f32_any(cur, a.ld, 0, v_dim, wt, bias, w / 2, nxt, 0, true, nullptr,
                a.dir_part, a.spr, n0, a.n);
  wt += (size_t)v_dim * (w / 2);
  bias += w / 2;
  __syncthreads();
  { float* t = cur; cur = nxt; nxt = t; }

  // rgb -> out rows 1..3
  dense_f32_any(cur, a.ld, 0, w / 2, wt, bias, 3, nullptr, 1, false, a.out,
                nullptr, 1, n0, a.n);
}

// --------------------------------------------------------------- bf16 path

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// dst[s][dst_off + o] = bf16(act(src[s, in_off:in_off+k] @ w[o, :] + bias[o]
// [+ dir_part row])) for the 64 x out tile; w is [out, k] row-major, k a
// multiple of 16, out = 32 NT. Warp (wm, wn) = (warp % 2, warp / 2) computes
// rows 32 wm .. +32 and columns 8 NT wn .. + 8 NT.
template <int NT, bool TAPE>
__device__ void dense_mma(const bf16* src, int ld, int in_off, int k,
                          const bf16* __restrict__ w, const float* __restrict__ bias,
                          bf16* dst, int dst_off, bool relu, const float* dir_part,
                          int spr, int n0, int n, bf16* gtape, int ldtape) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * NT * 8;
  const int out_dim = NT * 32;
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const bf16* p = src + (row0 + mi * 16 + g) * ld + in_off + k0 + 2 * t;
      af[mi][0] = lds32(p);
      af[mi][1] = lds32(p + 8 * ld);
      af[mi][2] = lds32(p + 8);
      af[mi][3] = lds32(p + 8 * ld + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const bf16* q = w + (size_t)(col0 + ni * 8 + g) * k + k0 + 2 * t;
      const uint32_t bfrag[2] = {ldg32(q), ldg32(q + 8)};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], bfrag);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = col0 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = row0 + mi * 16 + g + 8 * h, gi = n0 + s;
        float v0 = acc[mi][ni][2 * h] + bias[col];
        float v1 = acc[mi][ni][2 * h + 1] + bias[col + 1];
        if (dir_part != nullptr && gi < n) {
          const float* dp = dir_part + (size_t)(gi / spr) * out_dim + col;
          v0 += dp[0];
          v1 += dp[1];
        }
        if (relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(dst + s * ld + dst_off + col) = pair;
        if (TAPE && gi < n)
          *reinterpret_cast<__nv_bfloat162*>(gtape + (size_t)gi * ldtape + col) = pair;
      }
    }
  }
}

__device__ void dense_mma_any(const bf16* src, int ld, int in_off, int k,
                              const bf16* w, const float* bias, int out_dim,
                              bf16* dst, int dst_off, bool relu,
                              const float* dir_part, int spr, int n0, int n,
                              bf16* gtape = nullptr, int ldtape = 0) {
  switch (out_dim / 32) {
#define NERF_MMA_CASE(NT)                                                      \
  case NT:                                                                     \
    if (gtape != nullptr)                                                      \
      dense_mma<NT, true>(src, ld, in_off, k, w, bias, dst, dst_off, relu,     \
                          dir_part, spr, n0, n, gtape, ldtape);                \
    else                                                                       \
      dense_mma<NT, false>(src, ld, in_off, k, w, bias, dst, dst_off, relu,    \
                           dir_part, spr, n0, n, gtape, ldtape);               \
    break;
    NERF_MMA_CASE(1) NERF_MMA_CASE(2) NERF_MMA_CASE(3) NERF_MMA_CASE(4)
    NERF_MMA_CASE(5) NERF_MMA_CASE(6) NERF_MMA_CASE(7) NERF_MMA_CASE(8)
#undef NERF_MMA_CASE
  }
}

// A narrow head (alpha, rgb) on CUDA cores: gout[(row + o) * n + g] =
// src[s, in_off:in_off+k] @ w[o, :] + bias[o], w [out, k].
__device__ void head_small(const bf16* src, int ld, int in_off, int k,
                           const bf16* w, const float* bias, int out_dim,
                           float* gout, int row, int n0, int n) {
  for (int idx = threadIdx.x; idx < TN * out_dim; idx += blockDim.x) {
    const int s = idx / out_dim, o = idx % out_dim, g = n0 + s;
    const bf16* x = src + s * ld + in_off;
    const bf16* wr = w + (size_t)o * k;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc += __bfloat162float(x[j]) * __bfloat162float(wr[j]);
    if (g < n) gout[(size_t)(row + o) * n + g] = acc + bias[o];
  }
}

// wt: every layer [out, in] row-major (torch layout), the PE and dir-PE
// column blocks zero-padded to a.cp / a.cd columns.
__global__ void __launch_bounds__(THREADS) nerf_mlp_bf16_kernel(MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cur = reinterpret_cast<bf16*>(smem_raw);
  bf16* nxt = cur + TN * a.ld;
  const int n0 = blockIdx.x * TN;
  const int cp = a.cp, w = a.width;
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const float* bias = a.bias;
  bf16* tape = static_cast<bf16*>(a.tape);
  const int ldtape = a.depth * w;

  pe_fill(cur, a.ld, 0, cp, a.pos, a.px, a.py, a.pz, n0, a.n);
  pe_fill(nxt, a.ld, 0, cp, a.pos, a.px, a.py, a.pz, n0, a.n);
  __syncthreads();

  for (int i = 0; i < a.depth; ++i) {
    const bool after_skip = i > 0 && ((a.skip_mask >> (i - 1)) & 1);
    const int in_off = (i == 0 || after_skip) ? 0 : cp;
    const int in_dim = i == 0 ? cp : (after_skip ? cp + w : w);
    dense_mma_any(cur, a.ld, in_off, in_dim, wt, bias, w, nxt, cp, true, nullptr,
                  1, n0, a.n, tape == nullptr ? nullptr : tape + i * w, ldtape);
    wt += (size_t)in_dim * w;
    bias += w;
    __syncthreads();
    bf16* t = cur; cur = nxt; nxt = t;
  }
  head_small(cur, a.ld, cp, w, wt, bias, 1, a.out, 0, n0, a.n);
  wt += w;
  bias += 1;
  dense_mma_any(cur, a.ld, cp, w, wt, bias, w, nxt, 0, false, nullptr, 1, n0, a.n);
  wt += (size_t)w * w;
  bias += w;
  const bool per_sample = a.dx != nullptr;
  if (per_sample) pe_fill(nxt, a.ld, w, a.cd, a.dir, a.dx, a.dy, a.dz, n0, a.n);
  __syncthreads();
  { bf16* t = cur; cur = nxt; nxt = t; }

  const int v_dim = per_sample ? w + a.cd : w;
  dense_mma_any(cur, a.ld, 0, v_dim, wt, bias, w / 2, nxt, 0, true, a.dir_part,
                a.spr, n0, a.n);
  wt += (size_t)v_dim * (w / 2);
  bias += w / 2;
  __syncthreads();
  { bf16* t = cur; cur = nxt; nxt = t; }

  head_small(cur, a.ld, 0, w / 2, wt, bias, 3, a.out, 1, n0, a.n);
}

template <typename T>
int launch(void (*kernel)(MlpArgs), const MlpArgs& a, void* stream) {
  const int smem = 2 * TN * a.ld * (int)sizeof(T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.n + TN - 1) / TN;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace

// Planes px/py/pz (and dx/dy/dz) [N] f32; dir_part [R, W/2] f32 or null;
// bias: f32 biases, layer order trunk 0..D-1, alpha, feature, views, rgb.
// bf16 == 0: wt f32, each layer [in, out] (transposed), unpadded.
// bf16 == 1: wt bf16, each layer [out, in] with the PE block padded to a
//            multiple of 16 columns and the dir-PE block likewise; needs
//            width % 64 == 0.
// out [4, N] f32; tape [N, depth * width] of the compute dtype, or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int nerf_mlp_launch(
    const float* px, const float* py, const float* pz, const float* dx,
    const float* dy, const float* dz, const float* dir_part, const void* wt,
    const float* bias, float* out, void* tape, int n, int spr, int depth, int width,
    int skip_mask, int pos_mapping, int pos_include, int pos_bands,
    int pos_dim, const float* pos_coef, int dir_mapping, int dir_include,
    int dir_bands, int dir_dim, const float* dir_coef, int bf16, void* stream) {
  if (n == 0) return 0;
  MlpArgs a;
  a.px = px; a.py = py; a.pz = pz;
  a.dx = dx; a.dy = dy; a.dz = dz;
  a.dir_part = dir_part;
  a.wt = wt; a.bias = bias; a.out = out; a.tape = tape;
  a.pos = PE{pos_mapping, pos_include, pos_bands, pos_dim, pos_coef};
  a.dir = PE{dir_mapping, dir_include, dir_bands, dir_dim, dir_coef};
  a.n = n; a.spr = spr; a.depth = depth; a.width = width;
  a.skip_mask = skip_mask;
  const bool per_sample = dx != nullptr;
  a.cp = bf16 ? round_up(pos_dim, 16) : pos_dim;
  a.cd = bf16 ? round_up(dir_dim, 16) : dir_dim;
  int ld = a.cp + width;
  if (per_sample && width + a.cd > ld) ld = width + a.cd;
  if (!bf16) {
    a.ld = ld;
    return launch<float>(nerf_mlp_f32_kernel, a, stream);
  }
  a.ld = round_up(ld - 8, 64) + 8;  // = 8 mod 64: conflict-free A fragments
  return launch<__nv_bfloat16>(nerf_mlp_bf16_kernel, a, stream);
}
