// Device code shared by the fused-MLP kernels (nerf_mlp_bwd.cu, offset_mlp.cu,
// offset_mlp_bwd.cu): the positional encodings and their derivatives for a
// 64-sample tile, and the tile products [64 x in] . [in x out] with the
// result handed element by element to an epilogue functor: f32 FMAs on CUDA
// cores, or bf16 mma.sync m16n8k16 with f32 accumulation. Everything lives
// in an anonymous namespace: each source that includes it gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
typedef __nv_bfloat16 bf16;

constexpr int TN = 64;  // samples per chain block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SPW = TN / WARPS;
constexpr int MAX_LAYERS = 16;

struct PE {
  int mapping;  // 0 posenc, 1 rotate
  int include_input;
  int n_bands;
  int out_dim;
  const float* coef;  // posenc: [n_bands] bands; rotate: [3 n_bands, 3] basis
};

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(float v) { return __float2bfloat16(v); }

// b . v as the FMA chain fma(b2, v2, fma(b1, v1, b0 v0)), spelled out so
// that the compiler cannot reorder it: the operations of the plain PyTorch
// version (`embedder.rotate_projection`), so both take the sin and cos of
// the same argument, which reaches ~10^3 at the top band.
__device__ __forceinline__ float rot_proj(const float* b, const float* v) {
  return __fmaf_rn(b[2], v[2], __fmaf_rn(b[1], v[1], __fmul_rn(b[0], v[0])));
}

// The tile's PE of (x, y, z) into buf[s][off + c], c < width; columns from
// pe.out_dim to width are zero. Samples at or past n get zero inputs.
template <typename T>
__device__ void pe_fill(T* buf, int ld, int off, int width, PE pe, const float* x,
                        const float* y, const float* z, int n0, int n) {
  const int base = pe.include_input ? 3 : 0;
  for (int idx = threadIdx.x; idx < TN * width; idx += blockDim.x) {
    const int s = idx / width, c = idx % width, g = n0 + s;
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
    buf[s * ld + off + c] = cvt<T>(out);
  }
}

// d(x, y, z) of one sample from d_pe [out_dim], in f32 (fused.pe_rows_bwd).
__device__ void pe_bwd(const PE& pe, float x, float y, float z, const float* d, float out[3]) {
  const float v[3] = {x, y, z};
  const int base = pe.include_input ? 3 : 0;
  for (int a = 0; a < 3; ++a) out[a] = pe.include_input ? d[a] : 0.f;
  if (pe.mapping == 0) {
    for (int b = 0; b < pe.n_bands; ++b) {
      const float f = pe.coef[b];
      for (int a = 0; a < 3; ++a) {
        const float s = sinf(v[a] * f), c = cosf(v[a] * f);
        out[a] += f * (c * d[base + 6 * b + a] - s * d[base + 6 * b + 3 + a]);
      }
    }
  } else {
    const int f = 3 * pe.n_bands;
    for (int j = 0; j < f; ++j) {
      const float* b = pe.coef + 3 * j;
      const float p = rot_proj(b, v);
      const float dp = cosf(p) * d[base + j] - sinf(p) * d[base + f + j];
      for (int a = 0; a < 3; ++a) out[a] += b[a] * dp;
    }
  }
}

// ------------------------------------------------ tile products, f32 path

// For the tile: ep(s, o, sum_k src[s][in_off + k] * w[k * out_dim + o]),
// o < out_dim <= 32 NJ. Warp w owns samples w + 8i, lane l outputs l + 32j.
template <int NJ, class Ep>
__device__ void dense_f32(const float* src, int ld, int in_off, int in_dim,
                          const float* __restrict__ w, int out_dim, Ep& ep) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[SPW][NJ];
#pragma unroll
  for (int i = 0; i < SPW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const float* row0 = src + warp * ld + in_off;
#pragma unroll 2
  for (int k = 0; k < in_dim; ++k) {
    float wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = lane + 32 * j;
      wv[j] = o < out_dim ? __ldg(w + (size_t)k * out_dim + o) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const float xv = row0[i * WARPS * ld + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] += xv * wv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < SPW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = lane + 32 * j;
      if (o < out_dim) ep(warp + i * WARPS, o, acc[i][j]);
    }
}

template <class Ep>
__device__ void dense(const float* src, int ld, int in_off, int in_dim, const float* w,
                      int out_dim, Ep ep) {
  switch ((out_dim + 31) / 32) {
#define BWD_DENSE_CASE(NJ) \
  case NJ: dense_f32<NJ>(src, ld, in_off, in_dim, w, out_dim, ep); break;
    BWD_DENSE_CASE(1) BWD_DENSE_CASE(2) BWD_DENSE_CASE(3) BWD_DENSE_CASE(4)
    BWD_DENSE_CASE(5) BWD_DENSE_CASE(6) BWD_DENSE_CASE(7) BWD_DENSE_CASE(8)
    BWD_DENSE_CASE(9) BWD_DENSE_CASE(10) BWD_DENSE_CASE(11)
#undef BWD_DENSE_CASE
  }
}

// ----------------------------------------------- tile products, bf16 path

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
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

// For the 64 x (32 NT) tile: ep(s, o, sum_k src[s][in_off + k] * w[o][k]),
// w [out, k] row-major, k a multiple of 16. Warp (wm, wn) = (warp % 2,
// warp / 2) computes rows 32 wm .. +32 and columns 8 NT wn .. + 8 NT.
template <int NT, class Ep>
__device__ void dense_mma(const bf16* src, int ld, int in_off, int k,
                          const bf16* __restrict__ w, Ep& ep) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * NT * 8;
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
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = col0 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = row0 + mi * 16 + g + 8 * h;
        ep(s, col, acc[mi][ni][2 * h]);
        ep(s, col + 1, acc[mi][ni][2 * h + 1]);
      }
    }
}

// out_dim a multiple of 32, taken 256 columns at a time.
template <class Ep>
__device__ void dense(const bf16* src, int ld, int in_off, int k, const bf16* w, int out_dim,
                      Ep ep) {
  for (int c0 = 0; c0 < out_dim; c0 += 256) {
    auto ep_c = [&](int s, int o, float v) { ep(s, c0 + o, v); };
    const bf16* wc = w + (size_t)c0 * k;
    switch (min(256, out_dim - c0) / 32) {
#define BWD_MMA_CASE(NT) \
  case NT: dense_mma<NT>(src, ld, in_off, k, wc, ep_c); break;
      BWD_MMA_CASE(1) BWD_MMA_CASE(2) BWD_MMA_CASE(3) BWD_MMA_CASE(4)
      BWD_MMA_CASE(5) BWD_MMA_CASE(6) BWD_MMA_CASE(7) BWD_MMA_CASE(8)
#undef BWD_MMA_CASE
    }
  }
}

// The tile's 'posenc' PE of D <= 4 input planes into buf[s][off + c], c <
// width: [x (D), sin(f0 x) (D), cos(f0 x) (D), sin(f1 x), ...]; columns from
// pe.out_dim to width are zero. Samples at or past n get zero inputs.
struct Axes {
  const float* p[4];
  int d;
};

template <typename T>
__device__ void pe_fill_nd(T* buf, int ld, int off, int width, PE pe, Axes ax, int n0, int n) {
  const int d = ax.d, base = pe.include_input ? d : 0;
  for (int idx = threadIdx.x; idx < TN * width; idx += blockDim.x) {
    const int s = idx / width, c = idx % width, g = n0 + s;
    float out = 0.f;
    if (c < pe.out_dim && g < n) {
      if (c < base) {
        out = ax.p[c][g];
      } else {
        const int r = c - base, band = r / (2 * d), k = r % (2 * d);
        const float a = ax.p[k % d][g] * pe.coef[band];
        out = k < d ? sinf(a) : cosf(a);
      }
    } else if (c < pe.out_dim && c >= base) {
      const int k = (c - base) % (2 * d);
      out = k < d ? 0.f : 1.f;  // sin 0, cos 0: what a zero input encodes to
    }
    buf[s * ld + off + c] = cvt<T>(out);
  }
}

// d(axes) of one sample from d_pe [out_dim] of the 'posenc' PE, in f32.
__device__ void pe_bwd_nd(const PE& pe, const Axes& ax, int g, const float* dpe, float out[4]) {
  const int d = ax.d, base = pe.include_input ? d : 0;
  for (int a = 0; a < d; ++a) {
    const float x = ax.p[a][g];
    float acc = pe.include_input ? dpe[a] : 0.f;
    for (int b = 0; b < pe.n_bands; ++b) {
      const float f = pe.coef[b];
      const float s = sinf(x * f), c = cosf(x * f);
      acc += f * (c * dpe[base + 2 * d * b + a] - s * dpe[base + 2 * d * b + d + a]);
    }
    out[a] = acc;
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

}  // namespace
