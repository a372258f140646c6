// Recompute backward of the fused PE + NeRF MLP (the VJP of nerf_mlp.cu).
//
// Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_mlp_bwd` (kernel body
// :184, pallas_call :371, wrapper `make_mlp_vjp` :417) in both direction
// modes: per-ray (dir_part [R, W/2] in, d_dir [R, W/2] out) and per-sample
// (direction planes in, d_dir 3 x [N] out), both PE mappings, f32 and bf16.
// Semantics kept from the TPU kernel: the forward is recomputed in the
// compute dtype; ReLU masks come from the recomputed post-activation values
// (> 0); in bf16 every product takes bf16 operands, the cotangents included,
// and accumulates in f32; the PE and its derivative are f32.
//
// Where the card differs from the TPU, and what this design does about it:
//
// 1. The TPU kernel keeps every layer's activations of a 1024-lane tile in
//    VMEM. A 64-sample tile of them (~2,800 values a sample) is ~720 KB in
//    f32, over a block's 227 KB. Here a block keeps only two ping-pong
//    [64][LD] buffers in shared memory (the same plan as nerf_mlp.cu) and
//    writes each layer's input and output values of the tile to a "tape" in
//    global memory: PE, the trunk posts, feature, dir PE, h2, the
//    cotangents, and on the way down every layer's pre-activation gradient.
//    The tape holds one chunk of whole rays (~32k samples, ~650 MB in f32)
//    and is reused chunk after chunk.
//
// 2. dW is a sum over all R*S samples; on the TPU the grid is sequential
//    and accumulates in place. Blocks here run in parallel, so the sum is
//    three passes per chunk, all in fixed order: `bwd_chain_kernel` (one
//    block per 64-sample tile: recompute forward, propagate d_h down the
//    net, write the tape, d_planes and per-sample d_dir); `bwd_dw_kernel`
//    (dW[o, k] = sum_s d_pre[s, o] h_in[s, k] of every layer as 64x64 output
//    tiles; the chunk's samples are split into KSPLIT contiguous ranges, one
//    block per tile and range, each writing its own partial); and
//    `bwd_reduce_kernel` (grad += the KSPLIT partials, in order, one thread
//    per element). No atomics: two runs give bit-identical gradients.
//
// 3. In per-ray mode d_dir sums d_pre2 over a ray's S samples, which span
//    several tiles. Chunks hold whole rays, and `bwd_ddir_kernel` sums each
//    ray's rows of the tape in order, one thread per (ray, column).
//
// 4. Products: f32 FMAs on CUDA cores in f32 (bound by FMA issue, ~3x the
//    forward's 0.59 M multiply-adds a sample); bf16 mma.sync m16n8k16 with
//    f32 accumulation in bf16, as the forward kernel. The narrow heads
//    (alpha: 1 output, rgb: 3) run on CUDA cores. The dW tiles stage their
//    operands through shared memory, transposed so that the MMA fragments
//    are pairs along the sample axis. The tape costs ~20 KB a sample of
//    traffic in f32 (written once, read ~twice), well under the FMA time.

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
    BWD_DENSE_CASE(9) BWD_DENSE_CASE(10)
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

// ------------------------------------------------------------ chain pass

struct ChainArgs {
  const float *px, *py, *pz;  // [N] sample positions
  const float *dx, *dy, *dz;  // [N] per-sample directions, or null
  const float* dir_part;      // [R, W/2] per-ray direction term, or null
  const float* g;             // [4, N] cotangents of sigma, r, g, b
  const void* wf;             // weights as the forward kernel packs them
  const void* wb;             // the same layers transposed (see the wrapper)
  const float* bias;          // packed biases, forward order
  const float* head_a;        // [W] alpha weights, rounded to the compute dtype
  const float* head_rgb;      // [3, W/2] rgb weights, rounded likewise
  float* d_planes;            // [3, N]
  float* d_dir;               // per-sample: [3, N]; per-ray: unused here
  void* tape;                 // [chunk rows, ldt] compute dtype
  PE pos, dir;
  int n, spr, depth, width, skip_mask;
  int ld, cp, cd, dld;        // smem row stride, PE / dir-PE widths, d_pe stride
  int ldt, t_post, t_feat, t_dpe, t_h2, t_g, t_dpre, t_dfeat, t_dpre2;
  int c0, lim;                // chunk's first sample; samples >= lim are padding
};

template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + TN * a.ld;
  float* dpe = reinterpret_cast<float*>(nxt + TN * a.ld);  // [TN][dld] f32
  const int t0 = blockIdx.x * TN, n0 = a.c0 + t0, lim = a.lim;
  const int w = a.width, cp = a.cp, half = w / 2, ld = a.ld, n = a.n;
  const bool per_sample = a.dx != nullptr;
  T* tape = static_cast<T*>(a.tape) + (size_t)t0 * a.ldt;
  const int ldt = a.ldt;
  auto swap = [&]() { T* t = cur; cur = nxt; nxt = t; };
  auto in_dim_of = [&](int i, bool& has_pe) {
    const bool after_skip = i > 0 && ((a.skip_mask >> (i - 1)) & 1);
    has_pe = i == 0 || after_skip;
    return i == 0 ? cp : (after_skip ? cp + w : w);
  };
  const int v_dim = per_sample ? w + a.cd : w;
  // layer offsets in the packed weights (forward order, the same in wf and wb)
  size_t off[MAX_LAYERS];
  {
    size_t o = 0;
    bool hp;
    for (int i = 0; i < a.depth; ++i) { off[i] = o; o += (size_t)in_dim_of(i, hp) * w; }
    off[a.depth] = o;          // alpha
    off[a.depth + 1] = o + w;  // feature
    off[a.depth + 2] = o + w + (size_t)w * w;  // views
  }
  const T* wf = static_cast<const T*>(a.wf);
  const T* wb = static_cast<const T*>(a.wb);

  // ---- forward recompute; every value that a dW product reads goes to the tape
  pe_fill(cur, ld, 0, cp, a.pos, a.px, a.py, a.pz, n0, lim);
  pe_fill(nxt, ld, 0, cp, a.pos, a.px, a.py, a.pz, n0, lim);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TN * cp; idx += blockDim.x) {
    const int s = idx / cp, c = idx % cp;
    tape[(size_t)s * ldt + c] = cur[s * ld + c];
  }
  const float* bias = a.bias;
  for (int i = 0; i < a.depth; ++i) {
    bool has_pe;
    const int in_dim = in_dim_of(i, has_pe);
    T* dst = nxt;
    T* trow = tape + a.t_post + i * w;
    dense(cur, ld, has_pe ? 0 : cp, in_dim, wf + off[i], w, [&](int s, int o, float v) {
      const T tv = cvt<T>(fmaxf(v + bias[o], 0.f));
      dst[s * ld + cp + o] = tv;
      trow[(size_t)s * ldt + o] = tv;
    });
    bias += w;
    __syncthreads();
    swap();
  }
  bias += 1;  // alpha
  {
    T* dst = nxt;
    dense(cur, ld, cp, w, wf + off[a.depth + 1], w, [&](int s, int o, float v) {
      const T tv = cvt<T>(v + bias[o]);
      dst[s * ld + o] = tv;
      tape[(size_t)s * ldt + a.t_feat + o] = tv;
    });
  }
  bias += w;
  if (per_sample) pe_fill(nxt, ld, w, a.cd, a.dir, a.dx, a.dy, a.dz, n0, lim);
  __syncthreads();
  swap();
  if (per_sample) {
    for (int idx = threadIdx.x; idx < TN * a.cd; idx += blockDim.x) {
      const int s = idx / a.cd, c = idx % a.cd;
      tape[(size_t)s * ldt + a.t_dpe + c] = cur[s * ld + w + c];
    }
  }
  dense(cur, ld, 0, v_dim, wf + off[a.depth + 2], half, [&](int s, int o, float v) {
    v += bias[o];
    const int gs = n0 + s;
    if (!per_sample && gs < lim) v += a.dir_part[(size_t)(gs / a.spr) * half + o];
    tape[(size_t)s * ldt + a.t_h2 + o] = cvt<T>(fmaxf(v, 0.f));
  });
  __syncthreads();

  // ---- backward
  // cotangents (rounded to the compute dtype, as the dots take them), and
  // d_pre2 = [h2 > 0] * (g_rgb . W_rgb) on CUDA cores
  for (int idx = threadIdx.x; idx < TN * 4; idx += blockDim.x) {
    const int s = idx / 4, c = idx % 4, gs = n0 + s;
    tape[(size_t)s * ldt + a.t_g + c] = cvt<T>(gs < lim ? a.g[(size_t)c * n + gs] : 0.f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TN * half; idx += blockDim.x) {
    const int s = idx / half, o = idx % half;
    const T* row = tape + (size_t)s * ldt;
    float dh = 0.f;
    for (int c = 0; c < 3; ++c) dh += tof(row[a.t_g + 1 + c]) * a.head_rgb[c * half + o];
    const T tv = cvt<T>(tof(row[a.t_h2 + o]) > 0.f ? dh : 0.f);
    cur[s * ld + o] = tv;
    tape[(size_t)s * ldt + a.t_dpre2 + o] = tv;
  }
  __syncthreads();
  // [d_feature, d_dirpe] = d_pre2 . W_views
  {
    T* dst = nxt;
    const int dld = a.dld;
    dense(cur, ld, 0, half, wb + off[a.depth + 2], v_dim, [&](int s, int o, float v) {
      if (o < w) {
        const T tv = cvt<T>(v);
        dst[s * ld + cp + o] = tv;
        tape[(size_t)s * ldt + a.t_dfeat + o] = tv;
      } else {
        dpe[s * dld + o - w] = v;
      }
    });
  }
  __syncthreads();
  if (per_sample) {
    for (int s = threadIdx.x; s < TN; s += blockDim.x) {
      const int gs = n0 + s;
      if (gs >= lim) continue;
      float d[3];
      pe_bwd(a.dir, a.dx[gs], a.dy[gs], a.dz[gs], dpe + s * a.dld, d);
      for (int c = 0; c < 3; ++c) a.d_dir[(size_t)c * n + gs] = d[c];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < TN * a.dld; idx += blockDim.x) dpe[idx] = 0.f;
  swap();
  // top of the trunk: d_h = d_feature . W_feature + g_alpha W_alpha
  {
    T* dst = nxt;
    const T* post = tape + a.t_post + (a.depth - 1) * w;
    T* dpre = tape + a.t_dpre + (a.depth - 1) * w;
    dense(cur, ld, cp, w, wb + off[a.depth + 1], w, [&](int s, int o, float v) {
      v += tof(tape[(size_t)s * ldt + a.t_g]) * a.head_a[o];
      const T tv = cvt<T>(tof(post[(size_t)s * ldt + o]) > 0.f ? v : 0.f);
      dst[s * ld + cp + o] = tv;
      dpre[(size_t)s * ldt + o] = tv;
    });
  }
  __syncthreads();
  swap();
  // down the trunk: layer i's input gradient; its PE part accumulates in f32
  for (int i = a.depth - 1; i >= 0; --i) {
    bool has_pe;
    const int in_dim = in_dim_of(i, has_pe);
    const int pe_cols = has_pe ? cp : 0;
    T* dst = nxt;
    // layer i's input holds post_{i-1} after the PE columns (none for i = 0)
    const int prev = i > 0 ? i - 1 : 0;
    const T* post = tape + a.t_post + prev * w;
    T* dpre = tape + a.t_dpre + prev * w;
    const int dld = a.dld;
    dense(cur, ld, cp, w, wb + off[i], in_dim, [&](int s, int o, float v) {
      if (o < pe_cols) {
        dpe[s * dld + o] += v;
      } else {
        const int h = o - pe_cols;
        const T tv = cvt<T>(tof(post[(size_t)s * ldt + h]) > 0.f ? v : 0.f);
        dst[s * ld + cp + h] = tv;
        dpre[(size_t)s * ldt + h] = tv;
      }
    });
    __syncthreads();
    swap();
  }
  for (int s = threadIdx.x; s < TN; s += blockDim.x) {
    const int gs = n0 + s;
    if (gs >= lim) continue;
    float d[3];
    pe_bwd(a.pos, a.px[gs], a.py[gs], a.pz[gs], dpe + s * a.dld, d);
    for (int c = 0; c < 3; ++c) a.d_planes[(size_t)c * n + gs] = d[c];
  }
}

// -------------------------------------------------------------- dW pass

struct DwLayer {
  int a_off, m;                  // A = tape[:, a_off : a_off + m]
  int b_off1, n1, b_off2, n2;    // B = [tape[:, b_off1 : +n1], tape[:, b_off2 : +n2], 1]
  int ldc, c_off, bias_off;      // dW[m][n] at c_off + m ldc + n, db[m] at bias_off + m
  int tiles_n, tile0;            // 64 x 64 output tiles: n-tiles, first tile id
};

struct DwArgs {
  const void* tape;
  int ldt, k, kper;  // rows of the chunk, rows per split
  int n_layers, total;
  float* partial;    // [KSPLIT, total]
  DwLayer L[MAX_LAYERS];
};

template <typename T>
__device__ __forceinline__ float b_at(const T* row, const DwLayer& l, int c) {
  if (c < l.n1) return tof(row[l.b_off1 + c]);
  if (c < l.n1 + l.n2) return tof(row[l.b_off2 + c - l.n1]);
  return c == l.n1 + l.n2 ? 1.f : 0.f;
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
  const float* tape = static_cast<const float*>(a.tape);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += 16) {
    for (int idx = threadIdx.x; idx < 16 * 64; idx += THREADS) {
      const int kk = idx / 64, c = idx % 64, row = k0 + kk;
      const float* r = tape + (size_t)row * a.ldt;
      const bool in = row < k_hi;
      as[kk][c] = in && m0 + c < l.m ? r[l.a_off + m0 + c] : 0.f;
      bs[kk][c] = in ? b_at(r, l, n0 + c) : 0.f;
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
  const bf16* tape = static_cast<const bf16*>(a.tape);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int wm = warp % 4, wn = warp / 4;
  const bf16 zero = __float2bfloat16(0.f), one = __float2bfloat16(1.f);
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += DW_BK) {
    for (int idx = threadIdx.x; idx < DW_BK * 64; idx += THREADS) {
      const int kk = idx / 64, c = idx % 64, row = k0 + kk;
      const bf16* r = tape + (size_t)row * a.ldt;
      const bool in = row < k_hi;
      as[c][kk] = in && m0 + c < l.m ? r[l.a_off + m0 + c] : zero;
      const int cb = n0 + c;
      bf16 bv = zero;
      if (in) {
        if (cb < l.n1) bv = r[l.b_off1 + cb];
        else if (cb < l.n1 + l.n2) bv = r[l.b_off2 + cb - l.n1];
        else if (cb == l.n1 + l.n2) bv = one;
      }
      bs[c][kk] = bv;
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

// per-ray d_dir[r0 + r][o] = sum over the ray's samples of d_pre2, in order
template <typename T>
__global__ void bwd_ddir_kernel(const T* tape, int ldt, int t_dpre2, int rays, int spr,
                                int half, int r0, float* d_dir) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rays * half) return;
  const int r = idx / half, o = idx % half;
  const T* p = tape + (size_t)r * spr * ldt + t_dpre2 + o;
  float s = 0.f;
  for (int j = 0; j < spr; ++j) s += tof(p[(size_t)j * ldt]);
  d_dir[(size_t)(r0 + r) * half + o] = s;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {
  int cp, cd, ldt, t_post, t_feat, t_dpe, t_h2, t_g, t_dpre, t_dfeat, t_dpre2;
};

Layout layout(int depth, int width, int pos_dim, int dir_dim, int per_sample, int bf16) {
  Layout t;
  t.cp = bf16 ? round_up(pos_dim, 16) : pos_dim;
  t.cd = bf16 ? round_up(dir_dim, 16) : dir_dim;
  t.t_post = t.cp;
  t.t_feat = t.t_post + depth * width;
  t.t_dpe = t.t_feat + width;
  t.t_h2 = t.t_dpe + (per_sample ? t.cd : 0);
  t.t_g = t.t_h2 + width / 2;
  t.t_dpre = t.t_g + 4;
  t.t_dfeat = t.t_dpre + depth * width;
  t.t_dpre2 = t.t_dfeat + width;
  t.ldt = round_up(t.t_dpre2 + width / 2, 8);
  return t;
}

}  // namespace

// Columns of one tape row (elements of the compute dtype).
extern "C" int nerf_mlp_bwd_tape_cols(int depth, int width, int pos_dim, int dir_dim,
                                      int per_sample, int bf16) {
  return layout(depth, width, pos_dim, dir_dim, per_sample, bf16).ldt;
}

// Planes [N] f32; dir_part [R, W/2] (per-ray) or dx/dy/dz [N] (per-sample);
// g [4, N]; wf: the forward kernel's packed weights (nerf_mlp.cu); wb: the
// same layers, same order and sizes, as f32 [out, in] (bf16 == 0) or bf16
// [in, out] with the PE / dir-PE row blocks padded to multiples of 16
// (bf16 == 1); bias: forward order; head_a [W] and head_rgb [3, W/2] the
// head weights rounded to the compute dtype, f32.
// Outputs: d_planes [3, N]; d_dir [R, W/2] or [3, N]; grad: per layer in
// forward order (trunk, alpha, feature, views, rgb) dW [out, in] then db,
// f32, `total` floats. Scratch: tape [chunk_rays * spr rounded up to 64,
// tape_cols], partial [ksplit, total] f32. Chunks hold chunk_rays whole rays.
// Returns the first CUDA error (0 on success), -1 for an inconsistent layout.
extern "C" int nerf_mlp_bwd_launch(
    const float* px, const float* py, const float* pz, const float* dx, const float* dy,
    const float* dz, const float* dir_part, const float* g, const void* wf, const void* wb,
    const float* bias, const float* head_a, const float* head_rgb, float* d_planes,
    float* d_dir, float* grad, void* tape, float* partial, int n, int spr, int depth,
    int width, int skip_mask, int pos_mapping, int pos_include, int pos_bands, int pos_dim,
    const float* pos_coef, int dir_mapping, int dir_include, int dir_bands, int dir_dim,
    const float* dir_coef, int bf16, int chunk_rays, int ksplit, int total, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_sample = dx != nullptr;
  const Layout t = layout(depth, width, pos_dim, dir_dim, per_sample, bf16);
  const int half = width / 2;
  if (depth + 4 > MAX_LAYERS) return -1;

  // dW descriptors, forward layer order
  DwArgs d;
  d.tape = tape;
  d.ldt = t.ldt;
  d.partial = partial;
  d.n_layers = depth + 4;
  int c_off = 0, tiles = 0;
  auto add = [&](int li, int a_off, int m, int b1, int n1, int b2, int n2, int ldc) {
    DwLayer& l = d.L[li];
    l.a_off = a_off; l.m = m; l.b_off1 = b1; l.n1 = n1; l.b_off2 = b2; l.n2 = n2;
    l.ldc = ldc; l.c_off = c_off; l.bias_off = c_off + m * ldc;
    c_off += m * ldc + m;
    l.tiles_n = (n1 + n2 + 1 + 63) / 64;
    l.tile0 = tiles;
    tiles += ((m + 63) / 64) * l.tiles_n;
  };
  for (int i = 0; i < depth; ++i) {
    const int a_off = t.t_dpre + i * width;
    const bool after_skip = i > 0 && ((skip_mask >> (i - 1)) & 1);
    const int prev = t.t_post + (i - 1) * width;
    if (i == 0) add(i, a_off, width, 0, pos_dim, 0, 0, pos_dim);
    else if (after_skip) add(i, a_off, width, 0, pos_dim, prev, width, pos_dim + width);
    else add(i, a_off, width, prev, width, 0, 0, width);
  }
  const int top = t.t_post + (depth - 1) * width;
  add(depth, t.t_g, 1, top, width, 0, 0, width);
  add(depth + 1, t.t_dfeat, width, top, width, 0, 0, width);
  add(depth + 2, t.t_dpre2, half, t.t_feat, width, t.t_dpe, per_sample ? dir_dim : 0,
      width + dir_dim);
  add(depth + 3, t.t_g + 1, 3, t.t_h2, half, 0, 0, half);
  if (c_off != total) return -1;
  d.total = total;

  ChainArgs c;
  c.px = px; c.py = py; c.pz = pz; c.dx = dx; c.dy = dy; c.dz = dz;
  c.dir_part = dir_part; c.g = g; c.wf = wf; c.wb = wb; c.bias = bias;
  c.head_a = head_a; c.head_rgb = head_rgb; c.d_planes = d_planes; c.d_dir = d_dir;
  c.tape = tape;
  c.pos = PE{pos_mapping, pos_include, pos_bands, pos_dim, pos_coef};
  c.dir = PE{dir_mapping, dir_include, dir_bands, dir_dim, dir_coef};
  c.n = n; c.spr = spr; c.depth = depth; c.width = width; c.skip_mask = skip_mask;
  c.cp = t.cp; c.cd = t.cd;
  c.dld = t.cp > t.cd ? t.cp : t.cd;
  int ld = t.cp + width;
  if (per_sample && width + t.cd > ld) ld = width + t.cd;
  c.ld = bf16 ? round_up(ld - 8, 64) + 8 : ld;  // bf16: = 8 mod 64, conflict-free fragments
  c.ldt = t.ldt; c.t_post = t.t_post; c.t_feat = t.t_feat; c.t_dpe = t.t_dpe;
  c.t_h2 = t.t_h2; c.t_g = t.t_g; c.t_dpre = t.t_dpre; c.t_dfeat = t.t_dfeat;
  c.t_dpre2 = t.t_dpre2;

  const int esize = bf16 ? 2 : 4;
  const int smem = 2 * TN * c.ld * esize + TN * c.dld * 4;
  void (*chain)(ChainArgs) = bf16 ? bwd_chain_kernel<__nv_bfloat16> : bwd_chain_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)total, st)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)total * ksplit, st)) !=
      cudaSuccess)
    return (int)err;

  const int chunk = chunk_rays * spr;
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = n - c0 < chunk ? n - c0 : chunk;
    c.c0 = c0;
    c.lim = c0 + cn;
    chain<<<(cn + TN - 1) / TN, THREADS, smem, st>>>(c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    d.k = cn;
    d.kper = round_up((cn + ksplit - 1) / ksplit, 32);
    const dim3 grid(tiles, ksplit);
    if (bf16) bwd_dw_bf16_kernel<<<grid, THREADS, 0, st>>>(d);
    else bwd_dw_f32_kernel<<<grid, THREADS, 0, st>>>(d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, grad, total, ksplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (!per_sample) {
      const int rays = cn / spr;
      const int threads = rays * half;
      if (bf16)
        bwd_ddir_kernel<__nv_bfloat16><<<(threads + 255) / 256, 256, 0, st>>>(
            static_cast<const __nv_bfloat16*>(tape), t.ldt, t.t_dpre2, rays, spr, half,
            c0 / spr, d_dir);
      else
        bwd_ddir_kernel<float><<<(threads + 255) / 256, 256, 0, st>>>(
            static_cast<const float*>(tape), t.ldt, t.t_dpre2, rays, spr, half, c0 / spr,
            d_dir);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
