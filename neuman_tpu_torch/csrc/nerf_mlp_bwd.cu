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
//    three passes per chunk, all in fixed order (the second and third are in
//    mlp_dw.cuh, shared with offset_mlp_bwd.cu): `bwd_chain_kernel` (one
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
//
// 5. The "hbm" configuration (`fwd_tape`, the TPU kernel's `tape=`): the
//    forward kernel has written the trunk's post-ReLU values, sample-major
//    [N, depth * W], and the chain pass reads them instead of recomputing
//    the trunk: it loads the last layer's posts for the feature product and
//    takes the ReLU masks from the forward's rows; PE, feature, the view
//    head and everything downstream are computed as in the recompute
//    configuration. The values are the recomputed ones bit for bit (the
//    same products in the same order), so the gradients are too. The dW
//    pass reads them in place too, through `DwArgs::post` (base pointer
//    and row stride of the posts). The alternative, the chain pass copying
//    the posts into the chunk tape for the dW pass, writes and reads the
//    posts once more for nothing the dW pass needs; it was the slower of
//    the two on an H100 while both existed, and was deleted.

#include "mlp_dw.cuh"

namespace {

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
  const void* fwd_tape;       // [N, depth * W] posts from the forward, or null
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
  // the trunk posts of the tile's first sample and their row stride: the
  // chunk tape's columns, or the forward's tape (rows at or past lim unread)
  const T* fwd = static_cast<const T*>(a.fwd_tape);
  const int ldp = fwd != nullptr ? a.depth * w : ldt;
  const T* posts = fwd != nullptr ? fwd + (size_t)n0 * ldp : tape + a.t_post;
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
  if (fwd == nullptr) {
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
  } else {
    // the last layer's posts feed the feature product; both buffers hold the PE
    const T* last = posts + (a.depth - 1) * w;
    for (int idx = threadIdx.x; idx < TN * w; idx += blockDim.x) {
      const int s = idx / w, o = idx % w;
      cur[s * ld + cp + o] = n0 + s < lim ? last[(size_t)s * ldp + o] : cvt<T>(0.f);
    }
    bias += a.depth * w;
    __syncthreads();
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
    const T* post = posts + (a.depth - 1) * w;
    T* dpre = tape + a.t_dpre + (a.depth - 1) * w;
    dense(cur, ld, cp, w, wb + off[a.depth + 1], w, [&](int s, int o, float v) {
      v += tof(tape[(size_t)s * ldt + a.t_g]) * a.head_a[o];
      const bool on = n0 + s < lim && tof(post[(size_t)s * ldp + o]) > 0.f;
      const T tv = cvt<T>(on ? v : 0.f);
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
    const T* post = posts + prev * w;
    T* dpre = tape + a.t_dpre + prev * w;
    const int dld = a.dld;
    dense(cur, ld, cp, w, wb + off[i], in_dim, [&](int s, int o, float v) {
      if (o < pe_cols) {
        dpe[s * dld + o] += v;
      } else {
        const int h = o - pe_cols;
        const bool on = n0 + s < lim && tof(post[(size_t)s * ldp + h]) > 0.f;
        const T tv = cvt<T>(on ? v : 0.f);
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
// head weights rounded to the compute dtype, f32. fwd_tape: the forward
// kernel's tape [N, depth * width] in the compute dtype, or null to recompute
// the trunk.
// Outputs: d_planes [3, N]; d_dir [R, W/2] or [3, N]; grad: per layer in
// forward order (trunk, alpha, feature, views, rgb) dW [out, in] then db,
// f32, `total` floats. Scratch: tape [chunk_rays * spr rounded up to 64,
// tape_cols], partial [ksplit, total] f32. Chunks hold chunk_rays whole rays.
// Returns the first CUDA error (0 on success), -1 for an inconsistent layout.
extern "C" int nerf_mlp_bwd_launch(
    const float* px, const float* py, const float* pz, const float* dx, const float* dy,
    const float* dz, const float* dir_part, const float* g, const void* fwd_tape,
    const void* wf, const void* wb,
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
  const int esize = bf16 ? 2 : 4;
  const bool direct = fwd_tape != nullptr;
  DwArgs d;
  d.tape = tape;
  d.ldt = t.ldt;
  d.ldp = direct ? depth * width : t.ldt;
  d.partial = partial;
  d.n_layers = depth + 4;
  int c_off = 0, tiles = 0;
  // p1, p2: the block is a trunk post, at an offset from `d.post`
  auto add = [&](int li, int a_off, int m, int b1, int n1, int p1, int b2, int n2, int p2,
                 int ldc) {
    DwLayer& l = d.L[li];
    l.a_off = a_off; l.m = m; l.b_off1 = b1; l.n1 = n1; l.b_off2 = b2; l.n2 = n2;
    l.p1 = p1; l.p2 = p2;
    l.ldc = ldc; l.c_off = c_off; l.bias_off = c_off + m * ldc;
    c_off += m * ldc + m;
    l.tiles_n = (n1 + n2 + 1 + 63) / 64;
    l.tile0 = tiles;
    tiles += ((m + 63) / 64) * l.tiles_n;
  };
  for (int i = 0; i < depth; ++i) {
    const int a_off = t.t_dpre + i * width;
    const bool after_skip = i > 0 && ((skip_mask >> (i - 1)) & 1);
    const int prev = (i - 1) * width;
    if (i == 0) add(i, a_off, width, 0, pos_dim, 0, 0, 0, 0, pos_dim);
    else if (after_skip) add(i, a_off, width, 0, pos_dim, 0, prev, width, 1, pos_dim + width);
    else add(i, a_off, width, prev, width, 1, 0, 0, 0, width);
  }
  const int top = (depth - 1) * width;
  add(depth, t.t_g, 1, top, width, 1, 0, 0, 0, width);
  add(depth + 1, t.t_dfeat, width, top, width, 1, 0, 0, 0, width);
  add(depth + 2, t.t_dpre2, half, t.t_feat, width, 0, t.t_dpe, per_sample ? dir_dim : 0, 0,
      width + dir_dim);
  add(depth + 3, t.t_g + 1, 3, t.t_h2, half, 0, 0, 0, 0, half);
  if (c_off != total) return -1;
  d.total = total;

  ChainArgs c;
  c.px = px; c.py = py; c.pz = pz; c.dx = dx; c.dy = dy; c.dz = dz;
  c.dir_part = dir_part; c.g = g; c.wf = wf; c.wb = wb; c.bias = bias;
  c.head_a = head_a; c.head_rgb = head_rgb; c.d_planes = d_planes; c.d_dir = d_dir;
  c.tape = tape; c.fwd_tape = fwd_tape;
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
    d.post = direct ? static_cast<const char*>(fwd_tape) + (size_t)c0 * d.ldp * esize
                    : static_cast<const char*>(tape) + (size_t)t.t_post * esize;
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
