// Recompute backward of the fused PE + no-viewdirs MLP (the VJP of
// offset_mlp.cu): per-layer dW and db, and d_axes [D, N] through the PE.
//
// Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_offset_bwd` (kernel body
// :671, pallas_call :773, wrapper `make_offset_mlp_vjp` :797). Semantics kept
// from the TPU kernel: the forward is recomputed in the compute dtype; ReLU
// masks come from the recomputed post-activation values (> 0, compared in
// f32); in bf16 every product takes bf16 operands, the cotangents included,
// and accumulates in f32; the PE, its derivative and the d_pe sum are f32.
//
// The design is nerf_mlp_bwd.cu's, without the view head and d_dir:
//   - `offset_chain_kernel`, one block per 64-sample tile: recompute the
//     forward in two ping-pong shared-memory buffers, then walk d_h down the
//     trunk; every value a dW product reads (PE, the trunk posts, the
//     cotangents, each layer's pre-activation gradient) goes to a tape in
//     global memory that holds one chunk of samples and is reused; the PE
//     part of the input gradients accumulates in an f32 shared-memory buffer
//     and leaves through the PE derivative as d_axes;
//   - `bwd_dw_*_kernel` and `bwd_reduce_kernel` (mlp_dw.cuh): dW and db of
//     every layer from the tape as fixed-order partials. No atomics, so two
//     runs give bit-identical gradients.
// f32 products are FMAs on CUDA cores (bound by FMA issue, ~3x the forward's
// 0.57 M multiply-adds a sample), bf16 products mma.sync m16n8k16; the O-wide
// head (O = 3) runs on CUDA cores.
//
// The "hbm" configuration (`fwd_tape`, the TPU kernel's `tape=`): the forward
// kernel has written the trunk's post-ReLU values [N, depth * W]; the chain
// pass skips the trunk recompute and takes the ReLU masks from those rows,
// and the dW pass reads them in place (`DwArgs::post`), as in
// nerf_mlp_bwd.cu. Gradients equal the recompute configuration's bit for
// bit.

#include "mlp_dw.cuh"

namespace {

struct ChainArgs {
  Axes ax;              // D input planes [N]
  const float* g;       // [O, N] cotangents of the raw outputs
  const void* wf;       // trunk weights as the forward kernel packs them
  const void* wb;       // the same layers transposed (see the wrapper)
  const float* bias;    // trunk biases
  const float* head;    // [O, W] head weights rounded to the compute dtype, f32
  float* d_axes;        // [D, N]
  void* tape;           // [chunk rows, ldt] compute dtype
  const void* fwd_tape; // [N, depth * W] posts from the forward, or null
  PE pos;
  int n, depth, width, skip_mask, n_out;
  int ld, cp;           // smem row stride, PE width (padded for bf16)
  int ldt, t_post, t_g, t_dpre;
  int c0, lim;          // chunk's first sample; samples >= lim are padding
};

template <typename T>
__global__ void __launch_bounds__(THREADS) offset_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + TN * a.ld;
  float* dpe = reinterpret_cast<float*>(nxt + TN * a.ld);  // [TN][cp] f32
  const int t0 = blockIdx.x * TN, n0 = a.c0 + t0, lim = a.lim;
  const int w = a.width, cp = a.cp, ld = a.ld, n = a.n, ldt = a.ldt;
  T* tape = static_cast<T*>(a.tape) + (size_t)t0 * ldt;
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
  size_t off[MAX_LAYERS];
  {
    size_t o = 0;
    bool hp;
    for (int i = 0; i < a.depth; ++i) { off[i] = o; o += (size_t)in_dim_of(i, hp) * w; }
  }
  const T* wf = static_cast<const T*>(a.wf);
  const T* wb = static_cast<const T*>(a.wb);

  // ---- forward recompute; every value that a dW product reads goes to the tape
  pe_fill_nd(cur, ld, 0, cp, a.pos, a.ax, n0, lim);
  pe_fill_nd(nxt, ld, 0, cp, a.pos, a.ax, n0, lim);
  for (int idx = threadIdx.x; idx < TN * cp; idx += blockDim.x) dpe[idx] = 0.f;
  __syncthreads();
  for (int idx = threadIdx.x; idx < TN * cp; idx += blockDim.x) {
    const int s = idx / cp, c = idx % cp;
    tape[(size_t)s * ldt + c] = cur[s * ld + c];
  }
  const float* bias = a.bias;
  for (int i = 0; i < (fwd == nullptr ? a.depth : 0); ++i) {
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

  // ---- backward
  // cotangents, rounded to the compute dtype as the products take them
  for (int idx = threadIdx.x; idx < TN * 4; idx += blockDim.x) {
    const int s = idx / 4, c = idx % 4, gs = n0 + s;
    tape[(size_t)s * ldt + a.t_g + c] =
        cvt<T>(c < a.n_out && gs < lim ? a.g[(size_t)c * n + gs] : 0.f);
  }
  __syncthreads();
  // top of the trunk: d_h = g . W_head on CUDA cores, masked by the last post
  {
    const T* post = posts + (a.depth - 1) * w;
    T* dpre = tape + a.t_dpre + (a.depth - 1) * w;
    for (int idx = threadIdx.x; idx < TN * w; idx += blockDim.x) {
      const int s = idx / w, o = idx % w;
      const T* row = tape + (size_t)s * ldt;
      float dh = 0.f;
      for (int c = 0; c < a.n_out; ++c) dh += tof(row[a.t_g + c]) * a.head[c * w + o];
      const bool on = n0 + s < lim && tof(post[(size_t)s * ldp + o]) > 0.f;
      const T tv = cvt<T>(on ? dh : 0.f);
      cur[s * ld + cp + o] = tv;
      dpre[(size_t)s * ldt + o] = tv;
    }
  }
  __syncthreads();
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
    dense(cur, ld, cp, w, wb + off[i], in_dim, [&](int s, int o, float v) {
      if (o < pe_cols) {
        dpe[s * cp + o] += v;
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
    float d[4];
    pe_bwd_nd(a.pos, a.ax, gs, dpe + s * cp, d);
    for (int c = 0; c < a.ax.d; ++c) a.d_axes[(size_t)c * n + gs] = d[c];
  }
}

struct Layout {
  int cp, ldt, t_post, t_g, t_dpre;
};

Layout layout(int depth, int width, int pos_dim, int bf16) {
  Layout t;
  t.cp = bf16 ? round_up(pos_dim, 16) : pos_dim;
  t.t_post = t.cp;
  t.t_g = t.t_post + depth * width;
  t.t_dpre = t.t_g + 4;
  t.ldt = round_up(t.t_dpre + depth * width, 8);
  return t;
}

}  // namespace

// Columns of one tape row (elements of the compute dtype).
extern "C" int offset_mlp_bwd_tape_cols(int depth, int width, int pos_dim, int bf16) {
  return layout(depth, width, pos_dim, bf16).ldt;
}

// Planes ax0..ax3 [N] f32 (the first `d_in` are read); g [O, N], O <= 4; wf:
// the forward kernel's packed trunk weights (offset_mlp.cu); wb: the same
// layers, same order and sizes, as f32 [out, in] (bf16 == 0) or bf16
// [in, out] with the PE row block padded to a multiple of 16 (bf16 == 1);
// bias: the trunk's; head [O, W] rounded to the compute dtype, f32.
// fwd_tape: the forward kernel's tape [N, depth * width] in the compute
// dtype, or null to recompute the trunk.
// Outputs: d_axes [D, N]; grad: per layer in forward order (trunk, head)
// dW [out, in] then db, f32, `total` floats. Scratch: tape [chunk rounded up
// to 64, tape_cols], partial [ksplit, total] f32. `chunk` samples a pass.
// Returns the first CUDA error (0 on success), -1 for an inconsistent layout.
extern "C" int offset_mlp_bwd_launch(
    const float* ax0, const float* ax1, const float* ax2, const float* ax3, int d_in,
    const float* g, const void* fwd_tape, const void* wf, const void* wb, const float* bias, const float* head,
    float* d_axes, float* grad, void* tape, float* partial, int n, int depth, int width,
    int skip_mask, int n_out, int pos_include, int pos_bands, int pos_dim,
    const float* pos_coef, int bf16, int chunk, int ksplit, int total, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Layout t = layout(depth, width, pos_dim, bf16);
  if (depth + 1 > MAX_LAYERS || n_out > 4 || d_in > 4 || chunk % TN) return -1;

  // dW descriptors, forward layer order
  const int esize = bf16 ? 2 : 4;
  DwArgs d;
  d.tape = tape;
  d.ldt = t.ldt;
  d.ldp = fwd_tape != nullptr ? depth * width : t.ldt;
  d.partial = partial;
  d.n_layers = depth + 1;
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
  add(depth, t.t_g, n_out, (depth - 1) * width, width, 1, 0, 0, 0, width);
  if (c_off != total) return -1;
  d.total = total;

  ChainArgs c;
  c.ax = Axes{{ax0, ax1, ax2, ax3}, d_in};
  c.g = g; c.wf = wf; c.wb = wb; c.bias = bias; c.head = head; c.d_axes = d_axes;
  c.tape = tape; c.fwd_tape = fwd_tape;
  c.pos = PE{0, pos_include, pos_bands, pos_dim, pos_coef};
  c.n = n; c.depth = depth; c.width = width; c.skip_mask = skip_mask; c.n_out = n_out;
  c.cp = t.cp;
  const int ld = t.cp + width;
  c.ld = bf16 ? round_up(ld - 8, 64) + 8 : ld;  // bf16: = 8 mod 64, conflict-free fragments
  c.ldt = t.ldt; c.t_post = t.t_post; c.t_g = t.t_g; c.t_dpre = t.t_dpre;

  const int smem = 2 * TN * c.ld * esize + TN * t.cp * 4;
  void (*chain)(ChainArgs) =
      bf16 ? offset_chain_kernel<__nv_bfloat16> : offset_chain_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)total, st)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)total * ksplit, st)) !=
      cudaSuccess)
    return (int)err;

  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = n - c0 < chunk ? n - c0 : chunk;
    c.c0 = c0;
    c.lim = c0 + cn;
    chain<<<(cn + TN - 1) / TN, THREADS, smem, st>>>(c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    d.k = cn;
    d.post = fwd_tape != nullptr
                 ? static_cast<const char*>(fwd_tape) + (size_t)c0 * d.ldp * esize
                 : static_cast<const char*>(tape) + (size_t)t.t_post * esize;
    d.kper = round_up((cn + ksplit - 1) / ksplit, 32);
    const dim3 grid(tiles, ksplit);
    if (bf16) bwd_dw_bf16_kernel<<<grid, THREADS, 0, st>>>(d);
    else bwd_dw_f32_kernel<<<grid, THREADS, 0, st>>>(d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, grad, total, ksplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
