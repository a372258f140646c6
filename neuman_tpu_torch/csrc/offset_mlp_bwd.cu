// Recompute backward of the fused PE + no-viewdirs MLP (the VJP of
// offset_mlp.cu): per-layer dW and db, and d_axes [D, N] through the PE.
//
// Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_offset_bwd` (kernel body
// :671, pallas_call :773, wrapper `make_offset_mlp_vjp` :797). Semantics kept
// from the TPU kernel: the forward is recomputed in the compute dtype; ReLU
// masks come from the post-activation values (> 0); in bf16 every product
// takes bf16 operands, the cotangents included, and accumulates in f32; the
// PE, its derivative and the sum of the PE gradients are f32.
//
// What bounds it on an H100: ~3x the forward's multiply-adds (~1.5 M a
// sample at 8 x 256: the forward, the input gradients, the weight
// gradients) at 989 TFLOP/s in bf16 and 67 TFLOP/s in f32, and the tape:
// ~8.5 KB (bf16) / ~17 KB (f32) a sample written by the chain pass and read
// back by the dW pass.
//
// nerf_mlp_bwd.cu's design on mlp_hopper.cuh's building blocks, without the
// view head; two passes per chunk of samples:
//
// 1. `offset_chain_kernel`: persistent blocks, weight slabs streamed by a
//    producer warp through a shared-memory ring with cp.async.bulk on
//    mbarriers, wgmma in bf16 with two 64-sample tiles a block, register
//    tiles in f32. It recomputes a tile's trunk with the forward kernel's
//    function (`trunk`), takes d_h = g . W_head on CUDA cores (O = 3
//    outputs), then propagates d_h down the trunk with the transposed
//    weights, each layer's h part written over its input in shared memory.
//    The PE part of a layer's input gradient (128 columns: the 84 of the PE
//    and zero padding) is summed in f32 in a per-chunk scratch in device
//    memory (each thread adds to the elements it wrote itself; shared memory
//    holds two bf16 tiles of 384 columns and the ring, and has no room for an
//    f32 d_pe beside them), and leaves through the PE derivative as d_axes.
//    Every value a dW product reads (PE, posts, the cotangents, every
//    layer's d_pre) goes to the chunk's tape, 16 bytes a store.
// 2. `dw_kernel` and `dw_reduce_kernel` (mlp_hopper.cuh): dW = d_pre^T h_in
//    of every layer from the tape as a Hopper GEMM (128 x 128 output tiles,
//    TMA boxes into the ring, wgmma with MN-major operands in bf16, register
//    tiles in f32), the chunk's samples split into contiguous ranges whose
//    partials are summed in order. No atomics: two runs give bit-identical
//    gradients.
//
// The "hbm" configuration (`fwd_tape`, the TPU kernel's `tape=`): the
// forward kernel has written the trunk's post-ReLU values [N, depth * W];
// the chain pass loads the last layer's posts instead of recomputing the
// trunk and takes the ReLU masks from the forward's rows, and the dW pass
// reads them in place through a second tensor map. The forward's trunk is
// the chain pass's (`trunk`), so the gradients equal the recompute
// configuration's bit for bit.

#include "mlp_hopper.cuh"

namespace {

struct ChainArgs {
  Planes ax;                 // D input planes [N]
  const unsigned char* img;  // weight slab images: the forward trunk's, then the transposed layers'
  const uint2* slabs;
  int n_slabs;
  const float* bias;         // trunk biases
  const float* g;            // [O, N] cotangents of the raw outputs
  const float* head;         // [O, W] head weights rounded to the compute dtype, f32
  float* d_axes;             // [D, N]
  void* tape;                // [chunk rows, ldt] compute dtype
  float* dpe;                // [chunk rows, 64 pb] f32 PE gradients
  const void* fwd_tape;      // [N, depth * W] posts from the forward, or null
  PE pos;
  int n, depth, skip_mask, n_out, pb;
  int ldt, t_post, t_g, t_dpre;
  int c0, lim;               // the chunk's first sample; samples >= lim are padding
};

// The PE part of a transposed trunk product: outputs 64 pb wide, into d_pe.
template <typename T, class Ep>
__device__ void pe_part(const Tile<T>& t, Ring& ring, int pb, int kb, Ep ep) {
  const Mask<T> no_mask{nullptr, 0};
  const Rows<T> no_rows{nullptr, 0, 0};
  if (pb == 1) product<64, false>(t, ring, pb, kb, 0, ep, no_mask, no_rows);
  else product<128, false>(t, ring, pb, kb, 0, ep, no_mask, no_rows);
}

template <typename T, int W>
__device__ void chain(const ChainArgs& a, Ring& ring, unsigned char* rest, int units, int tiles) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  const int gi = threadIdx.x / 32 / (CONSUMER_WARPS / G);
  const int pb = a.pb, h0 = 64 * pb, ldd = 64 * pb;
  Tile<T> t = make_tile<T, W>(rest, gi, false, pb, false);
  const int ldt = a.ldt, lim = a.lim, depth = a.depth;
  const T* fwd = static_cast<const T*>(a.fwd_tape);
  const int ldp = fwd != nullptr ? depth * W : ldt;
  float* gs = t.scr;  // [HT][4] cotangents
  const auto keep = [](int, int, float v) { return v; };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u * G + gi;
    if (tile >= tiles) {
      drain(ring, a.n_slabs);
      continue;
    }
    t.n0 = a.c0 + tile * HT;
    t.rows = min(HT, lim - t.n0);
    const int n0 = t.n0;
    T* tape = static_cast<T*>(a.tape) + (size_t)tile * HT * ldt;
    float* dpe = a.dpe + (size_t)tile * HT * ldd;
    auto col = [&](int c) { return Rows<T>{tape + c, ldt, HT}; };
    // the trunk posts of the tile's first sample: the chunk tape's, or the forward's
    const T* posts = fwd != nullptr ? fwd + (size_t)n0 * ldp : tape + a.t_post;

    // ---- forward; every value a dW product reads goes to the tape
    pe_fill(t, 0, pb, a.pos, a.ax, lim);
    rows_out(t, 0, 64 * pb, col(0));
    if (fwd == nullptr)
      trunk<T, W>(t, ring, a.bias, depth, a.skip_mask, pb, tape + a.t_post, ldt, HT);
    else rows_in(t, h0, W, posts + (depth - 1) * W, ldp);

    // ---- backward
    // cotangents, rounded to the compute dtype as the products take them
    for (int idx = t.g.tid; idx < HT * 4; idx += t.g.nthr) {
      const int s = idx / 4, c = idx % 4;
      const T v = cvt<T>(c < a.n_out && n0 + s < lim ? a.g[(size_t)c * a.n + n0 + s] : 0.f);
      gs[idx] = tof(v);
      tape[(size_t)s * ldt + a.t_g + c] = v;
    }
    t.g.sync();
    // top of the trunk: d_pre = [post > 0] (g . W_head), over the last posts
    for (int idx = t.g.tid; idx < HT * W; idx += t.g.nthr) {
      const int s = sizeof(T) == 2 ? idx / W : idx % HT, o = sizeof(T) == 2 ? idx % W : idx / HT;
      float dh = 0.f;
      for (int c = 0; c < a.n_out; ++c) dh = fmaf(gs[s * 4 + c], a.head[c * W + o], dh);
      T* p = t.act.at(s, h0 + o);
      *p = cvt<T>(s < t.rows && tof(*p) > 0.f ? dh : 0.f);
    }
    if (sizeof(T) == 2) fence_async_smem();
    t.g.sync();
    rows_out(t, h0, W, col(a.t_dpre + (depth - 1) * W));
    // down the trunk: layer i's input gradient, its PE part first (summed
    // in f32 in d_pe: the first part stored, the later ones added, as the
    // plain version sums from zero), then the h part over the tile
    bool fresh = true;
    for (int i = depth - 1; i >= 0; --i) {
      if (has_pe(a.skip_mask, i)) {
        pe_part(t, ring, pb, W / 64, [dpe, ldd, fresh](int s, int o, float v) {
          float* q = dpe + s * ldd + o;
          *q = fresh ? v : *q + v;
          return v;
        });
        fresh = false;
      }
      if (i > 0)
        product<W, true>(t, ring, pb, W / 64, h0, keep, Mask<T>{posts + (i - 1) * W, ldp},
                         col(a.t_dpre + (i - 1) * W));
    }
    t.g.sync();  // every thread's d_pe sums are done
    for (int idx = t.g.tid; idx < HT * a.ax.d; idx += t.g.nthr) {
      const int s = idx % HT, c = idx / HT, g = n0 + s;
      if (g >= lim) continue;
      const float* x = c == 0 ? a.ax.p[0] : c == 1 ? a.ax.p[1] : c == 2 ? a.ax.p[2] : a.ax.p[3];
      a.d_axes[(size_t)c * a.n + g] = pe_bwd_axis(a.pos, x[g], a.ax.d, c, dpe + s * ldd, 1);
    }
    t.g.sync();
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(HOPPER_THREADS, 1) offset_chain_kernel(ChainArgs a, int stages) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  Ring ring;
  unsigned char* rest = ring_setup(ring, stages);
  const int tiles = (a.lim - a.c0 + HT - 1) / HT, units = (tiles + G - 1) / G;
  const int warp = threadIdx.x / 32;
  if (warp >= CONSUMER_WARPS) {
    producer_registers();
    if (threadIdx.x == PRODUCER_WARP * 32) {
      const int reps = (int)blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
      produce(ring, a.img, a.slabs, a.n_slabs, reps);
    }
  } else {
    consumer_registers();
    chain<T, W>(a, ring, rest, units, tiles);
  }
}

template <typename T, int W>
int launch_chain(const ChainArgs& c, int blocks, cudaStream_t st) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  int stages = 0;
  const int smem = launch_smem<T>(W, false, c.pb, false, &stages);
  void (*kernel)(ChainArgs, int) = offset_chain_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int units = (blocks + G - 1) / G;
  kernel<<<min(units, sm_count()), HOPPER_THREADS, smem, st>>>(c, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the chain pass (kernel 0) or the dW pass (1).
extern "C" int offset_mlp_bwd_shared_bytes(int kernel, int width, int pos_dim, int half_precision) {
  if (kernel == 1) return block_bytes(0, 0, MAX_STAGES);
  int stages = 0;
  const int pb = (pos_dim + 63) / 64;
  return half_precision ? launch_smem<bf16>(width, false, pb, false, &stages)
                        : launch_smem<float>(width, false, pb, false, &stages);
}

// Planes ax0..ax3 [N] f32 (the first `d_in` are read); g [O, N], O <= 4;
// img / slabs: the weight slabs the chain pass reads, in the compute dtype
// as the wrapper lays them out (the forward's trunk, left out when fwd_tape
// is given, then the transposed trunk layers, top down, each with its PE
// part first), and their (offset, bytes); bias: the trunk's; head [O, W]
// rounded to the compute dtype, f32. fwd_tape: the forward kernel's tape
// [N, depth * width] in the compute dtype, or null to recompute the trunk.
// Outputs: d_axes [D, N]; grad: per layer in forward order (trunk, head)
// dW [out, in] then db, f32, `total` floats. Scratch: tape [chunk rounded up
// to 64, tape_cols], dpe [chunk rounded up to 64, 64 ceil(pos_dim / 64)]
// f32, partial [max_ranges, total] f32. `chunk` samples a pass, a multiple
// of 64; each chunk's dW pass splits its samples into at most max_ranges
// ranges. Columns of a chunk-tape row (`offset_mlp.tape_layout`): the PE at
// 0, the posts at t_post, the cotangents at t_g, the d_pre at t_dpre, ldt in
// all, each a multiple of 8. Width 64 or 256, a PE of at most 128 columns.
// Returns the first
// CUDA error (0 on success), -1 for an inconsistent layout or a net it does
// not take, -2 if the tensor maps cannot be made.
extern "C" int offset_mlp_bwd_launch(
    const float* ax0, const float* ax1, const float* ax2, const float* ax3, int d_in,
    const float* g, const void* fwd_tape, const void* img, const void* slabs, int n_slabs,
    const float* bias, const float* head, float* d_axes, float* grad, void* tape, float* dpe,
    float* partial, int n, int depth, int width, int skip_mask, int n_out, int pos_include,
    int pos_bands, int pos_dim, const float* pos_coef, int half_precision, int chunk,
    int max_ranges, int total, int t_post, int t_g, int t_dpre, int ldt, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  struct { int t_post, t_g, t_dpre, ldt; } t = {t_post, t_g, t_dpre, ldt};
  const bool hbm = fwd_tape != nullptr;
  if (depth + 1 > MAX_LAYERS || n_out < 1 || n_out > 4 || d_in < 1 || d_in > 4 ||
      pos_dim > 128 || chunk % HT || (width != 64 && width != 256) ||
      t_post < pos_dim || t_g < t_post + depth * width || t_dpre < t_g + 4 ||
      ldt < t_dpre + depth * width || (t_post | t_g | t_dpre | ldt) % 8)
    return -1;

  // dW subs in forward layer order
  DwArgs d;
  int c_off = 0, tiles = 0, ns = 0;
  auto add = [&](int a_col, int m, int b_map, int b_col, int n_cols, int col, int ldc, bool first) {
    DwSub& s = d.S[ns++];
    s.a_col = a_col; s.m = m; s.b_map = b_map; s.b_col = b_col; s.n = n_cols;
    s.c_off = c_off + col; s.ldc = ldc; s.bias_off = first ? c_off + m * ldc : -1;
    s.tiles_n = (n_cols + DW_TILE - 1) / DW_TILE;
    s.tile0 = tiles;
    tiles += (m + DW_TILE - 1) / DW_TILE * s.tiles_n;
  };
  // the posts of trunk layer i: in the forward's tape, or in the chunk tape
  const int post_map = hbm ? 1 : 0;
  auto post_col = [&](int i) { return (hbm ? 0 : t.t_post) + i * width; };
  for (int i = 0; i < depth; ++i) {
    const bool pe = i == 0 || ((skip_mask >> (i - 1)) & 1);
    const int pe_cols = pe ? pos_dim : 0, ldc = pe_cols + (i > 0 ? width : 0);
    const int a_col = t.t_dpre + i * width;
    if (pe) add(a_col, width, 0, 0, pos_dim, 0, ldc, true);
    if (i > 0) add(a_col, width, post_map, post_col(i - 1), width, pe_cols, ldc, !pe);
    c_off += width * ldc + width;
  }
  add(t.t_g, n_out, post_map, post_col(depth - 1), width, 0, width, true);  // head
  c_off += n_out * width + n_out;
  if (c_off != total) return -1;
  d.n_subs = ns;
  d.total = total;
  d.partial = partial;
  const int ranges = dw_ranges(tiles, max_ranges);

  const int rows = (chunk + HT - 1) / HT * HT;
  CUtensorMap tmap, pmap;
  if (!tape_map(&tmap, tape, rows, t.ldt, half_precision)) return -2;
  if (hbm && !tape_map(&pmap, fwd_tape, n, depth * width, half_precision)) return -2;
  if (!hbm) pmap = tmap;

  ChainArgs c;
  c.ax = Planes{{ax0, ax1, ax2, ax3}, d_in};
  c.img = static_cast<const unsigned char*>(img);
  c.slabs = static_cast<const uint2*>(slabs);
  c.n_slabs = n_slabs;
  c.bias = bias; c.g = g; c.head = head; c.d_axes = d_axes;
  c.tape = tape; c.dpe = dpe; c.fwd_tape = fwd_tape;
  c.pos = PE{0, pos_include, pos_bands, pos_dim, pos_coef};
  c.n = n; c.depth = depth; c.skip_mask = skip_mask; c.n_out = n_out;
  c.pb = (pos_dim + 63) / 64;
  c.ldt = t.ldt; c.t_post = t.t_post; c.t_g = t.t_g; c.t_dpre = t.t_dpre;

  const int smem_dw = block_bytes(0, 0, MAX_STAGES);
  void (*dw)(const CUtensorMap, const CUtensorMap, const DwArgs) =
      half_precision ? dw_kernel<bf16> : dw_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(dw, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dw);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)total, st)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)total * ranges, st)) !=
      cudaSuccess)
    return (int)err;

  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int cn = n - c0 < chunk ? n - c0 : chunk;
    c.c0 = c0;
    c.lim = c0 + cn;
    const int blocks = (cn + HT - 1) / HT;
    int e = 0;
    if (width == 256) e = half_precision ? launch_chain<bf16, 256>(c, blocks, st)
                                         : launch_chain<float, 256>(c, blocks, st);
    else e = half_precision ? launch_chain<bf16, 64>(c, blocks, st)
                            : launch_chain<float, 64>(c, blocks, st);
    if (e != 0) return e;
    d.k = cn;
    d.kper = round_up((cn + ranges - 1) / ranges, 64);
    d.post_row = c0;
    dw<<<dim3(tiles, ranges), HOPPER_THREADS, smem_dw, st>>>(tmap, pmap, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dw_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, grad, total, ranges);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
