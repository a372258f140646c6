// Recompute backward of the fused PE + NeRF MLP (the VJP of nerf_mlp.cu).
//
// Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_mlp_bwd` (kernel body
// :184, pallas_call :371, wrapper `make_mlp_vjp` :417, `tape=` :229-240) in
// both direction modes: per-ray (dir_part [R, W/2] in, d_dir [R, W/2] out)
// and per-sample (direction planes in, d_dir 3 x [N] out), both PE
// mappings, f32 and bf16. Semantics kept from the TPU kernel: the forward is
// recomputed in the compute dtype; ReLU masks come from the post-activation
// values (> 0); in bf16 every product takes bf16 operands, the cotangents
// included, and accumulates in f32; the PE and its derivative are f32.
//
// What bounds it on an H100: ~3x the forward's multiply-adds (1.77 M a
// sample at 8 x 256: the forward, the input gradients, the weight
// gradients) at 989 TFLOP/s in bf16 and 67 TFLOP/s in f32, and the tape:
// ~10 KB (bf16) / ~20 KB (f32) a sample written by the chain pass and read
// back by the dW pass.
//
// Three passes per chunk of whole rays (the TPU kernel's grid is sequential
// and sums dW in place; blocks here run in parallel):
//
// 1. `bwd_chain_kernel`, on mlp_hopper.cuh's building blocks (the forward
//    kernel's design: persistent blocks, weight slabs streamed by a producer
//    warp through a shared-memory ring with cp.async.bulk on mbarriers,
//    wgmma in bf16 with two 64-sample tiles a block, register-blocked FMAs in
//    f32): recompute the forward of a tile with the forward kernel's
//    functions (`trunk`, `feature_views`), then propagate d_h down the net
//    with the transposed weights, each layer's output written over its input
//    in shared memory. It writes every value a dW product reads to the
//    chunk's tape in device memory (PE, posts, feature, dir PE, h2, the
//    cotangents, d_pre2, d_feature and every layer's d_pre), 16 bytes a
//    store, and d_planes and per-sample d_dir itself.
// 2. `dw_kernel` (mlp_hopper.cuh): dW = d_pre^T h_in of every layer from the
//    tape, as a Hopper GEMM: 128 x 128 output tiles, operands as TMA boxes
//    into a shared-memory ring, wgmma with both operands MN-major (bf16) or
//    register-blocked FMAs (f32); the chunk's samples split into contiguous
//    ranges, one partial each, and `dw_reduce_kernel` adds them in order. No
//    atomics: two runs give bit-identical gradients.
// 3. Per-ray mode: d_dir sums d_pre2 over a ray's S samples, which span
//    tiles; `bwd_ddir_kernel` sums each ray's rows of the tape in order.
//
// The "hbm" configuration (`fwd_tape`, the TPU kernel's `tape=`): the
// forward kernel has written the trunk's post-ReLU values, sample-major
// [N, depth * W]; the chain pass loads the last layer's posts instead of
// recomputing the trunk and takes the ReLU masks from the forward's rows,
// and the dW pass reads them in place through a second tensor map. The
// forward's trunk is the chain pass's (`trunk`), so the values, and the
// gradients, are the recompute configuration's bit for bit.

#include "mlp_hopper.cuh"

namespace {

struct ChainArgs {
  Net net;
  const unsigned char* img;  // weight slab images: the forward's, then the transposed layers'
  const uint2* slabs;
  int n_slabs;
  const float* g;          // [4, N] cotangents of sigma, r, g, b
  const float* head_a;     // [W] alpha weights, rounded to the compute dtype
  const float* head_rgb;   // [3, W/2] rgb weights, likewise
  float* d_planes;         // [3, N]
  float* d_dir;            // per-sample: [3, N]; per-ray: unused here
  void* tape;              // [chunk rows, ldt] compute dtype
  const void* fwd_tape;    // [N, depth * W] posts from the forward, or null
  int n, ldt, t_post, t_feat, t_dpe, t_h2, t_g, t_dpre, t_dfeat, t_dpre2;
  int c0, lim;             // the chunk's first sample; samples >= lim are padding
};

template <typename T, int W>
__device__ void chain(const ChainArgs& a, Ring& ring, unsigned char* rest, int units, int tiles) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  constexpr int HALF = W / 2, KB_HALF = (HALF + 63) / 64;
  const int gi = threadIdx.x / 32 / (CONSUMER_WARPS / G);
  Tile<T> t = make_tile<T, W>(rest, gi, true);
  const Net& net = a.net;
  const bool per_sample = net.dx != nullptr;
  const int ldt = a.ldt, lim = a.lim, depth = net.depth;
  const T* fwd = static_cast<const T*>(a.fwd_tape);
  const int ldp = fwd != nullptr ? depth * W : ldt;
  float* dpe = t.dpe;
  float* gs = t.scr;  // [HT][4] cotangents
  const float* head_a = a.head_a;
  const auto keep = [](int, int, float v) { return v; };
  const Mask<T> no_mask{nullptr, 0};
  const Rows<T> no_rows{nullptr, 0, 0};
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
    auto col = [&](int c) { return Rows<T>{tape + c, ldt, HT}; };
    // the trunk posts of the tile's first sample: the chunk tape's, or the forward's
    const T* posts = fwd != nullptr ? fwd + (size_t)n0 * ldp : tape + a.t_post;

    // ---- forward; every value a dW product reads goes to the tape
    pe_fill(t, 0, 1, net.pos, Planes{{net.px, net.py, net.pz, nullptr}, 3}, lim);
    rows_out(t, 0, 64, col(0));
    if (fwd == nullptr)
      trunk<T, W>(t, ring, net.bias, depth, net.skip_mask, 1, tape + a.t_post, ldt, HT);
    else rows_in(t, 64, W, posts + (depth - 1) * W, ldp);
    feature_views<T, W>(t, ring, net, lim, col(a.t_feat), per_sample ? col(a.t_dpe) : no_rows,
                        col(a.t_h2));

    // ---- backward
    // cotangents, rounded to the compute dtype as the products take them
    for (int idx = t.g.tid; idx < HT * 4; idx += t.g.nthr) {
      const int s = idx / 4, c = idx % 4;
      const T v = cvt<T>(n0 + s < lim ? a.g[(size_t)c * a.n + n0 + s] : 0.f);
      gs[idx] = tof(v);
      tape[(size_t)s * ldt + a.t_g + (c == 0 ? 0 : 7 + c)] = v;
    }
    t.g.sync();
    // d_pre2 = [h2 > 0] (g_rgb . W_rgb), over h2
    for (int idx = t.g.tid; idx < HT * HALF; idx += t.g.nthr) {
      const int s = sizeof(T) == 2 ? idx / HALF : idx % HT, o = sizeof(T) == 2 ? idx % HALF : idx / HT;
      float dh = 0.f;
      for (int c = 0; c < 3; ++c) dh = fmaf(gs[s * 4 + 1 + c], a.head_rgb[c * HALF + o], dh);
      T* p = t.act.at(s, 64 + o);
      *p = cvt<T>(tof(*p) > 0.f ? dh : 0.f);
    }
    if (sizeof(T) == 2) fence_async_smem();
    t.g.sync();
    rows_out(t, 64, HALF, col(a.t_dpre2));
    // [d_dirpe, d_feature] = d_pre2 . W_views; d_feature over d_pre2
    if (per_sample)
      product<64, false>(t, ring, 1, KB_HALF, 0,
                         [dpe](int s, int o, float v) { dpe[s * DLD + o] = v; return v; },
                         no_mask, no_rows);
    product<W, true>(t, ring, 1, KB_HALF, 64, keep, no_mask, col(a.t_dfeat));
    if (per_sample) {
      for (int s = t.g.tid; s < HT; s += t.g.nthr) {
        const int g = n0 + s;
        if (g >= lim) continue;
        float d[3];
        pe_bwd(net.dir, net.dx[g], net.dy[g], net.dz[g], dpe + s * DLD, d);
        for (int c = 0; c < 3; ++c) a.d_dir[(size_t)c * a.n + g] = d[c];
      }
      t.g.sync();
    }
    for (int idx = t.g.tid; idx < HT * DLD; idx += t.g.nthr) dpe[idx] = 0.f;
    // top of the trunk: d_h = d_feature . W_feature + g_alpha W_alpha
    product<W, true>(t, ring, 1, W / 64, 64,
                     [gs, head_a](int s, int o, float v) { return v + gs[s * 4] * head_a[o]; },
                     Mask<T>{posts + (depth - 1) * W, ldp}, col(a.t_dpre + (depth - 1) * W));
    // down the trunk: layer i's input gradient; its PE part accumulates in f32
    for (int i = depth - 1; i >= 0; --i) {
      if (has_pe(net.skip_mask, i))
        product<64, false>(t, ring, 1, W / 64, 0,
                           [dpe](int s, int o, float v) { dpe[s * DLD + o] += v; return v; },
                           no_mask, no_rows);
      if (i > 0)
        product<W, true>(t, ring, 1, W / 64, 64, keep, Mask<T>{posts + (i - 1) * W, ldp},
                         col(a.t_dpre + (i - 1) * W));
    }
    t.g.sync();
    for (int s = t.g.tid; s < HT; s += t.g.nthr) {
      const int g = n0 + s;
      if (g >= lim) continue;
      float d[3];
      pe_bwd(net.pos, net.px[g], net.py[g], net.pz[g], dpe + s * DLD, d);
      for (int c = 0; c < 3; ++c) a.d_planes[(size_t)c * a.n + g] = d[c];
    }
    t.g.sync();
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(HOPPER_THREADS, 1) bwd_chain_kernel(ChainArgs a, int stages) {
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

// per-ray d_dir[r0 + r][o] = sum over the ray's samples of d_pre2, in order
template <typename T>
__global__ void bwd_ddir_kernel(const T* tape, int ldt, int t_dpre2, int rays, int spr, int half,
                                int r0, float* d_dir) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rays * half) return;
  const int r = idx / half, o = idx % half;
  const T* p = tape + (size_t)r * spr * ldt + t_dpre2 + o;
  float s = 0.f;
  for (int j = 0; j < spr; ++j) s += tof(p[(size_t)j * ldt]);
  d_dir[(size_t)(r0 + r) * half + o] = s;
}

// Columns of a chunk-tape row: every block starts at a multiple of 8
// columns (16-byte stores; a TMA box starts on 16 bytes): the cotangent of
// sigma at t_g, those of r, g, b at t_g + 8.
struct Layout {
  int t_post, t_feat, t_dpe, t_h2, t_g, t_dpre, t_dfeat, t_dpre2, ldt;
};

Layout layout(int depth, int width, int per_sample) {
  Layout t;
  t.t_post = 64;  // after the PE block
  t.t_feat = t.t_post + depth * width;
  t.t_dpe = t.t_feat + width;
  t.t_h2 = t.t_dpe + (per_sample ? 64 : 0);
  t.t_g = t.t_h2 + width / 2;
  t.t_dpre = t.t_g + 16;
  t.t_dfeat = t.t_dpre + depth * width;
  t.t_dpre2 = t.t_dfeat + width;
  t.ldt = t.t_dpre2 + width / 2;
  return t;
}

template <typename T, int W>
int launch_chain(const ChainArgs& c, int blocks, cudaStream_t st) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  int stages = 0;
  const int smem = launch_smem<T>(W, true, 1, true, &stages);
  void (*kernel)(ChainArgs, int) = bwd_chain_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int units = (blocks + G - 1) / G;
  kernel<<<min(units, sm_count()), HOPPER_THREADS, smem, st>>>(c, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the chain pass (kernel 0) or the dW pass (1).
extern "C" int nerf_mlp_bwd_shared_bytes(int kernel, int width, int half_precision) {
  if (kernel == 1) return block_bytes(0, 0, MAX_STAGES);
  int stages = 0;
  return half_precision ? launch_smem<bf16>(width, true, 1, true, &stages)
                        : launch_smem<float>(width, true, 1, true, &stages);
}

// Columns of one chunk-tape row (elements of the compute dtype).
extern "C" int nerf_mlp_bwd_tape_cols(int depth, int width, int per_sample) {
  return layout(depth, width, per_sample).ldt;
}

// Planes [N] f32; dir_part [R, W/2] (per-ray) or dx/dy/dz [N] (per-sample);
// g [4, N]; img / slabs: the weight slabs the chain pass reads, in the
// compute dtype as the wrapper lays them out (the forward's layers, without
// the trunk when fwd_tape is given, then the transposed layers), and their
// (offset, bytes); bias: forward order; head_a [W] and head_rgb [3, W/2] the
// head weights rounded to the compute dtype, f32. fwd_tape: the forward
// kernel's tape [N, depth * width] in the compute dtype, or null to recompute
// the trunk.
// Outputs: d_planes [3, N]; d_dir [R, W/2] or [3, N]; grad: per layer in
// forward order (trunk, alpha, feature, views, rgb) dW [out, in] then db,
// f32, `total` floats. Scratch: tape [chunk_rays * spr rounded up to 64,
// tape_cols], partial [max_ranges, total] f32. Chunks hold chunk_rays whole
// rays; each chunk's dW pass splits its samples into at most max_ranges
// ranges. Width 64 or 256. Returns the first CUDA error (0 on success), -1
// for an inconsistent layout or an unsupported width, -2 if the tensor maps
// cannot be made.
extern "C" int nerf_mlp_bwd_launch(
    const float* px, const float* py, const float* pz, const float* dx, const float* dy,
    const float* dz, const float* dir_part, const float* g, const void* fwd_tape, const void* img,
    const void* slabs, int n_slabs, const float* bias, const float* head_a, const float* head_rgb,
    float* d_planes, float* d_dir, float* grad, void* tape, float* partial, int n, int spr,
    int depth, int width, int skip_mask, int pos_mapping, int pos_include, int pos_bands,
    int pos_dim, const float* pos_coef, int dir_mapping, int dir_include, int dir_bands,
    int dir_dim, const float* dir_coef, int half_precision, int chunk_rays, int max_ranges,
    int total, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_sample = dx != nullptr;
  const bool hbm = fwd_tape != nullptr;
  const Layout t = layout(depth, width, per_sample);
  const int half = width / 2;
  if (depth + 4 > MAX_LAYERS || (width != 64 && width != 256)) return -1;

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
  add(t.t_g, 1, post_map, post_col(depth - 1), width, 0, width, true);  // alpha
  c_off += width + 1;
  add(t.t_dfeat, width, post_map, post_col(depth - 1), width, 0, width, true);  // feature
  c_off += width * width + width;
  const int ldv = width + dir_dim;  // views: [W/2, W + dir_dim]
  add(t.t_dpre2, half, 0, t.t_feat, width, 0, ldv, true);
  if (per_sample) add(t.t_dpre2, half, 0, t.t_dpe, dir_dim, width, ldv, false);
  c_off += half * ldv + half;
  add(t.t_g + 8, 3, 0, t.t_h2, half, 0, half, true);  // rgb
  c_off += 3 * half + 3;
  if (c_off != total) return -1;
  d.n_subs = ns;
  d.total = total;
  d.partial = partial;
  const int ranges = dw_ranges(tiles, max_ranges);

  const int chunk = chunk_rays * spr;
  const int rows = (chunk + HT - 1) / HT * HT;
  CUtensorMap tmap, pmap;
  if (!tape_map(&tmap, tape, rows, t.ldt, half_precision)) return -2;
  if (hbm && !tape_map(&pmap, fwd_tape, n, depth * width, half_precision)) return -2;
  if (!hbm) pmap = tmap;

  ChainArgs c;
  c.net.px = px; c.net.py = py; c.net.pz = pz;
  c.net.dx = dx; c.net.dy = dy; c.net.dz = dz;
  c.net.dir_part = dir_part;
  c.net.bias = bias;
  c.net.pos = PE{pos_mapping, pos_include, pos_bands, pos_dim, pos_coef};
  c.net.dir = PE{dir_mapping, dir_include, dir_bands, dir_dim, dir_coef};
  c.net.spr = spr; c.net.depth = depth; c.net.skip_mask = skip_mask;
  c.img = static_cast<const unsigned char*>(img);
  c.slabs = static_cast<const uint2*>(slabs);
  c.n_slabs = n_slabs;
  c.g = g; c.head_a = head_a; c.head_rgb = head_rgb;
  c.d_planes = d_planes; c.d_dir = d_dir;
  c.tape = tape; c.fwd_tape = fwd_tape;
  c.n = n; c.ldt = t.ldt; c.t_post = t.t_post; c.t_feat = t.t_feat; c.t_dpe = t.t_dpe;
  c.t_h2 = t.t_h2; c.t_g = t.t_g; c.t_dpre = t.t_dpre; c.t_dfeat = t.t_dfeat;
  c.t_dpre2 = t.t_dpre2;

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
    if (!per_sample) {
      const int rays = cn / spr;
      const int threads = rays * half;
      if (half_precision)
        bwd_ddir_kernel<bf16><<<(threads + 255) / 256, 256, 0, st>>>(
            static_cast<const bf16*>(tape), t.ldt, t.t_dpre2, rays, spr, half, c0 / spr, d_dir);
      else
        bwd_ddir_kernel<float><<<(threads + 255) / 256, 256, 0, st>>>(
            static_cast<const float*>(tape), t.ldt, t.t_dpre2, rays, spr, half, c0 / spr, d_dir);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  return 0;
}
