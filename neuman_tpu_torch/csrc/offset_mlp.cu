// Fused positional encoding + no-viewdirs MLP (the offset net) over planar
// samples: PE of D <= 4 input planes (x, y, z, t), the ReLU trunk with the
// skip concat [PE, h], and the linear head, to O raw output planes [O, N].
//
// Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_offset_fwd_impl` (kernel
// body :558, pallas_call :605). The output scaling of the offset net
// (linear / tanh times a per-step scalar) stays outside, as there.
//
// The plan is nerf_mlp.cu's: one block of 256 threads runs a tile of 64
// samples through the whole net; the tile's activations live in two
// ping-pong [64][LD] shared-memory buffers whose columns [0, Cp) hold the
// tile's PE, so the skip concat is a column range; the weights (~2 MB in
// f32 at 8 x 256) stay in global memory, where the 50 MB L2 and each SM's
// L1 hold them. f32: FMAs on CUDA cores (bound by FMA issue, ~0.57 M
// multiply-adds a sample). bf16: mma.sync m16n8k16 with f32 accumulation,
// activations and weights rounded to bf16 where the TPU kernel casts them,
// the PE block (84 columns for D = 4, 10 bands) zero-padded to 96 for the
// MMA's k step with matching zero weight columns from the wrapper. The
// O-wide head runs on CUDA cores in both.
//
// With a tape pointer (the `mlp_tape="hbm"` train configuration; the TPU
// kernel's emit_tape) every trunk layer also writes its post-ReLU output, in
// the compute dtype, to tape[n][i * W + o]: what offset_mlp_bwd.cu's chain
// pass otherwise recomputes, bit for bit (the same tile products).

#include "mlp_tiles.cuh"

namespace {

struct OffsetArgs {
  Axes ax;            // D input planes [N]
  const void* wt;     // trunk weights: f32 [in, out] per layer; bf16 [out, in], PE block padded
  const float* bias;  // trunk biases, then the head's
  const float* head;  // [O, W] head weights rounded to the compute dtype, f32
  float* out;         // [O, N]
  void* tape;         // [N, depth * W] trunk posts, compute dtype, or null
  PE pos;
  int n, depth, width, skip_mask, n_out;
  int ld, cp;
};

// TAPE: the trunk posts also go to a.tape; a template flag, so that the
// tape-less kernel keeps its code.
template <typename T, bool TAPE>
__global__ void __launch_bounds__(THREADS) offset_mlp_kernel(OffsetArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + TN * a.ld;
  const int n0 = blockIdx.x * TN;
  const int cp = a.cp, w = a.width, ld = a.ld;
  const T* wt = static_cast<const T*>(a.wt);
  const float* bias = a.bias;
  T* tape = static_cast<T*>(a.tape);
  const int ldtape = a.depth * w, n = a.n;

  pe_fill_nd(cur, ld, 0, cp, a.pos, a.ax, n0, a.n);
  pe_fill_nd(nxt, ld, 0, cp, a.pos, a.ax, n0, a.n);
  __syncthreads();
  for (int i = 0; i < a.depth; ++i) {
    const bool after_skip = i > 0 && ((a.skip_mask >> (i - 1)) & 1);
    const int in_off = (i == 0 || after_skip) ? 0 : cp;
    const int in_dim = i == 0 ? cp : (after_skip ? cp + w : w);
    T* dst = nxt;
    T* trow = TAPE ? tape + (size_t)n0 * ldtape + i * w : nullptr;
    dense(cur, ld, in_off, in_dim, wt, w, [&](int s, int o, float v) {
      const T tv = cvt<T>(fmaxf(v + bias[o], 0.f));
      dst[s * ld + cp + o] = tv;
      if (TAPE && n0 + s < n) trow[(size_t)s * ldtape + o] = tv;
    });
    wt += (size_t)in_dim * w;
    bias += w;
    __syncthreads();
    T* t = cur; cur = nxt; nxt = t;
  }
  for (int idx = threadIdx.x; idx < TN * a.n_out; idx += blockDim.x) {
    const int s = idx / a.n_out, o = idx % a.n_out, g = n0 + s;
    const T* x = cur + s * ld + cp;
    const float* hw = a.head + (size_t)o * w;
    float acc = 0.f;
    for (int k = 0; k < w; ++k) acc += tof(x[k]) * hw[k];
    if (g < a.n) a.out[(size_t)o * a.n + g] = acc + bias[o];
  }
}

template <typename T>
int launch(const OffsetArgs& a, void* stream) {
  const int smem = 2 * TN * a.ld * (int)sizeof(T);
  void (*kernel)(OffsetArgs) =
      a.tape != nullptr ? offset_mlp_kernel<T, true> : offset_mlp_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.n + TN - 1) / TN, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Planes ax0..ax3 [N] f32 (the first `d_in` are read); bias: f32, trunk
// layers in order, then the head; head [O, W] f32, rounded to the compute
// dtype by the caller.
// bf16 == 0: wt f32, each trunk layer [in, out] (transposed), unpadded.
// bf16 == 1: wt bf16, each trunk layer [out, in] with the PE column block
//            padded to a multiple of 16; needs width % 64 == 0.
// out [O, N] f32; tape [N, depth * width] of the compute dtype, or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int offset_mlp_launch(
    const float* ax0, const float* ax1, const float* ax2, const float* ax3, int d_in,
    const void* wt, const float* bias, const float* head, float* out, void* tape, int n, int depth,
    int width, int skip_mask, int n_out, int pos_include, int pos_bands, int pos_dim,
    const float* pos_coef, int bf16, void* stream) {
  if (n == 0) return 0;
  OffsetArgs a;
  a.ax = Axes{{ax0, ax1, ax2, ax3}, d_in};
  a.wt = wt; a.bias = bias; a.head = head; a.out = out; a.tape = tape;
  a.pos = PE{0, pos_include, pos_bands, pos_dim, pos_coef};
  a.n = n; a.depth = depth; a.width = width; a.skip_mask = skip_mask; a.n_out = n_out;
  a.cp = bf16 ? round_up(pos_dim, 16) : pos_dim;
  const int ld = a.cp + width;
  if (!bf16) {
    a.ld = ld;
    return launch<float>(a, stream);
  }
  a.ld = round_up(ld - 8, 64) + 8;  // = 8 mod 64: conflict-free A fragments
  return launch<__nv_bfloat16>(a, stream);
}
