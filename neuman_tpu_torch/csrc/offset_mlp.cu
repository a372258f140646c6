// Fused positional encoding + no-viewdirs MLP (the offset net) over planar
// samples: PE of D <= 4 input planes (x, y, z, t), the ReLU trunk with the
// skip concat [PE, h], and the linear head, to O <= 4 raw output planes
// [O, N].
//
// Replaces neuman_tpu/ops/pallas/raymarch_vjp.py `_offset_fwd_impl` (kernel
// body :558, pallas_call :605). The output scaling of the offset net
// (linear / tanh times a per-step scalar) stays outside, as there.
//
// What bounds it on an H100: the multiply-adds, ~0.50 M a sample at 8 x 256
// with the 84-column PE of (x, y, z, t) (0.52 M as run, the PE padded to 128
// columns), at 989 TFLOP/s in bf16 and 67 TFLOP/s in f32; in bf16 also the
// ~1.1 MB of weights a block streams from L2 for every 128 samples.
//
// Design: nerf_mlp.cu's, on mlp_hopper.cuh's building blocks: persistent
// blocks of 8 consumer warps and a producer warp that streams the trunk's
// weights, laid out by the wrapper as 32 KB slab images, into a
// shared-memory ring with cp.async.bulk on mbarriers. bf16: each consumer
// warpgroup runs its own 64-sample tile through every layer with wgmma
// m64n256k16 (m64n64k16 at width 64), so every slab serves 128 samples; f32:
// the 8 warps share a 64-sample tile, 8 samples x W/32 outputs a thread from
// 128-bit shared loads. The PE takes two 64-column blocks of the tile (84
// columns, zero-padded to 128, with zero weight columns from the wrapper:
// 4.5% more multiply-adds on layers 0 and 5), so the skip input [PE, h] is
// one range. The O-wide head runs on CUDA cores. Activations are rounded to
// bf16 where the JAX kernel casts them (PE, trunk outputs).
//
// With a tape pointer (the `mlp_tape="hbm"` train configuration; the TPU
// kernel's emit_tape) every trunk layer also writes its post-ReLU output, in
// the compute dtype, to tape[n][i * W + o]: in bf16 16 bytes a store from
// the shared-memory tile, in f32 from the accumulators. The trunk is
// offset_mlp_bwd.cu's chain pass's (`trunk`), so the tape is what the
// backward otherwise recomputes, bit for bit.

#include "mlp_hopper.cuh"

namespace {

struct OffsetArgs {
  Planes ax;                 // D input planes [N]
  const unsigned char* img;  // trunk weight slab images
  const uint2* slabs;        // (byte offset, bytes) of each slab in the order the layers read them
  int n_slabs;
  const float* bias;         // trunk biases, then the head's
  const float* head;         // [O, W] head weights rounded to the compute dtype, f32
  float* out;                // [O, N]
  void* tape;                // [N, depth * W] trunk posts, compute dtype, or null
  PE pos;
  int n, depth, skip_mask, n_out, pb;
};

template <typename T, int W>
__device__ void forward(const OffsetArgs& a, Ring& ring, unsigned char* rest, int units,
                        int tiles) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  const int gi = threadIdx.x / 32 / (CONSUMER_WARPS / G);
  Tile<T> t = make_tile<T, W>(rest, gi, false, a.pb, false);
  const int ldp = a.depth * W, h0 = 64 * a.pb;
  const float* b_head = a.bias + a.depth * W;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u * G + gi;
    if (tile >= tiles) {
      drain(ring, a.n_slabs);
      continue;
    }
    t.n0 = tile * HT;
    t.rows = min(HT, a.n - t.n0);
    T* tape = a.tape != nullptr ? static_cast<T*>(a.tape) + (size_t)t.n0 * ldp : nullptr;
    pe_fill(t, 0, a.pb, a.pos, a.ax, a.n);
    trunk<T, W>(t, ring, a.bias, a.depth, a.skip_mask, a.pb, tape, ldp, t.rows);
    switch (a.n_out) {
      case 1: head<T, 1>(t, h0, W, a.head, b_head, a.out, a.n); break;
      case 2: head<T, 2>(t, h0, W, a.head, b_head, a.out, a.n); break;
      case 3: head<T, 3>(t, h0, W, a.head, b_head, a.out, a.n); break;
      default: head<T, 4>(t, h0, W, a.head, b_head, a.out, a.n); break;
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(HOPPER_THREADS, 1) offset_mlp_kernel(OffsetArgs a, int stages) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;  // tiles a block runs at once
  Ring ring;
  unsigned char* rest = ring_setup(ring, stages);
  const int tiles = (a.n + HT - 1) / HT, units = (tiles + G - 1) / G;
  const int warp = threadIdx.x / 32;
  if (warp >= CONSUMER_WARPS) {
    producer_registers();
    if (threadIdx.x == PRODUCER_WARP * 32) {
      const int reps = (int)blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
      produce(ring, a.img, a.slabs, a.n_slabs, reps);
    }
  } else {
    consumer_registers();
    forward<T, W>(a, ring, rest, units, tiles);
  }
}

template <typename T, int W>
int launch(const OffsetArgs& a, void* stream) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  int stages = 0;
  const int smem = launch_smem<T>(W, false, a.pb, false, &stages);
  void (*kernel)(OffsetArgs, int) = offset_mlp_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int units = ((a.n + HT - 1) / HT + G - 1) / G;
  kernel<<<min(units, sm_count()), HOPPER_THREADS, smem, (cudaStream_t)stream>>>(a, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the kernel at this width, dtype and PE width.
extern "C" int offset_mlp_shared_bytes(int width, int pos_dim, int half_precision) {
  int stages = 0;
  const int pb = (pos_dim + 63) / 64;
  return half_precision ? launch_smem<bf16>(width, false, pb, false, &stages)
                        : launch_smem<float>(width, false, pb, false, &stages);
}

// Planes ax0..ax3 [N] f32 (the first `d_in` are read); img / slabs: the trunk
// layers' weight slabs in the compute dtype as the wrapper lays them out
// (`nerf_mlp.slab_plan`, the PE blocks zero-padded to 64 columns each), and
// their (offset, bytes); bias: f32, trunk layers in order, then the head;
// head [O, W] f32, rounded to the compute dtype by the caller.
// out [O, N] f32; tape [N, depth * width] of the compute dtype, or null.
// Width 64 or 256, a PE of at most 128 columns, O <= 4. Returns the
// cudaError_t of the launch (0 on success), -1 for a net it does not take.
extern "C" int offset_mlp_launch(
    const float* ax0, const float* ax1, const float* ax2, const float* ax3, int d_in,
    const void* img, const void* slabs, int n_slabs, const float* bias, const float* head,
    float* out, void* tape, int n, int depth, int width, int skip_mask, int n_out,
    int pos_include, int pos_bands, int pos_dim, const float* pos_coef, int half_precision,
    void* stream) {
  if (n == 0) return 0;
  if (d_in < 1 || d_in > 4 || n_out < 1 || n_out > 4 || pos_dim > 128 || depth > MAX_LAYERS)
    return -1;
  OffsetArgs a;
  a.ax = Planes{{ax0, ax1, ax2, ax3}, d_in};
  a.img = static_cast<const unsigned char*>(img);
  a.slabs = static_cast<const uint2*>(slabs);
  a.n_slabs = n_slabs;
  a.bias = bias; a.head = head; a.out = out; a.tape = tape;
  a.pos = PE{0, pos_include, pos_bands, pos_dim, pos_coef};
  a.n = n; a.depth = depth; a.skip_mask = skip_mask; a.n_out = n_out;
  a.pb = (pos_dim + 63) / 64;
  if (width == 256) return half_precision ? launch<bf16, 256>(a, stream) : launch<float, 256>(a, stream);
  if (width == 64) return half_precision ? launch<bf16, 64>(a, stream) : launch<float, 64>(a, stream);
  return -1;
}
