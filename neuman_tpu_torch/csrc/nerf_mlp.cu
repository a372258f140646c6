// Fused positional encoding + NeRF MLP over planar samples.
//
// Replaces neuman_tpu/ops/pallas/raymarch.py `nerf_mlp_pallas` (kernel body
// :192, pallas_call :301, `emit_tape` :190-230) in both direction modes:
//   per-ray    - dir_part [R, W/2] (W_dirs . PE(d), one row per ray) is added
//                before the views ReLU; sample n belongs to ray n / S;
//   per-sample - the direction planes are encoded in the kernel and the
//                views layer reads [PE(d), feature].
// Both PE mappings: 'posenc' (bands f_b: [x, sin f0 x, cos f0 x, ...]) and
// 'rotate' ([x, sin(B x) all, cos(B x) all]); the bands or the basis B come
// in as a small array.
//
// What bounds it on an H100: the multiply-adds, ~0.59 M a sample at 8 x 256
// (1.18 MFLOP), at 989 TFLOP/s in bf16 and 67 TFLOP/s in f32; in bf16 the
// ~1.2 MB of weights a block streams from L2 for every 128 samples comes
// close too (~9 KB a sample).
//
// Design (mlp_hopper.cuh has the building blocks): persistent blocks of 8
// consumer warps and a producer warp that streams the layers' weights, laid
// out by the wrapper as 32 KB slab images, into a shared-memory ring with
// cp.async.bulk on mbarriers. bf16: each consumer warpgroup runs its own
// 64-sample tile through every layer with wgmma (m64n256k16 for the trunk
// and the feature layer, m64n128k16 for the views layer), the activations
// staying in shared memory in the swizzled layout wgmma reads, so every slab
// serves 128 samples. f32: the 8 warps share a 64-sample tile, 8 samples x 8
// outputs a thread from 128-bit shared loads of activations and weights. The
// 1-wide alpha and 3-wide rgb heads run on CUDA cores. Activations are
// rounded to bf16 where the JAX kernel casts them (PE, trunk outputs,
// feature, dir PE, views output).
//
// With a tape pointer (the `mlp_tape="hbm"` train configuration; the TPU
// kernel's emit_tape) every trunk layer also writes its post-ReLU output, in
// the compute dtype, to tape[n][i * W + o], sample-major rows of depth * W
// values: in bf16 16 bytes a store from the shared-memory tile, in f32 from
// the accumulators 8 consecutive outputs (two 16-byte stores) a sample. The
// trunk is the chain pass's function (`trunk`), so the tape is what the
// backward otherwise recomputes, bit for bit.

#include "mlp_hopper.cuh"

namespace {

struct FwdArgs {
  Net net;
  const unsigned char* img;  // weight slab images
  const uint2* slabs;        // (byte offset, bytes) of each slab in the order the layers read them
  int n_slabs;
  const float* head_a;       // [W] alpha weights, rounded to the compute dtype
  const float* head_rgb;     // [3, W/2] rgb weights, likewise
  float* out;                // [4, N]: sigma, r, g, b
  void* tape;                // [N, depth * W] trunk posts, compute dtype, or null
  int n;
};

template <typename T, int W>
__device__ void forward(const FwdArgs& a, Ring& ring, unsigned char* rest, int units, int tiles) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  const int gi = threadIdx.x / 32 / (CONSUMER_WARPS / G);
  Tile<T> t = make_tile<T, W>(rest, gi, false);
  const Net& net = a.net;
  const int ldp = net.depth * W;
  const float* b_alpha = net.bias + net.depth * W;
  const float* b_rgb = b_alpha + 1 + W + W / 2;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u * G + gi;
    if (tile >= tiles) {
      drain(ring, a.n_slabs);
      continue;
    }
    t.n0 = tile * HT;
    t.rows = min(HT, a.n - t.n0);
    T* tape = a.tape != nullptr ? static_cast<T*>(a.tape) + (size_t)t.n0 * ldp : nullptr;
    pe_fill(t, 0, 1, net.pos, Planes{{net.px, net.py, net.pz, nullptr}, 3}, a.n);
    trunk<T, W>(t, ring, net.bias, net.depth, net.skip_mask, 1, tape, ldp, t.rows);
    head<T, 1>(t, 64, W, a.head_a, b_alpha, a.out, a.n);
    feature_views<T, W>(t, ring, net, a.n, Rows<T>{nullptr, 0, 0}, Rows<T>{nullptr, 0, 0},
                        Rows<T>{nullptr, 0, 0});
    head<T, 3>(t, 64, W / 2, a.head_rgb, b_rgb, a.out + a.n, a.n);
  }
}


template <typename T, int W>
__global__ void __launch_bounds__(HOPPER_THREADS, 1) nerf_mlp_kernel(FwdArgs a, int stages) {
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
int launch(const FwdArgs& a, void* stream) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  int stages = 0;
  const int smem = launch_smem<T>(W, false, 1, true, &stages);
  void (*kernel)(FwdArgs, int) = nerf_mlp_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int units = ((a.n + HT - 1) / HT + G - 1) / G;
  kernel<<<min(units, sm_count()), HOPPER_THREADS, smem, (cudaStream_t)stream>>>(a, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the kernel at this width and dtype.
extern "C" int nerf_mlp_shared_bytes(int width, int half_precision) {
  int stages = 0;
  return half_precision ? launch_smem<bf16>(width, false, 1, true, &stages)
                        : launch_smem<float>(width, false, 1, true, &stages);
}

// Planes px/py/pz (and dx/dy/dz) [N] f32; dir_part [R, W/2] f32 or null;
// img / slabs: the layers' weight slabs (trunk, feature, views) in the
// compute dtype as the wrapper lays them out, and their (offset, bytes);
// bias: f32 biases, layer order trunk 0..D-1, alpha, feature, views, rgb;
// head_a [W], head_rgb [3, W/2] f32 rounded to the compute dtype.
// out [4, N] f32; tape [N, depth * width] of the compute dtype, or null.
// Width 64 or 256. Returns the cudaError_t of the launch (0 on success), -1
// for a width the kernel does not take.
extern "C" int nerf_mlp_launch(
    const float* px, const float* py, const float* pz, const float* dx, const float* dy,
    const float* dz, const float* dir_part, const void* img, const void* slabs, int n_slabs,
    const float* bias, const float* head_a, const float* head_rgb, float* out, void* tape, int n,
    int spr, int depth, int width, int skip_mask, int pos_mapping, int pos_include,
    int pos_bands, int pos_dim, const float* pos_coef, int dir_mapping, int dir_include,
    int dir_bands, int dir_dim, const float* dir_coef, int half_precision, void* stream) {
  if (n == 0) return 0;
  FwdArgs a;
  a.net.px = px; a.net.py = py; a.net.pz = pz;
  a.net.dx = dx; a.net.dy = dy; a.net.dz = dz;
  a.net.dir_part = dir_part;
  a.net.bias = bias;
  a.net.pos = PE{pos_mapping, pos_include, pos_bands, pos_dim, pos_coef};
  a.net.dir = PE{dir_mapping, dir_include, dir_bands, dir_dim, dir_coef};
  a.net.spr = spr; a.net.depth = depth; a.net.skip_mask = skip_mask;
  a.img = static_cast<const unsigned char*>(img);
  a.slabs = static_cast<const uint2*>(slabs);
  a.n_slabs = n_slabs;
  a.head_a = head_a; a.head_rgb = head_rgb;
  a.out = out; a.tape = tape; a.n = n;
  if (width == 256) return half_precision ? launch<bf16, 256>(a, stream) : launch<float, 256>(a, stream);
  if (width == 64) return half_precision ? launch<bf16, 64>(a, stream) : launch<float, 64>(a, stream);
  return -1;
}
