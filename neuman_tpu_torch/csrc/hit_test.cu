// Geometry-guided near and far: for each ray, the least z0 - dz and the
// greatest z0 + dz over the spheres of radius r about the body's vertices
// that the ray passes through, without a [rays, V] matrix in device memory.
//
// Replaces no TPU kernel: the JAX package computes this in plain jnp
// (neuman_tpu/ops/rays.py `geometry_guided_near_far`, shaped for the MXU as
// two [R, 3] x [3, V] products and ~20 elementwise passes over [R, V]),
// carried over as `ops/rays.geometry_guided_near_far_plain`, which stays the
// CPU path and this kernel's plain twin.
//
// The test of one ray against one vertex, from p = v - o:
//     z0 = d.p,  q = p - z0 d,  h^2 = |q|^2 + z0^2 (1 - |d|^2),
// which is |p|^2 - z0^2 in exact arithmetic (for a unit d, |q| is the
// distance from the vertex to the ray's line), and the ray passes through
// the sphere where r^2 - h^2 >= 0 (a NaN fails the test: a miss); then
// dz = sqrt(r^2 - h^2). The plain version forms |v|^2 - 2 o.v + |o|^2 - z0^2,
// a difference of terms of the size of |o - v|^2 (~9 for a camera 3 away)
// for a result of the size of r^2 (~1e-2), so it keeps ~1e-6 of h^2; q is
// of the size of r, and the rounding of z0 enters |q|^2 only squared, so
// here h^2 keeps ~1e-8. 1 - |d|^2 is taken once a ray in f64. Each step is
// an explicit round-to-nearest intrinsic, so nothing is contracted and
// tests can restate the arithmetic bit for bit. Misses give near = +inf,
// far = -inf, as in the plain version.
//
// What bounds it on the H100: FP32 instruction issue. The function needs
// at least ~9 FP32 instructions a ray-vertex pair (the expanded form, with
// |v|^2 a vertex and |o|^2, d.o a ray taken once: 3 FFMA for z0, 1 FADD and
// 3 FFMA for |v - o|^2, 1 FFMA for h^2, the test); this kernel spends ~16 on
// the form from p above (3 FADD for p, 3 for z0, 3 FFMA for q, 3 for |q|^2,
// 2 for h^2, the test), 7 more a pair for the accuracy. A hit adds a square
// root, a min and a max. A 1280x720 frame against V = 6,890 is 6.35e9 pairs:
// 1.7 ms at 9 a pair, 3.0 ms at 16, at the card's 3.35e13 FP32 instructions
// a second (its published 67 TFLOP/s f32, which counts an FMA as two). The
// bytes (rays in, near and far out: 32 B a ray; the vertices, 12 B each) are
// a few tens of MB at most: microseconds.
//
// Design:
// - A thread holds 4 rays in registers (origin, direction, 1 - |d|^2 and the
//   running near and far), so that each vertex read from shared memory feeds
//   4 tests; a block of 128 threads holds a tile of 512 rays.
// - The vertices are staged in shared memory, 256 at a time as (x, y, z, 0)
//   float4s (4 KB), which every thread of the block reads at the same
//   address (a broadcast). The small stage keeps many blocks on an SM
//   whatever V is.
// - Every ray is tested against every vertex: no pair is skipped.
// - The grid is (ray tiles, vertex slices). At the render's 2,048-ray chunks
//   the ray tiles alone would fill 4 of 132 SMs, so the vertex axis is split
//   too, towards ~8 blocks an SM but into no more than V / 64 slices; each
//   slice writes its partial near and far to a scratch row, and a second
//   small kernel takes each ray's min and max over the slices (min and max
//   are exact, so the result does not depend on the split). A whole frame
//   at once needs one slice and one launch. (Combining in the last block of
//   each ray tile to finish, counted by an atomic ticket, saved the launch
//   but left 4 blocks to read the partial rows, and was slower on the
//   H100 at a 2,048-ray chunk than the two kernels.) The plan (slices,
//   vertices a slice) is computed in Python (hit_test.hit_plan) from R, V
//   and the SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int RAYS = 4;                  // rays a thread
constexpr int TILE = THREADS * RAYS;     // rays a block
constexpr int STAGE = 256;               // vertices in shared memory at a time
constexpr int COMBINE_THREADS = 256;

// (h^2, z0) of the vertex at p = v - o: z0 = d.p,
// h^2 = |p - z0 d|^2 + z0^2 e.
__device__ __forceinline__ float2 line_h2(float px, float py, float pz, float dx, float dy,
                                          float dz, float e) {
  const float z0 = __fmaf_rn(dz, pz, __fmaf_rn(dy, py, __fmul_rn(dx, px)));
  const float qx = __fmaf_rn(-z0, dx, px), qy = __fmaf_rn(-z0, dy, py),
              qz = __fmaf_rn(-z0, dz, pz);
  const float qq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));
  return make_float2(__fmaf_rn(__fmul_rn(z0, e), z0, qq), z0);
}

__global__ void __launch_bounds__(THREADS) hit_test_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ verts, float* __restrict__ near_out, float* __restrict__ far_out,
    int num_rays, int o_stride, int d_stride, int num_verts, int slice_verts, float r2) {
  __shared__ float4 tab[STAGE];
  const int v0 = blockIdx.y * slice_verts;
  const int v1 = min(num_verts, v0 + slice_verts);
  float ox[RAYS], oy[RAYS], oz[RAYS], dx[RAYS], dy[RAYS], dz[RAYS], e[RAYS];
  float nr[RAYS], fr[RAYS];
#pragma unroll
  for (int i = 0; i < RAYS; ++i) {
    const int ray = blockIdx.x * TILE + i * THREADS + threadIdx.x;
    const bool live = ray < num_rays;
    const size_t row = live ? ray : 0;
    const size_t ko = (size_t)o_stride * row, kd = (size_t)d_stride * row;
    ox[i] = live ? origins[ko] : 0.f;
    oy[i] = live ? origins[ko + 1] : 0.f;
    oz[i] = live ? origins[ko + 2] : 0.f;
    dx[i] = live ? dirs[kd] : 0.f;
    dy[i] = live ? dirs[kd + 1] : 0.f;
    dz[i] = live ? dirs[kd + 2] : 0.f;
    const double dd = __dadd_rn(__dadd_rn(__dmul_rn(dx[i], dx[i]), __dmul_rn(dy[i], dy[i])),
                                __dmul_rn(dz[i], dz[i]));
    e[i] = __double2float_rn(__dsub_rn(1.0, dd));
    nr[i] = INFINITY;
    fr[i] = -INFINITY;
  }
  for (int s0 = v0; s0 < v1; s0 += STAGE) {
    const int n = min(STAGE, v1 - s0);
    __syncthreads();  // the previous stage has been read
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const size_t k = 3 * (size_t)(s0 + j);
      tab[j] = make_float4(verts[k], verts[k + 1], verts[k + 2], 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 v = tab[j];
#pragma unroll
      for (int i = 0; i < RAYS; ++i) {
        const float2 hz = line_h2(__fsub_rn(v.x, ox[i]), __fsub_rn(v.y, oy[i]),
                                  __fsub_rn(v.z, oz[i]), dx[i], dy[i], dz[i], e[i]);
        const float disc = __fsub_rn(r2, hz.x);
        if (disc >= 0.f) {
          const float w = __fsqrt_rn(disc);
          nr[i] = fminf(nr[i], __fsub_rn(hz.y, w));
          fr[i] = fmaxf(fr[i], __fadd_rn(hz.y, w));
        }
      }
    }
  }
  const size_t row = (size_t)blockIdx.y * num_rays;
#pragma unroll
  for (int i = 0; i < RAYS; ++i) {
    const int ray = blockIdx.x * TILE + i * THREADS + threadIdx.x;
    if (ray < num_rays) {
      near_out[row + ray] = nr[i];
      far_out[row + ray] = fr[i];
    }
  }
}

// near and far of each ray: the min and max of its `slices` partial rows.
__global__ void __launch_bounds__(COMBINE_THREADS) hit_combine_kernel(
    const float* __restrict__ near_part, const float* __restrict__ far_part,
    float* __restrict__ near_out, float* __restrict__ far_out, int num_rays, int slices) {
  const int ray = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (ray >= num_rays) return;
  float n = INFINITY, f = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < slices; ++s) {
    n = fminf(n, near_part[(size_t)s * num_rays + ray]);
    f = fmaxf(f, far_part[(size_t)s * num_rays + ray]);
  }
  near_out[ray] = n;
  far_out[ray] = f;
}

}  // namespace

// origins, dirs [R, 3] f32, rows `o_stride` and `d_stride` floats apart (0:
// one row for all), each row's 3 floats contiguous; verts [V, 3] f32,
// contiguous; near, far [R]; near_part, far_part [slices, R] scratch (unused
// with one slice). Returns the cudaError_t of the launches (0 on success),
// -1 for a bad plan.
extern "C" int hit_test_launch(const float* origins, const float* dirs, const float* verts,
                               float* near_out, float* far_out, float* near_part,
                               float* far_part, int num_rays, int o_stride, int d_stride,
                               int num_verts, int slices, int slice_verts, float r2,
                               void* stream) {
  if (num_rays == 0) return 0;
  if (num_verts < 0 || o_stride < 0 || d_stride < 0 || slices < 1 || slice_verts < 1 ||
      slices > 65535 || (long long)slices * slice_verts < num_verts ||
      (num_verts > 0 && (long long)(slices - 1) * slice_verts >= num_verts) ||
      (slices > 1 && (!near_part || !far_part)))
    return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (num_rays + TILE - 1) / TILE;
  const bool one = slices == 1;
  hit_test_kernel<<<dim3(tiles, slices), THREADS, 0, st>>>(
      origins, dirs, verts, one ? near_out : near_part, one ? far_out : far_part, num_rays,
      o_stride, d_stride, num_verts, slice_verts, r2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return err;
  hit_combine_kernel<<<(num_rays + COMBINE_THREADS - 1) / COMBINE_THREADS, COMBINE_THREADS, 0,
                       st>>>(near_part, far_part, near_out, far_out, num_rays, slices);
  return cudaGetLastError();
}
