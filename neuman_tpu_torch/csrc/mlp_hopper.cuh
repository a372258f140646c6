// Device code of the Hopper fused-MLP kernels: the NeRF pair (nerf_mlp.cu,
// nerf_mlp_bwd.cu), which replaces neuman_tpu/ops/pallas/raymarch.py
// `nerf_mlp_pallas` (:105) and raymarch_vjp.py `_mlp_bwd` (:76), and the
// offset-net pair (offset_mlp.cu, offset_mlp_bwd.cu), which replaces
// raymarch_vjp.py `_offset_fwd_impl` (:506) and `_offset_bwd` (:620): the
// positional encodings and their derivatives, one tile-product building
// block per compute dtype, shared by the forwards, their tapes and the
// backwards' chain passes, and the weight-gradient (dW) pass.
//
// What bounds these kernels on an H100: the MLP's multiply-adds (0.59 M a
// sample forward at 8 x 256, ~3x that backward) against 989 TFLOP/s (bf16
// tensor cores) or 67 TFLOP/s (f32 FMAs), and in bf16 also the weights: the
// ~1.2 MB of bf16 weights a tile of samples reads from L2.
//
// Block shape: 384 threads, two consumer warpgroups (8 warps) and a producer
// warpgroup, which gives most of its registers to the consumers (setmaxnreg:
// 40 a thread, the consumers 232). The producer's lane 0 streams "slabs" (weights in the forward and the chain
// pass, tape rows in the dW pass) into a ring of 32 KB stages of shared
// memory, with cp.async.bulk (a weight slab is laid out by the wrapper as the
// stage's image) or TMA tensor copies (tape rows), each completing on the
// stage's "full" mbarrier; every consumer warp arrives on the stage's "empty"
// mbarrier when it is done with it. The consumer warps never wait on L2 in
// their product loops. Blocks are persistent over the tiles, and every tile
// runs the same schedule of slabs, so the producer needs only the list.
//
// bf16: two consumer warpgroups, each on its own 64-sample tile, both read
//   every weight slab, so one slab serves 128 samples. A layer is
//   wgmma.mma_async m64nNk16 with f32 accumulators: A is the tile's
//   activations in shared memory, in blocks of 64 columns ("atoms": 64 rows
//   x 128 bytes, 128-byte swizzled, K-major, as the descriptor reads them),
//   B is a slab (N <= 256 rows of 64 k values, the same layout). The
//   epilogue writes the layer's output, rounded to bf16, into the same
//   layout, where the next layer's wgmma reads it.
// f32: no tensor cores (single-pass TF32 would change the numbers against the
//   JAX package). The 8 consumer warps share one 64-sample tile, stored
//   column-major ([column][sample]) so that a thread reads 8 samples with two
//   128-bit loads; a slab is 32 k-rows x N outputs, read 128 bits at a time;
//   each thread accumulates 8 samples x N/32 outputs (64 at N = 256).
//
// A layer writes its output over its input (the epilogue starts after the
// group's last read of the input), so a tile holds its PE in `pb` 64-column
// blocks (the NeRF's 63 columns in one, the offset net's 84 in two, zero
// past the PE's width) and W columns of hidden values after them (blocks
// pb .. pb + W/64 - 1): the skip input [PE, h] is blocks 0 .. pb + W/64 - 1,
// one contiguous range. The per-sample
// views layer reads [feature, dir PE] in f32, the plain version's order (a
// pre-activation within an ulp of 0 then rounds to the same side), from a
// block after h; bf16, whose shared memory has no room for it, reads
// [dir PE, feature] with the dir PE in block 0. The forward and the chain
// pass run the trunk through the same function (`trunk`), so the tape the
// forward writes is the chain pass's recompute bit for bit.

#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
typedef __nv_bfloat16 bf16;

constexpr int MAX_LAYERS = 16;

int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(float v) { return __float2bfloat16(v); }

struct PE {
  int mapping;  // 0 posenc, 1 rotate (3 inputs)
  int include_input;
  int n_bands;
  int out_dim;
  const float* coef;  // posenc: [n_bands] bands; rotate: [3 n_bands, 3] basis
};

// D <= 4 input planes [N] of a PE: (x, y, z) or the offset net's (x, y, z, t)
struct Planes {
  const float* p[4];
  int d;
};

constexpr int HT = 64;  // samples of a tile
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_WARP = CONSUMER_WARPS;  // the first warp of the third warpgroup
constexpr int HOPPER_THREADS = 3 * 128;
constexpr int STAGE_BYTES = 32768;  // a ring stage: a slab is at most 256 rows x 128 bytes
constexpr int MAX_STAGES = 4;
constexpr int ATOM = HT * 128;      // a 64-column block of a bf16 tile
constexpr int DLD = 65;             // row stride of the f32 d_pe scratch
constexpr int SCR_FLOATS = 4 * 4 * HT;  // head partial sums; the chain pass's cotangents
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can have on the H100
constexpr int DW_TILE = 128;        // dW output tiles are 128 x 128
constexpr int MAX_SUBS = 2 * MAX_LAYERS;

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory of one tile (activations, head scratch, d_pe in the NeRF
// chain pass) and of a whole block, for `groups` tiles and `stages` ring
// stages. Columns of a tile: pb PE blocks, h, and in f32 the NeRF's dir-PE
// block after h (views: the net has the view-direction head).
__host__ __device__ constexpr int tile_cols(int esize, int width, int pb = 1, bool views = true) {
  return 64 * pb + width + (esize == 4 && views ? 64 : 0);
}
// The block the per-sample views layer's dir PE is in.
__host__ __device__ constexpr int dpe_block(int esize, int width) {
  return esize == 4 ? 1 + width / 64 : 0;
}
__host__ __device__ constexpr int tile_bytes(int esize, int width, bool chain, int pb = 1,
                                             bool views = true) {
  return round1024(tile_cols(esize, width, pb, views) * HT * esize + SCR_FLOATS * 4 +
                   (chain ? HT * DLD * 4 : 0));
}
__host__ __device__ constexpr int block_bytes(int groups, int tile, int stages) {
  return 1024 /* alignment */ + stages * STAGE_BYTES + 1024 /* barriers */ + groups * tile;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the box of a 2-D tensor map at column c, row r
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int r,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Registers of the producer warpgroup and of the consumers: 128 x 40 + 256 x
// 232 <= 65,536. Every thread of a warpgroup runs it; the two roles' code
// never meets again after it.
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (layout
// type 1), the base 1024-byte aligned: lbo / sbo in bytes. K-major: sbo is
// the stride of 8-row groups, lbo unused; MN-major: lbo is the stride of
// 64-element groups along M or N, sbo that of 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[64 x N] += A[64 x 16] B[16 x N], bf16 operands from shared memory, f32
// accumulators; TA / TB: A / B MN-major (1) or K-major (0). Thread t of the
// warpgroup holds d[4 j + 2 h + e] at row 16 (t / 32) + (t % 32) / 4 + 8 h,
// column 8 j + 2 (t % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ------------------------------------------------------------------ ring

// The ring of slabs in shared memory. Every consumer thread and the producer
// keep their own copy of the position (stage, phase).
struct Ring {
  uint32_t base;       // shared address of stage 0 (1024-byte aligned)
  unsigned char* ptr;  // the same, generic
  uint32_t bars;       // full[i] at bars + 8 i, empty[i] at bars + 8 (MAX_STAGES + i)
  int stages, stage;
  uint32_t phase;
  __device__ uint32_t full() const { return bars + 8 * stage; }
  __device__ uint32_t empty() const { return bars + 8 * (MAX_STAGES + stage); }
  __device__ uint32_t slab() const { return base + stage * STAGE_BYTES; }
  __device__ const unsigned char* slab_ptr() const { return ptr + stage * STAGE_BYTES; }
  __device__ void advance() {
    if (++stage == stages) { stage = 0; phase ^= 1; }
  }
  __device__ void wait() const { mbar_wait(full(), phase); }
  // a consumer warp is done with the stage
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty());
    advance();
  }
  // the producer: wait until the stage is free, then expect `bytes` on it
  __device__ void acquire(uint32_t bytes) {
    mbar_wait(empty(), phase ^ 1);
    mbar_expect_tx(full(), bytes);
  }
};

// Lay out the ring at the 1024-aligned start of dynamic shared memory; every
// thread of the block calls it. Returns the (1024-aligned) memory after it.
__device__ unsigned char* ring_setup(Ring& r, int stages) {
  extern __shared__ unsigned char hopper_smem[];
  const uint32_t raw = smem_addr(hopper_smem);
  unsigned char* base = hopper_smem + ((1024 - (raw & 1023)) & 1023);
  r.ptr = base;
  r.base = smem_addr(base);
  r.bars = r.base + stages * STAGE_BYTES;
  r.stages = stages;
  r.stage = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(r.bars + 8 * i, 1);
      mbar_init(r.bars + 8 * (MAX_STAGES + i), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return base + stages * STAGE_BYTES + 1024;
}

// The producer: `reps` times the list of weight slabs (byte offset, bytes).
__device__ void produce(Ring& r, const unsigned char* img, const uint2* slabs, int n, int reps) {
  for (int u = 0; u < reps; ++u)
    for (int i = 0; i < n; ++i) {
      const uint2 e = slabs[i];
      r.acquire(e.y);
      bulk_load(r.slab(), img + e.x, e.y, r.full());
      r.advance();
    }
}

// A consumer group with no tile this round still takes every slab.
__device__ void drain(Ring& r, int n) {
  for (int i = 0; i < n; ++i) {
    r.wait();
    r.release();
  }
}

// ------------------------------------------------------------------ tiles

// The threads of one tile: a warpgroup (bf16) or the 8 consumer warps (f32).
struct Group {
  int tid, nthr, bar, warp;  // thread and warp index in the group, named barrier
  __device__ void sync() const { named_sync(bar, nthr); }
};

// Element (sample s, column c) of a tile's activations.
template <typename T> struct Act;
template <> struct Act<bf16> {
  unsigned char* p;  // block 0, 1024-byte aligned
  uint32_t s;        // its shared address
  __device__ bf16* at(int r, int c) const {
    return reinterpret_cast<bf16*>(p + (c >> 6) * ATOM + r * 128 +
                                   ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
  }
};
template <> struct Act<float> {
  float* p;
  uint32_t s;
  __device__ float* at(int r, int c) const { return p + c * HT + r; }
};

template <typename T> struct Tile {
  Act<T> act;
  float* scr;  // SCR_FLOATS f32
  float* dpe;  // [HT][DLD] f32 (the chain pass)
  Group g;
  int n0, rows;  // the tile's first sample; how many of its samples are real
};

// Tile `gi` of the block in the memory after the ring.
template <typename T, int W>
__device__ Tile<T> make_tile(unsigned char* rest, int gi, bool chain, int pb = 1,
                             bool views = true) {
  Tile<T> t;
  unsigned char* p = rest + gi * tile_bytes(sizeof(T), W, chain, pb, views);
  t.act.p = reinterpret_cast<decltype(t.act.p)>(p);
  t.act.s = smem_addr(p);
  t.scr = reinterpret_cast<float*>(p + tile_cols(sizeof(T), W, pb, views) * HT * sizeof(T));
  t.dpe = t.scr + SCR_FLOATS;
  const int warp = threadIdx.x / 32;
  if (sizeof(T) == 2) t.g = Group{(int)threadIdx.x % 128, 128, 1 + gi, warp % 4};
  else t.g = Group{(int)threadIdx.x, 256, 1, warp};
  return t;
}

// Rows of a tape from the tile's first sample, at the column of an output's
// first value; `rows` of them are written. And the ReLU masks of a backward
// product: the posts of the layer it masks (positive: on), rows past the
// tile's real samples off.
template <typename T> struct Rows {
  T* base;
  int ld, rows;
};
template <typename T> struct Mask {
  const T* base;
  int ld;
};

// The tile's columns [c0, c0 + n) to tape rows, 16 bytes a store.
__device__ void rows_out(const Tile<bf16>& t, int c0, int n, Rows<bf16> r) {
  const int per = n / 8;
  for (int idx = t.g.tid; idx < r.rows * per; idx += t.g.nthr) {
    const int s = idx / per, c = 8 * (idx % per);
    *reinterpret_cast<uint4*>(r.base + (size_t)s * r.ld + c) =
        *reinterpret_cast<const uint4*>(t.act.at(s, c0 + c));
  }
  t.g.sync();
}
__device__ void rows_out(const Tile<float>& t, int c0, int n, Rows<float> r) {
  for (int idx = t.g.tid; idx < HT * (n / 4); idx += t.g.nthr) {
    const int s = idx % HT, c = 4 * (idx / HT);
    if (s >= r.rows) continue;
    const float4 v = {*t.act.at(s, c0 + c), *t.act.at(s, c0 + c + 1), *t.act.at(s, c0 + c + 2),
                      *t.act.at(s, c0 + c + 3)};
    *reinterpret_cast<float4*>(r.base + (size_t)s * r.ld + c) = v;
  }
  t.g.sync();
}

// Tape rows (the tile's real samples; zeros past them) into columns [c0, c0 + n).
__device__ void rows_in(const Tile<bf16>& t, int c0, int n, const bf16* base, int ld) {
  const int per = n / 8;
  for (int idx = t.g.tid; idx < HT * per; idx += t.g.nthr) {
    const int s = idx / per, c = 8 * (idx % per);
    uint4 v = {0u, 0u, 0u, 0u};
    if (s < t.rows) v = *reinterpret_cast<const uint4*>(base + (size_t)s * ld + c);
    *reinterpret_cast<uint4*>(t.act.at(s, c0 + c)) = v;
  }
  fence_async_smem();
  t.g.sync();
}
__device__ void rows_in(const Tile<float>& t, int c0, int n, const float* base, int ld) {
  for (int idx = t.g.tid; idx < HT * (n / 4); idx += t.g.nthr) {
    const int s = idx % HT, c = 4 * (idx / HT);
    float4 v = {0.f, 0.f, 0.f, 0.f};
    if (s < t.rows) v = *reinterpret_cast<const float4*>(base + (size_t)s * ld + c);
    *t.act.at(s, c0 + c) = v.x;
    *t.act.at(s, c0 + c + 1) = v.y;
    *t.act.at(s, c0 + c + 2) = v.z;
    *t.act.at(s, c0 + c + 3) = v.w;
  }
  t.g.sync();
}

// b . v as the FMA chain fma(b2, v2, fma(b1, v1, b0 v0)), spelled out so
// that the compiler cannot reorder it: the operations of the plain PyTorch
// version (`embedder.rotate_projection`), so both take the sin and cos of
// the same argument, which reaches ~10^3 at the top band.
__device__ __forceinline__ float rot_proj(const float* b, const float* v) {
  return __fmaf_rn(b[2], v[2], __fmaf_rn(b[1], v[1], __fmul_rn(b[0], v[0])));
}

// v[i] of a 4-vector without a dynamic index (which would put v in local memory)
__device__ __forceinline__ float pick(const float v[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Column c of the PE of the d inputs v, as the plain PyTorch PE computes it
// (`embedder.embed`): posenc [v (d), sin(f0 v) (d), cos(f0 v) (d), sin(f1
// v), ...], each argument v f rounded to f32; rotate (d = 3) [v, sin(B v)
// all, cos(B v) all]. Columns from pe.out_dim on are 0.
__device__ __forceinline__ float pe_col(const PE& pe, const float v[4], int d, int c) {
  const int base = pe.include_input ? d : 0;
  if (c >= pe.out_dim) return 0.f;
  if (c < base) return pick(v, c);
  if (pe.mapping == 0) {
    const int r = c - base, band = r / (2 * d), k = r % (2 * d);
    const float a = pick(v, k < d ? k : k - d) * pe.coef[band];
    return k < d ? sinf(a) : cosf(a);
  }
  const int f = 3 * pe.n_bands, r = c - base, j = r < f ? r : r - f;
  const float a = rot_proj(pe.coef + 3 * j, v);
  return r < f ? sinf(a) : cosf(a);
}

// The PE of the planes into blocks blk .. blk + nblk - 1; samples at or past
// lim get zero inputs.
template <typename T>
__device__ void pe_fill(const Tile<T>& t, int blk, int nblk, const PE& pe, const Planes& in,
                        int lim) {
  const int cols = 64 * nblk;
  for (int idx = t.g.tid; idx < HT * cols; idx += t.g.nthr) {
    // bf16: neighbouring threads on neighbouring columns; f32 on samples
    const int s = sizeof(T) == 2 ? idx / cols : idx % HT;
    const int c = sizeof(T) == 2 ? idx % cols : idx / HT;
    const int g = t.n0 + s;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (a < in.d && g < lim) v[a] = in.p[a][g];
    *t.act.at(s, 64 * blk + c) = cvt<T>(pe_col(pe, v, in.d, c));
  }
  if (sizeof(T) == 2) fence_async_smem();
  t.g.sync();
}

// d(x, y, z) of one sample from d_pe [out_dim], in f32 (the plain
// version's `pe_bwd`).
__device__ void pe_bwd(const PE& pe, float x, float y, float z, const float* d, float out[3]) {
  const float v[4] = {x, y, z, 0.f};
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

// d(input a) of one sample of the posenc PE of d inputs, from d_pe [out_dim]
// (`ld` floats apart), in f32: the plain version's `pe_bwd`, band by band.
__device__ float pe_bwd_axis(const PE& pe, float x, int d, int a, const float* dpe, int ld) {
  const int base = pe.include_input ? d : 0;
  float acc = pe.include_input ? dpe[a * ld] : 0.f;
  for (int b = 0; b < pe.n_bands; ++b) {
    const float f = pe.coef[b];
    const float s = sinf(x * f), c = cosf(x * f);
    acc = acc + f * (c * dpe[(base + 2 * d * b + a) * ld] - s * dpe[(base + 2 * d * b + d + a) * ld]);
  }
  return acc;
}

// ------------------------------------------------------------ tile products

// out[s][o] = ep(s, o, sum_k A[s][k] B[o][k]) for the tile's 64 samples and
// the N outputs of one product (one part of a layer), masked by `mk`, then
// written to columns d0 .. d0 + N (STORE) and to tape rows (`tape`). A is the
// tile's blocks a0 .. a0 + kb; B comes from the ring, kb slabs (bf16) or 2 kb
// (f32). The sums run over k in order, in f32.
template <int N, bool STORE, class Ep>
__device__ void product(const Tile<bf16>& t, Ring& ring, int a0, int kb, int d0, Ep ep,
                        Mask<bf16> mk, Rows<bf16> tape) {
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint32_t a = t.act.s + a0 * ATOM;
  // one slab's products stay in flight while the next slab's are issued;
  // a slab is released once its products are done
  Ring next = ring;
  for (int j = 0; j < kb; ++j) {
    next.wait();
    const uint32_t b = next.slab();
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wgmma_bf16<0, 0>(d, sw128_desc(a + j * ATOM + 32 * q, 16, 1024),
                       sw128_desc(b + 32 * q, 16, 1024));
    wgmma_commit();
    next.advance();
    if (j > 0) {
      wgmma_wait<1>();
      ring.release();
    }
  }
  wgmma_wait<0>();
  if (kb > 0) ring.release();
  t.g.sync();  // the group's reads of A are done: the epilogue may overwrite it
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 16 * t.g.warp + (lane >> 2) + 8 * h, o = 8 * j + 2 * (lane & 3);
      float v0 = ep(s, o, d[4 * j + 2 * h]);
      float v1 = ep(s, o + 1, d[4 * j + 2 * h + 1]);
      if (mk.base != nullptr) {
        const bool live = s < t.rows;
        __nv_bfloat162 p = __floats2bfloat162_rn(0.f, 0.f);
        if (live) p = *reinterpret_cast<const __nv_bfloat162*>(mk.base + (size_t)s * mk.ld + o);
        v0 = live && __low2float(p) > 0.f ? v0 : 0.f;
        v1 = live && __high2float(p) > 0.f ? v1 : 0.f;
      }
      if constexpr (STORE)
        *reinterpret_cast<__nv_bfloat162*>(t.act.at(s, d0 + o)) = __floats2bfloat162_rn(v0, v1);
    }
  }
  if constexpr (STORE) {
    fence_async_smem();
    t.g.sync();
    if (tape.base != nullptr) rows_out(t, d0, N, tape);
  }
}

template <int NO>
__device__ __forceinline__ void load_vec(float (&v)[NO], const float* p) {
  if constexpr (NO % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else if constexpr (NO == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int NO>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[NO]) {
  if constexpr (NO % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NO; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (NO == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// f32: warp w computes samples 32 (w % 2) .. + 32 and outputs N/4 (w / 2) ..
// + N/4; lane l samples 8 (l % 4) .. + 8 and outputs N/32 (l / 4) .. + N/32.
template <int N, bool STORE, class Ep>
__device__ void product(const Tile<float>& t, Ring& ring, int a0, int kb, int d0, Ep ep,
                        Mask<float> mk, Rows<float> tape) {
  constexpr int NO = N / 32;
  const int lane = threadIdx.x & 31, w = t.g.warp;
  const int s0 = (w & 1) * 32 + (lane & 3) * 8;
  const int o0 = (w >> 1) * (N / 4) + (lane >> 2) * NO;
  float acc[8][NO];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  const float* x = t.act.p + a0 * 64 * HT + s0;
  for (int j = 0; j < 2 * kb; ++j, x += 32 * HT) {
    ring.wait();
    const float* wp = reinterpret_cast<const float*>(ring.slab_ptr()) + o0;
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(x + k * HT);
      const float4 x1 = *reinterpret_cast<const float4*>(x + k * HT + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float wv[NO];
      load_vec<NO>(wv, wp + k * N);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < NO; ++c) acc[i][c] = fmaf(xv[i], wv[c], acc[i][c]);
    }
    ring.release();
  }
  t.g.sync();  // every warp's reads of A are done
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = s0 + i;
    const bool live = s < t.rows;
    float post[NO];
#pragma unroll
    for (int c = 0; c < NO; ++c) post[c] = 0.f;
    if (mk.base != nullptr && live) load_vec<NO>(post, mk.base + (size_t)s * mk.ld + o0);
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      float v = ep(s, o0 + c, acc[i][c]);
      if (mk.base != nullptr) v = post[c] > 0.f ? v : 0.f;
      acc[i][c] = v;
      if constexpr (STORE) *t.act.at(s, d0 + o0 + c) = v;
    }
    if (tape.base != nullptr && s < tape.rows) store_vec<NO>(tape.base + (size_t)s * tape.ld + o0, acc[i]);
  }
  if constexpr (STORE) t.g.sync();
}

// A narrow head on CUDA cores: out[o * n + g] = x[s] . w[o] + b[o], x the
// tile's columns [c0, c0 + k), w [NOUT, k] (rounded to the compute dtype);
// each sample's dot product is split over nthr / 64 threads.
template <typename T, int NOUT>
__device__ void head(const Tile<T>& t, int c0, int k, const float* w, const float* b, float* out,
                     int n) {
  const int parts = t.g.nthr / HT, s = t.g.tid % HT, p = t.g.tid / HT, kp = k / parts;
  float acc[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) acc[o] = 0.f;
  for (int j = p * kp; j < (p + 1) * kp; ++j) {
    const float x = tof(*t.act.at(s, c0 + j));
#pragma unroll
    for (int o = 0; o < NOUT; ++o) acc[o] = fmaf(x, w[o * k + j], acc[o]);
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) t.scr[(p * NOUT + o) * HT + s] = acc[o];
  t.g.sync();
  if (t.g.tid < HT && t.n0 + s < n) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      float v = b[o];
      for (int q = 0; q < parts; ++q) v += t.scr[(q * NOUT + o) * HT + s];
      out[(size_t)o * n + t.n0 + s] = v;
    }
  }
  t.g.sync();
}

// ------------------------------------------------- the network, both passes

struct Net {
  const float *px, *py, *pz;  // [N] sample positions
  const float *dx, *dy, *dz;  // [N] per-sample directions, or null
  const float* dir_part;      // [R, W/2] per-ray direction term, or null
  const float* bias;          // f32, forward order: trunk, alpha, feature, views, rgb
  PE pos, dir;
  int spr, depth, skip_mask;
};

// whether trunk layer i's input starts with the PE (layer 0, and the layer
// after each skip)
__device__ __forceinline__ bool has_pe(int skip_mask, int i) {
  return i == 0 || ((skip_mask >> (i - 1)) & 1);
}

// The ReLU trunk on the tile's PE (blocks 0 .. pb - 1), leaving h in blocks
// pb .. pb + W/64 - 1; layer i's posts also go to tape rows at column i W
// (posts non-null). bias: the trunk's, layer by layer.
template <typename T, int W>
__device__ void trunk(const Tile<T>& t, Ring& ring, const float* bias, int depth, int skip_mask,
                      int pb, T* posts, int ld, int rows) {
  for (int i = 0; i < depth; ++i) {
    const bool pe = has_pe(skip_mask, i);
    const int kb = i == 0 ? pb : (pe ? pb + W / 64 : W / 64);
    product<W, true>(
        t, ring, pe ? 0 : pb, kb, 64 * pb,
        [bias](int, int o, float v) { return fmaxf(v + bias[o], 0.f); }, Mask<T>{nullptr, 0},
        Rows<T>{posts == nullptr ? nullptr : posts + i * W, ld, rows});
    bias += W;
  }
}

// After the trunk: the feature layer (over h) and the views layer (h2 into
// the first W/2 columns of block 1); per-sample, the direction PE goes to
// its block first. Each writes its tape columns where given.
template <typename T, int W>
__device__ void feature_views(const Tile<T>& t, Ring& ring, const Net& a, int lim, Rows<T> feat,
                              Rows<T> dpe, Rows<T> h2) {
  const float* bf = a.bias + a.depth * W + 1;
  product<W, true>(t, ring, 1, W / 64, 64, [bf](int, int o, float v) { return v + bf[o]; },
                   Mask<T>{nullptr, 0}, feat);
  const bool per_sample = a.dx != nullptr;
  constexpr int DB = dpe_block(sizeof(T), W);
  if (per_sample) {
    pe_fill(t, DB, 1, a.dir, Planes{{a.dx, a.dy, a.dz, nullptr}, 3}, lim);
    if (dpe.base != nullptr) rows_out(t, 64 * DB, 64, dpe);
  }
  const float* bv = bf + W;
  const float* dp = a.dir_part;
  const int n0 = t.n0, spr = a.spr;
  product<W / 2, true>(
      t, ring, per_sample ? min(DB, 1) : 1, per_sample ? 1 + W / 64 : W / 64, 64,
      [=](int s, int o, float v) {
        v += bv[o];
        if (dp != nullptr && n0 + s < lim) v += dp[(size_t)((n0 + s) / spr) * (W / 2) + o];
        return fmaxf(v, 0.f);
      },
      Mask<T>{nullptr, 0}, h2);
}

// ---------------------------------------------------------------- dW pass

// dW[o, k] = sum_s d_pre[s, o] h_in[s, k] of every layer, as products of
// column blocks of the chunk's tape rows ("subs": a layer's input may have
// two blocks, PE and posts, or feature and direction PE): both operands are
// sample-major, so both are MN-major for wgmma (the transpose bits), and
// arrive as 2-D TMA boxes. Output tiles are 128 x 128; the chunk's samples
// are split into contiguous ranges of `kper` rows (a multiple of 64), one
// block per tile and range, each writing its own partial; the reduce adds
// them in order. db[o] = sum_s d_pre[s, o] is summed from the A slabs by the
// first sub's first column tile. No atomics: two runs are bit-identical.
struct DwSub {
  int a_col, m;              // A: chunk-tape columns [a_col, a_col + m)
  int b_map, b_col, n;       // B: columns [b_col, b_col + n) of the tape (0) or the posts (1)
  int c_off, ldc, bias_off;  // dW[r][c] at c_off + r ldc + c; db[r] at bias_off + r, or -1
  int tiles_n, tile0;        // column tiles; the sub's first tile
};

struct DwArgs {
  DwSub S[MAX_SUBS];
  int n_subs, total, k, kper, post_row;  // chunk rows; rows per range; the chunk's first posts row
  float* partial;                        // [ranges, total]
};

template <typename T>
__device__ void dw_consume(const DwArgs& a, const DwSub& l, Ring& ring, int m0, int n0,
                           int slabs) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int SK = BF ? 64 : 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool db = l.bias_off >= 0 && n0 == 0;
  float* part = a.partial + (size_t)blockIdx.y * a.total;
  auto put = [&](int r, int c, float v) {
    if (r < l.m && c < l.n) part[l.c_off + (size_t)r * l.ldc + c] = v;
  };
  float bsum = 0.f;
  if constexpr (BF) {
    const int g = warp / 4, wt = threadIdx.x % 128;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    Ring next = ring;  // as in `product`: one slab's products in flight
    for (int j = 0; j < slabs; ++j) {
      next.wait();
      const uint32_t s = next.slab();
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q)  // k16 = two 8-row groups of 1024 bytes
        wgmma_bf16<1, 1>(d, sw128_desc(s + g * 8192 + 2048 * q, 8192, 1024),
                         sw128_desc(s + 16384 + 2048 * q, 8192, 1024));
      wgmma_commit();
      if (db && wt < 64) {
        const unsigned char* p = next.slab_ptr() + g * 8192;
        for (int r = 0; r < SK; ++r)
          bsum += __bfloat162float(*reinterpret_cast<const bf16*>(
              p + r * 128 + ((((wt >> 3) ^ (r & 7))) << 4) + (wt & 7) * 2));
      }
      next.advance();
      if (j > 0) {
        wgmma_wait<1>();
        ring.release();
      }
    }
    wgmma_wait<0>();
    if (slabs > 0) ring.release();
    const int w4 = warp % 4;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g * 64 + 16 * w4 + (lane >> 2) + 8 * h, c = n0 + 8 * j + 2 * (lane & 3);
        put(r, c, d[4 * j + 2 * h]);
        put(r, c + 1, d[4 * j + 2 * h + 1]);
      }
    if (db && wt < 64 && m0 + g * 64 + wt < l.m) part[l.bias_off + m0 + g * 64 + wt] = bsum;
  } else {
    const int wy = warp >> 1, wx = warp & 1;
    const int mr = (wy * 4 + (lane & 3)) * 8, nc = (wx * 8 + (lane >> 2)) * 8;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    for (int j = 0; j < slabs; ++j) {
      ring.wait();
      const float* A = reinterpret_cast<const float*>(ring.slab_ptr());
      const float* B = A + 4096;
#pragma unroll 4
      for (int k = 0; k < SK; ++k) {
        float av[8], bv[8];
        load_vec<8>(av, A + k * DW_TILE + mr);
        load_vec<8>(bv, B + k * DW_TILE + nc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
      if (db && threadIdx.x < DW_TILE)
        for (int k = 0; k < SK; ++k) bsum += A[k * DW_TILE + threadIdx.x];
      ring.release();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) put(m0 + mr + i, n0 + nc + c, acc[i][c]);
    if (db && threadIdx.x < DW_TILE && m0 + (int)threadIdx.x < l.m)
      part[l.bias_off + m0 + threadIdx.x] = bsum;
  }
}

// bf16: a stage holds A as two boxes [64 rows][64 columns] (128-byte
// swizzle), one for each warpgroup's 64 rows of the tile, and B as two such
// boxes side by side (128 columns); f32: A and B as boxes [32 rows][128
// columns], no swizzle. 32 KB a stage either way.
template <typename T>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    dw_kernel(const __grid_constant__ CUtensorMap tape_map,
              const __grid_constant__ CUtensorMap post_map, const DwArgs a) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int SK = BF ? 64 : 32;  // rows a slab
  Ring ring;
  ring_setup(ring, MAX_STAGES);
  int si = 0;
  while (si + 1 < a.n_subs && (int)blockIdx.x >= a.S[si + 1].tile0) ++si;
  const DwSub l = a.S[si];
  const int tile = blockIdx.x - l.tile0;
  const int m0 = tile / l.tiles_n * DW_TILE, n0 = tile % l.tiles_n * DW_TILE;
  const int k_lo = blockIdx.y * a.kper, k_hi = min(a.k, k_lo + a.kper);
  const int slabs = k_hi > k_lo ? (k_hi - k_lo + SK - 1) / SK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMER_WARPS) {
    producer_registers();
    if (warp == PRODUCER_WARP && lane == 0) {
      const CUtensorMap* bm = l.b_map ? &post_map : &tape_map;
      const int brow = l.b_map ? a.post_row : 0;
      for (int j = 0; j < slabs; ++j) {
        const int row = k_lo + j * SK;
        ring.acquire(STAGE_BYTES);
        const uint32_t s = ring.slab(), f = ring.full();
        if (BF) {
          tma_load(s, &tape_map, l.a_col + m0, row, f);
          tma_load(s + 8192, &tape_map, l.a_col + m0 + 64, row, f);
          tma_load(s + 16384, bm, l.b_col + n0, brow + row, f);
          tma_load(s + 24576, bm, l.b_col + n0 + 64, brow + row, f);
        } else {
          tma_load(s, &tape_map, l.a_col + m0, row, f);
          tma_load(s + 16384, bm, l.b_col + n0, brow + row, f);
        }
        ring.advance();
      }
    }
  } else {
    consumer_registers();
    dw_consume<T>(a, l, ring, m0, n0, slabs);
  }
}

// grad[e] += partial[0][e] + ... + partial[ranges - 1][e], in that order
__global__ void dw_reduce_kernel(const float* partial, float* grad, int total, int ranges) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int k = 0; k < ranges; ++k) s += partial[(size_t)k * total + e];
  grad[e] += s;
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The dW pass's map of a row-major [rows, cols] tape: bf16 boxes [64][64]
// with the 128-byte swizzle, f32 boxes [32][128]; out-of-range reads give 0.
bool tape_map(CUtensorMap* map, const void* base, int rows, int cols, int bf16) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {bf16 ? 64u : 128u, bf16 ? 64u : 32u};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// How many contiguous sample ranges the dW pass splits a chunk into: the
// count up to `most` whose blocks (tiles x ranges) fill the card's last wave
// best, the larger on a tie.
int dw_ranges(int tiles, int most) {
  const int sms = sm_count();
  int best = 1;
  double best_fill = 0.0;
  for (int r = 1; r <= most; ++r) {
    const int blocks = tiles * r, waves = (blocks + sms - 1) / sms;
    const double fill = (double)blocks / (waves * sms);
    if (fill >= best_fill - 1e-3) {
      best = r;
      best_fill = fill > best_fill ? fill : best_fill;
    }
  }
  return best;
}

// Ring stages that fit beside `groups` tiles of `tile` bytes.
int ring_stages(int groups, int tile) {
  int s = MAX_STAGES;
  while (s > 2 && block_bytes(groups, tile, s) > SMEM_LIMIT) --s;
  return s;
}

// Dynamic shared memory of a block of the tile kernels (bf16: two tiles,
// f32: one) of this shape with as many ring stages as fit, which go to
// *stages.
template <typename T>
int launch_smem(int width, bool chain, int pb, bool views, int* stages) {
  constexpr int G = sizeof(T) == 2 ? 2 : 1;
  const int tile = tile_bytes(sizeof(T), width, chain, pb, views);
  *stages = ring_stages(G, tile);
  return block_bytes(G, tile, *stages);
}

}  // namespace
