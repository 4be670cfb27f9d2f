// Whole-batch tensor-core tile for Hopper (sm_90a), used by half_step.cu:
// the sums of outT[n, b] = sum_k W(k, n) x[b, k] for a 128-column slab of
// W and every row of a batch of at most 128, over one k-range, on wgmma at
// fp32 accuracy (three TF32 passes). half_step.cu says why; this header
// holds the pieces: the PTX of TMA, mbarriers and wgmma, the shared-memory
// layout of a stage, the split of an operand into TF32 head and tail, and
// where each thread's sums lie in the output.
//
// Roles. A block has 384 threads: two consumer warpgroups (threads 0-255),
// each owning 64 of the slab's 128 columns, and a producer warpgroup, of
// which one warp (threads 256-287) keeps TMA loads in flight through a ring of
// STAGES stages, each a k-tile of KT = 32: the x tile [NB rows][32 k] and
// the W tile (up: [32 k][128 n] as four 32-column boxes; down, W stored
// [N, K]: [128 n][32 k]). Every TMA box is 128 bytes wide with the
// hardware's 128-byte swizzle (the 16-byte chunk c of line r lands at
// chunk c ^ (r % 8)), which is what keeps the reads below free of bank
// conflicts. A full barrier per stage counts the bytes in; an empty
// barrier per stage counts the consumer warps out.
//
// Operands of wgmma. In TF32 wgmma reads both shared-memory operands
// K-major and transposes only 16-bit types, so the upward W tile, whose
// columns are contiguous, cannot be read as it lies. The product is
// therefore computed transposed: W is the A operand (M = the slab's
// columns, 64 a warpgroup), fed from registers, and x is the B operand
// (N = NB, the batch rounded up to 32, 64 or 128), read from shared
// memory, where x is K-major as it lies in global memory.
//
// Head and tail. Each consumer thread loads its A fragment from the raw W
// tile and splits every element into hi = tf32(w) and lo = tf32(w - hi)
// in registers: every W element is split once, by the one thread that
// holds it. The consumers together split the raw x tile once into a head
// and a tail buffer in the canonical K-major layout without swizzle (core
// matrices of 8 rows x 16 bytes, LBO 128 bytes along k, SBO 1024 bytes
// along the rows), three sets of them in turn, then fence.proxy.async so
// that wgmma sees the generic stores. A k8 step is three wgmma into the
// same fp32 sums, the small terms first: lo.hi, hi.lo, hi.hi. Where every
// x of the stage is a TF32 number (the 0/1 states of CD), x's tail is
// zero, hi.lo adds exact zeros, and it is left out.
//
// A thread's sums. wgmma m64nNk8 gives thread `lane` of warp q of a
// warpgroup the sums of rows (16q + lane/4, +8) and columns 8j + 2(lane%4)
// (+1) of the 64 x NB product, d[4j + e] with e = 2 * (row half) +
// (column odd). A row m of A is a column n of W: the identity in the
// downward direction; upward a permutation (wg_col) under which the four
// loads of a fragment fall into 32 distinct banks of the swizzled tile.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int KT = 32;              // k per stage
constexpr int BN = 128;             // columns of W per block
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer's warpgroup
constexpr int NBUF = 3;             // head / tail buffer sets
constexpr int W_TILE_BYTES = BN * KT * 4;

template <int NB>
struct Layout {
  static constexpr int STAGES = NB == 128 ? 4 : (NB == 64 ? 6 : 8);
  static constexpr int X_BYTES = NB * KT * 4;
  static constexpr int STAGE_BYTES = X_BYTES + W_TILE_BYTES;
  static constexpr int SPLIT_BYTES = 2 * X_BYTES;  // head, then tail
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES + NBUF * SPLIT_BYTES;
  // + the barriers, + slack to align the base to the swizzle's 1024 bytes
  static constexpr int SMEM_BYTES = BAR_OFFSET + 2 * STAGES * 8 + 1024;
  static constexpr int ACC = NB / 2;  // sums per consumer thread
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The consumers' own barrier (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The same barrier, returning whether `p` holds for any consumer.
__device__ __forceinline__ bool consumers_sync_or(bool p) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, 256, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"((uint32_t)p)
      : "memory");
  return any != 0;
}

// Registers a thread of the warpgroup may hold from here on (setmaxnreg):
// the producer's warpgroup gives up what the consumers take.
template <int N>
__device__ __forceinline__ void max_registers_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void max_registers_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major operand without swizzle: start, LBO (between
// the two 16-byte core matrices of a k8 step), SBO (between 8-row groups).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// Column of the slab (0..127) of row `half` (0: lane/4, 1: lane/4 + 8) of
// consumer thread ts's part of the product.
template <bool TRANSPOSE>
__device__ __forceinline__ int wg_col(int ts, int half) {
  const int wg = ts >> 7, q = (ts >> 5) & 3, g = (ts & 31) >> 2;
  if (TRANSPOSE) return wg * 64 + q * 16 + g + 8 * half;
  return wg * 64 + (q >> 1) * 32 + (q & 1) * 8 + (g & 3) + (g >> 2) * 16 +
         4 * half;
}

// Float offset, in the raw W tile, of W(k, slab column n).
template <bool TRANSPOSE>
__device__ __forceinline__ int w_offset(int n, int k) {
  if (TRANSPOSE) return n * KT + ((((k >> 2) ^ (n & 7))) << 2) + (k & 3);
  const int c = n & 31;
  return (n >> 5) * (32 * KT) + k * 32 + ((((c >> 2) ^ (k & 7))) << 2) +
         (c & 3);
}

// Float offset, in the raw x tile, of x[row b, k].
__device__ __forceinline__ int x_offset(int b, int k) {
  return b * KT + ((((k >> 2) ^ (b & 7))) << 2) + (k & 3);
}

// The raw x tile, split into head and tail in the canonical layout: chunk
// c = 64 * (b / 8) + 8 * (k / 4) + b % 8 of 16 bytes at byte 16 * c.
// Returns whether any of the thread's tails is not zero.
template <int NB>
__device__ __forceinline__ bool split_x(const float* raw, float* hi,
                                        float* lo, int ts) {
  uint32_t tails = 0;
#pragma unroll
  for (int it = 0; it < NB * 8 / CONSUMERS; ++it) {
    const int c = it * CONSUMERS + ts;
    const int r = c & 7, kc = (c >> 3) & 7, b = (c >> 6) * 8 + r;
    const float4 v =
        *reinterpret_cast<const float4*>(raw + b * KT + ((kc ^ r) << 2));
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[c] = h;
    reinterpret_cast<uint4*>(lo)[c] = l;
    tails |= l.x | l.y | l.z | l.w;
  }
  return tails != 0;
}

template <int NB>
struct Mma;

template <>
struct Mma<32> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b_desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b_desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b_desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
  }
};


}  // namespace wg
