// fp32-accurate GEMM block tile for Hopper (sm_90a), shared by
// half_step.cu and chain.cu: out[M, N] (+)= A[M, K] . W over one k-range,
// with W stored [K, N] (TRANSPOSE = false) or [N, K] (TRANSPOSE = true),
// row-major.
//
// One block of 128 threads (2 x 2 warps) computes a (16*TM) x 64 tile of
// the output; each warp owns (8*TM) x 32 of it and each thread TM x 8
// sums in registers (TM = 2, 4, 8: 32, 64, 128 rows; the callers choose by
// the batch and the size of the product).
//
// The products run on the tensor cores at fp32 accuracy ("3xTF32"): on an
// H100 a CUDA-core tile with 8 x 8 sums a thread needs as many cycles of
// shared-memory reads as of FMAs (128 fp32 lanes but 128 bytes a cycle
// from shared memory per SM), and stops near a third of the fp32 peak.
// Each fp32 operand is split into a TF32 head and a TF32 tail
// (x = hi + lo, cvt.rna), and each 16 x 8 x 8 product is three
// mma.sync.m16n8k8 with fp32 accumulation: lo.hi + hi.lo + hi.hi; the
// dropped lo.lo term is below 2^-22 of the product. That is 3 tensor
// passes at 495 TFLOP/s instead of one CUDA-core pass at 67.
//
// Tiles of A and W travel global -> shared memory by cp.async through a
// ring of STAGES buffers, 16 bytes a copy, so the loads of tile t+3 are in
// flight while tile t is multiplied. Every copy carries its own byte count
// and zero-fills the rest, which masks ragged edges; an operand whose rows
// are not 16-byte aligned is copied 4 bytes at a time instead (chosen per
// launch and per operand). What a thread's copies share from tile to tile
// (source row, destination, byte count) is worked out once per call.
//
// Shared-memory layouts are chosen so that the mma fragments (a lane reads
// row lane/4, k lane%4) load without bank conflicts:
// - A and a transposed W keep the k index contiguous, as in global memory,
//   in rows of BK + 4 = 20 floats: 8 rows x 4 k fall into 32 banks;
// - a non-transposed W keeps the column index contiguous in rows of
//   BN + 8 = 72 floats: 4 k x 8 columns fall into 32 banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 128;
constexpr int STAGES = 4;
constexpr int LDK = BK + 4;        // row stride of a k-contiguous tile
constexpr int LDB = BN + 8;        // row stride of the n-contiguous W tile
constexpr int TN = 8;              // output columns per thread
constexpr int B_FLOATS = BN * LDK > BK * LDB ? BN * LDK : BK * LDB;

template <int TM>
struct Tile {
  static constexpr int BM = 16 * TM;
  static constexpr int A_FLOATS = BM * LDK;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

// One operand: base pointer, row stride in floats, and whether rows start
// 16-byte aligned (then 16-byte copies are used).
struct Operand {
  const float* p;
  int ld;
  bool vec;
};

__host__ __device__ inline bool rows_aligned16(const void* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && (ld & 3) == 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive floats, of which the first n_valid exist; the rest of
// the 16 bytes in shared memory is zero-filled. src is dereferenced only
// for the valid part.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           int n_valid, bool vec) {
  if (vec) {
    cp_async16(dst, src, 4 * n_valid);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = e < n_valid;
      cp_async4(dst + e, ok ? src + e : src, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ int clip4(int n) {
  return n < 0 ? 0 : (n > 4 ? 4 : n);
}

// ROWS x BK tile of a matrix whose k index is contiguous: tile row r is
// matrix row r0 + r (zero beyond n_rows), k range [k0, k0 + BK) clipped
// to k_end.
template <int ROWS>
__device__ __forceinline__ void load_k_contiguous(float* dst, Operand m,
                                                  int r0, int n_rows, int k0,
                                                  int k_end, int tid) {
#pragma unroll
  for (int c = tid; c < ROWS * (BK / 4); c += THREADS) {
    const int r = c / (BK / 4), kq = (c % (BK / 4)) * 4;
    const int gr = r0 + r, gk = k0 + kq;
    const int n_valid = gr < n_rows ? clip4(k_end - gk) : 0;
    const float* src = n_valid ? m.p + (size_t)gr * m.ld + gk : m.p;
    copy_chunk(dst + r * LDK + kq, src, n_valid, m.vec);
  }
}

// BK x BN tile of a [K, N] matrix: tile row kk is matrix row k0 + kk
// (zero from k_end on), columns [n0, n0 + BN) clipped to N.
__device__ __forceinline__ void load_n_contiguous(float* dst, Operand m,
                                                  int n0, int N, int k0,
                                                  int k_end, int tid) {
#pragma unroll
  for (int c = tid; c < BK * (BN / 4); c += THREADS) {
    const int kk = c / (BN / 4), nq = (c % (BN / 4)) * 4;
    const int gk = k0 + kk, gn = n0 + nq;
    const int n_valid = gk < k_end ? clip4(N - gn) : 0;
    const float* src = n_valid ? m.p + (size_t)gk * m.ld + gn : m.p;
    copy_chunk(dst + kk * LDB + nq, src, n_valid, m.vec);
  }
}

// Row and column, inside the block tile, of a thread's sum (i, j): the
// accumulator layout of mma.m16n8k8 (rows g and g + 8, columns 2t and
// 2t + 1 of each 16 x 8 piece, g = lane / 4, t = lane % 4), pieces i / 2
// down and j / 2 across the warp's part, warps 2 x 2.
template <int TM>
__device__ __forceinline__ int tile_row(int tid, int i) {
  return (tid >> 6) * (8 * TM) + (i >> 1) * 16 + ((tid & 31) >> 2) +
         8 * (i & 1);
}

__device__ __forceinline__ int tile_col(int tid, int j) {
  return ((tid >> 5) & 1) * 32 + (j >> 1) * 8 + 2 * (tid & 3) + (j & 1);
}

// x = hi + lo with both representable in TF32 (lo's own rounding is
// below 2^-22 of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8] on the tensor cores, fp32 sums.
__device__ __forceinline__ void mma_tf32(float& c0, float& c1, float& c2,
                                         float& c3, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += sum over k in [k_begin, k_end) of A[m0 + row, k] * W(k,
// n0 + col), k-tiles ascending. smem holds Tile<TM>::SMEM_BYTES. All
// threads of the block must call it; on return every copy has landed and
// every thread has passed a barrier, so smem may be reused at once.
template <bool TRANSPOSE, int TM>
__device__ __forceinline__ void block_tile(Operand a, Operand w, int M, int N,
                                           int m0, int n0, int k_begin,
                                           int k_end, float* smem,
                                           float (&acc)[TM][TN]) {
  using T = Tile<TM>;
  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int wm = (tid >> 6) * (8 * TM), wn = ((tid >> 5) & 1) * 32;
  constexpr int MT = TM / 2;  // 16-row pieces of the warp's part
  constexpr int NT = TN / 2;  // 8-column pieces
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // Fast path of the copies, for a k-tile that lies wholly inside the
  // k-range when both operands allow 16-byte copies: everything that does
  // not change from tile to tile (source row, destination, byte count of
  // each of the thread's chunks) is worked out once, here.
  const bool fast = a.vec && w.vec;
  constexpr int A_CHUNKS = T::BM * (BK / 4) / THREADS;
  constexpr int B_CHUNKS = BN * (BK / 4) / THREADS;
  constexpr int KC = BK / 4;         // 16-byte chunks per k-contiguous row
  constexpr int KROWS = THREADS / KC;  // rows one pass of the block copies
  constexpr int NC = BN / 4, NROWS = THREADS / NC;  // same, n-contiguous
  const int kr = tid / KC, kq4 = (tid % KC) * 4;
  const int nk = tid / NC, nq4 = (tid % NC) * 4;
  const float* a_src = a.p + (size_t)(m0 + kr) * a.ld + k_begin + kq4;
  const size_t a_step = (size_t)KROWS * a.ld;
  int a_bytes[A_CHUNKS];
#pragma unroll
  for (int q = 0; q < A_CHUNKS; ++q)
    a_bytes[q] = m0 + kr + KROWS * q < M ? 16 : 0;
  const float* w_src;
  size_t w_step, w_tile_step;
  int w_bytes[B_CHUNKS], w_dst;
  if (TRANSPOSE) {
    w_src = w.p + (size_t)(n0 + kr) * w.ld + k_begin + kq4;
    w_step = (size_t)KROWS * w.ld;
    w_tile_step = BK;
    w_dst = kr * LDK + kq4;
#pragma unroll
    for (int q = 0; q < B_CHUNKS; ++q)
      w_bytes[q] = n0 + kr + KROWS * q < N ? 16 : 0;
  } else {
    w_src = w.p + (size_t)(k_begin + nk) * w.ld + n0 + nq4;
    w_step = (size_t)NROWS * w.ld;
    w_tile_step = (size_t)BK * w.ld;
    w_dst = nk * LDB + nq4;
#pragma unroll
    for (int q = 0; q < B_CHUNKS; ++q) w_bytes[q] = 4 * clip4(N - n0 - nq4);
  }
  constexpr int W_DST_STEP = TRANSPOSE ? KROWS * LDK : NROWS * LDB;

  auto load = [&](int t) {
    float* as = smem + (t % STAGES) * T::STAGE_FLOATS;
    float* bs = as + T::A_FLOATS;
    const int k0 = k_begin + t * BK;
    if (fast && k0 + BK <= k_end) {
#pragma unroll
      for (int q = 0; q < A_CHUNKS; ++q)
        cp_async16(as + kr * LDK + kq4 + q * KROWS * LDK,
                   a_src + q * a_step + t * BK, a_bytes[q]);
#pragma unroll
      for (int q = 0; q < B_CHUNKS; ++q)
        cp_async16(bs + w_dst + q * W_DST_STEP,
                   w_src + q * w_step + t * w_tile_step, w_bytes[q]);
      return;
    }
    load_k_contiguous<T::BM>(as, a, m0, M, k0, k_end, tid);
    if (TRANSPOSE)
      load_k_contiguous<BN>(bs, w, n0, N, k0, k_end, tid);
    else
      load_n_contiguous(bs, w, n0, N, k0, k_end, tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for all, and tile t-1 is consumed
    if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);
    cp_async_commit();
    const float* as = smem + (t % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = as + (wm + mt * 16 + g) * LDK + k8 + t4;
        split_tf32(p[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(p[8 * LDK], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(p[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(p[8 * LDK + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (TRANSPOSE) {
          const float* p = bs + (wn + nt * 8 + g) * LDK + k8 + t4;
          split_tf32(p[0], b_hi[nt][0], b_lo[nt][0]);
          split_tf32(p[4], b_hi[nt][1], b_lo[nt][1]);
        } else {
          const float* p = bs + (k8 + t4) * LDB + wn + nt * 8 + g;
          split_tf32(p[0], b_hi[nt][0], b_lo[nt][0]);
          split_tf32(p[4 * LDB], b_hi[nt][1], b_lo[nt][1]);
        }
      }
      // the small terms first; the MT * NT products of one pass are
      // independent, so the tensor pipe never waits for a sum
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_tf32(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1],
                     acc[2 * mt + 1][2 * nt], acc[2 * mt + 1][2 * nt + 1],
                     pass == 0 ? a_lo[mt] : a_hi[mt],
                     pass == 1 ? b_lo[nt] : b_hi[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Write the thread's sums into a row-major [M, ld] buffer (one split-K
// slice's partial products), masked to M x N. dst is 16-byte aligned and
// ld a multiple of 4 (columns N..ld-1 are padding), so the two
// neighbouring columns of a piece go out as one 8-byte store and four
// lanes fill a 32-byte sector.
template <int TM>
__device__ __forceinline__ void store_partial(const float (&acc)[TM][TN],
                                              float* dst, int ld, int M,
                                              int m0, int n0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + tile_row<TM>(tid, i);
    if (r >= M) continue;
    float* row = dst + (size_t)r * ld;
#pragma unroll
    for (int j = 0; j < TN; j += 2) {
      const int c = n0 + tile_col(tid, j);
      if (c < ld)
        __stcg(reinterpret_cast<float2*>(row + c),
               make_float2(acc[i][j], acc[i][j + 1]));
    }
  }
}

// acc = sum over the slices, in the order 0, 1, 2, ..., of what
// store_partial wrote; the loads of one slice are in flight together.
template <int TM>
__device__ __forceinline__ void sum_partials(float (&acc)[TM][TN],
                                             const float* src, size_t plane,
                                             int slices, int ld, int M,
                                             int m0, int n0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int q = 0; q < slices; ++q) {
    const float* p = src + q * plane;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + tile_row<TM>(tid, i);
      if (r >= M) continue;
      const float* row = p + (size_t)r * ld;
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        const int c = n0 + tile_col(tid, j);
        if (c >= ld) continue;
        const float2 x = __ldcg(reinterpret_cast<const float2*>(row + c));
        acc[i][j] += x.x;
        acc[i][j + 1] += x.y;
      }
    }
  }
}

}  // namespace gemm
