// Fused RBM half-step for Hopper (sm_90a), fp32.
//
//   probs  = sigmoid((x . W[^T] + b) * inv_T)
//   sample = probs > u(seed, row0 + row, col0 + col)   (Philox4x32-10,
//                                                      philox.cuh)
//
// The seed of half_step_sample is keys[key_index] when keys is not null (a
// key table in device memory, which the host fills before each replay of a
// CUDA graph of an epoch, ops/graphs.py), else the value `seed`.
//
// row0 and col0 place the operand in a larger one: a data-parallel rank
// that holds rows row0.. of the batch, or a model-parallel rank that holds
// columns col0.. of W, draws the uniforms of those global elements, the
// bits a single device draws for them.
// One kernel body, three entry points, each replacing one TPU kernel:
//
// - half_step_sample: half_step_sample_aligned /
//   _make_half_step_sample_acc_kernel
//   (multimodal_idbn_tpu/ops/pallas_kernels.py:198-306), which the CD-k
//   trainer pallas_cd.fast_sampled_cd_update runs for every half-step of
//   the image stack; both directions (transpose_w).
// - half_step_probs: half_step_probs / _half_step_kernel
//   (pallas_kernels.py:60-64, :95-126), the deterministic probabilities
//   only: no uniform is drawn and no sample written, so it writes half the
//   bytes of half_step_sample.
// - half_step_sample_resident: half_step_sample / _half_step_sample_kernel
//   (pallas_kernels.py:67-91, :129-171), probs and sample for x . W from a
//   32-bit seed.
//
// The TPU kernels of the last two held the whole contraction dimension in
// VMEM (V <~ 3900, pallas_kernels.py:48-57); this body is k-tiled, so it
// has no such ceiling. The port's wrappers are in ops/half_step.py.
//
// What bounds it on an H100: at the flagship first layer one launch is
// 2*128*10000*1500 = 3.84 GFLOP over a 60 MB fp32 W. That W does not fit
// the 50 MB L2, so every half-step streams it from HBM (18 us at
// 3.35 TB/s), but the operations bound it first: 57 us at the fp32
// CUDA-core peak of 67 TFLOP/s, 23 us as three TF32 tensor-core passes at
// 495 TFLOP/s. The TPU kernel rounded its operands to bf16 for the MXU;
// this kernel keeps fp32 accuracy, which the flagship config pins. The
// product is skinny: at most 128 batch rows, so an output-tiled grid
// alone gives 24 to 48 blocks at the first layer and 8 to 32 at
// [128,500].[500,500] for 132 SMs.
//
// Design (the tile is gemm_tile.cuh: cp.async ring, error-compensated
// TF32 mma with fp32 sums):
// - Split-K fills the card. The contraction is cut into `slices` k-ranges
//   of k_per_slice (a multiple of 16, at most 1024: the tensor cores
//   truncate when they add to a sum, so a sum is kept short) and the grid
//   is column tiles x row tiles x slices; the wrapper chooses the tile's
//   rows and the two numbers from (B, K, N) alone (ops/half_step.py:
//   plan).
// - The reduction is deterministic. With more than one slice every block
//   writes its partial tile to a scratch buffer [slices, B, N4]; a ticket
//   counter per output tile tells the block that arrives last, and that
//   block alone sums the slices in the order 0, 1, 2, ... whoever it is,
//   then runs the epilogue once on the sum. No float atomics touch the
//   output, so two launches on the same inputs agree bit for bit, and the
//   three entries agree with each other. The last block puts the ticket
//   back to zero, so the wrapper zeroes the counters once.
// - Bias, temperature, sigmoid and, when sampling, the Philox uniform and
//   the Bernoulli compare are fused in that epilogue; every output is
//   written once. The uniform depends only on (seed, row, col), never on
//   the tiling or the slices.
// - transpose_w reads the same row-major [V, H] W for the visible
//   direction h . W^T with the same 16-byte copies (its tile is k-major).
// - Ragged edges and unaligned rows are handled in the tile's copies; any
//   B, K, N >= 1 is taken, and unlike the TPU callers nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"
#include "philox.cuh"

namespace {

struct HalfStepArgs {
  const float* x;     // [B, K]
  const float* w;     // [K, N], or [N, K] when transposed
  const float* b;     // [N]
  float* probs;       // [B, N]
  float* sample;      // [B, N], or null: probabilities only
  float* scratch;     // [slices, B, N rounded up to 4] when slices > 1
  int* tickets;       // one per output tile, zero between launches
  int B, K, N, slices, k_per_slice;
  float inv_T;
  const unsigned long long* keys;  // key table, or null: `seed` is the key
  int key_index;
  uint64_t seed;
  uint32_t row0, col0;  // global index of this operand's first row, column
};

template <bool TRANSPOSE, int TM>
__global__ void __launch_bounds__(gemm::THREADS, TM == 4 ? 4 : 5)
half_step_kernel(HalfStepArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  using T = gemm::Tile<TM>;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * gemm::BN;
  const int slice = blockIdx.z;
  const int k_begin = slice * a.k_per_slice;
  const int k_end = min(a.K, k_begin + a.k_per_slice);

  float acc[TM][gemm::TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < gemm::TN; ++j) acc[i][j] = 0.0f;

  const gemm::Operand xa{a.x, a.K, gemm::rows_aligned16(a.x, a.K)};
  const int ldw = TRANSPOSE ? a.K : a.N;
  const gemm::Operand wa{a.w, ldw, gemm::rows_aligned16(a.w, ldw)};
  gemm::block_tile<TRANSPOSE, TM>(xa, wa, a.B, a.N, m0, n0, k_begin, k_end,
                                  smem, acc);

  if (a.slices > 1) {
    const int ld = (a.N + 3) / 4 * 4;
    const size_t plane = (size_t)a.B * ld;
    gemm::store_partial<TM>(acc, a.scratch + slice * plane, ld, a.B, m0,
                            n0);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* ticket = a.tickets + blockIdx.y * gridDim.x + blockIdx.x;
      const int arrived = atomicAdd(ticket, 1);
      is_last = arrived == a.slices - 1;
      if (is_last) *ticket = 0;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    gemm::sum_partials<TM>(acc, a.scratch, plane, a.slices, ld, a.B, m0, n0);
  }

  const uint64_t seed =
      a.keys != nullptr ? __ldg(a.keys + a.key_index) : a.seed;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + gemm::tile_row<TM>(tid, i);
    if (r >= a.B) continue;
#pragma unroll
    for (int j = 0; j < gemm::TN; ++j) {
      const int c = n0 + gemm::tile_col(tid, j);
      if (c >= a.N) continue;
      const float p = sigmoidf_exact((acc[i][j] + __ldg(a.b + c)) * a.inv_T);
      const size_t o = (size_t)r * a.N + c;
      a.probs[o] = p;
      if (a.sample != nullptr) {
        const float u =
            philox_uniform(seed, a.row0 + (uint32_t)r,
                           a.col0 + (uint32_t)c, 0u, 0u);
        a.sample[o] = p > u ? 1.0f : 0.0f;
      }
    }
  }
}

template <bool TRANSPOSE, int TM>
int launch_tile(const HalfStepArgs& a, void* stream) {
  using T = gemm::Tile<TM>;
  auto kernel = half_step_kernel<TRANSPOSE, TM>;
  if (T::SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.N + gemm::BN - 1) / gemm::BN, (a.B + T::BM - 1) / T::BM,
                  a.slices);
  kernel<<<grid, gemm::THREADS, T::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// tile_rows is 32 or 64 (the block tile's rows); slices * k_per_slice
// must cover K with k_per_slice a multiple of 16; scratch and tickets may
// be null when slices == 1.
int launch(const float* x, const float* w, const float* b, float* probs,
           float* sample, float* scratch, int* tickets, int B, int K, int N,
           bool transpose_w, int tile_rows, int slices, int k_per_slice,
           float inv_T, const unsigned long long* keys, int key_index,
           uint64_t seed, int row0, int col0, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if ((tile_rows != 32 && tile_rows != 64) || slices < 1 ||
      slices > 65535 || k_per_slice < gemm::BK ||
      k_per_slice % gemm::BK != 0 ||
      (long long)slices * k_per_slice < (long long)K || row0 < 0 ||
      col0 < 0 || key_index < 0 ||
      (slices > 1 && (scratch == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const HalfStepArgs a{x, w, b, probs, sample, scratch, tickets, B, K, N,
                       slices, k_per_slice, inv_T, keys, key_index, seed,
                       (uint32_t)row0, (uint32_t)col0};
  if (tile_rows == 64)
    return transpose_w ? launch_tile<true, 4>(a, stream)
                       : launch_tile<false, 4>(a, stream);
  return transpose_w ? launch_tile<true, 2>(a, stream)
                     : launch_tile<false, 2>(a, stream);
}

}  // namespace

extern "C" int half_step_sample(const float* x, const float* w,
                                const float* b, float* probs, float* sample,
                                float* scratch, int* tickets, int B, int K,
                                int N, int transpose_w, int tile_rows,
                                int slices, int k_per_slice, float inv_T,
                                const unsigned long long* keys,
                                int key_index, unsigned long long seed,
                                int row0, int col0, void* stream) {
  return launch(x, w, b, probs, sample, scratch, tickets, B, K, N,
                transpose_w != 0, tile_rows, slices, k_per_slice, inv_T,
                keys, key_index, seed, row0, col0, stream);
}

extern "C" int half_step_probs(const float* x, const float* w,
                               const float* b, float* probs, float* scratch,
                               int* tickets, int B, int K, int N,
                               int tile_rows, int slices, int k_per_slice,
                               float inv_T, void* stream) {
  return launch(x, w, b, probs, nullptr, scratch, tickets, B, K, N, false,
                tile_rows, slices, k_per_slice, inv_T, nullptr, 0, 0, 0, 0,
                stream);
}

// seed is the TPU kernel's int32 seed; its 32 bits key Philox.
extern "C" int half_step_sample_resident(const float* x, const float* w,
                                         const float* b, float* probs,
                                         float* sample, float* scratch,
                                         int* tickets, int B, int K, int N,
                                         int tile_rows, int slices,
                                         int k_per_slice, float inv_T,
                                         unsigned int seed, void* stream) {
  return launch(x, w, b, probs, sample, scratch, tickets, B, K, N, false,
                tile_rows, slices, k_per_slice, inv_T, nullptr, 0,
                (uint64_t)seed, 0, 0, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
