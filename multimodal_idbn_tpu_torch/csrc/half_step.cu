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
// Two kernel bodies, three entry points, each replacing one TPU kernel:
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
// VMEM (V <~ 3900, pallas_kernels.py:48-57); both bodies here are k-tiled,
// so they have no such ceiling. The port's wrappers, and `plan`, which
// picks the body, are in ops/half_step.py.
//
// What bounds it on an H100: at the flagship first layer one launch is
// 2*128*10000*1500 = 3.84 GFLOP over a 60 MB fp32 W, which does not fit the
// 50 MB L2, so every half-step streams W from HBM: 18 us at 3.35 TB/s.
// The TPU kernel rounded its operands to bf16 for the MXU; this kernel
// keeps fp32 accuracy, which the flagship config pins, as three TF32
// tensor-core passes: 23 us at 495 TFLOP/s. So W's bytes and the three
// passes bound it about equally, and a design has to stream W once, at
// full rate, while the tensor cores run near theirs. The product is
// skinny: at most 128 batch rows.
//
// The wgmma body (wgmma_tile.cuh; every operand whose rows are 16-byte
// aligned, at most 128 rows):
// - One block holds the whole batch and a slab of 128 columns of W, so
//   every W element crosses from L2 to an SM once per launch and x once
//   per slab. One producer warp feeds a ring of 4 (6 for 64 rows, 8 for
//   32) k-tiles of 32 through TMA with 128-byte swizzle and mbarriers; two
//   consumer warpgroups of 64 columns each run wgmma, with the registers
//   the producer's warpgroup gives up (setmaxnreg), so that a whole
//   stage's wgmma stay in flight while the next stage is prepared.
// - wgmma reads shared-memory operands K-major in TF32, and the upward W
//   tile has its columns contiguous; so the product is computed
//   transposed, out^T = W^T . x^T: W is the A operand, read from
//   registers, and x the B operand, read from shared memory, where it is
//   K-major as it lies. The same holds downward (h . W^T), so both
//   directions share one body; only the A fragment's addresses differ.
// - Head and tail (hi = tf32(v), lo = tf32(v - hi)): each consumer thread
//   splits its own A fragment in registers, and the consumers split the x
//   tile once into head and tail buffers in shared memory (fenced for the
//   async proxy). A k8 step is three wgmma into the same fp32 sums:
//   lo.hi + hi.lo + hi.hi, the terms of the mma_sync body below. Where a
//   stage's x are all TF32 numbers, as CD's sampled 0/1 states are, x's
//   tail is zero and hi.lo, which would add exact zeros, is left out:
//   the consumers' barrier after the split reduces "any tail not zero"
//   over the block (bar.red.or), so the sums and their bits are those of
//   the three passes.
// - Split-K fills the card: the work is (slab, k-slice) units, slices of a
//   multiple of 32 and at most 1024 terms (the tensor cores truncate when
//   they add to a sum, so a sum is kept short), about one unit per SM;
//   the grid is persistent (at most one block per SM, units in turn) and
//   launched cooperatively. Each unit writes its partial sums to scratch
//   in the threads' own register order; after a grid barrier every block
//   sums its share of the output over the slices in the order 0, 1, 2,
//   ..., with no float atomics, and runs the epilogue on it, so the
//   reduction and the Philox draws are spread over the whole card (with
//   one slice too: 12 blocks drawing a 128 x 1500 output's uniforms alone
//   take longer than the product).
// - Why unaligned operands keep the mma_sync body: TMA needs 16-byte
//   aligned rows, and the old body's copies take any row. The wrapper
//   picks the body from the whole operand's shape (plan_shape), so a rank
//   takes the body the single-device launch takes; a rank's part of W
//   whose own rows are unaligned (a model-parallel rank's columns) is
//   loaded by the producer warp's own loads into the same tile, which
//   gives the same bits.
//
// The mma_sync body (gemm_tile.cuh: cp.async ring, error-compensated TF32
// mma.sync with fp32 sums; the ragged and unaligned shapes): the grid is
// column tiles x row tiles x slices; with more than one slice every block
// writes its partial tile to a scratch buffer [slices, B, N4]; a ticket
// counter per output tile tells the block that arrives last, and that
// block alone sums the slices in the order 0, 1, 2, ..., then runs the
// epilogue once on the sum; it puts the ticket back to zero.
//
// In both, bias, temperature, sigmoid and, when sampling, the Philox
// uniform and the Bernoulli compare are fused in the epilogue; every
// output is written once. The uniform depends only on (seed, row, col),
// never on the tiling or the slices; two launches on the same inputs
// agree bit for bit, and the three entries agree with each other.
//
// Three more entries give the visible units that are not Bernoulli their
// half-steps, on both bodies, as other instances of the same templates
// (EPI, the epilogue; the Bernoulli kernels keep their names and code):
// - half_step_linear (EPI_LINEAR): out = (x . W^T + b) * inv_T, no draw:
//   the logits of a replicated-softmax visible layer, whose words the row
//   kernel of rsoftmax.cu draws.
// - half_step_gauss (EPI_GAUSS): mean = (x . W^T + b) * inv_T and sample
//   = mean + n(seed, row0 + row, col0 + col), the N(0, 1) of Philox words 0
//   and 1 at the uniform's counter (philox.cuh): a Gaussian visible layer
//   of unit variance, drawn downward.
// - half_step_scaled (EPI_ROW_SCALED): probs = sigmoid((x . W + s_row * b)
//   * inv_T) and its Bernoulli sample: the hidden layer above a
//   replicated-softmax visible, whose bias counts once per word of the row
//   (s_row = D, the row's words).
// They are instantiated for the direction they are used in (down, down,
// up), and count their launches under their own names.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "gemm_tile.cuh"
#include "philox.cuh"
#include "wgmma_tile.cuh"

namespace {

struct HalfStepArgs {
  const float* x;     // [B, K]
  const float* w;     // [K, N], or [N, K] when transposed
  const float* b;     // [N]
  float* probs;       // [B, N]
  float* sample;      // [B, N], or null: probabilities only
  float* scratch;     // partial sums when slices > 1
  int* tickets;       // counters, zero between launches
  int B, K, N, slices, k_per_slice;
  float inv_T;
  const unsigned long long* keys;  // key table, or null: `seed` is the key
  int key_index;
  uint64_t seed;
  uint32_t row0, col0;  // global index of this operand's first row, column
  const float* row_scale;  // [B], the bias's factor per row (EPI_ROW_SCALED)
};

// The epilogues: EPI_SIGMOID is the Bernoulli half-step's.
enum { EPI_SIGMOID = 0, EPI_LINEAR = 1, EPI_GAUSS = 2, EPI_ROW_SCALED = 3 };

__device__ __forceinline__ uint64_t seed_of(const HalfStepArgs& a) {
  return a.keys != nullptr ? __ldg(a.keys + a.key_index) : a.seed;
}

// The uniform of output (r, c).
__device__ __forceinline__ float uniform_of(const HalfStepArgs& a,
                                            uint64_t seed, int r, int c) {
  return philox_uniform(seed, a.row0 + (uint32_t)r, a.col0 + (uint32_t)c, 0u,
                        0u);
}

// The epilogue of output (r, c) from its sum over the contraction and its
// uniform (read only when sampling).
__device__ __forceinline__ void emit(const HalfStepArgs& a, int r, int c,
                                     float sum, float u) {
  const float p = sigmoidf_exact((sum + __ldg(a.b + c)) * a.inv_T);
  const size_t o = (size_t)r * a.N + c;
  a.probs[o] = p;
  if (a.sample != nullptr) a.sample[o] = p > u ? 1.0f : 0.0f;
}

// The epilogue of output (r, c) of the other instances, which draw their
// own noise from the seed.
template <int EPI>
__device__ __forceinline__ void emit_mode(const HalfStepArgs& a,
                                          uint64_t seed, int r, int c,
                                          float sum) {
  const size_t o = (size_t)r * a.N + c;
  if constexpr (EPI == EPI_ROW_SCALED) {
    const float p = sigmoidf_exact(
        (sum + __ldg(a.row_scale + r) * __ldg(a.b + c)) * a.inv_T);
    a.probs[o] = p;
    if (a.sample != nullptr)
      a.sample[o] = p > uniform_of(a, seed, r, c) ? 1.0f : 0.0f;
  } else {
    const float m = (sum + __ldg(a.b + c)) * a.inv_T;
    a.probs[o] = m;
    if (EPI == EPI_GAUSS && a.sample != nullptr)
      a.sample[o] = m + philox_normal(seed, a.row0 + (uint32_t)r,
                                      a.col0 + (uint32_t)c, 0u, 0u);
  }
}

// Output (r, c) through epilogue EPI.
template <int EPI>
__device__ __forceinline__ void emit_epi(const HalfStepArgs& a, uint64_t seed,
                                         int r, int c, float sum) {
  if constexpr (EPI == EPI_SIGMOID)
    emit(a, r, c, sum,
         a.sample != nullptr ? uniform_of(a, seed, r, c) : 0.0f);
  else
    emit_mode<EPI>(a, seed, r, c, sum);
}

// ---------------------------------------------------------------------------
// The mma_sync body
// ---------------------------------------------------------------------------

template <bool TRANSPOSE, int TM, int EPI>
__device__ __forceinline__ void mma_sync_body(const HalfStepArgs& a) {
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

  const uint64_t seed = seed_of(a);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + gemm::tile_row<TM>(tid, i);
    if (r >= a.B) continue;
#pragma unroll
    for (int j = 0; j < gemm::TN; ++j) {
      const int c = n0 + gemm::tile_col(tid, j);
      if (c >= a.N) continue;
      emit_epi<EPI>(a, seed, r, c, acc[i][j]);
    }
  }
}

template <bool TRANSPOSE, int TM>
__global__ void __launch_bounds__(gemm::THREADS, TM == 4 ? 4 : 5)
half_step_kernel(HalfStepArgs a) {
  mma_sync_body<TRANSPOSE, TM, EPI_SIGMOID>(a);
}

template <bool TRANSPOSE, int TM, int EPI>
__global__ void __launch_bounds__(gemm::THREADS, TM == 4 ? 4 : 5)
half_step_mode_kernel(HalfStepArgs a) {
  mma_sync_body<TRANSPOSE, TM, EPI>(a);
}

template <bool TRANSPOSE, int TM, int EPI>
constexpr auto tile_kernel() {
  if constexpr (EPI == EPI_SIGMOID)
    return &half_step_kernel<TRANSPOSE, TM>;
  else
    return &half_step_mode_kernel<TRANSPOSE, TM, EPI>;
}

template <bool TRANSPOSE, int TM, int EPI>
int launch_tile(const HalfStepArgs& a, void* stream) {
  using T = gemm::Tile<TM>;
  auto kernel = tile_kernel<TRANSPOSE, TM, EPI>();
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

// ---------------------------------------------------------------------------
// The wgmma body
// ---------------------------------------------------------------------------

struct WgArgs {
  HalfStepArgs a;
  int tiles;         // slabs of 128 columns
  int tma_x, tma_w;  // the operand's rows suit TMA; else the producer's loads
};

// The consumers of every block meet here (a co-resident grid: the launch
// is cooperative); what any consumer wrote before is visible after.
__device__ __forceinline__ void grid_sync(unsigned* counter) {
  wg::consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < gridDim.x);
    __threadfence();
  }
  wg::consumers_sync();
}

// The outputs of float4 f of a slice's partial sums: row r and r + 1 of
// columns c0 and c1 (.x: (r, c0), .y: (r + 1, c0), .z: (r, c1), .w: (r + 1,
// c1)); the float4 holds consumer thread f % 256's sums 4j..4j+3 of slab
// f / (256 * NB / 8).
template <bool TRANSPOSE, int NB>
__device__ __forceinline__ void outputs_of(int f, int& r, int& c0, int& c1) {
  const int owner = f % wg::CONSUMERS;
  const int j = (f / wg::CONSUMERS) % (NB / 8);
  const int n0 = f / (wg::CONSUMERS * (NB / 8)) * wg::BN;
  r = 8 * j + 2 * (owner & 3);
  c0 = n0 + wg::wg_col<TRANSPOSE>(owner, 0);
  c1 = n0 + wg::wg_col<TRANSPOSE>(owner, 1);
}

// The producer warp's own loads of one stage, for an operand whose rows do
// not suit TMA: the same tile, zero beyond the operand's edges.
template <bool TRANSPOSE, int NB>
__device__ __forceinline__ void load_by_hand(const WgArgs& g, float* xs,
                                             float* ws, int n0, int k0,
                                             int lane) {
  const HalfStepArgs& a = g.a;
  if (!g.tma_x) {
    for (int e = lane; e < NB * wg::KT; e += 32) {
      const int r = e / wg::KT, k = e % wg::KT, gk = k0 + k;
      xs[wg::x_offset(r, k)] =
          r < a.B && gk < a.K ? a.x[(size_t)r * a.K + gk] : 0.0f;
    }
  }
  if (!g.tma_w) {
    for (int e = lane; e < wg::BN * wg::KT; e += 32) {
      // TRANSPOSE: W is [N, K], k contiguous; else [K, N], n contiguous
      const int n = TRANSPOSE ? e / wg::KT : e % wg::BN;
      const int k = TRANSPOSE ? e % wg::KT : e / wg::BN;
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.0f;
      if (gn < a.N && gk < a.K)
        v = TRANSPOSE ? a.w[(size_t)gn * a.K + gk] : a.w[(size_t)gk * a.N + gn];
      ws[wg::w_offset<TRANSPOSE>(n, k)] = v;
    }
  }
}

template <bool TRANSPOSE, int NB, int EPI>
__device__ __forceinline__ void wgmma_body(const CUtensorMap& xmap,
                                           const CUtensorMap& wmap,
                                           const WgArgs& g) {
  using L = wg::Layout<NB>;
  const HalfStepArgs& a = g.a;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  uint64_t* empty = full + L::STAGES;
  auto x_tile = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * L::STAGE_BYTES);
  };
  auto w_tile = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * L::STAGE_BYTES +
                                    L::X_BYTES);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], wg::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int units = g.tiles * a.slices;
  if (tid >= wg::CONSUMERS) {
    // the producer's warpgroup: 40 registers a thread, one warp at work,
    // stage s of the block's units in turn
    wg::max_registers_dec<40>();
    if (tid >= wg::CONSUMERS + 32) return;
    const int lane = tid & 31;
    const uint32_t tx =
        (g.tma_x ? L::X_BYTES : 0) + (g.tma_w ? wg::W_TILE_BYTES : 0);
    int s = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n0 = (u % g.tiles) * wg::BN;
      const int k_begin = (u / g.tiles) * a.k_per_slice;
      const int k_end = min(a.K, k_begin + a.k_per_slice);
      for (int k0 = k_begin; k0 < k_end; k0 += wg::KT, ++s) {
        const int slot = s % L::STAGES;
        wg::mbar_wait(&empty[slot], ((s / L::STAGES) & 1) ^ 1);
        float* xs = x_tile(slot);
        float* ws = w_tile(slot);
        if (lane == 0) {
          if (tx) wg::mbar_expect_tx(&full[slot], tx);
          if (g.tma_x) wg::tma_load(xs, &xmap, &full[slot], k0, 0);
          if (g.tma_w) {
            if (TRANSPOSE) {
              wg::tma_load(ws, &wmap, &full[slot], k0, n0);
            } else {
#pragma unroll
              for (int i = 0; i < wg::BN / 32; ++i)
                wg::tma_load(ws + i * 32 * wg::KT, &wmap, &full[slot],
                             n0 + 32 * i, k0);
            }
          }
        }
        if (!g.tma_x || !g.tma_w)
          load_by_hand<TRANSPOSE, NB>(g, xs, ws, n0, k0, lane);
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // the consumers: thread ts holds rows (16q + lane/4, +8) of its
  // warpgroup's 64 columns and L::ACC sums of them
  wg::max_registers_inc<232>();
  const int ts = tid, lane = ts & 31, t = lane & 3;
  const int col[2] = {wg::wg_col<TRANSPOSE>(ts, 0),
                      wg::wg_col<TRANSPOSE>(ts, 1)};
  float acc[L::ACC];
  uint32_t fh[4][4], fl[4][4];  // the fragments' heads and tails, per k8 step

  // stage s: its x tile split into head and tail, the thread's A
  // fragments loaded and the slot handed back; then per k8 step j the
  // fragment split into register set j and three wgmma, one commit group
  // a step; up to four groups stay in flight, so the tensor cores work
  // through the next stage's loads and split, and set j is free again
  // once the step four groups back has completed
  auto stage = [&](int s) {
    const int slot = s % L::STAGES;
    uint8_t* split = smem + L::STAGES * L::STAGE_BYTES +
                     (s % wg::NBUF) * L::SPLIT_BYTES;
    float* hi = reinterpret_cast<float*>(split);
    float* lo = reinterpret_cast<float*>(split + L::X_BYTES);
    wg::mbar_wait(&full[slot], (s / L::STAGES) & 1);
    const bool tails = wg::split_x<NB>(x_tile(slot), hi, lo, ts);
    const float* ws = w_tile(slot);
    float frag[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        frag[j][r] = ws[wg::w_offset<TRANSPOSE>(col[r & 1],
                                                8 * j + t + 4 * (r >> 1))];
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[slot]);
    __syncwarp();
    wg::fence_proxy_async();
    const bool x_tail = wg::consumers_sync_or(tails);
    const uint32_t hb = wg::smem_u32(hi), lb = wg::smem_u32(lo);
    // per k8 step: lo.hi, hi.lo (where x has a tail) and hi.hi
    auto k8_steps = [&](auto with_tail) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) wg::split(frag[j][r], fh[j][r], fl[j][r]);
        wg::wgmma_fence();
        const uint64_t dh = wg::desc(hb + 256 * j, 128, 1024);
        wg::Mma<NB>::run(acc, fl[j], dh);
        if constexpr (decltype(with_tail)::value)
          wg::Mma<NB>::run(acc, fh[j], wg::desc(lb + 256 * j, 128, 1024));
        wg::Mma<NB>::run(acc, fh[j], dh);
        wg::wgmma_commit();
        wg::wgmma_wait<3>();
      }
    };
    if (x_tail)
      k8_steps(std::true_type());
    else
      k8_steps(std::false_type());
  };

  float4* scratch = reinterpret_cast<float4*>(a.scratch);
  int s = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u % g.tiles, slice = u / g.tiles;
    const int k_begin = slice * a.k_per_slice;
    const int n_kt = (min(a.K, k_begin + a.k_per_slice) - k_begin +
                      wg::KT - 1) / wg::KT;
#pragma unroll
    for (int i = 0; i < L::ACC; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < n_kt; ++kt) stage(s++);
    wg::wgmma_wait<0>();
    float4* dst =
        scratch + (size_t)(slice * g.tiles + tile) * (NB / 8) * wg::CONSUMERS;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
      __stcg(dst + j * wg::CONSUMERS + ts,
             make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                         acc[4 * j + 3]));
  }

  // every block: its share of the output, summed over the slices in the
  // order 0, 1, 2, ..., through the epilogue
  unsigned* counters = reinterpret_cast<unsigned*>(a.tickets);
  grid_sync(&counters[0]);
  const int plane = g.tiles * (NB / 8) * wg::CONSUMERS;  // float4s a slice
  const uint64_t seed = seed_of(a);
  const int step = gridDim.x * wg::CONSUMERS;
  constexpr int U = 4;  // float4s a thread has in flight
  for (int f0 = blockIdx.x * wg::CONSUMERS + ts; f0 < plane; f0 += U * step) {
    float4 sum[U];
#pragma unroll
    for (int i = 0; i < U; ++i) sum[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
    for (int q = 0; q < a.slices; ++q) {
      float4 v[U];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (f0 + i * step < plane)
          v[i] = __ldcg(scratch + (size_t)q * plane + f0 + i * step);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        sum[i].x += v[i].x;
        sum[i].y += v[i].y;
        sum[i].z += v[i].z;
        sum[i].w += v[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (f0 + i * step >= plane) break;
      int r, c0, c1;
      outputs_of<TRANSPOSE, NB>(f0 + i * step, r, c0, c1);
      const float v[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e & 1), c = e < 2 ? c0 : c1;
        if (rr < a.B && c < a.N) emit_epi<EPI>(a, seed, rr, c, v[e]);
      }
    }
  }
  // the last block out puts the counters back to zero
  wg::consumers_sync();
  if (ts == 0 && atomicAdd(&counters[1], 1u) == gridDim.x - 1) {
    counters[0] = 0;
    counters[1] = 0;
  }
}

template <bool TRANSPOSE, int NB>
__global__ void __launch_bounds__(wg::THREADS, 1)
half_step_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const WgArgs g) {
  wgmma_body<TRANSPOSE, NB, EPI_SIGMOID>(xmap, wmap, g);
}

template <bool TRANSPOSE, int NB, int EPI>
__global__ void __launch_bounds__(wg::THREADS, 1)
half_step_mode_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const WgArgs g) {
  wgmma_body<TRANSPOSE, NB, EPI>(xmap, wmap, g);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major fp32 [rows, cols] at p, read in boxes of 32 columns (128
// bytes, swizzled) by box_rows rows, zero beyond its edges.
bool encode(CUtensorMap* map, const float* p, int rows, int cols,
            int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tma_ready(const float* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && (ld & 3) == 0;
}

template <bool TRANSPOSE, int NB, int EPI>
constexpr auto wgmma_kernel() {
  if constexpr (EPI == EPI_SIGMOID)
    return &half_step_wgmma<TRANSPOSE, NB>;
  else
    return &half_step_mode_wgmma<TRANSPOSE, NB, EPI>;
}

template <bool TRANSPOSE, int NB, int EPI>
int launch_wgmma(const HalfStepArgs& a, void* stream) {
  using L = wg::Layout<NB>;
  auto kernel = wgmma_kernel<TRANSPOSE, NB, EPI>();
  static int capacity[64] = {0};  // co-resident blocks, per device
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             L::SMEM_BYTES)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, wg::THREADS, L::SMEM_BYTES)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    capacity[dev] = per_sm * sms;
  }
  const int ldw = TRANSPOSE ? a.K : a.N;
  const WgArgs g{a, (a.N + wg::BN - 1) / wg::BN, tma_ready(a.x, a.K),
                 tma_ready(a.w, ldw)};
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (g.tma_x && !encode(&xmap, a.x, a.B, a.K, NB))
    return (int)cudaErrorInvalidValue;
  if (g.tma_w && !encode(&wmap, a.w, TRANSPOSE ? a.N : a.K, ldw,
                         TRANSPOSE ? wg::BN : wg::KT))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(capacity[dev]);
  cfg.blockDim = dim3(wg::THREADS);
  cfg.dynamicSmemBytes = L::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, g);
}

// body 0: mma_sync, tile_rows 32 or 64 (the block tile's rows),
// k_per_slice a multiple of 16, scratch and tickets may be null when
// slices == 1; body 1: wgmma, tile_rows 32, 64 or 128 (the batch rounded
// up; B <= tile_rows), k_per_slice a multiple of 32, scratch and tickets
// always. The slices cover K.
// The Bernoulli epilogue takes both directions; the others the one they
// are instantiated for (TRANSPOSE_OF).
template <int EPI>
int launch(const float* x, const float* w, const float* b, float* probs,
           float* sample, float* scratch, int* tickets, int B, int K, int N,
           bool transpose_w, int body, int tile_rows, int slices,
           int k_per_slice, float inv_T, const unsigned long long* keys,
           int key_index, uint64_t seed, int row0, int col0, void* stream,
           const float* row_scale = nullptr) {
  if (B <= 0 || N <= 0) return 0;
  const int k_tile = body == 1 ? wg::KT : gemm::BK;
  const bool rows_ok =
      body == 1 ? (tile_rows == 32 || tile_rows == 64 || tile_rows == 128) &&
                      B <= tile_rows
                : body == 0 && (tile_rows == 32 || tile_rows == 64);
  if (!rows_ok || slices < 1 || slices > 65535 || k_per_slice < k_tile ||
      k_per_slice % k_tile != 0 ||
      (long long)slices * k_per_slice < (long long)K || row0 < 0 ||
      col0 < 0 || key_index < 0 ||
      ((slices > 1 || body == 1) &&
       (scratch == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((EPI == EPI_ROW_SCALED && row_scale == nullptr) ||
      (EPI != EPI_SIGMOID && transpose_w != (EPI != EPI_ROW_SCALED)))
    return (int)cudaErrorInvalidValue;
  const HalfStepArgs a{x, w, b, probs, sample, scratch, tickets, B, K, N,
                       slices, k_per_slice, inv_T, keys, key_index, seed,
                       (uint32_t)row0, (uint32_t)col0, row_scale};
  if constexpr (EPI == EPI_SIGMOID) {
    if (body == 1) {
      if (tile_rows == 128)
        return transpose_w ? launch_wgmma<true, 128, EPI>(a, stream)
                           : launch_wgmma<false, 128, EPI>(a, stream);
      if (tile_rows == 64)
        return transpose_w ? launch_wgmma<true, 64, EPI>(a, stream)
                           : launch_wgmma<false, 64, EPI>(a, stream);
      return transpose_w ? launch_wgmma<true, 32, EPI>(a, stream)
                         : launch_wgmma<false, 32, EPI>(a, stream);
    }
    if (tile_rows == 64)
      return transpose_w ? launch_tile<true, 4, EPI>(a, stream)
                         : launch_tile<false, 4, EPI>(a, stream);
    return transpose_w ? launch_tile<true, 2, EPI>(a, stream)
                       : launch_tile<false, 2, EPI>(a, stream);
  } else {
    constexpr bool T = EPI != EPI_ROW_SCALED;
    if (body == 1) {
      if (tile_rows == 128) return launch_wgmma<T, 128, EPI>(a, stream);
      if (tile_rows == 64) return launch_wgmma<T, 64, EPI>(a, stream);
      return launch_wgmma<T, 32, EPI>(a, stream);
    }
    if (tile_rows == 64) return launch_tile<T, 4, EPI>(a, stream);
    return launch_tile<T, 2, EPI>(a, stream);
  }
}

}  // namespace

extern "C" int half_step_sample(const float* x, const float* w,
                                const float* b, float* probs, float* sample,
                                float* scratch, int* tickets, int B, int K,
                                int N, int transpose_w, int body,
                                int tile_rows, int slices, int k_per_slice,
                                float inv_T, const unsigned long long* keys,
                                int key_index, unsigned long long seed,
                                int row0, int col0, void* stream) {
  return launch<EPI_SIGMOID>(x, w, b, probs, sample, scratch, tickets, B, K,
                             N, transpose_w != 0, body, tile_rows, slices,
                             k_per_slice, inv_T, keys, key_index, seed, row0,
                             col0, stream);
}

extern "C" int half_step_probs(const float* x, const float* w,
                               const float* b, float* probs, float* scratch,
                               int* tickets, int B, int K, int N, int body,
                               int tile_rows, int slices, int k_per_slice,
                               float inv_T, void* stream) {
  return launch<EPI_SIGMOID>(x, w, b, probs, nullptr, scratch, tickets, B, K,
                             N, false, body, tile_rows, slices, k_per_slice,
                             inv_T, nullptr, 0, 0, 0, 0, stream);
}

// seed is the TPU kernel's int32 seed; its 32 bits key Philox.
extern "C" int half_step_sample_resident(const float* x, const float* w,
                                         const float* b, float* probs,
                                         float* sample, float* scratch,
                                         int* tickets, int B, int K, int N,
                                         int body, int tile_rows, int slices,
                                         int k_per_slice, float inv_T,
                                         unsigned int seed, void* stream) {
  return launch<EPI_SIGMOID>(x, w, b, probs, sample, scratch, tickets, B, K,
                             N, false, body, tile_rows, slices, k_per_slice,
                             inv_T, nullptr, 0, (uint64_t)seed, 0, 0, stream);
}

// The logits (x . W^T + b) * inv_T of a replicated-softmax visible layer.
extern "C" int half_step_linear(const float* x, const float* w,
                                const float* b, float* out, float* scratch,
                                int* tickets, int B, int K, int N, int body,
                                int tile_rows, int slices, int k_per_slice,
                                float inv_T, void* stream) {
  return launch<EPI_LINEAR>(x, w, b, out, nullptr, scratch, tickets, B, K,
                            N, true, body, tile_rows, slices, k_per_slice,
                            inv_T, nullptr, 0, 0, 0, 0, stream);
}

// The mean (x . W^T + b) * inv_T of a Gaussian visible layer and, where
// sample is not null, the mean plus N(0, 1) noise keyed as
// half_step_sample's uniforms.
extern "C" int half_step_gauss(const float* x, const float* w,
                               const float* b, float* mean, float* sample,
                               float* scratch, int* tickets, int B, int K,
                               int N, int body, int tile_rows, int slices,
                               int k_per_slice, float inv_T,
                               const unsigned long long* keys, int key_index,
                               unsigned long long seed, int row0, int col0,
                               void* stream) {
  return launch<EPI_GAUSS>(x, w, b, mean, sample, scratch, tickets, B, K, N,
                           true, body, tile_rows, slices, k_per_slice, inv_T,
                           keys, key_index, seed, row0, col0, stream);
}

// sigmoid((x . W + row_scale[row] * b) * inv_T) and its Bernoulli sample,
// keyed as half_step_sample's.
extern "C" int half_step_scaled(const float* x, const float* w,
                                const float* b, const float* row_scale,
                                float* probs, float* sample, float* scratch,
                                int* tickets, int B, int K, int N, int body,
                                int tile_rows, int slices, int k_per_slice,
                                float inv_T, const unsigned long long* keys,
                                int key_index, unsigned long long seed,
                                int row0, int col0, void* stream) {
  return launch<EPI_ROW_SCALED>(x, w, b, probs, sample, scratch, tickets, B,
                                K, N, false, body, tile_rows, slices,
                                k_per_slice, inv_T, keys, key_index, seed,
                                row0, col0, stream, row_scale);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
