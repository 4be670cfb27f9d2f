// Clamped mean-field RBM chain for Hopper (sm_90a), fp32: all n_steps of
// one chain for the whole batch in one launch.
//
// Per step t, with schedule row (1/max(1e-6,T_t), sigma_t, eta_t):
//   h = sigmoid((v W + hb) / T_t [+ sigma_t N])
//   l = (h W^T + vb) / T_t [+ sigma_t N]
//   v = sigmoid(l), softmax of l over each group, mu-pull by eta_t on the
//       first Dz columns, then the known coordinates re-clamped.
// An optional final pass at T=1 without noise, mu-pull or re-clamp follows
// (conditional_gibbs's extra pass, rbm_ops.py:434).
//
// Replaces the TPU kernel _chain_call / _make_chain_kernel
// (multimodal_idbn_tpu/ops/pallas_chain.py:85-198). The port's wrapper is
// ops/chain.py; the noise draws are Philox of (row0 + row, col, step, half)
// as in ops/rng.py, so the plain version reproduces them whatever the
// tiling. row0 and plan_B place the batch in a larger one: a data-parallel
// rank that holds rows row0.. of a batch of plan_B draws the noise of
// those global rows and sums every product in the order of the whole
// batch's plan, so its rows are the single-device chain's rows.
//
// What bounds it on an H100: a chain is 60-101 products in strict
// sequence ([128,2500].[2500,1500] at the bimodal joint, 0.96 GFLOP each:
// 14 us at the fp32 CUDA-core peak, 6 us as three TF32 tensor passes;
// [128,532].[532,500] at the flagship joint, under 1 us each). Each is
// far too small for one block and none may start before the last has
// ended, so the time is the card's rate only if all 132 SMs take part in
// every product, plus the latency of handing the state from one product
// to the next. At the bimodal joint the products dominate; at the
// flagship joint the hand-overs do.
//
// Design: the TPU kernel kept W and W^T in VMEM and walked the steps on
// one core. Here one persistent grid, launched cooperatively so that all
// its blocks are resident together, runs the whole chain:
// - every half-step is a split-K GEMM over all blocks (the block tile of
//   gemm_tile.cuh, shared with half_step.cu: error-compensated TF32 on
//   the tensor cores, fp32 sums): output tiles x k-slices are dealt to
//   the blocks, each writes its partial tile to a scratch buffer;
// - after a grid barrier a finishing pass, spread over all threads of the
//   grid, sums the slices in fixed order and applies bias, temperature,
//   noise and sigmoid (hidden half), or those and the group softmax (one
//   warp per row and group, so a group may straddle any tile boundary),
//   the mu-pull and the re-clamp (visible half);
// - the state v, h and the group logits live in global scratch buffers
//   that stay in L2 (<= 1.3 MB each); W is read from L2 once per half-step
//   by the grid as a whole (per 128-row tile), and the visible half reads
//   the row-major W along the contraction (the tile's transposed mode),
//   so no W^T is made;
// - four grid barriers a step (a monotonic counter in global memory that
//   the wrapper zeroes; thread 0 of each block arrives and spins);
// - the tile and the grid follow the shape (make_plan): 128-row tiles and
//   three blocks per SM where W is large, 64-row tiles and one block per
//   SM where it is small and the barriers set the pace, 32-row tiles for
//   a batch of at most 32, so a remainder batch of 12 does 12 rows' work.
// - the noise seed is keys[key_index] when keys is not null (a key table
//   in device memory, which the host fills before each replay of a CUDA
//   graph of an epoch, ops/graphs.py), else the value `seed`;
// - the launch is cudaLaunchKernelEx with the cooperative attribute,
//   which a stream capture takes; the barrier counter is zeroed by the
//   wrapper before every launch, and so before every replay.
// Rows beyond B are neither read nor written. There is no limit on V or
// H. The result does not depend on the grid size or on the order in which
// blocks run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"
#include "philox.cuh"

namespace {

constexpr int MAX_GROUPS = 8;
constexpr int MAX_K_TILES_PER_SLICE = 64;  // 1024 terms

// Resident blocks per SM the kernel is compiled for, by tile.
template <int TM>
constexpr int max_blocks_per_sm() {
  return TM == 8 ? 3 : (TM == 4 ? 4 : 5);
}

struct ChainArgs {
  const float* w;        // [V, H]
  const float* hb;       // [H]
  const float* vb;       // [V]
  const float* v_init;   // [B, V]
  const float* v_known;  // [B, V]
  const float* km;       // [B, V]
  const float* mu;       // [B, Dz] or null
  const float* sched;    // [n_steps, 3]
  const int* groups;     // [n_groups, 2] or null
  float* out;            // [B, V]
  float* v;              // [B, Vs] chain state, Vs = V rounded up to 4
  float* h;              // [B, Hs] hidden probabilities, Hs likewise
  float* logits;         // [B, V] visible logits (group columns only)
  float* partial;        // [slices, B, Hs or Vs] partial products of a half
  unsigned* barrier;     // zero at launch
  int B, V, H, Vs, Hs, n_steps, n_groups, Dz, noisy, final_unclamped;
  int slices_h, k_per_slice_h, slices_v, k_per_slice_v;
  const unsigned long long* keys;  // key table, or null: `seed` is the key
  int key_index;
  uint64_t seed;
  uint32_t row0;         // global index of the batch's first row
};

struct Plan {
  int tile_rows, grid, slices_h, k_per_slice_h, slices_v, k_per_slice_v;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// All blocks of the (co-resident) grid meet here; what any block wrote
// before is visible to every block after. `target` is the count the
// barrier has to reach, kept by each block.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// partial[slice][row][col] = x[row, k-slice] . W: output tiles x slices
// dealt over the blocks of the grid.
template <bool TRANSPOSE, int TM>
__device__ __forceinline__ void product_phase(const ChainArgs& a,
                                              const float* x, int ldx, int N,
                                              int ldp, int K, int slices,
                                              int k_per_slice, float* smem) {
  using T = gemm::Tile<TM>;
  const int tiles_n = (N + gemm::BN - 1) / gemm::BN;
  const int tiles_m = (a.B + T::BM - 1) / T::BM;
  const int items = tiles_m * tiles_n * slices;
  const gemm::Operand xa{x, ldx, true};
  const gemm::Operand wa{a.w, a.H, gemm::rows_aligned16(a.w, a.H)};
  const size_t plane = (size_t)a.B * ldp;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int slice = item % slices, tile = item / slices;
    const int m0 = (tile / tiles_n) * T::BM, n0 = (tile % tiles_n) * gemm::BN;
    const int k_begin = slice * k_per_slice;
    const int k_end = min(K, k_begin + k_per_slice);
    float acc[TM][gemm::TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < gemm::TN; ++j) acc[i][j] = 0.0f;
    gemm::block_tile<TRANSPOSE, TM>(xa, wa, a.B, N, m0, n0, k_begin, k_end,
                                    smem, acc);
    gemm::store_partial<TM>(acc, a.partial + slice * plane, ldp, a.B, m0,
                            n0);
  }
}

// Sums of the slices' partial products in the order 0, 1, 2, ...: one
// element, and four neighbouring ones (p 16-byte aligned).
__device__ __forceinline__ float sum_slices(const float* p, size_t plane,
                                            int slices) {
  float s = 0.0f;
#pragma unroll 4
  for (int q = 0; q < slices; ++q) s += __ldcg(p + q * plane);
  return s;
}

__device__ __forceinline__ float4 sum_slices4(const float* p, size_t plane,
                                              int slices) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int q = 0; q < slices; ++q) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p + q * plane));
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  return s;
}

template <int TM>
__global__ void __launch_bounds__(gemm::THREADS, max_blocks_per_sm<TM>())
chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sg[2 * MAX_GROUPS];

  const int tid = threadIdx.x;
  const int V = a.V, H = a.H, B = a.B;
  const int gtid = blockIdx.x * gemm::THREADS + tid;
  const int gthreads = gridDim.x * gemm::THREADS;
  const int lane = tid & 31;
  const int gwarp = gtid >> 5, gwarps = gthreads >> 5;
  const bool pull = a.mu != nullptr;
  const uint64_t seed =
      a.keys != nullptr ? __ldg(a.keys + a.key_index) : a.seed;
  unsigned barrier_target = 0;

  if (tid < 2 * a.n_groups) sg[tid] = a.groups[tid];
  for (int idx = gtid; idx < B * V; idx += gthreads) {
    const int r = idx / V, i = idx - r * V;
    a.v[(size_t)r * a.Vs + i] = a.v_init[idx];
  }
  grid_barrier(a.barrier, barrier_target);

  auto in_group = [&](int i) {
    for (int g = 0; g < a.n_groups; ++g)
      if (i >= sg[2 * g] && i < sg[2 * g + 1]) return true;
    return false;
  };
  // mu-pull and re-clamp of one visible probability
  auto finish = [&](float p, int row, int i, float eta, bool clamp) {
    if (clamp && pull && i < a.Dz)
      p = (1.0f - eta) * p + eta * a.mu[(size_t)row * a.Dz + i];
    if (clamp) {
      const size_t o = (size_t)row * V + i;
      const float k = a.km[o];
      p = p * (1.0f - k) + a.v_known[o] * k;
    }
    return p;
  };

  // One step: t indexes the noise; clamp = false is the final pass.
  auto step = [&](float inv_T, float sig, float eta, bool noisy, bool clamp,
                  int t) {
    // h = sigmoid((v W + hb) * inv_T [+ sig N])
    product_phase<false, TM>(a, a.v, a.Vs, H, a.Hs, V, a.slices_h,
                             a.k_per_slice_h, smem);
    grid_barrier(a.barrier, barrier_target);
    for (int idx = gtid; idx < B * (a.Hs / 4); idx += gthreads) {
      const int r = idx / (a.Hs / 4), j0 = (idx - r * (a.Hs / 4)) * 4;
      const float4 s4 = sum_slices4(a.partial + (size_t)r * a.Hs + j0,
                                    (size_t)B * a.Hs, a.slices_h);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (j >= H) break;
        float logit = (s[e] + __ldg(a.hb + j)) * inv_T;
        if (noisy)
          logit += philox_normal(seed, a.row0 + (uint32_t)r, (uint32_t)j,
                                 (uint32_t)t, 0u) * sig;
        a.h[(size_t)r * a.Hs + j] = sigmoidf_exact(logit);
      }
    }
    grid_barrier(a.barrier, barrier_target);
    // l = (h W^T + vb) * inv_T [+ sig N]
    product_phase<true, TM>(a, a.h, a.Hs, V, a.Vs, H, a.slices_v,
                            a.k_per_slice_v, smem);
    grid_barrier(a.barrier, barrier_target);
    auto logit_of = [&](float sum, int r, int i) {
      float logit = (sum + __ldg(a.vb + i)) * inv_T;
      if (noisy)
        logit += philox_normal(seed, a.row0 + (uint32_t)r, (uint32_t)i,
                               (uint32_t)t, 1u) * sig;
      return logit;
    };
    // v = sigmoid of l outside the groups ...
    for (int idx = gtid; idx < B * (a.Vs / 4); idx += gthreads) {
      const int r = idx / (a.Vs / 4), i0 = (idx - r * (a.Vs / 4)) * 4;
      const float4 s4 = sum_slices4(a.partial + (size_t)r * a.Vs + i0,
                                    (size_t)B * a.Vs, a.slices_v);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + e;
        if (i >= V) break;
        if (in_group(i)) continue;
        a.v[(size_t)r * a.Vs + i] =
            finish(sigmoidf_exact(logit_of(s[e], r, i)), r, i, eta, clamp);
      }
    }
    // ... and softmax of l inside each: one warp per (group, row)
    for (int pair = gwarp; pair < a.n_groups * B; pair += gwarps) {
      const int g = pair / B, r = pair - g * B;
      const int s = sg[2 * g], e = sg[2 * g + 1];
      float* l = a.logits + (size_t)r * V;
      float m = -INFINITY;
      for (int i = s + lane; i < e; i += 32) {
        l[i] = logit_of(sum_slices(a.partial + (size_t)r * a.Vs + i,
                                   (size_t)B * a.Vs, a.slices_v), r, i);
        m = fmaxf(m, l[i]);
      }
      m = warp_max(m);
      float sum = 0.0f;
      for (int i = s + lane; i < e; i += 32) sum += expf(l[i] - m);
      sum = warp_sum(sum);
      for (int i = s + lane; i < e; i += 32)
        a.v[(size_t)r * a.Vs + i] =
            finish(expf(l[i] - m) / sum, r, i, eta, clamp);
    }
    grid_barrier(a.barrier, barrier_target);
  };

  for (int t = 0; t < a.n_steps; ++t)
    step(a.sched[3 * t], a.sched[3 * t + 1], a.sched[3 * t + 2],
         a.noisy != 0, true, t);
  if (a.final_unclamped) step(1.0f, 0.0f, 0.0f, false, false, 0);

  for (int idx = gtid; idx < B * V; idx += gthreads) {
    const int r = idx / V, i = idx - r * V;
    a.out[idx] = __ldcg(a.v + (size_t)r * a.Vs + i);
  }
}

void phase_slices(int B, int N, int K, int tile_rows, int grid, int* slices,
                  int* k_per_slice) {
  const int tiles =
      ((B + tile_rows - 1) / tile_rows) * ((N + gemm::BN - 1) / gemm::BN);
  const int k_tiles = K > 0 ? (K + gemm::BK - 1) / gemm::BK : 1;
  int s = grid / tiles;  // one wave of work items
  if (s > k_tiles / 4) s = k_tiles / 4;
  if (s < 1) s = 1;
  int per = (k_tiles + s - 1) / s;
  // the tensor cores truncate when they add to a sum: keep a slice short
  if (per > MAX_K_TILES_PER_SLICE) per = MAX_K_TILES_PER_SLICE;
  *slices = (k_tiles + per - 1) / per;
  *k_per_slice = per * gemm::BK;
}

template <int TM>
cudaError_t resident_grid(int* grid) {
  using T = gemm::Tile<TM>;
  auto kernel = chain_kernel<TM>;
  cudaError_t err = cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  static int cached[64] = {0};  // by device; 0 = not asked yet
  if (dev < 64 && cached[dev] > 0) {
    *grid = cached[dev];
    return cudaSuccess;
  }
  if (T::SMEM_BYTES > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, gemm::THREADS, T::SMEM_BYTES)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > max_blocks_per_sm<TM>()) per_sm = max_blocks_per_sm<TM>();
  *grid = per_sm * sms;
  if (dev < 64) cached[dev] = *grid;
  return cudaSuccess;
}

// The tiling of one chain: a pure function of the shape and the card.
// plan_B is the batch the tile and the k-slices are chosen for (the whole
// batch of which B rows are launched; B when 0). tile_rows (32, 64, 128)
// and max_grid > 0 override the choice of the tile and cap the number of
// blocks (for measurements).
cudaError_t make_plan(int B, int V, int H, int tile_rows, int max_grid,
                      Plan* p) {
  // A large W (the bimodal joint) is bound by the products: 128-row tiles
  // and three blocks per SM. A small one (the flagship joint) is bound by
  // the barriers: 64-row tiles and one block per SM.
  const bool large = (long long)V * H >= (1LL << 20);
  if (tile_rows == 0) tile_rows = B <= 32 ? 32 : (large ? 128 : 64);
  cudaError_t err;
  if (tile_rows == 128)
    err = resident_grid<8>(&p->grid);
  else if (tile_rows == 64)
    err = resident_grid<4>(&p->grid);
  else if (tile_rows == 32)
    err = resident_grid<2>(&p->grid);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  if (max_grid == 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    max_grid = (large ? 3 : 1) * sms;
  }
  if (p->grid > max_grid) p->grid = max_grid;
  p->tile_rows = tile_rows;
  phase_slices(B, H, V, tile_rows, p->grid, &p->slices_h,
               &p->k_per_slice_h);
  phase_slices(B, V, H, tile_rows, p->grid, &p->slices_v,
               &p->k_per_slice_v);
  return cudaSuccess;
}

template <int TM>
cudaError_t launch(const ChainArgs& a, int grid, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(gemm::THREADS);
  cfg.dynamicSmemBytes = gemm::Tile<TM>::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chain_kernel<TM>, a);
}

}  // namespace

// out6 = (tile_rows, grid, slices_h, slices_v, floats of `partial`,
// grid barriers of a chain of n_steps [+ the final pass]).
// plan_B: the batch the plan is made for (B when 0); the scratch sizes are
// those of the B rows launched.
extern "C" int chain_plan(int B, int V, int H, int n_steps,
                          int final_unclamped, int tile_rows,
                          int max_grid, int plan_B, long long* out6) {
  Plan p;
  if (plan_B < B && plan_B != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      make_plan(plan_B > 0 ? plan_B : B, V, H, tile_rows, max_grid, &p);
  if (err != cudaSuccess) return (int)err;
  const long long ph = (long long)p.slices_h * B * ((H + 3) / 4 * 4);
  const long long pv = (long long)p.slices_v * B * ((V + 3) / 4 * 4);
  out6[0] = p.tile_rows;
  out6[1] = p.grid;
  out6[2] = p.slices_h;
  out6[3] = p.slices_v;
  out6[4] = ph > pv ? ph : pv;
  const int passes = (n_steps > 0 ? n_steps : 0) + (final_unclamped ? 1 : 0);
  out6[5] = 1 + 4LL * passes;
  return 0;
}

// v, h, logits, partial: scratch of [B, ceil4(V)], [B, ceil4(H)], [B, V]
// and chain_plan's out6[4] floats; barrier: one zeroed 32-bit counter.
extern "C" int chain_run(const float* w, const float* hb, const float* vb,
                         const float* v_init, const float* v_known,
                         const float* km, const float* mu, const float* sched,
                         const int* groups, float* out, float* v, float* h,
                         float* logits, float* partial, unsigned* barrier,
                         int B, int V, int H, int n_steps, int n_groups,
                         int Dz, int noisy, const unsigned long long* keys,
                         int key_index, unsigned long long seed,
                         int final_unclamped, int tile_rows,
                         int max_grid, int row0, int plan_B, void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (n_groups < 0 || n_groups > MAX_GROUPS || H <= 0 || row0 < 0 ||
      key_index < 0 ||
      (plan_B < B && plan_B != 0))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err =
      make_plan(plan_B > 0 ? plan_B : B, V, H, tile_rows, max_grid, &p);
  if (err != cudaSuccess) return (int)err;
  ChainArgs a{w, hb, vb, v_init, v_known, km, mu, sched, groups, out, v, h,
              logits, partial, barrier, B, V, H, (V + 3) / 4 * 4,
              (H + 3) / 4 * 4, n_steps > 0 ? n_steps : 0, n_groups, Dz, noisy,
              final_unclamped, p.slices_h, p.k_per_slice_h, p.slices_v,
              p.k_per_slice_v, keys, key_index, seed, (uint32_t)row0};
  err = p.tile_rows == 128  ? launch<8>(a, p.grid, stream)
        : p.tile_rows == 64 ? launch<4>(a, p.grid, stream)
                            : launch<2>(a, p.grid, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
