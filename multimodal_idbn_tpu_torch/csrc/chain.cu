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
// Two bodies, chosen by the wrapper from (V, H, groups) alone
// (ops/chain.py:body), so that a data-parallel rank and the whole batch
// always take the same one:
//
// The cluster body (chain_kernel_cluster), where W's slices and the state
// fit the shared memory of a cluster of 16 blocks (the flagship joint).
// The rows of a chain are independent chains, so the batch's rows are
// dealt to thread-block clusters (as many as the card holds at once, at
// most 24 rows each) and each cluster runs its rows' whole chain alone,
// with no grid-wide meeting:
// - block b of a cluster holds W[:, b*hw .. (b+1)*hw) in shared memory
//   for the whole launch (W is read from L2 or HBM once), the cluster's
//   rows of v in full, and its own slices of h and of v's columns
//   (bounds from the wrapper: every softmax group lies inside one slice);
// - hidden half: W[:, slice]^T . v^T over the whole contraction inside
//   the block (eight warps each take a fixed eighth of k, their sums
//   added in that order), then bias, temperature, noise and sigmoid;
// - visible half: W[:, slice] . h[:, slice]^T gives the block's share of
//   every visible logit; the shares go to the cluster's exchange area at
//   L2 and, after a cluster barrier, each slice's owner copies its 16
//   shares in and adds them in block order, then applies bias,
//   temperature, noise, sigmoid or the group softmax, mu-pull and
//   re-clamp, and writes its columns of v to the exchange area; after a
//   second cluster barrier every block copies the cluster's rows of v in;
// - the hand-overs go through L2 and not through distributed shared
//   memory: an all-to-all among 16 blocks moves about 8 bytes a cycle an
//   SM over DSMEM, by stores or bulk copies alike (H100, measured), and a
//   step moves about 80 KB a block, while L2 serves the same bytes about
//   twice as fast;
// - the products put W's rows or columns on the tensor cores' m side and
//   the batch rows on the n side, 8 rows a tile, so few rows pad little;
//   the noise of the next half-step is drawn while a barrier waits;
// - so two cluster barriers a step (barrier.cluster arrive.release /
//   wait.acquire, which order the exchange areas' stores and loads) and
//   no barrier counter; no cluster waits for another, so clusters may run
//   in waves and the launch is not cooperative;
// - each output's sum order is fixed by (V, H, groups): it does not
//   depend on B, row0, plan_B or the rows a cluster takes.
//
// The grid body (chain_kernel), for every other shape (the bimodal
// joint, whose W of 15 MB fits no cluster). The TPU kernel kept W and W^T
// in VMEM and walked the steps on one core. Here one persistent grid,
// launched cooperatively so that all its blocks are resident together,
// runs the whole chain:
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
// - the launch is cudaLaunchKernelEx with the cooperative attribute,
//   which a stream capture takes; the barrier counter is zeroed by the
//   wrapper before every launch, and so before every replay.
// Both bodies: the products are error-compensated TF32 on the tensor
// cores with fp32 sums; the noise seed is keys[key_index] when keys is
// not null (a key table in device memory, which the host fills before
// each replay of a CUDA graph of an epoch, ops/graphs.py), else the value
// `seed`. Rows beyond B are neither read nor written. The grid body has
// no limit on V or H, and its result does not depend on the grid size or
// on the order in which blocks run.
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
  // cluster body only
  const int* bounds;     // [17] visible columns of each block of a cluster
  int hw, vw, cl_rows;   // hidden columns a block, widest visible slice,
                         // rows a cluster
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

// ---------------------------------------------------------------------------
// The cluster body
// ---------------------------------------------------------------------------

namespace cluster {

constexpr int BLOCKS = 16;  // blocks of a cluster (the non-portable size)
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int KW = 8;       // warps that split the hidden contraction
constexpr int MAX_NT = 3;   // row tiles of 8: at most 24 rows a cluster
constexpr int MAX_QUADS = 1024;  // V / 4 at most

// Shared memory of a block, in floats, for NT row tiles of 8. The
// products put W on the tensor cores' m side and the rows on the n side
// (an n-tile is 8 rows), so a cluster of few rows does little padding.
// W[:, slice] is kept row by row, its column j at j ^ 8 (row % 4) (the
// hidden half reads it down the columns without bank conflicts); v and
// h have row strides of 4 mod 8.
struct Layout {
  int rows, vp, ldv, ldh;
  int v, h, hs, slot, vk, km, mu, nh, nv, hb, vb, floats;
};

__host__ __device__ inline Layout layout(int nt, int V, int hw, int vw) {
  Layout L;
  L.rows = 8 * nt;
  L.vp = (V + 7) / 8 * 8;                 // the hidden half's contraction
  L.ldv = L.vp + 4;
  L.ldh = hw + 4;
  int o = (L.vp + 16) * hw;               // W[:, slice], zero beyond V
  L.v = o;    o += L.rows * L.ldv;        // the cluster's rows of v
  L.h = o;    o += 2 * L.rows * L.ldh;    // my columns of h, as TF32 hi, lo
  L.hs = o;   o += KW * hw * L.rows;      // the k-parts of the hidden half
  L.slot = o; o += BLOCKS * vw * L.rows;  // every block's share of my logits
  L.vk = o;   o += L.rows * vw;           // my columns' clamp data and mu
  L.km = o;   o += L.rows * vw;
  L.mu = o;   o += L.rows * vw;
  L.nh = o;   o += L.rows * hw;           // the noise of the next half-steps
  L.nv = o;   o += L.rows * vw;
  L.hb = o;   o += hw;
  L.vb = o;   o += vw;
  L.floats = o;
  return L;
}

__device__ __forceinline__ unsigned rank_in_cluster() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, and later waits
// for all; what any of them stored before arriving (the exchange areas
// at L2 included) is visible to all after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// gemm::split_tf32 for a finite x (cvt.rna.tf32 is emulated in a few
// more instructions that guard infinities): the same hi and lo bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float rest = x - __uint_as_float(hi);
  lo = (__float_as_uint(rest) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float w_at(const float* w, int hw, int row,
                                      int col) {
  return w[row * hw + (col ^ ((row & 3) << 3))];
}

// c += a . b three times (the small terms into `small`, hi.hi into `big`)
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  gemm::mma_tf32(small[0], small[1], small[2], small[3], alo, bhi);
  gemm::mma_tf32(small[0], small[1], small[2], small[3], ahi, blo);
  gemm::mma_tf32(big[0], big[1], big[2], big[3], ahi, bhi);
}

// hs[kw][j][r] = sum over k-part kw of W[k, j] v[r, k]: warp (kw, mw)
// takes the 16-column tiles mw, mw + 2, ... over its eighth of k.
template <int NT>
__device__ __forceinline__ void hidden_products(const Layout& L, int hw,
                                                const float* w,
                                                const float* v, float* hs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = warp % KW, mw = warp / KW;
  const int k8s = L.vp / 8;
  const int kb = kw * k8s / KW, ke = (kw + 1) * k8s / KW;
  for (int m0 = 16 * mw; m0 < hw; m0 += 16 * (WARPS / KW)) {
    float big[NT][4], small[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.0f;
#pragma unroll 2
    for (int k8 = kb; k8 < ke; ++k8) {
      const int r0 = 8 * k8 + t4, r1 = r0 + 4;
      uint32_t ahi[4], alo[4];
      split(w_at(w, hw, r0, m0 + g), ahi[0], alo[0]);
      split(w_at(w, hw, r0, m0 + g + 8), ahi[1], alo[1]);
      split(w_at(w, hw, r1, m0 + g), ahi[2], alo[2]);
      split(w_at(w, hw, r1, m0 + g + 8), ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* pb = v + (8 * n + g) * L.ldv + r0;
        uint32_t bhi[2], blo[2];
        split(pb[0], bhi[0], blo[0]);
        split(pb[4], bhi[1], blo[1]);
        mma3(big[n], small[n], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* o = hs + (kw * hw + m0 + g) * L.rows + 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(o) =
          make_float2(big[n][0] + small[n][0], big[n][1] + small[n][1]);
      *reinterpret_cast<float2*>(o + 8 * L.rows) =
          make_float2(big[n][2] + small[n][2], big[n][3] + small[n][3]);
    }
  }
}

// The block's share of the visible logits, W[i, my columns] . h[r, my
// columns] for every visible column i: 16-row tiles of W dealt to the
// warps (the tiles listed in `tiles`, or all when it is null), each row
// stored as [i][r] into the exchange area of i's owner (xl[owner] at
// column block `me`, at L2).
template <int NT>
__device__ __forceinline__ void visible_products(const Layout& L, int V,
                                                 int hw, int vw, int rows,
                                                 const int* sb, unsigned me,
                                                 const short* tiles,
                                                 int n_tiles, const float* w,
                                                 const uint32_t* h,
                                                 float* xl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t chunk = (size_t)vw * L.rows;
  for (int k = warp; k < n_tiles; k += WARPS) {
    const int m0 = 16 * (tiles != nullptr ? tiles[k] : k);
    float big[NT][4], small[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < hw; k0 += 8) {
      const int ra = m0 + g, rb = ra + 8, c0 = k0 + t4, c1 = c0 + 4;
      uint32_t ahi[4], alo[4];
      split(w_at(w, hw, ra, c0), ahi[0], alo[0]);
      split(w_at(w, hw, rb, c0), ahi[1], alo[1]);
      split(w_at(w, hw, ra, c1), ahi[2], alo[2]);
      split(w_at(w, hw, rb, c1), ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t* pb = h + (8 * n + g) * L.ldh + c0;
        const uint32_t* pl = pb + L.rows * L.ldh;
        const uint32_t bhi[2] = {pb[0], pb[4]}, blo[2] = {pl[0], pl[4]};
        mma3(big[n], small[n], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = m0 + g + 8 * half;
      if (i >= V) continue;
      int c = 0;
      while (sb[c + 1] <= i) ++c;  // the owner of column i
      float* d = xl + (c * BLOCKS + me) * chunk + (i - sb[c]) * L.rows;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = 8 * n + 2 * t4;
        if (r < rows)
          __stcg(reinterpret_cast<float2*>(d + r),
                 make_float2(big[n][2 * half] + small[n][2 * half],
                             big[n][2 * half + 1] + small[n][2 * half + 1]));
      }
    }
  }
}

}  // namespace cluster

// One cluster runs the whole chain of its rows (header). Launched with
// cluster dimension cluster::BLOCKS, cluster::THREADS threads a block and
// layout(NT, V, hw, vw).floats * 4 bytes of dynamic shared memory; a
// cluster takes at most 8 NT rows.
template <int NT>
__global__ void __launch_bounds__(cluster::THREADS, 1)
chain_kernel_cluster(ChainArgs a) {
  using namespace cluster;
  extern __shared__ __align__(16) float smem[];
  __shared__ int sg[2 * MAX_GROUPS];
  __shared__ int sb[BLOCKS + 1];
  __shared__ unsigned qlive[MAX_QUADS / 32];
  __shared__ short live_tiles[MAX_QUADS / 4];
  __shared__ int n_live_tiles;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned me = rank_in_cluster();
  const int row_base = (int)cluster_index() * a.cl_rows;
  const int rows = min(a.cl_rows, a.B - row_base);
  const int V = a.V, H = a.H, hw = a.hw, vw = a.vw;
  const Layout L = layout(NT, V, hw, vw);
  constexpr int RC = 8 * NT;  // rows of the tiles
  float* w = smem;
  float* v = smem + L.v;
  uint32_t* h = reinterpret_cast<uint32_t*>(smem + L.h);
  float* hs = smem + L.hs;
  float* slot = smem + L.slot;
  float* vk = smem + L.vk;
  float* km = smem + L.km;
  float* mu = smem + L.mu;
  float* nh = smem + L.nh;
  float* nv = smem + L.nv;
  float* hb = smem + L.hb;
  float* vb = smem + L.vb;
  // the cluster's exchange areas at L2: every block's shares of every
  // slice's logits, [owner][block][i][r], then the rows of v, [r][Vs]
  const int clusters = gridDim.x / BLOCKS;
  const size_t chunk = (size_t)vw * RC;
  float* xl = a.partial + cluster_index() * (BLOCKS * BLOCKS * chunk);
  float* xv = a.partial + clusters * (BLOCKS * BLOCKS * chunk) +
              cluster_index() * ((size_t)RC * a.Vs);
  const bool pull = a.mu != nullptr;
  const uint64_t seed =
      a.keys != nullptr ? __ldg(a.keys + a.key_index) : a.seed;
  const uint32_t grow0 = a.row0 + (uint32_t)row_base;  // noise row of r = 0

  if (tid < 2 * a.n_groups) sg[tid] = a.groups[tid];
  if (tid <= BLOCKS) sb[tid] = a.bounds[tid];
  __syncthreads();
  const int h0 = (int)me * hw, hn = max(0, min(hw, H - h0));
  const int s = sb[me], wd = sb[me + 1] - s;

  // W[:, h0 .. h0 + hw), zero beyond V and H
  for (int idx = tid; idx < (L.vp + 16) * hw; idx += THREADS) {
    const int k = idx / hw, j = idx - k * hw;
    w[k * hw + (j ^ ((k & 3) << 3))] =
        k < V && j < hn ? __ldg(a.w + (size_t)k * H + h0 + j) : 0.0f;
  }
  // the cluster's rows of v_init, zero beyond them; h zero
  for (int idx = tid; idx < RC * L.vp; idx += THREADS) {
    const int r = idx / L.vp, i = idx - r * L.vp;
    v[r * L.ldv + i] =
        r < rows && i < V ? a.v_init[(size_t)(row_base + r) * V + i] : 0.0f;
  }
  for (int idx = tid; idx < 2 * RC * L.ldh; idx += THREADS) h[idx] = 0u;
  for (int idx = tid; idx < rows * wd; idx += THREADS) {
    const int r = idx / wd, i = idx - r * wd;
    const size_t o = (size_t)(row_base + r) * V + s + i;
    vk[r * vw + i] = a.v_known[o];
    km[r * vw + i] = a.km[o];
    mu[r * vw + i] = pull && s + i < a.Dz
                         ? a.mu[(size_t)(row_base + r) * a.Dz + s + i]
                         : 0.0f;
  }
  for (int j = tid; j < hw; j += THREADS) hb[j] = j < hn ? a.hb[h0 + j] : 0.0f;
  for (int i = tid; i < wd; i += THREADS) vb[i] = a.vb[s + i];
  // the slices with a coordinate left free in the cluster's rows: from
  // the second clamped step on, the others' v is their clamp values
  // (p (1 - 1) + v_known, exactly), so nobody computes or moves them
  unsigned live = 0;
  for (int c = 0; c < BLOCKS; ++c) {
    const int cs = sb[c], cw = sb[c + 1] - cs;
    bool free_here = false;
    for (int idx = tid; idx < rows * cw; idx += THREADS) {
      const int r = idx / cw, i = cs + idx - r * cw;
      free_here |= a.km[(size_t)(row_base + r) * V + i] != 1.0f;
    }
    if (__syncthreads_or(free_here)) live |= 1u << c;
  }
  for (int q = tid; q < MAX_QUADS / 32; q += THREADS) qlive[q] = 0;
  if (tid == 0) n_live_tiles = 0;
  __syncthreads();
  for (int c = 0; c < BLOCKS; ++c)
    if ((live >> c) & 1)
      for (int q = sb[c] / 4 + tid; q < (sb[c + 1] + 3) / 4; q += THREADS)
        atomicOr(&qlive[q / 32], 1u << (q % 32));
  const int n_tiles = (V + 15) / 16;  // 16-row tiles of the visible half
  for (int u = tid; u < n_tiles; u += THREADS) {
    bool meets = false;  // the tile has a row of a free slice
    for (int c = 0; c < BLOCKS; ++c)
      meets |= (live >> c) & 1 && sb[c] < 16 * u + 16 && sb[c + 1] > 16 * u;
    if (meets) live_tiles[atomicAdd(&n_live_tiles, 1)] = (short)u;
  }

  const bool noisy = a.noisy != 0;
  // the noise of step t's hidden and visible half, drawn ahead
  auto hidden_noise = [&](int t) {
    for (int idx = tid; idx < rows * hw; idx += THREADS) {
      const int r = idx / hw, j = idx - r * hw;
      if (j < hn)
        nh[r * hw + j] = philox_normal(seed, grow0 + (uint32_t)r,
                                       (uint32_t)(h0 + j), (uint32_t)t, 0u);
    }
  };
  auto visible_noise = [&](int t) {
    for (int idx = tid; idx < rows * wd; idx += THREADS) {
      const int r = idx / wd, i = idx - r * wd;
      nv[r * vw + i] = philox_normal(seed, grow0 + (uint32_t)r,
                                     (uint32_t)(s + i), (uint32_t)t, 1u);
    }
  };
  if (noisy && a.n_steps > 0) hidden_noise(0);
  __syncthreads();

  auto in_group = [&](int i) {
    for (int q = 0; q < a.n_groups; ++q)
      if (i >= sg[2 * q] && i < sg[2 * q + 1]) return true;
    return false;
  };
  auto finish = [&](float p, int r, int i, float eta, bool clamp) {
    if (clamp && pull && s + i < a.Dz)
      p = (1.0f - eta) * p + eta * mu[r * vw + i];
    if (clamp) {
      const float k = km[r * vw + i];
      p = p * (1.0f - k) + vk[r * vw + i] * k;
    }
    return p;
  };

  const int passes = a.n_steps + (a.final_unclamped ? 1 : 0);
  for (int pass = 0; pass < passes; ++pass) {
    const bool clamp = pass < a.n_steps;
    const int t = clamp ? pass : 0;
    const float inv_T = clamp ? __ldg(a.sched + 3 * t) : 1.0f;
    const float sig = clamp ? __ldg(a.sched + 3 * t + 1) : 0.0f;
    const float eta = clamp ? __ldg(a.sched + 3 * t + 2) : 0.0f;
    const bool noise = clamp && noisy;

    // h = sigmoid((v W + hb) * inv_T [+ sig N]) on my hidden columns: the
    // k-parts in order
    hidden_products<NT>(L, hw, w, v, hs);
    __syncthreads();
    for (int idx = tid; idx < hn * RC; idx += THREADS) {
      const int j = idx / RC, r = idx - j * RC;
      if (r >= rows) continue;
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < KW; ++q) sum += hs[(q * hw + j) * RC + r];
      float logit = (sum + hb[j]) * inv_T;
      if (noise) logit += nh[r * hw + j] * sig;
      split(sigmoidf_exact(logit), h[r * L.ldh + j],
            h[(RC + r) * L.ldh + j]);
    }
    __syncthreads();

    // my share of every visible logit, to its owner; from the second
    // clamped step on, only of the slices with a free coordinate
    const bool free_only = clamp && pass > 0;
    const bool mine = !free_only || ((live >> me) & 1);
    visible_products<NT>(L, V, hw, vw, rows, sb, me,
                         free_only ? live_tiles : nullptr,
                         free_only ? n_live_tiles : n_tiles, w, h, xl);
    cluster_arrive();
    if (noise && mine) visible_noise(t);
    cluster_wait();
    if (mine) {  // every block's share of my columns
      const float* src = xl + me * (BLOCKS * chunk);
      for (int c = tid; c < BLOCKS * (int)chunk / 4; c += THREADS)
        gemm::cp_async16(slot + 4 * c, src + 4 * c, 16);
      gemm::cp_async_commit();
      gemm::cp_async_wait<0>();
    }
    __syncthreads();

    // l = (h W^T + vb) * inv_T [+ sig N] on my visible columns: the
    // shares in block order; sigmoid outside the groups, the logits kept
    // in v inside them ...
    for (int idx = tid; idx < (mine ? wd : 0) * RC; idx += THREADS) {
      const int i = idx / RC, r = idx - i * RC;
      if (r >= rows) continue;
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < BLOCKS; ++q) sum += slot[(q * vw + i) * RC + r];
      float logit = (sum + vb[i]) * inv_T;
      if (noise) logit += nv[r * vw + i] * sig;
      v[r * L.ldv + s + i] =
          in_group(s + i) ? logit
                          : finish(sigmoidf_exact(logit), r, i, eta, clamp);
    }
    __syncthreads();
    // ... and their softmax: one warp per (group, row)
    for (int pair = warp; pair < a.n_groups * rows; pair += WARPS) {
      const int q = pair / rows, r = pair - q * rows;
      const int gs = sg[2 * q], ge = sg[2 * q + 1];
      if (gs < s || gs >= s + wd || !mine) continue;  // not mine to do
      float* l = v + r * L.ldv;
      float m = -INFINITY;
      for (int i = gs + lane; i < ge; i += 32) m = fmaxf(m, l[i]);
      m = warp_max(m);
      float sum = 0.0f;
      for (int i = gs + lane; i < ge; i += 32) sum += expf(l[i] - m);
      sum = warp_sum(sum);
      for (int i = gs + lane; i < ge; i += 32)
        l[i] = finish(expf(l[i] - m) / sum, r, i - s, eta, clamp);
    }
    if (pass + 1 == passes) break;  // nobody reads the last pass's v
    __syncthreads();

    // my columns of v to the cluster, then every block's columns of them
    // (from the second clamped step on, the free slices')
    for (int idx = tid; idx < (mine ? rows * wd : 0); idx += THREADS) {
      const int r = idx / wd, i = idx - r * wd;
      __stcg(xv + r * a.Vs + s + i, v[r * L.ldv + s + i]);
    }
    cluster_arrive();
    if (noise && t + 1 < a.n_steps) hidden_noise(t + 1);
    cluster_wait();
    for (int c = tid; c < rows * (a.Vs / 4); c += THREADS) {
      const int r = c / (a.Vs / 4), q = c - r * (a.Vs / 4), i = 4 * q;
      if (!free_only || (qlive[q / 32] >> (q % 32)) & 1)
        gemm::cp_async16(v + r * L.ldv + i, xv + r * a.Vs + i,
                         4 * min(4, V - i));
    }
    gemm::cp_async_commit();
    gemm::cp_async_wait<0>();
    __syncthreads();
  }
  __syncthreads();

  for (int idx = tid; idx < rows * wd; idx += THREADS) {
    const int r = idx / wd, i = idx - r * wd;
    a.out[(size_t)(row_base + r) * V + s + i] = v[r * L.ldv + s + i];
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

// The clusters of the cluster body that the card holds at once, for NT
// row tiles and `smem` bytes a block (asked once per device, tiles and
// size). The kernel's shared-memory ceiling is raised to `smem` first, and
// never lowered.
template <int NT>
cudaError_t cluster_occupancy(int smem, int* active) {
  struct Seen {
    int dev, smem, active;
  };
  static Seen seen[16];
  static int n_seen = 0, raised[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].smem == smem) {
      *active = seen[i].active;
      return cudaSuccess;
    }
  auto kernel = chain_kernel_cluster<NT>;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (raised[dev] < smem) {  // a launch of any size seen so far still fits
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess)
      return err;
    raised[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster::BLOCKS);
  cfg.blockDim = dim3(cluster::THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster::BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaOccupancyMaxActiveClusters(active, (void*)kernel, &cfg)) !=
      cudaSuccess)
    return err;
  if (n_seen < 16) seen[n_seen++] = Seen{dev, smem, *active};
  return cudaSuccess;
}

cudaError_t cluster_occupancy(int nt, int smem, int* active) {
  return nt == 1   ? cluster_occupancy<1>(smem, active)
         : nt == 2 ? cluster_occupancy<2>(smem, active)
                   : cluster_occupancy<3>(smem, active);
}

struct ClusterPlan {
  int nt, rows, clusters, smem;
};

// Rows a cluster takes: the batch spread over the clusters the card
// holds at once, in the fewest row tiles of 8 that take them, at most
// cluster::MAX_NT (or as many as fit a block's shared memory). A batch
// larger than that runs in waves of clusters, spread evenly over them.
cudaError_t make_cluster_plan(int B, int V, int hw, int vw, ClusterPlan* p) {
  if (hw <= 0 || hw % 32 != 0 || vw <= 0 || V > 4 * cluster::MAX_QUADS)
    return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  limit -= 1024;  // the kernel's static arrays
  p->nt = 0;
  for (int nt = 1; nt <= cluster::MAX_NT; ++nt) {
    const int smem = cluster::layout(nt, V, hw, vw).floats * 4;
    if (smem > limit) break;
    int active = 0;
    if ((err = cluster_occupancy(nt, smem, &active)) != cudaSuccess)
      return err;
    if (active < 1) break;  // no cluster of 16 blocks fits
    p->nt = nt;
    p->smem = smem;
    p->rows = (B + active - 1) / active;
    if (p->rows <= 8 * nt) break;
  }
  if (p->nt == 0) return cudaErrorNotSupported;
  if (p->rows > 8 * p->nt) {
    const int waves = (p->rows + 8 * p->nt - 1) / (8 * p->nt);
    p->rows = (p->rows + waves - 1) / waves;
    p->nt = (p->rows + 7) / 8;  // its shared-memory ceiling raised above
    p->smem = cluster::layout(p->nt, V, hw, vw).floats * 4;
  }
  p->clusters = (B + p->rows - 1) / p->rows;
  return cudaSuccess;
}

// Floats of the clusters' exchange areas at L2 (chain_kernel_cluster).
long long cluster_exchange_floats(const ClusterPlan& p, int V, int vw) {
  const long long rows = 8LL * p.nt;
  return (long long)p.clusters *
         (cluster::BLOCKS * cluster::BLOCKS * vw * rows +
          rows * ((V + 3) / 4 * 4));
}

cudaError_t launch_cluster(const ChainArgs& a, const ClusterPlan& p,
                           void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * cluster::BLOCKS);
  cfg.blockDim = dim3(cluster::THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster::BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return p.nt == 1   ? cudaLaunchKernelEx(&cfg, chain_kernel_cluster<1>, a)
         : p.nt == 2 ? cudaLaunchKernelEx(&cfg, chain_kernel_cluster<2>, a)
                     : cudaLaunchKernelEx(&cfg, chain_kernel_cluster<3>, a);
}

}  // namespace

// out8 = (tile_rows, grid, slices_h, slices_v, floats of `partial`,
// grid barriers of a chain of n_steps [+ the final pass], blocks of a
// cluster, shared-memory bytes of a block). The grid body (cluster_body
// 0): plan_B is the batch the plan is made for (B when 0); the scratch
// sizes are those of the B rows launched. The cluster body (cluster_body
// 1, hw hidden columns a block and vw the widest visible slice): rows a
// cluster, blocks, the k-parts of the hidden half and the shares of the
// visible half (one a block), the floats of the clusters' exchange areas;
// no grid barrier.
extern "C" int chain_plan(int B, int V, int H, int n_steps,
                          int final_unclamped, int tile_rows,
                          int max_grid, int plan_B, int cluster_body, int hw,
                          int vw, long long* out8) {
  if (plan_B < B && plan_B != 0) return (int)cudaErrorInvalidValue;
  if (cluster_body) {
    ClusterPlan c;
    const cudaError_t err = make_cluster_plan(B, V, hw, vw, &c);
    if (err != cudaSuccess) return (int)err;
    const long long vals[8] = {c.rows,
                               (long long)c.clusters * cluster::BLOCKS,
                               cluster::KW, cluster::BLOCKS,
                               cluster_exchange_floats(c, V, vw), 0,
                               cluster::BLOCKS, c.smem};
    for (int i = 0; i < 8; ++i) out8[i] = vals[i];
    return 0;
  }
  Plan p;
  const cudaError_t err =
      make_plan(plan_B > 0 ? plan_B : B, V, H, tile_rows, max_grid, &p);
  if (err != cudaSuccess) return (int)err;
  const long long ph = (long long)p.slices_h * B * ((H + 3) / 4 * 4);
  const long long pv = (long long)p.slices_v * B * ((V + 3) / 4 * 4);
  out8[0] = p.tile_rows;
  out8[1] = p.grid;
  out8[2] = p.slices_h;
  out8[3] = p.slices_v;
  out8[4] = ph > pv ? ph : pv;
  const int passes = (n_steps > 0 ? n_steps : 0) + (final_unclamped ? 1 : 0);
  out8[5] = 1 + 4LL * passes;
  out8[6] = 0;
  out8[7] = p.tile_rows == 128  ? gemm::Tile<8>::SMEM_BYTES
            : p.tile_rows == 64 ? gemm::Tile<4>::SMEM_BYTES
                                : gemm::Tile<2>::SMEM_BYTES;
  return 0;
}

// The grid body (cluster_body 0): v, h, logits, partial: scratch of
// [B, ceil4(V)], [B, ceil4(H)], [B, V] and chain_plan's out8[4] floats;
// barrier: one zeroed 32-bit counter. The cluster body (cluster_body 1)
// takes partial (chain_plan's out8[4] floats, the clusters' exchange
// areas; its B rows) and none of the others (null), and bounds: 17 ints on
// the device, the
// first visible column of each block of a cluster and V (every softmax
// group inside one block's columns), hw: hidden columns a block (a
// multiple of 32), vw: the widest block's visible columns.
extern "C" int chain_run(const float* w, const float* hb, const float* vb,
                         const float* v_init, const float* v_known,
                         const float* km, const float* mu, const float* sched,
                         const int* groups, float* out, float* v, float* h,
                         float* logits, float* partial, unsigned* barrier,
                         int B, int V, int H, int n_steps, int n_groups,
                         int Dz, int noisy, const unsigned long long* keys,
                         int key_index, unsigned long long seed,
                         int final_unclamped, int tile_rows,
                         int max_grid, int row0, int plan_B,
                         int cluster_body, const int* bounds, int hw, int vw,
                         void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (n_groups < 0 || n_groups > MAX_GROUPS || H <= 0 || row0 < 0 ||
      key_index < 0 ||
      (plan_B < B && plan_B != 0))
    return (int)cudaErrorInvalidValue;
  ChainArgs a{w, hb, vb, v_init, v_known, km, mu, sched, groups, out, v, h,
              logits, partial, barrier, B, V, H, (V + 3) / 4 * 4,
              (H + 3) / 4 * 4, n_steps > 0 ? n_steps : 0, n_groups, Dz, noisy,
              final_unclamped, 0, 0, 0, 0, keys, key_index, seed,
              (uint32_t)row0, bounds, hw, vw, 0};
  cudaError_t err;
  if (cluster_body) {
    if (bounds == nullptr || partial == nullptr)
      return (int)cudaErrorInvalidValue;
    ClusterPlan c;
    if ((err = make_cluster_plan(B, V, hw, vw, &c)) != cudaSuccess)
      return (int)err;
    a.cl_rows = c.rows;
    err = launch_cluster(a, c, stream);
  } else {
    Plan p;
    err = make_plan(plan_B > 0 ? plan_B : B, V, H, tile_rows, max_grid, &p);
    if (err != cudaSuccess) return (int)err;
    a.slices_h = p.slices_h;
    a.k_per_slice_h = p.k_per_slice_h;
    a.slices_v = p.slices_v;
    a.k_per_slice_v = p.k_per_slice_v;
    err = p.tile_rows == 128  ? launch<8>(a, p.grid, stream)
          : p.tile_rows == 64 ? launch<4>(a, p.grid, stream)
                              : launch<2>(a, p.grid, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
