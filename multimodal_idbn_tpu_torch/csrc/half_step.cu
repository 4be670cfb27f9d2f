// Fused RBM half-step for Hopper (sm_90a), fp32.
//
//   probs  = sigmoid((x . W[^T] + b) * inv_T)
//   sample = probs > u(seed, row, col)        (Philox4x32-10, philox.cuh)
//
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
// 3.35 TB/s), but the fp32 CUDA-core rate bounds it first (57 us at
// 67 TFLOP/s). The TPU kernel rounded its operands to bf16 for the MXU;
// this kernel computes true fp32, which the flagship config pins.
//
// Design: a shared-memory tiled fp32 FMA GEMM (32x64 output tile per
// 128-thread block, k-tiles of 16, next tile prefetched into registers
// while the current one is multiplied), with the whole epilogue fused:
// bias, temperature, sigmoid and, when sampling, the Philox uniform and
// the Bernoulli compare; every output written once. Ragged edges (10000,
// 1568, 1500, 500) are masked here, so unlike the TPU callers nothing is
// padded. transpose_w reads the same row-major [V, H] W for the visible
// direction h . W^T. The uniform depends only on (seed, row, col), never
// on the tiling.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 128;
constexpr int A_PER_THREAD = BM * BK / THREADS;  // 4
constexpr int B_PER_THREAD = BK * BN / THREADS;  // 8

// out[B, N] = x[B, K] . W, with W stored [K, N] (TRANSPOSE = false) or
// [N, K] (TRANSPOSE = true), both row-major.
// SAMPLE = false writes probs only and leaves sample untouched.
template <bool TRANSPOSE, bool SAMPLE>
__global__ void __launch_bounds__(THREADS)
half_step_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ probs,
                 float* __restrict__ sample, int B, int K, int N,
                 float inv_T, uint64_t seed) {
  // +4 padding: the transposing stores hit 2 banks per 32 threads
  // instead of 16; rows stay 16-byte aligned for the float4 reads.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 output columns each
  const int ty = tid / 16;  // 4 output rows each
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float ra[A_PER_THREAD];
  float rb[B_PER_THREAD];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_PER_THREAD; ++q) {
      const int e = tid + THREADS * q;
      const int gm = m0 + (e >> 4), gk = k0 + (e & 15);
      ra[q] = (gm < B && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < B_PER_THREAD; ++q) {
      const int e = tid + THREADS * q;
      if (TRANSPOSE) {
        const int gn = n0 + (e >> 4), gk = k0 + (e & 15);
        rb[q] = (gn < N && gk < K) ? __ldg(w + (size_t)gn * K + gk) : 0.0f;
      } else {
        const int gk = k0 + (e >> 6), gn = n0 + (e & 63);
        rb[q] = (gn < N && gk < K) ? __ldg(w + (size_t)gk * N + gn) : 0.0f;
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int q = 0; q < A_PER_THREAD; ++q) {
      const int e = tid + THREADS * q;
      As[e & 15][e >> 4] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < B_PER_THREAD; ++q) {
      const int e = tid + THREADS * q;
      if (TRANSPOSE) {
        Bs[e & 15][e >> 4] = rb[q];
      } else {
        Bs[e >> 6][e & 63] = rb[q];
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int n_tiles = (K + BK - 1) / BK;
  if (n_tiles > 0) load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    store_tile();
    __syncthreads();
    if (t + 1 < n_tiles) load_tile((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      const float p = sigmoidf_exact((acc[i][j] + __ldg(b + c)) * inv_T);
      const size_t o = (size_t)r * N + c;
      probs[o] = p;
      if (SAMPLE) {
        const float u =
            philox_uniform(seed, (uint32_t)r, (uint32_t)c, 0u, 0u);
        sample[o] = p > u ? 1.0f : 0.0f;
      }
    }
  }
}

template <bool TRANSPOSE, bool SAMPLE>
int launch(const float* x, const float* w, const float* b, float* probs,
           float* sample, int B, int K, int N, float inv_T, uint64_t seed,
           void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  half_step_kernel<TRANSPOSE, SAMPLE>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          x, w, b, probs, sample, B, K, N, inv_T, seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int half_step_sample(const float* x, const float* w,
                                const float* b, float* probs, float* sample,
                                int B, int K, int N, int transpose_w,
                                float inv_T, unsigned long long seed,
                                void* stream) {
  return transpose_w
             ? launch<true, true>(x, w, b, probs, sample, B, K, N, inv_T,
                                  seed, stream)
             : launch<false, true>(x, w, b, probs, sample, B, K, N, inv_T,
                                   seed, stream);
}

extern "C" int half_step_probs(const float* x, const float* w,
                               const float* b, float* probs, int B, int K,
                               int N, float inv_T, void* stream) {
  return launch<false, false>(x, w, b, probs, nullptr, B, K, N, inv_T, 0,
                              stream);
}

// seed is the TPU kernel's int32 seed; its 32 bits key Philox.
extern "C" int half_step_sample_resident(const float* x, const float* w,
                                         const float* b, float* probs,
                                         float* sample, int B, int K, int N,
                                         float inv_T, unsigned int seed,
                                         void* stream) {
  return launch<false, true>(x, w, b, probs, sample, B, K, N, inv_T,
                             (uint64_t)seed, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
