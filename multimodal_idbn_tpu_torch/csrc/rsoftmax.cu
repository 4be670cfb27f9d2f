// Replicated-softmax sampler for Hopper (sm_90a): the words of a
// replicated-softmax visible layer (Salakhutdinov & Hinton, NIPS 2009),
// drawn from their logits.
//
//   p[r, :]      = softmax(logits[r, :])
//   counts[r, :] ~ Multinomial(D[r], p[r, :])   (D[r] words, the row's own)
//   mean[r, :]   = D[r] * p[r, :]               (the counts' expectation)
//
// Word j < D[r] of row r is the category that the uniform of counter
// (row0 + r, j, 0, 0) under the key (Philox4x32-10, philox.cuh: the
// half-steps' uniforms) selects by inverse CDF: the least k whose
// cumulative weight exceeds u * total. The key is keys[key_index] when keys
// is not null (a key table that the host fills before each replay of a
// CUDA graph of an epoch, ops/graphs.py), else the value `seed`.
//
// No TPU kernel: the JAX package has no replicated-softmax layer. One block
// of 256 threads a row; the row's weights exp(l - max) and their
// cumulative sums live in shared memory. Thread t owns the contiguous
// chunk [t * C, (t + 1) * C) of the V words (C = ceil(V / 256)) and sums
// it in order; the 256 chunk sums are scanned in order by one thread, so
// the cumulative weights are a fixed function of the logits, whatever the
// schedule: two launches on the same inputs agree bit for bit, and the
// plain version (ops/rsoftmax.py) follows the same order of sums.
//
// What bounds it on an H100: per row V logits read and 2 V outputs written,
// 12 V bytes, 2.9 MB for [128, 2000]: under a microsecond at 3.35 TB/s; a
// launch of 128 blocks is latency, the scan of 256 chunk sums one thread's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rs_sample_kernel(const float* logits, const float* words, float* counts,
                 float* mean, int V, const unsigned long long* keys,
                 int key_index, uint64_t seed, uint32_t row0) {
  extern __shared__ float cdf[];  // [V] cumulative weights, then [V] counts
  int* hits = reinterpret_cast<int*>(cdf + V);
  __shared__ float chunk[THREADS];
  __shared__ float red[THREADS / 32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const float* l = logits + (size_t)r * V;
  const int C = (V + THREADS - 1) / THREADS;
  const int k0 = min(V, tid * C), k1 = min(V, k0 + C);

  // the row's largest logit
  float m = -INFINITY;
  for (int k = k0; k < k1; ++k) m = fmaxf(m, l[k]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, red[i]);

  // the chunk's weights and their running sums, in order
  float run = 0.0f;
  for (int k = k0; k < k1; ++k) {
    run += expf(l[k] - m);
    cdf[k] = run;
  }
  for (int k = tid; k < V; k += THREADS) hits[k] = 0;
  chunk[tid] = run;
  __syncthreads();
  if (tid == 0) {  // exclusive scan of the chunk sums, in order
    float acc = 0.0f;
    for (int t = 0; t < THREADS; ++t) {
      const float c = chunk[t];
      chunk[t] = acc;
      acc += c;
    }
  }
  __syncthreads();
  const float off = chunk[tid];
  for (int k = k0; k < k1; ++k) cdf[k] = off + cdf[k];
  __syncthreads();

  const float total = cdf[V - 1];
  const float D = __ldg(words + r);
  const uint64_t key = keys != nullptr ? __ldg(keys + key_index) : seed;
  const int n = (int)D;
  for (int j = tid; j < n; j += THREADS) {
    const float target =
        philox_uniform(key, row0 + (uint32_t)r, (uint32_t)j, 0u, 0u) * total;
    int lo = 0, hi = V - 1;  // the least k with cdf[k] > target
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] > target)
        hi = mid;
      else
        lo = mid + 1;
    }
    atomicAdd(&hits[lo], 1);
  }
  __syncthreads();
  float* out_c = counts + (size_t)r * V;
  float* out_m = mean + (size_t)r * V;
  for (int k = tid; k < V; k += THREADS) {
    out_c[k] = (float)hits[k];
    out_m[k] = D * (expf(l[k] - m) / total);
  }
}

}  // namespace

// logits, counts, mean: [B, V] float32; words: [B] float32 (whole numbers).
extern "C" int rs_sample(const float* logits, const float* words,
                         float* counts, float* mean, int B, int V,
                         const unsigned long long* keys, int key_index,
                         unsigned long long seed, int row0, void* stream) {
  if (B < 0 || V < 1 || row0 < 0 || key_index < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)V * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rs_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rs_sample_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      logits, words, counts, mean, V, keys, key_index, seed, (uint32_t)row0);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
