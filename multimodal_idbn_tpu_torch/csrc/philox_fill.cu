// Philox fill for Hopper (sm_90a): the uniforms and random bits of the
// port's plain torch draws (ops/rng.py: uniform, gumbel, random_bits16).
//
//   out[r, c] = word 0 of Philox4x32-10(counter = (row0 + r, col0 + c, 0,
//               stream_id), key)  ->  (bits >> 8) * 2^-24  (float32)
//                                 or  bits >> 16             (int32)
//
// No TPU kernel: the JAX package draws these numbers with jax.random
// (threefry, lowered by XLA; multimodal_idbn_tpu/ops/sampling.py:22-41,
// rbm_ops.py:145-170). The port drew them from a torch.Generator seeded by
// a host integer on every call, which a CUDA graph would replay with the
// captured seed. Here the key is read from device memory: keys[key_index]
// when keys is not null (a key table that the host fills before each
// replay of an epoch), else the value `seed`. The counter scheme is the
// kernels' own (philox.cuh), so ops/rng.py's torch Philox reproduces every
// bit (rng.philox_bits).
//
// What bounds it on an H100: it reads 8 bytes and writes 4 per element,
// and a Philox4x32-10 is ~60 integer operations, so a [128, 532] fill is
// ~0.27 MB and 4 MOP: well under a microsecond either way; the launch
// dominates. One thread per element, a grid-stride loop over at most 1024
// blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

__global__ void philox_fill_kernel(void* out, long long n, int cols,
                                   const unsigned long long* keys,
                                   int key_index, unsigned long long seed,
                                   uint32_t row0, uint32_t col0,
                                   uint32_t stream_id, int bits16) {
  const uint64_t key = keys != nullptr ? __ldg(keys + key_index) : seed;
  const uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const uint32_t r = (uint32_t)(i / cols), c = (uint32_t)(i % cols);
    const uint32_t bits =
        philox4x32_10(make_uint4(row0 + r, col0 + c, 0u, stream_id), k0, k1)
            .x;
    if (bits16)
      static_cast<int*>(out)[i] = (int)(bits >> 16);
    else
      static_cast<float*>(out)[i] = philox_bits_to_uniform(bits);
  }
}

}  // namespace

// out: [rows, cols] float32 (bits16 = 0) or int32 (bits16 = 1).
extern "C" int philox_fill(void* out, int rows, int cols,
                           const unsigned long long* keys, int key_index,
                           unsigned long long seed, int row0, int col0,
                           int stream_id, int bits16, void* stream) {
  if (rows < 0 || cols < 0 || row0 < 0 || col0 < 0 || key_index < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  philox_fill_kernel<<<(int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      out, n, cols, keys, key_index, seed, (uint32_t)row0, (uint32_t)col0,
      (uint32_t)stream_id, bits16);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
