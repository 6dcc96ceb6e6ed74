// planck_gen: bulk Planck-spectrum photon energies for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel physicl_tpu/light.py:_planck_gen_kernel_fn
// (built by _planck_kernel_sampler, pallas_call at light.py:370). The plain
// PyTorch twin is physicl_tpu_torch/ops/planck.py:planck_gen_reference.
//
// One thread per sample: a 24-bit uniform from the counter hash keyed on
// (seed, sample index) -- the TPU kernel's hardware PRNG has no counterpart
// on the card, so the kernel is held bitwise to its twin and statistically
// to the JAX package -- then the piecewise-polynomial inverse CDF
// (sampling.cuh:poly_icdf) and the optional code-unit factor.
//
// What bounds it on this card: the operations. Each sample writes 4 bytes
// (1.2 us per 10^6 samples at 3.35 TB/s) but costs ~14 integer operations of
// hashing, a five-step bisection, a divide and a degree-7 Horner chain. What
// the design does about it: the fit table (360 floats) sits in shared memory
// for the bisection's data-dependent reads, and the grid-stride loop keeps
// every SM busy with one launch of a fixed grid.

#include <cstdint>
#include <cuda_runtime.h>

#include "sampling.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
planck_gen_kernel(float* __restrict__ out, long long n, uint32_t seed,
                  const float* __restrict__ table, float scale) {
  __shared__ float t[physicl::kIcdfStride];
  for (int i = threadIdx.x; i < physicl::kIcdfStride; i += blockDim.x)
    t[i] = table[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += stride) {
    // draw 1 of "iteration 0": the fused kernel's hash with h0 = seed
    const uint32_t b = physicl::hash_bits(seed, 1u, physicl::slot_term(g));
    float E = physicl::poly_icdf(physicl::unit24(b), t);
    if (scale != 1.0f) E = E * scale;
    out[g] = E;
  }
}

}  // namespace

// Plain C launcher (loaded with ctypes): n energies into out (device float32)
// from the packed fit table (device float32, kIcdfStride entries). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int planck_gen_launch(void* out, long long n, unsigned int seed,
                                 const void* table, float scale,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int device = 0, n_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  long long blocks = (n + kBlock - 1) / kBlock;
  const long long cap = (long long)n_sm * 8;
  if (blocks > cap) blocks = cap;
  planck_gen_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (float*)out, n, (uint32_t)seed, (const float*)table, scale);
  return (int)cudaGetLastError();
}
