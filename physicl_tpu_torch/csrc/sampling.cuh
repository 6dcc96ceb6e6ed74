// Device helpers shared by fused_transport.cu and planck_gen.cu: the counter
// hash both kernels draw from and the piecewise-polynomial Planck inverse
// CDF (the same function in the bulk generator and in the transport kernel's
// "emit" op).
//
// Build with --fmad=false and no fast math: the plain PyTorch twins
// (physicl_tpu_torch/ops/fused.py, ops/planck.py) round every product and
// sum the same way, so kernel and twin agree bitwise.

#pragma once

#include <cstdint>

namespace physicl {

// Murmur3 finalizer twice over a (seed ^ iteration ^ draw index) + slot key:
// the JAX package's emulated-chunk hash (_Rng._hash_bits). lin is the slot
// term row * 0x85EBCA6B + lane * 0xC2B2AE35 (row = slot >> 7, lane = slot
// & 127), idx the 1-based draw index. hash_key depends only on the
// iteration's h0 and the draw index, so a kernel whose draw indices are
// compile-time constants computes it once per iteration for every slot;
// hash_mix is the per-slot finalizer.
__device__ __forceinline__ uint32_t hash_key(uint32_t h0, uint32_t idx) {
  return h0 ^ (idx * 0x7FEB352Du);
}

__device__ __forceinline__ uint32_t hash_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h ^= h >> 16;
  h *= 0xC2B2AE35u;
  h ^= h >> 13;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t h0, uint32_t idx,
                                              uint32_t lin) {
  return hash_mix(hash_key(h0, idx) + lin);
}

__device__ __forceinline__ uint32_t slot_term(long long g) {
  return (uint32_t)(g >> 7) * 0x85EBCA6Bu + (uint32_t)(g & 127) * 0xC2B2AE35u;
}

// top 24 bits -> uniform in [0, 1)
__device__ __forceinline__ float unit24(uint32_t b) {
  return (float)(b >> 8) * (1.0f / 16777216.0f);
}

// Layout of one packed inverse-CDF table (float32, kIcdfStride entries):
// 33 breakpoints pb, 32 segment midpoints, 32 half-widths, 32 x 8 monomial
// coefficients (segment-major, degree 0 first), then E_lo and E_hi.
// physicl_tpu_torch/ops/planck.py:icdf_table writes it.
constexpr int kSegs = 32;
constexpr int kDeg = 7;
constexpr int kIcdfPb = 0;
constexpr int kIcdfMid = kIcdfPb + kSegs + 1;
constexpr int kIcdfHalf = kIcdfMid + kSegs;
constexpr int kIcdfCoef = kIcdfHalf + kSegs;
constexpr int kIcdfLo = kIcdfCoef + kSegs * (kDeg + 1);
constexpr int kIcdfHi = kIcdfLo + 1;
constexpr int kIcdfStride = 360;

// The JAX package's _poly_icdf_eval (physicl_tpu/light.py:288) on one
// uniform: the segment s with pb[s] <= u < pb[s+1] (found by bisection over
// the 33 breakpoints, not by a mask over all 32 segments), x = (u - mid) /
// half with half accumulated as 1 + (half_s - 1) exactly as the JAX mask sum
// rounds it, degree-7 Horner, clip to [E_lo, E_hi]. A u outside every
// segment evaluates the zero polynomial, as the JAX mask sum does.
__device__ __forceinline__ float poly_icdf(float u, const float* t) {
  const float* pb = t + kIcdfPb;
  float acc = 0.0f;
  if (u >= pb[0] && u < pb[kSegs]) {
    int lo = 0, hi = kSegs;  // invariant: pb[lo] <= u < pb[hi]
    while (hi - lo > 1) {
      const int m = (lo + hi) >> 1;
      if (u >= pb[m]) lo = m; else hi = m;
    }
    const float half = 1.0f + (t[kIcdfHalf + lo] - 1.0f);
    const float x = (u - t[kIcdfMid + lo]) / half;
    const float* c = t + kIcdfCoef + lo * (kDeg + 1);
    acc = c[kDeg];
#pragma unroll
    for (int j = kDeg - 1; j >= 0; --j) acc = acc * x + c[j];
  }
  // jnp.clip / torch.clamp semantics: a NaN (Horner overflow in a
  // near-zero-mass tail segment of an extreme window) stays NaN, where
  // fminf/fmaxf would return the bound
  const float e_lo = t[kIcdfLo], e_hi = t[kIcdfHi];
  return acc < e_lo ? e_lo : (acc > e_hi ? e_hi : acc);
}

}  // namespace physicl
