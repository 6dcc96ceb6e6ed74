// Typed values of the generated user and field programs (ops/codegen.py):
// int32 and int64 arithmetic in two's complement, the conversions as the
// twin (ops/record.py:_convert) and XLA define them, shifts guarded past
// the width, integer and float64 powers and NaN-propagating min / max, the
// bit casts, and an integer or float64 constant of a field program read
// exactly from its Plan::fk slots. Plain C++: the host builds it too (with
// __device__ and __forceinline__ defined away).
#pragma once

#include <stdint.h>
#include <string.h>

// float -> integer: towards 0, saturating, NaN 0 (XLA's convert; on the
// card the saturating conversion instruction, with NaN tested first: the
// 64-bit one gives NaN the most negative value; the portable spelling on
// the host)
#ifdef __CUDA_ARCH__
__device__ __forceinline__ int trunc_i32(float x) {
  return isnan(x) ? 0 : __float2int_rz(x);
}
__device__ __forceinline__ int trunc_i32(double x) {
  return isnan(x) ? 0 : __double2int_rz(x);
}
__device__ __forceinline__ long long trunc_i64(float x) {
  return isnan(x) ? 0LL : __float2ll_rz(x);
}
__device__ __forceinline__ long long trunc_i64(double x) {
  return isnan(x) ? 0LL : __double2ll_rz(x);
}
#else
__device__ __forceinline__ int trunc_i32(float x) {
  return isnan(x) ? 0 : x >= 2147483648.0f ? 2147483647
         : x < -2147483648.0f ? (-2147483647 - 1) : (int)x;
}
__device__ __forceinline__ int trunc_i32(double x) {
  return isnan(x) ? 0 : x >= 2147483648.0 ? 2147483647
         : x < -2147483648.0 ? (-2147483647 - 1) : (int)x;
}
__device__ __forceinline__ long long trunc_i64(float x) {
  return isnan(x) ? 0LL : x >= 9223372036854775808.0f ? 9223372036854775807LL
         : x < -9223372036854775808.0f ? (-9223372036854775807LL - 1)
         : (long long)x;
}
__device__ __forceinline__ long long trunc_i64(double x) {
  return isnan(x) ? 0LL : x >= 9223372036854775808.0 ? 9223372036854775807LL
         : x < -9223372036854775808.0 ? (-9223372036854775807LL - 1)
         : (long long)x;
}
#endif

// << and >> as XLA and torch define them: 0 (<<) or the sign (>>) for an
// amount outside [0, width)
__device__ __forceinline__ int shl(int a, int b) {
  return (b < 0 || b >= 32) ? 0 : (int)((unsigned)a << b);
}
__device__ __forceinline__ long long shl(long long a, long long b) {
  return (b < 0 || b >= 64) ? 0LL
                            : (long long)((unsigned long long)a << b);
}
__device__ __forceinline__ int shr(int a, int b) {
  return a >> ((b < 0 || b >= 32) ? 31 : b);
}
__device__ __forceinline__ long long shr(long long a, long long b) {
  return a >> ((b < 0 || b >= 64) ? 63 : b);
}

// lax.integer_pow of an integer (y >= 0; the products wrap) and of a
// float64 (binary exponentiation, 1 / x^|y| for y < 0)
__device__ __forceinline__ int ipow_i32(int x, int y) {
  unsigned acc = 1u, ux = (unsigned)x, u = (unsigned)y;
  while (u) {
    if (u & 1u) acc *= ux;
    u >>= 1;
    ux *= ux;
  }
  return (int)acc;
}
__device__ __forceinline__ long long ipow_i64(long long x, int y) {
  unsigned long long acc = 1ull, ux = (unsigned long long)x;
  unsigned u = (unsigned)y;
  while (u) {
    if (u & 1u) acc *= ux;
    u >>= 1;
    ux *= ux;
  }
  return (long long)acc;
}
__device__ __forceinline__ double ipow_f64(double x, int y) {
  if (y == 0) return 1.0;
  const bool neg = y < 0;
  unsigned u = neg ? (unsigned)(-y) : (unsigned)y;
  double acc = 0.0;
  bool have = false;
  while (u) {
    if (u & 1u) {
      acc = have ? acc * x : x;
      have = true;
    }
    u >>= 1;
    if (u) x = x * x;
  }
  return neg ? 1.0 / acc : acc;
}

// jnp.minimum / jnp.maximum of float64: NaN-propagating
__device__ __forceinline__ double nan_min_f64(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}
__device__ __forceinline__ double nan_max_f64(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}

// the same bits as another type (lax.bitcast_convert_type)
__device__ __forceinline__ int f32_as_i32(float x) {
  int v;
  memcpy(&v, &x, 4);
  return v;
}
__device__ __forceinline__ float i32_as_f32(int x) {
  float v;
  memcpy(&v, &x, 4);
  return v;
}
__device__ __forceinline__ long long f64_as_i64(double x) {
  long long v;
  memcpy(&v, &x, 8);
  return v;
}
__device__ __forceinline__ double i64_as_f64(long long x) {
  double v;
  memcpy(&v, &x, 8);
  return v;
}

// a field program's integer or float64 constant: its bits in 16-bit
// chunks, high first, each an exact float in Plan::fk
__device__ __forceinline__ int fk_i32(const float* k) {
  return (int)(((unsigned)k[0] << 16) | (unsigned)k[1]);
}
__device__ __forceinline__ long long fk_i64(const float* k) {
  return (long long)(((unsigned long long)(unsigned)k[0] << 48) |
                     ((unsigned long long)(unsigned)k[1] << 32) |
                     ((unsigned long long)(unsigned)k[2] << 16) |
                     (unsigned long long)(unsigned)k[3]);
}
__device__ __forceinline__ double fk_f64(const float* k) {
  return i64_as_f64(fk_i64(k));
}
