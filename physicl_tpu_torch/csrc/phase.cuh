// The block phase of kernel 1i's bounded loops (ops/codegen.py:_phase_c).
//
// A user program's loop runs while a lane's condition holds, at most a
// static number of trips. Run per lane, a warp runs each loop of the
// program in turn, each as long as its slowest enabled lane, however few
// lanes are enabled in it. The form kernel calls a user program on every
// thread of the block at once (the tile and iteration loops are uniform
// over the block, dead and tail slots included), so a program's loops that
// read none of one another's results (ops/record.py:loop_phases) run as
// one phase of the block:
//
//  1. phase_place: each lane's enable of each loop, a warp ballot and its
//     popc prefix give the lane's place among its warp's items of the
//     loop; the warps' counts (in shared words after the items) and a
//     barrier give its place among the block's, and each loop's item
//     count;
//  2. each lane writes an item for each loop it is enabled in: its carried
//     values and the outer values the body reads, one row of kPhaseLanes
//     words each (two for a 64-bit value), in the loop's rows;
//  3. after a barrier, thread q runs items q, q + 256, ... of the block's
//     items in loop order (so a warp runs the lanes of one loop, but for a
//     warp at the boundary of two loops) and writes the carried values
//     back into the item;
//  4. after a barrier, each lane reads its results; a lane not enabled in
//     a loop keeps its initial values, as the per-lane loop leaves them;
//  5. a last barrier: the next phase (of this program or another, or this
//     one in the next iteration) puts its warps' counts after its own
//     rows, which may be words of this phase's result rows.
//
// A lane's values follow the same instructions either way, so the results
// are bit for bit the per-lane loop's. A field program is called on some
// lanes only, under per-lane branches: its loops stay per lane.
//
// The items take the first words of the form kernel's dynamic shared
// memory (Form::kPhaseWords, every phase of every program reusing them;
// the record count tile follows). Plain C++ apart from the four
// primitives: on the card the shared words, the thread index, the barrier
// and the ballot; the host build of the generated programs
// (tests/test_torch_codegen.py) runs a block's lanes as host threads and
// defines them.

#pragma once

#include "typed.cuh"

constexpr int kPhaseLanes = 256;
constexpr int kPhaseWarps = kPhaseLanes / 32;

#ifdef __CUDACC__
__device__ __forceinline__ unsigned* phase_words() {
  extern __shared__ unsigned phase_smem[];
  return phase_smem;
}
// the enable is made opaque before the vote (an empty asm, no
// instruction), as FormRec::count's predicate: the compiler must not copy
// the ballot into two paths of a lane's branch
__device__ __forceinline__ unsigned phase_ballot(bool p) {
  unsigned q = p;
  asm volatile("" : "+r"(q));
  return __ballot_sync(0xFFFFFFFFu, q != 0u);
}
__device__ __forceinline__ int phase_popc(unsigned b) { return __popc(b); }
#else
unsigned* phase_words();
unsigned phase_ballot(bool p);
void __syncthreads();
struct PhaseThread {
  unsigned x;
};
extern thread_local PhaseThread threadIdx;
inline int phase_popc(unsigned b) { return __builtin_popcount(b); }
#endif

// each lane's place among the block's items of each of kM loops (pos) and
// each loop's items (tot), from its enables; cnt: kM x kPhaseWarps words
template <int kM>
__device__ __forceinline__ void phase_place(unsigned* cnt,
                                            const bool (&en)[kM],
                                            int (&pos)[kM], int (&tot)[kM]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < kM; ++l) {
    const unsigned b = phase_ballot(en[l]);
    pos[l] = phase_popc(b & ((1u << lane) - 1u));
    if (lane == 0) cnt[l * kPhaseWarps + warp] = (unsigned)phase_popc(b);
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < kM; ++l) {
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kPhaseWarps; ++w) {
      const int c = (int)cnt[l * kPhaseWarps + w];
      base += w < warp ? c : 0;
      n += c;
    }
    pos[l] += base;
    tot[l] = n;
  }
}

// an item's value: a row word, or two (low, high) for a 64-bit value
__device__ __forceinline__ void phase_put_f32(unsigned* p, float v) {
  *p = (unsigned)f32_as_i32(v);
}
__device__ __forceinline__ float phase_get_f32(const unsigned* p) {
  return i32_as_f32((int)*p);
}
__device__ __forceinline__ void phase_put_i32(unsigned* p, int v) {
  *p = (unsigned)v;
}
__device__ __forceinline__ int phase_get_i32(const unsigned* p) {
  return (int)*p;
}
__device__ __forceinline__ void phase_put_i64(unsigned* p, long long v) {
  p[0] = (unsigned)(unsigned long long)v;
  p[kPhaseLanes] = (unsigned)((unsigned long long)v >> 32);
}
__device__ __forceinline__ long long phase_get_i64(const unsigned* p) {
  return (long long)(((unsigned long long)p[kPhaseLanes] << 32) | p[0]);
}
__device__ __forceinline__ void phase_put_f64(unsigned* p, double v) {
  phase_put_i64(p, f64_as_i64(v));
}
__device__ __forceinline__ double phase_get_f64(const unsigned* p) {
  return i64_as_f64(phase_get_i64(p));
}
