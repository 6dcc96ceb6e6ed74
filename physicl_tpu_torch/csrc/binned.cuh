// A binned reduce's bin index (fused_transport.cu, kernel 1i's "reduce" of
// a histogram tally: light.SpectrumMeasureStep and MeshTallyStep).
//
// The reference tallies per-bin masks, coord >= e[i] && coord < e[i+1], and
// coord < e[0] / coord >= e[-1] for the capture bins, with e the float64
// edges rounded to float32 (a float32 coordinate compared with a Python
// float). A slot falls in at most one of them, so the kernel takes one bin
// index a slot: n, the number of float32 edges at or below the coordinate,
// puts it in bin n - 1, underflow for n = 0 and overflow for n = the edge
// count. That reproduces every mask: a value on an edge falls in the upper
// bin, two edges that round to one float32 value leave their bin empty,
// +inf falls in overflow and -inf in underflow. A NaN coordinate is at or
// above no edge, so n would be 0: it falls in no bin, as in the reference
// (every mask false), and so does a dead slot.
//
// The edges sit in the Plan's fk as a search table: a complete binary
// search tree of 2^L - 1 nodes laid out level by level (node i's children
// 2i + 1 and 2i + 2), its in-order sequence the edges and then NaN, which
// no coordinate is at or above (ops/fused.py: Bins.search_table). The
// search is L steps of one load, one compare and one index update, with no
// branch; at step l the lanes read among 2^l neighbouring words, so up to
// 32 of them in distinct banks of the block's shared copy.
//
// Plain C++17 with no CUDA type, so that a host compiler builds it too
// (tests/test_torch_binned.py builds it with g++ beside a form's generated
// binned function).

#pragma once

#ifndef __CUDACC__
#ifndef __host__
#define __host__
#define __device__
#endif
#endif

namespace physicl {

// the least L with 2^L - 1 >= n
__host__ __device__ constexpr int bin_levels(int n) {
  int l = 0;
  while ((1 << l) - 1 < n) ++l;
  return l;
}

// One binned reduce's form: kNE float32 edges; the capture bins; kCount
// (each slot adds 1) or a value; its constants from fk[kFk] (the program's
// kNProg, then the search table); its float columns from kCol0; the
// search table's offset kSm in the block's shared copy.
template <int kNE_, int kUnder_, int kOver_, int kCount_, int kFk_,
          int kNProg_, int kCol0_, int kSm_>
struct BinForm {
  static constexpr int kNE = kNE_;
  static constexpr int kUnder = kUnder_;
  static constexpr int kOver = kOver_;
  static constexpr int kCount = kCount_;
  static constexpr int kTable = kFk_ + kNProg_;  // the table in fk
  static constexpr int kCol0 = kCol0_;
  static constexpr int kSm = kSm_;
  static constexpr int kNB = kNE - 1;                  // bins between edges
  static constexpr int kNC = kNB + kUnder + kOver;     // float columns
  static constexpr int kLevels = bin_levels(kNE);
  static constexpr int kNodes = (1 << kLevels) - 1;    // the table's length
};

// the number of edges at or below c: the search of the table t
template <int kLevels>
__host__ __device__ inline int bin_count_search(const float* t, float c) {
  int i = 0;
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int l = 0; l < kLevels; ++l) i = 2 * i + 1 + (t[i] <= c ? 1 : 0);
  return i - ((1 << kLevels) - 1);
}

// the slot's column among the op's kNC (the bins, underflow, overflow) for
// n edges at or below c, or -1: none (a dead slot, a NaN, outside the
// edges without a capture bin)
template <class B>
__host__ __device__ inline int bin_column(int n, float c, bool alive) {
  int col = n - 1;
  if (n == 0) col = B::kUnder ? B::kNB : -1;
  if (n == B::kNE) col = B::kOver ? B::kNB + B::kUnder : -1;
  return alive && c == c ? col : -1;
}

}  // namespace physicl
