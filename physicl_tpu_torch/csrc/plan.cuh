// The transport kernel's plan (fused_transport.cu): the runtime Plan that
// every launch passes as a __grid_constant__ parameter (or, past the
// parameter room, in a device buffer), the op and field codes, and a plan's
// form (the structure a form library is compiled for) with form_matches,
// the launch's check that a Plan has the form its library was compiled
// for.
//
// Plain C++17 with no CUDA type, so that a host compiler builds it too
// (tests/test_torch_form.py builds form_matches with g++).

#pragma once

#include <cstddef>
#include <cstdint>
#include <utility>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace physicl {

constexpr int kMaxExtras = 8;  // the Stokes and frame rows, otype and qm
constexpr int kRotSteps = 27;  // the azimuth bisection: 26 steps and the last

// Mirrored member for member by physicl_tpu_torch/ops/_build.py (ctypes):
// the grid pointers lead Plan and every other member is 4 bytes wide, so the
// layouts agree (fused_transport_plan_dims lets the binding check). Most ops
// reuse members under per-kind meanings: see the comments, and
// physicl_tpu_torch/ops/fused.py:_plan_struct.
struct Op {
  int kind;
  int col0;        // sign/cross: n column (-1 = none); del/compton:
                   // deposition fcol; lorentz: the q/m extras plane (-1 =
                   // the species-wide q/m folded in coef)
  int col1;        // sign: first of the three sign columns; scross: its
                   // count column; trace: its first stream plane;
                   // fresnel: the axis
  int flag;        // iso/hg/rayl/phase: bit 0 lambda^-4 weighting; hg: bit
                   // 1 isotropic limit; compton: bit 1 sigma_KN weighting;
                   // del: DelVariant; emit: isotropic; sign/cross/scross:
                   // weighted (float columns); sabsorb: kill inside; trace:
                   // scatter-flag plane; fresnel: match_speed; lorentz:
                   // LorentzFlag bits; user ops: bit 0 after the update,
                   // kUserBinned a binned reduce
  float coef;      // folded A*n (del and the scatter family); lorentz:
                   // 0.5 q/m in float32
  float wl_base;
  float c_val;     // |v| of a resampled, re-emitted or isotropically
                   // emitted photon; fresnel: c
  int emit_n;      // emit: photons per iteration; phase: knots; compton:
                   // Kahn tries
  int emit_row;    // emit: row of emit_starts; user ops: draws
  int icdf;        // emit: offset of its fit table in aux (-1 = constant
                   // E); phase: offset of its knots m0, then dm, in aux
  float emit_E;    // emit: constant energy
  float emit_scale;  // emit: code-unit factor on sampled energies (1 = none)
  float emit_r[3];
  float emit_v[3];   // emit: directed velocity (flag == 0)
  int ax0;         // cross: planes axes[ax0 .. ax0 + n_ax)
  int n_ax;
  int nf;          // iso/del/scatter family: n(r) field (-1 = constant n,
                   // folded in coef)
  int af;          // del: A(E) field (-1 = none)
  int capture;     // del: implicit capture; emit: a polarized source
  float w_min;     // del: roulette threshold and survivor weight
  float w_sur;     //      (w_sur == 0: no roulette)
  float box[6];    // absorb/reflect/periodic: lo0, hi0, lo1, hi1, lo2,
                   // hi2; sabsorb/scross: the sphere cx, cy, cz, R;
                   // del stretch: b, dx, dy, dz; del fluorescence: Y, E_f,
                   // E_edge; hg: 1 - g^2, 1 - g, 2g, 1 + g^2; compton:
                   // 1 / m_e c^2, theta_e (0 = electrons at rest);
                   // fresnel: loc, n_lo, n_hi; lorentz: E, then B; emit:
                   // a polarized source's Stokes vector, then its frame
  int fld[2];      // lorentz: the recorded E field, then the recorded B
                   // field (three components each; -1 = the constant in
                   // box); phase: fld[0] the recorded inverse CDF (-1 = the
                   // knot table)
};

struct Axis {
  int axis;   // 0, 1, 2 = x, y, z
  float L;    // plane location
  int col;    // count column (int), or weight-sum column (float) if weighted
  int ecol;   // energy-sum float column (-1 = none)
  int ecap;   // stream plane of the crossing photons' energies (-1 = none)
};

// One density or cross-section field (physicl_tpu_torch/ops/fields.py).
struct Field {
  int kind;        // FieldKind
  int interp;      // voxel: 0 nearest, 1 trilinear
  int n[3];        // voxel: grid shape
  float org[3];    // voxel: origin
  float sp[3];     // voxel: spacing
  float outside;   // voxel/layered: value outside the coverage
  int axis;        // layered: 0, 1, 2 = x, y, z; 3 = |r - ctr|
  float ctr[3];    // layered: centre of the radial layers
  int off;         // expr: its first constant in fk; layered: edges in aux
  int len;         // expr: its constants; layered: layers (len + 1 edges,
                   // then len values)
  int shape;       // expr: the hash of its program's shape (opcodes,
                   // registers, integer exponents, outputs: everything but
                   // the constants, ops/codegen.py:field_shape); else 0
};

// A plan's tables sized for it: kOps ops, kAxes crossing planes, kFields
// fields and kK expression-field constants (each at least 1). A form
// library is compiled for its plan's sizes (FormPlan<Form>, which its
// translation unit names in PHYSICL_PLAN_DIMS); the main library for the
// op-sequence plans' (3 ops, no plane, no field).
template <int kOps, int kAxes, int kFields, int kK>
struct PlanT {
  const float* grids[kFields];  // voxel fields: the device grid
  Op ops[kOps];
  Axis axes[kAxes];
  Field fields[kFields];
  float fk[kK];     // the expression fields' constants, read by the field
                    // functions a form library generates at constant
                    // indices; then each binned reduce's (its program's
                    // and its search table)
  int n_ops;
  int n_cols;       // int record columns in use (col 0 = alive count)
  int n_fcols;      // float record columns in use
  int const_norm;   // |dr| = const_speed * dt for every photon
  float const_speed;
  int n_stream;     // stream planes per sampled iteration (0 = none)
  int stream_every; // stride: iterations k % stream_every == 0 are sampled
  int stream_bf16;  // stream elements are bfloat16 (else float32)
  int n_extras;     // extras planes after the 15 core ones
  int otype_x;      // the otype plane's index among them (-1: not mixed)
  int wb_mask;      // bit p: extras plane p is written back for every slot
                    // (the Stokes and frame rows an op mutates, a
                    // fluorescent del included)
  // the azimuth bisection's rotation by 2 delta_k = 2 pi / 2^k, k = 0 ..
  // 26: sin and cos computed in float64 on the host and rounded to float32
  float rot_sd[kRotSteps];
  float rot_cd[kRotSteps];
  int uwb_mask;     // bit p: extras plane p is a user program's written-back
                    // plane (an ElementwiseStep's extras_write), stored for
                    // every slot
};

// A Plan of at most this many bytes is a __grid_constant__ kernel
// parameter (CUDA 12.1 and later take up to 32,764 B of parameters on
// sm_70 and newer; the rest is the launch's other arguments); a larger one
// goes to a device buffer (ops/codegen.py: PLAN_PARAM_BYTES).
constexpr int kPlanParamBytes = 32000;

enum OpKind : int {
  OP_KIN = 0, OP_DEL = 1, OP_ISO = 2, OP_SIGN = 3, OP_EMIT = 4, OP_CROSS = 5,
  OP_ABSORB = 6, OP_REFLECT = 7, OP_PERIODIC = 8, OP_SABSORB = 9,
  OP_SCROSS = 10, OP_TRACE = 11, OP_HG = 12, OP_RAYL = 13, OP_PHASE = 14,
  OP_COMPTON = 15, OP_FRESNEL = 16, OP_LORENTZ = 17, OP_POL = 18,
  OP_POLC = 19, OP_POLMEAS = 20, OP_CUSTOM = 21, OP_REDUCE = 22,
  OP_KSTATE = 23
};

// Op::flag bit of a binned reduce (a histogram tally: binned.cuh; its
// edges, columns and constants' place in fk are the form's); bit 0 of a
// user op is "after the update"
constexpr int kUserBinned = 2;
// Op::flag bits of a "polmeas": weight by w, the <Q> and <U> columns
enum PolmeasFlag : int { kPolWeighted = 1, kPolLocalQU = 2 };
// Op::flag bits of a "lorentz": a constant E field, a constant B field, the
// dt after the UpdateTimeStep (sched row 3; else before it, row 4)
enum LorentzFlag : int { kLorE = 1, kLorB = 2, kLorAfter = 4 };
// Op::flag of a "del": the analog kill's variants
enum DelVariant : int { kDelAnalog = 0, kDelStretch = 1, kDelFluor = 2 };
// Op::flag bits of the scatter family: bit 0 lambda^-4 weighting (iso, hg,
// rayl, phase, pol); bit 1 the isotropic limit |g| < 1e-7 (hg) or the
// sigma_KN / sigma_T weighting (compton, polc)
constexpr int kWavelength = 1;
constexpr int kHgIsotropic = 2;
constexpr int kKnXsec = 2;

enum FieldKind : int { FIELD_EXPR = 1, FIELD_LAYERED = 2, FIELD_VOXEL = 3 };

// A plan's form: everything an op body tests, as compile-time constants of
// the form's own library (physicl_tpu_torch/ops/codegen.py emits a struct
// Form of these tables per form). The plan's numbers (coefficients, boxes,
// column indices, plane locations, field geometry, tables) stay in the
// runtime Plan. Every member but the last two mirrors a Plan member, or a
// test on one, that form_matches checks.
struct OpForm {
  int kind;
  int flag;      // Op::flag, every bit
  int capture;   // Op::capture
  int roulette;  // del: w_sur > 0
  int col0;      // col0 >= 0 (0 or 1); lorentz: the q/m extras plane or -1
  int axis;      // fresnel: the axis (Op::col1); else 0
  int nf, af;    // Op::nf, Op::af
  int fld[2];    // Op::fld
  int icdf;      // emit: Op::icdf >= 0 (sampled energies)
  int scale;     // emit: emit_scale != 1
  int thermal;   // compton: theta_e = box[1] > 0
  int n;         // compton, polc: Kahn tries (emit_n); user ops: draws
                 // (emit_row); else 0
  int ax0, n_ax; // cross: its planes (Op::ax0, Op::n_ax); else 0
  // derived from the rest, not in the Plan:
  int draw0;     // the draws an iteration makes before this op
  int nf_shared; // the n(r) read reuses the last op's read of field nf
                 // (no op between them moves the particle)
};

struct AxisForm {
  int axis;  // Axis::axis
  int ecol;  // Axis::ecol >= 0
  int ecap;  // Axis::ecap >= 0
};

struct FieldForm {
  int kind;    // Field::kind
  int interp;  // voxel: Field::interp; else 0
  int axis;    // layered: Field::axis; else 0
  int shape;   // expr: Field::shape; else 0
};

// a binned reduce's search table (binned.cuh): its place in the Plan's fk,
// its length, and its place in the block's shared copy
struct BinTab {
  int fk, n, sm;
};

namespace form_detail {

template <class Form, std::size_t kI, class P>
__host__ __device__ bool op_matches(const P& p) {
  constexpr OpForm o = Form::kOp[kI];
  const Op& q = p.ops[kI];
  const bool emit = o.kind == OP_EMIT;
  const bool tries = o.kind == OP_COMPTON || o.kind == OP_POLC;
  const bool user = o.kind == OP_CUSTOM || o.kind == OP_REDUCE ||
                    o.kind == OP_KSTATE;
  const bool cross = o.kind == OP_CROSS;
  return q.kind == o.kind && q.flag == o.flag && q.capture == o.capture &&
         (o.kind != OP_DEL || (q.w_sur > 0.0f) == (o.roulette != 0)) &&
         (o.kind == OP_LORENTZ ? q.col0 == o.col0
                               : (q.col0 >= 0) == (o.col0 != 0)) &&
         (o.kind != OP_FRESNEL || q.col1 == o.axis) && q.nf == o.nf &&
         q.af == o.af && q.fld[0] == o.fld[0] && q.fld[1] == o.fld[1] &&
         (!emit || (q.icdf >= 0) == (o.icdf != 0)) &&
         (!emit || (q.emit_scale != 1.0f) == (o.scale != 0)) &&
         (o.kind != OP_COMPTON || (q.box[1] > 0.0f) == (o.thermal != 0)) &&
         (!tries || q.emit_n == o.n) && (!user || q.emit_row == o.n) &&
         (!cross || (q.ax0 == o.ax0 && q.n_ax == o.n_ax));
}

template <class Form, std::size_t kI, class P>
__host__ __device__ bool axis_matches(const P& p) {
  constexpr AxisForm a = Form::kAx[kI];
  const Axis& q = p.axes[kI];
  return q.axis == a.axis && (q.ecol >= 0) == (a.ecol != 0) &&
         (q.ecap >= 0) == (a.ecap != 0);
}

template <class Form, std::size_t kI, class P>
__host__ __device__ bool field_matches(const P& p) {
  constexpr FieldForm f = Form::kFld[kI];
  constexpr int k0 = Form::kFk[kI], nk = Form::kFk[kI + 1] - k0;
  const Field& q = p.fields[kI];
  return q.kind == f.kind &&
         (f.kind != FIELD_VOXEL || q.interp == f.interp) &&
         (f.kind != FIELD_LAYERED || q.axis == f.axis) &&
         (f.kind != FIELD_EXPR ||
          (q.shape == f.shape && q.off == k0 && q.len == nk));
}

template <class Form, class P, std::size_t... kO, std::size_t... kA,
          std::size_t... kF>
__host__ __device__ bool all_match(const P& p, std::index_sequence<kO...>,
                                   std::index_sequence<kA...>,
                                   std::index_sequence<kF...>) {
  return (op_matches<Form, kO>(p) && ... && true) &&
         (axis_matches<Form, kA>(p) && ... && true) &&
         (field_matches<Form, kF>(p) && ... && true);
}

}  // namespace form_detail

template <int kN>
constexpr int at_least_1 = kN > 0 ? kN : 1;

// The Plan type of a form: its tables sized for its ops, planes, fields and
// constants (Form::kNK: the expression fields', then the binned reduces').
template <class Form>
using FormPlan = PlanT<at_least_1<Form::kN>, at_least_1<Form::kNAx>,
                       at_least_1<Form::kNFld>, at_least_1<Form::kNK>>;

// True when the runtime Plan has exactly the structure Form was compiled
// for: the op kinds in order and every member an op body tests, the planes
// of each cross op, the fields' kinds and the expression fields' shapes and
// constant ranges, the record columns, the norm, the stream, the extras and
// their write-back masks. A launch of a form's library refuses any other
// Plan (cudaErrorInvalidValue).
template <class Form>
__host__ __device__ bool form_matches(const FormPlan<Form>& p) {
  return p.n_ops == Form::kN && p.n_cols == Form::kCols &&
         p.n_fcols == Form::kFcols && p.const_norm == Form::kConstNorm &&
         (p.n_stream > 0) == (Form::kStream != 0) &&
         p.stream_bf16 == Form::kStreamBf16 &&
         p.n_extras == Form::kExtras && p.otype_x == Form::kOtype &&
         p.wb_mask == Form::kWb && p.uwb_mask == Form::kUwb &&
         form_detail::all_match<Form>(
             p, std::make_index_sequence<Form::kN>{},
             std::make_index_sequence<Form::kNAx>{},
             std::make_index_sequence<Form::kNFld>{});
}

}  // namespace physicl
