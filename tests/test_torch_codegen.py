"""The transport kernel's code generator (``physicl_tpu_torch/ops/
codegen.py``): kernel 1i's user programs and the expression fields, on the
CPU, where there is no ``nvcc``.

* The generated translation unit is deterministic, and its build key
  (``ops/_build.py:plan_key``) changes with the program, the plan's form
  and the ``csrc/`` sources.
* The emitted program bodies, compiled for the host with ``g++`` (host
  stand-ins for ``__int_as_float``, ``nan_min``, ``nan_max``, ``ipow`` and
  the record sum; ``csrc/sampling.cuh``'s own ``hash_bits`` and ``unit24``)
  on 2**10 slots, against the plain version ``ops/record.py:
  run_user_program``: every program of ``chip_smoke.py``'s ``USER_PLANS``,
  its widened table's five op groups (every code and lowered function,
  the typed values and group C), the lattice and voxel-index paths, the
  user path and the spectrum path (a
  histogram tally's binned reduce
  through ``test_torch_binned.py``'s harness, against ``run_binned``:
  each slot's column equal, counts exactly, sums within rtol 1e-5), and a
  program per instruction code
  (the select's two operand forms, an alive clear before a record sum, a
  load after a store), and one per typed case (``_TYPED_CASES``: an
  int32, int64 or float64 operation of two registers and of constants at
  its edges, its result's bits stored, so the host's build and the twin
  agree bitwise). Tolerances: the plan programs' planes within 1e-6
  of each value plus 1e-6 of the plane's largest (``chip_smoke.py``'s plane
  gate: glibc's and torch's float32 transcendentals may differ by an ulp),
  ``alive`` equal, record sums within rtol 1e-5 (the host sums in float64,
  torch in float32); a single instruction bitwise, a transcendental one
  (exp, log, log10, sin, cos, tan, pow, and the libm functions of the
  widened table: atan ... lgamma, atan2) within 2 ulp; every code of the
  table is in glibc, so each is built here (``rsqrt`` is ``1.0f /
  sqrtf``, ``erfinv`` a recorded polynomial: no host stand-in).
* The emitted field functions (``codegen.field_c``: straight-line C, the
  constants read from the Plan's ``fk``), built with ``g++`` against a
  host Plan stand-in, against the plain version ``ops/record.py:run_field``
  on 2**10 seeded points with the same tolerances: a field per instruction
  code a field can use, three outputs included, and typed fields whose
  int32, int64 and float64 constants take their exact ``fk`` slots;
  ``chip_smoke.py``'s ``mirror_B``, ``crossed_EB``, ``linear_icdf`` and
  ``hg_icdf``;
  ``wide_sim``'s strings; the string grammar's constructs of its
  ``ops-strings`` plan (``%``, ``//``, comparisons, boolean logic,
  booleans promoted) and the lattice path's checkerboard.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import physicl_tpu_torch as T
from physicl_tpu_torch.ops import _build
from physicl_tpu_torch.ops import codegen as CG
from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops import record as RC

N = 1 << 10
SEED, K = 1234567, 3
T_OP, DT_OP = 0.0125, 1e-3
CSRC = os.path.join(os.path.dirname(F.__file__), os.pardir, "csrc")

_HARNESS = r"""
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <pthread.h>
#include <thread>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "phase.cuh"
#include "sampling.cuh"
#include "typed.cuh"
using physicl::hash_bits;
using physicl::slot_term;
using physicl::unit24;

// a block phase's primitives (phase.cuh): the block's lanes are host
// threads, its barrier a pthread barrier of kPhaseLanes, the shared words
// one array, a warp's ballot its lanes' votes read between two barriers
thread_local PhaseThread threadIdx;
static unsigned g_phase[1 << 20];
static unsigned g_votes[kPhaseLanes];
static pthread_barrier_t g_bar;
unsigned* phase_words() { return g_phase; }
void __syncthreads() { pthread_barrier_wait(&g_bar); }
unsigned phase_ballot(bool p) {
  g_votes[threadIdx.x] = p ? 1u : 0u;
  __syncthreads();
  const unsigned w0 = threadIdx.x & ~31u;
  unsigned b = 0;
  for (unsigned k = 0; k < 32; ++k) b |= g_votes[w0 + k] << k;
  __syncthreads();
  return b;
}
inline float __int_as_float(uint32_t b) {
  float v;
  std::memcpy(&v, &b, 4);
  return v;
}
// CUDA's correctly rounded fused multiply-add (U_FMA): the C library's
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float nan_min(float a, float b) {
  return (std::isnan(a) || std::isnan(b)) ? a + b : fminf(a, b);
}
inline float nan_max(float a, float b) {
  return (std::isnan(a) || std::isnan(b)) ? a + b : fmaxf(a, b);
}
inline float ipow(float x, int y) {
  if (y == 0) return 1.0f;
  const bool neg = y < 0;
  unsigned u = neg ? (unsigned)(-y) : (unsigned)y;
  float acc = 0.0f;
  bool have = false;
  while (u) {
    if (u & 1u) {
      acc = have ? acc * x : x;
      have = true;
    }
    u >>= 1;
    if (u) x = x * x;
  }
  return neg ? 1.0f / acc : acc;
}
// the warp's record sum: here one slot's value into a float64 column sum
struct HostAcc {
  double s[128] = {};
};
inline void user_sum(HostAcc& a, int col, float v) { a.s[col] += v; }

// one slot: its planes read, the program run, its planes written back
template <class Fn>
void run_slot(Fn fn, int n, int g, float* f, float* x, uint8_t* alive,
              float t, float dt, uint32_t h0, uint32_t idx0, HostAcc& acc) {
  float fl[15] = {}, xl[8] = {};
  const bool valid = g < n;
  for (int p = 0; p < 15 && valid; ++p) fl[p] = f[p * n + g];
  for (int p = 0; p < 8 && valid; ++p) xl[p] = x[p * n + g];
  bool a = valid && alive[g] != 0;
  fn(fl, xl, a, t, dt, h0, idx0, slot_term(g), acc);
  if (!valid) return;
  for (int p = 0; p < 15; ++p) f[p * n + g] = fl[p];
  for (int p = 0; p < 8; ++p) x[p * n + g] = xl[p];
  alive[g] = a;
}

template <class Fn>
void run_slots(Fn fn, int n, float* f, float* x, uint8_t* alive, float t,
               float dt, uint32_t h0, uint32_t idx0, double* acc) {
  HostAcc host_acc;
  for (int g = 0; g < n; ++g)
    run_slot(fn, n, g, f, x, alive, t, dt, h0, idx0, host_acc);
  std::memcpy(acc, host_acc.s, sizeof host_acc.s);
}

// a program with a block phase: the slots in blocks of kPhaseLanes, each
// lane a thread of the host (the lanes past n run on zero planes, dead, as
// the kernel's tail threads do); the record sums added in lane order
template <class Fn>
void run_blocks(Fn fn, int n, float* f, float* x, uint8_t* alive, float t,
                float dt, uint32_t h0, uint32_t idx0, double* acc) {
  std::vector<HostAcc> accs(kPhaseLanes);
  std::memset(acc, 0, 128 * sizeof(double));
  pthread_barrier_init(&g_bar, nullptr, kPhaseLanes);
  for (int g0 = 0; g0 < n; g0 += kPhaseLanes) {
    std::vector<std::thread> lanes;
    for (int q = 0; q < kPhaseLanes; ++q)
      lanes.emplace_back([&, q] {
        threadIdx.x = (unsigned)q;
        accs[q] = HostAcc{};
        run_slot(fn, n, g0 + q, f, x, alive, t, dt, h0, idx0, accs[q]);
      });
    for (auto& th : lanes) th.join();
    for (int q = 0; q < kPhaseLanes && g0 + q < n; ++q)
      for (int c = 0; c < 128; ++c) acc[c] += accs[q].s[c];
  }
  pthread_barrier_destroy(&g_bar);
}
"""


def _host_library(progs: dict, tmp):
    """``g++``-built shared library of ``{name: Program}``: ``run_<name>``
    runs the emitted body on every slot."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    parts = [_HARNESS]
    for name, prog in progs.items():
        parts.append(CG.program_c(prog, f"prog_{name}"))
        run = "run_blocks" if RC.loop_phases(prog) else "run_slots"
        parts.append(
            f'extern "C" void run_{name}(int n, float* f, float* x, '
            "uint8_t* alive, float t, float dt, uint32_t h0, uint32_t idx0, "
            f"double* acc) {{ {run}(prog_{name}<HostAcc>, n, f, x, alive, t, "
            "dt, h0, idx0, acc); }")
    src = os.path.join(tmp, "programs.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts))
    so = os.path.join(tmp, "libprograms.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", CSRC, "-o", so, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(so)


def _run_host(lib, name, planes, alive, idx0=0):
    """The host run of program ``name`` on ``planes`` ((23, n) float32: the
    15 core planes and 8 extras) and ``alive``; returns (planes, alive,
    float64 record sums)."""
    f = np.array(planes[:15], np.float32)  # copies: the run writes them
    x = np.array(planes[15:], np.float32)
    a = np.array(alive, np.uint8)
    acc = np.zeros(128, np.float64)
    h0 = (SEED ^ ((K * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF
    vp = ctypes.c_void_p
    getattr(lib, f"run_{name}")(
        ctypes.c_int(f.shape[1]), vp(f.ctypes.data), vp(x.ctypes.data),
        vp(a.ctypes.data), ctypes.c_float(T_OP), ctypes.c_float(DT_OP),
        ctypes.c_uint32(h0), ctypes.c_uint32(idx0), vp(acc.ctypes.data))
    return np.concatenate([f, x]), a.astype(bool), acc


def _run_twin(prog, planes, alive, idx0=0):
    """``run_user_program`` on the same inputs (the iteration's counter
    hash at draw index ``idx0``)."""
    f = [torch.from_numpy(p.copy()) for p in planes]
    rng = F._HashRng(SEED, K, F._slot_term(torch.arange(planes.shape[1])))
    rng.idx = idx0
    row = torch.zeros(128)
    al = RC.run_user_program(prog, f, torch.from_numpy(alive.copy()),
                             torch.tensor(T_OP), torch.tensor(DT_OP), rng,
                             row)
    return torch.stack(f).numpy(), al.numpy(), row.numpy().astype(np.float64)


def _inputs(seed=0):
    """(23, N) float32 planes in (0.1, 3) with ties between planes 0 and 12,
    exact 1s and 0s, and an alive mask of ~80%."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.1, 3.0, (23, N)).astype(np.float32)
    p[0, ::7] = p[12, ::7]
    p[12, ::11] = 1.0
    p[0, ::13] = 0.0
    alive = rng.uniform(size=N) < 0.8
    p[13] = alive
    return p, alive


# -- a program per instruction code ------------------------------------------

_TRANSCENDENTAL = {RC.U_EXP, RC.U_LOG, RC.U_LOG10, RC.U_SIN, RC.U_COS,
                   RC.U_TAN, RC.U_POW, RC.U_ATAN, RC.U_ASIN, RC.U_ACOS,
                   RC.U_SINH, RC.U_COSH, RC.U_TANH, RC.U_ASINH, RC.U_ACOSH,
                   RC.U_ATANH, RC.U_EXP2, RC.U_EXPM1, RC.U_LOG2, RC.U_LOG1P,
                   RC.U_ERF, RC.U_ERFC, RC.U_LGAMMA, RC.U_ATAN2}
# codes whose NaN (a negative operand) has no one sign bit across libms:
# their programs take the plane as it is, not less 1
_POSITIVE = (RC.U_SQRT, RC.U_LOG, RC.U_LOG10, RC.U_RSQRT)
# U_OUT is a loop's result in the recorder's SSA, never an instruction
_CODES = {name: code for name, code in vars(RC).items()
          if name.startswith("U_") and isinstance(code, int)
          and name != "U_OUT"}
_LOOP_CODES = {RC.U_CARRY, RC.U_LOOP, RC.U_SET, RC.U_END}


def _loop_program(code, field=False) -> RC.Program:
    """A bounded loop around the loop instruction ``code``: lanes that
    leave at different iterations and lanes that reach the cap
    (``U_LOOP``), carried int32 and float64 values (``U_CARRY``), carried
    values that swap, each update reading the other's old value
    (``U_SET``), and two loops in a row, the second reading the first's
    result (``U_END``); the results stored into planes 14, 3, 4, 15, or
    with ``field`` a field's three outputs over its variables a and b."""
    s = RC._SSA()
    x = s.val(RC.U_LD, (), 0 if field else 12)
    w = s.val(RC.U_LD, (), 1 if field else 0)
    c = s.const
    outs = []
    if code == RC.U_LOOP:  # halve while above 0.05, at most 6 times
        def body(v):
            r = s.op(RC.U_MUL, v[1], c(0.5))
            return [s.op(RC.U_GT, r, c(0.05)), r,
                    s.op(RC.U_ADD, v[2], c(1.0))]
        outs = s.loop([s.op(RC.U_GT, x, c(0.5)), x, c(0.0)], body, 6)[1:]
    elif code == RC.U_CARRY:  # an int32 count and a float64 sum
        def body(v):
            k = s.op(RC.U_ADD, v[1], c(1, RC.I32))
            tot = s.op(RC.U_ADD, v[2], s.op(RC.U_DIV, c(1.0, RC.F64),
                                            s.cvt(k, RC.F64)))
            return [s.op(RC.U_LT, s.cvt(k, RC.F32), s.op(
                RC.U_MUL, w, c(4.0))), k, tot]
        _, k, tot = s.loop([c(1.0), c(0, RC.I32), s.cvt(x, RC.F64)], body,
                           20)
        outs = [s.cvt(k, RC.F32), s.cvt(tot, RC.F32)]
    elif code == RC.U_SET:  # (a, b) -> (b, a + b / 2) three or four times
        def body(v):
            n = s.op(RC.U_ADD, v[3], c(1.0))
            return [s.op(RC.U_LT, n, s.op(RC.U_ADD, c(3.0), s.op(
                RC.U_GT, x, c(1.5)))), v[2], s.op(RC.U_ADD, v[1], s.op(
                    RC.U_MUL, v[2], c(0.5))), n]
        outs = s.loop([c(1.0), x, w, c(0.0)], body, 10)[1:3]
    else:  # two loops: the second starts from the first's result
        def first(v):
            r = s.op(RC.U_ADD, v[1], x)
            return [s.op(RC.U_LT, r, c(7.0)), r]

        _, r = s.loop([c(1.0), w], first, 50)

        def second(v):
            q = s.op(RC.U_MUL, v[1], c(0.75))
            return [s.op(RC.U_GT, q, x), q]

        outs = [r, s.loop([c(1.0), r], second, 50)[1]]
    if field:  # a field of three outputs
        outs = (outs + [x, x])[:3]
    for j, o in enumerate(outs):
        s.effects.append((RC.U_ST, o, j if field else (14, 3, 4, 15)[j]))
    return RC._schedule(s, 0)


def _code_program(case) -> RC.Program:
    """A short program around the instruction ``case`` (a ``U_*`` name, or
    one of the select's immediate form, an alive clear before a record sum
    and a load after a store): its results stored into planes 14, 3, 4, 15
    (an extras plane) or summed into record columns."""
    ld = lambda d, p: (RC.U_LD, d, 0, 0, p, False)  # noqa: E731
    st = lambda a, p: (RC.U_ST, 0, a, 0, p, False)  # noqa: E731
    if case == "U_SEL-imm":
        ins = [ld(0, 12), ld(1, 0), (RC.U_LT, 2, 0, 1, 0, False),
               (RC.U_SEL, 3, 2, 1, -2.5, True), st(3, 14)]
        return RC.Program(tuple(ins), 4, 0)
    if case in _TYPED_CASES:
        return _typed_program(*_TYPED_CASES[case])
    code = _CODES[case]
    if code in _LOOP_CODES:
        return _loop_program(code)
    if code == RC.U_FMA:  # a register addend, then an immediate one
        ins = [ld(0, 12), ld(1, 0), ld(2, 14),
               (RC.U_FMA, 3, 0, 1, 2, False), st(3, 14),
               (RC.U_FMA, 4, 1, 0, -2.5, True), st(4, 3)]
        return RC.Program(tuple(ins), 5, 0)
    if code in _TYPED_CODES:
        return _typed_program(code, RC.I32)
    if code == RC.U_SEL:
        ins = [ld(0, 12), ld(1, 0), (RC.U_LT, 2, 0, 1, 0, False),
               (RC.U_SEL, 3, 2, 0, 1, False), st(3, 14)]
        return RC.Program(tuple(ins), 4, 0)
    if code == RC.U_ST:  # a load after a store reads the stored value
        ins = [ld(0, 12), (RC.U_MUL, 1, 0, 0, 2.0, True), st(1, 12),
               ld(2, 12), (RC.U_ADD, 3, 2, 0, 1.0, True), st(3, 14),
               st(0, 15)]
        return RC.Program(tuple(ins), 4, 0)
    if code in (RC.U_ALIVE, RC.U_ACC):  # the clear before the sums
        ins = [ld(0, 12), (RC.U_LT, 1, 0, 0, 1.5, True),
               (RC.U_ALIVE, 0, 1, 0, 0, False), ld(2, 14),
               (RC.U_ACC, 0, 2, 0, 0, False), ld(3, 13),
               (RC.U_ACC, 0, 3, 0, 1, False),
               (RC.U_CONST, 4, 0, 0, 0.0, False),
               (RC.U_ACC, 0, 4, 0, 2, False)]
        return RC.Program(tuple(ins), 5, 0)
    if code == RC.U_LD:  # every core plane (13 the alive flag), an extras
        ins = [ld(0, 13), st(0, 14), ld(1, 16), st(1, 3), ld(2, 1),
               st(2, 15)]
        return RC.Program(tuple(ins), 3, 0)
    if code in (RC.U_T, RC.U_DT):
        return RC.Program(((code, 0, 0, 0, 0, False), st(0, 14)), 1, 0)
    if code == RC.U_CONST:
        vals = (1.5, -0.0, float("inf"), float("nan"), -3.25e-30)
        ins = []
        for j, v in enumerate(vals):
            ins += [(RC.U_CONST, j, 0, 0, v, False),
                    st(j, (14, 3, 4, 5, 15)[j])]
        return RC.Program(tuple(ins), len(vals), 0)
    if code == RC.U_UNIF:  # draws 0 and 2 of three
        ins = [(RC.U_UNIF, 0, 0, 0, 0, False), st(0, 14),
               (RC.U_UNIF, 1, 0, 0, 2, False), st(1, 3)]
        return RC.Program(tuple(ins), 2, 3)
    if code == RC.U_IPOW:
        ins = [ld(0, 12)]
        for j, e in enumerate((3, -2, 0, 7)):
            ins += [(RC.U_IPOW, 1 + j, 0, 0, e, False),
                    st(1 + j, (14, 3, 4, 15)[j])]
        return RC.Program(tuple(ins), 5, 0)
    if code in CG._UNARY:
        ins = [ld(0, 12), (RC.U_SUB, 1, 0, 0, 1.0, True), (code, 2, 0, 0, 0,
               False), st(2, 14), (code, 3, 1, 0, 0, False), st(3, 3)]
        if code in _POSITIVE:
            ins = ins[:1] + ins[2:4]
        return RC.Program(tuple(ins), 4, 0)
    # a binary operation: both operands registers, and b an immediate (a
    # remainder's divisor nonzero, E: fmodf(x, 0)'s NaN has no one sign
    # bit)
    fmod = code == RC.U_FMOD
    ins = [ld(0, 12), ld(1, 0), (code, 2, int(fmod), int(not fmod), 0,
                                 False), st(2, 14),
           (code, 3, 0, 0, 1.0, True), st(3, 3),
           (code, 4, 1, 0, 0.75 if fmod else 0.0, True), st(4, 15)]
    return RC.Program(tuple(ins), 5, 0)


# the codes of typed values: each in a program of its type (``_typed``)
_TYPED_CODES = {RC.U_CVT, RC.U_BAND, RC.U_BOR, RC.U_BXOR, RC.U_BNOT,
                RC.U_SHL, RC.U_SHR, RC.U_BITCAST}
# typed cases of the other codes: (code, type)
_TYPED_CASES = {
    **{f"{n}-{t}": (getattr(RC, n), t) for n in (
        "U_ADD", "U_SUB", "U_MUL", "U_NEG", "U_ABS", "U_MIN", "U_MAX",
        "U_DIV", "U_FMOD", "U_IPOW", "U_LT", "U_EQ", "U_SEL", "U_BOOL",
        "U_NOT") for t in (RC.I32, RC.I64)},
    **{f"{n}-{RC.F64}": (getattr(RC, n), RC.F64) for n in (
        "U_ADD", "U_SUB", "U_MUL", "U_DIV", "U_SQRT", "U_NEG", "U_MIN",
        "U_FLOOR", "U_IPOW", "U_LT", "U_EXP", "U_LOG", "U_SIN", "U_POW",
        "U_ATAN2", "U_LGAMMA", "U_FMOD", "U_RECIP", "U_RSQRT")},
    f"U_CVT-{RC.I64}": (RC.U_CVT, RC.I64),
    **{f"U_SHL-{t}": (RC.U_SHL, t) for t in (RC.I64,)},
    **{f"U_SHR-{t}": (RC.U_SHR, t) for t in (RC.I64,)},
    **{f"U_BAND-{t}": (RC.U_BAND, t) for t in (RC.I64,)},
}


class _Typed:
    """A typed program under construction: instructions and their types,
    one register each."""

    def __init__(self):
        self.ins, self.types = [], []

    def add(self, code, t, a=0, b=0, y=0, bimm=False):
        d = len(self.ins)
        self.ins.append((code, d, a, b, y, bimm))
        self.types.append(t)
        return d

    def store(self, v, t, planes):
        """The value's bits in the next of ``planes`` (an int32 or float32
        one, an int64 or float64 two: low word, then high word)."""
        if t == RC.F32:
            words = [v]
        elif t == RC.I32:
            words = [self.add(RC.U_BITCAST, RC.F32, v, y=RC.F32)]
        else:
            if t == RC.F64:
                v = self.add(RC.U_BITCAST, RC.I64, v, y=RC.I64)
            lo = self.add(RC.U_CVT, RC.I32, v, y=RC.I32)
            hi = self.add(RC.U_CVT, RC.I32, self.add(
                RC.U_SHR, RC.I64, v, y=32, bimm=True), y=RC.I32)
            words = [self.add(RC.U_BITCAST, RC.F32, w, y=RC.F32)
                     for w in (lo, hi)]
        for w in words:
            self.ins.append((RC.U_ST, 0, w, 0, planes.pop(0), False))
            self.types.append(RC.F32)

    def program(self, n_draws=0):
        return RC.Program(tuple(self.ins), len(self.ins), n_draws,
                          tuple(self.types))


def _typed_operands(p: _Typed, t):
    """Two values of type ``t`` over the whole range from the planes (an
    integer from a plane's bits, times another's for int64, so that sums
    and products wrap; a float64 from two planes' quotient), and a shift
    amount in [-10, 280] (past each width)."""
    a, b = (p.add(RC.U_LD, RC.F32, y=k) for k in (12, 0))
    sh = p.add(RC.U_CVT, RC.I32, p.add(RC.U_SUB, RC.F32, p.add(
        RC.U_MUL, RC.F32, p.add(RC.U_LD, RC.F32, y=14), y=100.0, bimm=True),
        y=20.0, bimm=True), y=RC.I32)
    if t == RC.F64:
        da, db = (p.add(RC.U_CVT, RC.F64, v, y=RC.F64) for v in (a, b))
        return p.add(RC.U_DIV, RC.F64, da, p.add(RC.U_ADD, RC.F64, db,
                                                 y=0.3, bimm=True)), db, sh
    ia, ib = (p.add(RC.U_BITCAST, RC.I32, v, y=RC.I32) for v in (a, b))
    if t == RC.I32:
        return ia, p.add(RC.U_SUB, RC.I32, ib, y=1 << 30, bimm=True), sh
    la, lb = (p.add(RC.U_CVT, RC.I64, v, y=RC.I64) for v in (ia, ib))
    return (p.add(RC.U_MUL, RC.I64, la, p.add(RC.U_MUL, RC.I64, lb, lb)),
            p.add(RC.U_SUB, RC.I64, lb, y=1 << 30, bimm=True),
            p.add(RC.U_CVT, RC.I64, sh, y=RC.I64))


def _typed_program(code, t) -> RC.Program:
    """A program around ``code`` of type ``t``: the operation of two
    registers, of a register and constants at the edges (a shift by 0,
    the width less 1, the width; a divisor of -1 and -3; int32's wrap),
    its results' bits stored (``_Typed.store``)."""
    p = _Typed()
    a, b, sh = _typed_operands(p, t)
    ints = t in RC.INT_BITS
    width = RC.INT_BITS.get(t, 0)
    planes = list(range(3, 13)) + list(range(14, 23))

    def out(v, vt=None):
        p.store(v, vt or t, planes)

    if code == RC.U_CVT:  # every conversion between the types
        f = p.add(RC.U_MUL, RC.F32, p.add(RC.U_LD, RC.F32, y=12),
                  y=3e9, bimm=True)  # past int32
        nan = p.add(RC.U_DIV, RC.F32, p.add(RC.U_LD, RC.F32, y=0),
                    p.add(RC.U_LD, RC.F32, y=0))  # 0 / 0 where plane 0 is 0
        fn = p.add(RC.U_SEL, RC.F32, p.add(RC.U_EQ, RC.F32, p.add(
            RC.U_LD, RC.F32, y=0), y=0.0, bimm=True), nan, f)
        if t == RC.I32:  # from float32, NaN included
            for src in (f, fn):
                for dst in (RC.I32, RC.I64, RC.F64):
                    out(p.add(RC.U_CVT, dst, src, y=dst), dst)
            return p.program()
        i = p.add(RC.U_BITCAST, RC.I32, f, y=RC.I32)
        big = p.add(RC.U_MUL, RC.I64, p.add(RC.U_CVT, RC.I64, i, y=RC.I64),
                    y=(1 << 33) + 1, bimm=True)
        d = p.add(RC.U_MUL, RC.F64, p.add(RC.U_CVT, RC.F64, f, y=RC.F64),
                  y=1e12, bimm=True)
        for src, st in ((i, RC.I32), (big, RC.I64), (d, RC.F64)):
            for dst in (RC.F32, RC.I32, RC.I64, RC.F64):
                if dst != st:
                    out(p.add(RC.U_CVT, dst, src, y=dst), dst)
        return p.program()
    if code == RC.U_BITCAST:
        out(p.add(RC.U_BITCAST, RC.I32, p.add(RC.U_LD, RC.F32, y=12),
                  y=RC.I32), RC.I32)
        dd = p.add(RC.U_CVT, RC.F64, p.add(RC.U_LD, RC.F32, y=0), y=RC.F64)
        ll = p.add(RC.U_BITCAST, RC.I64, dd, y=RC.I64)
        out(ll, RC.I64)
        out(p.add(RC.U_BITCAST, RC.F64, p.add(RC.U_ADD, RC.I64, ll, y=1,
                                               bimm=True), y=RC.F64), RC.F64)
        return p.program()
    if code in (RC.U_SHL, RC.U_SHR):
        if not ints:
            t, width = RC.I32, 32
            a, b, sh = _typed_operands(_Typed(), t)
        out(p.add(code, t, a, sh))
        for k in (0, 1, width - 1, width, -1):
            out(p.add(code, t, a, y=k, bimm=True))
        return p.program()
    if code == RC.U_BNOT:
        out(p.add(code, t if ints else RC.I32, a))
        return p.program()
    if code in (RC.U_NEG, RC.U_ABS, RC.U_SQRT, RC.U_FLOOR, RC.U_EXP,
                RC.U_LOG, RC.U_SIN, RC.U_LGAMMA, RC.U_RECIP, RC.U_RSQRT):
        out(p.add(code, t, a))
        out(p.add(code, t, b))
        if ints:  # the most negative value
            out(p.add(code, t, p.add(RC.U_CONST, t, y=-(1 << (width - 1)))))
        return p.program()
    if code == RC.U_IPOW:
        for e in ((3, 0, 7, 31) if ints else (3, -2, 0)):
            out(p.add(code, t, a, y=e))
        return p.program()
    if code in (RC.U_NOT, RC.U_BOOL):
        zero = p.add(RC.U_CONST, t, y=0 if ints else 0.0)
        out(p.add(code, RC.F32, a), RC.F32)
        out(p.add(code, RC.F32, zero), RC.F32)
        return p.program()
    if code == RC.U_SEL:
        cond = p.add(RC.U_LT, RC.F32, a, b)
        out(p.add(code, t, cond, b, a))
        out(p.add(code, t, cond, a, 5 if ints else 0.5, True))
        return p.program()
    compare = code in (RC.U_LT, RC.U_EQ)
    rt = RC.F32 if compare else t
    if code == RC.U_DIV and ints:  # by nonzero constants but -1
        for k in (7, -3, 1 << 20):
            out(p.add(code, t, a, y=k, bimm=True))
        return p.program()
    if code == RC.U_FMOD and ints:  # a divisor never 0; -1 included
        nz = p.add(RC.U_BOR, t, b, y=1, bimm=True)
        out(p.add(code, t, a, nz))
        for k in (7, -1, -3):
            out(p.add(code, t, a, y=k, bimm=True))
        return p.program()
    if code == RC.U_FMOD:  # a float64 divisor of 0: NaN of either sign
        b = p.add(RC.U_ADD, t, b, y=0.5, bimm=True)
    out(p.add(code, rt, a, b), rt)
    out(p.add(code, rt, b, a), rt)
    imm = ((1 << 31) - 1 if t == RC.I32 else -(1 << 40)) if ints else 0.75
    out(p.add(code, rt, a, y=imm, bimm=True), rt)
    return p.program()


_CODE_CASES = sorted(_CODES) + ["U_SEL-imm"] + sorted(_TYPED_CASES)


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(1 << 31) - ia, ia)  # order negative floats
    ib = np.where(ib < 0, -(1 << 31) - ib, ib)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return int(np.where(same, 0, np.abs(ia - ib)).max())


@pytest.fixture(scope="module")
def code_lib(tmp_path_factory):
    progs = {case.replace("-", "_"): _code_program(case)
             for case in _CODE_CASES}
    return _host_library(progs, str(tmp_path_factory.mktemp("codes"))), progs


@pytest.mark.parametrize("case", _CODE_CASES)
def test_instruction_matches_plain_version(code_lib, case):
    lib, progs = code_lib
    name = case.replace("-", "_")
    prog = progs[name]
    planes, alive = _inputs()
    got, got_alive, got_acc = _run_host(lib, name, planes, alive, idx0=5)
    want, want_alive, want_acc = _run_twin(prog, planes, alive, idx0=5)
    assert np.array_equal(got_alive, want_alive)
    code = _CODES.get(case) or _TYPED_CASES.get(case, (None,))[0]
    if case.endswith(f"-{RC.F64}") and code in _TRANSCENDENTAL | {
            RC.U_LGAMMA, RC.U_EXP, RC.U_LOG, RC.U_SIN, RC.U_POW}:
        # glibc's and torch's float64 libm: the two words within 4 ulp of
        # the double
        g = got[3:].view(np.int32).astype(np.int64)
        w = want[3:].view(np.int32).astype(np.int64)
        gd = ((g[1::2] << 32) | (g[0::2] & 0xFFFFFFFF)).view(np.float64)
        wd = ((w[1::2] << 32) | (w[0::2] & 0xFFFFFFFF)).view(np.float64)
        ok = np.isclose(gd, wd, rtol=1e-15, atol=0) | (np.isnan(gd)
                                                        & np.isnan(wd))
        assert ok.all(), (gd[~ok][:4], wd[~ok][:4])
    elif code in _TRANSCENDENTAL:
        assert _ulps(got, want) <= 2
    else:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got_acc, want_acc, rtol=1e-5, atol=1e-6)
    if code == RC.U_ALIVE:  # the clear lands before both sums
        assert got_acc[1] == float(got_alive.sum()) and got_acc[2] == 0.0


# -- the programs of chip_smoke.py's plans -----------------------------------


def _plans():
    """``{name: plan}`` of chip_smoke.py's kernel 1i plans, planned on the
    CPU at 2**10 photons."""
    import chip_smoke as cs

    sims = {case: cs.user_plan_sim(T, case, "cpu", n=N, chunk=16)
            for case in cs.USER_PLANS if case != "fluor-callable"}
    sims["user-path"] = cs.user_sim(T, N, "cpu", iters=16, chunk=16)[0]
    sims["spectrum-path"] = cs.spectrum_sim(T, N, "cpu", iters=16)[0]
    for case in cs.OPS_PLANS:  # the widened table's op groups
        if case != "ops-strings":
            sims[case] = cs.ops_plan_sim(T, case, "cpu", n=N, chunk=16)
    sims["lattice-path"] = cs.lattice_sim(T, N, "cpu", iters=16,
                                          chunk=16)[0]
    sims["voxel-index-path"] = cs.voxel_sim(T, N, "cpu", iters=16,
                                            chunk=16)[0]
    return {name: cs.planned(sim)[1].plan for name, sim in sims.items()}


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """The plans' user programs in one host library; their binned reduces
    (``binned_c``, the histogram tallies) in another
    (``test_torch_binned.host_library``)."""
    from test_torch_binned import host_library

    plans = _plans()
    progs, binned = {}, {}
    for name, plan in plans.items():
        for i, op in CG.user_ops(plan):
            key = f"{name.replace('-', '_')}_{i}"
            if op.bins is None:
                progs[key] = op.prog
            else:
                binned[key] = (plan, i)
    return (_host_library(progs, str(tmp_path_factory.mktemp("plans"))),
            progs, plans,
            host_library(binned, str(tmp_path_factory.mktemp("binned"))))


def _plan_inputs(plan, seed):
    """(23, N) planes for a plan's programs: positions within 100 c dt,
    directions at c, energies log-uniform over the spectrum's edges and
    beyond, weights in (0.2, 1), the extras in (-1, 1) but an otype plane
    of photon (1) and charged (0) codes; ~80% alive."""
    rng = np.random.default_rng(seed)
    c = float(T.light.c)
    p = np.zeros((23, N), np.float32)
    p[0:3] = rng.uniform(-100, 100, (3, N)) * c * 1e-3
    p[3:6] = rng.normal(size=(3, N)) * c * 1e-3
    d = rng.normal(size=(3, N))
    p[6:9] = d / np.linalg.norm(d, axis=0) * c
    p[9:12] = rng.normal(size=(3, N)) * 1e3
    p[12] = np.exp(rng.uniform(-3.5, 4.5, N))
    alive = rng.uniform(size=N) < 0.8
    p[13] = alive
    p[14] = rng.uniform(0.2, 1.0, N)
    p[15:15 + len(plan.extras)] = rng.uniform(-1, 1, (len(plan.extras), N))
    if "otype" in plan.extras:
        p[15 + plan.extras.index("otype")] = rng.integers(0, 2, N)
    return p, alive


@pytest.mark.parametrize("name", [
    "custom", "custom-draws", "custom-extras", "reduce-n", "mesh-x-path",
    "mesh-r-weighted", "kstate-mixed", "reduce-weighted", "past-limits",
    "user-path", "spectrum-path", "ops-libm", "ops-binary",
    "ops-composite", "lattice-path", "ops-typed", "ops-special",
    "voxel-index-path"])
def test_plan_programs_match_plain_version(plan_lib, name):
    lib, progs, plans, binned_lib = plan_lib
    plan = plans[name]
    idx0 = 0
    for i, op in CG.user_ops(plan):
        key = f"{name.replace('-', '_')}_{i}"
        planes, alive = _plan_inputs(plan, seed=i)
        if op.bins is not None:
            _check_binned(binned_lib, key, op, planes, alive)
            continue
        got, got_alive, got_acc = _run_host(lib, key, planes, alive, idx0)
        want, want_alive, want_acc = _run_twin(progs[key], planes, alive,
                                               idx0)
        assert np.array_equal(got_alive, want_alive), key
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want)
                      + 1e-6 * scale), key
        np.testing.assert_allclose(got_acc, want_acc, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        idx0 += op.prog.n_draws


def _check_binned(lib, key, op, planes, alive):
    """A binned reduce's generated function (``binned_c``) against the
    plain version (``record.run_binned``): each slot's column equal,
    counts exactly, sums within rtol 1e-5."""
    from test_torch_binned import run_host

    cols, sums = run_host(lib, key, planes, alive)
    f = [torch.from_numpy(p.copy()) for p in planes]
    al = torch.from_numpy(alive.copy())
    f[13] = al.float()
    out = RC.run_field(op.prog, f, 1 + (not op.bins.count))
    coord = out if op.bins.count else out[0]
    want = RC.bin_columns(coord, al, torch.tensor(op.bins.edges),
                          op.bins.underflow, op.bins.overflow)
    assert np.array_equal(cols, want.numpy()), key
    row = torch.zeros(128)
    RC.run_binned(op.bins, op.prog, f, al, row)
    nc, c0 = op.bins.n_cols, op.cols[1]
    if op.bins.count:
        assert np.array_equal(sums[c0:c0 + nc], row[:nc].double().numpy())
    else:
        np.testing.assert_allclose(sums[c0:c0 + nc], row[:nc].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


# -- the generated translation unit and its build key -------------------------


def _user_plan(fn=None, seed=0):
    """The plan of the user path's steps with ``fn`` as its ElementwiseStep
    (default: chip_smoke.py's decay), planned on the CPU."""
    import chip_smoke as cs

    sim, _ = cs.user_sim(T, 256, "cpu", iters=16, chunk=16, seed=seed)
    if fn is not None:
        step = next(s for s in sim._ordered_steps()
                    if isinstance(s, T.ElementwiseStep))
        step.fn = fn
    return cs.planned(sim)[1].plan


def test_source_is_deterministic_and_keyed():
    a, b = _user_plan(), _user_plan(seed=3)
    src = CG.form_source(a)
    assert src == CG.form_source(b)
    assert _build.plan_key(src) == _build.plan_key(CG.form_source(b))
    assert "#define PHYSICL_FORM 1\n" in src
    assert '#include "fused_transport.cu"' in src
    for i, _ in CG.user_ops(a):
        assert (f"std::integral_constant<int, {i}>" in src
                and f"user_op_{i}(f, x, alive" in src)
    # another program
    import chip_smoke as cs

    def decay2(p):
        return cs.decay(p) | {"E": p.E * 0.5}

    other = CG.form_source(_user_plan(decay2))
    assert other != src and _build.plan_key(other) != _build.plan_key(src)
    # another form of the same programs (stream planes)
    streamed = dataclasses.replace(a, n_stream=1, _cache={})
    assert CG.plan_form(streamed)["kStream"] == 1
    assert CG.plan_form(a)["kStream"] == 0
    assert _build.plan_key(CG.form_source(streamed)) != _build.plan_key(src)


def test_build_key_follows_the_csrc_sources(tmp_path, monkeypatch):
    src = CG.form_source(_user_plan())
    key = _build.plan_key(src)
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", str(copy))
    assert _build.plan_key(src) == key
    with open(copy / "fused_transport.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.plan_key(src) != key


def test_literals_are_exact():
    """Every float32 constant round-trips through its C spelling."""
    for v in (1.5, -0.0, 0.1, -3.25e-30, 3.4028234663852886e38, 1e-45):
        text = CG._lit(v)
        assert float.fromhex(text.strip("()").rstrip("f")) == float(
            np.float32(v))
        assert text.startswith("(") == (np.copysign(1.0, v) < 0)
    assert CG._lit(float("inf")) == "__int_as_float(0x7f800000)"
    assert CG._lit(float("nan")) == "__int_as_float(0x7fc00000)"


# -- building a plan's library (a stand-in compiler on the CPU) ------------------

_STUB = r"""
extern "C" int fused_transport_plan_dims(int* d) {
  const int dims[4] = {PLAN_DIMS};
  for (int i = 0; i < 4; ++i) d[i] = dims[i];
  return PLAN_SIZE;
}
extern "C" int fused_transport_grid(long long, int, int, int, int, int* g) {
  *g = 1;
  return 0;
}
extern "C" int fused_transport_launch() { return 0; }
"""


def _fake_nvcc(tmp, fail=False, plan=None):
    """A stand-in for ``nvcc`` that logs each call and copies a host stub
    library (the C interface, the Plan's sizes: ``plan``'s) to its ``-o``
    path, or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    ps = type(F._plan_struct(plan, torch.device("cpu"))[0]) if plan \
        else _build.plan_struct_type(_build.MAIN_PLAN_DIMS)
    stub = os.path.join(tmp, "stub.cpp")
    with open(stub, "w") as f:
        f.write(_STUB.replace("PLAN_SIZE", str(ctypes.sizeof(ps))).replace(
            "PLAN_DIMS", ", ".join(map(str, ps.dims))))
    so = os.path.join(tmp, "libstub.so")
    subprocess.run([gxx, "-shared", "-fPIC", "-o", so, stub], check=True)
    script = os.path.join(tmp, "nvcc")
    body = ('echo "error: the stand-in fails"; exit 2' if fail else
            f'cp {so} "$out"; echo "ptxas info    : Used 42 registers"')
    with open(script, "w") as f:
        f.write("#!/bin/sh\n"
                f'echo "$@" >> {tmp}/calls\n'
                'out=""; prev=""\n'
                'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
                'prev="$a"; done\n' + body + "\n")
    os.chmod(script, 0o755)
    return script


def _fresh_build_dir(monkeypatch, tmp, nvcc):
    monkeypatch.setenv("NVCC", nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", os.path.join(tmp, "_build"))
    for name in ("_plan_libs", "_jobs", "plan_builds"):
        monkeypatch.setattr(_build, name, {})


def test_plan_library_builds_once_and_loads(tmp_path, monkeypatch):
    """The generated source goes to ``_build/`` under its key, one
    compiler run builds the library (renamed into place from a file of
    its own), its seconds and log are kept, and the same source loads
    from the cache in the process and from the file after."""
    tmp = str(tmp_path)
    _fresh_build_dir(monkeypatch, tmp, _fake_nvcc(tmp, plan=_user_plan()))
    src = CG.form_source(_user_plan())
    key = _build.plan_key(src)
    _build.start_plan_builds({"user": src, "again": src})
    lib = _build.load_plan(src, "user")
    assert lib is _build.load_plan(src, "user")
    assert os.path.basename(lib._name) == f"libfused_plan_{key}.so"
    with open(os.path.join(_build.BUILD_DIR, f"fused_plan_{key}.cu")) as f:
        assert f.read() == src
    assert not [n for n in os.listdir(_build.BUILD_DIR) if ".tmp" in n]
    built = _build.plan_builds[key]
    assert built["label"] == "user" and built["seconds"] > 0
    assert "42 registers" in built["log"]
    monkeypatch.setattr(_build, "_plan_libs", {})
    _build.load_plan(src, "user")  # from the file: no second compile
    with open(tmp_path / "calls") as f:
        calls = f.read().splitlines()
    assert len(calls) == 1 and "-I" in calls[0] and "--fmad=false" in calls[0]


def test_failed_plan_build_raises_naming_the_plan(tmp_path, monkeypatch):
    tmp = str(tmp_path)
    _fresh_build_dir(monkeypatch, tmp, _fake_nvcc(tmp, fail=True))
    plan = _user_plan()
    with pytest.raises(RuntimeError, match=r"nvcc failed \(2\) for the "
                       r"plan \[kin,iso,kstate,custom,reduce\]:\n"
                       r"error: the stand-in fails"):
        F._library(plan)
    assert not os.path.exists(_build.plan_path(
        _build.plan_key(CG.form_source(plan))))


# -- the expression fields -----------------------------------------------------

_FIELD_HARNESS = r"""
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#include "typed.cuh"
inline float __int_as_float(uint32_t b) {
  float v;
  std::memcpy(&v, &b, 4);
  return v;
}
// CUDA's correctly rounded fused multiply-add (U_FMA): the C library's
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float nan_min(float a, float b) {
  return (std::isnan(a) || std::isnan(b)) ? a + b : fminf(a, b);
}
inline float nan_max(float a, float b) {
  return (std::isnan(a) || std::isnan(b)) ? a + b : fmaxf(a, b);
}
inline float ipow(float x, int y) {
  if (y == 0) return 1.0f;
  const bool neg = y < 0;
  unsigned u = neg ? (unsigned)(-y) : (unsigned)y;
  float acc = 0.0f;
  bool have = false;
  while (u) {
    if (u & 1u) {
      acc = have ? acc * x : x;
      have = true;
    }
    u >>= 1;
    if (u) x = x * x;
  }
  return neg ? 1.0f / acc : acc;
}
// the runtime Plan's field constants
struct Plan {
  const float* fk;
};
"""


def _field_library(specs: dict, tmp):
    """``g++``-built shared library of ``{name: expression field spec}``:
    ``run_<name>(n, a, b, c, fk, out)`` evaluates the emitted function at
    every point, its constants from ``fk``, its outputs into ``out``
    ((n_out, n))."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    parts = [_FIELD_HARNESS]
    for name, spec in specs.items():
        parts.append(CG.field_c(spec, f"field_{name}", 0))
        call = ("out[g] = field_{0}(p, a[g], b[g], c[g]);"
                if spec["n_out"] == 1 else
                "float o[3]; field_{0}(p, a[g], b[g], c[g], o); "
                "for (int j = 0; j < 3; ++j) out[j * n + g] = o[j];")
        parts.append(
            f'extern "C" void run_{name}(int n, const float* a, '
            "const float* b, const float* c, const float* fk, float* out) "
            "{ Plan p{fk}; for (int g = 0; g < n; ++g) { "
            + call.format(name) + " } }")
    src = os.path.join(tmp, "fields.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts))
    so = os.path.join(tmp, "libfields.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", CSRC, "-o", so, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(so)


def _field_both(lib, name, spec, pts):
    """(host outputs, plain outputs), each (n_out, n) float32, of field
    ``name`` at the points ``pts`` ((3, n) float32)."""
    from physicl_tpu_torch.ops import fields as FL

    n = pts.shape[1]
    fk = np.array(FL.field_layout(spec)[1] or [0.0], np.float32)
    out = np.zeros((spec["n_out"], n), np.float32)
    pts = np.ascontiguousarray(pts, np.float32)
    vp = ctypes.c_void_p
    getattr(lib, f"run_{name}")(
        ctypes.c_int(n), vp(pts[0].ctypes.data), vp(pts[1].ctypes.data),
        vp(pts[2].ctypes.data), vp(fk.ctypes.data), vp(out.ctypes.data))
    args = [torch.from_numpy(pts[i].copy())
            for i in range(len(spec["vars"]))]
    want = RC.run_field(spec["prog"], args, spec["n_out"])
    want = torch.stack(list(want)) if spec["n_out"] > 1 else want[None]
    return out, want.numpy()


def _field_code_spec(case):
    """A field around the instruction ``case`` (a ``U_*`` name a field can
    use, or the select's immediate form, or three outputs) over (a, b, c)
    = (x, y, z)."""
    from physicl_tpu_torch.ops import fields as FL

    ld = lambda d, v: (RC.U_LD, d, 0, 0, v, False)  # noqa: E731
    st = lambda a, j=0: (RC.U_ST, 0, a, 0, j, False)  # noqa: E731
    n_out = 1
    if case == "U_SEL-imm":
        ins = [ld(0, 0), ld(1, 1), (RC.U_LT, 2, 0, 1, 0, False),
               (RC.U_SEL, 3, 2, 1, -2.5, True), st(3)]
    elif case == "three-outputs":
        ins = [ld(0, 0), ld(1, 1), ld(2, 2), (RC.U_MUL, 3, 0, 1, 0, False),
               (RC.U_ADD, 4, 3, 2, 0, False), (RC.U_CONST, 5, 0, 0, 0.5,
                                               False),
               st(4, 0), st(5, 1), st(0, 2)]
        n_out = 3
    elif case in _TYPED_CASES or _CODES[case] in _TYPED_CODES:
        code, t = _TYPED_CASES.get(case, (_CODES.get(case), RC.I32))
        return FL.expr_field(_field_typed_program(code, t),
                             ("r0", "r1", "r2"), case).spec
    elif _CODES[case] in _LOOP_CODES:
        return FL.expr_field(_loop_program(_CODES[case], field=True),
                             ("r0", "r1", "r2"), case, n_out=3).spec
    else:
        code = _CODES[case]
        if code == RC.U_SEL:
            ins = [ld(0, 0), ld(1, 1), (RC.U_LT, 2, 0, 1, 0, False),
                   (RC.U_SEL, 3, 2, 0, 1, False), st(3)]
        elif code == RC.U_FMA:  # a register addend, an immediate one
            ins = [ld(0, 0), ld(1, 1), ld(2, 2),
                   (RC.U_FMA, 3, 0, 1, 2, False),
                   (RC.U_FMA, 4, 3, 0, 0.5, True), st(4)]
        elif code == RC.U_LD:
            ins = [ld(0, 2), st(0)]
        elif code in (RC.U_CONST, RC.U_ST):
            ins = [(RC.U_CONST, 0, 0, 0, -3.25e-30, False), st(0)]
        elif code == RC.U_IPOW:
            ins = [ld(0, 0), (RC.U_IPOW, 1, 0, 0, -3, False),
                   (RC.U_IPOW, 2, 0, 0, 7, False),
                   (RC.U_ADD, 3, 1, 2, 0, False), st(3)]
        elif code in CG._UNARY:
            ins = [ld(0, 0), (RC.U_SUB, 1, 0, 0, 1.0, True),
                   (code, 2, 1 if code not in _POSITIVE else 0, 0, 0,
                    False), st(2)]
        else:  # a binary operation: a register and an immediate operand
            ins = [ld(0, 0), ld(1, 1), (code, 2, 0, 1, 0, False),
                   (code, 3, 2, 0, 1.0, True), st(3)]
    prog = RC.Program(tuple(ins), 6, 0)
    return FL.expr_field(prog, ("r0", "r1", "r2"), case,
                         n_out=n_out).spec


def _field_typed_program(code, t) -> RC.Program:
    """A field around ``code`` of type ``t`` over (a, b): the operation of
    two values from the variables' bits (``_typed_operands``' kinds) and
    of a value and a constant of each typed slot (an int32 past 2**24, an
    int64 past 2**32, a float64 no float32 holds), folded by xor into one
    int32 whose bits are the output."""
    p = _Typed()
    x, y = (p.add(RC.U_LD, RC.F32, y=k) for k in (0, 1))
    i32 = lambda v: p.add(RC.U_BITCAST, RC.I32, v, y=RC.I32)  # noqa: E731
    ia, ib = i32(x), i32(y)
    la = p.add(RC.U_MUL, RC.I64, p.add(RC.U_CVT, RC.I64, ia, y=RC.I64),
               p.add(RC.U_CVT, RC.I64, ib, y=RC.I64))
    da = p.add(RC.U_DIV, RC.F64, p.add(RC.U_CVT, RC.F64, x, y=RC.F64),
               y=0.1, bimm=True)
    a = {RC.I32: ia, RC.I64: la, RC.F64: da}[t]
    imm = {RC.I32: (1 << 24) + 3, RC.I64: -(1 << 40) - 5,
           RC.F64: 1.0 / 3.0}[t]
    ints = t in RC.INT_BITS
    if code in (RC.U_SHL, RC.U_SHR):
        vals = [p.add(code, t, a, y=k, bimm=True) for k in (
            3, RC.INT_BITS[t] - 1, RC.INT_BITS[t])]
    elif code in (RC.U_BNOT, RC.U_NEG, RC.U_ABS, RC.U_SQRT, RC.U_EXP):
        vals = [p.add(code, t, a)]
    elif code == RC.U_CVT:
        big = p.add(RC.U_MUL, RC.F32, x, y=1e10, bimm=True)
        vals = [p.add(RC.U_CVT, RC.I32, big, y=RC.I32),
                p.add(RC.U_CVT, RC.I64, big, y=RC.I64),
                p.add(RC.U_CVT, RC.I32, da, y=RC.I32),
                p.add(RC.U_CVT, RC.F32, la, y=RC.F32)]
    elif code == RC.U_BITCAST:
        vals = [p.add(RC.U_BITCAST, RC.I64, da, y=RC.I64)]
    elif code == RC.U_SEL:
        c = p.add(RC.U_LT, RC.F32, x, y)
        vals = [p.add(code, t, c, a, imm, True)]
    elif code in (RC.U_LT, RC.U_EQ):
        vals = [p.add(code, RC.F32, a, y=imm, bimm=True)]
    elif code in (RC.U_DIV, RC.U_FMOD) and ints:
        vals = [p.add(code, t, a, y=imm, bimm=True)]
    else:
        vals = [p.add(code, t, a, y=imm, bimm=True),
                p.add(RC.U_CONST, t, y=imm)]
    acc = p.add(RC.U_CONST, RC.I32, y=0)
    for v in vals:
        vt = p.types[v]
        if vt == RC.F32:
            v = i32(v)
        elif vt == RC.F64:
            v = p.add(RC.U_BITCAST, RC.I64, v, y=RC.I64)
            vt = RC.I64
        if vt == RC.I64:
            v = p.add(RC.U_BXOR, RC.I32, p.add(RC.U_CVT, RC.I32, v, y=RC.I32),
                      p.add(RC.U_CVT, RC.I32, p.add(RC.U_SHR, RC.I64, v, y=32,
                                                    bimm=True), y=RC.I32))
        acc = p.add(RC.U_BXOR, RC.I32, acc, v)
    p.ins.append((RC.U_ST, 0, p.add(RC.U_BITCAST, RC.F32, acc, y=RC.F32),
                  0, 0, False))
    p.types.append(RC.F32)
    return p.program()


_FIELD_CODES = sorted(name for name, code in _CODES.items() if code not in (
    RC.U_T, RC.U_DT, RC.U_UNIF, RC.U_ALIVE, RC.U_ACC)) + [
        "U_SEL-imm", "three-outputs"] + sorted(
            k for k in _TYPED_CASES if _TYPED_CASES[k][0] in (
                RC.U_ADD, RC.U_MUL, RC.U_SUB, RC.U_MIN, RC.U_DIV, RC.U_FMOD,
                RC.U_SEL, RC.U_LT, RC.U_SHL, RC.U_SQRT, RC.U_EXP))


@pytest.fixture(scope="module")
def field_code_lib(tmp_path_factory):
    specs = {case.replace("-", "_"): _field_code_spec(case)
             for case in _FIELD_CODES}
    return (_field_library(specs, str(tmp_path_factory.mktemp("fcodes"))),
            specs)


@pytest.mark.parametrize("case", _FIELD_CODES)
def test_field_instruction_matches_plain_version(field_code_lib, case):
    lib, specs = field_code_lib
    name = case.replace("-", "_")
    planes, _ = _inputs(seed=3)
    pts = planes[[0, 12, 1]]
    got, want = _field_both(lib, name, specs[name], pts)
    if case == f"U_EXP-{RC.F64}":  # glibc's and torch's float64 exp
        assert np.mean(got.view(np.int32) == want.view(np.int32)) > 0.5
    elif _CODES.get(case) in _TRANSCENDENTAL:
        assert _ulps(got, want) <= 2
    else:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _smoke_fields():
    """``{name: spec}``: chip_smoke.py's recorded fields (the mirror's
    B(r), the crossed E and B, the two inverse CDFs) and wide_sim's
    strings, recorded and compiled as the prover does."""
    import chip_smoke as cs

    R = ("r0", "r1", "r2")
    E, B = cs.crossed_EB(torch)
    specs = {
        "mirror_B": RC.record_field(cs.mirror_B, R, "B", ncomp=3).spec,
        "crossed_E": RC.record_field(E, R, "E", ncomp=3).spec,
        "crossed_B": RC.record_field(B, R, "B", ncomp=3).spec,
        "linear_icdf": RC.record_field(cs.linear_icdf, ("u",), "u").spec,
        "hg_icdf": RC.record_field(cs.hg_icdf, ("u",), "u").spec}
    plan = cs.planned(cs.wide_sim(T, N, "cpu", chunk=16))[1].plan
    for j, sp in CG.expr_fields(plan):
        specs[f"wide_{j}"] = sp
    assert sum(k.startswith("wide") for k in specs) == 9
    # the string grammar's constructs (the strings plan's fields) and the
    # lattice path's checkerboard
    plan = cs.planned(cs.ops_plan_sim(T, "ops-strings", "cpu", n=N,
                                      chunk=16))[1].plan
    for j, sp in CG.expr_fields(plan):
        specs[f"strings_{j}"] = sp
    assert sum(k.startswith("strings") for k in specs) == 11
    plan = cs.planned(cs.lattice_sim(T, N, "cpu", iters=16,
                                     chunk=16)[0])[1].plan
    specs["lattice_n"] = CG.expr_fields(plan)[0][1]
    assert all(sp["kind"] == "expr" and sp["error"] is None
               for sp in specs.values())
    return specs


@pytest.fixture(scope="module")
def smoke_field_lib(tmp_path_factory):
    torch.set_num_threads(1)
    specs = _smoke_fields()
    return (_field_library(specs, str(tmp_path_factory.mktemp("sfields"))),
            specs)


@pytest.mark.parametrize("name", [
    "mirror_B", "crossed_E", "crossed_B", "linear_icdf", "hg_icdf",
    *[f"wide_{j}" for j in range(9)], *[f"strings_{j}" for j in range(11)],
    "lattice_n"])
def test_smoke_fields_match_plain_version(smoke_field_lib, name):
    """Each field at 2**10 seeded points (positions within 100 c dt, draws
    in [0, 1), energies in (0.5, 3)): within 1e-6 of each value plus 1e-6
    of the output's largest."""
    lib, specs = smoke_field_lib
    spec = specs[name]
    rng = np.random.default_rng(11)
    c_dt = float(T.light.c) * 1e-3
    if spec["vars"] == ("u",):
        pts = np.zeros((3, N), np.float32)
        pts[0] = rng.uniform(0, 1, N)
    elif spec["vars"] == ("E",):
        pts = np.zeros((3, N), np.float32)
        pts[0] = rng.uniform(0.5, 3.0, N)
    else:
        pts = (rng.uniform(-100, 100, (3, N)) * c_dt).astype(np.float32)
        if name.startswith(("mirror", "crossed")):
            pts = rng.normal(size=(3, N)).astype(np.float32)
    got, want = _field_both(lib, name, spec, pts)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-6 * scale)
