"""Kernel 1i's programs and the recorded fields: a user's torch callable
recorded once, at plan time, into an elementwise register program that
:mod:`physicl_tpu_torch.ops.codegen` compiles per plan into straight-line
CUDA C for ``csrc/fused_transport.cu`` (the ops ``custom``, ``reduce`` and
``kstate``, and a field callable: :func:`record_field`) and
:func:`run_user_program` / :func:`run_field`, the plain versions, run with
float32 torch ops.

Counterpart of the JAX package's tracing of the same callables into its
fused kernel (``physicl_tpu/ops/fused.py:1448-1569``) and of its plan-time
probes (``physicl_tpu/ops/pipeline.py:_probe_kernelstep``,
``_probe_particle_fn``), whose behavioural checks become structural ones
here. The callable is traced with ``make_fx`` in fake mode over per-particle
inputs of two lengths, and the aten graph is translated:

* a value is a float32, an int32, an int64, a float64 or a bool per
  particle (a bool held as float32 0.0 / 1.0), with 1 or 3 components (the
  ``KernelStep`` facade's ``r``, ``dr``, ``v`` and ``dv``); a scalar
  (``t``, ``dt``, a constant) has 1 component. Each SSA value has its
  type (:data:`F32`, :data:`I32`, :data:`I64`, :data:`F64`), the C
  declaration and the twin's torch dtype follow it. An operation takes its
  operands in torch's promoted dtype: ``.int()`` int32, ``.long()`` and
  a Python int int64, ``.double()`` float64; integer ``+ - * neg abs min
  max``, ``& | ^ ~`` and the compares stay in the integer type and wrap
  in two's complement, ``<<`` and ``>>`` give 0 or the sign past the
  width (as torch and XLA), ``//`` and ``%`` by a nonzero constant are
  exact (``//`` by a value that may be 0 is refused: XLA's result is
  implementation-defined); a float converts to an integer truncated,
  saturating, NaN 0 (``cvt.rzi``), an integer to a float rounded to
  nearest; a plane store and a record sum round once to float32.
  Operations over the component axis (``x[0]``, ``unbind``, ``stack``,
  ``sum(0)``, ``amax(0)``, ``linalg.norm(dim=0)``) are elementwise per
  particle;
* an operation over the particle axis (a reduction, an index or gather,
  ``roll``, ``flip``, ``cat`` along particles, a value that depends on the
  particle count) is refused as ``not-elementwise``; an aten operation
  outside the table as ``op-unsupported``, by name; Python control flow on
  a value (which a fake tensor cannot decide) as ``trace``;
* ``p.uniform()`` is the op's draw ``i`` in Python call order, hashed at the
  op's first draw index plus ``i``; a draw that is never used still counts,
  as in JAX. The recorder's placeholder for the draws is sized to the
  callable (a callable that draws more than it holds is recorded again with
  one row a draw). ``t`` and ``dt`` are inputs: the program reads the schedule
  row of the op's place relative to ``UpdateTimeStep``;
* a Python scalar takes the tensor's type where it meets one (a float32
  rounded once: JAX's weak types); an integer exponent is ``lax.integer_pow``'s repeated products, an
  exponent of 0.5 a square root (torch's ``pow``), any other ``powf``; a
  tensor divided by a tensor or a scalar is a division, a scalar divided by
  a tensor is torch's ``reciprocal(x) * c``; bool times float is 0.0 or the
  float, as in torch.

The instruction table is jnp's elementwise float32 functions. Group A, an
instruction each, a CUDA libm function in the kernel and torch's own op
on the card in the twin (the same function there): ``atan``, ``asin``,
``acos``, ``atan2``, ``sinh``, ``cosh``, ``tanh``, ``asinh``, ``acosh``,
``atanh``, ``exp2``, ``expm1``, ``log2``, ``log1p``, ``erf``, ``erfc``,
``lgamma``, ``fmod``, ``round`` (``rintf``), ``copysign``, ``nextafter``,
``isnan``, ``signbit``, and ``rsqrt`` as ``1.0f / sqrtf``. Group B,
lowered to the instructions in the order of the jnp function it stands
for (:func:`_lower`): ``remainder`` / ``%`` and ``floor_divide`` / ``//``
/ ``div(rounding_mode=)`` (``lax.rem``, then the sign fix), ``sign``,
``frac``, ``sigmoid``, ``silu``, ``relu``, ``softplus``, ``logaddexp``,
``xlogy``, ``special.xlog1py``, ``hypot``, ``fmax`` / ``fmin``, ``lerp``,
``addcmul`` / ``addcdiv``, ``add`` / ``sub`` with ``alpha``,
``heaviside``, ``nan_to_num``, ``isinf``, ``deg2rad`` / ``rad2deg``,
``special.ndtr`` (jnp's form, taken before torch decomposes it),
``sinc``, ``logit`` and ``erfinv`` (XLA's polynomial). Group C, lowered
the same way (:func:`_lower_special`): ``digamma`` / ``special.psi`` and
``polygamma`` of a Python int (XLA's Lanczos form and Hurwitz-zeta
series), ``special.zeta``, ``special.i0`` / ``i0e`` / ``i1`` / ``i1e`` /
``modified_bessel_i0`` / ``i1`` (Cephes' float32 Chebyshev series),
``special.ndtri``, ``log_ndtr`` and ``entr``, ``mvlgamma``,
``logaddexp2``, ``ldexp`` and ``frexp`` (jnp's bits), and ``F.gelu``
(both forms), ``F.elu`` and ``F.logsigmoid`` (``jax.nn``'s); in float64
the ones whose form is float32's (coefficient tables) are refused. Refused
as ``op-unsupported`` naming the op, with no jnp counterpart this
straight-line program can run: ``special.gammainc`` / ``gammaincc``
(jnp's ``while_loop``), ``special.bessel_j0`` / ``j1`` (jnp's
recurrence), ``special.erfcx`` and torch-only functions such as
``bessel_y0`` and ``modified_bessel_k0`` (no jnp function).

The program is register code over per-component SSA values: common
subexpressions merged, unused values dropped, the side effects (plane
stores, alive clears, float record sums) kept in order, and registers
assigned by liveness. Its length, registers and draws have no limit: each
plan's programs are compiled for it.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# instruction codes (ops/codegen.py turns each into C); the libm codes
# from U_ATAN on came after the first 41, whose numbers stay as they were
(U_LD, U_T, U_DT, U_CONST, U_UNIF, U_NEG, U_ABS, U_SQRT, U_EXP, U_LOG,
 U_LOG10, U_SIN, U_COS, U_TAN, U_FLOOR, U_CEIL, U_TRUNC, U_RECIP, U_NOT,
 U_BOOL, U_IPOW, U_ADD, U_SUB, U_MUL, U_DIV, U_POW, U_MIN, U_MAX, U_LT, U_LE,
 U_GT, U_GE, U_EQ, U_NE, U_AND, U_OR, U_XOR, U_SEL, U_ST, U_ALIVE,
 U_ACC, U_ATAN, U_ASIN, U_ACOS, U_SINH, U_COSH, U_TANH, U_ASINH, U_ACOSH,
 U_ATANH, U_EXP2, U_EXPM1, U_LOG2, U_LOG1P, U_ERF, U_ERFC, U_LGAMMA,
 U_RSQRT, U_ROUND, U_ISNAN, U_SIGNBIT, U_ATAN2, U_FMOD, U_COPYSIGN,
 U_NEXTAFTER, U_CVT, U_BAND, U_BOR, U_BXOR, U_BNOT, U_SHL, U_SHR,
 U_BITCAST) = range(73)
ALIVE_PLANE = 13
# value types: float32 (a bool too, as 0.0 / 1.0), int32, int64, float64
F32, I32, I64, F64 = "f", "i", "l", "d"
DTYPES = {F32: torch.float32, I32: torch.int32, I64: torch.int64,
          F64: torch.float64}
INT_BITS = {I32: 32, I64: 64}
DRAW_ROWS = 64   # rows of the draws placeholder, unless a callable draws more

_UNARY = {"neg": U_NEG, "abs": U_ABS, "sqrt": U_SQRT, "exp": U_EXP,
          "log": U_LOG, "log10": U_LOG10, "sin": U_SIN, "cos": U_COS,
          "tan": U_TAN, "floor": U_FLOOR, "ceil": U_CEIL, "trunc": U_TRUNC,
          "reciprocal": U_RECIP, "atan": U_ATAN, "asin": U_ASIN,
          "acos": U_ACOS, "sinh": U_SINH, "cosh": U_COSH, "tanh": U_TANH,
          "asinh": U_ASINH, "acosh": U_ACOSH, "atanh": U_ATANH,
          "exp2": U_EXP2, "expm1": U_EXPM1, "log2": U_LOG2,
          "log1p": U_LOG1P, "erf": U_ERF, "erfc": U_ERFC,
          "lgamma": U_LGAMMA, "rsqrt": U_RSQRT}
_BINARY = {"add": U_ADD, "sub": U_SUB, "mul": U_MUL, "div": U_DIV,
           "true_divide": U_DIV, "minimum": U_MIN, "maximum": U_MAX,
           "lt": U_LT, "le": U_LE, "gt": U_GT, "ge": U_GE, "eq": U_EQ,
           "ne": U_NE, "bitwise_and": U_AND, "bitwise_or": U_OR,
           "bitwise_xor": U_XOR, "logical_and": U_AND, "logical_or": U_OR,
           "logical_xor": U_XOR, "atan2": U_ATAN2, "arctan2": U_ATAN2,
           "fmod": U_FMOD, "copysign": U_COPYSIGN,
           "nextafter": U_NEXTAFTER}
_COMMUTATIVE = {U_ADD, U_MUL, U_MIN, U_MAX, U_EQ, U_NE, U_AND, U_OR, U_XOR}
_FLIPPED = {U_LT: U_GT, U_GT: U_LT, U_LE: U_GE, U_GE: U_LE}
_COMPARES = {U_LT, U_LE, U_GT, U_GE, U_EQ, U_NE}
# the integers a float32 holds exactly
EXACT_F32 = 1 << 24
_LOGIC = {U_LT, U_LE, U_GT, U_GE, U_EQ, U_NE, U_AND, U_OR, U_XOR, U_NOT,
          U_BOOL, U_ISNAN, U_SIGNBIT}
# operations over the particle axis (refused when they reach it)
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
               "all", "var", "std", "norm", "linalg_vector_norm", "cumsum",
               "cumprod", "logsumexp", "argmax", "argmin", "median", "sort",
               "argsort", "topk", "var_mean", "std_mean", "count_nonzero"}
_GATHERS = {"index", "index_select", "gather", "take", "take_along_dim",
            "roll", "flip", "cat", "narrow", "slice", "arange", "nonzero",
            "masked_select", "scatter", "scatter_add", "index_put",
            "index_add", "masked_scatter", "repeat", "tile", "unfold",
            "diff", "permute", "transpose", "t", "flatten", "reshape",
            "view", "_unsafe_view", "unsqueeze", "squeeze",
            "split", "chunk", "split_with_sizes"}
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous",
             "positive"}
_SHIFTS = {"__lshift__", "__rshift__", "bitwise_left_shift",
           "bitwise_right_shift"}
_FACTORIES = {"scalar_tensor", "full", "zeros", "ones", "full_like",
              "zeros_like", "ones_like", "new_full", "new_zeros", "new_ones"}


class Refused(Exception):
    """A callable the recorder cannot turn into a kernel program:
    ``code`` is the refusal code's stem (the prover adds ``elementwise-``,
    ``reduce-`` or ``kernelstep-`` where the JAX package does), ``detail``
    what it found."""

    def __init__(self, code: str, detail: str):
        super().__init__(f"[{code}] {detail}")
        self.code = code
        self.detail = detail


def _f32(x) -> float:
    """``x`` rounded once to float32 (a Python scalar meeting a tensor)."""
    return float(np.float32(x))


def _bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def wrap_int(v: int, t: str) -> int:
    """``v`` in two's complement of type ``t`` (int32 or int64)."""
    n = INT_BITS[t]
    v &= (1 << n) - 1
    return v - (1 << n) if v >> (n - 1) else v


@dataclasses.dataclass(frozen=True)
class Program:
    """A recorded program: instructions ``(code, dst, a, b, y, bimm)`` with
    ``y`` an int (plane, draw, exponent, record column or the select's true
    register), the immediate of a ``bimm`` operand or a constant (a float,
    or an int of an integer type), or a conversion's target type; the
    registers and the draws it takes; ``types`` each instruction's value
    type (:data:`F32` ... :data:`F64`; empty: all float32)."""

    ins: tuple
    n_regs: int
    n_draws: int
    types: tuple = ()

    def stores(self) -> List[int]:
        return [y for code, *_, y, _ in self.ins if code == U_ST]

    def type_list(self) -> tuple:
        return self.types or (F32,) * len(self.ins)

    def typed(self) -> bool:
        """Whether a value is an integer or a float64."""
        return any(t != F32 for t in self.types)

    def operand_types(self) -> List[Tuple[str, Optional[str]]]:
        """Per instruction, the type of its operand ``a`` and of its
        constant (a ``U_CONST``'s value or a ``bimm`` operand: a select's
        has the select's type, a binary operation's its operand's), or
        None."""
        reg_t: Dict[int, str] = {}
        out = []
        for (code, d, a, _, _, bimm), t in zip(self.ins, self.type_list()):
            ta = reg_t.get(a, F32)
            imm = (t if code in (U_CONST, U_SEL) else ta) if (
                code == U_CONST or bimm) else None
            out.append((ta, imm))
            if code not in (U_ST, U_ALIVE, U_ACC):
                reg_t[d] = t
        return out


# -- SSA over scalar components -----------------------------------------------


class _SSA:
    """Per-component values: ``defs[vid] = (code, args, y)`` and
    ``ty[vid]`` its type; pure values are merged by key. Effects (stores,
    alive clears, record sums) are kept in order."""

    def __init__(self):
        self.defs: List[tuple] = []
        self.ty: List[str] = []
        self.memo: Dict[tuple, int] = {}
        self.effects: List[tuple] = []
        # an integer read from a plane (a float32 that holds an exact
        # integer, as the otype plane): its float32 load
        self.exact: Dict[int, int] = {}

    def result_type(self, code, args) -> str:
        """An instruction's type, from its operands': a compare, a logic
        op or a test is a bool (float32); a select has its values' type;
        a load, t, dt and a draw are float32; the rest their operand's."""
        if code in _LOGIC or not args:
            return F32
        return self.ty[args[1] if code == U_SEL else args[0]]

    def val(self, code, args=(), y=0, t=None) -> int:
        t = self.result_type(code, args) if t is None else t
        if isinstance(y, float):
            ky = (struct.pack("<d", y) if t == F64 and code == U_CONST
                  else _bits(y))
        else:
            ky = y
        key = (code, tuple(args), ky, t)
        vid = self.memo.get(key)
        if vid is None:
            vid = self.memo[key] = len(self.defs)
            self.defs.append((code, tuple(args), y))
            self.ty.append(t)
        return vid

    def const(self, x, t=F32) -> int:
        """A constant of type ``t``: a float32 rounds once, an integer
        wraps."""
        if t == F32:
            v = _f32(x)
        elif t == F64:
            v = float(x)
        else:
            v = wrap_int(int(x), t)
        return self.val(U_CONST, (), v, t)

    def like(self, a, x) -> int:
        """The constant ``x`` in ``a``'s type."""
        return self.const(x, self.ty[a])

    def is_const(self, vid) -> bool:
        return self.defs[vid][0] == U_CONST

    def plane_int(self, v, t) -> int:
        """The float32 load ``v`` of an integer plane as type ``t``."""
        c = self.cvt(v, t)
        self.exact[c] = v
        return c

    def float_of(self, a):
        """``a`` as an exact float32 (an integer plane's load, or a small
        integer constant), or None."""
        if a in self.exact:
            return self.exact[a]
        if self.is_const(a) and self.ty[a] in INT_BITS and abs(
                self.defs[a][2]) <= EXACT_F32:
            return self.const(float(self.defs[a][2]))
        return None

    def binary(self, code, a, b) -> int:
        if code in _COMPARES and (a in self.exact or b in self.exact):
            # an integer plane compared with another or a small constant:
            # the same answer from the float32 loads, with no conversion
            fa, fb = self.float_of(a), self.float_of(b)
            if fa is not None and fb is not None:
                a, b = fa, fb
        if self.is_const(a) and not self.is_const(b):
            if code in _COMMUTATIVE:
                a, b = b, a
            elif code in _FLIPPED:
                code, a, b = _FLIPPED[code], b, a
        return self.val(code, (a, b))

    def cvt(self, a, t) -> int:
        """``a`` converted to type ``t`` (a constant folded)."""
        if self.ty[a] == t:
            return a
        if t == F32 and a in self.exact:
            return self.exact[a]
        if self.is_const(a):
            v = _convert(torch.tensor([self.defs[a][2]],
                                      dtype=DTYPES[self.ty[a]]), t)
            return self.const(v.item(), t)
        return self.val(U_CVT, (a,), t, t)

    def op(self, code, *args) -> int:
        """An instruction of a lowered function (:func:`_lower`): a select
        on a constant condition is its branch, and an exact operation
        (:data:`_EXACT`) of constants is its constant, the value the kernel
        would compute bit for bit."""
        if code == U_SEL and self.is_const(args[0]):
            return args[1] if self.defs[args[0]][2] != 0 else args[2]
        if code in _EXACT and all(self.is_const(a) for a in args):
            regs = [torch.tensor([self.defs[a][2]],
                                 dtype=DTYPES[self.ty[a]]) for a in args]
            ins = ((U_SEL, 0, 0, 2, 1, False) if code == U_SEL
                   else (code, 0, 0, len(args) - 1, 0, False))
            t = self.result_type(code, args)
            v = _pure(ins, regs, lambda y, tt=F32: torch.tensor(
                [y], dtype=DTYPES[tt]), torch.ones(1), t)
            return self.const(v[0].item(), t)
        if len(args) == 2:
            return self.binary(code, *args)
        return self.val(code, args)


def _uses(code, args, ssa) -> List[int]:
    """The operands that need a register: operand b of a binary operation
    and the false value of a select may be a constant's immediate."""
    if code == U_SEL:
        cond, tv, fv = args
        return [cond, tv] + ([] if ssa.is_const(fv) else [fv])
    if len(args) == 2:
        return [args[0]] + ([] if ssa.is_const(args[1]) else [args[1]])
    return list(args)


# -- jnp's elementwise functions over the instructions ------------------------

# the codes whose value the twin computes bit for bit as the kernel does
# (IEEE operations, roundings, compares, selects): constants fold through
# them
_EXACT = {U_NEG, U_ABS, U_NOT, U_BOOL, U_ADD, U_SUB, U_MUL, U_DIV, U_MIN,
          U_MAX, U_LT, U_LE, U_GT, U_GE, U_EQ, U_NE, U_AND, U_OR, U_XOR,
          U_SEL, U_FLOOR, U_CEIL, U_TRUNC, U_ROUND, U_ISNAN, U_SIGNBIT,
          U_FMOD, U_COPYSIGN, U_SQRT, U_CVT, U_BAND, U_BOR, U_BXOR, U_BNOT,
          U_SHL, U_SHR, U_BITCAST}
_INF = float("inf")
_NAN = float("nan")
_F32_MAX = float(np.finfo(np.float32).max)
# XLA's erf_inv for float32 (M. Giles' single-precision approximation):
# the coefficients for w < 5, then for w >= 5
_ERFINV = ((2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
            -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941),
           (-0.000200214257, 0.000100950558, 0.00134934322,
            -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
            1.00167406, 2.83297682))


def _sign(s: _SSA, x: int) -> int:
    """``lax.sign``: 1, -1, or ``x`` itself (a zero keeps its sign, NaN
    stays NaN)."""
    z = s.like(x, 0)
    return s.op(U_SEL, s.op(U_GT, x, z), s.like(x, 1),
                s.op(U_SEL, s.op(U_LT, x, z), s.like(x, -1), x))


def _round_away(s: _SSA, x: int) -> int:
    """``lax.round`` (half away from zero): the truncation, plus the sign
    where the fraction (exact) is at least a half."""
    t = s.op(U_TRUNC, x)
    half = s.op(U_GE, s.op(U_ABS, s.op(U_SUB, x, t)), s.like(x, 0.5))
    return s.op(U_SEL, half, s.op(U_ADD, t, s.op(U_COPYSIGN, s.like(x, 1.0),
                                                 x)), t)


def _nonzero_divisor(s: _SSA, b: int) -> int:
    """An integer divisor that jnp replaces by 1 where it is 0."""
    if s.is_const(b) and s.defs[b][2] != 0:
        return b
    return s.op(U_SEL, s.op(U_EQ, b, s.like(b, 0)), s.like(b, 1), b)


def _remainder(s: _SSA, a: int, b: int, ints: bool = False) -> int:
    """``jnp.remainder``: ``lax.rem`` (fmodf, or the integer remainder),
    plus the divisor where the remainder is nonzero and its sign differs
    from the divisor's; an integer divisor of 0 reads 1."""
    if ints:
        b = _nonzero_divisor(s, b)
    z = s.like(a, 0)
    tm = s.op(U_FMOD, a, b)
    fix = s.op(U_AND, s.op(U_NE, s.op(U_LT, tm, z), s.op(U_LT, b, z)),
               s.op(U_NE, tm, z))
    return s.op(U_SEL, fix, s.op(U_ADD, tm, b), tm)


def _floor_divide(s: _SSA, a: int, b: int) -> int:
    """``jnp.floor_divide`` of floats (``_float_divmod``): ``(a - rem) /
    b``, less 1 where the remainder's sign differs from the divisor's,
    rounded half away from zero."""
    mod = s.op(U_FMOD, a, b)
    div = s.op(U_DIV, s.op(U_SUB, a, mod), b)
    ind = s.op(U_AND, s.op(U_NE, mod, s.like(a, 0.0)),
               s.op(U_NE, _sign(s, b), _sign(s, mod)))
    div = s.op(U_SEL, ind, s.op(U_SUB, div, s.like(a, 1.0)), div)
    return _round_away(s, div)


def _int_divide(s: _SSA, a: int, b: int, floor: bool) -> int:
    """Integer division by a nonzero constant ``b``: ``lax.div`` (towards
    zero; by -1 a negation, which wraps), and for ``jnp.floor_divide`` 1
    less where the signs differ and the remainder is nonzero."""
    if s.defs[b][2] == -1:
        return s.op(U_NEG, a)
    q = s.op(U_DIV, a, b)
    if not floor:
        return q
    ind = s.op(U_AND, s.op(U_NE, _sign(s, a), _sign(s, b)),
               s.op(U_NE, s.op(U_FMOD, a, b), s.like(a, 0)))
    return s.op(U_SEL, ind, s.op(U_SUB, q, s.like(a, 1)), q)


def _logaddexp(s: _SSA, a: int, b: int, base2: bool = False) -> int:
    """``jnp.logaddexp``: ``max + log1p(exp(-|a - b|))``, ``a + b`` where
    the difference is NaN; ``jnp.logaddexp2``: ``max + log1p(exp2(-|a -
    b|)) / ln 2``."""
    delta = s.op(U_SUB, a, b)
    tail = s.op(U_LOG1P, s.op(U_EXP2 if base2 else U_EXP,
                              s.op(U_NEG, s.op(U_ABS, delta))))
    if base2:
        tail = s.op(U_MUL, s.like(a, 1 / np.log(2)), tail)
    return s.op(U_SEL, s.op(U_ISNAN, delta), s.op(U_ADD, a, b),
                s.op(U_ADD, s.op(U_MAX, a, b), tail))


def _hypot(s: _SSA, a: int, b: int) -> int:
    """``jnp.hypot``: ``hi * sqrt(1 + (lo / hi)**2)`` of the magnitudes,
    ``hi`` where it is 0, inf where either is inf."""
    a, b = s.op(U_ABS, a), s.op(U_ABS, b)
    inf = s.like(a, _INF)
    is_inf = s.op(U_OR, s.op(U_EQ, a, inf), s.op(U_EQ, b, inf))
    hi, lo = s.op(U_MAX, a, b), s.op(U_MIN, a, b)
    zero = s.op(U_EQ, hi, s.like(a, 0.0))
    q = s.op(U_DIV, lo, s.op(U_SEL, zero, s.like(a, 1.0), hi))
    r = s.op(U_MUL, hi, s.op(U_SQRT, s.op(U_ADD, s.op(U_MUL, q, q),
                                          s.like(a, 1.0))))
    return s.op(U_SEL, is_inf, inf, s.op(U_SEL, zero, hi, r))


def _erfinv(s: _SSA, x: int) -> int:
    """XLA's ``erf_inv`` (``jax.scipy.special.erfinv``): ``w = -log1p(-x
    x)``, a polynomial of degree 8 in ``w - 2.5`` or ``sqrt(w) - 3``,
    times ``x``; ``x`` inf at |x| = 1."""
    w = s.op(U_NEG, s.op(U_LOG1P, s.op(U_MUL, x, s.op(U_NEG, x))))
    lt = s.op(U_LT, w, s.const(5.0))
    w = s.op(U_SEL, lt, s.op(U_SUB, w, s.const(2.5)),
             s.op(U_SUB, s.op(U_SQRT, w), s.const(3.0)))

    def coef(i):
        return s.op(U_SEL, lt, s.const(_ERFINV[0][i]),
                    s.const(_ERFINV[1][i]))

    p = coef(0)
    for i in range(1, len(_ERFINV[0])):
        p = s.op(U_ADD, coef(i), s.op(U_MUL, p, w))
    one = s.op(U_EQ, s.op(U_ABS, x), s.const(1.0))
    return s.op(U_SEL, one, s.op(U_MUL, x, s.const(_INF)),
                s.op(U_MUL, p, x))


def _sigmoid(s: _SSA, x: int) -> int:
    """``lax.logistic``: ``1 / (1 + exp(-x))``."""
    return s.op(U_DIV, s.like(x, 1.0), s.op(U_ADD, s.op(U_EXP, s.op(
        U_NEG, x)), s.like(x, 1.0)))


# -- group C: XLA's and jnp's float32 forms of the special functions --------

# the Lanczos approximation XLA's digamma uses (g = 7, 8 terms)
_LANCZOS_G = 7.0
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)
# (2k)! / B_2k, k = 12 down to 1: XLA's Hurwitz zeta (Euler-Maclaurin)
_ZETA = (-7.1661652561756670113e18, 1.8152105401943546773e17,
         -4.5979787224074726105e15, 1.1646782814350067249e14,
         -2.950130727918164224e12, 7.47242496e10,
         -1.8924375803183791606e9, 47900160.0, -1209600.0, 30240.0,
         -720.0, 12.0)
# Cephes' float32 Chebyshev coefficients: exp(-x) I0(x) and exp(-x) I1(x)
# / x on [0, 8], their sqrt(x)-scaled forms on [8, inf)
# (jax/_src/lax/special.py:_i0e_impl32, XLA's chlo.bessel_i1e)
_I0E = ((-1.30002500998624804212E-8, 6.04699502254191894932E-8,
         -2.67079385394061173391E-7, 1.11738753912010371815E-6,
         -4.41673835845875056359E-6, 1.64484480707288970893E-5,
         -5.75419501008210370398E-5, 1.88502885095841655729E-4,
         -5.76375574538582365885E-4, 1.63947561694133579842E-3,
         -4.32430999505057594430E-3, 1.05464603945949983183E-2,
         -2.37374148058994688156E-2, 4.93052842396707084878E-2,
         -9.49010970480476444210E-2, 1.71620901522208775349E-1,
         -3.04682672343198398683E-1, 6.76795274409476084995E-1),
        (3.39623202570838634515E-9, 2.26666899049817806459E-8,
         2.04891858946906374183E-7, 2.89137052083475648297E-6,
         6.88975834691682398426E-5, 3.36911647825569408990E-3,
         8.04490411014108831608E-1))
_I1E = ((9.38153738649577178388E-9, -4.44505912879632808065E-8,
         2.00329475355213526229E-7, -8.56872026469545474066E-7,
         3.47025130813767847674E-6, -1.32731636560394358279E-5,
         4.78156510755005422638E-5, -1.61760815825896745588E-4,
         5.12285956168575772895E-4, -1.51357245063125314899E-3,
         4.15642294431288815669E-3, -1.05640848946261981558E-2,
         2.47264490306265168283E-2, -5.29459812080949914269E-2,
         1.02643658689847095384E-1, -1.76416518357834055153E-1,
         2.52587186443633654823E-1),
        (-3.83538038596423702205E-9, -2.63146884688951950684E-8,
         -2.51223623787020892529E-7, -3.88256480887769039346E-6,
         -1.10588938762623716291E-4, -9.76109749136146840777E-3,
         7.78576235018280120474E-1))
# jax.scipy.special.ndtri's rational approximations (Cephes)
_NDTRI = {
    "p0": (-5.99633501014107895267E1, 9.80010754185999661536E1,
           -5.66762857469070293439E1, 1.39312609387279679503E1,
           -1.23916583867381258016E0),
    "q0": (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
           8.63602421390890590575E1, -2.25462687854119370527E2,
           2.00260212380060660359E2, -8.20372256168333339912E1,
           1.59056225126211695515E1, -1.18331621121330003142E0),
    "p1": (4.05544892305962419923E0, 3.15251094599893866154E1,
           5.71628192246421288162E1, 4.40805073893200834700E1,
           1.46849561928858024014E1, 2.18663306850790267539E0,
           -1.40256079171354495875E-1, -3.50424626827848203418E-2,
           -8.57456785154685413611E-4),
    "q1": (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
           4.13172038254672030440E1, 1.50425385692907503408E1,
           2.50464946208309415979E0, -1.42182922854787788574E-1,
           -3.80806407691578277194E-2, -9.33259480895457427372E-4),
    "p2": (3.23774891776946035970E0, 6.91522889068984211695E0,
           3.93881025292474443415E0, 1.33303460815807542389E0,
           2.01485389549179081538E-1, 1.23716634817820021358E-2,
           3.01581553508235416007E-4, 2.65806974686737550832E-6,
           6.23974539184983293730E-9),
    "q2": (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
           1.37702099489081330271E0, 2.16236993594496635890E-1,
           1.34204006088543189037E-2, 3.28014464682127739104E-4,
           2.89247864745380683936E-6, 6.79019408009981274425E-9)}


def _chebyshev(s: _SSA, x: int, coefs) -> int:
    """``evaluate_chebyshev_polynomial``: Clenshaw's ``b0 = x b1 - b2 +
    c``, then ``0.5 (b0 - b2)``."""
    z = s.like(x, 0.0)
    b0 = b1 = b2 = z
    for c in coefs:
        b2, b1 = b1, b0
        b0 = s.op(U_ADD, s.op(U_SUB, s.op(U_MUL, x, b1), b2), s.like(x, c))
    return s.op(U_MUL, s.like(x, 0.5), s.op(U_SUB, b0, b2))


def _polyval(s: _SSA, coefs, x: int) -> int:
    """``jnp.polyval``: Horner's ``y x + c`` from the leading
    coefficient."""
    y = s.like(x, coefs[0])
    for c in coefs[1:]:
        y = s.op(U_ADD, s.op(U_MUL, y, x), s.like(x, c))
    return y


def _digamma(s: _SSA, x: int) -> int:
    """XLA's digamma: the Lanczos form ``log(t) + A'(z) / A(z) - g / t``
    at ``z = x - 1`` (``t = z + g + 0.5``, ``log(t)`` as ``log(g + 0.5) +
    log1p(z / (g + 0.5))``); below 0.5 the reflection ``digamma(1 - x) -
    pi cot(pi x)`` (``x`` shifted by whole periods into [-0.5, 0.5]); NaN
    at the poles (0 and the negative integers)."""
    c = lambda v: s.like(x, v)  # noqa: E731
    half, one = c(0.5), c(1.0)
    reflect = s.op(U_LT, x, half)
    z = s.op(U_SEL, reflect, s.op(U_NEG, x), s.op(U_SUB, x, one))
    a, ap = c(_LANCZOS_BASE), c(0.0)
    for i, k in enumerate(_LANCZOS):
        zt = s.op(U_ADD, z, c(i + 1))
        ap = s.op(U_SUB, ap, s.op(U_DIV, c(k), s.op(U_MUL, zt, zt)))
        a = s.op(U_ADD, a, s.op(U_DIV, c(k), zt))
    lph = c(_LANCZOS_G + 0.5)
    t = s.op(U_ADD, lph, z)
    log_t = s.op(U_ADD, c(np.log(_LANCZOS_G + 0.5)),
                 s.op(U_LOG1P, s.op(U_DIV, z, lph)))
    dg = s.op(U_SUB, s.op(U_ADD, log_t, s.op(U_DIV, ap, a)),
              s.op(U_DIV, c(_LANCZOS_G), t))
    red = s.op(U_ADD, x, s.op(U_ABS, s.op(U_FLOOR, s.op(U_ADD, x, half))))
    pix = s.op(U_MUL, c(np.pi), red)
    refl = s.op(U_SUB, dg, s.op(U_DIV, s.op(U_MUL, c(np.pi),
                                            s.op(U_COS, pix)),
                                s.op(U_SIN, pix)))
    dg = s.op(U_SEL, reflect, refl, dg)
    pole = s.op(U_AND, s.op(U_LE, x, c(0.0)),
                s.op(U_EQ, x, s.op(U_FLOOR, x)))
    return s.op(U_SEL, pole, c(_NAN), dg)


def _zeta(s: _SSA, x: int, q: int) -> int:
    """XLA's Hurwitz zeta ``zeta(x, q)``: the first 10 terms ``(q +
    k)**-x``, then Euler-Maclaurin's tail at ``a = q + 10`` with 12
    Bernoulli terms by Horner; the first sum alone where the tail is below
    its epsilon; NaN for x < 1 and for q <= 0 with x not an integer, at the
    poles (integer q <= 0) inf for even integer x and NaN else, inf at x =
    1."""
    c = lambda v: s.like(x, v)  # noqa: E731
    one, zero = c(1.0), c(0.0)
    neg_x = s.op(U_NEG, x)
    a = q
    initial = s.op(U_POW, q, neg_x)
    for _ in range(9):
        a = s.op(U_ADD, a, one)
        initial = s.op(U_ADD, initial, s.op(U_POW, a, neg_x))
    a = s.op(U_ADD, a, one)
    neg_power = s.op(U_POW, a, neg_x)
    tail = s.op(U_DIV, s.op(U_MUL, neg_power, a), s.op(U_SUB, x, one))
    total = s.op(U_ADD, initial, tail)
    a_inv2 = s.op(U_DIV, one, s.op(U_MUL, a, a))
    horner = zero
    for i in range(11):
        factor = s.op(U_MUL, s.op(U_ADD, x, c(21.0 - 2 * i)),
                      s.op(U_ADD, x, c(22.0 - 2 * i)))
        horner = s.op(U_MUL, factor, s.op(U_MUL, a_inv2, s.op(
            U_ADD, horner, s.op(U_DIV, one, c(_ZETA[i])))))
    total = s.op(U_ADD, total, s.op(U_MUL, neg_power, s.op(
        U_ADD, c(0.5), s.op(U_MUL, s.op(U_DIV, x, a), s.op(
            U_ADD, s.op(U_DIV, one, c(_ZETA[11])), horner)))))
    eps = c(float(np.finfo(np.float32).eps) if s.ty[x] == F32
            else float(np.finfo(np.float64).eps))
    out = s.op(U_SEL, s.op(U_LT, s.op(U_ABS, neg_power), s.op(
        U_MUL, s.op(U_ABS, initial), eps)), initial, total)
    nan, inf = c(_NAN), c(_INF)
    out = s.op(U_SEL, s.op(U_LT, x, one), nan, out)
    q_le0 = s.op(U_LE, q, zero)
    x_int = s.op(U_EQ, x, s.op(U_FLOOR, x))
    out = s.op(U_SEL, s.op(U_AND, q_le0, s.op(U_NOT, x_int)), nan, out)
    pole = s.op(U_AND, q_le0, s.op(U_EQ, q, s.op(U_FLOOR, q)))
    even = s.op(U_AND, x_int, s.op(U_EQ, s.op(U_FMOD, x, c(2.0)), zero))
    out = s.op(U_SEL, pole, s.op(U_SEL, even, inf, nan), out)
    return s.op(U_SEL, s.op(U_EQ, x, one), inf, out)


def _polygamma(s: _SSA, n: int, x: int) -> int:
    """XLA's polygamma of a Python int ``n``: ``(2 (n % 2) - 1) exp(
    lgamma(n + 1)) zeta(n + 1, x)``; digamma for n = 0; NaN for n < 0."""
    if n < 0:
        return s.like(x, _NAN)
    if n == 0:
        return _digamma(s, x)
    np1 = s.like(x, float(n + 1))
    # (2 (n % 2) - 1) exp(lgamma(n + 1)): the sign times n!, a constant
    # (a libm function of a constant the kernel's compiler would fold)
    coef = s.like(x, (2.0 * (n % 2) - 1.0) * math.factorial(n))
    return s.op(U_MUL, coef, _zeta(s, np1, x))


def _i0e(s: _SSA, x: int) -> int:
    """``lax.bessel_i0e`` (``_i0e_impl32``): of |x|, Chebyshev in ``x / 2 -
    2`` up to 8, in ``32 / x - 2`` over sqrt(x) past it."""
    x = s.op(U_ABS, x)
    le8 = _chebyshev(s, s.op(U_SUB, s.op(U_MUL, s.like(x, 0.5), x),
                             s.like(x, 2.0)), _I0E[0])
    gt8 = s.op(U_DIV, _chebyshev(s, s.op(U_SUB, s.op(
        U_DIV, s.like(x, 32.0), x), s.like(x, 2.0)), _I0E[1]),
        s.op(U_SQRT, x))
    return s.op(U_SEL, s.op(U_LE, x, s.like(x, 8.0)), le8, gt8)


def _i1e(s: _SSA, x: int) -> int:
    """XLA's ``chlo.bessel_i1e`` (Cephes' i1ef): of z = |x|, z times a
    Chebyshev series in ``z / 2 - 2`` up to 8, one in ``32 / z - 2`` over
    sqrt(z) past it; times sign(x)."""
    z = s.op(U_ABS, x)
    le8 = s.op(U_MUL, z, _chebyshev(s, s.op(U_SUB, s.op(
        U_MUL, s.like(x, 0.5), z), s.like(x, 2.0)), _I1E[0]))
    gt8 = s.op(U_DIV, _chebyshev(s, s.op(U_SUB, s.op(
        U_DIV, s.like(x, 32.0), z), s.like(x, 2.0)), _I1E[1]),
        s.op(U_SQRT, z))
    return s.op(U_MUL, _sign(s, x),
                s.op(U_SEL, s.op(U_LE, z, s.like(x, 8.0)), le8, gt8))


def _ndtr_ssa(s: _SSA, x: int) -> int:
    """``jax.scipy.special.ndtr``: ``erf`` near 0, ``erfc`` in the tails
    (:func:`_ndtr`'s form)."""
    h = s.like(x, float(np.float32(0.5) * np.sqrt(2.0, dtype=np.float32)))
    w = s.op(U_MUL, x, h)
    z = s.op(U_ABS, w)
    y = s.op(U_SEL, s.op(U_LT, z, h), s.op(U_ADD, s.op(U_ERF, w),
                                           s.like(x, 1.0)),
             s.op(U_SEL, s.op(U_GT, w, s.like(x, 0.0)),
                  s.op(U_SUB, s.like(x, 2.0), s.op(U_ERFC, z)),
                  s.op(U_ERFC, z)))
    return s.op(U_MUL, y, s.like(x, 0.5))


def _ndtri(s: _SSA, p: int) -> int:
    """``jax.scipy.special.ndtri`` (Cephes): ``p`` past 1 - e**-2
    complemented; above e**-2 a rational function of ``(p - 0.5)**2``,
    else of ``1 / z``, ``z = sqrt(-2 log p)`` (the p2 / q2 pair for z >=
    8); the sign restored; -inf at 0, inf at 1."""
    c = lambda v: s.like(p, v)  # noqa: E731
    mcp = s.op(U_SEL, s.op(U_GT, p, c(-np.expm1(-2.0))),
               s.op(U_SUB, c(1.0), p), p)
    san = s.op(U_SEL, s.op(U_EQ, mcp, c(0.0)), c(0.5), mcp)
    w = s.op(U_SUB, san, c(0.5))
    ww = s.op(U_MUL, w, w)
    big = s.op(U_ADD, w, s.op(U_MUL, s.op(U_MUL, w, ww), s.op(
        U_DIV, _polyval(s, _NDTRI["p0"], ww), _polyval(s, _NDTRI["q0"], ww))))
    big = s.op(U_MUL, big, c(-np.sqrt(2.0 * np.pi)))
    z = s.op(U_SQRT, s.op(U_MUL, c(-2.0), s.op(U_LOG, san)))
    first = s.op(U_SUB, z, s.op(U_DIV, s.op(U_LOG, z), z))
    inv = s.op(U_DIV, c(1.0), z)

    def second(pk, qk):
        return s.op(U_DIV, s.op(U_DIV, _polyval(s, _NDTRI[pk], inv),
                                _polyval(s, _NDTRI[qk], inv)), z)

    x = s.op(U_SEL, s.op(U_GT, san, c(np.exp(-2.0))), big, s.op(
        U_SEL, s.op(U_GE, z, c(8.0)), s.op(U_SUB, first, second("p2", "q2")),
        s.op(U_SUB, first, second("p1", "q1"))))
    x = s.op(U_SEL, s.op(U_GT, p, c(1.0 - np.exp(-2.0))), x,
             s.op(U_NEG, x))
    return s.op(U_SEL, s.op(U_EQ, p, c(0.0)), c(-_INF), s.op(
        U_SEL, s.op(U_EQ, p, c(1.0)), c(_INF), x))


def _log_ndtr(s: _SSA, x: int) -> int:
    """``jax.scipy.special.log_ndtr`` (series order 3): ``-ndtr(-x)`` past
    5, ``log(ndtr(x))`` past -10, else the asymptotic series ``-x**2 / 2
    - log(-x) - log(2 pi) / 2 + log(1 - 1 / x**2 + 3 / x**4 - 15 /
    x**6)``."""
    c = lambda v: s.like(x, v)  # noqa: E731
    lo, hi = c(-10.0), c(5.0)
    upper = s.op(U_NEG, _ndtr_ssa(s, s.op(U_NEG, x)))
    middle = s.op(U_LOG, _ndtr_ssa(s, s.op(U_MAX, x, lo)))
    xl = s.op(U_MIN, x, lo)
    x2 = s.op(U_MUL, xl, xl)
    log_scale = s.op(U_SUB, s.op(U_SUB, s.op(U_MUL, c(-0.5), x2), s.op(
        U_LOG, s.op(U_NEG, xl))), c(0.5 * np.log(2.0 * np.pi)))
    x4 = s.op(U_MUL, x2, x2)
    odd = s.op(U_ADD, s.op(U_DIV, c(1.0), x2),
               s.op(U_DIV, c(15.0), s.op(U_MUL, x4, x2)))
    even = s.op(U_DIV, c(3.0), x4)
    series = s.op(U_SUB, s.op(U_ADD, c(1.0), even), odd)
    lower = s.op(U_ADD, log_scale, s.op(U_LOG, series))
    return s.op(U_SEL, s.op(U_GT, x, hi), upper,
                s.op(U_SEL, s.op(U_GT, x, lo), middle, lower))


def _frexp(s: _SSA, x: int) -> Tuple[int, int]:
    """``jnp.frexp`` of a float32: the mantissa in [0.5, 1) with ``x``'s
    sign and the int32 exponent, from the bits (a subnormal scaled by
    2**23 first); ``x`` and 0 for 0, inf and NaN."""
    i = I32
    tiny = s.op(U_LT, s.op(U_ABS, x), s.like(x, float(
        np.finfo(np.float32).tiny)))
    x1 = s.val(U_BITCAST, (s.op(U_SEL, tiny, s.op(
        U_MUL, x, s.like(x, float(1 << 23))), x),), i, i)
    x2 = s.op(U_SEL, tiny, s.const(-23, i), s.const(0, i))
    x2 = s.op(U_ADD, x2, s.op(U_ADD, s.op(U_SUB, s.op(
        U_BAND, s.op(U_SHR, x1, s.const(23, i)), s.const(0xFF, i)),
        s.const(127, i)), s.const(1, i)))
    x1 = s.op(U_BAND, x1, s.const(~(0xFF << 23), i))
    x1 = s.op(U_BOR, x1, s.const(126 << 23, i))
    m = s.val(U_BITCAST, (x1,), F32, F32)
    cond = s.op(U_OR, s.op(U_OR, s.op(U_EQ, s.op(U_ABS, x), s.like(
        x, _INF)), s.op(U_ISNAN, x)), s.op(U_EQ, x, s.like(x, 0.0)))
    return (s.op(U_SEL, cond, x, m),
            s.op(U_SEL, cond, s.const(0, i), x2))


def _ldexp(s: _SSA, x: int, e: int) -> int:
    """``jnp.ldexp``: the exponent ``e`` as a float added to frexp's, the
    mantissa doubled while it is positive, times ``2.0 ** e``; ``x`` where
    it is 0 or inf."""
    m, fe = _frexp(s, x)
    ef = s.op(U_ADD, s.cvt(fe, F32), s.cvt(e, F32))
    pos = s.op(U_GT, ef, s.like(x, 0.0))
    m = s.op(U_SEL, pos, s.op(U_MUL, m, s.like(x, 2.0)), m)
    ef = s.op(U_SEL, pos, s.op(U_SUB, ef, s.like(x, 1.0)), ef)
    out = s.op(U_MUL, m, s.op(U_POW, s.like(x, 2.0), ef))
    keep = s.op(U_OR, s.op(U_EQ, s.op(U_ABS, x), s.like(x, _INF)),
                s.op(U_EQ, x, s.like(x, 0.0)))
    return s.op(U_SEL, keep, x, out)


def _lower(s: _SSA, name: str, xs: Sequence[int], opt: dict) -> int:
    """One component of the jnp function ``name`` (the aten name of its
    torch counterpart) of the components ``xs``, over the instructions, in
    the order of the jnp function: ``opt`` its options (alpha, value,
    beta, eps, decimals, nan/posinf/neginf, approximate, p, n); constants
    in the type of the first component."""
    x = xs[0]
    if s.ty[x] in INT_BITS:
        return _lower_int(s, name, xs)
    c = lambda v: s.like(x, v)  # noqa: E731
    if name in _GROUP_C:
        return _lower_special(s, name, xs, opt)
    if name == "isnan":
        return s.op(U_ISNAN, x)
    if name == "signbit":
        return s.op(U_SIGNBIT, x)
    if name == "isinf":
        return s.op(U_EQ, s.op(U_ABS, x), c(_INF))
    if name == "isposinf":
        return s.op(U_EQ, x, c(_INF))
    if name == "isneginf":
        return s.op(U_EQ, x, c(-_INF))
    if name == "round":
        d = int(opt.get("decimals", 0))
        if d == 0:
            return s.op(U_ROUND, x)
        f = c(10.0 ** d)
        return s.op(U_DIV, s.op(U_ROUND, s.op(U_MUL, x, f)), f)
    if name in ("sign", "sgn"):
        return _sign(s, x)
    if name == "frac":
        return s.op(U_SUB, x, s.op(U_TRUNC, x))
    if name == "sigmoid":
        return _sigmoid(s, x)
    if name == "silu":
        return s.op(U_MUL, x, _sigmoid(s, x))
    if name == "relu":
        return s.op(U_MAX, x, c(0.0))
    if name == "softplus":
        beta = opt.get("beta", 1.0)
        if beta == 1.0:
            return _logaddexp(s, x, c(0.0))
        return s.op(U_DIV, _logaddexp(s, s.op(U_MUL, x, c(beta)), c(0.0)),
                    c(beta))
    if name == "erfinv":
        return _erfinv(s, x)
    if name == "deg2rad":
        return s.op(U_MUL, x, c(np.pi / 180))
    if name == "rad2deg":
        return s.op(U_MUL, x, c(180 / np.pi))
    if name == "sinc":
        z = s.op(U_EQ, x, c(0.0))
        pix = s.op(U_MUL, c(np.pi), x)
        safe = s.op(U_SEL, z, c(1.0), pix)
        return s.op(U_SEL, z, c(1.0), s.op(U_DIV, s.op(U_SIN, safe), safe))
    if name == "logit":
        eps = opt.get("eps")
        if eps is not None:
            x = s.op(U_MIN, s.op(U_MAX, x, c(eps)), c(1.0 - _f32(eps)))
        return s.op(U_LOG, s.op(U_DIV, x, s.op(U_SUB, c(1.0), x)))
    if name == "nan_to_num":
        out = s.op(U_SEL, s.op(U_ISNAN, x), c(opt.get("nan") or 0.0), x)
        pos, neg = opt.get("posinf"), opt.get("neginf")
        big = _F32_MAX if s.ty[x] == F32 else float(np.finfo(np.float64).max)
        out = s.op(U_SEL, s.op(U_EQ, out, c(_INF)),
                   c(big if pos is None else pos), out)
        return s.op(U_SEL, s.op(U_EQ, out, c(-_INF)),
                    c(-big if neg is None else neg), out)
    y = xs[1]
    if name == "remainder":
        return _remainder(s, x, y, opt.get("ints", False))
    if name == "floor_divide":
        return _floor_divide(s, x, y)
    if name == "trunc_divide":
        return s.op(U_TRUNC, s.op(U_DIV, x, y))
    if name == "logaddexp":
        return _logaddexp(s, x, y)
    if name in ("xlogy", "special_xlog1py"):
        return s.op(U_SEL, s.op(U_NE, x, c(0.0)), s.op(
            U_MUL, x, s.op(U_LOG if name == "xlogy" else U_LOG1P, y)),
            c(0.0))
    if name == "hypot":
        return _hypot(s, x, y)
    if name in ("fmax", "fmin"):
        cmp = U_GT if name == "fmax" else U_LT
        return s.op(U_SEL, s.op(U_OR, s.op(cmp, x, y), s.op(U_ISNAN, y)),
                    x, y)
    if name == "heaviside":
        z = c(0.0)
        return s.op(U_SEL, s.op(U_LT, x, z), z,
                    s.op(U_SEL, s.op(U_GT, x, z), c(1.0), y))
    w = xs[2] if len(xs) > 2 else None
    if name == "lerp":
        # torch's lerp: from the start for |w| < 0.5, else from the end
        d = s.op(U_SUB, y, x)
        return s.op(U_SEL, s.op(U_LT, s.op(U_ABS, w), c(0.5)),
                    s.op(U_ADD, x, s.op(U_MUL, w, d)),
                    s.op(U_SUB, y, s.op(U_MUL, d, s.op(U_SUB, c(1.0), w))))
    if name in ("addcmul", "addcdiv"):
        v = opt.get("value", 1)
        t = y if v == 1 else s.op(U_MUL, c(v), y)
        return s.op(U_ADD, x, s.op(U_MUL if name == "addcmul" else U_DIV,
                                   t, w))
    raise ValueError(name)


def _lower_int(s: _SSA, name: str, xs: Sequence[int]) -> int:
    """The functions of :data:`_INT_LOWERED` of integers, as jnp computes
    them in the integer type: a test of a float property is false, a
    rounding the value, a division by a nonzero constant exact."""
    x = xs[0]
    if name in ("isnan", "isinf", "isposinf", "isneginf"):
        return s.const(0.0)
    if name == "signbit":
        return s.op(U_LT, x, s.like(x, 0))
    if name in ("round", "nan_to_num"):
        return x
    if name in ("sign", "sgn"):
        return _sign(s, x)
    if name == "relu":
        return s.op(U_MAX, x, s.like(x, 0))
    y = xs[1]
    if name == "remainder":
        return _remainder(s, x, y, True)
    if name in ("floor_divide", "trunc_divide"):
        return _int_divide(s, x, y, name == "floor_divide")
    if name in ("fmax", "fmin"):
        return s.op(U_MAX if name == "fmax" else U_MIN, x, y)
    raise ValueError(name)


def _lower_special(s: _SSA, name: str, xs: Sequence[int], opt: dict) -> int:
    """Group C (:data:`_GROUP_C`): XLA's, ``jax.scipy.special``'s,
    ``jnp``'s and ``jax.nn``'s forms, in their order."""
    x = xs[0]
    c = lambda v: s.like(x, v)  # noqa: E731
    if name == "digamma":
        return _digamma(s, x)
    if name == "polygamma":
        return _polygamma(s, int(opt["n"]), x)
    if name == "special_zeta":
        return _zeta(s, x, xs[1])
    if name in ("i0", "special_modified_bessel_i0"):
        return s.op(U_MUL, s.op(U_EXP, s.op(U_ABS, x)), _i0e(s, x))
    if name == "special_i0e":
        return _i0e(s, x)
    if name in ("special_i1", "special_modified_bessel_i1"):
        return s.op(U_MUL, s.op(U_EXP, s.op(U_ABS, x)), _i1e(s, x))
    if name == "special_i1e":
        return _i1e(s, x)
    if name == "special_ndtri":
        return _ndtri(s, x)
    if name == "special_log_ndtr":
        return _log_ndtr(s, x)
    if name == "special_entr":
        xlogx = s.op(U_SEL, s.op(U_NE, x, c(0.0)),
                     s.op(U_MUL, x, s.op(U_LOG, x)), c(0.0))
        return s.op(U_SEL, s.op(U_LT, x, c(0.0)), c(-_INF),
                    s.op(U_NEG, xlogx))
    if name == "mvlgamma":
        # multigammaln: sum_i lgamma(a - i / 2) + 0.25 d (d - 1) log(pi)
        d = int(opt["p"])
        k = s.op(U_MUL, s.op(U_MUL, c(0.25), c(d)), s.op(U_SUB, c(d),
                                                         c(1.0)))
        total = s.op(U_LGAMMA, x)
        for i in range(1, d):
            total = s.op(U_ADD, total, s.op(U_LGAMMA, s.op(U_SUB, x,
                                                           c(i / 2))))
        # log(pi) a constant (a libm function of a constant the kernel's
        # compiler would fold)
        return s.op(U_ADD, total, s.op(U_MUL, k, c(np.log(np.pi))))
    if name == "logaddexp2":
        return _logaddexp(s, x, xs[1], base2=True)
    if name == "ldexp":
        return _ldexp(s, x, xs[1])
    if name == "gelu":
        if opt.get("approximate", "none") == "tanh":
            cube = s.val(U_IPOW, (x,), 3)
            inner = s.op(U_MUL, c(np.sqrt(2 / np.pi)), s.op(
                U_ADD, x, s.op(U_MUL, c(0.044715), cube)))
            cdf = s.op(U_MUL, c(0.5), s.op(U_ADD, c(1.0),
                                           s.op(U_TANH, inner)))
            return s.op(U_MUL, x, cdf)
        return s.op(U_MUL, s.op(U_MUL, c(0.5), x), s.op(U_ERFC, s.op(
            U_MUL, s.op(U_NEG, x), c(np.sqrt(0.5)))))
    if name == "elu":
        alpha, scale, in_scale = (opt.get(k, 1.0) for k in (
            "alpha", "scale", "input_scale"))
        pos = s.op(U_GT, x, c(0.0))
        xn = x if in_scale == 1 else s.op(U_MUL, x, c(in_scale))
        neg = s.op(U_MUL, c(alpha), s.op(U_EXPM1, s.op(U_SEL, pos, c(0.0),
                                                       xn)))
        if scale != 1:
            return s.op(U_SEL, pos, s.op(U_MUL, x, c(scale)),
                        s.op(U_MUL, neg, c(scale)))
        return s.op(U_SEL, pos, x, neg)
    if name == "log_sigmoid_forward":
        return s.op(U_NEG, _logaddexp(s, s.op(U_NEG, x), c(0.0)))
    raise ValueError(name)


# the torch functions (their aten names) lowered over the instructions
# (:func:`_lower`), with their operand count
_LOWERED = {"isnan": 1, "signbit": 1, "isinf": 1, "isposinf": 1,
            "isneginf": 1, "round": 1, "sign": 1, "sgn": 1, "frac": 1,
            "sigmoid": 1, "silu": 1, "relu": 1, "softplus": 1, "erfinv": 1,
            "deg2rad": 1, "rad2deg": 1, "sinc": 1, "logit": 1,
            "nan_to_num": 1, "remainder": 2, "floor_divide": 2,
            "logaddexp": 2, "xlogy": 2, "special_xlog1py": 2, "hypot": 2,
            "fmax": 2, "fmin": 2, "heaviside": 2, "lerp": 3, "addcmul": 3,
            "addcdiv": 3,
            # torch.div(rounding_mode="trunc")
            "trunc_divide": 2,
            # group C
            "digamma": 1, "special_zeta": 2, "i0": 1, "special_i0e": 1,
            "special_i1": 1, "special_i1e": 1,
            "special_modified_bessel_i0": 1, "special_modified_bessel_i1": 1,
            "special_ndtri": 1, "special_log_ndtr": 1, "special_entr": 1,
            "mvlgamma": 1, "logaddexp2": 2, "ldexp": 2, "gelu": 1, "elu": 1,
            "log_sigmoid_forward": 1}
_GROUP_C = {"digamma", "polygamma", "special_zeta", "i0", "special_i0e",
            "special_i1", "special_i1e", "special_modified_bessel_i0",
            "special_modified_bessel_i1", "special_ndtri",
            "special_log_ndtr", "special_entr", "mvlgamma", "logaddexp2",
            "ldexp", "gelu", "elu", "log_sigmoid_forward"}
# the lowered functions jnp computes in an integer type
_INT_LOWERED = {"isnan", "isinf", "isposinf", "isneginf", "signbit",
                "round", "nan_to_num", "sign", "sgn", "relu", "remainder",
                "floor_divide", "trunc_divide", "fmax", "fmin"}
# the lowered functions whose form is float32's (coefficient tables and
# cutoffs): refused in float64, where jnp's form differs
_F32_FORMS = {"erfinv", "digamma", "polygamma", "special_zeta", "i0",
              "special_i0e", "special_i1", "special_i1e",
              "special_modified_bessel_i0", "special_modified_bessel_i1",
              "special_ndtri", "special_log_ndtr", "ldexp"}


def _schedule(ssa: _SSA, n_draws: int) -> Program:
    """Drop unused values, order the instructions (a record sum right after
    its value, stores and alive clears last, after every load) and assign
    registers by liveness."""
    live = set()
    stack = [e[1] for e in ssa.effects]
    while stack:
        v = stack.pop()
        if v in live:
            continue
        live.add(v)
        code, args, _ = ssa.defs[v]
        stack.extend(_uses(code, args, ssa))
    accs: Dict[int, list] = {}
    tail = []
    for eff in ssa.effects:
        if eff[0] == U_ACC:
            accs.setdefault(eff[1], []).append(eff)
        else:
            tail.append(eff)
    order: List[tuple] = []  # ("v", vid) or ("e", effect)
    for v in range(len(ssa.defs)):
        if v in live:
            order.append(("v", v))
            order.extend(("e", e) for e in accs.get(v, ()))
    order.extend(("e", e) for e in tail)
    last: Dict[int, int] = {}
    for i, (kind, item) in enumerate(order):
        if kind == "v":
            code, args, _ = ssa.defs[item]
            for u in _uses(code, args, ssa):
                last[u] = i
        else:
            last[item[1]] = i
    reg: Dict[int, int] = {}
    free: List[int] = []
    n_regs = 0
    ins, types = [], []
    for i, (kind, item) in enumerate(order):
        if kind == "e":
            code, v, y = item
            ins.append((code, 0, reg[v], 0, y, False))
            types.append(F32)
            if last[item[1]] == i:
                free.append(reg[v])
            continue
        code, args, y = ssa.defs[item]
        srcs = _uses(code, args, ssa)
        for u in dict.fromkeys(srcs):
            if last[u] == i:
                free.append(reg[u])
        if free:
            free.sort(reverse=True)
            d = free.pop()
        else:
            d, n_regs = n_regs, n_regs + 1
        reg[item] = d  # every live value has a last use
        a = b = 0
        bimm = False
        if code == U_SEL:
            # (cond, false register, true register in y), or with a
            # constant false value (cond, true register, its immediate)
            cond, tv, fv = args
            a = reg[cond]
            if ssa.is_const(fv):
                b, y, bimm = reg[tv], ssa.defs[fv][2], True
            else:
                b, y = reg[fv], reg[tv]
        elif len(args) == 2:
            a = reg[args[0]]
            if ssa.is_const(args[1]):
                bimm, y = True, ssa.defs[args[1]][2]
            else:
                b = reg[args[1]]
        elif len(args) == 1:
            a = reg[args[0]]
        ins.append((code, d, a, b, y, bimm))
        types.append(ssa.ty[item])
    return Program(tuple(ins), max(n_regs, 1), n_draws,
                   tuple(types) if any(t != F32 for t in types) else ())


# -- the aten graph -> SSA ------------------------------------------------------


class _Input:
    """A graph input: its role (``"plane"``, ``"t"``, ``"dt"``, ``"const"``,
    ``"draws"``, ``"forbidden"``) and, per component, a plane number or a
    constant."""

    def __init__(self, role, comps=(0,), kind="f", why=""):
        self.role = role
        self.comps = tuple(comps)
        self.kind = kind
        self.why = why


def _kind_of(dtype) -> str:
    """A value's kind: ``"b"`` a bool (a float32 0.0 or 1.0 in its
    register), ``"f"`` float32, ``"d"`` float64, ``"i"`` int32, ``"l"``
    int64; ``"?"`` another dtype."""
    return _KINDS.get(dtype, "?")


_KINDS = {torch.bool: "b", torch.float32: "f", torch.float64: "d",
          torch.int32: "i", torch.int64: "l"}
# a kind's register type
_REG = {"b": F32, "f": F32, "i": I32, "l": I64, "d": F64}
# the kinds of the typed paths: bools and float32 keep the float32 paths
_TYPED = {"i", "l", "d"}
_BITCASTS = {("f", "i"), ("i", "f"), ("d", "l"), ("l", "d")}


def _name(target) -> Tuple[str, str]:
    """(packet, overload) of an aten target: ``aten.mul.Tensor`` ->
    ``("mul", "Tensor")``."""
    parts = str(target).split(".")
    if len(parts) >= 3 and parts[0] == "aten":
        return parts[1], parts[2]
    if len(parts) == 2 and parts[0] == "aten":
        return parts[1], "default"
    return str(target), ""


def _to_float(ssa: _SSA, c: int) -> int:
    """A value leaving the program (a plane store, a record sum), rounded
    once to float32."""
    return ssa.cvt(c, F32)


def _to_alive(ssa: _SSA, c: int) -> int:
    """An alive clear's operand: a bool, a float32, or another type's
    nonzero test."""
    return c if ssa.ty[c] == F32 else ssa.op(U_BOOL, c)


class _Translator:
    """One aten graph to SSA values. ``n`` is the traced particle count: a
    value of shape ``()`` or ``(n,)`` has 1 component, ``(3, n)`` three.
    Each value has a kind (:func:`_kind_of`, from the node's dtype); an
    operation with an integer or float64 operand or value takes its
    operands in torch's promoted dtype (:meth:`to`) and computes in it."""

    def __init__(self, gm, inputs: Sequence[_Input], n: int, ssa: _SSA):
        self.gm = gm
        self.n = n
        self.ssa = ssa
        self.vals: Dict = {}
        self.kinds: Dict = {}
        self.draws_node = None
        self.inputs = list(inputs)

    # values
    def comps_of(self, x) -> List[int]:
        if isinstance(x, torch.fx.Node):
            v = self.vals[x]
            if isinstance(v, _Input):
                raise Refused(v.role if v.role in ("state", "trace")
                              else "op-unsupported", v.why)
            return v
        if isinstance(x, (bool, int, float)):
            return [self.ssa.const(float(x))]
        raise Refused("op-unsupported", f"operand {x!r}")

    def kind_of(self, x) -> str:
        if isinstance(x, torch.fx.Node):
            return self.kinds[x]
        return "b" if isinstance(x, bool) else "f"

    def typed(self, *xs, kinds=()) -> bool:
        """Whether an operand or a kind is an integer or a float64."""
        return any(k in _TYPED for k in kinds) or any(
            isinstance(x, torch.fx.Node) and self.kinds.get(x) in _TYPED
            for x in xs)

    def to(self, x, kind) -> List[int]:
        """The components of ``x`` (a node or a Python scalar) as ``kind``:
        a scalar a constant of that kind, a value converted (to a bool, its
        nonzero test)."""
        ssa = self.ssa
        if not isinstance(x, torch.fx.Node):
            if not isinstance(x, (bool, int, float)):
                raise Refused("op-unsupported", f"operand {x!r}")
            if kind == "b":
                return [ssa.const(1.0 if x else 0.0)]
            return [ssa.const(x, _REG[kind])]
        cs = self.comps_of(x)
        if self.kinds[x] == kind:
            return cs
        if kind == "b":
            return [ssa.op(U_BOOL, c) for c in cs]
        return [ssa.cvt(c, _REG[kind]) for c in cs]

    def promoted(self, *xs) -> str:
        """The kind of torch's common dtype of the operands (a Python
        scalar and a 0-dim value promote as torch promotes them)."""
        protos = []
        for x in xs:
            if isinstance(x, torch.fx.Node):
                val = x.meta.get("val")
                protos.append(torch.empty((1,) if val.dim() else (),
                                          dtype=val.dtype))
            else:
                protos.append(x)
        dt = protos[0].dtype if len(protos) == 1 else torch.result_type(
            *protos[:2])
        for p in protos[2:]:
            dt = torch.result_type(torch.empty((1,), dtype=dt), p)
        return _kind_of(dt)

    def ncomp(self, node) -> int:
        val = node.meta.get("val")
        shape = tuple(getattr(val, "shape", ()))
        if shape in ((), (self.n,)):
            return 1
        if shape == (3, self.n):
            return 3
        raise Refused("op-unsupported", f"{node.target} gives a value of "
                      f"shape {shape} (a value is per particle, with 1 or 3 "
                      "components)")

    def rank(self, x) -> int:
        if not isinstance(x, torch.fx.Node):
            return 0
        val = x.meta.get("val")
        shape = tuple(getattr(val, "shape", ()))
        return 0 if shape == () else len(shape)

    def particle_dims(self, x, dims) -> Tuple[bool, bool]:
        """(touches the particle axis, touches the component axis) of an
        operation over ``dims`` of ``x`` (None or [] = every axis)."""
        r = self.rank(x)
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = list(range(r))
        if isinstance(dims, int):
            dims = [dims]
        dims = [d % max(r, 1) for d in dims]
        return (r >= 1 and (r - 1) in dims), (r == 2 and 0 in dims)

    def broadcast(self, *cs):
        k = max(len(c) for c in cs)
        return [c * k if len(c) == 1 else c for c in cs], k

    def run(self):
        placeholders = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        for node, inp in zip(placeholders, self.inputs):
            self.kinds[node] = inp.kind
            if inp.role == "draws":
                self.draws_node = node
                self.vals[node] = inp
            elif inp.role in ("forbidden", "state"):
                self.vals[node] = inp
            else:
                self.vals[node] = [self.leaf(inp, c) for c in inp.comps]
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "call_function":
                self.call(node)
            elif node.op == "get_attr":
                self.constant(node, getattr(self.gm, node.target))
            elif node.op == "output":
                out = node.args[0]
        return out

    def leaf(self, inp: _Input, c) -> int:
        """A plane (an integer plane's float32 converted where an integer
        operation needs it), ``t``, ``dt`` or a constant of the input's
        kind."""
        ssa = self.ssa
        if inp.role == "plane":
            v = ssa.val(U_LD, (), int(c))
            return v if inp.kind in ("b", "f") else ssa.plane_int(
                v, _REG[inp.kind])
        if inp.role == "t":
            return ssa.val(U_T)
        if inp.role == "dt":
            return ssa.val(U_DT)
        if inp.kind in _TYPED:
            return ssa.const(int(c) if inp.kind != "d" else c,
                             _REG[inp.kind])
        return ssa.const(c)

    def set(self, node, comps, kind):
        self.vals[node] = comps
        self.kinds[node] = kind

    def call(self, node):
        ssa = self.ssa
        if node.target is operator.getitem:
            seq, i = node.args
            k = self.kinds[seq]
            self.set(node, list(self.vals[seq][i]),
                     k[i] if isinstance(k, list) else k)
            return
        name, over = _name(node.target)
        args, kw = node.args, node.kwargs
        val = node.meta.get("val")
        kind = _kind_of(getattr(val, "dtype", torch.float32)) \
            if isinstance(val, torch.Tensor) else "f"
        if name == "select" and args[0] is self.draws_node:
            self.set(node, [ssa.val(U_UNIF, (), int(args[2]))], "f")
            return
        if name == "frexp":
            self.frexp(node, args[0])
            return
        if name == "log_sigmoid_forward":
            self.lowered(node, name, args, kw, self.kind_of(args[0]))
            return
        if kind == "?":
            raise Refused("op-unsupported", f"aten.{name} gives dtype "
                          f"{val.dtype} (a value is float32, float64, int32, "
                          "int64 or bool)")
        if name in _IDENTITY:
            src = args[0]
            self.vals[node] = self.vals[src]
            self.kinds[node] = self.kinds[src]
            return
        if name == "_to_copy":
            self.convert(node, args[0], kw.get("dtype"))
            return
        if name == "view" and over == "dtype":
            self.bitcast(node, args[0], kind)
            return
        if name in _FACTORIES:
            self.factory(node, name, args, kw, kind)
            return
        if name in _UNARY:
            self.unary(node, name, args[0], kind)
            return
        if name == "square":
            cs = self.to(args[0], kind)
            self.set(node, [ssa.binary(U_MUL, c, c) for c in cs], kind)
            return
        if name in ("bitwise_not", "logical_not"):
            x = args[0]
            if name == "bitwise_not" and self.kind_of(x) in ("i", "l"):
                self.set(node, [ssa.op(U_BNOT, c) for c in self.to(x, kind)],
                         kind)
                return
            cs = self.comps_of(x)
            self.set(node, [ssa.val(U_NOT, (c,)) for c in cs], "b")
            return
        if name in _SHIFTS:
            self.shift(node, name, args, kind)
            return
        if name == "div" and kw.get("rounding_mode") is not None:
            mode = kw["rounding_mode"]
            self.lowered(node, "floor_divide" if mode == "floor"
                         else "trunc_divide", args, kw, kind)
            return
        if name in _BINARY or name == "rsub":
            self.binary(node, name, args, kw, kind)
            return
        if name in _LOWERED or name == "polygamma":
            self.lowered(node, name, args, kw, kind)
            return
        if name == "pow":
            self.pow(node, over, args, kind)
            return
        if name in ("clamp", "clamp_min", "clamp_max"):
            self.clamp(node, name, args, kw, kind)
            return
        if name == "where":
            cond, a, b = (args + (None,) * 3)[:3]
            (cc, ca, cb), _ = self.broadcast(
                self.to(cond, "b"), self.to(a, kind), self.to(b, kind))
            self.set(node, [ssa.val(U_SEL, (c, x, y))
                            for c, x, y in zip(cc, ca, cb)], kind)
            return
        if name == "select":
            x, dim, i = args
            r = self.rank(x)
            if r != 2 or dim % 2 != 0:
                raise Refused("not-elementwise", f"aten.select picks one "
                              "particle (an index along the particle axis)")
            self.set(node, [self.comps_of(x)[i]], self.kind_of(x))
            return
        if name == "unbind":
            x = args[0]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            if self.rank(x) != 2 or dim % 2 != 0:
                raise Refused("not-elementwise", "aten.unbind along the "
                              "particle axis")
            self.vals[node] = [[c] for c in self.comps_of(x)]
            self.kinds[node] = self.kind_of(x)
            return
        if name == "stack":
            seq = args[0]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            if dim != 0 and dim != -2:
                raise Refused("not-elementwise", "aten.stack along the "
                              "particle axis")
            if len(seq) != 3 or any(self.rank(s) > 1 for s in seq):
                raise Refused("op-unsupported", f"aten.stack of {len(seq)} "
                              "values (a value has 1 or 3 components)")
            self.set(node, [self.to(s, kind)[0] for s in seq], kind)
            return
        if name == "expand":
            self.ncomp(node)
            cs = self.comps_of(args[0])
            k = self.ncomp(node)
            self.set(node, cs * k if len(cs) == 1 and k == 3 else cs,
                     self.kind_of(args[0]))
            return
        if name in _REDUCTIONS:
            self.reduce(node, name, over, args, kw, kind)
            return
        if name in _GATHERS:
            raise Refused("not-elementwise", f"aten.{name} reaches across "
                          "particles (a gather, shift, concatenation or "
                          "reshape of the particle axis)")
        if name in ("rand", "randn", "rand_like", "randn_like", "bernoulli",
                    "uniform", "normal", "randint", "multinomial"):
            raise Refused("op-unsupported", f"aten.{name}: randomness only "
                          "through p.uniform()")
        raise Refused("op-unsupported", f"aten.{name}.{over} is not in the "
                      "kernel's instruction table")

    def constant(self, node, t: torch.Tensor):
        """A tensor the callable made from literals: a scalar becomes a
        constant of its kind (a float32 rounded once); any other shape is
        refused where it is used."""
        kind = _kind_of(t.dtype)
        if t.numel() == 1 and kind != "?":
            v = t.reshape(()).item()
            self.set(node, self.to(v, kind) if kind in _TYPED
                     else [self.ssa.const(float(v))], kind)
        else:
            self.vals[node] = _Input("forbidden", why=f"a constant tensor of "
                                     f"shape {tuple(t.shape)} and dtype "
                                     f"{t.dtype} (constants are scalars)")
            self.kinds[node] = "f"

    def convert(self, node, x, dtype):
        """``.to(dtype)``: to a float, an integer (a float truncated
        towards 0, saturating, NaN 0), a float64 or a bool."""
        src = self.kind_of(x)
        dst = _kind_of(dtype) if dtype is not None else (
            src if src in _TYPED else "f")
        if dst == "?":
            raise Refused("op-unsupported", f"aten._to_copy to {dtype} (a "
                          "value is float32, float64, int32, int64 or bool)")
        if src in _TYPED or dst in _TYPED:
            self.set(node, self.to(x, dst), dst)
            return
        cs = self.comps_of(x)
        if dst == "f":
            self.set(node, cs, "f")
        else:
            self.set(node, cs if src == "b" else
                     [self.ssa.val(U_BOOL, (c,)) for c in cs], "b")

    def bitcast(self, node, x, kind):
        """``.view(dtype)`` between float32 and int32, or float64 and
        int64: the same bits."""
        src = self.kind_of(x)
        if src == kind:
            self.set(node, self.comps_of(x), kind)
            return
        if (src, kind) not in _BITCASTS:
            raise Refused("op-unsupported", f"aten.view from {src!r} to "
                          f"{kind!r} (a bitcast between float32 and int32, "
                          "or float64 and int64)")
        t = _REG[kind]
        self.set(node, [self.ssa.val(U_BITCAST, (c,), t, t)
                        for c in self.comps_of(x)], kind)

    def factory(self, node, name, args, kw, kind):
        k = self.ncomp(node)
        if name == "scalar_tensor":
            v = args[0]
        elif name in ("full", "new_full"):
            v = args[1] if name == "full" else args[2]
        elif name in ("full_like",):
            v = args[1]
        elif name in ("zeros", "zeros_like", "new_zeros"):
            v = 0.0
        else:
            v = 1.0
        if kind in _TYPED:
            self.set(node, self.to(int(v) if kind != "d" else v, kind) * k,
                     kind)
            return
        if kind == "b":
            v = 1.0 if v else 0.0
        self.set(node, [self.ssa.const(float(v))] * k, kind if kind == "b"
                 else "f")

    def unary(self, node, name, x, kind):
        ssa = self.ssa
        code = _UNARY[name]
        if not self.typed(x, kinds=(kind,)):
            cs = self.comps_of(x)
            if self.kind_of(x) != "f" and name not in ("abs", "neg"):
                cs = [ssa.val(U_BOOL, (c,)) if self.kind_of(x) == "b" else c
                      for c in cs]
            self.set(node, [ssa.val(code, (c,)) for c in cs],
                     "f" if kind == "f" else self.kind_of(x))
            return
        if kind in ("i", "l"):
            cs = self.to(x, kind)
            if name in ("floor", "ceil", "trunc"):
                self.set(node, cs, kind)
                return
            if name not in ("abs", "neg"):
                raise Refused("op-unsupported", f"aten.{name} of integers")
            self.set(node, [ssa.op(code, c) for c in cs], kind)
            return
        if kind != "d":
            raise Refused("op-unsupported", f"aten.{name} giving {kind!r}")
        self.set(node, [ssa.val(code, (c,)) for c in self.to(x, kind)], kind)

    def binary(self, node, name, args, kw, kind):
        ssa = self.ssa
        alpha = kw.get("alpha", 1)
        a, b = args[0], args[1]
        code = U_SUB if name == "rsub" else _BINARY[name]
        if name == "rsub":
            a, b = b, a
        if code in (U_AND, U_OR, U_XOR):
            if name.startswith("bitwise") and kind in ("i", "l"):
                code = {U_AND: U_BAND, U_OR: U_BOR, U_XOR: U_BXOR}[code]
                ca, cb = self.to(a, kind), self.to(b, kind)
            else:
                ca, cb = self.to(a, "b"), self.to(b, "b")
        elif code in _LOGIC:
            ck = self.promoted(a, b)
            ca, cb = self.to(a, ck), self.to(b, ck)
        else:
            ca, cb = self.to(a, kind), self.to(b, kind)
            if alpha != 1:  # torch.add / sub / rsub: a + alpha * b
                cb = [ssa.op(U_MUL, c, ssa.const(alpha, _REG[kind]))
                      for c in cb]
            if code == U_FMOD and kind in ("i", "l"):
                cb = [_nonzero_divisor(ssa, c) for c in cb]
        (ca, cb), _ = self.broadcast(ca, cb)
        cs = [ssa.binary(code, x, y) for x, y in zip(ca, cb)]
        if kind == "b" and code not in _LOGIC:
            cs = [ssa.val(U_BOOL, (c,)) for c in cs]  # bool + bool: or
        self.set(node, cs, kind)

    def shift(self, node, name, args, kind):
        """``<<`` and ``>>`` of integers (as torch and XLA: 0, or the sign,
        past the width)."""
        if kind not in ("i", "l"):
            raise Refused("op-unsupported", f"aten.{name} giving {kind!r}")
        code = U_SHL if "lshift" in name or "left" in name else U_SHR
        ca, cb = self.to(args[0], kind), self.to(args[1], kind)
        (ca, cb), _ = self.broadcast(ca, cb)
        self.set(node, [self.ssa.binary(code, x, y) for x, y in zip(ca, cb)],
                 kind)

    def clamp(self, node, name, args, kw, kind):
        ssa = self.ssa
        lo = args[1] if len(args) > 1 else kw.get("min")
        hi = args[2] if len(args) > 2 else kw.get("max")
        if name == "clamp_max":
            lo, hi = None, args[1]
        cs = self.to(args[0], kind)
        if lo is not None:
            (cs, cl), _ = self.broadcast(cs, self.to(lo, kind))
            cs = [ssa.binary(U_MAX, a, b) for a, b in zip(cs, cl)]
        if hi is not None:
            (cs, ch), _ = self.broadcast(cs, self.to(hi, kind))
            cs = [ssa.binary(U_MIN, a, b) for a, b in zip(cs, ch)]
        self.set(node, cs, kind)

    def lowered(self, node, name, args, kw, kind):
        """A jnp function over the instructions (:func:`_lower`), per
        component: its operands, broadcast, and its options."""
        if name == "polygamma":
            xs, rest = [args[1]], []
        else:
            xs = list(args[:_LOWERED[name]])
            rest = list(args[len(xs):])

        def arg(key, default=None):
            return rest.pop(0) if rest else kw.get(key, default)

        opt = {}
        if name == "round":
            opt["decimals"] = arg("decimals", 0)
            if opt["decimals"] < 0:
                raise Refused("op-unsupported", f"aten.round with decimals="
                              f"{opt['decimals']} (below 0)")
        elif name == "softplus":
            opt["beta"] = float(arg("beta", 1.0))  # the threshold is moot
        elif name == "logit":
            opt["eps"] = arg("eps")
        elif name == "nan_to_num":
            for key in ("nan", "posinf", "neginf"):
                opt[key] = arg(key)
        elif name in ("addcmul", "addcdiv"):
            opt["value"] = arg("value", 1)
        elif name == "polygamma":
            opt["n"] = int(args[0])
        elif name == "mvlgamma":
            opt["p"] = int(arg("p"))
        elif name == "gelu":
            opt["approximate"] = arg("approximate", "none")
        elif name == "elu":
            for key in ("alpha", "scale", "input_scale"):
                opt[key] = float(arg(key, 1.0))
        ssa = self.ssa
        ck = self.promoted(*xs) if kind == "b" else kind
        if ck in ("i", "l") and name not in _INT_LOWERED:
            raise Refused("op-unsupported", f"aten.{name} of integers")
        if ck == "d" and name in _F32_FORMS:
            raise Refused("op-unsupported", f"aten.{name} in float64 (its "
                          "jnp form here is float32's)")
        if name == "ldexp":  # the exponent keeps its kind
            cs = [self.to(xs[0], ck), self.comps_of(xs[1])]
        else:
            cs = [self.to(x, ck) for x in xs]
        cs, _ = self.broadcast(*cs)
        if name in ("floor_divide", "trunc_divide") and ck in (
                "i", "l") and not all(ssa.is_const(c) and ssa.defs[c][2] != 0
                                      for c in cs[1]):
            raise Refused("op-unsupported", f"aten.{node.target} of integers "
                          "by a value that may be 0 (XLA's result is "
                          "implementation-defined)")
        comps = [_lower(ssa, name, comp, opt) for comp in zip(*cs)]
        if name == "log_sigmoid_forward":  # (output, buffer)
            self.vals[node], self.kinds[node] = [comps, comps], [kind, kind]
            return
        self.set(node, comps, kind)

    def frexp(self, node, x):
        """``torch.frexp``: (mantissa, int32 exponent), ``jnp.frexp``'s
        bits."""
        if self.kind_of(x) == "d":
            raise Refused("op-unsupported", "aten.frexp in float64 (its jnp "
                          "form here is float32's)")
        outs = [_frexp(self.ssa, c) for c in self.to(x, "f")]
        self.vals[node] = [[m for m, _ in outs], [e for _, e in outs]]
        self.kinds[node] = ["f", "i"]

    def pow(self, node, over, args, kind):
        """A power: an integer exponent ``lax.integer_pow``'s products (of
        integers, which wrap), a float one ``pow`` in the value's float
        type."""
        ssa = self.ssa
        base, ex = args[0], args[1]
        ints = kind in ("i", "l")
        if over != "Scalar" and (isinstance(ex, bool) or not isinstance(
                ex, (int, float, torch.fx.Node))):
            raise Refused("op-unsupported", f"aten.pow with exponent {ex!r}")
        if isinstance(ex, int) and over != "Scalar":
            if abs(ex) > 1 << 24 or (ints and ex < 0):
                raise Refused("op-unsupported", f"integer exponent {ex}")
            self.set(node, [ssa.val(U_IPOW, (c,), int(ex))
                            for c in self.to(base, kind)], kind)
            return
        if ints:
            raise Refused("op-unsupported", "aten.pow of integers to an "
                          "integer tensor")
        if isinstance(ex, float) and ex == 0.5 and over != "Scalar":
            self.set(node, [ssa.val(U_SQRT, (c,))
                            for c in self.to(base, kind)], kind)
            return
        (cb, ce), _ = self.broadcast(self.to(base, kind), self.to(ex, kind))
        self.set(node, [ssa.val(U_POW, (x, y)) for x, y in zip(cb, ce)],
                 kind)

    def reduce(self, node, name, over, args, kw, kind):
        ssa = self.ssa
        x = args[0]
        if name == "linalg_vector_norm":
            ord_ = args[1] if len(args) > 1 else kw.get("ord", 2)
            dims = args[2] if len(args) > 2 else kw.get("dim")
        else:
            dims = args[1] if len(args) > 1 else kw.get("dim")
        keep = (args[2] if len(args) > 2 and name != "linalg_vector_norm"
                else kw.get("keepdim", False))
        part, comp = self.particle_dims(x, dims)
        if part:
            raise Refused("not-elementwise", f"aten.{name} over the particle "
                          "axis (a cross-particle reduction)")
        typed = self.typed(x, kinds=(kind,))
        if not comp:
            self.set(node, self.to(x, kind) if typed and kind != "b"
                     else list(self.comps_of(x)), kind)
            return
        if keep:
            raise Refused("op-unsupported", f"aten.{name} with keepdim")
        cs = self.to(x, kind) if typed and kind != "b" else self.comps_of(x)
        if name == "sum":
            v = ssa.binary(U_ADD, ssa.binary(U_ADD, cs[0], cs[1]), cs[2])
        elif name in ("amax", "max") and over in ("default", "dim"):
            v = ssa.binary(U_MAX, ssa.binary(U_MAX, cs[0], cs[1]), cs[2])
        elif name in ("amin", "min") and over in ("default", "dim"):
            v = ssa.binary(U_MIN, ssa.binary(U_MIN, cs[0], cs[1]), cs[2])
        elif name == "linalg_vector_norm" and ord_ == 2:
            sq = [ssa.binary(U_MUL, c, c) for c in cs]
            v = ssa.val(U_SQRT, (ssa.binary(U_ADD, ssa.binary(
                U_ADD, sq[0], sq[1]), sq[2]),))
        elif name in ("any", "all"):
            bs = [c if self.kind_of(x) == "b" else ssa.val(U_BOOL, (c,))
                  for c in self.comps_of(x)]
            code = U_OR if name == "any" else U_AND
            v = ssa.binary(code, ssa.binary(code, bs[0], bs[1]), bs[2])
        else:
            raise Refused("op-unsupported", f"aten.{name} over the "
                          "component axis")
        if name in ("max", "min") and over == "dim":
            raise Refused("op-unsupported", f"aten.{name}.dim (values and "
                          "indices)")
        self.set(node, [v], kind)


# -- tracing ---------------------------------------------------------------------

# the particle counts a callable is traced at: a program that differs
# between them depends on the population's capacity (neither is 1 or 3,
# so a value's shape tells its components from its particles)
_SIZES = (7, 11)


class _CtxUse(Exception):
    """A KernelStep fn touched its ctx: the attribute names the
    capability it wanted."""


class KernelCtxTrip:
    """The ``ctx`` a recorded KernelStep fn gets: any attribute access
    raises (randomness needs ElementwiseStep's ``p.uniform()``, records
    ReduceMeasureStep), and the recorder refuses with code ``ctx``."""

    def __getattr__(self, name):
        raise _CtxUse(name)


class _StateUse(Exception):
    """A KernelStep fn touched a state field the kernel's facade cannot
    give it (``a`` reads zeros in the JAX kernel, ``extras`` are absent)."""


def _trip_raise(self, *a, **k):
    raise _StateUse(object.__getattribute__(self, "_name"))


class _TripLeaf:
    """Stand-in for a SimState field of the facade that the kernel cannot
    honour: any read (arithmetic, indexing, conversion, a torch function)
    raises :class:`_StateUse`."""

    def __init__(self, name):
        object.__setattr__(self, "_name", name)

    def __getattr__(self, attr):
        raise _StateUse(object.__getattribute__(self, "_name"))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        leaf = next(a for a in list(args) + list((kwargs or {}).values())
                    if isinstance(a, _TripLeaf))
        raise _StateUse(object.__getattribute__(leaf, "_name"))


for _dunder in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
                "__rfloordiv__", "__mod__", "__rmod__", "__pow__",
                "__rpow__", "__matmul__", "__rmatmul__", "__neg__",
                "__pos__", "__abs__", "__lt__", "__le__", "__gt__",
                "__ge__", "__eq__", "__ne__", "__getitem__", "__iter__",
                "__len__", "__bool__", "__float__", "__int__", "__index__",
                "__array__", "__and__", "__rand__", "__or__", "__ror__",
                "__xor__", "__rxor__", "__invert__"):
    setattr(_TripLeaf, _dunder, _trip_raise)
del _dunder
_TripLeaf.__hash__ = object.__hash__


class _TripExtras:
    """Stand-in for ``state.extras`` on the facade: reading it raises
    :class:`_StateUse`; a fn that replaces it is refused as an ignored
    write."""

    def _trip(self, *a, **k):
        raise _StateUse("extras")

    __getitem__ = get = keys = values = items = __iter__ = __len__ = \
        __contains__ = __bool__ = _trip


class _Return(Exception):
    pass


class _Contract(ValueError):
    """A returned value that breaks the step's contract: raised as the JAX
    package raises it when it traces the fn (an error, not a refusal)."""


def _ndtr(x):
    """``jax.scipy.special.ndtr``'s form (torch's own traces as ``0.5 (1 +
    erf(x / sqrt 2))``): ``erf`` near 0, ``erfc`` in the tails."""
    h = float(np.float32(0.5) * np.sqrt(2.0, dtype=np.float32))
    w = x * h
    z = torch.abs(w)
    return 0.5 * torch.where(z < h, 1.0 + torch.erf(w), torch.where(
        w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))


class _JnpForms(torch.overrides.TorchFunctionMode):
    """While a callable is traced: the torch functions whose aten
    decomposition is not the jnp function's form, in that form."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.special.ndtr:
            return _ndtr(*args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))


def _make_fx(body, examples):
    from torch.fx.experimental.proxy_tensor import make_fx

    with _JnpForms():
        return make_fx(body, tracing_mode="fake")(*examples)


def _traced(body, examples, label: str, fail: str):
    """``make_fx`` of ``body``; a fn's own exception becomes ``Refused(
    fail)``, Python control flow on a value ``trace``, a data-dependent
    shape ``not-elementwise``."""
    try:
        return _make_fx(body, examples)
    except (Refused, _CtxUse, _StateUse, _Return, _Contract):
        raise
    except Exception as e:  # the user's fn, run under fake tensors
        what = type(e).__name__
        if "DataDependent" in what or "GuardOn" in what:
            raise Refused("trace", f"{label} branches on a value ({what}): "
                          "Python control flow cannot follow a per-particle "
                          "value; use torch.where") from None
        if "DynamicOutputShape" in what:
            raise Refused("not-elementwise", f"{label} makes a value whose "
                          "length depends on the data (a mask index or a "
                          "nonzero)") from None
        raise Refused(fail, f"{label} failed recording ({what}: {e})") \
            from None


def _plane_inputs(n, planes):
    """Example tensors and ``_Input``s for per-particle planes: ``planes``
    is a list of ``(plane number, dtype)`` (13 is the alive mask)."""
    ex, ins = [], []
    for p, dt in planes:
        ex.append(torch.zeros(n, dtype=dt))
        ins.append(_Input("plane", (p,), _kind_of(dt)))
    return ex, ins


def _same_at_sizes(record, label: str) -> Program:
    """``record(n)`` at both trace sizes; a program that differs depends on
    the particle count."""
    progs = [record(n) for n in _SIZES]
    # compared by their constants' bits (a NaN constant equals itself)
    keys = [tuple(tuple(struct.pack("<d", v) if isinstance(v, float) else v
                        for v in ins)
                  for ins in prog.ins) + (prog.n_regs, prog.n_draws,
                                          prog.types)
            for prog in progs]
    if keys[0] != keys[1]:
        raise Refused("not-elementwise", f"{label} depends on the population "
                      "capacity: its program changes with the particle "
                      "count (inside the kernel the count is one tile)")
    return progs[0]


def _leaves(name, val, rows, n):
    """The components of one returned value: ``rows`` of them (a tuple or
    a ``(3, N)`` tensor for a 3-row plane)."""
    if rows == 1:
        return [(name, 0, val)]
    comps = tuple(val) if isinstance(val, (tuple, list)) or (
        isinstance(val, torch.Tensor) and val.dim() == 2) else (val,)
    if len(comps) != rows:
        raise _Contract(f"extras_write plane {name!r} has {rows} rows; "
                         f"update returned {len(comps)} components")
    return [(name, i, c) for i, c in enumerate(comps)]


def record_particle_fn(fn: Callable, who: str, view_extras=(),
                       writable=(), outputs=None, f0: int = 0,
                       sink: int = U_ACC) -> Program:
    """Record a ``ParticleView`` callable: an ``ElementwiseStep`` body
    (``outputs`` None: its returned fields and ``writable`` extras become
    plane stores, ``alive`` an alive clear) or a ``ReduceMeasureStep``'s
    contributions (``outputs`` the declared names: record sums into float
    columns ``f0, f0 + 1, ...``; with ``sink=U_ST`` stores to outputs
    ``f0, f0 + 1, ...`` instead, as a field program's, which
    :func:`record_binned` takes). ``view_extras`` are the declared extras
    as ``(name, first packed plane, rows)``. Raises :class:`Refused` or,
    for a broken contract, ``ValueError`` as the JAX package does when it
    traces the fn."""
    from physicl_tpu_torch.engine import ParticleView

    fields = ParticleView._FIELDS
    label = f"{who} fn"
    rows_of = {name: (p0, rows) for name, p0, rows in view_extras}

    def record(n, n_rows=DRAW_ROWS):
        planes = [(i, torch.bool if nm == "alive" else torch.float32)
                  for i, nm in enumerate(fields)]
        for _, p0, rows in view_extras:
            planes += [(p0 + i, torch.float32) for i in range(rows)]
        examples, inputs = _plane_inputs(n, planes)
        examples += [torch.zeros(()), torch.zeros(()),
                     torch.zeros((n_rows, n))]
        inputs += [_Input("t"), _Input("dt"), _Input("draws")]
        side = {}

        def body(*a):
            view_f = dict(zip(fields, a[:15]))
            pos, ex = 15, {}
            for name, _, rows in view_extras:
                comps = tuple(a[pos:pos + rows])
                pos += rows
                ex[name] = comps[0] if rows == 1 else comps
            t, dt, draws = a[pos:pos + 3]
            count = [0]

            def uniform():
                # past the placeholder's rows a stand-in row: the count
                # then sizes the placeholder of a second recording
                count[0] += 1
                return draws[min(count[0], n_rows) - 1]

            upd = fn(ParticleView(view_f, t, dt, uniform, extras=ex))
            side["n_draws"] = count[0]
            if outputs is None:
                bad = set(upd) - set(fields) - set(writable)
                if bad:
                    raise _Contract(
                        f"ElementwiseStep returned unknown fields {bad} "
                        f"(transport fields or extras_write="
                        f"{tuple(writable)} only)")
                leaves = []
                for name, val in upd.items():
                    rows = rows_of[name][1] if name in writable else 1
                    leaves += _leaves(name, val, rows, n)
            else:
                missing = set(outputs) - set(upd)
                if missing:
                    raise _Contract(
                        f"ReduceMeasureStep fn did not return declared "
                        f"outputs {sorted(missing)}")
                leaves = [(name, 0, upd[name]) for name in outputs]
            side["leaves"] = leaves
            return [v for _, _, v in leaves if isinstance(v, torch.Tensor)]

        gm = _traced(body, examples, label, "probe-error")
        if side["n_draws"] > n_rows:
            return record(n, side["n_draws"])
        ssa = _SSA()
        tr = _Translator(gm, inputs, n, ssa)
        out = iter(tr.run())
        for j, (name, i, v) in enumerate(side["leaves"]):
            node = next(out) if isinstance(v, torch.Tensor) else v
            cs = tr.comps_of(node)
            if len(cs) != 1:
                raise Refused("shape", f"{label} returns {name!r} with 3 "
                              "components where one value per particle is "
                              "expected")
            c = cs[0]
            if outputs is not None:
                ssa.effects.append((sink, _to_float(ssa, c), f0 + j))
            elif name == "alive":
                if c != ssa.val(U_LD, (), ALIVE_PLANE):
                    ssa.effects.append((U_ALIVE, _to_alive(ssa, c), 0))
            else:
                plane = (rows_of[name][0] + i if name in writable
                         else fields.index(name))
                if c != ssa.val(U_LD, (), plane):
                    ssa.effects.append((U_ST, _to_float(ssa, c), plane))
        return _schedule(ssa, side["n_draws"])

    return _same_at_sizes(record, label)


def record_binned(binning, who: str) -> Program:
    """Record a histogram tally's coordinate and value
    (``light.Binning.coord_value``) into one program of one output (the
    coordinate, for a count) or two (then the value): output ``j`` a store
    to ``j``, as a field program's. The binned reduce's kernel code and
    :func:`run_binned` take the bin index and the sum from there."""

    def fn(p):
        coord, val = binning.coord_value(p)
        return {"coord": coord} if val is None else {"coord": coord,
                                                     "value": val}

    names = ("coord",) if binning.value is None else ("coord", "value")
    return record_particle_fn(fn, who, outputs=names, sink=U_ST)


_KSTATE_OUT = ("r", "dr", "v", "dv", "E", "w", "alive")


def record_kernelstep(fn: Callable, otype_plane: int = -1,
                      species: int = 0) -> Program:
    """Record a ``KernelStep(elementwise=True)`` fn, a ``SimState ->
    SimState`` map, over the kernel's facade: ``r``, ``dr``, ``v``, ``dv``,
    ``E``, ``w``, ``alive`` and ``otype`` (the plane ``otype_plane`` of a
    mixed plan, else the constant ``species``) as planes, ``t`` and ``dt``
    from the schedule, ``a`` and ``extras`` poisoned, no PRNG key. The
    transport fields it returns are stored, ``alive`` only clears.
    Refusal codes as the JAX prover's (prefixed ``kernelstep-``): ``ctx``,
    ``state``, ``trace``, ``return``, ``shape``, ``ignored-write``,
    ``not-elementwise``; and ``op-unsupported``."""
    from physicl_tpu_torch.state import SimState

    label = "KernelStep(elementwise=True) fn"

    def trace(n):
        examples = [torch.zeros((3, n)) for _ in range(4)]
        inputs = [_Input("plane", (3 * j, 3 * j + 1, 3 * j + 2))
                  for j in range(4)]
        ex, ins = _plane_inputs(n, [(12, torch.float32), (13, torch.bool)])
        examples += ex + [torch.zeros(n, dtype=torch.int32),
                          torch.zeros(n), torch.zeros(()), torch.zeros(()),
                          torch.zeros((), dtype=torch.int32), torch.zeros(())]
        inputs += ins + [
            _Input("plane", (otype_plane,), "i") if otype_plane >= 0
            else _Input("const", (float(species),), "i"),
            _Input("plane", (14,)), _Input("t"), _Input("dt"),
            _Input("state", why=f"{label} reads state.n_spawned, which the "
                   "kernel's facade does not carry"),
            _Input("state", why=f"{label} reads state.t_comp, which the "
                   "kernel's facade does not carry")]
        side = {}

        def body(r, dr, v, dv, E, alive, otype, w, t, dt, ns, tc):
            a, extras = _TripLeaf("a"), _TripExtras()
            st = SimState(r=r, dr=dr, v=v, dv=dv, a=a, E=E, alive=alive,
                          otype=otype, w=w, t=t, dt=dt, key=None,
                          n_spawned=ns, t_comp=tc, extras=extras)
            out = fn(st, KernelCtxTrip())
            if not isinstance(out, SimState):
                raise _Return(type(out).__name__)
            if out.a is not a:
                side["ignored"] = "a"
            elif out.extras is not extras:
                side["ignored"] = "extras"
            for nm, x in (("t", t), ("dt", dt), ("n_spawned", ns),
                          ("t_comp", tc)):
                if getattr(out, nm) is not x:
                    side.setdefault("ignored", nm)
            for nm in _KSTATE_OUT:
                want = (3, n) if nm in ("r", "dr", "v", "dv") else (n,)
                got = tuple(getattr(getattr(out, nm), "shape", ()))
                if got != want:
                    side.setdefault("shape", (nm, want, got))
            return [getattr(out, nm) for nm in _KSTATE_OUT]

        try:
            gm = _traced(body, examples, label, "trace")
        except _CtxUse as e:
            want = str(e)
            hint = ("randomness needs ElementwiseStep's p.uniform()"
                    if "key" in want or "rng" in want else
                    "measurement needs ReduceMeasureStep"
                    if want == "record" else
                    "host/sim access is not elementwise")
            raise Refused("ctx", f"{label} uses ctx.{want}: {hint}") \
                from None
        except _StateUse as e:
            what = str(e)
            hint = ("the kernel's facade has no accelerations (the JAX "
                    "kernel reads zeros)" if what == "a" else
                    "the kernel's facade carries no extras planes (use "
                    "ElementwiseStep with extras=)")
            raise Refused("state", f"{label} uses state.{what}: {hint}") \
                from None
        except _Return as e:
            raise Refused("return", f"{label} must return a SimState, got "
                          f"{e}") from None
        return gm, side, inputs

    # the contract's refusals at both sizes first (a slice may keep the
    # shape at one size), then the programs
    traced = {n: trace(n) for n in _SIZES}
    for gm, side, _ in traced.values():
        if "ignored" in side:
            nm = side["ignored"]
            raise Refused("ignored-write", f"{label} writes state.{nm}, "
                          "which the fused kernel ignores but the generic "
                          "tier applies"
                          + (" (use ElementwiseStep with extras_write=)"
                             if nm == "extras" else ""))
        if "shape" in side:
            nm, want, got = side["shape"]
            raise Refused("shape", f"{label} changed the shape of state.{nm}"
                          f" ({want} -> {got}): not a per-particle map")

    def record(n):
        gm, side, inputs = traced[n]
        ssa = _SSA()
        tr = _Translator(gm, inputs, n, ssa)
        out = tr.run()
        for nm, node in zip(_KSTATE_OUT, out):
            cs = tr.comps_of(node)
            if nm == "alive":
                if cs[0] != ssa.val(U_LD, (), ALIVE_PLANE):
                    ssa.effects.append((U_ALIVE, _to_alive(ssa, cs[0]), 0))
                continue
            base = {"r": 0, "dr": 3, "v": 6, "dv": 9, "E": 12, "w": 14}[nm]
            for i, c in enumerate(cs):
                if c != ssa.val(U_LD, (), base + i):
                    ssa.effects.append((U_ST, _to_float(ssa, c), base + i))
        return _schedule(ssa, 0)

    return _same_at_sizes(record, label)


# -- callable fields (the field programs of ops/fields.py) ---------------------


def record_field(fn: Callable, varnames: Tuple[str, ...], label: str,
                 ncomp: int = 1):
    """Record a torch callable ``fn(*varnames)`` (``variable_n_fn(r0, r1,
    r2)``, ``A_fn(E)``, ``cos_theta_icdf(u)``, or with ``ncomp=3`` a
    ``LorentzForceStep`` field returning three components) into one field
    program of :mod:`physicl_tpu_torch.ops.fields`: the recorder's own
    instructions (selects and comparisons included), variable ``i`` a load
    of plane ``i``, output ``j`` a store to ``j`` (a component that is a
    Python number a constant). The callable is traced once, so the
    components' shared subexpressions are computed once. Returns a field
    callable with that ``spec`` (its plain version runs the program).
    Raises :class:`Refused` with code ``field-fn-callable`` where the
    callable cannot be recorded."""
    from physicl_tpu_torch.ops import fields as FL

    def record(n):
        examples, inputs = _plane_inputs(
            n, [(i, torch.float32) for i in range(len(varnames))])

        def as_plane(out):
            if not isinstance(out, torch.Tensor):
                out = torch.full((n,), float(out))
            return out

        def body(*a):
            out = fn(*a)
            if ncomp == 1:
                return [as_plane(out)]
            comps = (tuple(out) if isinstance(out, (tuple, list))
                     or (isinstance(out, torch.Tensor) and out.dim() == 2)
                     else (out,))
            if len(comps) != ncomp:
                raise _Contract(f"{label} returns {len(comps)} components, "
                                f"not {ncomp}")
            return [as_plane(c) for c in comps]

        try:
            gm = _traced(body, examples, label, "field-fn-callable")
        except _Contract as e:
            raise Refused("field-fn-callable", str(e)) from None
        ssa = _SSA()
        tr = _Translator(gm, inputs, n, ssa)
        for j, node in enumerate(tr.run()):
            cs = tr.comps_of(node)
            if len(cs) != 1:
                raise Refused("field-fn-callable", f"{label} returns "
                              f"{len(cs)} components where it should "
                              "return one per slot")
            ssa.effects.append((U_ST, _to_float(ssa, cs[0]), j))
        return _schedule(ssa, 0)

    try:
        prog = _same_at_sizes(record, label)
    except Refused as e:
        raise Refused("field-fn-callable", e.detail) from None
    name = getattr(fn, "__name__", "callable")
    return FL.expr_field(prog, varnames, f"<recorded {name}>", n_out=ncomp)


# -- the plain version ------------------------------------------------------------


def run_user_program(prog: Program, f: list, alive: torch.Tensor, t, dt,
                     rng, rec_f_row: Optional[torch.Tensor] = None):
    """Plain version of a compiled user program over one chunk iteration's
    planes ``f`` (the packed planes as a list of ``(C,)`` float32 tensors;
    stores replace entries), the ``alive`` mask, the 0-d ``t`` and ``dt``
    of the op's place, and the iteration's counter-hash ``rng`` (advanced
    by the program's draws). Record sums go to ``rec_f_row``. Every value
    is a ``(C,)`` tensor (a scalar expanded), so no torch operation sees a
    0-d operand: torch divides by a CPU scalar on the card as a product
    with its reciprocal and raises to a scalar power through special
    cases. Returns the new alive mask."""
    C = alive.shape[0]
    dev = alive.device

    def full(x, t=F32):
        return torch.full((), x if t != F32 else float(x),
                          dtype=DTYPES[t], device=dev).expand(C)

    one = full(1.0)
    t, dt = t.to(dev, torch.float32).expand(C), dt.to(
        dev, torch.float32).expand(C)
    regs: List[Optional[torch.Tensor]] = [None] * prog.n_regs
    base = rng.idx
    for ins, ty in zip(prog.ins, prog.type_list()):
        code, d, a, _, y, _ = ins
        va = regs[a]
        if code == U_ST:
            f[y] = va
            continue
        if code == U_ALIVE:
            alive = alive & (va != 0)
            f[ALIVE_PLANE] = alive.to(torch.float32)
            continue
        if code == U_ACC:
            rec_f_row[y] = torch.where(alive, va, 0.0).sum()
            continue
        if code == U_LD:
            v = alive.to(torch.float32) if y == ALIVE_PLANE else f[y]
        elif code == U_T:
            v = t
        elif code == U_DT:
            v = dt
        elif code == U_UNIF:
            v = rng.uniform_at(base + y + 1)
        else:
            v = _pure(ins, regs, full, one, ty)
        regs[d] = v
    rng.idx = base + prog.n_draws
    return alive


def bin_columns(coord: torch.Tensor, alive: torch.Tensor,
                edges: torch.Tensor, underflow: bool,
                overflow: bool) -> torch.Tensor:
    """Each slot's column among a binned tally's (the bins, then
    underflow, then overflow), or -1: the comparisons of the reference's
    masks against the float32 ``edges`` (``coord >= e[i] and coord <
    e[i+1]``, ``coord < e[0]``, ``coord >= e[-1]``), as the number of
    edges at or below the coordinate. A NaN coordinate, a dead slot, and a
    coordinate outside the edges without its capture bin fall in none."""
    n_e = edges.numel()
    n = torch.searchsorted(edges, coord.contiguous(), right=True)
    col = n - 1
    col = torch.where(n == 0, n_e - 1 if underflow else -1, col)
    col = torch.where(n == n_e, n_e - 1 + int(underflow) if overflow
                      else -1, col)
    return torch.where(alive & ~torch.isnan(coord), col, -1)


def run_binned(bins, prog: Program, f: list, alive: torch.Tensor,
               rec_f_row: torch.Tensor) -> None:
    """Plain version of a binned reduce (``ops/fused.py:Bins``) over one
    chunk iteration's planes ``f``: the coordinate and value program
    (:func:`record_binned`), each slot's column (:func:`bin_columns`), and
    the values (1 for a count) added into their columns of ``rec_f_row``
    (the op's ``bins.n_cols`` columns, written whole) by ``index_add_`` in
    float64, then rounded once: a float32 sum in slot order would drift
    from the kernel's and the reference's tree-ordered sums by ~n ulp."""
    planes = list(f)
    planes[ALIVE_PLANE] = alive.to(torch.float32)
    out = run_field(prog, planes, 1 if bins.count else 2)
    coord = out if bins.count else out[0]
    edges = torch.tensor(bins.edges, dtype=torch.float32,
                         device=alive.device)
    col = bin_columns(coord, alive, edges, bins.underflow, bins.overflow)
    keep = col >= 0
    val = (torch.ones_like(coord) if bins.count else out[1])[keep]
    rec_f_row[:bins.n_cols] = torch.zeros(
        bins.n_cols, dtype=torch.float64, device=alive.device).index_add_(
            0, col[keep], val.double()).float()


def _pure(ins, regs, full, one, t=F32) -> torch.Tensor:
    """The value of one pure instruction (every code but the loads, draws,
    stores, alive clears and record sums) of type ``t`` over the registers
    ``regs``: the operation its generated C (ops/codegen.py) matches, in
    the torch dtype of its type; ``full(y, t)`` a constant as a
    full-length tensor, ``one`` float32 1.0 so."""
    code, _, a, b, y, bimm = ins
    va = regs[a]
    if code == U_CONST:
        return full(y, t)
    if code == U_CVT:
        return _convert(va, t)
    if code == U_BITCAST:
        return va.contiguous().view(DTYPES[t])
    if code == U_SEL:
        if bimm:
            return torch.where(va != 0, regs[b], full(y, t))
        return torch.where(va != 0, regs[y], regs[b])
    if code == U_NOT:
        return (va == 0).to(torch.float32)
    if code == U_BOOL:
        return (va != 0).to(torch.float32)
    if code == U_IPOW:
        return _ipow(va, int(y))
    if t in INT_BITS and code not in _LOGIC:
        return _pure_int(code, va, full(y, t) if bimm else regs[b], t)
    if code == U_NEG:
        return -va
    if code == U_ABS:
        return va.abs()
    if code == U_SQRT:
        return _sqrt_rn(va) if t == F32 else _sqrt_f64(va)
    if code == U_RECIP:
        return torch.div(one if t == F32 else full(1.0, t), va)
    if code == U_RSQRT and t == F64:
        return torch.div(full(1.0, t), _sqrt_f64(va))
    if code in _TWIN_UNARY:
        return _TWIN_UNARY[code](va)
    if code in _TWIN_BINARY:
        vb = regs[b]
        if bimm:  # a compare's immediate has its operand's type
            vb = full(y, _TYPE_OF[va.dtype])
        return _TWIN_BINARY[code](va, vb)
    raise ValueError(f"program code {code}")


_TYPE_OF = {v: k for k, v in DTYPES.items()}


def _pure_int(code, va, vb, t) -> torch.Tensor:
    """An integer instruction of type ``t``: two's complement, wrapping;
    a division by a nonzero constant and a remainder towards 0 (by -1 the
    remainder 0); a shift past the width 0 (``<<``) or the sign
    (``>>``), as XLA and torch define them."""
    n = INT_BITS[t]
    if code == U_NEG:
        return -va
    if code == U_ABS:
        return va.abs()
    if code == U_BNOT:
        return torch.bitwise_not(va)
    if code in (U_ADD, U_SUB, U_MUL, U_MIN, U_MAX, U_BAND, U_BOR, U_BXOR):
        return _INT_BINARY[code](va, vb)
    if code == U_DIV:
        return torch.div(va, vb, rounding_mode="trunc")
    if code == U_FMOD:
        m1 = vb == -1
        return torch.where(m1, torch.zeros_like(va),
                           torch.fmod(va, torch.where(m1, 1, vb)))
    ok = (vb >= 0) & (vb < n)
    if code == U_SHL:
        return torch.where(ok, torch.bitwise_left_shift(
            va, torch.where(ok, vb, 0)), torch.zeros_like(va))
    if code == U_SHR:
        return torch.bitwise_right_shift(va, torch.where(ok, vb, n - 1))
    raise ValueError(f"integer program code {code}")


_INT_BINARY = {U_ADD: torch.add, U_SUB: torch.sub, U_MUL: torch.mul,
               U_MIN: torch.minimum, U_MAX: torch.maximum,
               U_BAND: torch.bitwise_and, U_BOR: torch.bitwise_or,
               U_BXOR: torch.bitwise_xor}


def _convert(x: torch.Tensor, t: str) -> torch.Tensor:
    """``x`` converted to type ``t`` as the kernel's C converts it: a
    float to an integer truncated towards 0, saturating at the type's
    range, NaN 0 (``cvt.rzi``); an integer or float64 to a float rounded
    to nearest; an integer narrowed by its low bits."""
    dst = DTYPES[t]
    if x.dtype == dst:
        return x
    if t in INT_BITS and x.is_floating_point():
        n = INT_BITS[t]
        xd = torch.nan_to_num(x.double(), nan=0.0)
        big, small = xd >= 2.0 ** (n - 1), xd < -2.0 ** (n - 1)
        out = torch.where(big | small, 0.0, xd).trunc().to(dst)
        out = torch.where(big, (1 << (n - 1)) - 1, out)
        return torch.where(small, -(1 << (n - 1)), out)
    return x.to(dst)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the kernel's ``sqrtf``)."""
    return torch.sqrt(x.double()).float()


def _sqrt_f64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root (the kernel's ``sqrt``):
    torch's on the card; on the CPU numpy's, as torch's vectorized one
    misses by an ulp."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``lax.integer_pow``: binary exponentiation, 1/x^|y| for y < 0."""
    if y == 0:
        return torch.ones_like(x)
    neg, y = y < 0, abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return torch.ones_like(acc) / acc if neg else acc


def run_field(prog: Program, args, n_out: int = 1):
    """Plain version of a field program (:func:`record_field`,
    ``ops/fields.py:compile_expr``) over the variables ``args`` (tensors of
    one shape, or broadcastable to one), in float32: the output, or a tuple
    of ``n_out`` outputs."""
    args = [torch.as_tensor(x).to(torch.float32) for x in args]
    shape = torch.broadcast_shapes(*(x.shape for x in args))
    dev = args[0].device
    args = [x.expand(shape) for x in args]

    def full(x, t=F32):
        return torch.full((), x if t != F32 else float(x),
                          dtype=DTYPES[t], device=dev).expand(shape)

    one = full(1.0)
    regs: List[Optional[torch.Tensor]] = [None] * prog.n_regs
    out: List[Optional[torch.Tensor]] = [None] * n_out
    for ins, ty in zip(prog.ins, prog.type_list()):
        code, d, a, _, y, _ = ins
        if code == U_ST:
            out[y] = regs[a]
        elif code == U_LD:
            regs[d] = args[y]
        else:
            regs[d] = _pure(ins, regs, full, one, ty)
    return out[0] if n_out == 1 else tuple(out)


def _cmp(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


def _bit(fn):
    return lambda a: fn(a).to(torch.float32)


# each code's libm function on the card is torch's own op there (the
# kernel's expf, atanf, erff, lgammaf, ... of a float32); rsqrt is a
# correctly rounded square root's reciprocal, as U_RSQRT's C
_TWIN_UNARY = {U_EXP: torch.exp, U_LOG: torch.log, U_LOG10: torch.log10,
               U_SIN: torch.sin, U_COS: torch.cos, U_TAN: torch.tan,
               U_FLOOR: torch.floor, U_CEIL: torch.ceil,
               U_TRUNC: torch.trunc, U_ATAN: torch.atan, U_ASIN: torch.asin,
               U_ACOS: torch.acos, U_SINH: torch.sinh, U_COSH: torch.cosh,
               U_TANH: torch.tanh, U_ASINH: torch.asinh,
               U_ACOSH: torch.acosh, U_ATANH: torch.atanh,
               U_EXP2: torch.exp2, U_EXPM1: torch.expm1, U_LOG2: torch.log2,
               U_LOG1P: torch.log1p, U_ERF: torch.erf, U_ERFC: torch.erfc,
               U_LGAMMA: torch.lgamma, U_ROUND: torch.round,
               U_RSQRT: lambda a: torch.div(torch.ones_like(a),
                                            _sqrt_rn(a)),
               U_ISNAN: _bit(torch.isnan), U_SIGNBIT: _bit(torch.signbit)}
_TWIN_BINARY = {
    U_ADD: torch.add, U_SUB: torch.sub, U_MUL: torch.mul, U_DIV: torch.div,
    U_POW: torch.pow, U_MIN: torch.minimum, U_MAX: torch.maximum,
    U_ATAN2: torch.atan2, U_FMOD: torch.fmod, U_COPYSIGN: torch.copysign,
    U_NEXTAFTER: torch.nextafter,
    U_LT: _cmp(torch.lt), U_LE: _cmp(torch.le), U_GT: _cmp(torch.gt),
    U_GE: _cmp(torch.ge), U_EQ: _cmp(torch.eq), U_NE: _cmp(torch.ne),
    U_AND: lambda a, b: ((a != 0) & (b != 0)).to(torch.float32),
    U_OR: lambda a, b: ((a != 0) | (b != 0)).to(torch.float32),
    U_XOR: lambda a, b: ((a != 0) ^ (b != 0)).to(torch.float32)}
