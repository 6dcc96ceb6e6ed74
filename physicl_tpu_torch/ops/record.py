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
``logaddexp2``, ``ldexp`` and ``frexp`` (jnp's bits), ``F.gelu`` (both
forms), ``F.elu`` and ``F.logsigmoid`` (``jax.nn``'s), ``special.gammainc``
/ ``gammaincc`` (jnp's ``igamma`` / ``igammac``: the series and the
continued fraction each a bounded loop, :meth:`_SSA.loop`) and
``special.bessel_j0`` / ``j1`` (Cephes' form as torch computes it, not
jnp's recurrence: :func:`_bessel_j`); in float64 the ones whose form is
float32's (coefficient tables, float32's epsilon) are refused. Refused as
``op-unsupported`` naming the op, with no jnp counterpart:
``special.erfcx`` and torch-only functions such as ``bessel_y0`` and
``modified_bessel_k0``.

The program is register code over per-component SSA values: common
subexpressions merged, unused values dropped, the side effects (plane
stores, alive clears, float record sums) kept in order, and registers
assigned by liveness. A libm function of constants is folded on the host
to its correctly rounded value (:func:`fold_libm`), as XLA's constant
folding does. The lowered functions' Horner and Clenshaw steps are
float32 fused multiply-adds (``U_FMA``, rounded once; the twin computes it
exactly, :func:`fma_f32`); the user's own ``a * b + c`` stays a product
and a sum. A bounded loop (``U_CARRY`` ... ``U_END``) carries values
through a body of pure instructions while a lane's condition holds, at
most a static number of iterations: per lane in the kernel, over the whole
tensor with a disabled lane's values kept by select in the twin
(:func:`_run_loop`), which gives jnp's ``while_loop`` values. Its length,
registers and draws have no limit: each plan's programs are compiled for
it.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import math
import operator
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import mpmath
import numpy as np
import torch

# instruction codes (ops/codegen.py turns each into C); the libm codes
# from U_ATAN on came after the first 41, whose numbers stay as they were;
# U_FMA is a float32 fused multiply-add, U_CARRY ... U_END a bounded loop
# (:meth:`_SSA.loop`), U_OUT a loop's result in the SSA only
(U_LD, U_T, U_DT, U_CONST, U_UNIF, U_NEG, U_ABS, U_SQRT, U_EXP, U_LOG,
 U_LOG10, U_SIN, U_COS, U_TAN, U_FLOOR, U_CEIL, U_TRUNC, U_RECIP, U_NOT,
 U_BOOL, U_IPOW, U_ADD, U_SUB, U_MUL, U_DIV, U_POW, U_MIN, U_MAX, U_LT, U_LE,
 U_GT, U_GE, U_EQ, U_NE, U_AND, U_OR, U_XOR, U_SEL, U_ST, U_ALIVE,
 U_ACC, U_ATAN, U_ASIN, U_ACOS, U_SINH, U_COSH, U_TANH, U_ASINH, U_ACOSH,
 U_ATANH, U_EXP2, U_EXPM1, U_LOG2, U_LOG1P, U_ERF, U_ERFC, U_LGAMMA,
 U_RSQRT, U_ROUND, U_ISNAN, U_SIGNBIT, U_ATAN2, U_FMOD, U_COPYSIGN,
 U_NEXTAFTER, U_CVT, U_BAND, U_BOR, U_BXOR, U_BNOT, U_SHL, U_SHR,
 U_BITCAST, U_FMA, U_CARRY, U_LOOP, U_SET, U_END, U_OUT) = range(79)
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
            imm = (t if code in (U_CONST, U_SEL, U_FMA) else ta) if (
                code == U_CONST or bimm) else None
            out.append((ta, imm))
            if code not in (U_ST, U_ALIVE, U_ACC, U_LOOP, U_SET, U_END):
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
        # the bounded loops: (carried values, U_LOOP value, cap, the
        # condition's place among the carried)
        self.loops: List[tuple] = []
        # the incomplete gammas' loops of each (a, x): _igamma_sums
        self.igamma: Dict[tuple, tuple] = {}
        self._in_body = False

    def result_type(self, code, args) -> str:
        """An instruction's type, from its operands': a compare, a logic
        op or a test is a bool (float32); a select has its values' type;
        a load, t, dt and a draw are float32; the rest their operand's."""
        if code in _LOGIC or not args:
            return F32
        return self.ty[args[1] if code == U_SEL else args[0]]

    def val(self, code, args=(), y=0, t=None) -> int:
        t = self.result_type(code, args) if t is None else t
        if code in _LIBM_FOLD and args and all(self.is_const(a)
                                               for a in args):
            v = fold_libm(code, [self.defs[a][2] for a in args], t)
            if v is not None:
                return self.const(v, t)
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
                   else (U_FMA, 0, 0, 1, 2, False) if code == U_FMA
                   else (code, 0, 0, len(args) - 1, 0, False))
            t = self.result_type(code, args)
            v = _pure(ins, regs, lambda y, tt=F32: torch.tensor(
                [y], dtype=DTYPES[tt]), torch.ones(1), t)
            return self.const(v[0].item(), t)
        if len(args) == 2:
            return self.binary(code, *args)
        return self.val(code, args)

    def loop(self, inits: Sequence[int], body: Callable, cap: int,
             cond: int = 0) -> List[int]:
        """A bounded loop: carried values starting at ``inits`` (the
        ``cond``-th a float32 bool, the lane's enable), ``body(carried)``
        their next values (pure values only: no store, alive clear or
        record sum), at most ``cap`` iterations. A lane runs the body while
        its condition holds and keeps its values once it is disabled, as
        jnp's ``while_loop`` does with its ``enabled`` selects; the twin
        runs the whole tensor until no lane is enabled. Returns the
        carried values after the loop."""
        if self._in_body:
            raise Refused("op-unsupported", "a loop inside a loop's body")
        lid = len(self.loops)
        carried = [self.val(U_CARRY, (v,), (lid, j), self.ty[v])
                   for j, v in enumerate(inits)]
        n_eff = len(self.effects)
        self._in_body = True
        try:
            new = list(body(list(carried)))
        finally:
            self._in_body = False
        if len(self.effects) != n_eff or len(new) != len(carried) or any(
                self.ty[v] != self.ty[c] for v, c in zip(new, carried)):
            raise ValueError("a loop body makes an effect or changes its "
                             "carried values' number or types")
        node = self.val(U_LOOP, tuple(new), (lid, int(cap), cond), F32)
        self.loops.append((tuple(carried), node, int(cap), cond))
        return [self.val(U_OUT, (node,), j, self.ty[c])
                for j, c in enumerate(carried)]


def _uses(code, args, ssa, y=None) -> List[int]:
    """The operands that need a register: operand b of a binary operation,
    the false value of a select and the addend of a fused multiply-add may
    be a constant's immediate; a loop needs its carried values too."""
    if code == U_SEL:
        cond, tv, fv = args
        return [cond, tv] + ([] if ssa.is_const(fv) else [fv])
    if code == U_FMA:
        a, b, c = args
        return [a, b] + ([] if ssa.is_const(c) else [c])
    if code == U_LOOP:
        return list(args) + list(ssa.loops[y[0]][0])
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
          U_SHL, U_SHR, U_BITCAST, U_FMA}
# the libm codes: a call whose arguments are all constants is folded on
# the host to its correctly rounded value (fold_libm), as XLA's constant
# folding does, so the kernel and the twin read one constant
_LIBM_FOLD = {U_EXP, U_LOG, U_LOG10, U_SIN, U_COS, U_TAN, U_POW, U_ATAN,
              U_ASIN, U_ACOS, U_SINH, U_COSH, U_TANH, U_ASINH, U_ACOSH,
              U_ATANH, U_EXP2, U_EXPM1, U_LOG2, U_LOG1P, U_ERF, U_ERFC,
              U_LGAMMA, U_ATAN2}
# float64 ulps within which a float64 result is refined (it may lie on
# either side of the nearest rounding boundary of float32)
_FOLD_ULPS = 4


def _lgamma64(x: float) -> float:
    try:
        return math.lgamma(x)
    except ValueError:  # a pole
        return _INF


_NP_LIBM = {U_EXP: np.exp, U_LOG: np.log, U_LOG10: np.log10, U_SIN: np.sin,
            U_COS: np.cos, U_TAN: np.tan, U_ATAN: np.arctan,
            U_ASIN: np.arcsin, U_ACOS: np.arccos, U_SINH: np.sinh,
            U_COSH: np.cosh, U_TANH: np.tanh, U_ASINH: np.arcsinh,
            U_ACOSH: np.arccosh, U_ATANH: np.arctanh, U_EXP2: np.exp2,
            U_EXPM1: np.expm1, U_LOG2: np.log2, U_LOG1P: np.log1p,
            U_ERF: math.erf, U_ERFC: math.erfc, U_LGAMMA: _lgamma64,
            U_POW: np.power, U_ATAN2: np.arctan2}


def _mp_libm(code, xs):
    """The function of ``code`` at ``xs`` at 100 digits (mpmath), or None
    where it is complex."""
    mp = mpmath.mp
    with mpmath.workdps(100):
        a = [mpmath.mpf(float(x)) for x in xs]
        fn = {U_EXP: mp.exp, U_LOG: mp.log, U_LOG10: mp.log10,
              U_SIN: mp.sin, U_COS: mp.cos, U_TAN: mp.tan, U_ATAN: mp.atan,
              U_ASIN: mp.asin, U_ACOS: mp.acos, U_SINH: mp.sinh,
              U_COSH: mp.cosh, U_TANH: mp.tanh, U_ASINH: mp.asinh,
              U_ACOSH: mp.acosh, U_ATANH: mp.atanh,
              U_EXP2: lambda v: mp.power(2, v), U_EXPM1: mp.expm1,
              U_LOG2: lambda v: mp.log(v, 2), U_LOG1P: mp.log1p,
              U_ERF: mp.erf, U_ERFC: mp.erfc,
              U_LGAMMA: lambda v: mp.re(mp.loggamma(v)),
              U_POW: mp.power, U_ATAN2: mp.atan2}[code]
        v = fn(*a)
        return None if isinstance(v, mpmath.mpc) else +v


def _round_exact(v, approx: float, t: str) -> float:
    """The float of type ``t`` nearest to the exact value ``v`` (an mpmath
    number; ``approx`` a float near it), ties to even; past the largest
    float, inf where IEEE rounding overflows."""
    ftype = np.float32 if t == F32 else np.float64
    big = mpmath.mpf(2) ** (128 if t == F32 else 1024)
    with np.errstate(over="ignore"):
        r = ftype(approx)
    cands = {r, np.nextafter(r, ftype(_INF)), np.nextafter(r, ftype(-_INF))}

    def dist(c):
        cv = mpmath.mpf(float(c)) if np.isfinite(c) else math.copysign(
            1, c) * big
        return abs(v - cv)

    with mpmath.workdps(100):
        best = sorted(cands, key=lambda c: (dist(c), int(np.asarray(
            c).view(np.int32 if t == F32 else np.int64)) & 1))[0]
    return float(best)


def fold_libm(code, xs, t: str = F32) -> Optional[float]:
    """A libm code of constants ``xs`` (values of type ``t``, float32 or
    float64) folded to its correctly rounded value, or None (the call stays
    in the program). The float64 libm result (numpy's, C99's special
    values) rounds once to float32; where it lies within ``_FOLD_ULPS``
    float64 ulps of a float32 rounding boundary (or is lgamma of a negative
    number) it is refined at 100 digits (mpmath) and rounded from there; a
    float64 program's value is always taken from 100 digits."""
    if t not in (F32, F64):
        return None
    with np.errstate(all="ignore"):
        r64 = float(_NP_LIBM[code](*[float(x) for x in xs]))
    if not math.isfinite(r64) or r64 == 0.0:
        return r64  # a special value: exact, as C99 defines it
    if t == F32:
        with np.errstate(over="ignore"):
            a = np.float32(r64)
            side = np.nextafter(a, np.float32(_INF if r64 > a else -_INF))
        hi = float(side) if np.isfinite(side) else math.copysign(2.0 ** 128,
                                                                 r64)
        lo = float(a) if np.isfinite(a) else math.copysign(
            float(np.finfo(np.float32).max), r64)
        mid = (lo + hi) / 2
        # lgamma of a negative argument: the C library's float64 value
        # may lose digits near its zeros, so it is refined too
        sure = code != U_LGAMMA or float(xs[0]) > 0
        if sure and (r64 == float(a) or abs(r64 - mid)
                     > _FOLD_ULPS * math.ulp(r64)):
            return float(a)
    v = _mp_libm(code, xs)
    if v is None:
        return None
    return _round_exact(v, r64, t)
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
        p = _fma(s, p, w, coef(i))
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


def _fma(s: _SSA, a: int, b: int, c: int) -> int:
    """A lowered step ``a b + c``: in float32 one fused multiply-add
    (``U_FMA``, rounded once, as XLA contracts it on the CPU); in float64 a
    product and a sum."""
    if s.ty[a] != F32:
        return s.op(U_ADD, s.op(U_MUL, a, b), c)
    if s.is_const(a) and not s.is_const(b):
        a, b = b, a
    return s.op(U_FMA, a, b, c)


def _chebyshev(s: _SSA, x: int, coefs) -> int:
    """``evaluate_chebyshev_polynomial``: Clenshaw's ``b0 = x b1 - b2 +
    c`` (``x b1 - b2`` one fused multiply-add), then ``0.5 (b0 - b2)``."""
    z = s.like(x, 0.0)
    b0 = b1 = b2 = z
    for c in coefs:
        b2, b1 = b1, b0
        b0 = s.op(U_ADD, _fma(s, x, b1, s.op(U_NEG, b2)), s.like(x, c))
    return s.op(U_MUL, s.like(x, 0.5), s.op(U_SUB, b0, b2))


def _polyval(s: _SSA, coefs, x: int) -> int:
    """``jnp.polyval``: Horner's ``y x + c`` from the leading coefficient,
    each step one fused multiply-add."""
    y = s.like(x, coefs[0])
    for c in coefs[1:]:
        y = _fma(s, y, x, s.like(x, c))
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
    # (2 (n % 2) - 1) exp(lgamma(n + 1)): libm functions of constants,
    # folded on the host
    coef = s.op(U_MUL, s.like(x, 2.0 * (n % 2) - 1.0),
                s.op(U_EXP, s.op(U_LGAMMA, np1)))
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
    big = _fma(s, s.op(U_MUL, w, ww), s.op(
        U_DIV, _polyval(s, _NDTRI["p0"], ww), _polyval(s, _NDTRI["q0"], ww)),
        w)
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


# Cephes' j0 / j1 as torch computes them (aten/src/ATen/native/Math.h,
# bessel_j0_forward and bessel_j1_forward): a rational function in x**2 up
# to 5 (its two zeros factored), past it the asymptotic form
_J0 = {"PP": (7.96936729297347051624e-04, 8.28352392107440799803e-02,
              1.23953371646414299388e+00, 5.44725003058768775090e+00,
              8.74716500199817011941e+00, 5.30324038235394892183e+00,
              9.99999999999999997821e-01),
       "PQ": (9.24408810558863637013e-04, 8.56288474354474431428e-02,
              1.25352743901058953537e+00, 5.47097740330417105182e+00,
              8.76190883237069594232e+00, 5.30605288235394617618e+00,
              1.00000000000000000218e+00),
       "QP": (-1.13663838898469149931e-02, -1.28252718670509318512e+00,
              -1.95539544257735972385e+01, -9.32060152123768231369e+01,
              -1.77681167980488050595e+02, -1.47077505154951170175e+02,
              -5.14105326766599330220e+01, -6.05014350600728481186e+00),
       "QQ": (6.43178256118178023184e+01, 8.56430025976980587198e+02,
              3.88240183605401609683e+03, 7.24046774195652478189e+03,
              5.93072701187316984827e+03, 2.06209331660327847417e+03,
              2.42005740240291393179e+02),
       "RP": (-4.79443220978201773821e+09, 1.95617491946556577543e+12,
              -2.49248344360967716204e+14, 9.70862251047306323952e+15),
       "RQ": (4.99563147152651017219e+02, 1.73785401676374683123e+05,
              4.84409658339962045305e+07, 1.11855537045356834862e+10,
              2.11277520115489217587e+12, 3.10518229857422583814e+14,
              3.18121955943204943306e+16, 1.71086294081043136091e+18),
       "zeros": (5.78318596294678452118e+00, 3.04712623436620863991e+01),
       "shift": 0.785398163397448309615660845819875721}
_J1 = {"PP": (7.62125616208173112003e-04, 7.31397056940917570436e-02,
              1.12719608129684925192e+00, 5.11207951146807644818e+00,
              8.42404590141772420927e+00, 5.21451598682361504063e+00,
              1.00000000000000000254e+00),
       "PQ": (5.71323128072548699714e-04, 6.88455908754495404082e-02,
              1.10514232634061696926e+00, 5.07386386128601488557e+00,
              8.39985554327604159757e+00, 5.20982848682361821619e+00,
              9.99999999999999997461e-01),
       "QP": (5.10862594750176621635e-02, 4.98213872951233449420e+00,
              7.58238284132545283818e+01, 3.66779609360150777800e+02,
              7.10856304998926107277e+02, 5.97489612400613639965e+02,
              2.11688757100572135698e+02, 2.52070205858023719784e+01),
       "QQ": (7.42373277035675149943e+01, 1.05644886038262816351e+03,
              4.98641058337653607651e+03, 9.56231892404756170795e+03,
              7.99704160447350683650e+03, 2.82619278517639096600e+03,
              3.36093607810698293419e+02),
       "RP": (-8.99971225705559398224e+08, 4.52228297998194034323e+11,
              -7.27494245221818276015e+13, 3.68295732863852883286e+15),
       "RQ": (6.20836478118054335476e+02, 2.56987256757748830383e+05,
              8.35146791431949253037e+07, 2.21511595479792499675e+10,
              4.74914122079991414898e+12, 7.84369607876235854894e+14,
              8.95222336184627338078e+16, 5.32278620332680085395e+18),
       "zeros": (1.46819706421238932572e+01, 4.92184563216946036703e+01),
       "shift": 2.356194490192344928846982537459627163}
_SQ2OPI = 0.797884560802865355879892119868763737


def _bessel_j(s: _SSA, x: int, order: int) -> int:
    """``torch.special.bessel_j0`` / ``bessel_j1``: Cephes' j0 and j1 in
    torch's own order (``bessel_j0_forward`` / ``bessel_j1_forward``), its
    Horner steps fused multiply-adds. Of ``|x|`` (j1 negated for x < 0, so
    that -0 keeps its sign): up to 5 a rational function of ``z = x**2``
    times ``(z - r1) (z - r2)`` (j0 ``1 - z / 4`` below 1e-5; j1 times
    ``x``), past it ``(P / Q cos(x - s) - 5 / x (QP / QQ) sin(x - s))
    sqrt(2 / pi) / sqrt(x)``, P, Q, QP, QQ of ``25 / z``.

    Not jnp's ``bessel_jn`` (a backward recurrence of 51 steps): in float32
    that recurrence overflows below z = 3.45 (NaN), is within 1.2e-7 of
    ``scipy.special.j0`` only on [5, 30) and 3.0e-3 / 0.38 off on [30, 45)
    / [45, 60), while torch's float32 function is within 3.1e-7 everywhere.
    The generic tier runs torch's eager function, so the fused tier follows
    torch's form and the two tiers of the port agree."""
    k = _J0 if order == 0 else _J1
    c = lambda v: s.like(x, v)  # noqa: E731
    neg = s.op(U_LT, x, c(0.0))
    xa = s.op(U_SEL, neg, s.op(U_NEG, x), x)
    z = s.op(U_MUL, xa, xa)
    r1, r2 = k["zeros"]
    near = s.op(U_DIV, _polyval(s, k["RP"], z), _polyval(s, k["RQ"], z))
    if order == 0:
        near = s.op(U_MUL, s.op(U_MUL, s.op(U_SUB, z, c(r1)),
                                s.op(U_SUB, z, c(r2))), near)
        near = s.op(U_SEL, s.op(U_LT, xa, c(0.00001)), s.op(
            U_SUB, c(1.0), s.op(U_DIV, z, c(4.0))), near)
        w = s.op(U_DIV, c(25.0), z)
    else:
        near = s.op(U_MUL, s.op(U_MUL, s.op(U_MUL, near, xa),
                                s.op(U_SUB, z, c(r1))), s.op(U_SUB, z, c(r2)))
        five = s.op(U_DIV, c(5.0), xa)
        w = s.op(U_MUL, five, five)
    xn = s.op(U_SUB, xa, c(k["shift"]))
    p = s.op(U_MUL, s.op(U_DIV, _polyval(s, k["PP"], w),
                         _polyval(s, k["PQ"], w)), s.op(U_COS, xn))
    q = s.op(U_MUL, s.op(U_MUL, s.op(U_DIV, c(5.0), xa), s.op(
        U_DIV, _polyval(s, k["QP"], w), _polyval(s, k["QQ"], w))),
        s.op(U_SIN, xn))
    far = s.op(U_DIV, s.op(U_MUL, s.op(U_SUB, p, q), c(_SQ2OPI)),
               s.op(U_SQRT, xa))
    out = s.op(U_SEL, s.op(U_LE, xa, c(5.0)), near, far)
    return out if order == 0 else s.op(U_SEL, neg, s.op(U_NEG, out), out)


# jnp's igamma / igammac (jax/_src/lax/special.py igamma_impl,
# igammac_impl) in float32: machine epsilon, -log(float32 max) (folded)
_EPS32 = float(np.finfo(np.float32).eps)
_CF_CAP = 2000        # the continued fraction's cap (jnp's c < 2000)
# the series' cap (jnp's loop has none): a lane still enabled after it
# keeps its partial sum; it needs a ~ 2**20 and x within a few sqrt(a) of
# it to get there
_SERIES_CAP = 1 << 16


def _igamma_series(s: _SSA, x: int, a: int, enabled: int) -> tuple:
    """``_igamma_series`` (VALUE mode): ``r`` from ``a`` up by 1, the term
    ``c *= x / r`` added to ``ans`` while ``c / ans > eps``; returns
    ``ans`` after the loop and its initial value (``ans ax / a`` is the
    function's). The derivative's values do not reach the value and are
    left out."""
    one = s.like(a, 1.0)

    def body(v):
        _, r, cc, ans = v
        r = s.op(U_ADD, r, one)
        cc = s.op(U_MUL, cc, s.op(U_DIV, x, r))
        ans = s.op(U_ADD, ans, cc)
        return [s.op(U_GT, s.op(U_DIV, cc, ans), s.like(a, _EPS32)), r, cc,
                ans]

    return s.loop([enabled, a, one, one], body, _SERIES_CAP)[3], one


def _igammac_cf(s: _SSA, x: int, a: int, enabled: int) -> tuple:
    """``_igammac_continued_fraction`` (VALUE mode): the convergents ``pk /
    qk``, rescaled by eps past 1 / eps, while the relative change ``t``
    exceeds eps, at most 2000 terms; returns ``ans`` after the loop and its
    initial value (``ans ax`` is the function's)."""
    c = lambda v: s.like(x, v)  # noqa: E731
    y = s.op(U_SUB, c(1.0), a)
    z = s.op(U_ADD, s.op(U_ADD, x, y), c(1.0))
    pkm1 = s.op(U_ADD, x, c(1.0))
    qkm1 = s.op(U_MUL, z, x)
    ans = s.op(U_DIV, pkm1, qkm1)
    eps = c(_EPS32)

    def body(v):
        _, ans, t, y, z, cc, pkm1, qkm1, pkm2, qkm2 = v
        cc = s.op(U_ADD, cc, c(1.0))
        y = s.op(U_ADD, y, c(1.0))
        z = s.op(U_ADD, z, c(2.0))
        yc = s.op(U_MUL, y, cc)
        pk = s.op(U_SUB, s.op(U_MUL, pkm1, z), s.op(U_MUL, pkm2, yc))
        qk = s.op(U_SUB, s.op(U_MUL, qkm1, z), s.op(U_MUL, qkm2, yc))
        nz = s.op(U_NE, qk, c(0.0))
        r = s.op(U_DIV, pk, qk)
        t = s.op(U_SEL, nz, s.op(U_ABS, s.op(U_DIV, s.op(U_SUB, ans, r), r)),
                 c(1.0))
        ans = s.op(U_SEL, nz, r, ans)
        pkm2, pkm1, qkm2, qkm1 = pkm1, pk, qkm1, qk
        big = s.op(U_GT, s.op(U_ABS, pk), c(1.0 / _EPS32))
        pkm2, pkm1, qkm2, qkm1 = (s.op(U_SEL, big, s.op(U_MUL, v_, eps), v_)
                                  for v_ in (pkm2, pkm1, qkm2, qkm1))
        return [s.op(U_GT, t, eps), ans, t, y, z, cc, pkm1, qkm1, pkm2,
                qkm2]

    out = s.loop([enabled, ans, c(1.0), y, z, c(0.0), pkm1, qkm1, c(1.0), x],
                 body, _CF_CAP)
    return out[1], ans


def _igamma_sums(s: _SSA, a: int, x: int, on_cf: tuple,
                 on_ser: tuple) -> tuple:
    """The continued fraction's and the series' sums of ``(a, x)`` for the
    lower (``[0]``) and the upper (``[1]``) function, each loop enabled on
    its lanes ``on_cf`` / ``on_ser`` of either. Recorded once for both
    functions (``_SSA.igamma``), so that ``gammainc`` and ``gammaincc`` of
    the same operands share two loops, not four; each function's sum is
    ``select(its enable, the loop's, the initial one)``, what the loop
    enabled on its lanes alone leaves: an enabled lane's values depend only
    on its own, and a lane not enabled keeps its initial values, as in
    jnp's ``while_loop``."""
    if (a, x) not in s.igamma:
        s.igamma[a, x] = (_igammac_cf(s, x, a, s.op(U_OR, *on_cf)),
                          _igamma_series(s, x, a, s.op(U_OR, *on_ser)))
    (cf, cf0), (ser, ser0) = s.igamma[a, x]
    return [(s.op(U_SEL, on_cf[k], cf, cf0),
             s.op(U_SEL, on_ser[k], ser, ser0)) for k in (0, 1)]


def _igamma(s: _SSA, a: int, x: int, upper: bool) -> int:
    """``jax.scipy.special.gammainc`` / ``gammaincc`` (``lax.igamma`` /
    ``igammac``: ``igamma_impl`` / ``igammac_impl``): the series below the
    switch (``x >= 1 and x > a`` for the lower function, ``x < 1 or x <
    a`` the upper's series), the continued fraction past it, each a
    bounded loop whose lanes are enabled where the inputs are in the domain
    and ``a log x - x - lgamma(a)`` does not underflow (the loops shared
    with the other function of the same operands, :func:`_igamma_sums`); 0
    and 1 at x = 0 and inf, NaN for a < 0, x < 0, a = x = 0 and NaN."""
    c = lambda v: s.like(x, v)  # noqa: E731
    is_nan = s.op(U_OR, s.op(U_ISNAN, a), s.op(U_ISNAN, x))
    x_inf = s.op(U_EQ, x, c(_INF))
    a_zero = s.op(U_EQ, a, c(0.0))
    x_zero = s.op(U_EQ, x, c(0.0))
    domain = s.op(U_OR, s.op(U_OR, s.op(U_OR, s.op(U_LT, x, c(0.0)), s.op(
        U_LT, a, c(0.0))), s.op(U_AND, a_zero, x_zero)), is_nan)
    ax = s.op(U_SUB, s.op(U_SUB, s.op(U_MUL, a, s.op(U_LOG, x)), x),
              s.op(U_LGAMMA, a))
    under = s.op(U_LT, ax, s.op(U_NEG, s.op(U_LOG, c(_F32_MAX))))
    ax = s.op(U_EXP, ax)
    use_cf = s.op(U_AND, s.op(U_GE, x, c(1.0)), s.op(U_GT, x, a))
    use_ser = s.op(U_OR, s.op(U_LT, x, c(1.0)), s.op(U_LT, x, a))
    on = (s.op(U_NOT, s.op(U_OR, s.op(U_OR, s.op(U_OR, x_zero, domain),
                                          under), x_inf)),
          s.op(U_NOT, s.op(U_OR, s.op(U_OR, s.op(U_OR, domain, under),
                                          x_inf), a_zero)))
    cf, ser = _igamma_sums(
        s, a, x, (s.op(U_AND, on[0], use_cf),
                  s.op(U_AND, on[1], s.op(U_NOT, use_ser))),
        (s.op(U_AND, on[0], s.op(U_NOT, use_cf)),
         s.op(U_AND, on[1], use_ser)))[int(upper)]
    ser = s.op(U_DIV, s.op(U_MUL, ser, ax), a)
    cf = s.op(U_MUL, cf, ax)
    if not upper:
        out = s.op(U_SEL, use_cf, s.op(U_SUB, c(1.0), cf), ser)
        out = s.op(U_SEL, x_zero, c(0.0), out)
        out = s.op(U_SEL, x_inf, c(1.0), out)
    else:
        out = s.op(U_SEL, use_ser, s.op(U_SUB, c(1.0), ser), cf)
        out = s.op(U_SEL, s.op(U_OR, x_inf, a_zero), c(0.0), out)
    return s.op(U_SEL, domain, c(_NAN), out)


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
    if name in ("special_bessel_j0", "special_bessel_j1"):
        return _bessel_j(s, x, int(name[-1]))
    if name in ("igamma", "igammac"):
        return _igamma(s, x, xs[1], name == "igammac")
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
        # log(pi) of a constant, folded on the host
        return s.op(U_ADD, total, s.op(U_MUL, k, s.op(U_LOG, c(np.pi))))
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
            "log_sigmoid_forward": 1, "special_bessel_j0": 1,
            "special_bessel_j1": 1, "igamma": 2, "igammac": 2}
_GROUP_C = {"digamma", "polygamma", "special_zeta", "i0", "special_i0e",
            "special_i1", "special_i1e", "special_modified_bessel_i0",
            "special_modified_bessel_i1", "special_ndtri",
            "special_log_ndtr", "special_entr", "mvlgamma", "logaddexp2",
            "ldexp", "gelu", "elu", "log_sigmoid_forward",
            "special_bessel_j0", "special_bessel_j1", "igamma", "igammac"}
# the lowered functions jnp computes in an integer type
_INT_LOWERED = {"isnan", "isinf", "isposinf", "isneginf", "signbit",
                "round", "nan_to_num", "sign", "sgn", "relu", "remainder",
                "floor_divide", "trunc_divide", "fmax", "fmin"}
# the lowered functions whose form is float32's (coefficient tables and
# cutoffs): refused in float64, where jnp's form differs
_F32_FORMS = {"erfinv", "digamma", "polygamma", "special_zeta", "i0",
              "special_i0e", "special_i1", "special_i1e",
              "special_modified_bessel_i0", "special_modified_bessel_i1",
              "special_ndtri", "special_log_ndtr", "ldexp",
              "special_bessel_j0", "special_bessel_j1", "igamma", "igammac"}


def _live(ssa: _SSA) -> set:
    """The values the effects need, transitively."""
    live = set()
    stack = [e[1] for e in ssa.effects]
    while stack:
        v = stack.pop()
        if v in live:
            continue
        live.add(v)
        code, args, y = ssa.defs[v]
        stack.extend(_uses(code, args, ssa, y))
    return live


def _regions(ssa: _SSA) -> Dict[int, int]:
    """The loop each value's body belongs to: a value that depends on a
    loop's carried values (a loop's result, ``U_OUT``, is outside it)."""
    region: Dict[int, int] = {}
    for v, (code, args, y) in enumerate(ssa.defs):
        if code == U_CARRY:
            region[v] = y[0]
        elif code not in (U_OUT, U_LOOP):
            rs = {region[a] for a in args if a in region}
            if len(rs) > 1:
                raise ValueError("a value of two loops' bodies")
            if rs:
                region[v] = rs.pop()
    return region


def _loop_inputs(ssa: _SSA, lid: int, region: dict, live: set) -> List[int]:
    """The outer values loop ``lid`` reads: its initial values, then what
    its (live) body and next values read from outside it."""
    carried, node, _, _ = ssa.loops[lid]
    out = [ssa.defs[c][1][0] for c in carried]
    body = [v for v, r in region.items() if r == lid and v in live
            and ssa.defs[v][0] != U_CARRY]
    for v in sorted(body):
        out += [a for a in ssa.defs[v][1] if region.get(a) != lid]
    out += [n for n in ssa.defs[node][1] if region.get(n) != lid]
    return list(dict.fromkeys(out))


def _schedule(ssa: _SSA, n_draws: int) -> Program:
    """Drop unused values, order the instructions (a record sum right after
    its value, stores and alive clears last, after every load) and assign
    registers by liveness. A loop (:meth:`_SSA.loop`) becomes its carried
    values' ``U_CARRY`` instructions, ``U_LOOP`` (the condition's register,
    the cap), the body's instructions (the values that depend on a carried
    value), one ``U_SET`` a carried value (its register, the next value's)
    and ``U_END``; a value of the loop's outer code that the body reads, and
    each carried value, stays in its register through ``U_END``; a loop's
    result is its carried value's register. The values go in rounds: those
    that read no loop's result, the loops that read only them, then what
    reads those loops' results, and so on, so that loops none of which
    reads another's results follow one another (one block phase of the
    kernel: :func:`loop_phases`); a program with no loop keeps its values'
    order."""
    live = _live(ssa)
    region = _regions(ssa)
    # the results' carried values
    alias: Dict[int, int] = {}
    for v, (code, args, y) in enumerate(ssa.defs):
        if code == U_OUT:
            alias[v] = ssa.loops[ssa.defs[args[0]][2][0]][0][y]
    accs: Dict[int, list] = {}
    tail = []
    for eff in ssa.effects:
        if eff[0] == U_ACC:
            accs.setdefault(eff[1], []).append(eff)
        else:
            tail.append(eff)
    # ("v", vid), ("e", effect), ("loop" / "end", loop id), ("set",
    # (carried, next))
    order: List[tuple] = []
    # the values in rounds: those that read no loop's result, then the
    # loops that read only them, then the values that read those loops'
    # results, and so on (a value's round: the most loops in a chain
    # above it), each round in the SSA's order
    rounds: Dict[int, int] = {}
    stage: Dict[int, int] = {}
    for v in range(len(ssa.defs)):
        if v not in live or v in region:
            continue
        code, args, y = ssa.defs[v]
        if code == U_LOOP:
            stage[v] = max((rounds.get(u, 0) for u in _loop_inputs(
                ssa, y[0], region, live)), default=0)
        elif code == U_OUT:
            rounds[v] = stage[args[0]] + 1
        else:
            rounds[v] = max((rounds.get(a, 0) for a in args), default=0)
    for r in range(max(rounds.values(), default=0) + 1):
        for v, rv in rounds.items():
            if rv != r:
                continue
            if ssa.defs[v][0] != U_OUT:
                order.append(("v", v))
            order.extend(("e", e) for e in accs.get(v, ()))
        for v, sv in stage.items():
            if sv != r:
                continue
            lid = ssa.defs[v][2][0]
            carried = ssa.loops[lid][0]
            order += [("v", c) for c in carried]
            order.append(("loop", lid))
            order += [("v", b) for b in range(v) if b in live
                      and region.get(b) == lid and ssa.defs[b][0] != U_CARRY]
            order += [("set", (c, n)) for c, n in zip(carried, ssa.defs[v][1])]
            order.append(("end", lid))
    order.extend(("e", e) for e in tail)

    def ref(u):
        return alias.get(u, u)

    def uses_at(kind, item):
        if kind == "v":
            code, args, y = ssa.defs[item]
            return [ref(u) for u in _uses(code, args, ssa, y)]
        if kind == "e":
            return [ref(item[1])]
        if kind == "set":
            return [ref(item[1])]
        if kind == "loop":
            loop = ssa.loops[item]
            return [loop[0][loop[3]]]
        return []

    last: Dict[int, int] = {}
    defined: Dict[int, int] = {}
    opened = {}
    for i, (kind, item) in enumerate(order):
        for u in uses_at(kind, item):
            last[u] = i
        if kind == "v":
            defined[item] = i
        elif kind == "loop":
            opened[item] = i
        elif kind == "end":
            # what the body reads from outside, and the carried values,
            # live through the loop's last instruction
            i0 = opened[item]
            for j in range(i0, i + 1):
                for u in uses_at(*order[j]):
                    if defined.get(u, -1) < i0:
                        last[u] = max(last[u], i)
            for c in ssa.loops[item][0]:
                last[c] = max(last.get(c, i), i)
    reg: Dict[int, int] = {}
    free: List[int] = []
    n_regs = 0
    ins, types = [], []

    def release(i, vals):
        for u in dict.fromkeys(vals):
            if last[u] == i:
                free.append(reg[u])

    for i, (kind, item) in enumerate(order):
        if kind == "e":
            code, v, y = item
            ins.append((code, 0, reg[ref(v)], 0, y, False))
            types.append(F32)
            release(i, [ref(v)])
            continue
        if kind in ("loop", "set", "end"):
            if kind == "loop":
                loop = ssa.loops[item]
                ins.append((U_LOOP, 0, reg[loop[0][loop[3]]], 0, loop[2],
                            False))
            elif kind == "set":
                ins.append((U_SET, reg[item[0]], reg[ref(item[1])], 0, 0,
                            False))
            else:
                ins.append((U_END, 0, 0, 0, 0, False))
            types.append(F32)
            if kind == "end":
                release(i, [u for u, j in last.items() if j == i])
            else:
                release(i, uses_at(kind, item))
            continue
        code, args, y = ssa.defs[item]
        args = tuple(ref(u) for u in args)
        release(i, uses_at(kind, item))
        if free:
            free.sort(reverse=True)
            d = free.pop()
        else:
            d, n_regs = n_regs, n_regs + 1
        reg[item] = d  # every live value has a last use
        a = b = 0
        bimm = False
        if code == U_CARRY:
            a, y = reg[args[0]], 0
        elif code == U_SEL:
            # (cond, false register, true register in y), or with a
            # constant false value (cond, true register, its immediate)
            cond, tv, fv = args
            a = reg[cond]
            if ssa.is_const(fv):
                b, y, bimm = reg[tv], ssa.defs[fv][2], True
            else:
                b, y = reg[fv], reg[tv]
        elif code == U_FMA:
            # (a, b, the addend's register in y), or its immediate
            a, b = reg[args[0]], reg[args[1]]
            if ssa.is_const(args[2]):
                bimm, y = True, ssa.defs[args[2]][2]
            else:
                y = reg[args[2]]
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


# -- branched arms ---------------------------------------------------------------


# an arm of a select that holds one of these (a CUDA libm call) or at
# least ARM_MIN instructions runs under a branch on the select's condition
_LIBM_CALLS = _LIBM_FOLD | {U_FMOD}
ARM_MIN = 12
# the instructions that stay where the program has them: loads, draws, t
# and dt, the effects and the loops' own
_PINNED = {U_LD, U_T, U_DT, U_UNIF, U_ST, U_ALIVE, U_ACC, U_CARRY, U_LOOP,
           U_SET, U_END}
# the codes with one register operand
_ONE_OPERAND = set(_UNARY.values()) | {U_NOT, U_BOOL, U_ROUND, U_ISNAN,
                                       U_SIGNBIT, U_CVT, U_BITCAST, U_IPOW,
                                       U_BNOT}


def _operands(ins) -> list:
    """``(register, slot)`` of an instruction's register operands (a
    select's slots ``"c"``, ``"t"``, ``"f"``)."""
    code, d, a, b, y, bimm = ins
    if code in (U_CONST, U_LD, U_T, U_DT, U_UNIF, U_END):
        return []
    if code == U_LOOP:
        return [(a, "c")]
    if code == U_SEL:
        return [(a, "c"), (b, "t")] if bimm else [(a, "c"), (y, "t"),
                                                 (b, "f")]
    if code == U_FMA:
        return [(a, "a"), (b, "b")] + ([] if bimm else [(y, "c")])
    if code in (U_ST, U_ALIVE, U_ACC, U_CARRY, U_SET):
        return [(a, "a")]
    if code in _ONE_OPERAND:
        return [(a, "a")]
    return [(a, "a")] + ([] if bimm else [(b, "b")])


def branched_arms(prog: Program) -> dict:
    """``{select index: (true arm, false arm)}`` of the selects whose arms
    run under a branch: an arm is the instructions that only that operand
    of the select needs, transitively (pure ones of the select's own loop
    body or of the outer code; never a load, draw, effect or loop
    instruction), and a select is branched where an arm holds a libm call
    (``_LIBM_CALLS``) or at least ``ARM_MIN`` instructions, and neither
    of its values is a constant (a guard of a special value, such as
    ``ndtri``'s ``p == 0``: its other arm is the common one, and a branch
    around it would only cost). On each lane the same instructions see the
    same inputs, so the twin is unchanged."""
    n = len(prog.ins)
    defn, opnd, users, region = {}, [None] * n, [[] for _ in range(n)], []
    loops = []
    for i, ins in enumerate(prog.ins):
        code = ins[0]
        if code == U_END:
            loops.pop()
        region.append(loops[-1] if loops else None)
        opnd[i] = [(defn[r], slot) for r, slot in _operands(ins)]
        for j, slot in opnd[i]:
            users[j].append((i, slot))
        if code == U_LOOP:
            loops.append(i)
        if code not in (U_ST, U_ALIVE, U_ACC, U_LOOP, U_END, U_SET):
            defn[ins[1]] = i
    movable = [ins[0] not in _PINNED for ins in prog.ins]

    def arm(s, slot):
        r = next((j for j, sl in opnd[s] if sl == slot), None)
        if r is None or not (movable[r] and region[r] == region[s]
                             and users[r] == [(s, slot)]):
            return set()
        out, seen, heap = {r}, {r}, [-j for j, _ in opnd[r]]
        heapq.heapify(heap)
        while heap:
            j = -heapq.heappop(heap)
            if j in seen:
                continue
            seen.add(j)
            if movable[j] and region[j] == region[s] and all(
                    u in out for u, _ in users[j]):
                out.add(j)
                for k, _ in opnd[j]:
                    heapq.heappush(heap, -k)
        return out

    branched = {}
    for s, ins in enumerate(prog.ins):
        if ins[0] != U_SEL or ins[5] or any(
                prog.ins[j][0] == U_CONST for j, sl in opnd[s]
                if sl != "c"):
            continue  # a constant arm: a guard, the other arm the common one
        arms = (arm(s, "t"), arm(s, "f"))
        if any(len(a) >= ARM_MIN or any(prog.ins[j][0] in _LIBM_CALLS
                                        for j in a) for a in arms):
            branched[s] = arms
    return branched


@functools.lru_cache(maxsize=256)
def arm_owner(prog: Program) -> dict:
    """``{instruction: (select, side)}``: the innermost branched arm
    (:func:`branched_arms`) each instruction runs in, ``side`` True for
    the select's true arm; an instruction outside every arm is absent."""
    owner = {}
    for s, arms in sorted(branched_arms(prog).items(),
                          key=lambda kv: -sum(map(len, kv[1]))):
        for side, members in zip((True, False), arms):
            for j in members:
                owner[j] = (s, side)
    return owner


# a block phase of the kernel's loops (csrc/phase.cuh): the block's
# threads, its warps' count words per loop, and the values every lane of
# a block holds alike, which the thread that runs an item declares again
# rather than read from the item
PHASE_LANES = 256
PHASE_WARPS = PHASE_LANES // 32
_UNIFORM = {U_CONST, U_T, U_DT}


@dataclasses.dataclass(frozen=True)
class PhaseLoop:
    """One loop of a block phase (:func:`loop_phases`): the indices of its
    ``U_LOOP`` and ``U_END``, of its carried values' ``U_CARRY`` (in
    ``U_SET`` order), of those the program reads after the loop
    (``results``) and of the outer values its body reads, those an item
    stores (``stored``) and those every lane holds alike (``uniform``:
    constants, t and dt); ``row0`` the first word of its items in the
    phase's shared words, each value a row of :data:`PHASE_LANES` words
    (two for an int64 or float64)."""

    loop: int
    end: int
    carried: tuple
    results: tuple
    stored: tuple
    uniform: tuple
    row0: int


def _words(t: str) -> int:
    return 2 if t in (I64, F64) else 1


def loop_phases(prog: Program) -> List[List[PhaseLoop]]:
    """The program's loops in block phases: each phase a run of loops that
    follow one another (one's ``U_END``, then the next one's ``U_CARRY``
    instructions and ``U_LOOP``), none of which reads a result of an
    earlier loop of its run. The kernel runs a phase's loops together: each
    lane puts an item in shared memory for each loop it is enabled in, the
    block's threads run the items in loop order, and each lane reads its
    results back (``ops/codegen.py``); the twin's warp tally
    (:data:`warp_tally`) groups lanes the same way."""
    ins, tys = prog.ins, prog.type_list()
    defn: Dict[int, int] = {}
    loops = []
    first_carry = None
    open_ = None
    read_at: Dict[int, int] = {}  # each value's last reader
    for i, (code, d, *_rest) in enumerate(ins):
        for r, _ in _operands(ins[i]):
            read_at[defn[r]] = i
        if code == U_CARRY and first_carry is None:
            first_carry = i
        if code == U_LOOP:
            open_ = {"loop": i, "carry0": first_carry, "reads": [],
                     "carried": [], "inits": []}
            for j in range(first_carry, i):
                open_["inits"].append(defn[ins[j][2]])
        elif open_ is not None:
            open_["reads"] += [defn[r] for r, _ in _operands(ins[i])]
            if code == U_SET:
                open_["carried"].append(defn[d])
            if code == U_END:
                open_["end"] = i
                loops.append(open_)
                open_ = None
        if code != U_CARRY:
            first_carry = None
        if code not in (U_ST, U_ALIVE, U_ACC, U_LOOP, U_END, U_SET):
            defn[d] = i
    phases: List[List[PhaseLoop]] = []
    prev_end, results = None, set()
    for lp in loops:
        outer = sorted({j for j in lp["reads"] if j < lp["carry0"]})
        if not (phases and prev_end == lp["carry0"] - 1 and not results
                .intersection(outer + lp["inits"])):
            phases.append([])
            results = set()
        row0 = sum(_words(tys[j]) for p in phases[-1]
                   for j in p.carried + p.stored)
        phases[-1].append(PhaseLoop(
            lp["loop"], lp["end"], tuple(lp["carried"]),
            tuple(j for j in lp["carried"] if read_at.get(j, 0) > lp["end"]),
            tuple(j for j in outer if ins[j][0] not in _UNIFORM),
            tuple(j for j in outer if ins[j][0] in _UNIFORM), row0))
        results.update(lp["carried"])
        prev_end = lp["end"]
    return phases


def phase_words(prog: Program) -> int:
    """The 32-bit words of shared memory the program's largest block phase
    takes: each loop's warp counts, then its items' rows (0 without a
    loop)."""
    tys = prog.type_list()
    out = 0
    for ph in loop_phases(prog):
        rows = sum(_words(tys[j]) for p in ph for j in p.carried + p.stored)
        out = max(out, PHASE_WARPS * len(ph) + PHASE_LANES * rows)
    return out


# -- the plain version ------------------------------------------------------------


# when a dict, the plain versions append each run's executed lane counts
# of a program to it, ``{id(program): [(lanes, per-instruction lane
# counts), ...]}`` in run order: an instruction of a branched arm
# (:func:`branched_arms`) counts the lanes that take the arm, a loop body's
# instruction the lanes that ran each iteration (the bounds of
# ``chip_smoke.py`` count such work on the lanes that do it)
lane_tally: Optional[dict] = None
# when a dict, the plain versions append each run's loop trips of a
# program to it, ``{id(program): [(lanes, warps, lane trips, warp trips
# a lane a warp, warp trips regrouped), ...]}``: the trips summed over the
# lanes, then over the warps of 32 consecutive lanes (each warp runs each
# loop to its slowest lane), then over the warps of the block phases
# (:func:`loop_phases`: each block of PHASE_LANES lanes' items in loop
# order, 32 at a time; a warp of two loops' items runs both)
warp_tally: Optional[dict] = None


def warp_trips(trips: Sequence[torch.Tensor],
               phases: Sequence[Sequence[int]]) -> Tuple[int, int, int]:
    """``(lane trips, warp trips, regrouped warp trips)`` of one run:
    ``trips`` each loop's iterations per lane (0 where it was not
    enabled), ``phases`` the loops' places in ``trips``, phase by phase
    (:data:`warp_tally`)."""
    C = trips[0].shape[0]
    lane = sum(int(t.sum()) for t in trips)
    warps = -(-C // 32)
    now = sum(int(torch.nn.functional.pad(t, (0, warps * 32 - C))
                  .view(warps, 32).amax(1).sum()) for t in trips)
    blocks = -(-C // PHASE_LANES)
    regrouped = 0
    for ph in phases:
        T = torch.stack([torch.nn.functional.pad(
            trips[j].long(), (0, blocks * PHASE_LANES - C)) for j in ph])
        T = T.view(len(ph), blocks, PHASE_LANES)
        en = (T > 0).long()
        cnt = en.sum(2)
        item = en.cumsum(2) - en + (cnt.cumsum(0) - cnt)[:, :, None]
        n_chunks = len(ph) * PHASE_WARPS
        top = torch.zeros(len(ph), blocks, n_chunks, dtype=torch.long,
                          device=T.device)
        top.scatter_reduce_(2, item // 32 * en, T * en, "amax")
        regrouped += int(top.sum())
    return lane, now, regrouped


def _tally(prog: Program, conds: dict, loop_lanes: dict, C: int,
           trips: Optional[dict] = None) -> None:
    """Append one run's lane counts of ``prog`` to :data:`lane_tally`:
    ``conds`` each select's condition mask, ``loop_lanes`` each loop's
    enabled lanes summed over its iterations; and where :data:`warp_tally`
    is a dict, ``trips`` (each loop's iterations per lane) as its warps
    run them."""
    if warp_tally is not None and trips:
        order = sorted(trips)
        place = {i: j for j, i in enumerate(order)}
        phases = [[place[p.loop] for p in ph] for ph in loop_phases(prog)]
        warp_tally.setdefault(id(prog), []).append(
            (C, -(-C // 32), *warp_trips([trips[i] for i in order],
                                         phases)))
    if lane_tally is None:
        return
    owner = arm_owner(prog)
    memo = {}

    def reach(key):
        if key is None:
            return None
        if key not in memo:
            s_, side = key
            m = conds[s_] if side else ~conds[s_]
            up = reach(owner.get(s_))
            memo[key] = m if up is None else m & up
        return memo[key]

    took = {key: int(reach(key).sum()) for key in set(owner.values())}
    counts = []
    loop = None
    for j, ins in enumerate(prog.ins):
        if ins[0] == U_LOOP:
            loop = j
        elif ins[0] == U_END:
            loop = None
        if loop is not None and j != loop:
            counts.append(loop_lanes.get(loop, 0))
        else:
            counts.append(took.get(owner.get(j), C))
    lane_tally.setdefault(id(prog), []).append((C, counts))


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
    tys = prog.type_list()
    conds, loops = ({}, {}) if lane_tally is not None else (None, None)
    trips = {} if warp_tally is not None else None
    i = 0
    while i < len(prog.ins):
        ins, ty = prog.ins[i], tys[i]
        code, d, a, _, y, _ = ins
        i += 1
        va = regs[a]
        if code == U_LOOP:
            i = _run_loop(prog, i - 1, regs, full, one, loops, trips)
            continue
        if code == U_SEL and conds is not None:
            conds[i - 1] = va != 0
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
    if conds is not None or trips:
        _tally(prog, conds, loops, C, trips)
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
    if code == U_CARRY:
        return va
    if code == U_FMA:
        return fma_f32(va, regs[b], full(y, t) if bimm else regs[y])
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


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of float32 tensors, rounded once (the kernel's
    ``__fmaf_rn``): the float64 product (exact), its sum with ``c`` rounded
    to odd (the sum, its TwoSum error, and the odd neighbour where the sum
    is inexact and even), then one rounding to float32, which is then the
    correctly rounded value (53 bits hold 24 and two more)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    s = s.contiguous()
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    away = torch.where(err > 0, _INF, -_INF).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, away), s).float()


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
    tys = prog.type_list()
    conds, loops = ({}, {}) if lane_tally is not None else (None, None)
    trips = {} if warp_tally is not None else None
    i = 0
    while i < len(prog.ins):
        ins, ty = prog.ins[i], tys[i]
        code, d, a, _, y, _ = ins
        i += 1
        if code == U_LOOP:
            i = _run_loop(prog, i - 1, regs, full, one, loops, trips)
        elif code == U_ST:
            out[y] = regs[a]
        elif code == U_LD:
            regs[d] = args[y]
        else:
            if code == U_SEL and conds is not None:
                conds[i - 1] = regs[a] != 0
            regs[d] = _pure(ins, regs, full, one, ty)
    if conds is not None or trips:
        _tally(prog, conds, loops, shape.numel(), {
            k: v.reshape(-1) for k, v in (trips or {}).items()})
    return out[0] if n_out == 1 else tuple(out)


def _run_loop(prog: Program, i: int, regs, full, one, lanes=None,
              trips=None) -> int:
    """Plain version of the loop whose ``U_LOOP`` is instruction ``i``, as
    jnp's ``while_loop`` runs it: the body over the whole tensor, each
    carried value then kept by select where the lane was disabled at the
    iteration's start, until no lane is enabled or the cap is reached
    (``lanes``, a dict: the enabled lanes summed over its iterations;
    ``trips``, a dict: each lane's iterations). Returns the index after
    its ``U_END``."""
    tys = prog.type_list()
    _, _, cond, _, cap, _ = prog.ins[i]
    end = i + 1
    while prog.ins[end][0] != U_END:
        end += 1
    if trips is not None:
        trips[i] = torch.zeros(regs[cond].shape, dtype=torch.int32,
                               device=regs[cond].device)
    for _ in range(cap):
        en = regs[cond] != 0
        n_en = int(en.sum())
        if not n_en:
            break
        if lanes is not None:
            lanes[i] = lanes.get(i, 0) + n_en
        if trips is not None:
            trips[i] += en
        pending = []
        for k in range(i + 1, end):
            ins = prog.ins[k]
            if ins[0] == U_SET:
                pending.append((ins[1], regs[ins[2]]))
            else:
                regs[ins[1]] = _pure(ins, regs, full, one, tys[k])
        for d, v in pending:
            regs[d] = torch.where(en, v, regs[d])
    return end + 1


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
