"""Kernel 1i's programs: a user's torch callable recorded once, at plan time,
into an elementwise register program that :mod:`physicl_tpu_torch.ops.codegen`
compiles per plan into straight-line CUDA C for ``csrc/fused_transport.cu``
(the ops ``custom``, ``reduce`` and ``kstate``) and :func:`run_user_program`,
the plain version, runs with float32 torch ops.

Counterpart of the JAX package's tracing of the same callables into its
fused kernel (``physicl_tpu/ops/fused.py:1448-1569``) and of its plan-time
probes (``physicl_tpu/ops/pipeline.py:_probe_kernelstep``,
``_probe_particle_fn``), whose behavioural checks become structural ones
here. The callable is traced with ``make_fx`` in fake mode over per-particle
inputs of two lengths, and the aten graph is translated:

* a value is a float32 or a bool per particle (a bool held as 0.0 / 1.0),
  with 1 or 3 components (the ``KernelStep`` facade's ``r``, ``dr``, ``v``
  and ``dv``); a scalar (``t``, ``dt``, a constant) has 1 component.
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
* a Python scalar rounds once to float32 where it meets a tensor (JAX's weak
  types); an integer exponent is ``lax.integer_pow``'s repeated products, an
  exponent of 0.5 a square root (torch's ``pow``), any other ``powf``; a
  tensor divided by a tensor or a scalar is a division, a scalar divided by
  a tensor is torch's ``reciprocal(x) * c``; bool times float is 0.0 or the
  float, as in torch.

The program is register code over per-component SSA values: common
subexpressions merged, unused values dropped, the side effects (plane
stores, alive clears, float record sums) kept in order, and registers
assigned by liveness. Its length, registers and draws have no limit: each
plan's programs are compiled for it.
"""

from __future__ import annotations

import dataclasses
import operator
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# instruction codes (ops/codegen.py turns each into C)
(U_LD, U_T, U_DT, U_CONST, U_UNIF, U_NEG, U_ABS, U_SQRT, U_EXP, U_LOG,
 U_LOG10, U_SIN, U_COS, U_TAN, U_FLOOR, U_CEIL, U_TRUNC, U_RECIP, U_NOT,
 U_BOOL, U_IPOW, U_ADD, U_SUB, U_MUL, U_DIV, U_POW, U_MIN, U_MAX, U_LT, U_LE,
 U_GT, U_GE, U_EQ, U_NE, U_AND, U_OR, U_XOR, U_SEL, U_ST, U_ALIVE,
 U_ACC) = range(41)
ALIVE_PLANE = 13
DRAW_ROWS = 64   # rows of the draws placeholder, unless a callable draws more

_UNARY = {"neg": U_NEG, "abs": U_ABS, "sqrt": U_SQRT, "exp": U_EXP,
          "log": U_LOG, "log10": U_LOG10, "sin": U_SIN, "cos": U_COS,
          "tan": U_TAN, "floor": U_FLOOR, "ceil": U_CEIL, "trunc": U_TRUNC,
          "reciprocal": U_RECIP}
_BINARY = {"add": U_ADD, "sub": U_SUB, "mul": U_MUL, "div": U_DIV,
           "true_divide": U_DIV, "minimum": U_MIN, "maximum": U_MAX,
           "lt": U_LT, "le": U_LE, "gt": U_GT, "ge": U_GE, "eq": U_EQ,
           "ne": U_NE, "bitwise_and": U_AND, "bitwise_or": U_OR,
           "bitwise_xor": U_XOR, "logical_and": U_AND, "logical_or": U_OR,
           "logical_xor": U_XOR}
_COMMUTATIVE = {U_ADD, U_MUL, U_MIN, U_MAX, U_EQ, U_NE, U_AND, U_OR, U_XOR}
_FLIPPED = {U_LT: U_GT, U_GT: U_LT, U_LE: U_GE, U_GE: U_LE}
_LOGIC = {U_LT, U_LE, U_GT, U_GE, U_EQ, U_NE, U_AND, U_OR, U_XOR, U_NOT,
          U_BOOL}
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


@dataclasses.dataclass(frozen=True)
class Program:
    """A recorded program: instructions ``(code, dst, a, b, y, bimm)`` with
    ``y`` an int (plane, draw, exponent, record column or the select's true
    register) or the float immediate of a ``bimm`` operand or a constant;
    the registers and the draws it takes."""

    ins: tuple
    n_regs: int
    n_draws: int

    def stores(self) -> List[int]:
        return [y for code, *_, y, _ in self.ins if code == U_ST]


# -- SSA over scalar components -----------------------------------------------


class _SSA:
    """Per-component values: ``defs[vid] = (code, args, y)``; pure values
    are merged by key. Effects (stores, alive clears, record sums) are kept
    in order."""

    def __init__(self):
        self.defs: List[tuple] = []
        self.memo: Dict[tuple, int] = {}
        self.effects: List[tuple] = []

    def val(self, code, args=(), y=0) -> int:
        key = (code, tuple(args), _bits(y) if isinstance(y, float) else y)
        vid = self.memo.get(key)
        if vid is None:
            vid = self.memo[key] = len(self.defs)
            self.defs.append((code, tuple(args), y))
        return vid

    def const(self, x) -> int:
        return self.val(U_CONST, (), _f32(x))

    def is_const(self, vid) -> bool:
        return self.defs[vid][0] == U_CONST

    def binary(self, code, a, b) -> int:
        if self.is_const(a) and not self.is_const(b):
            if code in _COMMUTATIVE:
                a, b = b, a
            elif code in _FLIPPED:
                code, a, b = _FLIPPED[code], b, a
        return self.val(code, (a, b))


def _uses(code, args, ssa) -> List[int]:
    """The operands that need a register: operand b of a binary operation
    and the false value of a select may be a constant's immediate."""
    if code == U_SEL:
        cond, tv, fv = args
        return [cond, tv] + ([] if ssa.is_const(fv) else [fv])
    if len(args) == 2:
        return [args[0]] + ([] if ssa.is_const(args[1]) else [args[1]])
    return list(args)


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
    ins = []
    for i, (kind, item) in enumerate(order):
        if kind == "e":
            code, v, y = item
            ins.append((code, 0, reg[v], 0, y, False))
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
    return Program(tuple(ins), max(n_regs, 1), n_draws)


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
    if dtype == torch.bool:
        return "b"
    if dtype == torch.float32:
        return "f"
    if dtype in (torch.int32, torch.int64, torch.int16, torch.int8,
                 torch.uint8):
        return "i"
    return "?"


def _name(target) -> Tuple[str, str]:
    """(packet, overload) of an aten target: ``aten.mul.Tensor`` ->
    ``("mul", "Tensor")``."""
    parts = str(target).split(".")
    if len(parts) >= 3 and parts[0] == "aten":
        return parts[1], parts[2]
    if len(parts) == 2 and parts[0] == "aten":
        return parts[1], "default"
    return str(target), ""


class _Translator:
    """One aten graph to SSA values. ``n`` is the traced particle count: a
    value of shape ``()`` or ``(n,)`` has 1 component, ``(3, n)`` three."""

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
        if inp.role == "plane":
            return self.ssa.val(U_LD, (), int(c))
        if inp.role == "t":
            return self.ssa.val(U_T)
        if inp.role == "dt":
            return self.ssa.val(U_DT)
        return self.ssa.const(c)

    def set(self, node, comps, kind):
        self.vals[node] = comps
        self.kinds[node] = kind

    def call(self, node):
        ssa = self.ssa
        if node.target is operator.getitem:
            seq, i = node.args
            self.set(node, list(self.vals[seq][i]), self.kinds[seq])
            return
        name, over = _name(node.target)
        args, kw = node.args, node.kwargs
        val = node.meta.get("val")
        kind = _kind_of(getattr(val, "dtype", torch.float32)) \
            if isinstance(val, torch.Tensor) else "f"
        if name == "select" and args[0] is self.draws_node:
            self.set(node, [ssa.val(U_UNIF, (), int(args[2]))], "f")
            return
        if kind == "?":
            raise Refused("op-unsupported", f"aten.{name} gives dtype "
                          f"{val.dtype} (a value is float32 or bool)")
        if name in _IDENTITY:
            src = args[0]
            self.vals[node] = self.vals[src]
            self.kinds[node] = self.kinds[src]
            return
        if name == "_to_copy":
            self.convert(node, args[0], kw.get("dtype"))
            return
        if name in _FACTORIES:
            self.factory(node, name, args, kw)
            return
        if name in _UNARY:
            (x,) = args[:1]
            cs = self.comps_of(x)
            if self.kind_of(x) != "f" and name not in ("abs", "neg"):
                cs = [ssa.val(U_BOOL, (c,)) if self.kind_of(x) == "b" else c
                      for c in cs]
            self.set(node, [ssa.val(_UNARY[name], (c,)) for c in cs],
                     "f" if kind == "f" else self.kind_of(x))
            return
        if name == "square":
            cs = self.comps_of(args[0])
            self.set(node, [ssa.binary(U_MUL, c, c) for c in cs], kind)
            return
        if name in ("bitwise_not", "logical_not"):
            if self.kind_of(args[0]) == "i":
                raise Refused("op-unsupported", f"aten.{name} on integers")
            cs = self.comps_of(args[0])
            self.set(node, [ssa.val(U_NOT, (c,)) for c in cs], "b")
            return
        if name in _BINARY or name == "rsub":
            self.binary(node, name, args, kw, kind)
            return
        if name == "pow":
            self.pow(node, over, args, kind)
            return
        if name in ("clamp", "clamp_min", "clamp_max"):
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            if name == "clamp_max":
                lo, hi = None, args[1]
            cs = self.comps_of(args[0])
            if lo is not None:
                cl = self.comps_of(lo)
                (cs, cl), _ = self.broadcast(cs, cl)
                cs = [ssa.binary(U_MAX, a, b) for a, b in zip(cs, cl)]
            if hi is not None:
                ch = self.comps_of(hi)
                (cs, ch), _ = self.broadcast(cs, ch)
                cs = [ssa.binary(U_MIN, a, b) for a, b in zip(cs, ch)]
            self.set(node, cs, "f")
            return
        if name == "where":
            cond, a, b = (args + (None,) * 3)[:3]
            cc, ca, cb = (self.comps_of(cond), self.comps_of(a),
                          self.comps_of(b))
            (cc, ca, cb), _ = self.broadcast(cc, ca, cb)
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
            # bools are 0.0 / 1.0 and ints exact in the registers: a
            # promotion to float changes no value
            self.set(node, [self.comps_of(s)[0] for s in seq], kind)
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
        constant (rounded to float32); any other shape is refused where it
        is used."""
        kind = _kind_of(t.dtype)
        if t.numel() == 1 and kind != "?":
            self.set(node, [self.ssa.const(float(t.reshape(()).item()))],
                     kind)
        else:
            self.vals[node] = _Input("forbidden", why=f"a constant tensor of "
                                     f"shape {tuple(t.shape)} and dtype "
                                     f"{t.dtype} (constants are scalars)")
            self.kinds[node] = "f"

    def convert(self, node, x, dtype):
        cs = self.comps_of(x)
        src = self.kind_of(x)
        if dtype is None or dtype == torch.float32:
            self.set(node, cs, "f")
        elif dtype == torch.bool:
            self.set(node, cs if src == "b" else
                     [self.ssa.val(U_BOOL, (c,)) for c in cs], "b")
        elif _kind_of(dtype) == "i":
            self.set(node, cs if src != "f" else
                     [self.ssa.val(U_TRUNC, (c,)) for c in cs], "i")
        else:
            raise Refused("op-unsupported", f"aten._to_copy to {dtype} (a "
                          "value is float32 or bool)")

    def factory(self, node, name, args, kw):
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
        dt = kw.get("dtype")
        kind = "b" if dt == torch.bool else "f"
        if kind == "b":
            v = 1.0 if v else 0.0
        self.set(node, [self.ssa.const(float(v))] * k, kind)

    def binary(self, node, name, args, kw, kind):
        ssa = self.ssa
        if kw.get("alpha", 1) != 1:
            raise Refused("op-unsupported", f"aten.{name} with alpha")
        if kw.get("rounding_mode") is not None:
            raise Refused("op-unsupported", f"aten.{name} with rounding_mode"
                          f"={kw['rounding_mode']!r}")
        a, b = args[0], args[1]
        code = U_SUB if name == "rsub" else _BINARY[name]
        if name == "rsub":
            a, b = b, a
        ka, kb = self.kind_of(a), self.kind_of(b)
        if code in (U_AND, U_OR, U_XOR) and name.startswith("bitwise") \
                and "i" in (ka, kb):
            raise Refused("op-unsupported", f"aten.{name} on integers")
        ca, cb = self.comps_of(a), self.comps_of(b)
        if code in (U_AND, U_OR, U_XOR):
            ca = [c if ka == "b" else ssa.val(U_BOOL, (c,)) for c in ca]
            cb = [c if kb == "b" else ssa.val(U_BOOL, (c,)) for c in cb]
        (ca, cb), _ = self.broadcast(ca, cb)
        cs = [ssa.binary(code, x, y) for x, y in zip(ca, cb)]
        if kind == "b" and code not in _LOGIC:
            cs = [ssa.val(U_BOOL, (c,)) for c in cs]  # bool + bool: or
        self.set(node, cs, kind)

    def pow(self, node, over, args, kind):
        ssa = self.ssa
        base, ex = args[0], args[1]
        if over == "Scalar":  # c ** x
            cb, ce = [ssa.const(float(base))], self.comps_of(ex)
            (cb, ce), _ = self.broadcast(cb, ce)
            self.set(node, [ssa.val(U_POW, (x, y)) for x, y in zip(cb, ce)],
                     "f")
            return
        cs = self.comps_of(base)
        if isinstance(ex, bool) or not isinstance(ex, (int, float,
                                                       torch.fx.Node)):
            raise Refused("op-unsupported", f"aten.pow with exponent {ex!r}")
        if isinstance(ex, int):
            if abs(ex) > 1 << 24:
                raise Refused("op-unsupported", f"integer exponent {ex}")
            self.set(node, [ssa.val(U_IPOW, (c,), int(ex)) for c in cs], "f")
        elif isinstance(ex, float) and ex == 0.5:
            self.set(node, [ssa.val(U_SQRT, (c,)) for c in cs], "f")
        else:
            ce = self.comps_of(ex)
            (cs, ce), _ = self.broadcast(cs, ce)
            self.set(node, [ssa.binary(U_POW, x, y) for x, y in zip(cs, ce)],
                     "f")

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
        if not comp:
            self.set(node, list(self.comps_of(x)), kind)
            return
        if keep:
            raise Refused("op-unsupported", f"aten.{name} with keepdim")
        cs = self.comps_of(x)
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
                  for c in cs]
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


def _make_fx(body, examples):
    from torch.fx.experimental.proxy_tensor import make_fx

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
    if progs[0] != progs[1]:
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
                       writable=(), outputs=None, f0: int = 0) -> Program:
    """Record a ``ParticleView`` callable: an ``ElementwiseStep`` body
    (``outputs`` None: its returned fields and ``writable`` extras become
    plane stores, ``alive`` an alive clear) or a ``ReduceMeasureStep``'s
    contributions (``outputs`` the declared names: record sums into float
    columns ``f0, f0 + 1, ...``). ``view_extras`` are the declared extras
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
                ssa.effects.append((U_ACC, c, f0 + j))
            elif name == "alive":
                if c != ssa.val(U_LD, (), ALIVE_PLANE):
                    ssa.effects.append((U_ALIVE, c, 0))
            else:
                plane = (rows_of[name][0] + i if name in writable
                         else fields.index(name))
                if c != ssa.val(U_LD, (), plane):
                    ssa.effects.append((U_ST, c, plane))
        return _schedule(ssa, side["n_draws"])

    return _same_at_sizes(record, label)


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
                    ssa.effects.append((U_ALIVE, cs[0], 0))
                continue
            base = {"r": 0, "dr": 3, "v": 6, "dv": 9, "E": 12, "w": 14}[nm]
            for i, c in enumerate(cs):
                if c != ssa.val(U_LD, (), base + i):
                    ssa.effects.append((U_ST, c, base + i))
        return _schedule(ssa, 0)

    return _same_at_sizes(record, label)


# -- callable scalar fields (the expression program of ops/fields.py) ----------


def record_field(fn: Callable, varnames: Tuple[str, ...], label: str,
                 ncomp: int = 1):
    """Record a torch callable ``fn(*varnames)`` (``variable_n_fn(r0, r1,
    r2)``, ``A_fn(E)``, ``cos_theta_icdf(u)``, or with ``ncomp=3`` a
    ``LorentzForceStep`` field returning three components) into postfix
    programs of :func:`physicl_tpu_torch.ops.fields.compile_expr`; returns
    a callable with that ``spec`` (its twin runs the program), or with
    ``ncomp=3`` a tuple of three such callables, one per component (a
    component that is a Python number is a one-instruction constant
    program). Raises :class:`Refused`: ``field-fn-callable`` where the
    callable cannot be recorded, ``field-expr-unsupported`` for an
    operation the expression program lacks."""
    from physicl_tpu_torch.ops import fields as FL

    codes = {U_NEG: FL.INS_NEG, U_ABS: FL.INS_FABS, U_SQRT: FL.INS_SQRT,
             U_EXP: FL.INS_EXP, U_LOG: FL.INS_LOG, U_LOG10: FL.INS_LOG10,
             U_SIN: FL.INS_SIN, U_COS: FL.INS_COS, U_TAN: FL.INS_TAN,
             U_FLOOR: FL.INS_FLOOR, U_CEIL: FL.INS_CEIL, U_ADD: FL.INS_ADD,
             U_SUB: FL.INS_SUB, U_MUL: FL.INS_MUL, U_DIV: FL.INS_DIV,
             U_POW: FL.INS_POW, U_MIN: FL.INS_MIN, U_MAX: FL.INS_MAX}

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

        def emit(v, prog):
            code, args, y = ssa.defs[v]
            if code == U_LD:
                prog.append((FL.INS_VAR, float(y)))
            elif code == U_CONST:
                prog.append((FL.INS_CONST, y))
            elif code == U_RECIP:
                prog.append((FL.INS_CONST, 1.0))
                emit(args[0], prog)
                prog.append((FL.INS_DIV, 0.0))
            elif code == U_IPOW:
                emit(args[0], prog)
                prog.append((FL.INS_IPOW, float(y)))
            elif code in codes:
                for x in args:
                    emit(x, prog)
                prog.append((codes[code], 0.0))
            else:
                name = {v: k for k, v in globals().items()
                        if k.startswith("U_") and isinstance(v, int)}[code]
                raise Refused("field-expr-unsupported", f"{label}: the "
                              f"expression program has no {name[2:]}")
            return prog

        progs = []
        for node in tr.run():
            cs = tr.comps_of(node)
            if len(cs) != 1:
                raise Refused("field-fn-callable", f"{label} returns "
                              f"{len(cs)} components where it should "
                              "return one per slot")
            progs.append(tuple(emit(cs[0], [])))
        return tuple(progs)

    try:
        progs = _same_at_sizes(record, label)
    except Refused as e:
        if e.code == "field-expr-unsupported":
            raise
        raise Refused("field-fn-callable", e.detail) from None
    name = getattr(fn, "__name__", "callable")
    out = []
    for i, prog in enumerate(progs):
        spec = {"kind": "expr", "prog": prog, "depth": FL._depth(prog),
                "vars": tuple(varnames), "error": None,
                "text": f"<recorded {name}" + (f"[{i}]>" if ncomp > 1
                                               else ">")}

        def recorded(*args, _spec=spec):
            return FL.run_program(_spec["prog"], args)

        recorded.spec = spec
        out.append(recorded)
    return out[0] if ncomp == 1 else tuple(out)


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

    def full(x):
        return torch.full((), float(x), dtype=torch.float32,
                          device=dev).expand(C)

    one = full(1.0)
    t, dt = t.to(dev, torch.float32).expand(C), dt.to(
        dev, torch.float32).expand(C)
    regs: List[Optional[torch.Tensor]] = [None] * prog.n_regs
    base = rng.idx
    from physicl_tpu_torch.ops import fields as FL

    for code, d, a, b, y, bimm in prog.ins:
        va = regs[a]
        vb = full(y) if bimm and code != U_SEL else regs[b]
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
        elif code == U_CONST:
            v = full(y)
        elif code == U_UNIF:
            v = rng.uniform_at(base + y + 1)
        elif code == U_NEG:
            v = -va
        elif code == U_ABS:
            v = va.abs()
        elif code == U_SQRT:
            v = FL._sqrt_rn(va)
        elif code == U_RECIP:
            v = torch.div(one, va)
        elif code == U_NOT:
            v = (va == 0).to(torch.float32)
        elif code == U_BOOL:
            v = (va != 0).to(torch.float32)
        elif code == U_IPOW:
            v = FL._ipow(va, int(y))
        elif code == U_SEL:
            if bimm:
                v = torch.where(va != 0, regs[b], full(y))
            else:
                v = torch.where(va != 0, regs[y], regs[b])
        elif code in _TWIN_UNARY:
            v = _TWIN_UNARY[code](va)
        elif code in _TWIN_BINARY:
            v = _TWIN_BINARY[code](va, vb)
        else:
            raise ValueError(f"user program code {code}")
        regs[d] = v
    rng.idx = base + prog.n_draws
    return alive


def _cmp(fn):
    return lambda a, b: fn(a, b).to(torch.float32)


_TWIN_UNARY = {U_EXP: torch.exp, U_LOG: torch.log, U_LOG10: torch.log10,
               U_SIN: torch.sin, U_COS: torch.cos, U_TAN: torch.tan,
               U_FLOOR: torch.floor, U_CEIL: torch.ceil,
               U_TRUNC: torch.trunc}
_TWIN_BINARY = {
    U_ADD: torch.add, U_SUB: torch.sub, U_MUL: torch.mul, U_DIV: torch.div,
    U_POW: torch.pow, U_MIN: torch.minimum, U_MAX: torch.maximum,
    U_LT: _cmp(torch.lt), U_LE: _cmp(torch.le), U_GT: _cmp(torch.gt),
    U_GE: _cmp(torch.ge), U_EQ: _cmp(torch.eq), U_NE: _cmp(torch.ne),
    U_AND: lambda a, b: ((a != 0) & (b != 0)).to(torch.float32),
    U_OR: lambda a, b: ((a != 0) | (b != 0)).to(torch.float32),
    U_XOR: lambda a, b: ((a != 0) ^ (b != 0)).to(torch.float32)}
