"""Density, cross-section and force fields: what the transport kernel
evaluates for ``variable_n_fn`` (n(r)), ``A_fn`` (A(E)), a recorded
``cos_theta_icdf`` and a recorded E or B of ``LorentzForceStep``.

Three kinds, each a torch callable (the plain version the kernel's twin
calls, as the JAX emulated chunk calls the JAX callables) carrying a
``spec`` dict that :mod:`physicl_tpu_torch.ops.fused` turns into the
kernel's field descriptor:

* ``"expr"``: a field program in the recorder's IR
  (:class:`physicl_tpu_torch.ops.record.Program`: one SSA register code,
  variable ``i`` a load of plane ``i``, output ``j`` a store to ``j``),
  from a torch callable (:func:`physicl_tpu_torch.ops.record.
  record_field`, every code the recorder has, selects and comparisons
  included; a Lorentz field one program with three outputs) or a
  C-expression string over ``r0/r1/r2[gid]`` or ``E[gid]`` in the
  reference's grammar (the JAX package's ``_EXPR_NS``,
  :func:`compile_expr`). The string folds literals exactly as Python and
  JAX evaluate it: a subtree made only of literals is one Python value
  (double or int) that rounds to float32 where it meets a float array and
  is an int32 where it meets an integer; a function call is a float32
  operation even on literals; an integer exponent (``x ** 2``, ``pow(x,
  2)``) is ``lax.integer_pow``'s repeated products; integers are int32
  values, as jnp's ``eval`` gives them with x64 off, and wrap. A typed
  constant takes its bits' 16-bit chunks in the ``Plan``'s ``fk``
  (:func:`fk_slots`). :mod:`physicl_tpu_torch.ops.codegen` compiles each program to
  straight-line C in its plan's form library, the program's shape
  (:func:`field_layout`) in the form and its constants in the runtime
  ``Plan``; its plain version is :func:`physicl_tpu_torch.ops.record.
  run_field`.
* ``"layered"``: piecewise-constant layers along x, y, z or the radius
  (``light.layered_density``); edges and values ride in the kernel's
  auxiliary table and the kernel finds the layer by bisection.
* ``"voxel"``: a 3-D grid (``light.voxel_density``), nearest or trilinear,
  read straight from a device copy of the flat float32 grid (one upload per
  callable and device, shared by every op that uses the callable).

A torch callable has no spec: the prover records it into an ``"expr"``
program, or refuses one it cannot record (code ``field-fn-callable``).
"""

from __future__ import annotations

import ast
import re
import struct
import zlib

import numpy as np
import torch

from physicl_tpu_torch.ops import record as RC

# field kinds (csrc/plan.cuh, enum FieldKind)
KIND_CODES = {"expr": 1, "layered": 2, "voxel": 3}
LAYER_AXES = {"x": 0, "y": 1, "z": 2, "r": 3}

MAX_IPOW = 1 << 24  # |integer exponent| (held exactly as a float32)
MAX_VOXELS = 2 ** 31 - 1  # the kernel's flat voxel index is int32

_GID_RE = re.compile(r"\[\s*gid\s*\]")
_CONSTS = {"M_PI": np.pi, "M_E": np.e}
_UNARY = {"sqrt": RC.U_SQRT, "fabs": RC.U_ABS, "exp": RC.U_EXP,
          "log": RC.U_LOG, "log10": RC.U_LOG10, "sin": RC.U_SIN,
          "cos": RC.U_COS, "tan": RC.U_TAN, "floor": RC.U_FLOOR,
          "ceil": RC.U_CEIL}
# the functions of a boolean or an integer that keep its kind (jnp.abs,
# floor, ceil, minimum, maximum); the others give a float
_KIND_KEEPING = {"fabs", "floor", "ceil", "fmin", "fmax"}
_BINARY = {"fmin": RC.U_MIN, "fmax": RC.U_MAX}
_BINOPS = {ast.Add: RC.U_ADD, ast.Sub: RC.U_SUB, ast.Mult: RC.U_MUL,
           ast.Div: RC.U_DIV}
_LOGIC = {ast.BitAnd: RC.U_AND, ast.BitOr: RC.U_OR, ast.BitXor: RC.U_XOR}
_LOGIC_INT = {ast.BitAnd: RC.U_BAND, ast.BitOr: RC.U_BOR,
              ast.BitXor: RC.U_BXOR}
_SHIFTS = {ast.LShift: RC.U_SHL, ast.RShift: RC.U_SHR}
_CMPOPS = {ast.Lt: RC.U_LT, ast.LtE: RC.U_LE, ast.Gt: RC.U_GT,
           ast.GtE: RC.U_GE, ast.Eq: RC.U_EQ, ast.NotEq: RC.U_NE}
_LITERAL_NODES = (ast.Constant, ast.UnaryOp, ast.BinOp, ast.BoolOp,
                  ast.Compare, ast.IfExp, ast.operator, ast.unaryop,
                  ast.boolop, ast.cmpop, ast.expr_context)
_RANK = {"b": 0, "i": 1, "f": 2}  # a boolean, an integer, a float
_SYMBOLS = {ast.BitAnd: "&", ast.BitOr: "|", ast.BitXor: "^",
            ast.LShift: "<<", ast.RShift: ">>", ast.MatMult: "@"}
_INT32 = 2 ** 31
_NOT_LITERAL = object()
_sqrt_rn = RC._sqrt_rn


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class _Unsupported(Exception):
    """A construct the reference evaluates and the kernel's field programs
    do not: the prover refuses it (``field-expr-unsupported``)."""


class _Raise(Exception):
    """A construct the reference's ``eval`` over jnp raises on: ``exc``
    the exception it raises."""

    def __init__(self, exc, msg):
        super().__init__(msg)
        self.exc = exc


def _literal(node):
    """The Python value of a literal-only subtree (no variable and no
    call: Python evaluates it, in bool, int or float), or
    ``_NOT_LITERAL``."""
    for sub in ast.walk(node):
        if not (isinstance(sub, _LITERAL_NODES) or (
                isinstance(sub, ast.Name) and sub.id in _CONSTS)):
            return _NOT_LITERAL
    try:
        v = eval(compile(ast.Expression(node), "<literal>", "eval"),
                 {"__builtins__": {}}, dict(_CONSTS))
    except (ArithmeticError, ValueError, TypeError) as e:
        raise _Raise(type(e), f"literal subexpression "
                     f"{ast.unparse(node)!r}: {e}") from None
    if not isinstance(v, (bool, int, float)):
        raise _Unsupported(f"literal subexpression value {v!r}")
    return v


class _Val:
    """A value of the field program: its SSA number and its kind (``"b"``
    a boolean held as 0.0 / 1.0, ``"i"`` an int32, ``"f"`` a float32)."""

    def __init__(self, vid, kind="f"):
        self.vid, self.kind = vid, kind


class _Compiler:
    """A C-expression string's AST -> SSA values, with the kinds jnp
    gives them: a boolean meets arithmetic as 0 or 1 (``b + b`` is or,
    ``b * b`` and), an integer (a boolean with an integer, ``%``, ``//``,
    ``& | ^ ~ << >>``) is an int32 that wraps, and a float wins. Operands
    stay in the string's order (an operation of a literal and a variable
    keeps its operands as written)."""

    def __init__(self, varnames):
        self.varnames = list(varnames)
        self.ssa = RC._SSA()

    def const(self, v) -> _Val:
        """A Python literal where it meets an array (a weak type)."""
        if isinstance(v, bool):
            return _Val(self.ssa.const(float(v)), "b")
        if isinstance(v, int):
            if not -_INT32 <= v < _INT32:
                raise _Raise(OverflowError, f"the integer {v} does not fit "
                             "int32")
            # its float32 constant too, where a float meets it (in the
            # literal's place in the program)
            self.ssa.const(v)
            return _Val(self.ssa.const(v, RC.I32), "i")
        return _Val(self.ssa.const(v))

    def to(self, v: _Val, kind: str) -> int:
        """``v``'s SSA value as ``kind`` (a boolean's 0.0 / 1.0 is already
        a float; an integer converts)."""
        if v.kind == kind or (kind == "f" and v.kind == "b"):
            return v.vid
        return self.ssa.cvt(v.vid, RC.F32 if kind == "f" else RC.I32)

    def emit(self, node) -> _Val:
        v = _literal(node)
        if v is not _NOT_LITERAL:
            return self.const(v)
        ssa = self.ssa
        if isinstance(node, ast.Name):
            return _Val(ssa.val(RC.U_LD, (), self.varnames.index(node.id)))
        if isinstance(node, ast.UnaryOp):
            return self.unary(node)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Pow):
                return self.pow(node.left, node.right)
            return self.binop(node.op, self.emit(node.left),
                              self.emit(node.right))
        if isinstance(node, ast.Compare):
            if len(node.ops) > 1:
                raise _Raise(ValueError, f"chained comparison "
                             f"{ast.unparse(node)!r}: the truth value of "
                             "an array is ambiguous")
            op = type(node.ops[0])
            if op not in _CMPOPS:
                raise _Unsupported(f"comparison {ast.unparse(node)!r}")
            a = self.emit(node.left)
            b = self.emit(node.comparators[0])
            kind = max(a.kind, b.kind, key=_RANK.get)
            kind = "f" if kind == "b" else kind
            return _Val(ssa.val(_CMPOPS[op], (self.to(a, kind),
                                              self.to(b, kind))), "b")
        if isinstance(node, ast.BoolOp):
            # Python's and / or: an array's truth value raises
            for sub in node.values[:-1]:
                v = _literal(sub)
                if v is _NOT_LITERAL:
                    raise _Raise(ValueError, f"{ast.unparse(node)!r}: the "
                                 "truth value of an array is ambiguous")
                if bool(v) != isinstance(node.op, ast.And):
                    return self.const(v)
            return self.emit(node.values[-1])
        if isinstance(node, ast.IfExp):
            v = _literal(node.test)
            if v is _NOT_LITERAL:
                raise _Raise(ValueError, f"{ast.unparse(node)!r}: the truth "
                             "value of an array is ambiguous")
            return self.emit(node.body if v else node.orelse)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and not node.keywords):
            return self.call(node)
        raise _Unsupported(f"construct {ast.unparse(node)!r}")

    def unary(self, node) -> _Val:
        x = self.emit(node.operand)
        if isinstance(node.op, ast.UAdd):
            return x
        if isinstance(node.op, ast.Not):
            raise _Raise(ValueError, f"{ast.unparse(node)!r}: the truth "
                         "value of an array is ambiguous")
        if isinstance(node.op, ast.USub):
            if x.kind == "b":
                raise _Raise(TypeError, f"{ast.unparse(node)!r}: neg does "
                             "not accept dtype bool")
            return _Val(self.ssa.val(RC.U_NEG, (x.vid,)), x.kind)
        # ~: a boolean's not, an integer's bitwise not
        if x.kind == "f":
            raise _Raise(TypeError, f"{ast.unparse(node)!r}: not does not "
                         "accept dtype float32")
        if x.kind == "i":
            return _Val(self.ssa.val(RC.U_BNOT, (x.vid,)), "i")
        return _Val(self.ssa.val(RC.U_NOT, (x.vid,)), "b")

    def binop(self, op, a: _Val, b: _Val) -> _Val:
        ssa = self.ssa
        t = type(op)
        text = _SYMBOLS.get(t, t.__name__)
        kinds = {a.kind, b.kind}
        kind = max(kinds, key=_RANK.get)
        if t in _LOGIC or t in _SHIFTS:
            if "f" in kinds:
                raise _Raise(TypeError, f"{text} does not accept dtype "
                             "float32")
            if t in _LOGIC and kinds == {"b"}:
                return _Val(ssa.val(_LOGIC[t], (a.vid, b.vid)), "b")
            code = _LOGIC_INT.get(t) or _SHIFTS[t]
            return _Val(ssa.val(code, (self.to(a, "i"), self.to(b, "i"))),
                        "i")
        if t is ast.Div:
            return _Val(ssa.val(RC.U_DIV, (self.to(a, "f"), self.to(b, "f"))))
        if t in (ast.Mod, ast.FloorDiv):
            if kind == "f":
                fn = RC._remainder if t is ast.Mod else RC._floor_divide
                return _Val(fn(ssa, self.to(a, "f"), self.to(b, "f")))
            ai, bi = self.to(a, "i"), self.to(b, "i")
            if t is ast.Mod:
                return _Val(RC._remainder(ssa, ai, bi, True), "i")
            if not (ssa.is_const(bi) and ssa.defs[bi][2] != 0):
                raise _Unsupported("integer floor division by a value that "
                                   "may be 0 (XLA's result is "
                                   "implementation-defined)")
            return _Val(RC._int_divide(ssa, ai, bi, True), "i")
        if t not in _BINOPS:
            raise _Unsupported(f"operator {text}")
        if kinds == {"b"}:
            if t is ast.Sub:
                raise _Raise(TypeError, "sub does not accept dtype bool")
            # jnp.add of booleans is or, jnp.multiply and
            code = RC.U_OR if t is ast.Add else RC.U_AND
            return _Val(ssa.val(code, (a.vid, b.vid)), "b")
        return _Val(ssa.val(_BINOPS[t], (self.to(a, kind),
                                         self.to(b, kind))), kind)

    def call(self, node) -> _Val:
        name, args = node.func.id, node.args
        if name == "pow" and len(args) == 2:
            return self.pow(args[0], args[1])
        if name in _UNARY and len(args) == 1:
            x = self.emit(args[0])
            if name in _KIND_KEEPING and x.kind != "f":
                if x.kind == "i" and name != "fabs":
                    return x  # jnp.floor / ceil of an integer
                return _Val(self.ssa.val(_UNARY[name], (x.vid,)), x.kind)
            return _Val(self.ssa.val(_UNARY[name], (self.to(x, "f"),)))
        if name in _BINARY and len(args) == 2:
            a = self.emit(args[0])
            b = self.emit(args[1])
            kind = max((a.kind, b.kind), key=_RANK.get)
            if kind == "b":
                return _Val(self.ssa.val(_BINARY[name], (a.vid, b.vid)), "b")
            return _Val(self.ssa.val(_BINARY[name], (self.to(a, kind),
                                                     self.to(b, kind))), kind)
        raise _Unsupported(f"call {ast.unparse(node)!r}")

    def pow(self, base, exponent) -> _Val:
        """``jnp.power``: an exponent that is a Python int (or bool) is
        ``lax.integer_pow``'s repeated products (of a boolean or an
        integer an int32 that wraps, and never a negative power); a float
        one, or a float or boolean array, ``powf`` of floats."""
        e = _literal(exponent)
        x = self.emit(base)
        if isinstance(e, int):
            if abs(e) > MAX_IPOW:
                raise _Unsupported(f"integer exponent {e} beyond {MAX_IPOW}")
            if x.kind == "f":
                return _Val(self.ssa.val(RC.U_IPOW, (x.vid,), int(e)))
            if e < 0:
                raise _Raise(TypeError, "integers cannot be raised to "
                             f"negative powers ({e})")
            return _Val(self.ssa.val(RC.U_IPOW, (self.to(x, "i"),), int(e)),
                        "i")
        y = self.emit(exponent)
        if "i" in (x.kind, y.kind) or (x.kind, y.kind) == ("b", "b"):
            raise _Unsupported("a power of an integer or to an integer "
                               "array")
        return _Val(self.ssa.val(RC.U_POW, (x.vid, y.vid)))


def expr_field(prog, varnames, text, n_out=1, error=None, raises=None):
    """A torch callable over ``varnames`` that runs the field program
    ``prog`` (:func:`physicl_tpu_torch.ops.record.run_field`; ``n_out``
    outputs), with its ``spec`` of kind ``"expr"``. With ``error`` set it
    raises when called: ``raises`` (the reference's own exception for a
    construct its ``eval`` rejects, which the prover raises too) or
    ``NotImplementedError`` (a construct the kernel's programs lack, which
    the prover refuses: ``field-expr-unsupported``)."""
    spec = {"kind": "expr", "prog": prog, "n_out": n_out,
            "vars": tuple(varnames), "error": error, "raises": raises,
            "text": text}

    def fn(*args):
        if error is not None:
            raise (raises or NotImplementedError)(error)
        return RC.run_field(prog, args, n_out)

    fn.spec = spec
    return fn


def compile_expr(expr, varnames, label):
    """A C-expression string -> a torch callable over ``varnames`` with a
    ``spec`` of kind ``"expr"``: its field program, one output. The
    grammar is what the reference's ``eval`` over jnp evaluates (the JAX
    package's ``_EXPR_NS``): numbers, ``M_PI``, ``M_E``, ``True`` and
    ``False``; ``+ - * / % // **`` (``%`` and ``//`` as ``jnp.remainder``
    and ``jnp.floor_divide``), one comparison ``< <= > >= == !=``, ``& |
    ^ ~`` of booleans and of int32 values, ``<< >>`` of int32 values,
    unary ``+ -``; the functions ``sqrt fabs exp log log10 sin cos tan
    floor ceil fmin fmax pow``. Literal subtrees fold as Python folds
    them; a boolean meets arithmetic as jnp promotes it. Unknown symbols
    raise ``ValueError`` (as in the JAX package); a construct that the
    reference's ``eval`` raises on (a chained comparison, ``x if c else
    y`` or ``and`` on an array, ``-`` of a boolean, ``~`` or ``&`` of a
    float) raises its exception when the field is called or planned; one
    the kernel lacks (an integer floor division by a value that may be 0)
    is refused by the prover (``field-expr-unsupported``)."""
    text = _GID_RE.sub("", str(expr))
    tree = ast.parse(text.strip(), mode="eval")
    known = set(_CONSTS) | set(_UNARY) | set(_BINARY) | {"pow"}
    for node in ast.walk(tree):
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute) else None)
        if name is not None and name not in known and name not in varnames:
            raise ValueError(f"{label}: unknown symbol {name!r}")
    comp, error, raises = _Compiler(varnames), None, None
    try:
        comp.ssa.effects.append((RC.U_ST, RC._to_float(
            comp.ssa, comp.emit(tree.body).vid), 0))
    except _Unsupported as e:
        comp.ssa, error = RC._SSA(), f"{label}: {e}"
    except _Raise as e:
        comp.ssa, error, raises = RC._SSA(), f"{label}: {e}", e.exc
    prog = RC._schedule(comp.ssa, 0)
    return expr_field(prog, varnames, text, error=error, raises=raises)


def field_layout(spec: dict):
    """``(shape, constants)`` of an expression field: its shape hash (an
    int32 of its outputs and every instruction's opcode, registers, load
    and store indices and integer exponent: everything but the constants)
    and its constants as float32 values, one for each ``U_CONST``
    instruction and each immediate operand, in program order (the order in
    which ``ops/codegen.py:field_c`` reads them from the Plan)."""
    prog = spec["prog"]
    shape, consts = [spec["n_out"]], []
    for (code, d, a, b, y, bimm), t, (_, timm) in zip(
            prog.ins, prog.type_list(), prog.operand_types()):
        typed = (t,) if t != RC.F32 else ()
        if timm is not None:
            consts.extend(fk_slots(y, timm))
            shape.append((code, d, a, b, bimm) + typed
                         + ((timm,) if timm != t else ()))
        else:
            shape.append((code, d, a, b, y) + typed)
    h = zlib.crc32(repr(shape).encode()) & 0x7FFFFFFF
    return h, consts


def fk_slots(y, t: str) -> list:
    """A constant of type ``t`` in ``Plan::fk``: a float32 one slot; an
    integer or a float64 its bits' 16-bit chunks, high first, each an
    exact float (``csrc/typed.cuh``: ``fk_i32``, ``fk_i64``, ``fk_f64``)."""
    if t == RC.F32:
        return [float(np.float32(y))]
    if t == RC.F64:
        bits, n = struct.unpack("<Q", struct.pack("<d", float(y)))[0], 4
    else:
        n = RC.INT_BITS[t] // 16
        bits = int(y) & ((1 << (16 * n)) - 1)
    return [float((bits >> (16 * (n - 1 - j))) & 0xFFFF) for j in range(n)]


def _on(spec: dict, key: str, device) -> torch.Tensor:
    """``spec[key]`` (a numpy array) as a float32 tensor on ``device``,
    copied there once and kept in the spec."""
    dev = torch.device(device)
    cache = spec.setdefault("_dev", {})
    t = cache.get((key, dev))
    if t is None:
        t = cache[(key, dev)] = torch.from_numpy(
            np.ascontiguousarray(spec[key], np.float32)).to(dev)
    return t


def grid_on(spec: dict, device) -> torch.Tensor:
    """The flat float32 voxel grid of a voxel spec on ``device``: one
    upload per spec and device, shared by every op and by the twin."""
    return _on(spec, "flat", device)


def layered_fn(spec: dict):
    """Plain version of the kernel's layered field: the layer ``i`` with
    ``edges[i] <= coord < edges[i+1]`` (for finite values the JAX mask sum
    gives the same number), ``outside`` beyond the edges, 0 for a NaN
    coordinate (no mask of the JAX sum is set there)."""
    axis = spec["axis"]
    L = len(spec["values"])
    outside = _f32(spec["outside"])
    center = [_f32(c) for c in spec["center"]]

    def fn(r0, r1, r2):
        dev = r0.device
        edges = _on(spec, "edges", dev)
        values = _on(spec, "values", dev)
        if axis == LAYER_AXES["r"]:
            d = [r - c.to(dev) for r, c in zip((r0, r1, r2), center)]
            coord = _sqrt_rn(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        else:
            coord = (r0, r1, r2)[axis]
        i = (torch.searchsorted(edges, coord.contiguous(), right=True)
             - 1).clamp(0, L - 1)
        val = values[i]
        out = (coord < edges[0]) | (coord >= edges[L])
        val = torch.where(out, outside.to(dev), val)
        return torch.where(torch.isnan(coord), 0.0, val)

    return fn


def _index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """A float index clamped to [0, hi] before the conversion (a NaN reads
    slot 0; the caller masks such points), as int64."""
    return torch.nan_to_num(x, nan=0.0).clamp(0, hi).to(torch.int64)


def voxel_fn(spec: dict):
    """Plain version of the kernel's voxel field, the arithmetic of
    ``physicl_tpu/ops/fused.py:_bind_vox_field`` in the same order:
    ``f = (r - origin) / spacing``; nearest rounds half to even; trilinear
    sums ``val + ((wx * wy) * wz) * corner`` over dx, dy, dz in that order."""
    nx, ny, nz = spec["shape"]
    org = [_f32(o) for o in spec["origin"]]
    sp = [_f32(s) for s in spec["spacing"]]
    outside = _f32(spec["outside"])
    trilinear = spec["interp"] == "trilinear"
    one = _f32(1.0)

    def fn(r0, r1, r2):
        dev = r0.device
        grid = grid_on(spec, dev)
        f = [(r - o.to(dev)) / s.to(dev) for r, o, s in zip((r0, r1, r2),
                                                             org, sp)]
        n = (nx, ny, nz)
        if not trilinear:
            inside = torch.ones_like(r0, dtype=torch.bool)
            for fi, ni in zip(f, n):
                inside &= (fi >= -0.5) & (fi < _f32(ni - 0.5).to(dev))
            ix, iy, iz = (_index(torch.round(fi), ni - 1)
                          for fi, ni in zip(f, n))
            val = grid[(ix * ny + iy) * nz + iz]
            return torch.where(inside, val, outside.to(dev))
        inside = torch.ones_like(r0, dtype=torch.bool)
        for fi, ni in zip(f, n):
            inside &= (fi >= 0) & (fi <= _f32(ni - 1).to(dev))
        lo = [_index(torch.floor(fi), ni - 2) for fi, ni in zip(f, n)]
        t = [(fi - li.to(torch.float32)).clamp(0.0, 1.0)
             for fi, li in zip(f, lo)]
        w = [((one.to(dev) - ti), ti) for ti in t]
        val = torch.zeros_like(r0)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    flat = ((lo[0] + dx) * ny + (lo[1] + dy)) * nz \
                        + (lo[2] + dz)
                    corner = grid[flat]
                    val = val + w[0][dx] * w[1][dy] * w[2][dz] * corner
        return torch.where(inside, val, outside.to(dev))

    return fn


