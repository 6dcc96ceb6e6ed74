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
  (double or int) that rounds to float32 where it meets an array; a
  function call is a float32 operation even on literals; an integer
  exponent (``x ** 2``, ``pow(x, 2)``) is ``lax.integer_pow``'s repeated
  products. :mod:`physicl_tpu_torch.ops.codegen` compiles each program to
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
_BINARY = {"fmin": RC.U_MIN, "fmax": RC.U_MAX}
_BINOPS = {ast.Add: RC.U_ADD, ast.Sub: RC.U_SUB, ast.Mult: RC.U_MUL,
           ast.Div: RC.U_DIV}
_NOT_LITERAL = object()
_sqrt_rn = RC._sqrt_rn


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class _Unsupported(Exception):
    pass


def _literal(node):
    """The Python value of a literal-only subtree (evaluated as Python
    evaluates it, in double or int), or ``_NOT_LITERAL``."""
    if isinstance(node, ast.Constant):
        if isinstance(node.value, bool) or not isinstance(
                node.value, (int, float)):
            raise _Unsupported(f"constant {node.value!r}")
        return node.value
    if isinstance(node, ast.Name) and node.id in _CONSTS:
        return _CONSTS[node.id]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                    (ast.USub, ast.UAdd)):
        v = _literal(node.operand)
        if v is _NOT_LITERAL:
            return v
        return -v if isinstance(node.op, ast.USub) else +v
    if isinstance(node, ast.BinOp) and (type(node.op) in _BINOPS
                                        or isinstance(node.op, ast.Pow)):
        a, b = _literal(node.left), _literal(node.right)
        if a is _NOT_LITERAL or b is _NOT_LITERAL:
            return _NOT_LITERAL
        try:
            v = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                 ast.Mult: lambda: a * b, ast.Div: lambda: a / b,
                 ast.Pow: lambda: a ** b}[type(node.op)]()
        except (ArithmeticError, ValueError) as e:
            raise _Unsupported(f"literal subexpression: {e}") from None
        if not isinstance(v, (int, float)):
            raise _Unsupported(f"literal subexpression value {v!r}")
        return v
    return _NOT_LITERAL


def _int_exponent(node):
    """A literal-only exponent that is a Python int (``lax.integer_pow``),
    else None."""
    v = _literal(node)
    if isinstance(v, int) and not isinstance(v, bool):
        if abs(v) > MAX_IPOW:
            raise _Unsupported(f"integer exponent {v} beyond {MAX_IPOW}")
        return v
    return None


def _emit(node, varnames, ssa) -> int:
    """The SSA value of ``node``, its operands in the string's order (an
    operation of a literal and a variable keeps its operands as written)."""
    v = _literal(node)
    if v is not _NOT_LITERAL:
        return ssa.const(v)
    if isinstance(node, ast.Name):
        return ssa.val(RC.U_LD, (), varnames.index(node.id))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return ssa.val(RC.U_NEG, (_emit(node.operand, varnames, ssa),))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        return _emit(node.operand, varnames, ssa)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
        return _emit_pow(node.left, node.right, varnames, ssa)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        a = _emit(node.left, varnames, ssa)
        return ssa.val(_BINOPS[type(node.op)],
                       (a, _emit(node.right, varnames, ssa)))
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and not node.keywords):
        name, args = node.func.id, node.args
        if name == "pow" and len(args) == 2:
            return _emit_pow(args[0], args[1], varnames, ssa)
        if name in _UNARY and len(args) == 1:
            return ssa.val(_UNARY[name], (_emit(args[0], varnames, ssa),))
        if name in _BINARY and len(args) == 2:
            a = _emit(args[0], varnames, ssa)
            return ssa.val(_BINARY[name], (a, _emit(args[1], varnames, ssa)))
        raise _Unsupported(f"call {ast.unparse(node)!r}")
    raise _Unsupported(f"construct {ast.unparse(node)!r}")


def _emit_pow(base, exponent, varnames, ssa) -> int:
    y = _int_exponent(exponent)
    x = _emit(base, varnames, ssa)
    if y is not None:
        return ssa.val(RC.U_IPOW, (x,), y)
    return ssa.val(RC.U_POW, (x, _emit(exponent, varnames, ssa)))


def expr_field(prog, varnames, text, n_out=1, error=None):
    """A torch callable over ``varnames`` that runs the field program
    ``prog`` (:func:`physicl_tpu_torch.ops.record.run_field`; ``n_out``
    outputs), with its ``spec`` of kind ``"expr"``. With ``error`` set
    (a construct outside the IR) it raises ``NotImplementedError`` when
    called, and the prover refuses it (``field-expr-unsupported``)."""
    spec = {"kind": "expr", "prog": prog, "n_out": n_out,
            "vars": tuple(varnames), "error": error, "text": text}

    def fn(*args):
        if error is not None:
            raise NotImplementedError(error)
        return RC.run_field(prog, args, n_out)

    fn.spec = spec
    return fn


def compile_expr(expr, varnames, label):
    """A C-expression string -> a torch callable over ``varnames`` with a
    ``spec`` of kind ``"expr"``: its field program, one output. Unknown
    symbols raise ``ValueError`` (as in the JAX package); a construct
    outside the grammar is kept as ``spec["error"]`` and refused by the
    prover (``field-expr-unsupported``)."""
    text = _GID_RE.sub("", str(expr))
    tree = ast.parse(text.strip(), mode="eval")
    known = set(_CONSTS) | set(_UNARY) | set(_BINARY) | {"pow"}
    for node in ast.walk(tree):
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute) else None)
        if name is not None and name not in known and name not in varnames:
            raise ValueError(f"{label}: unknown symbol {name!r}")
    ssa, error = RC._SSA(), None
    try:
        ssa.effects.append((RC.U_ST, _emit(tree.body, list(varnames), ssa),
                            0))
    except _Unsupported as e:
        ssa, error = RC._SSA(), f"{label}: {e}"
    prog = RC._schedule(ssa, 0)
    return expr_field(prog, varnames, text, error=error)


def field_layout(spec: dict):
    """``(shape, constants)`` of an expression field: its shape hash (an
    int32 of its outputs and every instruction's opcode, registers, load
    and store indices and integer exponent: everything but the constants)
    and its constants as float32 values, one for each ``U_CONST``
    instruction and each immediate operand, in program order (the order in
    which ``ops/codegen.py:field_c`` reads them from the Plan)."""
    shape, consts = [spec["n_out"]], []
    for code, d, a, b, y, bimm in spec["prog"].ins:
        if code == RC.U_CONST or bimm:
            consts.append(float(np.float32(y)))
            shape.append((code, d, a, b, bimm))
        else:
            shape.append((code, d, a, b, y))
    h = zlib.crc32(repr(shape).encode()) & 0x7FFFFFFF
    return h, consts


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


