"""Density and cross-section fields: what the transport kernel evaluates for
``variable_n_fn`` (n(r)) and ``A_fn`` (A(E)).

Three kinds, each a torch callable (the plain version the kernel's twin
calls, as the JAX emulated chunk calls the JAX callables) carrying a
``spec`` dict that :mod:`physicl_tpu_torch.ops.fused` turns into the
kernel's field descriptor:

* ``"expr"``: a C-expression string over ``r0/r1/r2[gid]`` or ``E[gid]``
  in the reference's grammar (the JAX package's ``_EXPR_NS``), compiled to
  a short postfix program that the kernel interprets from its plan. The
  program folds literals exactly as Python and JAX evaluate the string: a
  subtree made only of literals is one Python value (double or int) that
  rounds to float32 where it meets an array; a function call is a float32
  operation even on literals; an integer exponent (``x ** 2``,
  ``pow(x, 2)``) is ``lax.integer_pow``'s repeated products.
* ``"layered"``: piecewise-constant layers along x, y, z or the radius
  (``light.layered_density``); edges and values ride in the kernel's
  auxiliary table and the kernel finds the layer by bisection.
* ``"voxel"``: a 3-D grid (``light.voxel_density``), nearest or trilinear,
  read straight from a device copy of the flat float32 grid (one upload per
  callable and device, shared by every op that uses the callable).

A torch callable has no spec: the prover records it into an ``"expr"``
program (:func:`physicl_tpu_torch.ops.record.record_field`), or refuses one
it cannot record (code ``field-fn-callable``).
"""

from __future__ import annotations

import ast
import re

import numpy as np
import torch

# postfix instruction codes (csrc/fused_transport.cu, enum FieldIns)
INS_CONST, INS_VAR, INS_NEG, INS_ADD, INS_SUB, INS_MUL, INS_DIV, INS_POW, \
    INS_IPOW, INS_MIN, INS_MAX, INS_SQRT, INS_FABS, INS_EXP, INS_LOG, \
    INS_LOG10, INS_SIN, INS_COS, INS_TAN, INS_FLOOR, INS_CEIL = range(21)

# field kinds (csrc/fused_transport.cu, enum FieldKind)
KIND_CODES = {"expr": 1, "layered": 2, "voxel": 3}
LAYER_AXES = {"x": 0, "y": 1, "z": 2, "r": 3}

MAX_PROG = 256     # postfix instructions over all expression fields of a plan
MAX_DEPTH = 16     # evaluation stack of one expression
MAX_IPOW = 1 << 24  # |integer exponent| (held exactly as a float32)
MAX_VOXELS = 2 ** 31 - 1  # the kernel's flat voxel index is int32

_GID_RE = re.compile(r"\[\s*gid\s*\]")
_CONSTS = {"M_PI": np.pi, "M_E": np.e}
_UNARY = {"sqrt": INS_SQRT, "fabs": INS_FABS, "exp": INS_EXP, "log": INS_LOG,
          "log10": INS_LOG10, "sin": INS_SIN, "cos": INS_COS, "tan": INS_TAN,
          "floor": INS_FLOOR, "ceil": INS_CEIL}
_BINARY = {"fmin": INS_MIN, "fmax": INS_MAX}
_BINOPS = {ast.Add: INS_ADD, ast.Sub: INS_SUB, ast.Mult: INS_MUL,
           ast.Div: INS_DIV}
_NOT_LITERAL = object()


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (the kernel's ``sqrtf``)."""
    return torch.sqrt(x.double()).float()


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


def _emit(node, varnames, prog):
    v = _literal(node)
    if v is not _NOT_LITERAL:
        prog.append((INS_CONST, float(np.float32(v))))
        return
    if isinstance(node, ast.Name):
        prog.append((INS_VAR, float(varnames.index(node.id))))
    elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        _emit(node.operand, varnames, prog)
        prog.append((INS_NEG, 0.0))
    elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.UAdd):
        _emit(node.operand, varnames, prog)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
        _emit_pow(node.left, node.right, varnames, prog)
    elif isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        _emit(node.left, varnames, prog)
        _emit(node.right, varnames, prog)
        prog.append((_BINOPS[type(node.op)], 0.0))
    elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
          and not node.keywords):
        name, args = node.func.id, node.args
        if name == "pow" and len(args) == 2:
            _emit_pow(args[0], args[1], varnames, prog)
        elif name in _UNARY and len(args) == 1:
            _emit(args[0], varnames, prog)
            prog.append((_UNARY[name], 0.0))
        elif name in _BINARY and len(args) == 2:
            _emit(args[0], varnames, prog)
            _emit(args[1], varnames, prog)
            prog.append((_BINARY[name], 0.0))
        else:
            raise _Unsupported(f"call {ast.unparse(node)!r}")
    else:
        raise _Unsupported(f"construct {ast.unparse(node)!r}")


def _emit_pow(base, exponent, varnames, prog):
    y = _int_exponent(exponent)
    _emit(base, varnames, prog)
    if y is not None:
        prog.append((INS_IPOW, float(y)))
    else:
        _emit(exponent, varnames, prog)
        prog.append((INS_POW, 0.0))


def _depth(prog) -> int:
    sp = deepest = 0
    for code, _ in prog:
        if code in (INS_CONST, INS_VAR):
            sp += 1
        elif code in (INS_ADD, INS_SUB, INS_MUL, INS_DIV, INS_POW, INS_MIN,
                      INS_MAX):
            sp -= 1
        deepest = max(deepest, sp)
    return deepest


def compile_expr(expr, varnames, label):
    """A C-expression string -> a torch callable over ``varnames`` with a
    ``spec`` of kind ``"expr"``. Unknown symbols raise ``ValueError`` (as
    in the JAX package); a construct outside the grammar is kept as
    ``spec["error"]`` and refused by the prover (``field-expr-unsupported``)."""
    text = _GID_RE.sub("", str(expr))
    tree = ast.parse(text.strip(), mode="eval")
    known = set(_CONSTS) | set(_UNARY) | set(_BINARY) | {"pow"}
    for node in ast.walk(tree):
        name = (node.id if isinstance(node, ast.Name)
                else node.attr if isinstance(node, ast.Attribute) else None)
        if name is not None and name not in known and name not in varnames:
            raise ValueError(f"{label}: unknown symbol {name!r}")
    prog, error = [], None
    try:
        _emit(tree.body, list(varnames), prog)
    except _Unsupported as e:
        prog, error = [], f"{label}: {e}"
    spec = {"kind": "expr", "prog": tuple(prog), "depth": _depth(prog),
            "vars": tuple(varnames), "error": error, "text": text}

    def fn(*args):
        if error is not None:
            raise NotImplementedError(error)
        return run_program(spec["prog"], args)

    fn.spec = spec
    return fn


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
    return _f32(1.0).to(acc.device) / acc if neg else acc


_TORCH_UNARY = {INS_FABS: torch.abs, INS_EXP: torch.exp, INS_LOG: torch.log,
                INS_LOG10: torch.log10, INS_SIN: torch.sin,
                INS_COS: torch.cos, INS_TAN: torch.tan,
                INS_FLOOR: torch.floor, INS_CEIL: torch.ceil,
                INS_SQRT: _sqrt_rn, INS_NEG: torch.neg}
_TORCH_BINARY = {INS_ADD: torch.add, INS_SUB: torch.sub, INS_MUL: torch.mul,
                 INS_DIV: torch.div, INS_POW: torch.pow,
                 INS_MIN: torch.minimum, INS_MAX: torch.maximum}


def run_program(prog, args) -> torch.Tensor:
    """Plain version of the kernel's postfix interpreter, in float32."""
    like = args[0]
    st = []
    for code, val in prog:
        if code == INS_CONST:
            st.append(_f32(val).to(like.device))
        elif code == INS_VAR:
            st.append(args[int(val)].to(torch.float32))
        elif code == INS_IPOW:
            st.append(_ipow(st.pop(), int(val)))
        elif code in _TORCH_UNARY:
            st.append(_TORCH_UNARY[code](st.pop()))
        else:
            b = st.pop()
            st.append(_TORCH_BINARY[code](st.pop(), b))
    return st.pop().expand(like.shape)


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


