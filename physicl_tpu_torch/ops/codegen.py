"""The transport kernel's code generator: each plan's form compiled into a
library of its own.

A plan's **form** is its structure: the op kinds in order, every flag and
boolean an op body tests, which record columns each op has, each field's
kind and which field each op reads, the norm, the stream, the extras and
their write-back masks, and the user ops' recorded programs. Its
**numbers** (coefficients, boxes, column indices, plane locations, field
geometry and grids, tables) stay in the runtime ``Plan``
(``ops/fused.py:_plan_struct``). :func:`form_source` emits one translation
unit per form: ``struct Form``, the form as ``constexpr`` tables of
``csrc/plan.cuh``'s ``OpForm``, ``AxisForm`` and ``FieldForm``, with the
user ops' programs, compiled with ``csrc/fused_transport.cu``'s
``fused_form_kernel<Form>`` (whose iteration body folds over the op
indices, so the dispatch, the flag tests, the fields' kind tests and the
draw indices are compile-time constants). Plans that differ only in
numbers share one source, one build key and one library
(``ops/fused.py:_library`` builds it through
:func:`physicl_tpu_torch.ops._build.load_plan`). The JAX package traces
each plan's ops into its kernel (``physicl_tpu/ops/fused.py:_kernel``): the
port compiles each plan's form.

Two facts the emitter derives from the form:

* each op's first draw index (``OpForm::draw0``): the draws every op
  before it makes per iteration, in the twin's order
  (:func:`draw_counts`);
* a shared field read (``OpForm::nf_shared``): an op whose n(r) is the
  same field as the last n(r) read, with no op between them that moves the
  particle (``kin``, ``reflect``, ``periodic``, ``fresnel``, ``emit`` or a
  user op), reuses that read: the same function of the same inputs.

Kernel 1i's user programs (:mod:`physicl_tpu_torch.ops.record`) become
straight-line CUDA C, one device function per program:

* one ``const`` local per instruction, an SSA value of the program's type
  (``float``, ``int``, ``long long`` or ``double``), so that the compiler
  keeps the program's values in the SM's registers; integer arithmetic in
  two's complement through the unsigned type, conversions, guarded
  shifts and the typed helpers in ``csrc/typed.cuh``;
* plane loads and stores at constant indices of ``f[]`` (the 15 core
  planes; plane 13 reads the ``alive`` flag) and ``x[]`` (the extras), in
  program order, so a load after a store reads the new value;
* draw ``i`` as ``unit24(hash_bits(h0, idx0 + i + 1, lin))``;
* an alive clear updating ``alive`` and ``f[13]``; a record sum through
  ``user_sum`` (alive-masked) into the kernel's record accumulator;
* every operation the function the plain version
  (:func:`~physicl_tpu_torch.ops.record.run_user_program`) matches:
  ``expf``, ``logf``, ``powf``, ``ipow``, ``nan_min``, ... and a lowered
  function's fused multiply-add as ``__fmaf_rn``. Built with
  ``--fmad=false``, the planes stay bitwise equal to it;
* a bounded loop as a ``for`` over its cap that a lane leaves when its
  condition clears, its carried values mutable locals updated together
  after the body;
* a select whose arm (the instructions only that operand needs) holds a
  libm call or at least ``record.ARM_MIN`` instructions as an ``if`` /
  ``else`` on its condition with each arm inside
  (:func:`~physicl_tpu_torch.ops.record.branched_arms`),
  so that a warp none of whose lanes takes an arm skips it; loads, draws,
  stores, alive clears, record sums and loops stay where they are.

A histogram tally's reduce (``light.SpectrumMeasureStep``,
``MeshTallyStep``: ``_Op.bins``) is a **binned reduce** (:func:`binned_c`):
its program computes the coordinate (and the value) with its constants
read from the ``Plan``'s ``fk``, and hands them to the kernel's
``FormRec::binned`` with the op's ``BinForm`` (``csrc/binned.cuh``: the
edges, the capture bins, the columns, the edges' search table in ``fk``),
which takes one bin index a slot and one sum per distinct bin of a warp.

The expression fields (``ops/fields.py``: a C-expression string or a
recorded torch callable; n(r), A(E), an inverse CDF, a Lorentz op's E or B
with three outputs) become one straight-line device function each
(:func:`field_c`, ``Form::field``), as the JAX kernel traces the callable
into its body: the same instructions and C functions as the user
programs, the variables as arguments, and the constants read from the
runtime ``Plan``'s ``fk`` at constant indices (a constant-bank operand of
the instruction; an integer or float64 constant from its bits' 16-bit
chunks, ``ops/fields.py:fk_slots``), so that plans that differ only in a
field's numbers share a source. The program's shape (``ops/fields.py:field_layout``) is
part of the form: ``FieldForm::shape``, checked by ``form_matches``. The
``Plan`` itself is sized for the plan (``PHYSICL_PLAN_DIMS``: ops,
crossing planes, fields, field constants); past :data:`PLAN_PARAM_BYTES`
it goes to a device buffer (:func:`plan_in_buffer`).
"""

from __future__ import annotations

import ctypes
import math
import re
import struct

import numpy as np

from physicl_tpu_torch.ops import fields as FL
from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops import record as RC

_NF = 15          # core planes: f[0..14]
# a Plan of at most this many bytes is a kernel parameter; a larger one goes
# to a device buffer (csrc/plan.cuh: kPlanParamBytes)
PLAN_PARAM_BYTES = 32000
_MAX_EXTRAS = 8   # extras planes: x[0..7] (csrc/plan.cuh)
_ARGS = ("float* f, float* x, bool& alive, float t, float dt, uint32_t h0, "
         "uint32_t idx0, uint32_t lin, Acc& acc")

_UNARY = {RC.U_NEG: "-{a}", RC.U_ABS: "fabsf({a})", RC.U_SQRT: "sqrtf({a})",
          RC.U_EXP: "expf({a})", RC.U_LOG: "logf({a})",
          RC.U_LOG10: "log10f({a})", RC.U_SIN: "sinf({a})",
          RC.U_COS: "cosf({a})", RC.U_TAN: "tanf({a})",
          RC.U_FLOOR: "floorf({a})", RC.U_CEIL: "ceilf({a})",
          RC.U_TRUNC: "truncf({a})", RC.U_RECIP: "1.0f / {a}",
          RC.U_NOT: "{a} == 0.0f ? 1.0f : 0.0f",
          RC.U_BOOL: "{a} != 0.0f ? 1.0f : 0.0f",
          RC.U_ATAN: "atanf({a})", RC.U_ASIN: "asinf({a})",
          RC.U_ACOS: "acosf({a})", RC.U_SINH: "sinhf({a})",
          RC.U_COSH: "coshf({a})", RC.U_TANH: "tanhf({a})",
          RC.U_ASINH: "asinhf({a})", RC.U_ACOSH: "acoshf({a})",
          RC.U_ATANH: "atanhf({a})", RC.U_EXP2: "exp2f({a})",
          RC.U_EXPM1: "expm1f({a})", RC.U_LOG2: "log2f({a})",
          RC.U_LOG1P: "log1pf({a})", RC.U_ERF: "erff({a})",
          RC.U_ERFC: "erfcf({a})", RC.U_LGAMMA: "lgammaf({a})",
          RC.U_RSQRT: "1.0f / sqrtf({a})", RC.U_ROUND: "rintf({a})",
          RC.U_ISNAN: "isnan({a}) ? 1.0f : 0.0f",
          RC.U_SIGNBIT: "signbit({a}) ? 1.0f : 0.0f"}
_BINARY = {RC.U_ADD: "{a} + {b}", RC.U_SUB: "{a} - {b}",
           RC.U_MUL: "{a} * {b}", RC.U_DIV: "{a} / {b}",
           RC.U_POW: "powf({a}, {b})", RC.U_MIN: "nan_min({a}, {b})",
           RC.U_MAX: "nan_max({a}, {b})",
           RC.U_LT: "{a} < {b} ? 1.0f : 0.0f",
           RC.U_LE: "{a} <= {b} ? 1.0f : 0.0f",
           RC.U_GT: "{a} > {b} ? 1.0f : 0.0f",
           RC.U_GE: "{a} >= {b} ? 1.0f : 0.0f",
           RC.U_EQ: "{a} == {b} ? 1.0f : 0.0f",
           RC.U_NE: "{a} != {b} ? 1.0f : 0.0f",
           RC.U_AND: "{a} != 0.0f && {b} != 0.0f ? 1.0f : 0.0f",
           RC.U_OR: "{a} != 0.0f || {b} != 0.0f ? 1.0f : 0.0f",
           RC.U_XOR: "({a} != 0.0f) != ({b} != 0.0f) ? 1.0f : 0.0f",
           RC.U_ATAN2: "atan2f({a}, {b})", RC.U_FMOD: "fmodf({a}, {b})",
           RC.U_COPYSIGN: "copysignf({a}, {b})",
           RC.U_NEXTAFTER: "nextafterf({a}, {b})"}


# the C types of the program's value types
_CTYPE = {RC.F32: "float", RC.I32: "int", RC.I64: "long long",
          RC.F64: "double"}
# an integer instruction (two's complement: the sums and products in the
# unsigned type, a negation too; a division and remainder by a nonzero
# constant, by -1 the remainder 0; the shifts guarded in csrc/typed.cuh)
_INT = {RC.U_NEG: "({T})(({U})0 - ({U}){a})",
        RC.U_ABS: "{a} < 0 ? ({T})(({U})0 - ({U}){a}) : {a}",
        RC.U_ADD: "({T})(({U}){a} + ({U}){b})",
        RC.U_SUB: "({T})(({U}){a} - ({U}){b})",
        RC.U_MUL: "({T})(({U}){a} * ({U}){b})",
        RC.U_DIV: "{a} / {b}", RC.U_FMOD: "{b} == -1 ? ({T})0 : {a} % {b}",
        RC.U_MIN: "{a} < {b} ? {a} : {b}", RC.U_MAX: "{a} > {b} ? {a} : {b}",
        RC.U_BAND: "{a} & {b}", RC.U_BOR: "{a} | {b}", RC.U_BXOR: "{a} ^ {b}",
        RC.U_BNOT: "~{a}", RC.U_SHL: "shl({a}, {b})",
        RC.U_SHR: "shr({a}, {b})"}
_UNSIGNED = {RC.I32: "unsigned", RC.I64: "unsigned long long"}
_BITCAST = {(RC.F32, RC.I32): "f32_as_i32", (RC.I32, RC.F32): "i32_as_f32",
            (RC.F64, RC.I64): "f64_as_i64", (RC.I64, RC.F64): "i64_as_f64"}


def _lit(y, t=RC.F32) -> str:
    """A constant of type ``t`` as C: a float an exact hexadecimal literal,
    or its bits where it is not finite; an integer a decimal one."""
    if t in RC.INT_BITS:
        v = int(y)
        if v == -(1 << (RC.INT_BITS[t] - 1)):
            return ("(-2147483647 - 1)" if t == RC.I32
                    else "(-9223372036854775807LL - 1)")
        text = f"{v}" + ("LL" if t == RC.I64 else "")
        return f"({text})" if v < 0 else text
    if t == RC.F64:
        v = float(y)
        if math.isfinite(v):
            return f"({v.hex()})" if math.copysign(1.0, v) < 0 else v.hex()
        bits = struct.unpack("<q", struct.pack("<d", v))[0]
        return f"i64_as_f64({bits}LL)"
    v = float(np.float32(y))
    if math.isfinite(v):
        text = f"{v.hex()}f"
        return f"({text})" if math.copysign(1.0, v) < 0 else text
    return f"__int_as_float({RC._bits(v) & 0xFFFFFFFF:#010x})"


def _double(template: str) -> str:
    """A float32 function's C for float64: ``expf`` -> ``exp``, ``1.0f /``
    -> ``1.0 /``, ``nan_min`` -> ``nan_min_f64``."""
    return re.sub(r"\b([a-z][a-z0-9]*)f\(", r"\1(", template).replace(
        "1.0f /", "1.0 /").replace("nan_min(", "nan_min_f64(").replace(
        "nan_max(", "nan_max_f64(")


def _plane(p: int) -> str:
    if 0 <= p < _NF:
        return f"f[{p}]"
    if _NF <= p < _NF + _MAX_EXTRAS:
        return f"x[{p - _NF}]"
    raise ValueError(f"a user program names plane {p}")


def _pure_c(ins, cur, lit, t=RC.F32, ta=RC.F32, timm=RC.F32) -> str:
    """The C expression of one pure instruction (``record._pure``'s
    codes) of type ``t`` over the locals ``cur`` (register -> local);
    ``ta`` its operand a's type, ``timm`` its constant's; ``lit(y, t)``
    spells a constant."""
    code, _, a, b, y, bimm = ins
    va = cur.get(a)
    if code == RC.U_CONST:
        return lit(y, t)
    if code == RC.U_CVT:
        if t in RC.INT_BITS and ta in (RC.F32, RC.F64):
            return f"trunc_{t_name(t)}({va})"
        return f"({_CTYPE[t]}){va}"
    if code == RC.U_BITCAST:
        return f"{_BITCAST[(ta, t)]}({va})"
    if code == RC.U_IPOW:
        fn = "ipow" if t == RC.F32 else f"ipow_{t_name(t)}"
        return f"{fn}({va}, {int(y)})"
    if code == RC.U_SEL:
        # (cond, false register, true register in y), or with a constant
        # false value (cond, true register, the immediate)
        if bimm:
            return f"{va} != 0.0f ? {cur[b]} : {lit(y, t)}"
        return f"{va} != 0.0f ? {cur[y]} : {cur[b]}"
    if code == RC.U_FMA:
        # (a, b, the addend's register in y), or its immediate
        return (f"__fmaf_rn({va}, {cur[b]}, "
                f"{lit(y, t) if bimm else cur[y]})")
    vb = lit(y, timm) if bimm else cur.get(b)
    if t in RC.INT_BITS and code in _INT:
        return _INT[code].format(a=va, b=vb, T=_CTYPE[t], U=_UNSIGNED[t])
    if code in _UNARY:
        text = _UNARY[code]
        return (_double(text) if t == RC.F64 else text).format(a=va)
    if code in _BINARY:
        text = _BINARY[code]
        return (_double(text) if t == RC.F64 else text).format(a=va, b=vb)
    raise ValueError(f"program code {code}")


def _body_c(prog: RC.Program, lit, pinned, phase=False):
    """The C statements of a program body: one ``const`` local an
    instruction (``pinned(ins, cur)``: the line of a load's, draw's, t's,
    dt's or effect's instruction, or None to leave it out; ``lit(y, t)``
    spells a constant), a loop as a ``for`` over its cap that a lane leaves
    when its condition clears (its carried values mutable locals, updated
    together after the body), and each branched select's arms
    (``record.branched_arms``) inside an ``if`` / ``else`` on its
    condition. With ``phase`` (a program every thread of the block runs
    together: kernel 1i's) each block phase of loops
    (``record.loop_phases``) runs across the block (:func:`_phase_c`)."""
    n = len(prog.ins)
    text = [[] for _ in range(n)]
    sel = {}
    cur = {}   # register -> the local that holds its value
    ctype_of = {}  # local -> its C type
    sets = []
    for i, (ins, t, (ta, timm)) in enumerate(zip(
            prog.ins, prog.type_list(), prog.operand_types())):
        code, d, a, b, y, bimm = ins
        ctype = _CTYPE[t]
        if code == RC.U_LOOP:
            text[i] = [f"for (int it{i} = 0; it{i} < {int(y)}; ++it{i}) {{",
                       f"  if ({cur[a]} == 0.0f) break;"]
            continue
        if code == RC.U_SET:
            sets.append((cur[d], cur[a]))
            continue
        if code == RC.U_END:
            # the next values together: a carried value that another's
            # update reads is copied first
            dsts = {dst for dst, _ in sets}
            lines, renamed = [], {}
            for k, (_, src) in enumerate(sets):
                if src in dsts and src not in renamed:
                    renamed[src] = f"n{i}_{k}"
                    lines.append(f"  const {ctype_of[src]} n{i}_{k} = "
                                 f"{src};")
            lines += [f"  {dst} = {renamed.get(src, src)};"
                      for dst, src in sets]
            text[i] = lines + ["}"]
            sets = []
            continue
        if code == RC.U_CARRY:
            text[i] = [f"{ctype} v{i} = {cur[a]};"]
            cur[d] = f"v{i}"
            ctype_of[cur[d]] = ctype
            continue
        line = pinned(ins, cur)
        if line is not None:
            if isinstance(line, tuple):  # a value: (expression,)
                text[i] = [f"const {ctype} v{i} = {line[0]};"]
                cur[d] = f"v{i}"
                ctype_of[cur[d]] = ctype
            else:  # the statements of an effect
                text[i] = list(line)
            continue
        spelled = []

        def lit_once(yv, tt=RC.F32):
            spelled.append(lit(yv, tt))
            return spelled[-1]

        text[i] = [f"const {ctype} v{i} = "
                   f"{_pure_c(ins, cur, lit_once, t, ta, timm)};"]
        if code == RC.U_SEL:  # (cond, true, false) for a branch
            sel[i] = (cur[a], cur[b] if bimm else cur[y],
                      spelled[-1] if bimm else cur[b], ctype)
        cur[d] = f"v{i}"
        ctype_of[cur[d]] = ctype
    branched, owner = RC.branched_arms(prog), RC.arm_owner(prog)
    members = {}
    for i in range(n):
        members.setdefault(owner.get(i), []).append(i)
    # with phase: each phased loop's instructions (its U_LOOP to its U_END)
    # and the phase each last loop ends
    inside, ends = set(), {}
    for ph in (RC.loop_phases(prog) if phase else ()):
        for p in ph:
            inside.update(range(p.loop, p.end + 1))
        ends[ph[-1].end] = ph
    out = []

    def emit(key, pad, span=None):
        for i in members.get(key, ()):
            if span is not None and not span[0] <= i <= span[1]:
                continue
            if span is None and i in inside:
                if i in ends:
                    out.extend(pad + ln for ln in _phase_c(
                        prog, ends[i], text, loop_lines))
                continue
            if i in branched:
                cond, tv, fv, ctype = sel[i]
                out.append(f"{pad}{ctype} v{i};")
                out.append(f"{pad}if ({cond} != 0.0f) {{")
                emit((i, True), pad + "  ", span)
                out.append(f"{pad}  v{i} = {tv};")
                out.append(f"{pad}}} else {{")
                emit((i, False), pad + "  ", span)
                out.append(f"{pad}  v{i} = {fv};")
                out.append(f"{pad}}}")
                continue
            code = prog.ins[i][0]
            if code == RC.U_END:
                pad = pad[:-2]
                out.extend(f"{pad}{ln}" for ln in text[i])
                continue
            out.extend(f"{pad}{ln}" for ln in text[i])
            if code == RC.U_LOOP:
                pad += "  "

    def loop_lines(p, pad):
        """A phased loop's own lines: its ``for`` and its body."""
        n0 = len(out)
        emit(None, pad, (p.loop, p.end))
        lines = out[n0:]
        del out[n0:]
        return lines

    emit(None, "  ")
    return out


def _phase_c(prog: RC.Program, ph, text, loop_lines) -> list:
    """The block phase of the loops ``ph`` (``record.loop_phases``), run by
    every thread of the block (``csrc/phase.cuh``): each lane's enables
    placed (``phase_place``: its item's place among each loop's, and each
    loop's items), its items written to the block's shared words (each
    carried and stored outer value a row of ``record.PHASE_LANES`` words,
    two for a 64-bit value), then after a barrier thread ``q`` runs items
    ``q``, ``q + 256``, ... in loop order (the loop's own locals, read from
    the item, the constants, t and dt declared again; the carried values
    the program reads after the loop written back), and after another each
    lane reads those results; a lane not enabled in a loop keeps its
    initial values. The items' rows come first, the loops' warp counts
    after them; a third barrier ends the phase, as the next phase's counts
    may take words of this one's rows."""
    tys = prog.type_list()
    m = len(ph)
    lanes = RC.PHASE_LANES
    rows = sum(RC._words(tys[j]) for p in ph for j in p.carried + p.stored)

    def cells(p, only=None):
        """(local, C type, helper suffix, word offset) of each value an
        item holds (of ``only``'s): the carried values, then the stored
        outer ones."""
        out, r = [], p.row0
        for j in p.carried + p.stored:
            if only is None or j in only:
                out.append((f"v{j}", _CTYPE[tys[j]], _tn(tys[j]),
                            lanes * r))
            r += RC._words(tys[j])
        return out

    def enable(p):
        reg = prog.ins[p.loop][2]
        return next(f"v{j}" for j in p.carried if prog.ins[j][1] == reg)

    lines = [f"{{  // block phase: {m} loop(s), {rows} rows of items",
             "  unsigned* const ph_w = phase_words();",
             f"  const bool ph_en[{m}] = {{"
             + ", ".join(f"{enable(p)} != 0.0f" for p in ph) + "};",
             f"  int ph_pos[{m}], ph_tot[{m}];",
             f"  phase_place<{m}>(ph_w + {lanes * rows}, ph_en, ph_pos, "
             "ph_tot);"]
    for k, p in enumerate(ph):
        lines += [f"  if (ph_en[{k}]) {{",
                  f"    unsigned* const ph_it = ph_w + ph_pos[{k}];"]
        lines += [f"    phase_put_{tn}(ph_it + {off}, {v});"
                  for v, _, tn, off in cells(p)]
        lines.append("  }")
    lines += ["  __syncthreads();",
              f"  for (int ph_q = threadIdx.x; ph_q < "
              f"{' + '.join(f'ph_tot[{k}]' for k in range(m))}; "
              f"ph_q += {lanes}) {{"]
    for k, p in enumerate(ph):
        # the place of item ph_q among this loop's items
        item = " - ".join(["ph_q"] + [f"ph_tot[{j}]" for j in range(k)])
        upto = " + ".join(f"ph_tot[{j}]" for j in range(k + 1))
        head = (f"if (ph_q < {upto}) {{" if k < m - 1 else "{") if k == 0 \
            else (f"}} else if (ph_q < {upto}) {{" if k < m - 1
                  else "} else {")
        n_c = len(p.carried)
        body = [f"unsigned* const ph_it = ph_w + ({item});"]
        body += [f"{'const ' if c >= n_c else ''}{ct} {v} = "
                 f"phase_get_{tn}(ph_it + {off});"
                 for c, (v, ct, tn, off) in enumerate(cells(p))]
        for j in p.uniform:
            body += text[j]
        body += loop_lines(p, "")
        body += [f"phase_put_{tn}(ph_it + {off}, {v});"
                 for v, _, tn, off in cells(p, p.results)]
        lines.append("    " + head)
        lines += ["      " + ln for ln in body]
    lines += ["    }", "  }", "  __syncthreads();"]
    for k, p in enumerate(ph):
        lines += [f"  if (ph_en[{k}]) {{",
                  f"    const unsigned* const ph_it = ph_w + ph_pos[{k}];"]
        lines += [f"    {v} = phase_get_{tn}(ph_it + {off});"
                  for v, _, tn, off in cells(p, p.results)]
        lines.append("  }")
    # every lane has read its results before the block's next phase writes
    # its warps' counts, whose words may be this phase's result rows
    lines += ["  __syncthreads();", "}"]
    return lines


def _tn(t: str) -> str:
    """A value type's suffix in ``csrc/phase.cuh``'s item helpers."""
    return "f32" if t == RC.F32 else t_name(t)


def program_c(prog: RC.Program, name: str) -> str:
    """The device function template ``name<Acc>`` that runs ``prog`` on one
    slot: its parameters are the slot's planes ``f`` and extras ``x``, its
    ``alive`` flag, ``t`` and ``dt`` of the op's place, the iteration's hash
    seed ``h0``, the op's first draw index ``idx0``, the slot term ``lin``
    and the record accumulator ``acc`` that ``user_sum(acc, col, v)``
    adds to. Its loops and branched arms as :func:`_body_c` writes them."""

    def pinned(ins, cur):
        code, d, a, _, y, _ = ins
        va = cur.get(a)
        if code == RC.U_ST:
            return [f"{_plane(y)} = {va};"]
        if code == RC.U_ALIVE:
            return [f"alive = alive && {va} != 0.0f;",
                    "f[13] = alive ? 1.0f : 0.0f;"]
        if code == RC.U_ACC:
            return [f"user_sum(acc, {int(y)}, alive ? {va} : 0.0f);"]
        if code == RC.U_LD:
            return ("alive ? 1.0f : 0.0f" if y == RC.ALIVE_PLANE
                    else _plane(y)),
        if code == RC.U_T:
            return "t",
        if code == RC.U_DT:
            return "dt",
        if code == RC.U_UNIF:
            return f"unit24(hash_bits(h0, idx0 + {int(y) + 1}u, lin))",
        return None

    out = ["template <class Acc>",
           f"__device__ __forceinline__ void {name}({_ARGS}) {{"]
    out += _body_c(prog, _lit, pinned, phase=True)
    out.append("}")
    return "\n".join(out)


_VARS = ("a", "b", "c")


def _fk_body(prog: RC.Program, load, k0: int, phase=False):
    """The body of a program whose constants are read from ``plan.fk``
    from ``k0`` on (in ``ops/fields.py:field_layout`` order): its lines,
    one ``const`` local an instruction (``load(y)`` a load's expression;
    loops, their block phases with ``phase``, and branched arms as
    :func:`_body_c` writes them), and its outputs ``{j: local}``."""
    outs, k = {}, [k0]

    def lit(_, t=RC.F32):
        n = len(FL.fk_slots(0, t))
        k[0] += n
        if t == RC.F32:
            return f"plan.fk[{k[0] - 1}]"
        return f"fk_{t_name(t)}(plan.fk + {k[0] - n})"

    def pinned(ins, cur):
        code, _, a, _, y, _ = ins
        if code == RC.U_ST:
            outs[int(y)] = cur[a]
            return []
        if code == RC.U_LD:
            return load(y),
        return None

    lines = _body_c(prog, lit, pinned, phase)
    return lines, outs


def t_name(t: str) -> str:
    """A typed value's suffix in ``csrc/typed.cuh``'s helper names."""
    return {RC.I32: "i32", RC.I64: "i64", RC.F64: "f64"}[t]


def field_c(spec: dict, name: str, k0: int) -> str:
    """The device function ``name`` of an expression field (``ops/
    fields.py``): ``(plan, a, b, c) -> value``, or with three outputs
    ``(plan, a, b, c, out)`` filling ``out[0..2]``; variable ``i`` is
    argument ``i``. One ``const`` local an instruction, each the
    function the plain version (``ops/record.py:run_field``) matches; its
    constants are read from ``plan.fk`` at ``k0`` on, in the order of
    ``ops/fields.py:field_layout``."""
    n_out = spec["n_out"]
    sig = "const Plan& plan, float a, float b, float c"
    lines, outs = _fk_body(spec["prog"], lambda y: _VARS[y], k0)
    out = [f"__device__ __forceinline__ "
           f"{'float' if n_out == 1 else 'void'} {name}("
           f"{sig}{'' if n_out == 1 else ', float* out'}) {{", *lines]
    out += ([f"  return {outs[0]};"] if n_out == 1 else
            [f"  out[{j}] = {outs[j]};" for j in range(n_out)])
    out.append("}")
    return "\n".join(out)


def bin_form(op, k0: int, sm: int) -> str:
    """The ``BinForm`` (``csrc/binned.cuh``) of a binned reduce whose
    constants start at ``fk[k0]`` and whose search table sits at ``sm`` in
    the block's shared copy."""
    b = op.bins
    n_prog = len(F.bin_constants(op)) - ((1 << b.levels) - 1)
    return (f"BinForm<{len(b.edges)}, {int(b.underflow)}, "
            f"{int(b.overflow)}, {int(b.count)}, {k0}, {n_prog}, "
            f"{op.cols[1]}, {sm}>")


def binned_c(op, name: str, bform: str, k0: int) -> str:
    """The device function template ``name<Acc>`` of a binned reduce (a
    histogram tally, ``ops/fused.py:Bins``): ``(plan, f, x, alive, acc)``;
    its program's coordinate (and value) from the slot's planes, its
    constants read from ``plan.fk`` from ``k0`` on, handed to
    ``acc.binned<bform>``, which takes the bin index and the sum
    (``csrc/fused_transport.cu``: ``FormRec::binned``)."""
    def load(y):
        return "alive ? 1.0f : 0.0f" if y == RC.ALIVE_PLANE else _plane(y)

    lines, outs = _fk_body(op.prog, load, k0, phase=True)
    value = "1.0f" if op.bins.count else outs[1]
    return "\n".join([
        "template <class Acc>",
        f"__device__ __forceinline__ void {name}(const Plan& plan, "
        "const float* f, const float* x, bool alive, Acc& acc) {", *lines,
        f"  acc.template binned<{bform}>(alive, {outs[0]}, {value});",
        "}"])


# the ops that move a particle, which end a shared field read (codes of
# ops/fused.py:OP_CODES, csrc/plan.cuh: OpKind)
_K = F.OP_CODES
_MOVERS = {_K[k] for k in ("kin", "reflect", "periodic", "fresnel", "emit",
                           "custom", "reduce", "kstate")}
# the ops whose n(r) (Op::nf) is read at the particle's position
_N_READERS = {_K[k] for k in ("iso", "del", "hg", "rayl", "phase",
                              "compton", "pol", "polc")}
_USER = {_K[k] for k in ("custom", "reduce", "kstate")}
# OpForm's members in order (csrc/plan.cuh)
OP_FORM = ("kind", "flag", "capture", "roulette", "col0", "axis", "nf", "af",
           "fld", "icdf", "scale", "thermal", "n", "ax0", "n_ax", "draw0",
           "nf_shared")


def user_ops(plan) -> list:
    """``[(op index, op)]`` of the plan's user ops."""
    return [(i, op) for i, op in enumerate(plan.ops)
            if op.kind in F.USER_OPS]


def _struct(plan, ps):
    """The plan's ``PlanStruct`` (``ops/fused.py:_plan_struct``): the one
    given, or the CPU one."""
    if ps is not None:
        return ps
    import torch

    return F._plan_struct(plan, torch.device("cpu"))[0]


def draw_count(o) -> int:
    """Draws one op (an ``OpStruct``) makes per iteration, in the twin's
    order: iso a uniform and a pair; del one uniform (implicit capture:
    only with roulette; fluorescence: a uniform, a uniform and a pair); the
    hg, rayl and phase scatters a uniform and a pair; compton a uniform and
    an azimuth (thermal: then a pair and two uniforms) and a uniform and a
    pair per Kahn try; fresnel one; emit one for a sampled energy and one
    for an isotropic direction; pol two; polc two and the Kahn tries; a
    user op its program's draws."""
    k = o.kind
    if k == _K["iso"] or k in (_K["hg"], _K["rayl"], _K["phase"],
                               _K["pol"]):
        return 2
    if k == _K["del"]:
        if o.capture:
            return int(o.w_sur > 0.0)
        return 3 if o.flag == 2 else 1
    if k == _K["compton"]:
        return (5 if o.box[1] > 0.0 else 2) + 2 * o.emit_n
    if k == _K["polc"]:
        return 2 + 2 * o.emit_n
    if k == _K["fresnel"]:
        return 1
    if k == _K["emit"]:
        return int(o.icdf >= 0) + int(o.flag != 0)
    if k in _USER:
        return o.emit_row
    return 0


def draw_counts(plan, ps=None) -> list:
    """Each op's draws per iteration (:func:`draw_count`)."""
    ps = _struct(plan, ps)
    return [draw_count(ps.ops[i]) for i in range(ps.n_ops)]


def plan_in_buffer(plan, ps=None) -> bool:
    """Whether the plan's form kernel takes its ``Plan`` from a device
    buffer: where the Plan is past the parameter room
    (:data:`PLAN_PARAM_BYTES`), or the plan asks for it
    (``FusedPlan.plan_buffer``)."""
    return bool(plan.plan_buffer) or \
        ctypes.sizeof(_struct(plan, ps)) > PLAN_PARAM_BYTES


def plan_form(plan, ps=None) -> dict:
    """The plan's form: ``ops`` (one ``OpForm`` tuple per op, members as
    :data:`OP_FORM`), ``axes`` (``(axis, ecol, ecap)`` per crossing
    plane), ``fields`` (``(kind, interp, axis, shape)`` per field),
    ``fk`` (each field's first constant in ``Plan::fk``, and their
    number last), the binned reduces (``bins``: ``{op index: (BinForm,
    first constant in fk)}``; ``kBinTab``, ``kBinEdges``, ``kBinRow``:
    their search tables and shared memory), ``kNK`` (every constant in
    ``fk``), ``dims`` (the
    Plan's table sizes) and the plan-level constants, read from its
    ``PlanStruct`` (``ps``, or the CPU one), so that the form and the
    launch's ``form_matches`` agree by construction."""
    ps = _struct(plan, ps)
    n_fields = len(F._field_index(plan.ops)[0])
    ops, draw, last_read = [], 0, {}
    qm = -1
    for i in range(ps.n_ops):
        o = ps.ops[i]
        k = o.kind
        shared = 0
        if k in _N_READERS and o.nf >= 0:
            shared = int(last_read.get(o.nf, False))
            last_read[o.nf] = True
        if k in _MOVERS:
            last_read = {}
        if k == _K["lorentz"]:
            col0 = o.col0
            if o.col0 >= 0:
                qm = o.col0
        else:
            col0 = int(o.col0 >= 0)
        ops.append((
            k, o.flag, o.capture,
            int(k == _K["del"] and o.w_sur > 0.0), col0,
            o.col1 if k == _K["fresnel"] else 0, o.nf, o.af,
            tuple(o.fld), int(k == _K["emit"] and o.icdf >= 0),
            int(k == _K["emit"] and o.emit_scale != 1.0),
            int(k == _K["compton"] and o.box[1] > 0.0),
            (o.emit_n if k in (_K["compton"], _K["polc"])
             else o.emit_row if k in _USER else 0),
            o.ax0 if k == _K["cross"] else 0,
            o.n_ax if k == _K["cross"] else 0, draw, shared))
        draw += draw_count(o)
    n_ax = sum(op[OP_FORM.index("n_ax")] for op in ops)
    axes = [(ps.axes[a].axis, int(ps.axes[a].ecol >= 0),
             int(ps.axes[a].ecap >= 0)) for a in range(n_ax)]
    fields, fk = [], [0]
    for i in range(n_fields):
        fd = ps.fields[i]
        expr = fd.kind == 1
        fields.append((fd.kind, fd.interp if fd.kind == 3 else 0,
                       fd.axis if fd.kind == 2 else 0,
                       fd.shape if expr else 0))
        fk.append(fk[-1] + (fd.len if expr else 0))
    # the binned reduces: their BinForm and first constant in fk, their
    # search tables' (place in fk, length, place in the block's shared
    # copy), and the shared copy's size
    bins, tabs, n_k = {}, [], fk[-1]
    for i, k0 in F.bin_offsets(plan.ops, fk[-1]).items():
        op = plan.ops[i]
        n_tab, sm = (1 << op.bins.levels) - 1, sum(t[1] for t in tabs)
        bins[i] = (bin_form(op, k0, sm), k0)
        n_k = k0 + len(F.bin_constants(op))
        tabs.append((n_k - n_tab, n_tab, sm))
    edges, row = F.bin_smem_floats(plan.ops)
    return {"ops": ops, "axes": axes, "fields": fields, "fk": fk,
            "kNK": n_k, "bins": bins, "kBinTab": tabs, "kBinEdges": edges,
            "kBinRow": row,
            "dims": type(ps).dims, "kPlanInBuffer": int(plan_in_buffer(
                plan, ps)),
            "kCols": ps.n_cols, "kFcols": ps.n_fcols,
            "kConstNorm": ps.const_norm, "kStream": int(ps.n_stream > 0),
            "kStreamBf16": ps.stream_bf16, "kExtras": ps.n_extras,
            "kOtype": ps.otype_x, "kQm": qm, "kWb": ps.wb_mask,
            "kUwb": ps.uwb_mask}


def plan_label(plan) -> str:
    """How a build names the plan: its ops."""
    return "[" + ",".join(op.kind for op in plan.ops) + "]"


def _op_c(op: tuple) -> str:
    vals = []
    for name, v in zip(OP_FORM, op):
        vals.append("{" + ", ".join(str(x) for x in v) + "}"
                    if name == "fld" else str(v))
    return "{" + ", ".join(vals) + "}"


def expr_fields(plan) -> list:
    """``[(field index, spec)]`` of the plan's expression fields."""
    specs = F._field_index(plan.ops)[0]
    return [(j, sp) for j, sp in enumerate(specs) if sp["kind"] == "expr"]


def form_struct(plan, ps=None, form=None, bodies=True) -> str:
    """``struct Form``: the plan's form (:func:`plan_form`) as the
    ``constexpr`` tables and constants that ``csrc/fused_transport.cu``'s
    form kernel and ``csrc/plan.cuh``'s ``form_matches`` read, and (with
    ``bodies``) each user op's program as ``Form::user`` and each
    expression field's function as ``Form::field``."""
    form = form or plan_form(plan, ps)
    kinds = [op.kind for op in plan.ops]
    n_ax, n_fld = len(form["axes"]), len(form["fields"])
    parts = ["struct Form {", f"  static constexpr int kN = {len(kinds)};",
             "  // " + ", ".join(OP_FORM),
             "  static constexpr OpForm kOp[kN] = {"]
    parts += [f"      {_op_c(op)},  // {i}: {kinds[i]}"
              for i, op in enumerate(form["ops"])]
    parts += ["  };", f"  static constexpr int kNAx = {n_ax};",
              f"  static constexpr AxisForm kAx[{max(1, n_ax)}] = {{"
              + ", ".join("{" + ", ".join(map(str, a)) + "}"
                          for a in form["axes"] or [(0, 0, 0)]) + "};",
              f"  static constexpr int kNFld = {n_fld};",
              f"  static constexpr FieldForm kFld[{max(1, n_fld)}] = {{"
              + ", ".join("{" + ", ".join(map(str, f)) + "}"
                          for f in form["fields"] or [(0, 0, 0, 0)]) + "};",
              "  // each field's first constant in Plan::fk, then their "
              "number",
              f"  static constexpr int kFk[{n_fld + 1}] = {{"
              + ", ".join(map(str, form["fk"])) + "};",
              "  // the binned reduces' search tables: place in fk, length, "
              "place in bin_smem",
              f"  static constexpr int kNBinTab = {len(form['kBinTab'])};",
              f"  static constexpr BinTab kBinTab[{max(1, len(form['kBinTab']))}]"
              " = {" + ", ".join("{" + ", ".join(map(str, t)) + "}"
                                 for t in form["kBinTab"] or [(0, 0, 0)])
              + "};"]
    parts += [f"  static constexpr int {name} = {form[name]};"
              for name in ("kNK", "kBinEdges", "kBinRow", "kCols", "kFcols",
                           "kConstNorm", "kStream", "kStreamBf16", "kExtras",
                           "kOtype", "kQm", "kWb", "kUwb", "kPlanInBuffer")]
    words = F.phase_smem_bytes(plan.ops) // 4
    if words:
        # the user programs' block phases' shared words (csrc/phase.cuh);
        # a form with no loop has no such member
        parts.append(f"  static constexpr int kPhaseWords = {words};")
    for j, sp in (expr_fields(plan) if bodies else ()):
        one = sp["n_out"] == 1
        parts += [
            f"  static __device__ __forceinline__ "
            f"{'float' if one else 'void'} field(",
            f"      std::integral_constant<int, {j}>, const Plan& plan, "
            "float a, float b,",
            f"      float c{'' if one else ', float* out'}) {{",
            f"    {'return ' if one else ''}field_{j}(plan, a, b, c"
            f"{'' if one else ', out'});", "  }"]
    binned = form["bins"]
    for i, _ in (user_ops(plan) if bodies else ()):
        args = _ARGS.replace("Acc", "R")
        parts += [
            "  template <class R>",
            "  static __device__ __forceinline__ void user(",
            f"      std::integral_constant<int, {i}>, const Plan& plan, "
            f"{args}) {{",
            f"    binned_op_{i}(plan, f, x, alive, acc);" if i in binned
            else f"    user_op_{i}(f, x, alive, t, dt, h0, idx0, lin, acc);",
            "  }"]
    parts.append("};")
    return "\n".join(parts)


def form_source(plan, ps=None) -> str:
    """The translation unit of the plan's form library (``ps``: its
    ``PlanStruct``, or the CPU one): ``struct Form`` and its user
    programs, compiled with ``fused_transport.cu``, and the library's
    ``fused_transport_grid`` and ``fused_transport_launch`` for that form
    alone. Depends only on the form, so plans that differ in numbers share
    it."""
    if plan.kernel_seq is not None:
        raise ValueError("a plan of the main path's op-sequence form runs "
                         "the main library")
    form = plan_form(plan, ps)
    parts = [
        "// Generated by physicl_tpu_torch/ops/codegen.py: the form library "
        "of a plan",
        f"// {plan_label(plan)}, compiled with fused_transport.cu.",
        "#define PHYSICL_FORM 1",
        "// the Plan's tables: ops, crossing planes, fields, constants",
        "#define PHYSICL_PLAN_DIMS " + ", ".join(map(str, form["dims"])),
        '#include "fused_transport.cu"', "", "namespace {", ""]
    for j, sp in expr_fields(plan):
        parts.append(f"// field {j}: {len(sp['prog'].ins)} instructions, "
                     f"{sp['n_out']} output(s)")
        parts += [field_c(sp, f"field_{j}", form["fk"][j]), ""]
    binned = form["bins"]
    for i, op in user_ops(plan):
        if i in binned:
            b = op.bins
            parts.append(
                f"// op {i}: reduce, binned: {b.n_cols} float columns from "
                f"{op.cols[1]} ({len(b.edges) - 1} bins"
                + (", underflow" if b.underflow else "")
                + (", overflow" if b.overflow else "")
                + f"), {'a count' if b.count else 'a value'}; "
                f"{len(op.prog.ins)} instructions")
            parts += [binned_c(op, f"binned_op_{i}", *binned[i]), ""]
            continue
        parts.append(f"// op {i}: {op.kind}, {len(op.prog.ins)} "
                     f"instructions, {op.prog.n_draws} draws")
        parts += [program_c(op.prog, f"user_op_{i}"), ""]
    parts += form_struct(plan, ps, form).splitlines()
    parts += ["", "}  // namespace", "",
              'extern "C" int fused_transport_grid(long long capacity, '
              "int k_act, int n_cols,",
              "                                    int n_fcols, int variant, "
              "int* grid_out) {",
              "  return form_grid<Form>(capacity, k_act, n_cols, n_fcols, "
              "variant, grid_out);", "}", "",
              'extern "C" int fused_transport_launch(',
              "    const void* packed_in, void* packed_out, long long "
              "capacity,",
              "    const void* sched, int sched_stride, const void* thr,",
              "    const void* emit_starts, int emit_stride, const void* aux, "
              "int k_act,",
              "    unsigned int seed, const Plan* plan, const void* plan_dev,",
              "    int variant, int grid, void* rec, void* rec_f, void* "
              "partials,",
              "    void* stream_buf, int n_srows, int stream_elem, void* "
              "stream) {",
              "  return form_launch<Form>(packed_in, packed_out, capacity, "
              "sched, sched_stride,",
              "                           thr, emit_starts, emit_stride, aux, "
              "k_act, seed, plan,",
              "                           plan_dev, variant, grid, rec, "
              "rec_f, partials,",
              "                           stream_buf, n_srows, stream_elem, "
              "stream);",
              "}", ""]
    return "\n".join(parts)
