"""Kernel 1i's code generator: a plan's recorded user programs
(:mod:`physicl_tpu_torch.ops.record`) as straight-line CUDA C, compiled
with ``csrc/fused_transport.cu`` into a library of the plan's own
(``ops/fused.py:_library`` builds it through
:func:`physicl_tpu_torch.ops._build.load_plan`).

Counterpart of the JAX package's tracing of each user callable into its
fused kernel (``physicl_tpu/ops/fused.py:1448-1569``): the port records the
torch callable at plan time and compiles the recording per plan.

Each program becomes one device function over a slot's planes:

* one ``const float`` local per instruction, an SSA value, so that the
  compiler keeps the program's values in the SM's registers;
* plane loads and stores at constant indices of ``f[]`` (the 15 core
  planes; plane 13 reads the ``alive`` flag) and ``x[]`` (the extras), in
  program order, so a load after a store reads the new value;
* draw ``i`` as ``unit24(hash_bits(h0, idx0 + i + 1, lin))``;
* an alive clear updating ``alive`` and ``f[13]``; a record sum through
  ``user_sum`` (alive-masked; skipped where no lane of the warp adds
  anything but 0);
* every operation the function the plain version
  (:func:`~physicl_tpu_torch.ops.record.run_user_program`) matches:
  ``expf``, ``logf``, ``powf``, ``ipow``, ``nan_min``, ... Built with
  ``--fmad=false``, the planes stay bitwise equal to it.

The translation unit defines ``PHYSICL_USER_PLAN`` (the plan's kernel
variant), includes ``fused_transport.cu``, which then instantiates that
variant alone, and defines ``user_op`` (case ``o`` runs op ``o``'s program)
and ``fused_user_probe`` (the programs alone in an iteration loop, never
launched, whose SASS ``scripts/sass_loop.py`` counts). The source depends
only on the plan's op kinds, its user ops' programs and its variant, so
plans that share them share a library.
"""

from __future__ import annotations

import math

import numpy as np

from physicl_tpu_torch.ops import record as RC

_NF = 15          # core planes: f[0..14]
_MAX_EXTRAS = 8   # extras planes: x[0..7] (csrc/fused_transport.cu)
_ARGS = ("float* f, float* x, bool& alive, float t, float dt, uint32_t h0, "
         "uint32_t idx0, uint32_t lin, float* frow")

_UNARY = {RC.U_NEG: "-{a}", RC.U_ABS: "fabsf({a})", RC.U_SQRT: "sqrtf({a})",
          RC.U_EXP: "expf({a})", RC.U_LOG: "logf({a})",
          RC.U_LOG10: "log10f({a})", RC.U_SIN: "sinf({a})",
          RC.U_COS: "cosf({a})", RC.U_TAN: "tanf({a})",
          RC.U_FLOOR: "floorf({a})", RC.U_CEIL: "ceilf({a})",
          RC.U_TRUNC: "truncf({a})", RC.U_RECIP: "1.0f / {a}",
          RC.U_NOT: "{a} == 0.0f ? 1.0f : 0.0f",
          RC.U_BOOL: "{a} != 0.0f ? 1.0f : 0.0f"}
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
           RC.U_XOR: "({a} != 0.0f) != ({b} != 0.0f) ? 1.0f : 0.0f"}


def _lit(y) -> str:
    """A float32 constant as C: an exact hexadecimal literal, or its bits
    where it is not finite."""
    v = float(np.float32(y))
    if math.isfinite(v):
        text = f"{v.hex()}f"
        return f"({text})" if math.copysign(1.0, v) < 0 else text
    return f"__int_as_float({RC._bits(v) & 0xFFFFFFFF:#010x})"


def _plane(p: int) -> str:
    if 0 <= p < _NF:
        return f"f[{p}]"
    if _NF <= p < _NF + _MAX_EXTRAS:
        return f"x[{p - _NF}]"
    raise ValueError(f"a user program names plane {p}")


def program_c(prog: RC.Program, name: str) -> str:
    """The device function ``name`` that runs ``prog`` on one slot: its
    parameters are the slot's planes ``f`` and extras ``x``, its ``alive``
    flag, ``t`` and ``dt`` of the op's place, the iteration's hash seed
    ``h0``, the op's first draw index ``idx0``, the slot term ``lin`` and
    the warp's float record row ``frow``."""
    out = [f"__device__ __forceinline__ void {name}({_ARGS}) {{"]
    cur = {}  # register -> the local that holds its value
    for i, (code, d, a, b, y, bimm) in enumerate(prog.ins):
        va = cur.get(a)
        if code == RC.U_ST:
            out.append(f"  {_plane(y)} = {va};")
            continue
        if code == RC.U_ALIVE:
            out.append(f"  alive = alive && {va} != 0.0f;")
            out.append("  f[13] = alive ? 1.0f : 0.0f;")
            continue
        if code == RC.U_ACC:
            out.append(f"  user_sum(frow, {int(y)}, alive ? {va} : 0.0f);")
            continue
        if code == RC.U_LD:
            expr = ("alive ? 1.0f : 0.0f" if y == RC.ALIVE_PLANE
                    else _plane(y))
        elif code == RC.U_T:
            expr = "t"
        elif code == RC.U_DT:
            expr = "dt"
        elif code == RC.U_CONST:
            expr = _lit(y)
        elif code == RC.U_UNIF:
            expr = f"unit24(hash_bits(h0, idx0 + {int(y) + 1}u, lin))"
        elif code == RC.U_IPOW:
            expr = f"ipow({va}, {int(y)})"
        elif code == RC.U_SEL:
            # (cond, false register, true register in y), or with a
            # constant false value (cond, true register, the immediate)
            if bimm:
                expr = f"{va} != 0.0f ? {cur[b]} : {_lit(y)}"
            else:
                expr = f"{va} != 0.0f ? {cur[y]} : {cur[b]}"
        elif code in _UNARY:
            expr = _UNARY[code].format(a=va)
        elif code in _BINARY:
            expr = _BINARY[code].format(a=va,
                                        b=_lit(y) if bimm else cur[b])
        else:
            raise ValueError(f"user program code {code}")
        out.append(f"  const float v{i} = {expr};")
        cur[d] = f"v{i}"
    out.append("}")
    return "\n".join(out)


def user_ops(plan) -> list:
    """``[(op index, op)]`` of the plan's user ops."""
    from physicl_tpu_torch.ops import fused as F

    return [(i, op) for i, op in enumerate(plan.ops)
            if op.kind in F.USER_OPS]


def plan_label(plan) -> str:
    """How a build names the plan: its ops and variant."""
    kinds = ",".join(op.kind for op in plan.ops)
    return f"[{kinds}] variant {plan.kernel_variant}"


def plan_source(plan) -> str:
    """The translation unit of ``plan``'s library (a plan with user ops)."""
    ops = user_ops(plan)
    if not ops:
        raise ValueError("a plan without user ops runs the main library")
    variant = plan.kernel_variant
    parts = [
        "// Generated by physicl_tpu_torch/ops/codegen.py: kernel 1i's user "
        "programs of one",
        f"// plan, {plan_label(plan)}, compiled with fused_transport.cu.",
        f"#define PHYSICL_USER_PLAN {variant}",
        '#include "fused_transport.cu"', "", "namespace {", ""]
    for i, op in ops:
        parts.append(f"// op {i}: {op.kind}, {len(op.prog.ins)} "
                     f"instructions, {op.prog.n_draws} draws")
        parts += [program_c(op.prog, f"user_op_{i}"), ""]
    call = "(f, x, alive, t, dt, h0, idx0, lin, frow)"
    parts.append(f"__device__ __forceinline__ void user_op(int o, {_ARGS}) "
                 "{")
    parts.append("  switch (o) {")
    parts += [f"    case {i}: user_op_{i}{call}; break;" for i, _ in ops]
    parts += ["    default: break;", "  }", "}", "", "}  // namespace", ""]
    # the probe: the programs in plan order, each at its draw offset among
    # the user ops (the kernel's other ops draw between them; the offset
    # changes no instruction)
    body, idx0 = [], 0
    for i, op in ops:
        row = 1 if op.after_update else 2
        body.append(f"    user_op_{i}(f, x, alive, sched[{row} * k_act + k], "
                    f"sched[{row + 2} * k_act + k], h0, {idx0}u, lin, frow);")
        idx0 += op.prog.n_draws
    parts += [
        "// The plan's user programs alone, k_act iterations over one slot a",
        "// thread: scripts/sass_loop.py counts the instructions of its loop",
        "// (the programs' own per photon-iteration). Never launched.",
        "__global__ void __launch_bounds__(kBlock)",
        "fused_user_probe(float* planes, long long C, const float* sched, "
        "int k_act,",
        "                 uint32_t seed, float* frow) {",
        "  const long long g = (long long)blockIdx.x * blockDim.x + "
        "threadIdx.x;",
        "  float f[kNF], x[kMaxExtras];",
        "#pragma unroll",
        "  for (int p = 0; p < kNF; ++p) f[p] = planes[p * C + g];",
        "#pragma unroll",
        "  for (int p = 0; p < kMaxExtras; ++p) x[p] = planes[(kNF + p) * C "
        "+ g];",
        "  const uint32_t lin = physicl::slot_term(g);",
        "  bool alive = f[13] > 0.0f;",
        "#pragma unroll 1",
        "  for (int k = 0; k < k_act; ++k) {",
        "    // the planes opaque to the compiler at every iteration's start "
        "(no",
        "    // instruction), so that no program's work leaves the loop",
        "#pragma unroll",
        '    for (int p = 0; p < kNF; ++p) asm volatile("" : "+f"(f[p]));',
        "#pragma unroll",
        "    for (int p = 0; p < kMaxExtras; ++p) "
        'asm volatile("" : "+f"(x[p]));',
        "    const uint32_t h0 = seed ^ ((uint32_t)k * 0x9E3779B9u);",
        *body,
        "  }",
        "#pragma unroll",
        "  for (int p = 0; p < kNF; ++p) planes[p * C + g] = f[p];",
        "#pragma unroll",
        "  for (int p = 0; p < kMaxExtras; ++p) planes[(kNF + p) * C + g] = "
        "x[p];",
        "}", ""]
    return "\n".join(parts)

