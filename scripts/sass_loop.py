#!/usr/bin/env python3
"""Count the instructions of ``fused_transport``'s iteration loop in its SASS.

On a machine with the CUDA toolkit (the kernels build at first use)::

    python3 scripts/sass_loop.py 64 65          # the op-sequence variants
    python3 scripts/sass_loop.py --dump DIR 64  # also write each one's SASS
    python3 scripts/sass_loop.py --lib _build/libfused_plan_KEY.so --ballots 5

or on a SASS listing made elsewhere (``cuobjdump -sass lib.so``)::

    python3 scripts/sass_loop.py --sass FILE 64 --ranges f80-fc0*3,1020-1060

or, for a generated form source (``ops/codegen.py:form_source``, also
written beside its library as ``_build/fused_plan_<key>.cu``), its loop's
instructions by the generated line each came from (``attribute``: the libm
calls, the fused multiply-adds, the programs' other instructions, the
kernel's own code; compiled again with ``-lineinfo``)::

    python3 scripts/sass_loop.py --attribute _build/fused_plan_KEY.cu --ballots 5

``--lib`` with no variant counts a form library's ``fused_form_kernel``
(every plan outside the main path's op-sequence form runs one, generated
per plan form by ``physicl_tpu_torch/ops/codegen.py``): its iteration loop
is the smallest loop (a backward branch and its target) that holds every
warp vote of the function; ``--ballots`` gives the form's votes per
iteration (the alive count and its other count sites,
``chip_smoke.form_ballots``), so that ``iterations`` is the number of
iterations the loop's body holds and ``per_iteration`` its fast path over
them. ``ldg`` counts the global loads in the loop (a trilinear field read
is eight, the dt one).

The iteration loop of an op-sequence instantiation is the loop without
inner loops that holds the most warp votes: its body is straight-line code
for ``iterations`` iterations (the unrolled body; four ballots an
iteration, the sign's), and ``window`` counts the instructions of the
enclosing 32-iteration window loop outside it (the count flush, and the
remainder iterations of a window that is not a multiple of the
unrolling). ``static`` counts every instruction of a loop;
``fast_path`` leaves out the blocks around the out-of-line calls of
correctly rounded square roots and divides (their slow paths, for
arguments out of the fast path's range), and ``per_iteration`` is
``fast_path / iterations``; ``--ranges`` counts only the given address
ranges (hex, end inclusive, ``*n`` for a range run n times), as when an
executed path is traced by hand. Classes are by opcode (``CLASSES``), but
for the counter hash's own instructions (``_HASH``). Prints one JSON
object per kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# the counter hash's instructions: the murmur3 and draw-index multipliers,
# the finalizer's shifts by 16 and 13, two- and three-way XORs
_HASH = re.compile(r"^(IMAD|VIADD|IADD3)\b.*(-0x7a143595|-0x3d4d51cb|0x7feb352d|"
                   r"0xffd66a5a)|^SHF\.R\.U32\.HI R\d+, RZ, 0x(10|d),|"
                   r"^LOP3\.LUT .*, 0x(3c|96), !PT$")

# opcode classes, first match wins ("hash" by _HASH before them)
CLASSES = (
    ("record", ("VOTE", "VOTEU", "POPC", "UPOPC", "UFLO", "ATOMS", "RED",
                "ATOM", "SHFL", "S2R")),
    ("conversion", ("I2F", "I2FP", "F2I", "F2F", "F2FP", "I2I", "FRND")),
    ("mufu", ("MUFU",)),
    ("call", ("CALL", "RET")),
    ("control", ("BRA", "BRX", "BSSY", "BSYNC", "EXIT", "WARPSYNC", "BAR",
                 "NOP", "YIELD")),
    ("memory", ("LDG", "STG", "LDC", "LDS", "STS", "LD", "ST", "LDL",
                "STL")),
    ("uniform", ("U", "S2UR", "R2UR")),
    ("float", ("F", "H")),
    ("predicate", ("PLOP3", "P2R", "R2P")),
    ("integer", ("",)),
)

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"^(?:@!?U?P\w+\s+)?BRA(?:\.\w+)*\s+(?:`\(\S+\)\s*)?0x"
                  r"([0-9a-f]+)")


def opcode(text: str) -> str:
    """The opcode of one instruction, without its predicate and modifiers."""
    words = text.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def op_class(text: str) -> str:
    if _HASH.search(text.split(None, 1)[1] if text.startswith("@")
                    else text):
        return "hash"
    op = opcode(text)
    for name, prefixes in CLASSES:
        for pre in prefixes:
            if (op == pre if name not in ("uniform", "float", "integer")
                    else op.startswith(pre)):
                return name
    return "integer"


def functions(sass: str) -> dict:
    """``{mangled name: [(address, instruction), ...]}`` of a cuobjdump
    listing."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = [(int(a, 16), t) for a, t in _INS.findall(body)]
    return out


def mangled_pattern(variant: int) -> str:
    """A substring of the mangled name of op-sequence variant's kernel (64
    or 65): its op codes (physicl_tpu_torch/ops/fused.py:OP_CODES)."""
    from physicl_tpu_torch.ops import fused as F

    seq = {v: k for k, v in F.SEQ_VARIANTS.items()}[variant]
    return ("fused_seq_kernel", "".join(f"Li{F.OP_CODES[k]}E" for k in seq))


def function_for(funcs: dict, variant: int):
    kernel, args = mangled_pattern(variant)
    for name, ins in funcs.items():
        if kernel in name and args in name:
            return name, ins
    raise KeyError(f"no SASS function for variant {variant}")


def loops(ins):
    """``[(start index, end index)]`` of every backward branch."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    out = []
    for i, (_, text) in enumerate(ins):
        m = _BRA.match(text)
        if m and int(m.group(1), 16) in index and index[
                int(m.group(1), 16)] <= i:
            out.append((index[int(m.group(1), 16)], i))
    return out


def iteration_loop(ins, innermost=False):
    """(start, end) of the smallest loop holding every warp vote (where the
    compiler peeled a copy of it, the smallest of those holding the most
    votes; or, with ``innermost``, of the loop without inner loops that
    holds the most votes: the unrolled body, not its remainder), and of the
    smallest loop around that one (None if there is none)."""
    votes = [i for i, (_, t) in enumerate(ins) if opcode(t) == "VOTE"]
    if not votes:
        raise ValueError("no warp vote: not a fused_transport kernel")
    every = loops(ins)
    if innermost:
        leaves = [lp for lp in every
                  if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                             for o in every)]
        inside = [lp for lp in leaves
                  if any(lp[0] <= v <= lp[1] for v in votes)]
    else:
        inside = [lp for lp in every
                  if lp[0] <= min(votes) and max(votes) <= lp[1]]
        if not inside:
            # the compiler peeled a copy of the loop (the block's first
            # tile): the smallest of the loops that hold the most votes
            inside = every
    if not inside:
        raise ValueError("no loop holds the warp votes")
    n_votes = {lp: sum(lp[0] <= v <= lp[1] for v in votes) for lp in inside}
    if innermost:
        body = max(inside, key=n_votes.get)
    else:
        most = max(n_votes.values())
        body = min((lp for lp in inside if n_votes[lp] == most),
                   key=lambda lp: lp[1] - lp[0])
    outer = [lp for lp in loops(ins) if lp[0] <= body[0] and body[1] <= lp[1]
             and lp != body]
    return body, (min(outer, key=lambda lp: lp[1] - lp[0]) if outer else None)


def slow_blocks(ins, lo, hi):
    """Indices in [lo, hi] of the blocks around each out-of-line call: from
    the predicated branch that skips it to that branch's target (the
    structured layout, ``BSSY`` / ``BSYNC``), or else from the branch before
    it to the unconditional branch after it."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    skip = set()
    for i in range(lo, hi + 1):
        if opcode(ins[i][1]) != "CALL":
            continue
        a = i
        while a > lo and opcode(ins[a - 1][1]) != "BRA":
            a -= 1
        m = _BRA.match(ins[a - 1][1]) if a > lo else None
        target = index.get(int(m.group(1), 16)) if m else None
        if (m and ins[a - 1][1].startswith("@") and target is not None
                and i < target <= hi):
            skip.update(range(a, target))
            continue
        b = i
        while b < hi and not (opcode(ins[b][1]) == "BRA"
                              and not ins[b][1].startswith("@")):
            b += 1
        skip.update(range(a, b + 1))
    return skip


def count(ins, idx) -> dict:
    out = {}
    for i in idx:
        c = op_class(ins[i][1])
        out[c] = out.get(c, 0) + 1
    return dict(sorted(out.items()))


def summary(ins, ranges=None, ballots=None, innermost=False) -> dict:
    """The loop's counts (``static``, ``fast_path``, ``per_iteration``, its
    global loads and the fast path's classes, the window loop's own
    instructions), or the counts over ``ranges`` [(start address, end
    address, times)]. ``ballots``: the warp votes per iteration, which
    give the iterations the loop holds; ``innermost`` (the op-sequence
    instantiations): the iteration loop is the innermost one with a
    vote."""
    if ranges:
        idx = [i for lo, hi, n in ranges for _ in range(n)
               for i, (a, _) in enumerate(ins) if lo <= a <= hi]
        return {"ranges": [f"{lo:x}-{hi:x}*{n}" for lo, hi, n in ranges],
                "executed": len(idx), "classes": count(ins, idx)}
    (lo, hi), outer = iteration_loop(ins, innermost=innermost)
    slow = slow_blocks(ins, lo, hi)
    fast = [i for i in range(lo, hi + 1) if i not in slow]
    n_iter = 1
    if ballots:
        n_iter = max(1, sum(1 for i in range(lo, hi + 1)
                            if opcode(ins[i][1]) == "VOTE") // ballots)
    out = {"loop": [f"{ins[lo][0]:x}", f"{ins[hi][0]:x}"],
           "iterations": n_iter, "static": hi - lo + 1,
           "fast_path": len(fast), "per_iteration": len(fast) / n_iter,
           "ldg": sum(1 for i in range(lo, hi + 1)
                      if opcode(ins[i][1]) == "LDG"),
           "classes": count(ins, fast)}
    if innermost and outer is not None:
        out["window"] = sum(1 for i in range(outer[0], outer[1] + 1)
                            if not lo <= i <= hi)
    return out


def variant_summary(funcs: dict, variant: int, ranges=None) -> dict:
    """summary() of op-sequence ``variant``'s kernel in the listing
    ``funcs``."""
    name, ins = function_for(funcs, variant)
    return {"variant": variant, "function": name,
            **summary(ins, ranges, 4, innermost=True)}


def form_summary(funcs: dict, ballots: int = 1, ranges=None) -> dict:
    """summary() of a form library's ``fused_form_kernel``, with
    ``ballots`` warp votes per iteration."""
    name, ins = next((n, i) for n, i in funcs.items()
                     if "fused_form_kernel" in n)
    return {"function": name, **summary(ins, ranges, ballots)}


# a line-information comment of nvdisasm (-g, -gi): each "file", line pair,
# the innermost first and then the sites it was inlined at
_LOC = re.compile(r'"([^"]+)", line (\d+)')
_LIBM = re.compile(r"\b([a-z][a-z0-9]*f)\(")
_TEXT = re.compile(r"^\s*\.text\.(\S+):\s*$")
_LABEL = re.compile(r"^\s*(\.L\w+):")
_TARGET = re.compile(r"`\((\.L\w+)\)")


def lined_functions(listing: str) -> dict:
    """``{name: [(address, instruction, [(file, line), ...]), ...]}`` of an
    ``nvdisasm -g -gi`` listing: each instruction with the source location
    of the ``//##`` comment before it (innermost first, then the sites it
    was inlined at), a branch to a label rewritten to the label's address
    (as ``cuobjdump -sass`` prints it)."""
    out, cur, loc, labels, pending = {}, None, [], {}, []
    fresh = []  # the comments since the last instruction
    for line in listing.splitlines():
        m = _TEXT.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            loc, fresh = [], []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        if "//##" in line:
            # an inlined location is listed with its chain, then its
            # outer sites alone: the longest chain is the instruction's
            fresh.append([(f, int(n)) for f, n in _LOC.findall(line)])
        m = _INS.search(line.split("//##")[0])
        if m and cur is not None:
            if fresh:
                loc, fresh = max(fresh, key=len), []
            addr = int(m.group(1), 16)
            labels.update((lb, addr) for lb in pending)
            pending = []
            cur.append((addr, m.group(2).strip(), loc))
    for ins in out.values():
        ins[:] = [(a, _TARGET.sub(lambda m: f"0x{labels.get(m.group(1), 0):x}",
                                  t), lc) for a, t, lc in ins]
    return out


def source_kind(text: str) -> str:
    """What one line of a generated form source computes: ``libm:<name>``
    (a CUDA libm call), ``fma`` (a fused multiply-add), ``loop`` (a bounded
    loop's head or exit), ``phase`` (a block phase's own: its items placed,
    written and read, its barriers and item loop,
    ``ops/codegen.py:_phase_c``), ``branch`` (a branched arm's ``if`` /
    ``else``), ``move`` (a branched select's result or a loop's update),
    ``program`` (another instruction of a program)."""
    t = text.strip()
    if "ph_" in t or "phase_" in t or t == "__syncthreads();":
        return "phase"
    if t.startswith("for (int it") or t.endswith("break;") or re.match(
            r"^const \w+(?: \w+)? n\d+_\d+ = ", t):
        return "loop"
    if t.startswith(("if (", "} else", "}")) or re.match(
            r"^(float|int|long long|double) v\d+;$", t):
        return "branch"
    if re.match(r"^v\d+ = ", t):
        return "move"
    if "__fmaf_rn(" in t:
        return "fma"
    calls = [c for c in _LIBM.findall(t) if c not in (
        "__int_as_float", "unit24", "nan_min", "nan_max", "hash_bits")]
    if calls:
        return "libm:" + calls[0]
    return "program"


def lined_listing(source: str, csrc=None) -> str:
    """``nvdisasm -g -gi`` of a generated form source (``source``, a .cu
    file) compiled to a cubin with the build's flags and ``-lineinfo``
    (``csrc``: the directory of the sources it includes, the package's
    ``csrc/`` by default)."""
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from physicl_tpu_torch.ops import _build

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "form.cubin")
        subprocess.run([os.path.join(cuda, "bin", "nvcc"), *flags, "-cubin",
                        "-lineinfo", "-I", csrc or _build._CSRC, "-o", cubin,
                        source], check=True, capture_output=True, text=True)
        return subprocess.run(
            [os.path.join(cuda, "bin", "nvdisasm"), "-g", "-gi", cubin],
            check=True, capture_output=True, text=True).stdout


def attribute(source: str, ballots: int = 1, listing=None) -> dict:
    """The SASS of a form's iteration loop attributed to its generated
    source (``ops/codegen.py:form_source``, the file ``source``), from
    ``listing`` (``lined_listing``'s, made now where None): each
    fast-path instruction of ``fused_form_kernel``'s iteration loop goes to
    the generated line it was inlined from (``source_kind``: the libm calls
    by name, the fused multiply-adds, the programs' other instructions, the
    branched arms' and loops' own), or to ``kernel`` (``csrc/``'s code).
    ``by_op`` splits the generated ones by device function (``user_op_<i>``,
    ``field_<j>``); ``if_branches`` counts the branched arms' ``if`` lines
    and those that compiled to a branch (a ``BRA`` at that line);
    ``loop_bodies`` counts, for each bounded loop (by its ``for`` line),
    the instructions of the lines inside it: those a lane runs on each of
    its trips (the rest of ``fast_path`` runs once an iteration)."""
    if listing is None:
        listing = lined_listing(source)
    gen = open(source).read().splitlines()
    owner, fn = {}, None
    # each generated line's innermost bounded loop: its for line (a loop
    # holds the lines indented past it, up to its closing brace)
    in_loop, open_loops = {}, []
    for n, text in enumerate(gen, 1):
        depth = len(text) - len(text.lstrip())
        while open_loops and depth <= open_loops[-1][1]:
            open_loops.pop()
        if open_loops:
            in_loop[n] = open_loops[-1][0]
        if text.strip().startswith("for (int it"):
            open_loops.append((n, depth))
    for n, text in enumerate(gen, 1):
        m = re.search(r"\b(user_op_\d+|field_\d+|binned_op_\d+)\(", text)
        if m and text.startswith(("__device__", "template", "void")) or (
                m and " void " in text):
            fn = m.group(1)
        owner[n] = fn
        if text == "}":
            fn = None
    funcs = lined_functions(listing)
    name = next(n for n in funcs if "fused_form_kernel" in n
                and "buf" not in n)
    ins = funcs[name]
    plain = [(a, t) for a, t, _ in ins]
    (lo, hi), _ = iteration_loop(plain)
    slow = slow_blocks(plain, lo, hi)
    base = os.path.basename(source)
    by_kind, by_op, ifs, bodies = {}, {}, {}, {}
    for i in range(lo, hi + 1):
        if i in slow:
            continue
        line = next((n for f, n in ins[i][2]
                     if os.path.basename(f) == base), None)
        kind = "kernel" if line is None else source_kind(gen[line - 1])
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if line is not None:
            key = owner.get(line) or "form"
            by_op[key] = by_op.get(key, 0) + 1
            if line in in_loop:
                bodies[in_loop[line]] = bodies.get(in_loop[line], 0) + 1
            if source_kind(gen[line - 1]) == "branch" and gen[
                    line - 1].strip().startswith("if ("):
                ifs.setdefault(line, False)
                ifs[line] |= opcode(ins[i][1]) == "BRA"
    n_iter = max(1, sum(1 for i in range(lo, hi + 1)
                        if opcode(plain[i][1]) == "VOTE") // ballots)
    return {"function": name, "iterations": n_iter,
            "fast_path": sum(by_kind.values()),
            "by_kind": dict(sorted(by_kind.items())),
            "by_op": dict(sorted(by_op.items())),
            "if_branches": {"lines": len(ifs),
                            "compiled_to_branch": sum(ifs.values())},
            "loop_bodies": {f"line {n}: {gen[n - 1].strip()}": c
                            for n, c in sorted(bodies.items())}}


def library_sass(path: str) -> str:
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def built_sass() -> str:
    """The SASS of the fused_transport library this process loaded (built
    from this checkout's sources first if need be)."""
    from physicl_tpu_torch.ops import _build

    return library_sass(_build.load()["fused_transport"]._name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", type=int, nargs="*")
    ap.add_argument("--sass", help="a cuobjdump -sass listing")
    ap.add_argument("--lib", help="a built library (default: the main one)")
    ap.add_argument("--ballots", type=int, default=1, help="a form's warp "
                    "votes per iteration")
    ap.add_argument("--ranges", help="hex address ranges a-b,c-d (one "
                    "kernel)")
    ap.add_argument("--dump", help="write each kernel's SASS here")
    ap.add_argument("--attribute", help="a generated form source (.cu): "
                    "its iteration loop's SASS by source line")
    ap.add_argument("--listing", help="with --attribute: its nvdisasm -g -gi "
                    "listing (lined_listing), made elsewhere")
    args = ap.parse_args(argv)
    if args.attribute:
        print(json.dumps(attribute(args.attribute, args.ballots, open(
            args.listing).read() if args.listing else None)))
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    sass = (open(args.sass).read() if args.sass
            else library_sass(args.lib) if args.lib else built_sass())
    funcs = functions(sass)
    ranges = None
    if args.ranges:
        ranges = []
        for r in args.ranges.split(","):
            span, _, times = r.partition("*")
            lo, hi = (int(x, 16) for x in span.split("-"))
            ranges.append((lo, hi, int(times or 1)))
    kernels = {f"variant_{v}": v for v in args.variants}
    if not kernels:
        kernels = {"form": None}
    for label, v in kernels.items():
        if args.dump:
            _, ins = (function_for(funcs, v) if v is not None else next(
                (n, i) for n, i in funcs.items() if "fused_form_kernel" in n))
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, f"{label}.sass"), "w") as f:
                f.writelines(f"{a:05x} {t}\n" for a, t in ins)
        print(json.dumps(variant_summary(funcs, v, ranges) if v is not None
                         else form_summary(funcs, args.ballots, ranges)))


if __name__ == "__main__":
    main()
