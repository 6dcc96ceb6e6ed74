#!/usr/bin/env python3
"""Count the instructions of ``fused_transport``'s iteration loop in its SASS.

On a machine with the CUDA toolkit (the kernels build at first use)::

    python3 scripts/sass_loop.py 0 64          # variants 0 and 64
    python3 scripts/sass_loop.py --dump DIR 0  # also write each function's SASS

or on a SASS listing made elsewhere (``cuobjdump -sass lib.so``)::

    python3 scripts/sass_loop.py --sass FILE 0 --ranges f80-fc0*3,1020-1060

A user plan's library (kernel 1i, generated per plan by
``physicl_tpu_torch/ops/codegen.py``) also holds ``fused_user_probe``: the
plan's user programs alone in a loop over iterations. ``--user`` counts
that loop in a library's listing (``--sass FILE --user``, or ``--lib
PATH --user``): ``per_iteration`` is the straight-line instructions of the
programs per photon-iteration without the slow paths of the correctly
rounded roots and divides, and with the probe loop's own few (the
counter, the hash seed, the t and dt loads, the branch) and every record
sum's shuffles (a sum that no lane of the warp feeds is skipped at run
time, so this bounds the executed count from above).

The iteration loop of a generic instantiation is the smallest loop (a
backward branch and its target) that holds every warp vote of the function:
the loop over iterations, with the op loop and its switch inside it.
``static`` counts every instruction in it, every switch case included, so
it bounds the executed path from above; ``--ranges`` counts only the given
address ranges (hex, end inclusive, ``*n`` for a range run n times), as
when the executed path through the switch is traced by hand. The iteration
loop of an op-sequence instantiation is the loop without inner loops that
holds the most warp votes: its body is straight-line code for
``iterations`` iterations (the unrolled body; four ballots an iteration,
the sign's), and ``window`` counts the instructions of the enclosing
32-iteration window loop outside it (the count flush, and the remainder
iterations of a window that is not a multiple of the unrolling). ``fast_path`` leaves out
the blocks around the out-of-line calls of correctly rounded square roots
and divides (their slow paths, for arguments out of the fast path's range),
and ``per_iteration`` is ``fast_path / iterations``. Classes are by opcode
(``CLASSES``), but for the counter hash's own instructions (``_HASH``). Prints one JSON object per variant.
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
    """A substring of the mangled name of variant's kernel: the generic
    instantiations' six bool template arguments, or the op-sequence
    instantiations' op codes (physicl_tpu_torch/ops/fused.py:OP_CODES)."""
    if variant >= 64:
        from physicl_tpu_torch.ops import fused as F

        seq = {v: k for k, v in F.SEQ_VARIANTS.items()}[variant]
        return ("fused_seq_kernel", "".join(f"Li{F.OP_CODES[k]}E"
                                            for k in seq))
    return ("fused_transport_kernel", "".join(
        "Lb1E" if variant & (1 << b) else "Lb0E" for b in range(6)))


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
    """(start, end) of the smallest loop holding every warp vote (or, with
    ``innermost``, of the loop without inner loops that holds the most
    votes: the unrolled body, not its remainder), and of the smallest loop
    around that one (None if there is none)."""
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
        raise ValueError("no loop holds the warp votes")
    if innermost:
        body = max(inside, key=lambda lp: sum(lp[0] <= v <= lp[1]
                                              for v in votes))
    else:
        body = min(inside, key=lambda lp: lp[1] - lp[0])
    outer = [lp for lp in loops(ins) if lp[0] <= body[0] and body[1] <= lp[1]
             and lp != body]
    return body, (min(outer, key=lambda lp: lp[1] - lp[0]) if outer else None)


def slow_blocks(ins, lo, hi):
    """Indices in [lo, hi] of the blocks around each out-of-line call (from
    the branch before it to the unconditional branch after it)."""
    skip = set()
    for i in range(lo, hi + 1):
        if opcode(ins[i][1]) != "CALL":
            continue
        a = i
        while a > lo and opcode(ins[a - 1][1]) != "BRA":
            a -= 1
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


def summary(ins, ranges=None, ballots=None) -> dict:
    """The loop's counts (``static``, ``fast_path``, ``per_iteration`` and
    the fast path's classes, the window loop's own instructions), or the
    counts over ``ranges`` [(start address, end address, times)].
    ``ballots``: the warp votes per iteration of an op-sequence
    instantiation, whose iteration loop is then the innermost one with a
    vote."""
    if ranges:
        idx = [i for lo, hi, n in ranges for _ in range(n)
               for i, (a, _) in enumerate(ins) if lo <= a <= hi]
        return {"ranges": [f"{lo:x}-{hi:x}*{n}" for lo, hi, n in ranges],
                "executed": len(idx), "classes": count(ins, idx)}
    (lo, hi), outer = iteration_loop(ins, innermost=ballots is not None)
    fast = [i for i in range(lo, hi + 1) if i not in slow_blocks(ins, lo, hi)]
    n_iter = 1
    if ballots:
        n_iter = sum(1 for i in range(lo, hi + 1)
                     if opcode(ins[i][1]) == "VOTE") // ballots
    out = {"loop": [f"{ins[lo][0]:x}", f"{ins[hi][0]:x}"],
           "iterations": n_iter, "static": hi - lo + 1,
           "fast_path": len(fast), "per_iteration": len(fast) / n_iter,
           "classes": count(ins, fast)}
    if ballots and outer is not None:
        out["window"] = sum(1 for i in range(outer[0], outer[1] + 1)
                            if not lo <= i <= hi)
    return out


def variant_summary(funcs: dict, variant: int, ranges=None) -> dict:
    """summary() of ``variant``'s kernel in the listing ``funcs``."""
    name, ins = function_for(funcs, variant)
    return {"variant": variant, "function": name,
            **summary(ins, ranges, 4 if variant >= 64 else None)}


def user_summary(funcs: dict) -> dict:
    """The loop of a user plan library's ``fused_user_probe`` (the largest
    backward branch): its instructions per iteration, all and on the fast
    path, and their classes."""
    name, ins = next((n, i) for n, i in funcs.items()
                     if "fused_user_probe" in n)
    every = loops(ins)
    if not every:
        raise ValueError("fused_user_probe has no loop")
    lo, hi = max(every, key=lambda lp: lp[1] - lp[0])
    fast = [i for i in range(lo, hi + 1) if i not in slow_blocks(ins, lo, hi)]
    return {"function": name, "loop": [f"{ins[lo][0]:x}", f"{ins[hi][0]:x}"],
            "static": hi - lo + 1, "per_iteration": len(fast),
            "votes": sum(1 for i in fast if opcode(ins[i][1]) == "VOTE"),
            "classes": count(ins, fast)}


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
    ap.add_argument("--user", action="store_true", help="count a user "
                    "plan library's fused_user_probe loop")
    ap.add_argument("--ranges", help="hex address ranges a-b,c-d (one "
                    "variant)")
    ap.add_argument("--dump", help="write each variant's SASS here")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    sass = (open(args.sass).read() if args.sass
            else library_sass(args.lib) if args.lib else built_sass())
    funcs = functions(sass)
    if args.user:
        print(json.dumps(user_summary(funcs)))
    ranges = None
    if args.ranges:
        ranges = []
        for r in args.ranges.split(","):
            span, _, times = r.partition("*")
            lo, hi = (int(x, 16) for x in span.split("-"))
            ranges.append((lo, hi, int(times or 1)))
    for v in args.variants:
        if args.dump:
            _, ins = function_for(funcs, v)
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, f"variant_{v}.sass"), "w") as f:
                f.writelines(f"{a:05x} {t}\n" for a, t in ins)
        print(json.dumps(variant_summary(funcs, v, ranges)))


if __name__ == "__main__":
    main()
