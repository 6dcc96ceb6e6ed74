"""scripts/sass_loop.py's counts on a hand-written listing, on the CPU: the
iteration loop (the smallest loop holding every warp vote), its fast path
(without the block a predicated branch skips around an out-of-line call),
its global loads, and its iterations from the votes per iteration."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import sass_loop  # noqa: E402

LISTING = """
        Function : _Z17fused_form_kernelI5FormAEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   VOTE.ALL R2, PT, P0 ;
        /*0020*/                   FFMA R3, R4, R5, R6 ;
        /*0030*/              @P1 BRA 0x70 ;
        /*0040*/                   MOV R4, R3 ;
        /*0050*/                   CALL.REL.NOINC 0x100 ;
        /*0060*/                   MOV R3, R4 ;
        /*0070*/                   LDG.E R7, [R8.64] ;
        /*0080*/                   VOTE.ANY R9, PT, P2 ;
        /*0090*/                   FMUL R3, R3, R7 ;
        /*00a0*/                   BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


@pytest.mark.parametrize("ballots,iterations", [(1, 2), (2, 1)])
def test_form_summary_counts(ballots, iterations):
    out = sass_loop.form_summary(sass_loop.functions(LISTING), ballots)
    assert out["function"] == "_Z17fused_form_kernelI5FormAEvv"
    assert out["loop"] == ["10", "a0"]
    assert out["static"] == 10
    assert out["fast_path"] == 7  # the call's block, 0x40-0x60, skipped
    assert out["iterations"] == iterations
    assert out["per_iteration"] == 7 / iterations
    assert out["ldg"] == 1
    assert sum(out["classes"].values()) == 7
