"""scripts/sass_loop.py's counts on a hand-written listing, on the CPU: the
iteration loop (the smallest loop holding every warp vote), its fast path
(without the block a predicated branch skips around an out-of-line call),
its global loads, and its iterations from the votes per iteration; and
its attribution of a form's loop to the generated source lines of an
``nvdisasm -g -gi`` listing (the longest inline chain an instruction's,
branches to labels resolved)."""

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


# an nvdisasm -g -gi listing of a form: an inlined location listed with
# its chain, then its outer site alone; branches to labels
SOURCE = """// generated
template <class Acc>
__device__ __forceinline__ void user_op_2(float* f) {
  const float v1 = expf(v0);
  const float v2 = __fmaf_rn(v1, v0, 0x1p+0f);
  float v5;
  if (v2 != 0.0f) {
    v5 = v1;
  } else {
    v5 = v0;
  }
}
"""
LINED = """
.text._Z17fused_form_kernelI5FormAEvv:
        //## File "/k/fused_transport.cu", line 10
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        //## File "/k/fused_transport.cu", line 12
        /*0010*/                   VOTE.ALL R2, PT, P0 ;
        //## File "/k/math.h", line 3 inlined at "{src}", line 4 inlined at "/k/fused_transport.cu", line 20
        //## File "/k/fused_transport.cu", line 20
        /*0020*/                   FMUL R3, R4, R5 ;
        /*0030*/                   MUFU.EX2 R3, R3 ;
        //## File "{src}", line 5 inlined at "/k/fused_transport.cu", line 20
        //## File "/k/fused_transport.cu", line 20
        /*0040*/                   FFMA R6, R3, R4, 1 ;
        //## File "{src}", line 7 inlined at "/k/fused_transport.cu", line 20
        /*0050*/              @P1  BRA `(.L_x_1) ;
        //## File "{src}", line 8 inlined at "/k/fused_transport.cu", line 20
        /*0060*/                   MOV R7, R3 ;
.L_x_1:
        //## File "/k/fused_transport.cu", line 12
        /*0070*/                   BRA `(.L_x_0) ;
        /*0080*/                   EXIT ;
"""


def test_attribute_by_source_line(tmp_path):
    """Each loop instruction goes to the generated line of its longest
    inline chain (a libm call by name, an FMA, a branched arm's if and
    move), the rest to the kernel; a branch to a label is a loop."""
    src = tmp_path / "form.cu"
    src.write_text(SOURCE)
    listing = LINED.replace("{src}", str(src))
    funcs = sass_loop.lined_functions(listing)
    ins = funcs["_Z17fused_form_kernelI5FormAEvv"]
    assert ins[7][1] == "BRA 0x10"  # the label resolved to its address
    out = sass_loop.attribute(str(src), 1, listing)
    assert out["by_kind"] == {"branch": 1, "fma": 1, "kernel": 2,
                              "libm:expf": 2, "move": 1}
    assert out["by_op"] == {"user_op_2": 5}
    assert out["if_branches"] == {"lines": 1, "compiled_to_branch": 1}


# a block phase's item loop: the phase's own lines and a bounded loop's
# body (lines 6-7 inside the for of line 5)
PHASE_SOURCE = """// generated
{  // block phase: 1 loop(s), 2 rows of items
  phase_place<1>(ph_w + 512, ph_en, ph_pos, ph_tot);
  __syncthreads();
    for (int it9 = 0; it9 < 40; ++it9) {
      const float v10 = v8 * 0x1p-1f;
      v8 = v10;
    }
    phase_put_f32(ph_it + 0, v8);
}
"""
PHASE_LINED = """
.text._Z17fused_form_kernelI5FormAEvv:
.L_x_0:
        //## File "{src}", line 3 inlined at "/k/fused_transport.cu", line 20
        /*0000*/                   VOTE.ANY R2, PT, P0 ;
        //## File "{src}", line 4 inlined at "/k/fused_transport.cu", line 20
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_1:
        //## File "{src}", line 6 inlined at "/k/fused_transport.cu", line 20
        /*0020*/                   FMUL R3, R3, 0.5 ;
        //## File "{src}", line 7 inlined at "/k/fused_transport.cu", line 20
        /*0030*/                   MOV R4, R3 ;
        //## File "{src}", line 5 inlined at "/k/fused_transport.cu", line 20
        /*0040*/              @P1  BRA `(.L_x_1) ;
        //## File "{src}", line 9 inlined at "/k/fused_transport.cu", line 20
        /*0050*/                   STS [R5], R3 ;
        //## File "/k/fused_transport.cu", line 12
        /*0060*/                   BRA `(.L_x_0) ;
        /*0070*/                   EXIT ;
"""


def test_attribute_counts_the_phase_and_loop_bodies(tmp_path):
    """A block phase's own lines are ``phase``; the lines inside a bounded
    loop's ``for`` (indented past it) count as its body, a lane's work a
    trip; the ``for`` line itself is the loop's head."""
    src = tmp_path / "form.cu"
    src.write_text(PHASE_SOURCE)
    out = sass_loop.attribute(str(src), 1,
                              PHASE_LINED.replace("{src}", str(src)))
    assert out["by_kind"] == {"kernel": 1, "loop": 1, "move": 1, "phase": 3,
                              "program": 1}
    assert out["loop_bodies"] == {
        "line 5: for (int it9 = 0; it9 < 40; ++it9) {": 2}
