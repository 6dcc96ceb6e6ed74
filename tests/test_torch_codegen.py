"""Kernel 1i's code generator (``physicl_tpu_torch/ops/codegen.py``) on the
CPU, where there is no ``nvcc``.

* The generated translation unit is deterministic, and its build key
  (``ops/_build.py:plan_key``) changes with the program, the variant and
  the ``csrc/`` sources.
* The emitted program bodies, compiled for the host with ``g++`` (host
  stand-ins for ``__int_as_float``, ``nan_min``, ``nan_max``, ``ipow`` and
  the record sum; ``csrc/sampling.cuh``'s own ``hash_bits`` and ``unit24``)
  on 2**10 slots, against the plain version ``ops/record.py:
  run_user_program``: every program of ``chip_smoke.py``'s ``USER_PLANS``,
  the user path and the spectrum path, and a program per instruction code
  (the select's two operand forms, an alive clear before a record sum, a
  load after a store). Tolerances: the plan programs' planes within 1e-6
  of each value plus 1e-6 of the plane's largest (``chip_smoke.py``'s plane
  gate: glibc's and torch's float32 transcendentals may differ by an ulp),
  ``alive`` equal, record sums within rtol 1e-5 (the host sums in float64,
  torch in float32); a single instruction bitwise, a transcendental one
  (exp, log, log10, sin, cos, tan, pow) within 2 ulp.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import physicl_tpu_torch as T
from physicl_tpu_torch.ops import _build
from physicl_tpu_torch.ops import codegen as CG
from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops import record as RC

N = 1 << 10
SEED, K = 1234567, 3
T_OP, DT_OP = 0.0125, 1e-3
CSRC = os.path.join(os.path.dirname(F.__file__), os.pardir, "csrc")

_HARNESS = r"""
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#include "sampling.cuh"
using physicl::hash_bits;
using physicl::slot_term;
using physicl::unit24;

static double g_acc[128];
inline float __int_as_float(uint32_t b) {
  float v;
  std::memcpy(&v, &b, 4);
  return v;
}
inline float nan_min(float a, float b) {
  return (std::isnan(a) || std::isnan(b)) ? a + b : fminf(a, b);
}
inline float nan_max(float a, float b) {
  return (std::isnan(a) || std::isnan(b)) ? a + b : fmaxf(a, b);
}
inline float ipow(float x, int y) {
  if (y == 0) return 1.0f;
  const bool neg = y < 0;
  unsigned u = neg ? (unsigned)(-y) : (unsigned)y;
  float acc = 0.0f;
  bool have = false;
  while (u) {
    if (u & 1u) {
      acc = have ? acc * x : x;
      have = true;
    }
    u >>= 1;
    if (u) x = x * x;
  }
  return neg ? 1.0f / acc : acc;
}
// the warp's record sum: here one slot's value into a float64 column sum
inline void user_sum(float*, int col, float v) { g_acc[col] += v; }

template <class Fn>
void run_slots(Fn fn, int n, float* f, float* x, uint8_t* alive, float t,
               float dt, uint32_t h0, uint32_t idx0, double* acc) {
  std::memset(g_acc, 0, sizeof g_acc);
  for (int g = 0; g < n; ++g) {
    float fl[15], xl[8];
    for (int p = 0; p < 15; ++p) fl[p] = f[p * n + g];
    for (int p = 0; p < 8; ++p) xl[p] = x[p * n + g];
    bool a = alive[g] != 0;
    fn(fl, xl, a, t, dt, h0, idx0, slot_term(g), nullptr);
    for (int p = 0; p < 15; ++p) f[p * n + g] = fl[p];
    for (int p = 0; p < 8; ++p) x[p * n + g] = xl[p];
    alive[g] = a;
  }
  std::memcpy(acc, g_acc, sizeof g_acc);
}
"""


def _host_library(progs: dict, tmp):
    """``g++``-built shared library of ``{name: Program}``: ``run_<name>``
    runs the emitted body on every slot."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    parts = [_HARNESS]
    for name, prog in progs.items():
        parts.append(CG.program_c(prog, f"prog_{name}"))
        parts.append(
            f'extern "C" void run_{name}(int n, float* f, float* x, '
            "uint8_t* alive, float t, float dt, uint32_t h0, uint32_t idx0, "
            f"double* acc) {{ run_slots(prog_{name}, n, f, x, alive, t, dt, "
            "h0, idx0, acc); }")
    src = os.path.join(tmp, "programs.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts))
    so = os.path.join(tmp, "libprograms.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", so, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(so)


def _run_host(lib, name, planes, alive, idx0=0):
    """The host run of program ``name`` on ``planes`` ((23, N) float32: the
    15 core planes and 8 extras) and ``alive``; returns (planes, alive,
    float64 record sums)."""
    f = np.array(planes[:15], np.float32)  # copies: the run writes them
    x = np.array(planes[15:], np.float32)
    a = np.array(alive, np.uint8)
    acc = np.zeros(128, np.float64)
    h0 = (SEED ^ ((K * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF
    vp = ctypes.c_void_p
    getattr(lib, f"run_{name}")(
        ctypes.c_int(N), vp(f.ctypes.data), vp(x.ctypes.data),
        vp(a.ctypes.data), ctypes.c_float(T_OP), ctypes.c_float(DT_OP),
        ctypes.c_uint32(h0), ctypes.c_uint32(idx0), vp(acc.ctypes.data))
    return np.concatenate([f, x]), a.astype(bool), acc


def _run_twin(prog, planes, alive, idx0=0):
    """``run_user_program`` on the same inputs (the iteration's counter
    hash at draw index ``idx0``)."""
    f = [torch.from_numpy(p.copy()) for p in planes]
    rng = F._HashRng(SEED, K, F._slot_term(torch.arange(N)))
    rng.idx = idx0
    row = torch.zeros(128)
    al = RC.run_user_program(prog, f, torch.from_numpy(alive.copy()),
                             torch.tensor(T_OP), torch.tensor(DT_OP), rng,
                             row)
    return torch.stack(f).numpy(), al.numpy(), row.numpy().astype(np.float64)


def _inputs(seed=0):
    """(23, N) float32 planes in (0.1, 3) with ties between planes 0 and 12,
    exact 1s and 0s, and an alive mask of ~80%."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.1, 3.0, (23, N)).astype(np.float32)
    p[0, ::7] = p[12, ::7]
    p[12, ::11] = 1.0
    p[0, ::13] = 0.0
    alive = rng.uniform(size=N) < 0.8
    p[13] = alive
    return p, alive


# -- a program per instruction code ------------------------------------------

_TRANSCENDENTAL = {RC.U_EXP, RC.U_LOG, RC.U_LOG10, RC.U_SIN, RC.U_COS,
                   RC.U_TAN, RC.U_POW}
_CODES = {name: code for name, code in vars(RC).items()
          if name.startswith("U_") and isinstance(code, int)}


def _code_program(case) -> RC.Program:
    """A short program around the instruction ``case`` (a ``U_*`` name, or
    one of the select's immediate form, an alive clear before a record sum
    and a load after a store): its results stored into planes 14, 3, 4, 15
    (an extras plane) or summed into record columns."""
    ld = lambda d, p: (RC.U_LD, d, 0, 0, p, False)  # noqa: E731
    st = lambda a, p: (RC.U_ST, 0, a, 0, p, False)  # noqa: E731
    if case == "U_SEL-imm":
        ins = [ld(0, 12), ld(1, 0), (RC.U_LT, 2, 0, 1, 0, False),
               (RC.U_SEL, 3, 2, 1, -2.5, True), st(3, 14)]
        return RC.Program(tuple(ins), 4, 0)
    code = _CODES[case]
    if code == RC.U_SEL:
        ins = [ld(0, 12), ld(1, 0), (RC.U_LT, 2, 0, 1, 0, False),
               (RC.U_SEL, 3, 2, 0, 1, False), st(3, 14)]
        return RC.Program(tuple(ins), 4, 0)
    if code == RC.U_ST:  # a load after a store reads the stored value
        ins = [ld(0, 12), (RC.U_MUL, 1, 0, 0, 2.0, True), st(1, 12),
               ld(2, 12), (RC.U_ADD, 3, 2, 0, 1.0, True), st(3, 14),
               st(0, 15)]
        return RC.Program(tuple(ins), 4, 0)
    if code in (RC.U_ALIVE, RC.U_ACC):  # the clear before the sums
        ins = [ld(0, 12), (RC.U_LT, 1, 0, 0, 1.5, True),
               (RC.U_ALIVE, 0, 1, 0, 0, False), ld(2, 14),
               (RC.U_ACC, 0, 2, 0, 0, False), ld(3, 13),
               (RC.U_ACC, 0, 3, 0, 1, False),
               (RC.U_CONST, 4, 0, 0, 0.0, False),
               (RC.U_ACC, 0, 4, 0, 2, False)]
        return RC.Program(tuple(ins), 5, 0)
    if code == RC.U_LD:  # every core plane (13 the alive flag), an extras
        ins = [ld(0, 13), st(0, 14), ld(1, 16), st(1, 3), ld(2, 1),
               st(2, 15)]
        return RC.Program(tuple(ins), 3, 0)
    if code in (RC.U_T, RC.U_DT):
        return RC.Program(((code, 0, 0, 0, 0, False), st(0, 14)), 1, 0)
    if code == RC.U_CONST:
        vals = (1.5, -0.0, float("inf"), float("nan"), -3.25e-30)
        ins = []
        for j, v in enumerate(vals):
            ins += [(RC.U_CONST, j, 0, 0, v, False),
                    st(j, (14, 3, 4, 5, 15)[j])]
        return RC.Program(tuple(ins), len(vals), 0)
    if code == RC.U_UNIF:  # draws 0 and 2 of three
        ins = [(RC.U_UNIF, 0, 0, 0, 0, False), st(0, 14),
               (RC.U_UNIF, 1, 0, 0, 2, False), st(1, 3)]
        return RC.Program(tuple(ins), 2, 3)
    if code == RC.U_IPOW:
        ins = [ld(0, 12)]
        for j, e in enumerate((3, -2, 0, 7)):
            ins += [(RC.U_IPOW, 1 + j, 0, 0, e, False),
                    st(1 + j, (14, 3, 4, 15)[j])]
        return RC.Program(tuple(ins), 5, 0)
    if code in CG._UNARY:
        ins = [ld(0, 12), (RC.U_SUB, 1, 0, 0, 1.0, True), (code, 2, 0, 0, 0,
               False), st(2, 14), (code, 3, 1, 0, 0, False), st(3, 3)]
        if code in (RC.U_SQRT, RC.U_LOG, RC.U_LOG10):
            ins = ins[:1] + ins[2:4]
        return RC.Program(tuple(ins), 4, 0)
    # a binary operation: both operands registers, and b an immediate
    ins = [ld(0, 12), ld(1, 0), (code, 2, 0, 1, 0, False), st(2, 14),
           (code, 3, 0, 0, 1.0, True), st(3, 3),
           (code, 4, 1, 0, 0.0, True), st(4, 15)]
    return RC.Program(tuple(ins), 5, 0)


_CODE_CASES = sorted(_CODES) + ["U_SEL-imm"]


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(1 << 31) - ia, ia)  # order negative floats
    ib = np.where(ib < 0, -(1 << 31) - ib, ib)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return int(np.where(same, 0, np.abs(ia - ib)).max())


@pytest.fixture(scope="module")
def code_lib(tmp_path_factory):
    progs = {case.replace("-", "_"): _code_program(case)
             for case in _CODE_CASES}
    return _host_library(progs, str(tmp_path_factory.mktemp("codes"))), progs


@pytest.mark.parametrize("case", _CODE_CASES)
def test_instruction_matches_plain_version(code_lib, case):
    lib, progs = code_lib
    name = case.replace("-", "_")
    prog = progs[name]
    planes, alive = _inputs()
    got, got_alive, got_acc = _run_host(lib, name, planes, alive, idx0=5)
    want, want_alive, want_acc = _run_twin(prog, planes, alive, idx0=5)
    assert np.array_equal(got_alive, want_alive)
    code = _CODES.get(case)
    if code in _TRANSCENDENTAL:
        assert _ulps(got, want) <= 2
    else:
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got_acc, want_acc, rtol=1e-5, atol=1e-6)
    if code == RC.U_ALIVE:  # the clear lands before both sums
        assert got_acc[1] == float(got_alive.sum()) and got_acc[2] == 0.0


# -- the programs of chip_smoke.py's plans -----------------------------------


def _plans():
    """``{name: plan}`` of chip_smoke.py's kernel 1i plans, planned on the
    CPU at 2**10 photons."""
    import chip_smoke as cs

    sims = {case: cs.user_plan_sim(T, case, "cpu", n=N, chunk=16)
            for case in cs.USER_PLANS if case != "fluor-callable"}
    sims["user-path"] = cs.user_sim(T, N, "cpu", iters=16, chunk=16)[0]
    sims["spectrum-path"] = cs.spectrum_sim(T, N, "cpu", iters=16)[0]
    return {name: cs.planned(sim)[1].plan for name, sim in sims.items()}


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    plans = _plans()
    progs = {f"{name.replace('-', '_')}_{i}": op.prog
             for name, plan in plans.items()
             for i, op in CG.user_ops(plan)}
    return (_host_library(progs, str(tmp_path_factory.mktemp("plans"))),
            progs, plans)


def _plan_inputs(plan, seed):
    """(23, N) planes for a plan's programs: positions within 100 c dt,
    directions at c, energies log-uniform over the spectrum's edges and
    beyond, weights in (0.2, 1), the extras in (-1, 1) but an otype plane
    of photon (1) and charged (0) codes; ~80% alive."""
    rng = np.random.default_rng(seed)
    c = float(T.light.c)
    p = np.zeros((23, N), np.float32)
    p[0:3] = rng.uniform(-100, 100, (3, N)) * c * 1e-3
    p[3:6] = rng.normal(size=(3, N)) * c * 1e-3
    d = rng.normal(size=(3, N))
    p[6:9] = d / np.linalg.norm(d, axis=0) * c
    p[9:12] = rng.normal(size=(3, N)) * 1e3
    p[12] = np.exp(rng.uniform(-3.5, 4.5, N))
    alive = rng.uniform(size=N) < 0.8
    p[13] = alive
    p[14] = rng.uniform(0.2, 1.0, N)
    p[15:15 + len(plan.extras)] = rng.uniform(-1, 1, (len(plan.extras), N))
    if "otype" in plan.extras:
        p[15 + plan.extras.index("otype")] = rng.integers(0, 2, N)
    return p, alive


@pytest.mark.parametrize("name", [
    "custom", "custom-draws", "custom-extras", "reduce-n", "mesh-x-path",
    "mesh-r-weighted", "kstate-mixed", "reduce-weighted", "past-limits",
    "user-path", "spectrum-path"])
def test_plan_programs_match_plain_version(plan_lib, name):
    lib, progs, plans = plan_lib
    plan = plans[name]
    idx0 = 0
    for i, op in CG.user_ops(plan):
        key = f"{name.replace('-', '_')}_{i}"
        planes, alive = _plan_inputs(plan, seed=i)
        got, got_alive, got_acc = _run_host(lib, key, planes, alive, idx0)
        want, want_alive, want_acc = _run_twin(progs[key], planes, alive,
                                               idx0)
        assert np.array_equal(got_alive, want_alive), key
        scale = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want)
                      + 1e-6 * scale), key
        np.testing.assert_allclose(got_acc, want_acc, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        idx0 += op.prog.n_draws


# -- the generated translation unit and its build key -------------------------


def _user_plan(fn=None, seed=0):
    """The plan of the user path's steps with ``fn`` as its ElementwiseStep
    (default: chip_smoke.py's decay), planned on the CPU."""
    import chip_smoke as cs

    sim, _ = cs.user_sim(T, 256, "cpu", iters=16, chunk=16, seed=seed)
    if fn is not None:
        step = next(s for s in sim._ordered_steps()
                    if isinstance(s, T.ElementwiseStep))
        step.fn = fn
    return cs.planned(sim)[1].plan


def test_source_is_deterministic_and_keyed():
    a, b = _user_plan(), _user_plan(seed=3)
    src = CG.plan_source(a)
    assert src == CG.plan_source(b)
    assert _build.plan_key(src) == _build.plan_key(CG.plan_source(b))
    assert f"#define PHYSICL_USER_PLAN {a.kernel_variant}\n" in src
    assert '#include "fused_transport.cu"' in src
    for i, _ in CG.user_ops(a):
        assert f"case {i}: user_op_{i}(" in src
    # another program
    import chip_smoke as cs

    def decay2(p):
        return cs.decay(p) | {"E": p.E * 0.5}

    other = CG.plan_source(_user_plan(decay2))
    assert other != src and _build.plan_key(other) != _build.plan_key(src)
    # another variant of the same programs (stream planes: bit 1)
    streamed = dataclasses.replace(a, n_stream=1)
    assert streamed.kernel_variant == a.kernel_variant | 2
    assert _build.plan_key(CG.plan_source(streamed)) != _build.plan_key(src)


def test_build_key_follows_the_csrc_sources(tmp_path, monkeypatch):
    src = CG.plan_source(_user_plan())
    key = _build.plan_key(src)
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", str(copy))
    assert _build.plan_key(src) == key
    with open(copy / "fused_transport.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.plan_key(src) != key


def test_literals_are_exact():
    """Every float32 constant round-trips through its C spelling."""
    for v in (1.5, -0.0, 0.1, -3.25e-30, 3.4028234663852886e38, 1e-45):
        text = CG._lit(v)
        assert float.fromhex(text.strip("()").rstrip("f")) == float(
            np.float32(v))
        assert text.startswith("(") == (np.copysign(1.0, v) < 0)
    assert CG._lit(float("inf")) == "__int_as_float(0x7f800000)"
    assert CG._lit(float("nan")) == "__int_as_float(0x7fc00000)"


# -- building a plan's library (a stand-in compiler on the CPU) ------------------

_STUB = r"""
extern "C" int fused_transport_plan_size() { return PLAN_SIZE; }
extern "C" int fused_transport_grid(long long, int, int, int, int, int* g) {
  *g = 1;
  return 0;
}
extern "C" int fused_transport_launch() { return 0; }
"""


def _fake_nvcc(tmp, fail=False):
    """A stand-in for ``nvcc`` that logs each call and copies a host stub
    library (the C interface, the Plan's size) to its ``-o`` path, or
    fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    stub = os.path.join(tmp, "stub.cpp")
    with open(stub, "w") as f:
        f.write(_STUB.replace("PLAN_SIZE",
                              str(ctypes.sizeof(_build.PlanStruct))))
    so = os.path.join(tmp, "libstub.so")
    subprocess.run([gxx, "-shared", "-fPIC", "-o", so, stub], check=True)
    script = os.path.join(tmp, "nvcc")
    body = ('echo "error: the stand-in fails"; exit 2' if fail else
            f'cp {so} "$out"; echo "ptxas info    : Used 42 registers"')
    with open(script, "w") as f:
        f.write("#!/bin/sh\n"
                f'echo "$@" >> {tmp}/calls\n'
                'out=""; prev=""\n'
                'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
                'prev="$a"; done\n' + body + "\n")
    os.chmod(script, 0o755)
    return script


def _fresh_build_dir(monkeypatch, tmp, nvcc):
    monkeypatch.setenv("NVCC", nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", os.path.join(tmp, "_build"))
    for name in ("_plan_libs", "_plan_jobs", "plan_builds"):
        monkeypatch.setattr(_build, name, {})


def test_plan_library_builds_once_and_loads(tmp_path, monkeypatch):
    """The generated source goes to ``_build/`` under its key, one
    compiler run builds the library (renamed into place from a file of
    its own), its seconds and log are kept, and the same source loads
    from the cache in the process and from the file after."""
    tmp = str(tmp_path)
    _fresh_build_dir(monkeypatch, tmp, _fake_nvcc(tmp))
    src = CG.plan_source(_user_plan())
    key = _build.plan_key(src)
    _build.start_plan_builds({"user": src, "again": src})
    lib = _build.load_plan(src, "user")
    assert lib is _build.load_plan(src, "user")
    assert os.path.basename(lib._name) == f"libfused_plan_{key}.so"
    with open(os.path.join(_build.BUILD_DIR, f"fused_plan_{key}.cu")) as f:
        assert f.read() == src
    assert not [n for n in os.listdir(_build.BUILD_DIR) if ".tmp" in n]
    built = _build.plan_builds[key]
    assert built["label"] == "user" and built["seconds"] > 0
    assert "42 registers" in built["log"]
    monkeypatch.setattr(_build, "_plan_libs", {})
    _build.load_plan(src, "user")  # from the file: no second compile
    with open(tmp_path / "calls") as f:
        calls = f.read().splitlines()
    assert len(calls) == 1 and "-I" in calls[0] and "--fmad=false" in calls[0]


def test_failed_plan_build_raises_naming_the_plan(tmp_path, monkeypatch):
    tmp = str(tmp_path)
    _fresh_build_dir(monkeypatch, tmp, _fake_nvcc(tmp, fail=True))
    plan = _user_plan()
    with pytest.raises(RuntimeError, match=r"nvcc failed \(2\) for the user "
                       r"plan \[kin,iso,kstate,custom,reduce\] variant 40"):
        F._library(plan)
    assert not os.path.exists(_build.plan_path(
        _build.plan_key(CG.plan_source(plan))))
