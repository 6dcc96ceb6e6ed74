"""The incomplete gammas through a bounded loop, Cephes' Bessel j0 / j1,
libm calls of constants folded on the host, and the lowered functions'
fused multiply-adds and branched arms (``physicl_tpu_torch/ops/record.py``,
``ops/codegen.py``), on the CPU.

* ``torch.special.gammainc`` / ``gammaincc``: the recorded program's plain
  version (the fused tier's twin: each loop over the whole tensor, a
  disabled lane kept by select) and the generic tier's eager torch, both
  against ``jax.scipy.special`` in float32, on a <= 0, x < 0, x = 0, x
  near a, both sides of the ``x > 1 and x > a`` switch, large and tiny a,
  a lane that runs the continued fraction to its 2000 cap, NaN and inf.
  Tolerance: ``4 eps (2 + (|a log x| + x + |lgamma a|) D)`` (``eps``
  float32's, ``D`` the side jnp computes directly; ``a log x - x -
  lgamma(a)`` cancels in float32, and its rounding is a relative error of
  D in every float32 form, jnp's included; ``_igamma_tol``); special
  values equal, NaN for NaN.
* ``torch.special.bessel_j0`` / ``j1``: the twin against torch's eager
  function within 2.5e-7 and ``scipy.special.j0`` / ``j1`` within 1e-6 on
  [-60, 60] (and +-0, NaN, inf as torch gives them), against jnp's
  ``bessel_jn`` within 1e-6 only on [3.5, 30), where its recurrence has
  converged in float32.
* The generated C, built with the host ``g++``, bitwise against the twin:
  the lowered series and continued fraction (lanes leaving at different
  iterations, a lane at the cap, NaN), branched arms (``i0e`` and ``i1e``
  on both sides of 8, a user select over two polynomials) and ``U_FMA`` on
  hard operands (cancellation, float32 midpoints, subnormal results,
  overflow, inf x 0, NaN), whose twin also equals the C library's
  ``fmaf``.
* A libm call of constants: folded to the correctly rounded value (checked
  at 100 digits), no libm call with constant arguments left in the
  generated C, and the host build bitwise against the twin.
* The four functions fuse with ``Simulation(device="cpu")`` as an
  ``ElementwiseStep``, a ``ReduceMeasureStep``, a ``KernelStep`` and a
  recorded field, against the JAX package (jnp's ``gammainc`` /
  ``gammaincc`` and ``bessel_jn`` on [3.5, 30); in the aperture path,
  whose arguments span [0, 40], Cephes' j0 / j1 written in jnp from the
  coefficients in torch's ``ATen/native/Math.h``): ``sim.ts``
  byte-identical, int records equal, float records within rtol 1e-5, and
  ``chip_smoke.py``'s aperture path at 2**12 photons x 64 iterations.
* ``chip_smoke.py``'s bound counts the twin's lanes over the iterations it
  times (``lane_weights``): work that the data puts only in the first
  iterations counts once.
"""

import ctypes
import re

import numpy as np
import pytest
import scipy.special as ss
import torch

import jax.numpy as jnp
import jax.scipy.special as jsp

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.kernels import KernelStep as JKernelStep
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.kernels import KernelStep as TKernelStep
from physicl_tpu_torch.ops import codegen as CG
from physicl_tpu_torch.ops import record as RC

from test_torch_codegen import (_field_both, _field_library, _host_library,
                                _inputs, _run_host, _run_twin)

EPS = float(np.finfo(np.float32).eps)
F32 = np.float32


def _twin(fn, *xs):
    """The recorded field program of ``fn`` run by its plain version."""
    names = ("a", "b", "c")[:len(xs)]
    field = RC.record_field(fn, names, "fn")
    return field(*[torch.from_numpy(np.asarray(x, F32)) for x in xs]).numpy()


# -- the incomplete gammas -----------------------------------------------------

_RNG = np.random.default_rng(21)
_N = 1 << 10
# case -> (a, x), float32
_IGAMMA = {
    "a-nonpositive": (np.r_[np.zeros(8), -_RNG.uniform(0, 5, _N)],
                      np.r_[np.linspace(0, 3, 8), _RNG.uniform(0, 5, _N)]),
    "x-negative": (_RNG.uniform(0, 5, _N), -_RNG.uniform(0, 5, _N)),
    "x-zero": (_RNG.uniform(0, 5, _N), np.zeros(_N)),
    "x-near-a": ((a := _RNG.uniform(1, 500, _N)),
                 a * (1 + _RNG.uniform(-1e-3, 1e-3, _N))),
    "below-switch": (_RNG.uniform(0.5, 30, _N), _RNG.uniform(0, 1, _N)),
    "series-side": ((a := _RNG.uniform(2, 30, _N)), a * _RNG.uniform(
        0.1, 0.99, _N)),
    "fraction-side": ((a := _RNG.uniform(0.1, 30, _N)), (a + 1) * _RNG.uniform(
        1.01, 3, _N)),
    "large-a": ((a := _RNG.uniform(1e3, 3e4, _N)),
                a + _RNG.normal(0, 3, _N) * np.sqrt(a)),
    "tiny-a": (10.0 ** _RNG.uniform(-30, -2, _N), _RNG.uniform(0, 5, _N)),
    # the continued fraction runs to its cap of 2000 terms (a = 1e8)
    "cap": (np.full(16, 1e8), 1e8 + np.arange(8, 24)),
    "nan-inf": (np.array([np.nan, 1, np.nan, np.inf, 1, 2, 0, np.inf, 3,
                          -np.inf]),
                np.array([1, np.nan, np.nan, 1, np.inf, np.inf, np.inf,
                          np.inf, -np.inf, 2])),
}


def _igamma_tol(a, x):
    """``4 eps (2 + (|a log x| + |x| + |lgamma a|) D)``: ``D`` the side
    jnp computes directly (its ``gammaincc`` where ``x > 1 and x > a``,
    else its ``gammainc``), the other side being ``1 - D``. A rounding
    error in ``ax = a log x - x - lgamma(a)`` is a relative error of D.
    The largest twin and eager gaps to jnp measured over these cases are
    1.3 and 1.8 times ``eps (...) D`` above 4 eps (large-a's 0.021 and
    0.018 where jnp itself is 0.012 off scipy's float64)."""
    a32, x32 = jnp.asarray(a, jnp.float32), jnp.asarray(x, jnp.float32)
    direct = np.where((x > 1) & (x > a), jsp.gammaincc(a32, x32),
                      jsp.gammainc(a32, x32)).astype(np.float64)
    with np.errstate(all="ignore"):
        scale = (np.abs(a * np.log(x)) + np.abs(x)
                 + np.abs(ss.gammaln(a))) * np.abs(direct)
    return 4 * EPS * (2 + np.nan_to_num(scale, nan=0.0, posinf=0.0))


def _close(got, want, tol):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert (np.abs(got[~nan].astype(np.float64) - want[~nan])
            <= tol[~nan]).all(), np.abs(got[~nan] - want[~nan]).max()


@pytest.mark.parametrize("upper", [False, True], ids=["gammainc",
                                                      "gammaincc"])
@pytest.mark.parametrize("case", sorted(_IGAMMA))
def test_igamma_matches_jax_on_both_tiers(case, upper):
    a, x = (np.asarray(v, F32) for v in _IGAMMA[case])
    t_fn = torch.special.gammaincc if upper else torch.special.gammainc
    j_fn = jsp.gammaincc if upper else jsp.gammainc
    want = np.asarray(j_fn(jnp.asarray(a), jnp.asarray(x)), np.float64)
    tol = _igamma_tol(a.astype(np.float64), x.astype(np.float64))
    _close(_twin(t_fn, a, x), want, tol)  # the fused tier's twin
    if case != "cap":  # torch's own series there converges, jnp's stops
        # the generic tier (torch's eager function) where both are finite:
        # torch's special values differ from jnp's (the fused tier's)
        eager = t_fn(torch.from_numpy(a), torch.from_numpy(x)).numpy()
        ok = np.isfinite(want) & np.isfinite(eager)
        _close(eager[ok], want[ok], tol[ok])


def test_igamma_cap_lane_runs_2000_terms():
    """The cap lanes stop at 2000 terms in the twin as in jnp: with a cap
    of 1999 the value differs."""
    a, x = (np.asarray(v, F32) for v in _IGAMMA["cap"])
    at = RC._CF_CAP
    got = _twin(lambda a, x: torch.special.gammaincc(a, x), a, x)
    try:
        RC._CF_CAP = at - 1
        short = _twin(lambda a, x: torch.special.gammaincc(a, x), a, x)
    finally:
        RC._CF_CAP = at
    assert not np.array_equal(got, short)
    want = np.asarray(jsp.gammaincc(jnp.asarray(a), jnp.asarray(x)))
    assert np.abs(got - want).max() <= _igamma_tol(
        a.astype(np.float64), x.astype(np.float64)).min()


def test_igamma_float64_is_refused():
    with pytest.raises(RC.Refused, match="igamma in float64"):
        RC.record_field(lambda E: torch.special.gammainc(E.double(), E),
                        ("E",), "A_fn")


# -- Bessel j0 / j1 -------------------------------------------------------------

_BX = np.r_[np.linspace(-60, 60, 120001), 0.0, -0.0, 1e-6, -1e-6, 4.9999995,
            5.0, 5.0000005, 1e-30].astype(F32)


@pytest.mark.parametrize("order", [0, 1])
def test_bessel_matches_torch_scipy_and_jnp(order):
    t_fn = (torch.special.bessel_j0, torch.special.bessel_j1)[order]
    got = _twin(t_fn, _BX)
    eager = t_fn(torch.from_numpy(_BX)).numpy()
    assert np.abs(got - eager).max() <= 2.5e-7
    truth = (ss.j0, ss.j1)[order](_BX.astype(np.float64))
    assert np.abs(got - truth).max() <= 1e-6
    jn = np.asarray(jsp.bessel_jn(jnp.asarray(_BX), v=order))[order]
    conv = (np.abs(_BX) >= 3.5) & (np.abs(_BX) < 30)
    assert np.abs(got - jn)[conv].max() <= 1e-6
    # the edges as torch gives them: NaN at +-inf and NaN, -0 kept by j1
    sp = np.array([np.inf, -np.inf, np.nan, -0.0, 0.0], F32)
    g = _twin(t_fn, sp)
    e = t_fn(torch.from_numpy(sp)).numpy()
    assert np.array_equal(g.view(np.int32)[3:], e.view(np.int32)[3:])
    assert np.isnan(g[:3]).all() and np.isnan(e[:3]).all()


def test_bessel_float64_is_refused():
    with pytest.raises(RC.Refused, match="special_bessel_j0 in float64"):
        RC.record_field(lambda E: torch.special.bessel_j0(E.double()),
                        ("E",), "A_fn")


# -- the generated C on the host ------------------------------------------------

def _loop_field(upper):
    """The lowered continued fraction (``upper``) or series alone, ``ax`` =
    1, as a field of (a, x): its loop of exact operations."""
    s = RC._SSA()
    a, x = s.val(RC.U_LD, (), 0), s.val(RC.U_LD, (), 1)
    en = s.op(RC.U_AND, s.op(RC.U_GT, a, s.const(0.0)),
              s.op(RC.U_GT, x, s.const(0.0)))
    part = RC._igammac_cf if upper else RC._igamma_series
    out = s.op(RC.U_MUL, part(s, x, a, en)[0], s.const(1.0))
    if not upper:
        out = s.op(RC.U_DIV, out, a)
    s.effects.append((RC.U_ST, out, 0))
    from physicl_tpu_torch.ops import fields as FL

    return FL.expr_field(RC._schedule(s, 0), ("r0", "r1", "r2"),
                         "loop").spec


def _recorded_spec(fn):
    return RC.record_field(fn, ("r0", "r1", "r2"), "fn").spec


def _poly_select(x, y, z):
    """A user select over two polynomials of 8 and 7 steps (the user's own
    ``a * b + c``: a product and a sum each)."""
    hi = lo = x
    for k in range(8):
        hi = hi * y + (k + 0.5)
    for k in range(7):
        lo = lo * z - (k + 0.25)
    return torch.where(x > 1.5, hi, lo)


_HOST_FIELDS = {
    "series": lambda: _loop_field(False),
    "fraction": lambda: _loop_field(True),
    "i0e": lambda: _recorded_spec(lambda x, y, z: torch.special.i0e(x)),
    "i1e": lambda: _recorded_spec(lambda x, y, z: torch.special.i1e(x)),
    "user_select": lambda: _recorded_spec(_poly_select),
}


@pytest.fixture(scope="module")
def host_fields(tmp_path_factory):
    specs = {name: make() for name, make in _HOST_FIELDS.items()}
    return _field_library(specs, str(tmp_path_factory.mktemp("loops"))), specs


def _host_points(name):
    rng = np.random.default_rng(5)
    n = 1 << 12
    if name in ("series", "fraction"):
        a = rng.uniform(0.05, 40, n)
        x = a * rng.uniform(0.2, 3, n)
        a[:4], x[:4] = 1e8, 1e8 + np.arange(8, 12)  # the cap lanes
        a[4:8] = [np.nan, 1, -1, 3]
        x[4:8] = [1, np.nan, 2, 0]
        return np.stack([a, x, np.zeros(n)]).astype(F32)
    # both sides of 8 (i0e, i1e), of 1.5 (the user select)
    return np.stack([rng.uniform(-20, 20, n), rng.uniform(-2, 2, n),
                     rng.uniform(-2, 2, n)]).astype(F32)


@pytest.mark.parametrize("name", sorted(_HOST_FIELDS))
def test_host_build_is_bitwise_the_twin(host_fields, name):
    lib, specs = host_fields
    spec = specs[name]
    src = CG.field_c(spec, "f", 0)
    if name in ("series", "fraction"):
        assert "for (int it" in src and "break;" in src
    else:
        assert "if (" in src  # a branched arm
        assert len(RC.branched_arms(spec["prog"])) >= 1
    if name in ("i0e", "i1e"):
        assert "__fmaf_rn(" in src
    if name == "user_select":
        assert "__fmaf_rn(" not in src  # the user's a * b + c stays two
    got, want = _field_both(lib, name, spec, _host_points(name))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


_FMA_CASES = {}


def _fma_cases():
    rng = np.random.default_rng(8)
    n = 1 << 12
    a = rng.uniform(-10, 10, n).astype(F32)
    b = rng.uniform(-10, 10, n).astype(F32)
    _FMA_CASES["cancellation"] = (a, b, (-(a.astype(np.float64) * b)).astype(
        F32))
    a = rng.integers(1, 1 << 12, n).astype(F32)
    b = (rng.integers(1, 1 << 12, n) * 2.0 ** -12 + 1).astype(F32)
    c = (2.0 ** -26 * rng.choice([-1, 1, 0.5, -0.5, 3], n)).astype(F32)
    _FMA_CASES["midpoints"] = (a, b, c)
    _FMA_CASES["subnormal"] = (
        (rng.uniform(-1, 1, n) * 1e-20).astype(F32),
        (rng.uniform(-1, 1, n) * 1e-20).astype(F32),
        (rng.uniform(-1, 1, n) * 1e-39).astype(F32))
    sp = np.array([3e38, -3e38, np.inf, 0.0, np.nan, -np.inf, 1e30, -0.0,
                   1e-45, -1.0], F32)
    _FMA_CASES["overflow-inf-nan"] = (
        np.repeat(sp, 10), np.tile(sp, 10),
        np.tile(np.array([0, -0.0, np.inf, -np.inf, np.nan, 1, -3e38,
                          1e-45, -1e-45, 5], F32), 10))
    return sorted(_FMA_CASES)


@pytest.mark.parametrize("case", _fma_cases())
def test_fma_twin_is_fmaf_and_the_host_build(case, tmp_path):
    a, b, c = _FMA_CASES[case]
    libm = ctypes.CDLL("libm.so.6")
    libm.fmaf.restype = ctypes.c_float
    libm.fmaf.argtypes = [ctypes.c_float] * 3
    twin = RC.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([libm.fmaf(*v) for v in zip(a, b, c)], F32)
    assert np.array_equal(twin.view(np.int32), want.view(np.int32)) or (
        np.array_equal(np.isnan(twin), np.isnan(want)) and np.array_equal(
            twin[~np.isnan(twin)].view(np.int32),
            want[~np.isnan(want)].view(np.int32)))
    # the generated C of a field a b + c
    prog = RC.Program(((RC.U_LD, 0, 0, 0, 0, False),
                       (RC.U_LD, 1, 0, 0, 1, False),
                       (RC.U_LD, 2, 0, 0, 2, False),
                       (RC.U_FMA, 3, 0, 1, 2, False),
                       (RC.U_ST, 0, 3, 0, 0, False)), 4, 0)
    from physicl_tpu_torch.ops import fields as FL

    spec = FL.expr_field(prog, ("r0", "r1", "r2"), "fma").spec
    lib = _field_library({"fma": spec}, str(tmp_path))
    got, want = _field_both(lib, "fma", spec, np.stack([a, b, c]))
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all()
    assert np.array_equal(np.isnan(got[0]), np.isnan(twin))


# -- libm calls of constants ------------------------------------------------------

_CONST_CASES = {
    "log-pi": lambda E: E * torch.log(torch.full_like(E, np.pi)),
    "exp-lgamma": lambda E: E + torch.exp(torch.lgamma(torch.full_like(
        E, 3.0))),
    "pow-atan2": lambda E: E * torch.pow(torch.full_like(E, 2.5), 1.7)
    + torch.atan2(torch.full_like(E, -1.0), torch.full_like(E, -0.5)),
    "erfc-overflow": lambda E: E * torch.erfc(torch.full_like(E, 4.0))
    + torch.exp(torch.full_like(E, 100.0)) * 0.0,
    "sin-large": lambda E: E - torch.sin(torch.full_like(E, 1e30)),
}
# the libm calls in the generated C: name(args), every argument a literal
_LIT = r"(?:\(?-?0x[0-9a-f.]+p[+-]\d+f\)?|__int_as_float\(0x[0-9a-f]+\))"
_CONST_CALL = re.compile(r"\b(?:expf|logf|log10f|sinf|cosf|tanf|powf|atanf|"
                         r"asinf|acosf|sinhf|coshf|tanhf|asinhf|acoshf|"
                         r"atanhf|exp2f|expm1f|log2f|log1pf|erff|erfcf|"
                         r"lgammaf|atan2f)\(" + _LIT + r"(?:, " + _LIT
                         + r")?\)")


@pytest.mark.parametrize("case", sorted(_CONST_CASES))
def test_libm_of_constants_is_folded(case, tmp_path):
    fn = _CONST_CASES[case]
    prog = RC.record_particle_fn(lambda p: {"E": fn(p.E)}, "ElementwiseStep")
    codes = {ins[0] for ins in prog.ins}
    assert not codes & RC._LIBM_FOLD, codes
    src = CG.program_c(prog, "prog_c")
    assert not _CONST_CALL.search(src)
    lib = _host_library({"c": prog}, str(tmp_path))
    planes, alive = _inputs(3)
    got = _run_host(lib, "c", planes, alive)[0]
    want = _run_twin(prog, planes, alive)[0]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_fold_is_correctly_rounded():
    import mpmath

    rng = np.random.default_rng(2)
    for code, lo, hi in ((RC.U_EXP, -100, 88), (RC.U_LOG, 1e-30, 1e30),
                         (RC.U_SIN, -1e4, 1e4), (RC.U_LGAMMA, -20, 40),
                         (RC.U_ERFC, -3, 9), (RC.U_ATANH, -1, 1)):
        for x in rng.uniform(lo, hi, 300).astype(F32):
            got = RC.fold_libm(code, [float(x)])
            v = RC._mp_libm(code, [float(x)])
            assert v is not None
            with mpmath.workdps(100):
                want = RC._round_exact(v, float(v), RC.F32)
            assert got == want or (np.isnan(got) and np.isnan(want))
    # special values as C99 gives them; float64 from 100 digits
    assert RC.fold_libm(RC.U_LOG, [0.0]) == -np.inf
    assert np.isnan(RC.fold_libm(RC.U_LOG, [-1.0]))
    assert RC.fold_libm(RC.U_EXP, [100.0]) == np.inf
    assert RC.fold_libm(RC.U_LGAMMA, [0.0]) == np.inf
    assert RC.fold_libm(RC.U_LOG, [np.pi], RC.F64) == float(
        mpmath.log(mpmath.mpf(np.pi)))


def test_string_field_folds_constant_calls():
    from physicl_tpu_torch.ops import fields as FL

    spec = FL.compile_expr("exp(2.0) * r0[gid] + log(10.0)",
                           ("r0", "r1", "r2"), "n").spec
    codes = {ins[0] for ins in spec["prog"].ins}
    assert not codes & RC._LIBM_FOLD
    assert not _CONST_CALL.search(CG.field_c(spec, "f", 0))


# -- through Simulation, against the JAX package -----------------------------------

DT = 1e-3


def _math_h_cephes(order):
    """The coefficients and constants of ``bessel_j<order>_forward`` read
    from the installed torch's ``ATen/native/Math.h``: a source of Cephes'
    j0 / j1 independent of ``ops/record.py``'s tables."""
    import os

    path = os.path.join(os.path.dirname(torch.__file__), "include", "ATen",
                        "native", "Math.h")
    text = open(path).read()
    name = f"bessel_j{order}_forward"
    body = text[text.index(f"T {name}(T x) {{"):text.index(f"}} // {name}")]
    num = r"([-+]?[0-9.]+(?:e[-+]?[0-9]+)?)"
    k = {m[1]: [float(v) for v in m[2].replace(",", " ").split()]
         for m in re.finditer(r"static const T (\w+)\[\] = \{([^}]*)\}",
                              body)}
    k["zeros"] = [float(v) for v in re.findall(r"x \* x - T\(" + num
                                                + r"\)", body)]
    k["shift"] = float(re.search(r"cos\(x - T\(" + num, body)[1])
    k["sq2opi"] = float(re.search(r"\) \* T\(" + num
                                  + r"\) / std::sqrt", body)[1])
    assert len(k["zeros"]) == 2 and all(len(k[n]) for n in (
        "PP", "PQ", "QP", "QQ", "RP", "RQ"))
    return k


def _cephes_j(x, order):
    """Cephes' j0 / j1 in jnp, in torch's order, from the coefficients
    ``_math_h_cephes`` reads, for the JAX package's side where jnp's
    ``bessel_jn`` has not converged (below 3.5 and past 30)."""
    k = _math_h_cephes(order)

    def poly(cs, v):
        y = jnp.zeros_like(v)
        for cc in cs:
            y = y * v + cc
        return y

    xa = jnp.abs(x)
    z = xa * xa
    r1, r2 = k["zeros"]
    if order == 0:
        near = jnp.where(xa < 1e-5, 1.0 - z / 4.0, (z - r1) * (z - r2)
                         * poly(k["RP"], z) / poly(k["RQ"], z))
        w = 25.0 / z
    else:
        near = poly(k["RP"], z) / poly(k["RQ"], z) * xa * (z - r1) * (
            z - r2)
        w = 5.0 / xa * (5.0 / xa)
    xn = xa - k["shift"]
    far = (poly(k["PP"], w) / poly(k["PQ"], w) * jnp.cos(xn)
           - 5.0 / xa * (poly(k["QP"], w) / poly(k["QQ"], w))
           * jnp.sin(xn)) * k["sq2opi"] / jnp.sqrt(xa)
    out = jnp.where(xa <= 5.0, near, far)
    return out if order == 0 else jnp.where(x < 0, -out, out)


def _fns(P):
    """The four functions of a particle's E in package P: gammainc(3, 2E),
    gammaincc(2.5, 4E), j0(12E), j1(9E); E stays within [0.45, 2.2], so
    the Bessel arguments lie in [3.5, 30), where jnp's ``bessel_jn`` has
    converged."""
    if P is T:
        return (lambda E: torch.special.gammainc(torch.full_like(E, 3.0),
                                                 2.0 * E),
                lambda E: torch.special.gammaincc(torch.full_like(E, 2.5),
                                                  4.0 * E),
                lambda E: torch.special.bessel_j0(12.0 * E),
                lambda E: torch.special.bessel_j1(9.0 * E))
    return (lambda E: jsp.gammainc(3.0, 2.0 * E),
            lambda E: jsp.gammaincc(2.5, 4.0 * E),
            lambda E: jsp.bessel_jn(12.0 * E, v=0)[0],
            lambda E: jsp.bessel_jn(9.0 * E, v=1)[1])


def _photons(P, n, seed, extras=None):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    c = float(P.light.c)
    bulk = P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n), r=rng.normal(size=(3, n)) * 30 * c * DT,
        v=d / np.linalg.norm(d, axis=0) * c)
    if extras:
        bulk["extras"] = extras
    return bulk


def _fused_run(P, kind, n=1 << 10, iters=24):
    """A Simulation in which the four functions enter as ``kind``: an
    ElementwiseStep writing their weighted sum into a dose plane, a
    ReduceMeasureStep of each, a KernelStep scaling E by a weight near 1,
    or the absorption A(E) of a ScatterDeleteStep."""
    L = P.light
    c = float(L.c)
    fns = _fns(P)
    kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
    s = P.Simulation(until_t=DT * iters * 0.9999, seed=5, chunk_steps=8,
                     **kw)
    steps = [P.UpdateTimeStep(lambda st: np.double(DT)),
             P.newton.NewtonianKinematicsStep(),
             L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0)]
    measures = []
    extras = None
    if kind == "elementwise":
        def dose(p):
            return {"dose": p.extras["dose"] + sum(
                (k + 1.0) * f(p.E) for k, f in enumerate(fns))}

        steps.append(P.ElementwiseStep(dose, extras_write=("dose",)))
        extras = {"dose": np.zeros(n, np.float32)}
    elif kind == "reduce":
        red = P.ReduceMeasureStep(None, lambda p: {
            f"f{k}": f(p.E) for k, f in enumerate(fns)},
            outputs=tuple(f"f{k}" for k in range(4)), measure_n=True)
        steps.append(red)
        measures.append(red)
    elif kind == "kernelstep":
        KS = TKernelStep if P is T else JKernelStep

        def scale(st, ctx):
            w = 1.0 + 1e-3 * sum(f(st.E) for f in fns)
            return st.replace(E=st.E * w)

        steps.append(KS(scale, elementwise=True))
    else:  # a recorded field: A(E) of an absorber
        def A_fn(E):
            return (1.0 + fns[0](E) + fns[1](E) + fns[2](E) * fns[3](E)) \
                * 0.01 / (c * DT)

        steps.append(L.ScatterDeleteStep(n=1.0, A=1.0, A_fn=A_fn))
    sign = L.ScatterSignMeasureStep(None, True)
    steps.append(sign)
    measures.append(sign)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    s.add_photons(_photons(P, n, 3, extras))
    s.start()
    s.join()
    assert s.used_fused, f"{P.__name__} {kind}: not fused"
    return s, [np.asarray(m.data, np.float64) for m in measures]


@pytest.mark.parametrize("kind", ["elementwise", "reduce", "kernelstep",
                                  "field"])
def test_functions_fuse_and_match_jax(kind):
    ts, trows = _fused_run(T, kind)
    js, jrows = _fused_run(J, kind)
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    for tr, jr in zip(trows, jrows):
        assert tr.shape == jr.shape
        np.testing.assert_array_equal(tr[:, :2], jr[:, :2])  # t, counts
        np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)
    st_t, st_j = ts.sim_state, js.sim_state
    assert np.array_equal(st_t.alive.numpy(), np.asarray(st_j.alive))
    if kind in ("elementwise", "kernelstep"):
        # the photons' slots (jnp's bessel_jn is NaN at a padding slot's
        # E = 0)
        live = st_t.alive.numpy()
        a = (st_t.extras["dose"] if kind == "elementwise"
             else st_t.E).numpy()[live]
        b = np.asarray(st_j.extras["dose"] if kind == "elementwise"
                       else st_j.E)[live]
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# each function alone, in each place: the plan fuses on the CPU and the
# twin's records equal the eager torch function's sums
@pytest.mark.parametrize("place", ["elementwise", "reduce", "kernelstep",
                                   "field"])
@pytest.mark.parametrize("fn", ["gammainc", "gammaincc", "bessel_j0",
                                "bessel_j1"])
def test_each_function_fuses(fn, place):
    k = ("gammainc", "gammaincc", "bessel_j0", "bessel_j1").index(fn)
    f = _fns(T)[k]
    if place == "field":
        field = RC.record_field(lambda E: f(E), ("E",), "A_fn")
        E = torch.linspace(0.5, 2.0, 257)
        assert np.abs(field(E).numpy() - f(E).numpy()).max() <= 2e-6
        return
    if place == "kernelstep":
        prog = RC.record_kernelstep(lambda st, ctx: st.replace(E=f(st.E)))
    else:
        prog = RC.record_particle_fn(
            lambda p: {"E": f(p.E)}, "ElementwiseStep") \
            if place == "elementwise" else RC.record_particle_fn(
                lambda p: {"x": f(p.E)}, "ReduceMeasureStep", outputs=("x",))
    n = 512
    E = torch.linspace(0.5, 2.0, n)
    planes = [torch.zeros(n) for _ in range(16)]
    planes[12], planes[13], planes[14] = E.clone(), torch.ones(n), \
        torch.ones(n)

    class _Rng:
        idx = 0

    row = torch.zeros(4)
    RC.run_user_program(prog, planes, torch.ones(n, dtype=torch.bool),
                        torch.zeros(()), torch.full((), DT), _Rng(), row)
    got = row[0] if place == "reduce" else planes[12]
    want = f(E).sum() if place == "reduce" else f(E)
    assert float((got - want).abs().max()) <= 2e-6 * (n if place == "reduce"
                                                      else 1)


def _aperture_steps(P, c_dt):
    """``chip_smoke.py``'s aperture path in package P (its functions in jnp
    for the JAX package: Cephes' j0 / j1, jnp's incomplete gammas)."""
    import chip_smoke as cs

    L = P.light
    if P is T:
        return cs.aperture_steps(P, c_dt)
    c = float(L.c)

    def pinhole(p):
        x = cs.AP_XMAX * jnp.sqrt(p.vx * p.vx + p.vy * p.vy) / c
        airy = jnp.where(x > 0, (2.0 * _cephes_j(x, 1) / x) ** 2, 1.0)
        lam = cs.AP_GAIN * p.E
        return {"airy": airy, "pdet": jsp.gammainc(cs.AP_K, lam),
                "pmiss": jsp.gammaincc(cs.AP_K, lam)}

    def tally(p):
        x = cs.AP_XMAX * jnp.sqrt(p.vx * p.vx + p.vy * p.vy) / c
        return {"airy": p.extras["airy"], "pdet": p.extras["pdet"],
                "pmiss": p.extras["pmiss"], "j0sq": _cephes_j(x, 0) ** 2}

    red = P.ReduceMeasureStep(None, tally, outputs=cs.AP_OUTPUTS,
                              measure_n=True, extras=cs.AP_EXTRAS)
    return [P.UpdateTimeStep(lambda s: np.double(DT)),
            P.newton.NewtonianKinematicsStep(),
            L.ScatterIsotropicStep(A=np.double(1e-3), n=np.double(1e-3)),
            L.ScatterSignMeasureStep(None, True),
            P.ElementwiseStep(pinhole, extras_write=cs.AP_EXTRAS), red], red


def _aperture_run(P, n=1 << 12, iters=64):
    c_dt = float(P.light.c) * DT
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=(iters - 0.5) * DT, seed=4, chunk_steps=32,
                     auto_shrink=False, **kw)
    steps, red = _aperture_steps(P, c_dt)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(9)
    d = rng.normal(size=(3, n))
    bulk = P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n),
        r=rng.normal(size=(3, n)) * 100 * c_dt,
        v=d / np.linalg.norm(d, axis=0) * float(P.light.c))
    bulk["extras"] = {k: np.zeros(n, F32) for k in ("airy", "pdet",
                                                     "pmiss")}
    s.add_photons(bulk)
    s.start()
    s.join()
    assert s.used_fused, s.explain_plan()
    return s, np.asarray(red.data, np.float64)


def test_aperture_path_matches_jax():
    ts, trow = _aperture_run(T)
    js, jrow = _aperture_run(J)
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    np.testing.assert_array_equal(trow[:, :2], jrow[:, :2])  # t, n
    scale = np.abs(jrow[:, 2:]).max(axis=0)
    assert (np.abs(trow[:, 2:] - jrow[:, 2:]) <= 1e-5 * scale).all()
    # pdet + pmiss = 1 a photon; the last row against scipy in float64
    x = ts.sim_state.extras
    assert float((x["pdet"] + x["pmiss"] - 1.0).abs().max()) <= 2e-6
    import chip_smoke as cs

    st = ts.sim_state
    want = cs.aperture_truth(st.v.numpy(), st.E.numpy(), st.alive.numpy(),
                             float(T.light.c))
    n = trow[-1, 1]
    assert np.abs(trow[-1, 2:] - want).max() <= 1e-5 * n


# -- the bound's lane counts ---------------------------------------------------


def test_lane_weights_count_an_early_window_once():
    """The twin's lane counts (``RC.lane_tally``: a program's runs in
    order) over the first 4 of 8 iterations, stood for all 8 by
    ``chip_smoke.lane_weights``, equal those over all 8, where the first
    iteration's lanes run the series at a near 200 and the others at a near
    2; the first 4 iterations' mean alone counts the long series more than
    once."""
    import chip_smoke as cs

    n = 256
    s = T.Simulation(until_t=DT * 7.5, seed=2, chunk_steps=8, device="cpu",
                     auto_shrink=False)

    def dose(p):
        a = torch.where(p.t < 1.5 * DT, 200.0 + p.E, 2.0 + p.E)
        return {"dose": p.extras["dose"] + torch.special.gammainc(a, 0.9 * a)}

    s.add_step(0, T.UpdateTimeStep(lambda st: np.double(DT)))
    s.add_step(1, T.ElementwiseStep(dose, extras_write=("dose",)))
    s.add_photons(_photons(T, n, 6, {"dose": np.zeros(n, F32)}))
    RC.lane_tally = {}
    try:
        s.start()
        s.join()
        tally = RC.lane_tally
    finally:
        RC.lane_tally = None
    assert s.used_fused and len(tally) == 1
    (key, runs), = tally.items()
    assert len(runs) == 8
    whole = cs.lane_weights(tally)[key]
    first = {key: runs[:4]}
    np.testing.assert_allclose(cs.lane_weights(first, 8 / 4)[key], whole,
                               rtol=1e-12)
    assert max(cs.lane_weights(first)[key]) > 1.2 * max(whole)


# -- shared loops and the block phase -------------------------------------------


def _n_loops(prog):
    return sum(1 for ins in prog.ins if ins[0] == RC.U_LOOP)


def _igamma_field(fn):
    return RC.record_field(fn, ("a", "b", "c"), "igamma").spec["prog"]


_LOWER = _igamma_field(lambda a, x, c: torch.special.gammainc(a, x))
_UPPER = _igamma_field(lambda a, x, c: torch.special.gammaincc(a, x))
_PAIR = RC.record_field(lambda a, x, c: (torch.special.gammainc(a, x),
                                         torch.special.gammaincc(a, x), c),
                        ("a", "b", "c"), "pair", ncomp=3)
_SHARED = {**_IGAMMA,
           # x == a exactly: below 1 both functions' series, at or above 1
           # the lower one's series and the upper one's continued fraction
           "x-equals-a-below-1": ((a := _RNG.uniform(0.01, 1, _N)), a),
           "x-equals-a-above-1": ((a := np.r_[1.0, _RNG.uniform(1, 60, _N)]),
                                  a)}


def test_shared_operands_record_two_loops():
    """gammainc and gammaincc of the same operands record two loops (one
    series, one continued fraction), where each alone records both: four
    apart. Neither reads the other's result, so they follow one another in
    one block phase."""
    pair = _PAIR.spec["prog"]
    assert _n_loops(_LOWER) == _n_loops(_UPPER) == 2
    assert _n_loops(pair) == 2
    caps = sorted(ins[4] for ins in pair.ins if ins[0] == RC.U_LOOP)
    assert caps == [RC._CF_CAP, RC._SERIES_CAP]
    assert [[len(p.carried) for p in ph]
            for ph in RC.loop_phases(pair)] == [[10, 4]]
    # only the sums are read after the loops: the items write back one
    # value each
    assert [[len(p.results) for p in ph]
            for ph in RC.loop_phases(pair)] == [[1, 1]]


@pytest.mark.parametrize("case", sorted(_SHARED))
def test_shared_loops_are_bitwise_the_single_functions(case):
    """The shared loops' twin gives each function's value bit for bit as
    the program of that function alone, and within ``_igamma_tol`` of
    ``jax.scipy.special``."""
    a, x = (np.asarray(v, F32) for v in _SHARED[case])
    ta, tx = torch.from_numpy(a), torch.from_numpy(x)
    lo, up, _ = _PAIR(ta, tx, tx)
    for got, prog, j_fn in ((lo, _LOWER, jsp.gammainc),
                            (up, _UPPER, jsp.gammaincc)):
        alone = RC.run_field(prog, [ta, tx, tx])
        assert np.array_equal(got.numpy().view(np.int32),
                              alone.numpy().view(np.int32))
        want = np.asarray(j_fn(jnp.asarray(a), jnp.asarray(x)), np.float64)
        _close(got.numpy(), want, _igamma_tol(a.astype(np.float64),
                                              x.astype(np.float64)))


def _lo(a, x):
    return torch.special.gammainc(a, x)


def _up(a, x):
    return torch.special.gammaincc(a, x)


# each case: the two values of planes (a, x, y) through the functions
# (lo, up), the loops they record and their block phases
_APART = {
    "same": (lambda a, x, y, lo, up: (lo(a, x), up(a, x)), 2, 1),
    "cap": (lambda a, x, y, lo, up: (lo(a, x), a), 2, 1),
    "body-operand": (lambda a, x, y, lo, up: (lo(a, x), up(a, y)), 4, 1),
    "init": (lambda a, x, y, lo, up: (lo(a, x), up(y, x)), 4, 1),
    "enable-reads-the-other": (
        lambda a, x, y, lo, up: (lo(a, x), up(a, x * lo(a, x))), 4, 2),
}


@pytest.mark.parametrize("case", list(_APART))
def test_loops_that_differ_stay_apart(case):
    """gammainc and gammaincc share loops only on the same operands: loops
    that differ in the cap (a function's series and continued fraction), in
    an operand their bodies read (x), in an initial value (a, the series'
    r) or whose enable reads the other's result (a later block phase) stay
    apart; shared or not, each value is bit for bit the one of the
    functions recorded alone."""
    fn, loops, phases = _APART[case]
    field = RC.record_field(lambda a, x, y: (*fn(a, x, y, _lo, _up), y),
                            ("a", "b", "c"), case, ncomp=3)
    prog = field.spec["prog"]
    assert (_n_loops(prog), len(RC.loop_phases(prog))) == (loops, phases)
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 20.0, 1 << 10)
    x = a * rng.uniform(0.2, 3.0, a.size)
    x[::9] = a[::9]
    ta, tx, ty = (torch.from_numpy(v.astype(F32))
                  for v in (a, x, rng.uniform(0.5, 20.0, a.size)))
    got = field(ta, tx, ty)[:2]
    want = fn(ta, tx, ty, lambda a, x: RC.run_field(_LOWER, [a, x, x]),
              lambda a, x: RC.run_field(_UPPER, [a, x, x]))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              w.numpy().view(np.int32))


def test_block_phase_in_a_1i_program_not_in_a_field():
    """A kernel 1i program's loops run as a block phase (the enables
    placed, the items run by the block's threads between two barriers, a
    third before the next phase); a
    field program's keep the per-lane loop (a field is called under
    per-lane branches, where a barrier would deadlock)."""
    spec = _PAIR.spec
    src = CG.program_c(spec["prog"], "p")
    assert src.count("phase_place<2>(") == 1
    assert src.count("__syncthreads();") == 3
    assert "for (int ph_q = threadIdx.x;" in src
    field = CG.field_c(spec, "f", 0)
    assert "phase_" not in field and "__syncthreads" not in field
    assert field.count("for (int it") == 2 and "break;" in field


def _phase_planes(n):
    """(23, n) planes for the pair program (a in plane 12, x in plane 0),
    one kind a block of 256 slots: the lanes split between the series and
    the continued fraction; every lane in both shared loops (x == a >= 1);
    no lane enabled (a < 0); x == a below 1 and NaN."""
    rng = np.random.default_rng(17)
    p = rng.uniform(0.1, 3.0, (23, n)).astype(F32)
    kind = (np.arange(n) // 256) % 4
    a = rng.uniform(1.0, 20.0, n)
    x = np.where(rng.uniform(size=n) < 0.5, a * 0.5, (a + 1) * 2.0)
    x = np.where(kind == 1, a, x)
    a = np.where(kind == 2, -a, a)
    a = np.where(kind == 3, rng.uniform(0.01, 1.0, n), a)
    x = np.where(kind == 3, a, x)
    a[3::97] = np.nan
    p[12], p[0] = a, x
    alive = rng.uniform(size=n) < 0.8
    p[13] = alive
    return p, alive


def _pair_program():
    """The lower and upper incomplete gammas' loops of (a, x) = (plane 12,
    plane 0) as ``record._igamma`` switches and shares them, with ``ax`` =
    1 (no libm call: glibc's and torch's may differ by an ulp), stored in
    planes 15 and 16: a kernel 1i program with two shared loops."""
    s = RC._SSA()
    c = s.const
    a, x = s.val(RC.U_LD, (), 12), s.val(RC.U_LD, (), 0)
    ok = s.op(RC.U_AND, s.op(RC.U_GT, a, c(0.0)), s.op(RC.U_GT, x, c(0.0)))
    lower_cf = s.op(RC.U_AND, s.op(RC.U_GE, x, c(1.0)), s.op(RC.U_GT, x, a))
    upper_ser = s.op(RC.U_OR, s.op(RC.U_LT, x, c(1.0)), s.op(RC.U_LT, x, a))
    on = lambda p: s.op(RC.U_AND, ok, p)  # noqa: E731
    (cf_lo, ser_lo), (cf_up, ser_up) = RC._igamma_sums(
        s, a, x, (on(lower_cf), on(s.op(RC.U_NOT, upper_ser))),
        (on(s.op(RC.U_NOT, lower_cf)), on(upper_ser)))
    one = c(1.0)
    lo = s.op(RC.U_SEL, lower_cf, s.op(RC.U_SUB, one, cf_lo),
              s.op(RC.U_DIV, ser_lo, a))
    up = s.op(RC.U_SEL, upper_ser, s.op(RC.U_SUB, one, s.op(
        RC.U_DIV, ser_up, a)), cf_up)
    s.effects += [(RC.U_ST, lo, 15), (RC.U_ST, up, 16)]
    return RC._schedule(s, 0)


def test_block_phase_host_build_is_bitwise_the_twin(tmp_path):
    """The pair program's block phase built with g++ (the block's lanes as
    host threads, ``test_torch_codegen._HARNESS``) on 1000 slots (a tail
    block whose last 24 threads run on no slot): blocks whose lanes split
    between the two loops, sit in both, or in none, bitwise the twin."""
    prog = _pair_program()
    assert _n_loops(prog) == 2 and len(RC.loop_phases(prog)) == 1
    lib = _host_library({"pair": prog}, str(tmp_path))
    planes, alive = _phase_planes(1000)
    got, got_alive, _ = _run_host(lib, "pair", planes, alive)
    want, want_alive, _ = _run_twin(prog, planes, alive)
    assert np.array_equal(got_alive, want_alive)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _two_phase_program():
    """Two block phases of the lower function's loops (``ax`` = 1, as in
    :func:`_pair_program`): those of (a, x) and (y, 0.5), then, reading
    their results, those of (a r1, 2) and (y r2, 0.5), stored in planes 15
    and 16 (a in plane 12, x in 0, y in 1). The later phase stores no x (a
    constant is declared again), so it has one row fewer, and its warp
    counts take the earlier phase's last row: the result of (y, 0.5)'s
    series."""
    s = RC._SSA()
    c = s.const

    def lower(a, x):
        ok = s.op(RC.U_AND, s.op(RC.U_GT, a, c(0.0)),
                  s.op(RC.U_GT, x, c(0.0)))
        use_cf = s.op(RC.U_AND, s.op(RC.U_GE, x, c(1.0)),
                      s.op(RC.U_GT, x, a))
        on_cf = s.op(RC.U_AND, ok, use_cf)
        on_ser = s.op(RC.U_AND, ok, s.op(RC.U_NOT, use_cf))
        (cf, ser), _ = RC._igamma_sums(s, a, x, (on_cf, on_cf),
                                       (on_ser, on_ser))
        return s.op(RC.U_SEL, use_cf, s.op(RC.U_SUB, c(1.0), cf),
                    s.op(RC.U_DIV, ser, a))

    a, x, y = (s.val(RC.U_LD, (), k) for k in (12, 0, 1))
    r1, r2 = lower(a, x), lower(y, c(0.5))
    r3 = lower(s.op(RC.U_MUL, a, r1), c(2.0))
    r4 = lower(s.op(RC.U_MUL, y, r2), c(0.5))
    s.effects += [(RC.U_ST, s.op(RC.U_ADD, r1, r2), 15),
                  (RC.U_ST, s.op(RC.U_ADD, r3, r4), 16)]
    return RC._schedule(s, 0)


def test_two_block_phases_host_build_is_bitwise_the_twin(tmp_path):
    """A program of two block phases whose later one's warp counts take
    words of a result row of the earlier one (``chip_smoke.phase_hazards``:
    the phase's closing barrier keeps them apart) built with g++ on 1000
    slots, bitwise the twin."""
    import chip_smoke as cs

    prog = _two_phase_program()
    assert [[len(p.carried) for p in ph] for ph in RC.loop_phases(prog)] \
        == [[10, 4, 10, 4]] * 2
    assert cs.phase_hazards(prog) == [(0, 28, 1)]
    lib = _host_library({"two": prog}, str(tmp_path))
    planes, alive = _phase_planes(1000)
    got, got_alive, _ = _run_host(lib, "two", planes, alive)
    want, want_alive, _ = _run_twin(prog, planes, alive)
    assert np.array_equal(got_alive, want_alive)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_warp_trip_tally_is_exact():
    """``record.warp_trips`` on a hand-built run of 600 lanes (two full
    blocks and one of 88; 19 warps): loop 0 takes 5 trips on lanes 0-27
    and 7 on lane 100, loop 1 2 on lanes 0-7 and 9 on lane 599. A lane a
    warp: loop 0's warps 0 and 3, loop 1's 0 and 18, 5 + 7 + 2 + 9. In one
    phase block 0's items are loop 0's 29 then loop 1's 8: the first warp
    holds 29 and 3 of them (7 + 2), the second 5 (2), and block 2's first
    warp the last lane (9); in two phases block 0's loops take a warp each
    (7, 2)."""
    C = 600
    t0 = torch.zeros(C, dtype=torch.int32)
    t1 = torch.zeros(C, dtype=torch.int32)
    t0[:28], t0[100] = 5, 7
    t1[:8], t1[599] = 2, 9
    assert RC.warp_trips([t0, t1], [[0, 1]]) == (172, 23, 20)
    assert RC.warp_trips([t0, t1], [[0], [1]]) == (172, 23, 18)


def test_twin_tallies_the_warp_trips():
    """The twin's ``warp_tally``: one entry a run of a program with loops,
    its lane trips the loops' enabled lanes summed over their iterations
    (``lane_tally``'s count), and the regrouped warps' trips at most the
    consecutive warps'."""
    prog = _pair_program()
    planes, alive = _phase_planes(1000)
    RC.lane_tally, RC.warp_tally = {}, {}
    try:
        _run_twin(prog, planes, alive)
        (runs,), (lanes,) = RC.warp_tally.values(), RC.lane_tally.values()
    finally:
        RC.lane_tally = RC.warp_tally = None
    (n, warps, lane, now, regrouped), = runs
    assert (n, warps) == (1000, 32)
    loops = [i for i, ins in enumerate(prog.ins) if ins[0] == RC.U_LOOP]
    assert lane == sum(lanes[0][1][i + 1] for i in loops)
    assert 0 < regrouped <= now
