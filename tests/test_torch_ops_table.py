"""Kernel 1i's and the field programs' instruction table, widened to jnp's
elementwise float32 functions (``physicl_tpu_torch/ops/record.py``), and
the field-string grammar widened to the Python operators jnp evaluates
(``physicl_tpu_torch/ops/fields.py``), on the CPU.

* One case per torch function the recorder now takes: the callable is
  recorded (``record.record_field``) and its program's plain version
  (``record.run_field``, the kernel's twin) is held against torch's own op
  and against the jnp function it stands for, on seeded inputs with ±0,
  ±inf, NaN and subnormals (and, for ``%``, ``//`` and ``fmod``, points
  one ulp either side of multiples of the divisor). NaN where the
  reference has NaN, inf where it has inf, and elsewhere ``|got - want|
  <= atol + rtol |want|`` with the tolerances stated per op in
  ``_OPS``: libm functions within XLA's CPU polynomials (a few 1e-7
  relative; lgamma near its zeros and the sums that cancel absolutely),
  the exact ones (roundings, compares, selects, fmod and the remainder)
  equal. XLA's CPU flushes subnormals to zero, so subnormal inputs are
  held against torch only. Where the port follows jnp and torch's op
  differs (``sign`` and ``heaviside`` of NaN, ``xlogy(0, NaN)``,
  ``floor_divide`` by 0 or past 2**22, torch's own ``erfinv`` polynomial
  and ``ndtr`` form, torch's fused multiply-adds in ``lerp``,
  ``addcmul`` and ``add`` / ``sub`` with ``alpha``), the torch
  comparison skips those points or states its tolerance.
* Every op also records through the ``ElementwiseStep``,
  ``ReduceMeasureStep`` and ``KernelStep(elementwise=True)`` recorders;
  the ops left to port (``ROADMAP.md`` section 3) are refused there as
  ``*-op-unsupported``, naming the op.
* One case per string construct: the compiled field program against the
  JAX package's ``eval`` over jnp, bitwise (every construct is exact), and
  each construct the reference raises on raises the same exception.
* The lattice path of ``chip_smoke.py`` (a checkerboard density string, an
  absorber through ``-expm1`` and ``sigmoid`` of ``hypot``, azimuthal and
  energy observables through ``atan2``, ``erfc`` and ``tanh``) at 2**12
  photons x 64 iterations: the JAX package against the port, ``sim.ts``
  and the int records equal, each observable's sum (at most 1 a photon)
  within 1e-5 of the row's photon count, planes within 1e-4 of each
  plane's max.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.light import _compile_field_expr as j_field
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.ops import fields as FL
from physicl_tpu_torch.ops import record as RC

N = 1 << 14
SPECIAL = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5,
                      -0.5, 2.0, 3.0])
SUBNORMAL = np.float32([1e-40, -1e-40, 1.4e-45, -1.4e-45])
FLUSHED = 2e-38  # XLA's CPU flushes results below FLT_MIN to zero


def _inputs(domain, nargs, seed):
    """``nargs`` float32 arrays of one length: ``domain`` values from a
    numpy seed, then the specials and subnormals."""
    rng = np.random.default_rng(seed)

    def draw():
        if domain == "wide":  # both signs, 1e-9 to 5e8
            v = np.exp(rng.uniform(-20, 20, N)) * rng.choice([-1, 1], N)
        elif domain == "unit":
            v = rng.uniform(-1, 1, N)
        elif domain == "pos":
            v = np.exp(rng.uniform(-20, 20, N))
        elif domain == "ge1":
            v = 1 + np.exp(rng.uniform(-20, 10, N))
        elif domain == "prob":
            v = rng.uniform(0, 1, N)
        elif domain == "zeta":  # (x, q): x in (1, 20), q in (1e-3, 150)
            v = np.where(rng.random(N) < 0.5, 1 + np.exp(rng.uniform(
                -6, 3, N)), np.exp(rng.uniform(-7, 5, N)))
        elif domain == "ldexp":  # a mantissa, then an exponent
            v = rng.uniform(-10, 10, N) * np.exp2(rng.integers(-60, 60, N))
        else:  # "small"
            v = rng.uniform(-10, 10, N)
        return np.concatenate([v.astype(np.float32), SPECIAL, SUBNORMAL])

    if domain == "ldexp":
        return [draw(), np.concatenate([rng.integers(
            -300, 300, N).astype(np.float32), SPECIAL, SUBNORMAL])]
    if domain != "mod":
        return [draw() for _ in range(nargs)]
    # a multiple of the divisor, one ulp either side of it, or any value
    b = rng.choice(np.float32([2.0, -2.0, 0.05, 0.7, -0.3, 1e-3]), N)
    a = (rng.integers(-2000, 2000, N) * b).astype(np.float32)
    side = rng.integers(0, 3, N)
    a = np.where(side == 0, np.nextafter(a, np.float32(np.inf)),
                 np.where(side == 1, np.nextafter(a, np.float32(-np.inf)),
                          a))
    a = np.where(rng.random(N) < 0.3,
                 np.exp(rng.uniform(-20, 20, N)) * rng.choice([-1, 1], N),
                 a).astype(np.float32)
    sp = np.concatenate([SPECIAL, SUBNORMAL])
    return [np.concatenate([a, sp, sp]),
            np.concatenate([b.astype(np.float32), sp, sp[::-1]])]


def _lerp_jnp(a, b, w):
    """torch.lerp's formula (jnp has no lerp): from the start for |w| <
    0.5, else from the end."""
    return jnp.where(jnp.abs(w) < 0.5, a + w * (b - a),
                     b - (b - a) * (1 - w))


def _near_poles(a):
    """Where torch's digamma (its own algorithm) differs from XLA's by
    more than its tolerance: within 1e-3 of a pole (0 and the negative
    integers), and at -inf (torch NaN, XLA's reflection NaN too)."""
    with np.errstate(invalid="ignore"):
        return (a <= 0) & (np.abs(a - np.round(a)) < 1e-3)


def _off_domain(a):
    """Where torch's polygamma and zeta (their own algorithms) give
    another non-finite value than XLA's: at +-inf, the poles, and x <= 0
    for zeta (torch NaN at 0, XLA inf)."""
    return ~np.isfinite(a) | (a <= 0)


def _divide_skips(a, b):
    """Where torch's floor division differs from jnp's: a divisor of 0
    (torch a / b, jnp NaN) and quotients of 2**22 or more (jnp's (a -
    rem) / b rounds before its half-away rounding)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return (b == 0) | (np.abs(a.astype(np.float64) / b) >= 2 ** 22)


# name -> (torch callable, jnp callable, operands, domain,
#          (rtol, atol) against jnp, (rtol, atol) against torch,
#          points the torch comparison skips (the port follows jnp there))
_OPS = {
    # group A: one instruction each, a CUDA libm function
    "atan": (torch.atan, jnp.arctan, 1, "wide", (4e-7, 0), (0, 0), None),
    "asin": (torch.asin, jnp.arcsin, 1, "unit", (4e-7, 0), (0, 0), None),
    "acos": (torch.acos, jnp.arccos, 1, "unit", (4e-7, 0), (0, 0), None),
    "atan2": (torch.atan2, jnp.arctan2, 2, "wide", (4e-7, 0), (0, 0),
              None),
    "sinh": (torch.sinh, jnp.sinh, 1, "small", (1e-6, 0), (0, 0), None),
    "cosh": (torch.cosh, jnp.cosh, 1, "small", (1e-6, 0), (0, 0), None),
    "tanh": (torch.tanh, jnp.tanh, 1, "small", (6e-5, 0), (0, 0), None),
    "asinh": (torch.asinh, jnp.arcsinh, 1, "wide", (4e-7, 0), (0, 0),
              None),
    "acosh": (torch.acosh, jnp.arccosh, 1, "ge1", (6e-7, 0), (0, 0),
              None),
    "atanh": (torch.atanh, jnp.arctanh, 1, "unit", (6e-7, 0), (0, 0),
              None),
    "exp2": (torch.exp2, jnp.exp2, 1, "small", (6e-7, 0), (0, 0), None),
    "expm1": (torch.expm1, jnp.expm1, 1, "small", (6e-7, 1e-7), (0, 0),
              None),
    "log2": (torch.log2, jnp.log2, 1, "pos", (4e-7, 1e-7), (0, 0), None),
    "log1p": (torch.log1p, jnp.log1p, 1, "pos", (4e-7, 0), (0, 0), None),
    "erf": (torch.erf, jsp.erf, 1, "small", (6e-7, 0), (0, 0), None),
    "erfc": (torch.erfc, jsp.erfc, 1, "small", (4e-6, FLUSHED), (0, 0),
             None),
    "lgamma": (torch.lgamma, jsp.gammaln, 1, "small", (2e-6, 1e-5),
               (0, 0), None),
    "rsqrt": (torch.rsqrt, jax.lax.rsqrt, 1, "pos", (4e-7, 0), (2.5e-7, 0),
              None),
    "fmod": (torch.fmod, jnp.fmod, 2, "mod", (0, FLUSHED), (0, 0), None),
    "round": (torch.round, jnp.round, 1, "small", (0, 0), (0, 0), None),
    "copysign": (torch.copysign, jnp.copysign, 2, "wide", (0, 0), (0, 0),
                 None),
    "nextafter": (torch.nextafter, jnp.nextafter, 2, "wide", (0, FLUSHED),
                  (0, 0), None),
    "isnan": (torch.isnan, jnp.isnan, 1, "wide", (0, 0), (0, 0), None),
    "signbit": (torch.signbit, jnp.signbit, 1, "wide", (0, 0), (0, 0),
                None),
    # group A in the recorded program: XLA's erf_inv polynomial
    "erfinv": (torch.erfinv, jsp.erfinv, 1, "unit", (4e-7, 0), (1e-5, 0),
               None),
    # group B: lowered to the instructions, in the jnp function's order
    "remainder": (torch.remainder, jnp.remainder, 2, "mod", (0, FLUSHED),
                  (0, 0), None),
    "floor_divide": (torch.floor_divide, jnp.floor_divide, 2, "mod",
                     (0, 0), (0, 0),
                     _divide_skips),
    "div_floor": (lambda a, b: torch.div(a, b, rounding_mode="floor"),
                  jnp.floor_divide, 2, "mod", (0, 0), (0, 0),
                  _divide_skips),
    "div_trunc": (lambda a, b: torch.div(a, b, rounding_mode="trunc"),
                  lambda a, b: jnp.trunc(a / b), 2, "mod", (0, 0), (0, 0),
                  None),
    "sign": (torch.sign, jnp.sign, 1, "wide", (0, 0), (0, 0),
             lambda a: np.isnan(a)),
    "frac": (torch.frac, lambda a: a - jnp.trunc(a), 1, "wide", (0, 0),
             (0, 0), None),
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid, 1, "small", (4e-7, 0),
                (4e-7, 0), None),
    "relu": (torch.relu, jax.nn.relu, 1, "wide", (0, 0), (0, 0), None),
    "softplus": (Fn.softplus, jax.nn.softplus, 1, "small", (6e-7, 0),
                 (4e-7, 1e-6), None),
    "logaddexp": (torch.logaddexp, jnp.logaddexp, 2, "small", (4e-7, 2e-6),
                  (4e-7, 2e-6), None),
    "xlogy": (torch.xlogy, jsp.xlogy, 2, "wide", (4e-7, 0), (4e-7, 0),
              lambda a, b: (a == 0) & np.isnan(b)),
    "hypot": (torch.hypot, jnp.hypot, 2, "wide", (4e-7, 0), (4e-7, 0),
              None),
    "fmax": (torch.fmax, jnp.fmax, 2, "wide", (0, 0), (0, 0), None),
    "fmin": (torch.fmin, jnp.fmin, 2, "wide", (0, 0), (0, 0), None),
    "heaviside": (torch.heaviside, jnp.heaviside, 2, "wide", (0, 0), (0, 0),
                  lambda a, b: np.isnan(a)),
    "nan_to_num": (torch.nan_to_num, jnp.nan_to_num, 1, "wide", (0, 0),
                   (0, 0), None),
    "deg2rad": (torch.deg2rad, jnp.deg2rad, 1, "wide", (0, FLUSHED),
                (0, 0), None),
    "rad2deg": (torch.rad2deg, jnp.rad2deg, 1, "wide", (0, 0), (0, 0),
                None),
    "ndtr": (torch.special.ndtr, jsp.ndtr, 1, "small", (4e-6, FLUSHED),
             (4e-7, 1.2e-7), None),
    "sinc": (torch.sinc, jnp.sinc, 1, "small", (4e-7, 1e-7), (4e-7, 1e-7),
             None),
    "logit": (torch.logit, jsp.logit, 1, "unit", (4e-7, 0), (0, 0), None),
    "lerp": (torch.lerp, _lerp_jnp, 3, "small", (0, 0), (4e-7, 1e-5),
             None),
    "addcmul": (lambda a, b, c: torch.addcmul(a, b, c, value=0.5),
                lambda a, b, c: a + 0.5 * b * c, 3, "small", (0, 0),
                (4e-7, 1e-5), None),
    "addcdiv": (lambda a, b, c: torch.addcdiv(a, b, c, value=2.0),
                lambda a, b, c: a + 2.0 * b / c, 3, "small", (0, 0),
                (0, 0), None),
    "add_alpha": (lambda a, b: torch.add(a, b, alpha=2.5),
                  lambda a, b: a + 2.5 * b, 2, "small", (0, 0), (4e-7, 1e-5),
                  None),
    "sub_alpha": (lambda a, b: torch.sub(a, b, alpha=0.5),
                  lambda a, b: a - 0.5 * b, 2, "small", (0, 0),
                  (4e-7, 1e-5), None),
}
_OPS_C = {
    # group C: XLA's, jax.scipy.special's, jnp's and jax.nn's forms, in
    # their order (the same float32 algorithms: within a few ulp of jnp
    # where XLA's CPU libm calls differ from torch's, and torch's own
    # algorithms within their stated tolerances)
    "digamma": (torch.digamma, jsp.digamma, 1, "small", (4e-6, 2e-6),
                (5e-5, 2e-5), _near_poles),
    "polygamma1": (lambda a: torch.polygamma(1, a),
                   lambda a: jsp.polygamma(1, a), 1, "pos", (2e-6, 1e-6),
                   (4e-6, 1e-6), _off_domain),
    "polygamma3": (lambda a: torch.polygamma(3, a),
                   lambda a: jsp.polygamma(3, a), 1, "pos", (4e-6, 1e-6),
                   (4e-6, 1e-6), None),
    "zeta": (torch.special.zeta, jsp.zeta, 2, "zeta", (4e-6, 1e-30),
             (4e-6, 1e-30), lambda a, b: _off_domain(a) | (b <= 0)),
    "i0": (torch.special.i0, jsp.i0, 1, "small", (1e-6, 0), (1e-6, 0),
           None),
    "i0e": (torch.special.i0e, jsp.i0e, 1, "wide", (1e-6, 1e-7),
            (1e-6, 1e-7), None),
    "i1": (torch.special.i1, jsp.i1, 1, "small", (2e-6, 0), (2e-6, 1e-38),
           None),
    "i1e": (torch.special.i1e, jsp.i1e, 1, "wide", (2e-6, 1e-7),
            (2e-6, 1e-7), None),
    "modified_bessel_i0": (torch.special.modified_bessel_i0, jsp.i0, 1,
                           "small", (1e-6, 0), (2e-6, 0), None),
    "modified_bessel_i1": (torch.special.modified_bessel_i1, jsp.i1, 1,
                           "small", (2e-6, 0), (2e-6, 1e-38), None),
    "ndtri": (torch.special.ndtri, jsp.ndtri, 1, "prob", (1e-6, 1e-7),
              (1e-6, 1e-7), None),
    "log_ndtr": (torch.special.log_ndtr, jsp.log_ndtr, 1, "small",
                 (2e-6, 4e-7), (1e-6, 4e-7), None),
    "entr": (torch.special.entr, jsp.entr, 1, "wide", (4e-7, 2e-7),
             (4e-7, 2e-7), None),
    "mvlgamma": (lambda a: torch.mvlgamma(a + 3.0, 3),
                 lambda a: jsp.multigammaln(a + 3.0, 3), 1, "pos",
                 (4e-6, 1e-5), (4e-6, 1e-5), None),
    "logaddexp2": (torch.logaddexp2, jnp.logaddexp2, 2, "small",
                   (4e-7, 2e-6), (4e-7, 2e-6), None),
    "ldexp": (lambda a, b: torch.ldexp(a, b.int()),
              lambda a, b: jnp.ldexp(a, b.astype(jnp.int32)), 2, "ldexp",
              (0, FLUSHED), (0, 0), lambda a, b: ~np.isfinite(b)),
    "frexp_mantissa": (lambda a: torch.frexp(a)[0],
                       lambda a: jnp.frexp(a)[0], 1, "wide", (0, 0),
                       (0, 0), lambda a: ~np.isfinite(a)),
    "frexp_exponent": (lambda a: torch.frexp(a)[1].float(),
                       lambda a: jnp.frexp(a)[1].astype(jnp.float32), 1,
                       "wide", (0, 0), (0, 0), lambda a: ~np.isfinite(a)),
    "gelu": (Fn.gelu, lambda a: jax.nn.gelu(a, approximate=False), 1,
             "small", (4e-7, 2e-7), (4e-6, 2e-6), lambda a: a == np.inf),
    "gelu_tanh": (lambda a: Fn.gelu(a, approximate="tanh"),
                  lambda a: jax.nn.gelu(a, approximate=True), 1, "small",
                  (1e-6, 6e-7), (1e-6, 6e-7), None),
    "elu": (lambda a: Fn.elu(a, 0.7), lambda a: jax.nn.elu(a, 0.7), 1,
            "small", (4e-7, 1e-7), (4e-7, 1e-7), None),
    "logsigmoid": (Fn.logsigmoid, jax.nn.log_sigmoid, 1, "small",
                   (4e-7, 2e-7), (4e-7, 2e-7), None),
}
_ALL = {**_OPS, **_OPS_C}


def _seed(name):
    """Each op's input seed: groups A and B by their place in ``_OPS``,
    group C after them."""
    if name in _OPS:
        return sorted(_OPS).index(name)
    return len(_OPS) + sorted(_OPS_C).index(name)


def _close(got, want, rtol, atol, mask):
    """NaN where ``want`` has NaN, and within ``atol + rtol |want|``
    (inf equal) on ``mask``."""
    g, w = got[mask].astype(np.float64), want[mask].astype(np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    g, w = g[ok], w[ok]
    inf = np.isinf(w) | np.isinf(g)
    assert np.array_equal(g[inf], w[inf])
    err = np.abs(g[~inf] - w[~inf])
    bad = err > atol + rtol * np.abs(w[~inf])
    assert not bad.any(), (g[~inf][bad][:5], w[~inf][bad][:5])


@pytest.mark.parametrize("name", sorted(_ALL))
def test_op_twin_matches_torch_and_jnp(name):
    t_fn, j_fn, k, domain, tol_j, tol_t, skip_t = _ALL[name]
    xs = _inputs(domain, k, seed=_seed(name))
    if k == 3:  # lerp's weight, addcmul's and addcdiv's second factor
        xs[2] = np.concatenate([np.random.default_rng(1).uniform(
            -1, 2, N).astype(np.float32), SPECIAL, SUBNORMAL])
    names = ("a", "b", "c")[:k]
    fn = RC.record_field(t_fn, names, name)
    codes = {ins[0] for ins in fn.spec["prog"].ins}
    # every code of a program (U_OUT is the recorder's own, never one)
    assert codes and codes <= set(range(RC.U_OUT)), codes
    tx = [torch.from_numpy(x) for x in xs]
    got = fn(*tx).numpy().astype(np.float32)
    want_t = t_fn(*tx).numpy().astype(np.float32)
    want_j = np.asarray(j_fn(*[jnp.asarray(x) for x in xs]), np.float32)
    # subnormal operands or results: XLA's CPU flushes them to zero
    tiny = np.logical_or.reduce([(np.abs(x) < 1.2e-38) & (x != 0)
                                 for x in xs + [got]])
    _close(got, want_j, *tol_j, ~tiny)
    keep = np.ones_like(got, dtype=bool)
    if skip_t is not None:
        keep &= ~skip_t(*xs)
    _close(got, want_t, *tol_t, keep)


def _every_op():
    """One value of every op in ``_OPS`` of a particle's planes, summed,
    NaN turned to 0."""
    def fn(E, w, vx, vy):
        u = torch.tanh(vx) * 0.9  # in (-0.9, 0.9)
        pos = E + 1.0
        args = {"wide": (vx, vy, w), "unit": (u, u * 0.5, w),
                "pos": (pos, pos + 1.0, w), "ge1": (pos, vy, w),
                "small": (vx, vy, w), "mod": (vx, pos, w),
                "prob": (u * 0.5 + 0.5, w, w), "zeta": (pos + 1.0, pos, w),
                "ldexp": (vx, vy * 10, w)}
        total = 0.0
        for name, (t_fn, _, k, domain, *_) in _ALL.items():
            v = t_fn(*args[domain][:k])
            total = total + torch.nan_to_num(v.to(torch.float32))
        return total
    return fn


def test_every_op_records_in_each_user_recorder():
    """The user-code recorders take every op: an ElementwiseStep update,
    a ReduceMeasureStep output and a KernelStep(elementwise=True) map, each
    of one value that uses all of them; the ElementwiseStep program's twin
    equals the callable on the view's planes within 1e-5 of its scale."""
    every = _every_op()
    prog = RC.record_particle_fn(
        lambda p: {"dose": every(p.E, p.w, p.vx, p.vy)}, "ElementwiseStep",
        view_extras=(("dose", 15, 1),), writable=("dose",))
    n_codes = {ins[0] for ins in prog.ins}
    assert {RC.U_ATAN2, RC.U_ERF, RC.U_LGAMMA, RC.U_FMOD, RC.U_ROUND,
            RC.U_ISNAN, RC.U_SIGNBIT, RC.U_NEXTAFTER} <= n_codes
    RC.record_particle_fn(lambda p: {"x": every(p.E, p.w, p.vx, p.vy)},
                          "ReduceMeasureStep", outputs=("x",))
    RC.record_kernelstep(lambda s, ctx: s.replace(
        E=every(s.E, s.w, s.v[0], s.v[1])))
    rng = np.random.default_rng(3)
    C = 512
    planes = [torch.from_numpy(rng.uniform(-3, 3, C).astype(np.float32))
              for _ in range(16)]
    planes[12] = planes[12].abs() + 0.5  # E
    alive = torch.ones(C, dtype=torch.bool)

    class _Rng:
        idx = 0

    f = list(planes)
    RC.run_user_program(prog, f, alive, torch.tensor(0.0),
                        torch.tensor(1e-3), _Rng())
    want = every(planes[12], planes[14], planes[6], planes[7])
    scale = float(want.abs().max())
    assert float((f[15] - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("op,code", [
    (torch.special.erfcx, "special_erfcx"),
    (torch.special.bessel_y0, "special_bessel_y0"),
    (torch.special.modified_bessel_k0, "special_modified_bessel_k0"),
    (torch.special.scaled_modified_bessel_k1,
     "special_scaled_modified_bessel_k1"),
    (lambda x: (x > 0).int() // (x > 1).int(), "floor_divide"),
    (lambda x: torch.digamma(x.double()), "digamma in float64"),
])
def test_ops_left_to_port_are_refused_by_name(op, code):
    """The ops left with no instruction (ROADMAP.md section 3: a function
    jnp lacks, an integer floor division by a value that may be 0, a
    float32 form in float64) are refused as
    op-unsupported by every recorder, naming the op (the prover adds
    ``elementwise-``, ``reduce-`` or ``kernelstep-``)."""
    for record in (
            lambda: RC.record_particle_fn(lambda p: {"E": op(p.E) * 1.0},
                                          "ElementwiseStep"),
            lambda: RC.record_particle_fn(lambda p: {"x": op(p.E) * 1.0},
                                          "ReduceMeasureStep",
                                          outputs=("x",)),
            lambda: RC.record_kernelstep(lambda s, ctx: s.replace(
                E=op(s.E) * 1.0))):
        with pytest.raises(RC.Refused) as e:
            record()
        assert e.value.code == "op-unsupported"
        assert code in e.value.detail
    with pytest.raises(RC.Refused) as e:
        RC.record_field(lambda E: op(E) * 1.0, ("E",), "A_fn")
    assert e.value.code == "field-fn-callable" and code in e.value.detail


# -- the string grammar ----------------------------------------------------------

_CONSTRUCTS = {
    "modulo": "r0[gid] % 0.3",
    "modulo-negative-divisor": "r0[gid] % -0.7",
    "modulo-literal-dividend": "2 % (r0[gid] + 5.0)",
    "floor-divide": "r0[gid] // 0.05",
    "floor-divide-literal": "7 // (r1[gid] + 5.0)",
    "literal-modulo-fold": "-7 % 3 * r0[gid] + 7 // 2.0",
    "lt": "(r0[gid] < 0.1) * 2.0", "le": "(r0[gid] <= r1[gid]) * 2.0",
    "gt": "(r0[gid] > 0) * 2.0", "ge": "(r0[gid] >= -0.5) + 0.5",
    "eq": "(floor(r0[gid]) == 1.0) * 3.0", "ne": "(r2[gid] != 0.0) * 1.0",
    "and": "((r0[gid] > 0) & (r1[gid] < 0.5)) * 1.5",
    "or": "((r0[gid] > 0) | (r1[gid] < 0.5)) * 1.5",
    "xor": "((r0[gid] > 0) ^ (r1[gid] < 0.5)) * 1.5",
    "invert": "~(r0[gid] > 0) * 1.5",
    "true-false": "True * r0[gid] + False + ((r1[gid] > 0) ^ True)",
    "bool-sum-is-or": "(r0[gid] > 0) + (r1[gid] > 0)",
    "bool-product-is-and": "(r0[gid] > 0) * (r1[gid] > 0)",
    "bool-meets-int": "((r0[gid] > 0) * 3 - 1) % 2 + (r1[gid] < 0) // 2",
    "bool-power": "(r0[gid] > 0) ** 2 + r1[gid] ** (r2[gid] > 0)",
    "bool-function": "fabs(r0[gid] > 0) + fmin(r1[gid] > 0, r2[gid] > 0) "
                     "+ sqrt(r0[gid] > 0)",
    "and-or-literal": "(True and r0[gid]) + (0 or r1[gid])",
    "if-literal": "r0[gid] if 2 > 1 else r1[gid]",
    "checkerboard": "1e-3 * (1.0 + 0.5 * ((floor(r0[gid] / 0.05) + "
                    "floor(r1[gid] / 0.05)) % 2 == 0))",
    # int32 values (jnp's eval with x64 off): exact past 2**24, wrapping,
    # the bitwise ops, shifts at their edges, integer // and % by a
    # nonzero constant
    "int-and": "(((r0[gid] > 0) * 3) & 1) + 1.0",
    "int-or-xor": "(((r0[gid] > 0) * 5) | 2) ^ ((r1[gid] < 0) * 7)",
    "int-invert": "~((r0[gid] > 0) * 3) * 0.5",
    "int-bool-bitwise": "((r0[gid] > 0) & 6) + ((r1[gid] > 0) | 8)",
    "int-shifts": "(((r0[gid] > 0) + 1) << 30) + (((r1[gid] > 0) * -8) >> 1)"
                  " + ((r2[gid] > 0) << 31)",
    "int-shift-edges": "(((r0[gid] > 0) * 5) << 32) + (((r1[gid] > 0) * -5)"
                       " >> 40) + (((r2[gid] > 0) * 7) >> -1) + ((r0[gid] "
                       "< 0) << (r1[gid] > 0) * 31)",
    "int-past-2-24": "((r0[gid] > 0) * 16777217 + (r1[gid] > 0)) % 16 + 0.5",
    "int-wrap": "((r0[gid] > 0) * 2147483647 + (r1[gid] > -10)) >> 28",
    "int-floor-divide": "((r0[gid] > 0) * 2147483647 + (r1[gid] > 0) * 5) "
                        "// -3 + ((r2[gid] > 0) * -7) // 2",
    "int-floor-divide-minus-one": "((r0[gid] > 0) * -2147483647 - 1) // -1"
                                  " + ((r1[gid] > 0) * 9) % -4",
    "int-modulo-maybe-zero": "((r0[gid] > 0) * 7) % ((r1[gid] > 0) * 3)",
    "int-functions": "fabs((r0[gid] > 0) * -2147483647 - 1) + floor((r1["
                     "gid] > 0) * 3) + fmax((r2[gid] > 0) * 5, 2)",
    "int-compare": "((r0[gid] > 0) * 16777217 == 16777217) * 1.0 + (((r1["
                   "gid] > 0) * 3) < 2.5)",
    "int-power": "(((r0[gid] > 0) * 50000 + 1) ** 2) % 1000",
    "int-to-float": "((r0[gid] > 0) * 16777217 + 1) * 1.0 + (r1[gid] > 0) "
                    "* 16777217 / 2",
}

# constructs the reference's eval over jnp raises on, and its exception
_RAISING = {
    "chained-comparison": ("0 < r0[gid] < 1", ValueError),
    "if-array": ("r0[gid] if r1[gid] else r2[gid]", ValueError),
    "and-array": ("r0[gid] and True", ValueError),
    "not-array": ("not r0[gid]", ValueError),
    "neg-bool": ("-(r0[gid] > 0)", TypeError),
    "bool-minus-bool": ("(r0[gid] > 0) - (r1[gid] > 0)", TypeError),
    "invert-float": ("~r0[gid]", TypeError),
    "and-float": ("r0[gid] & r1[gid]", TypeError),
    "int-negative-power": ("(r0[gid] > 0) ** -1", TypeError),
    "int-literal-overflow": ("2**40 * r0[gid]", OverflowError),
    "literal-zero-division": ("1 % 0 + r0[gid]", ZeroDivisionError),
}


def _points(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.5, (3, n)).astype(np.float32)
    pts[0, :11] = SPECIAL
    pts[1, 11:22] = SPECIAL
    pts[0, 22:27] = np.float32([0.05, -0.05, 0.1, 0.3, -0.3])  # multiples
    return pts


@pytest.mark.parametrize("name", sorted(_CONSTRUCTS))
def test_string_construct_matches_jax(name):
    expr = _CONSTRUCTS[name]
    fn = FL.compile_expr(expr, ("r0", "r1", "r2"), "variable_n_fn")
    assert fn.spec["error"] is None
    pts = _points()
    got = fn(*[torch.from_numpy(p) for p in pts]).numpy()
    want = np.asarray(j_field(expr, ("r0", "r1", "r2"), "n")(
        *[jnp.asarray(p) for p in pts]), np.float32)
    np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))


@pytest.mark.parametrize("name", sorted(_RAISING))
def test_string_construct_raises_as_jax(name):
    """Raised when the field is called, by both packages alike; the
    port's prover raises it too (as the JAX kernel does when it traces the
    field), and the generic tier when it calls the field."""
    expr, exc = _RAISING[name]
    x = jnp.zeros(3, jnp.float32)
    with pytest.raises(exc):
        j_field(expr, ("r0", "r1", "r2"), "n")(x, x, x)
    fn = FL.compile_expr(expr, ("r0", "r1", "r2"), "variable_n_fn")
    assert fn.spec["raises"] is exc
    for fuse in ("auto", "off"):
        s = T.Simulation(until_t=0.0025, seed=0, device="cpu", fuse=fuse)
        s.add_step(0, T.UpdateTimeStep(lambda t: np.double(1e-3)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.light.ScatterIsotropicStep(
            A=1.0, variable_n=True, variable_n_fn=expr))
        s.add_photons(T.light.generate_photon_state(8, E=1.0))
        with pytest.raises(exc):
            s._run_impl()


# -- the lattice path ----------------------------------------------------------

DT = 1e-3
CELL = 50.0        # checkerboard cell, in c dt
R_AP, EPS = 200.0, 10.0   # the aperture's radius and edge, in c dt
SIGMA = 100.0      # the transverse observable's width, in c dt
MU = 2e-3          # absorption per c dt outside the aperture


def lattice_density(c_dt):
    """A checkerboard of rods along z (the density n of A = 1e-3: n =
    1e-3 or 1.5e-3), cells of CELL c dt."""
    cell = CELL * c_dt
    return (f"1e-3 * (1.0 + 0.5 * ((floor(r0[gid] / {cell!r}) + "
            f"floor(r1[gid] / {cell!r})) % 2 == 0))")


def lattice_steps(P, xp, c):
    """The lattice path's steps after the clock and the kinematics: the
    checkerboard scatter, the absorber (kill with probability -expm1(-mu
    |v| dt) outside a soft aperture, sigmoid((R - hypot(rx, ry)) / eps)),
    the observables and the sign tally."""
    c_dt = c * DT
    mu = MU / c_dt
    R, eps, sigma = R_AP * c_dt, EPS * c_dt, SIGMA * c_dt
    hypot = torch.hypot if xp is torch else jnp.hypot
    sigmoid = torch.sigmoid if xp is torch else jax.nn.sigmoid
    erfc = torch.erfc if xp is torch else jsp.erfc
    atan2 = torch.atan2 if xp is torch else jnp.arctan2

    def absorber(p):
        speed = xp.sqrt(p.vx * p.vx + p.vy * p.vy + p.vz * p.vz)
        open_ = sigmoid((R - hypot(p.rx, p.ry)) / eps)
        kill = -xp.expm1(-mu * speed * p.dt) * (1.0 - open_)
        return {"alive": ~((p.uniform() < kill) & p.alive)}

    def observables(p):
        return {"aniso": xp.cos(2.0 * atan2(p.vy, p.vx)),
                "core": erfc(hypot(p.rx, p.ry) / (np.sqrt(2.0) * sigma)),
                "tanhE": xp.tanh(p.E)}

    iso = P.light.ScatterIsotropicStep(A=np.double(1e-3), variable_n=True,
                                       variable_n_fn=lattice_density(c_dt))
    red = P.ReduceMeasureStep(None, observables,
                              outputs=("aniso", "core", "tanhE"),
                              measure_n=True)
    sign = P.light.ScatterSignMeasureStep(None, True)
    return [iso, P.ElementwiseStep(absorber), red, sign], (red, sign)


def _lattice_run(P, n=1 << 12, iters=64):
    xp = torch if P is T else jnp
    c = float(P.light.c)
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=(iters - 0.5) * DT, seed=3, chunk_steps=32,
                     auto_shrink=False, **kw)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             P.newton.NewtonianKinematicsStep()]
    more, measures = lattice_steps(P, xp, c)
    for i, st in enumerate(steps + more):
        s.add_step(i, st)
    rng = np.random.default_rng(6)
    d = rng.normal(size=(3, n))
    s.add_photons(P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n),
        r=rng.normal(0, 150, (3, n)) * c * DT,
        v=d / np.linalg.norm(d, axis=0) * c))
    s.start()
    s.join()
    assert s.used_fused, s.explain_plan()
    return s, [np.asarray(m.data, np.float64) for m in measures]


def test_lattice_path_matches_jax():
    ts, (t_red, t_sign) = _lattice_run(T)
    js, (j_red, j_sign) = _lattice_run(J)
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    np.testing.assert_array_equal(t_sign, j_sign)
    np.testing.assert_array_equal(t_red[:, :2], j_red[:, :2])  # t, n
    # each observable is at most 1 a photon: its sum within 1e-5 of the
    # row's photon count (cos 2 phi cancels across the photons)
    assert (np.abs(t_red[:, 2:] - j_red[:, 2:])
            <= 1e-5 * j_red[:, 1:2]).all()
    assert j_sign[-1, 1] < j_sign[0, 1]  # the absorber killed
    live = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), live)
    for nm in ("r", "v", "E", "w"):
        want = np.asarray(getattr(js.sim_state, nm))[..., live]
        got = getattr(ts.sim_state, nm).numpy()[..., live]
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            assert float(np.abs(g - w).max(initial=0.0)) <= 1e-4 * scale, nm
    # the plan fuses every user op and the string field
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    plan = try_build_fused(ts, ts._ordered_steps(),
                           ts._init_run_state()).plan
    assert [op.kind for op in plan.ops] == ["kin", "iso", "custom",
                                           "reduce", "sign"]
