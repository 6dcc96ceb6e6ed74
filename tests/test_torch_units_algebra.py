"""The port's ``Measurement`` over the unit algebra of tests/test_units.py
and tests/test_units_differential.py, held against the JAX package's.

Each case builds the same expression with both modules and compares the
stored (code-unit) values, the scale, the base-dimension dict, the
original-units dict and the unit string exactly; the physical constants
and the wavelength helpers of ``light`` too. Code scales are reset after
each case in both packages.
"""

import copy

import numpy as np
import pytest

import physicl_tpu.light as JL
import physicl_tpu.units as JU
import physicl_tpu_torch.light as TL
import physicl_tpu_torch.units as TU

_BASE = ("s", "m", "kg", "A", "K", "mol", "cd")

UNITS = ["m**1", "s**-2", "kg**2 m**1", "N**1", "J**1 s**1", "eV**1",
         "au**1", "min**2", "W**1 K**-1", "Pa**2", "C**1 V**1",
         "kg**1 m**1 s**-2", "Bq**3", "L**1", "t**1", "Da**1", "lm**1",
         "au**0.5", "m^2 s^-1"]


@pytest.fixture(autouse=True)
def _reset_code_scales():
    yield
    for U, L in ((TU, TL), (JU, JL)):
        for u in _BASE:
            U.reset_code_scale(u)
        L.refresh_constants()


def _snap(m):
    if not hasattr(m, "units"):  # a plain value (``value()``, a norm)
        return ("plain", np.asarray(m, np.float64).tolist())
    return (np.asarray(m.view(np.ndarray), np.float64).tolist(),
            float(m.scale), dict(m.units), dict(m.original_units),
            m.unitstr())


def _same(expr):
    """``expr(U, L)`` through the port and the JAX package: equal
    snapshots (NaN equal to NaN)."""
    np.testing.assert_equal(_snap(expr(TU, TL)), _snap(expr(JU, JL)))


@pytest.mark.parametrize("unit", UNITS)
def test_construction(unit):
    for val in (0.5, 7.25, [1.0, 2.0, 3.0]):
        _same(lambda U, L: U.Measurement(val, unit))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
def test_binary_ops_fuzz(op):
    rng = np.random.default_rng({"add": 1, "subtract": 2, "multiply": 3,
                                 "divide": 4}[op])
    fn = getattr(np, op)
    for _ in range(60):
        u1, u2 = rng.choice(UNITS, 2)
        v1, v2 = (float(x) for x in rng.uniform(0.5, 5, 2))
        _same(lambda U, L: fn(U.Measurement(v1, u1), U.Measurement(v2, u2)))


@pytest.mark.parametrize("unit", UNITS)
def test_powers_and_coercion(unit):
    _same(lambda U, L: U.Measurement(2.5, unit) ** 2)
    _same(lambda U, L: np.square(U.Measurement(2.5, unit)))
    _same(lambda U, L: np.sqrt(U.Measurement(2.5, unit)))
    _same(lambda U, L: U.Measurement(2.5, unit) + 1.5)
    _same(lambda U, L: U.Measurement(2.5, unit) * 1.5)
    _same(lambda U, L: U.Measurement(10.0, unit) / 2.0)


@pytest.mark.parametrize("scale", [("m", 0.001), ("m", 1000.0),
                                   ("m", 2.5), ("s", 1e-3), ("kg", 1e3)])
def test_code_scales(scale):
    for U, L in ((TU, TL), (JU, JL)):
        U.set_code_scale(*scale)
        L.refresh_constants()
    for u in ("m**1", "N**1", "J**1", "au**1", "m**2 s**-1", "eV**1"):
        _same(lambda U, L: U.Measurement(3.0, u))
        _same(lambda U, L: U.Measurement(3.0, u).value())
        _same(lambda U, L: U.Measurement.from_code([1.0, 2.0], u))
    for name in ("c", "h", "kB", "m_e"):
        _same(lambda U, L: getattr(L, name))


def test_reference_identities():
    """tests/test_units.py's identities, through both packages."""
    _same(lambda U, L: U.Measurement(5, "kg**1 m**1 s**-2"))
    _same(lambda U, L: U.Measurement(5, "N**1"))
    _same(lambda U, L: U.Measurement(1, "au**1")
          + U.Measurement(149597870700, "m**1"))
    _same(lambda U, L: U.Measurement(149597870700, "m**1")
          + U.Measurement(1, "au**1"))
    _same(lambda U, L: L.E_from_wavelength(U.Measurement(633e-9, "m**1")))
    _same(lambda U, L: L.wavelength_from_E(
        L.E_from_wavelength(U.Measurement(633e-9, "m**1"))))
    _same(lambda U, L: L.c / ((U.Measurement(0, "J**1")
                               + U.Measurement(13.6, "eV**1")) / L.h))
    a = {U: U.Measurement(5, "kg**1 m**1 s**-2") for U in (TU, JU)}
    _same(lambda U, L: a[U] * U.Measurement(10, "min**2"))
    _same(lambda U, L: a[U] / U.Measurement(5, "au**1"))
    _same(lambda U, L: a[U] ** 2)
    _same(lambda U, L: U.Measurement(0, "m**1")
          + np.sqrt(U.Measurement(5, "au**1")))
    _same(lambda U, L: U.Measurement(3, "m^2 s^-1"))
    _same(lambda U, L: U.Measurement(
        [U.Measurement(1, "au**1"), 0, 2.5], "m**1"))
    _same(lambda U, L: np.sqrt(np.sum(U.Measurement(
        [U.Measurement(1, "au**1"), 0, 2.5], "m**1") ** 2)))
    _same(lambda U, L: np.linalg.norm(U.Measurement([L.c, 0, 0],
                                                    "m**1 s**-1")))


def test_comparisons_strings_and_copies():
    for U in (TU, JU):
        a, b = U.Measurement(1, "au**1"), U.Measurement(2 * 149597870700,
                                                        "m**1")
        assert bool(a < b) and bool(b > a) and not bool(a == b)
    t = TU.Measurement([1.0, 2.0], "eV**1")
    j = JU.Measurement([1.0, 2.0], "eV**1")
    assert repr(t) == repr(j) and t.unitstr() == j.unitstr()
    assert TU.Measurement(2.0, "m**1").fstr() == \
        JU.Measurement(2.0, "m**1").fstr()
    assert TU.Measurement(2.0, "m**1").valstr() == \
        JU.Measurement(2.0, "m**1").valstr()
    np.testing.assert_equal(_snap(copy.deepcopy(t)), _snap(copy.deepcopy(j)))
    assert copy.deepcopy(t).original_units is not t.original_units
    for bad in ("zorbs**1",):
        with pytest.raises(TU.MeasurementError):
            TU.Measurement(1, bad)
    with pytest.raises(TU.MeasurementError):
        TU.set_code_scale("N", 2.0)
