"""Planck generation: the PyTorch port against the JAX package on the CPU.

* The host math (numpy float64) is a copy of the JAX package's, so the CDF,
  the inverse-CDF polynomial fit and the inverse table are exactly equal.
* The plain inverse CDF ``poly_icdf_reference`` picks the same segment as
  the JAX mask sum and agrees within 4 ulp (XLA may contract the Horner
  chain into FMAs; on this CPU it measured 0 ulp), on 2**16 seeded
  uniforms plus every breakpoint and its float32 neighbours, on the four
  windows of tests/test_planck.py.
* The bulk generator's plain twin (the CPU route of ``planck_gen``) draws
  from the counter hash, the TPU kernel from the TPU's hardware PRNG, so
  they are compared by distribution: the analytic density within 10% on
  bins above 5% of the peak, and quantiles within rtol 0.02 of the JAX
  package's ``device_method="poly"`` sampler.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import physicl_tpu as J
import physicl_tpu.light as JL
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light as TL
from physicl_tpu_torch.ops import planck as TP

T_SUN = 5778.0
KT = float(JL.kB.value()) * T_SUN
WINDOWS = [(0.1, 12.0), (2.0, 10.0), (0.01, 20.0), (0.1, 30.0)]


def _args(window, bins=2000):
    return (window[0] * KT, window[1] * KT, T_SUN, bins)


@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_host_arrays_equal_jax(window):
    args = _args(window)
    for a, b in zip(TL.planck_cdf(*args), JL.planck_cdf(*args)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TL._planck_inverse_table(*args),
                                  JL._planck_inverse_table(*args))
    t, j = TL._planck_poly_data(*args), JL._planck_poly_data(*args)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(t[3]), np.asarray(j[3]))
    assert t[4] == j[4]
    assert np.asarray(t[0]).dtype == np.float32


def test_density_and_probability_equal_jax():
    E = np.linspace(0.1 * KT, 10 * KT, 64)
    np.testing.assert_array_equal(
        np.asarray(TL.planck_distribution(E, T_SUN)),
        np.asarray(JL.planck_distribution(E, T_SUN)))
    assert (TL.planck_probability(1e-20, 5e-19, T_SUN)
            == JL.planck_probability(1e-20, 5e-19, T_SUN))
    lam = T.Measurement(550e-9, "m**1")
    back = TL.wavelength_from_E(TL.E_from_wavelength(lam))
    assert np.isclose(float(back), 550e-9, rtol=1e-12)


def _probe_uniforms(data):
    rng = np.random.default_rng(0)
    u = rng.uniform(size=1 << 16).astype(np.float32)
    pb = np.asarray(data[0], np.float32)
    edges = np.concatenate([pb, np.nextafter(pb, np.float32(0)),
                            np.nextafter(pb, np.float32(2))])
    return np.concatenate([u, edges[(edges >= 0) & (edges < 1)]]).astype(
        np.float32)


@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_poly_icdf_matches_jax(window):
    data = TL._planck_poly_data(*_args(window))
    u = _probe_uniforms(data)
    want = np.asarray(JL._poly_icdf_eval(jnp.asarray(u), data))
    got = TL.poly_icdf_reference(torch.from_numpy(u), data).numpy()
    # the same segment as the JAX predicate pb[s] <= u < pb[s+1]
    seg = TP.poly_segment(torch.from_numpy(u), data).numpy()
    np.testing.assert_array_equal(
        seg, np.searchsorted(np.asarray(data[0], np.float32), u,
                             side="right") - 1)
    # the widest window overflows Horner to NaN at u = 1 - 2**-24 in a
    # near-zero-mass tail segment; both packages agree on where
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ulps = (np.abs(got[ok].astype(np.float64) - want[ok])
            / np.spacing(np.abs(want[ok])))
    assert ulps.max() <= 4, ulps.max()


def test_twin_histogram_matches_density():
    """The pattern of tests/test_planck.py:47 on the generator's twin."""
    a, b = 0.1 * KT, 12 * KT
    E = TL.planck_sample_E(200_000, a, b, T_SUN, bins=2000, seed=0,
                           device="cpu").numpy()
    hist, edges = np.histogram(E, bins=40, range=(a, b), density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    analytic = np.array(
        [float(TL.planck_distribution(x, T_SUN).value()) for x in centers])
    analytic /= np.trapezoid(analytic, centers)
    mask = analytic > 0.05 * analytic.max()
    rel = np.abs(hist[mask] - analytic[mask]) / analytic[mask]
    assert rel.max() < 0.10


def test_twin_quantiles_match_jax_poly():
    """The pattern of tests/test_planck.py:102-115: every sampler shares
    the polynomial, so quantiles agree within rtol 0.02."""
    args = dict(n=100_000, E_min=0.1 * KT, E_max=12 * KT, T=T_SUN, bins=2000)
    q = np.linspace(0.05, 0.95, 10)
    jax_poly = np.asarray(JL.planck_sample_E(**args, device=True,
                                             device_method="poly"))
    for method in ("kernel", "auto", "poly", "table"):
        E = TL.planck_sample_E(**args, device="cpu", device_method=method,
                               seed=1).numpy()
        assert E.dtype == np.float32
        assert np.allclose(np.quantile(E, q), np.quantile(jax_poly, q),
                           rtol=0.02), method
    host = TL.planck_sample_E(**args, seed=1)
    assert host.dtype == np.float64
    assert np.allclose(np.quantile(host, q), np.quantile(jax_poly, q),
                       rtol=0.02)


def test_sampler_routes_agree():
    """``sample_device`` on the CPU is the twin of the kernel route of
    ``planck_sample_E``; ``icdf`` is the plain inverse CDF; the generator
    route is reproducible from its seed."""
    s = TL.PlanckSampler(0.1 * KT, 12 * KT, T_SUN, bins=2000)
    got = s.sample_device(7, 4097, device="cpu")
    want = TL.planck_sample_E(4097, s.E_min, s.E_max, T_SUN, bins=2000,
                              seed=7, device="cpu", device_method="kernel")
    assert torch.equal(got, want)
    u = torch.linspace(0.001, 0.999, 512, dtype=torch.float32)
    assert torch.equal(s.icdf(u), TL.poly_icdf_reference(u, s.data))
    assert torch.equal(TP.planck_gen(7, 4097, s.table(), device="cpu"), got)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(s(g1, 1000), s(g2, 1000))


def test_code_unit_factor_applied():
    """Under a non-unit code scale the samplers write code-unit energies
    (the pattern of tests/test_fused.py:419)."""
    T.set_code_scale("m", 10.0)  # J scales by 10^2 = 100
    TL.refresh_constants()
    try:
        s = TL.PlanckSampler(1e-20, 5e-19, T_SUN)
        assert s._code == pytest.approx(100.0)
        for E in (s(torch.Generator().manual_seed(0), 50_000).numpy(),
                  s.sample_device(0, 50_000, device="cpu").numpy(),
                  s.icdf(torch.linspace(0.01, 0.99, 64)).numpy()):
            assert np.all((E >= 1e-18 * 0.999) & (E <= 5e-17 * 1.001)), (
                E.min(), E.max())
    finally:
        T.reset_code_scale("m")
        TL.refresh_constants()


def test_device_photon_state_matches_host():
    """``generate_photon_state(device="cpu")`` builds the same initial
    state as the host (numpy) route."""
    from physicl_tpu_torch.ops import fused as F
    from physicl_tpu_torch.state import SimState

    rng = np.random.default_rng(5)
    E = rng.uniform(0.5, 2.0, 777)
    r = rng.normal(size=(3, 777))
    host = TL.generate_photon_state(777, E=E, r=r, w=0.5)
    dev = TL.generate_photon_state(777, E=torch.from_numpy(E), r=r, w=0.5,
                                   device="cpu")
    assert isinstance(dev["E"], torch.Tensor) and dev["E"].dtype == \
        torch.float32
    a = SimState.from_population([], [host], device="cpu")
    b = SimState.from_population([], [dev], device="cpu")
    assert torch.equal(F.pack_state(a), F.pack_state(b))


def test_generate_photons_and_from_E():
    """tests/test_planck.py's contract on the port's host-object
    constructors."""
    ph = TL.generate_photons(100, min=1.0, max=2.0)
    assert len(ph) == 100
    Es = np.array([float(p.E) for p in ph])
    assert np.all((Es >= 1.0) & (Es <= 2.0))
    # the default sampler is power(3): mean 3/4 of the range
    assert np.isclose(Es.mean(), 1.75, atol=0.05)
    ph2 = TL.generate_photons_from_E([T.Measurement(1, "J**1"),
                                      T.Measurement(2, "J**1")])
    assert len(ph2) == 2
    assert float(np.linalg.norm(np.asarray(ph2[0].v, np.double))) == float(
        TL.c)
    ph = TL.generate_photons(10, fn=lambda: 0.5, min=0.0, max=2.0)
    assert np.allclose([float(p.E) for p in ph], 1.0)
    ph = TL.generate_photons(10, fn=lambda size: np.full(size, 0.25),
                             min=0.0, max=4.0)
    assert np.allclose([float(p.E) for p in ph], 1.0)


def test_generate_photons_run_like_jax():
    """Objects from either package's constructor, with the same energies,
    give the same fused run."""
    rows = []
    for P in (J, T):
        objs = P.light.generate_photons_from_E(np.linspace(1.0, 2.0, 64))
        kw = {"device": "cpu"} if P is T else {}
        s = P.Simulation(until_t=0.0079, seed=2, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterIsotropicStep(A=0.001, n=0.001))
        m = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, m)
        for o in objs:
            s.add_obj(o)
        s.start()
        s.join()
        rows.append(np.asarray(m.data))
    np.testing.assert_array_equal(rows[0], rows[1])


def test_clear_kernel_cache_is_exported():
    """The JAX package's cache reset exists on the port's surface; the port
    records every callable afresh at each start(), so it has nothing to
    drop and a run after it is the same run."""
    assert "clear_kernel_cache" in T.__all__
    assert T.clear_kernel_cache() is None
