"""``SpectrumMeasureStep`` and ``MeshTallyStep``, the histogram tallies that
run as kernel 1i's ``reduce`` op, held against the JAX package on the CPU.

The port's contributions are torch (``physicl_tpu_torch/light.py``), the JAX
package's jnp; both fuse them into per-bin float record columns. Counts are
exact; energy, path-length and weight sums agree within rtol 1e-5 (XLA's
FMAs move the planes by ulps), and CSV files match where the values do.
"""

import numpy as np
import pytest

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401

DT = 1e-3
K = 40
RTOL = 1e-5


def _build(P, case, out_fn=None):
    kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
    s = P.Simulation(until_t=DT * K * 0.9999, seed=11, chunk_steps=16, **kw)
    L = P.light
    c = float(L.c)
    c_dt = c * DT
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             P.newton.NewtonianKinematicsStep()]
    edges = np.exp(np.linspace(-1.0, 1.0, 13))
    if case == "spectrum-count":
        # thermal Compton moves energies across bins every iteration
        steps.append(L.ScatterComptonStep(A=0.2 / c_dt, n=1.0, mec2=4.0,
                                          theta_e=0.01))
        tally = L.SpectrumMeasureStep(out_fn, edges=edges, measure_n=True,
                                      underflow=True, overflow=True)
    elif case == "spectrum-energy-weighted":
        steps += [L.ScatterComptonStep(A=0.2 / c_dt, n=1.0, mec2=4.0),
                  L.ScatterDeleteStep(1.0, 0.05 / c_dt,
                                      implicit_capture=True)]
        tally = L.SpectrumMeasureStep(out_fn, edges=edges, weight="energy",
                                      weighted=True, overflow=True)
    elif case == "mesh-x-pathlength":
        steps.append(L.ScatterIsotropicStep(A=0.1 / c_dt, n=1.0))
        tally = L.MeshTallyStep(out_fn, axis="x",
                                edges=np.linspace(-20, 20, 17) * c_dt,
                                value="pathlength", underflow=True,
                                overflow=True)
    elif case == "mesh-r-weighted":
        steps += [L.ScatterIsotropicStep(A=0.1 / c_dt, n=1.0),
                  L.ScatterDeleteStep(1.0, 0.05 / c_dt,
                                      implicit_capture=True)]
        tally = L.MeshTallyStep(out_fn, axis="r",
                                edges=np.linspace(0, 30, 11) * c_dt,
                                center=(2 * c_dt, -c_dt, 0.0), weighted=True,
                                measure_n=True, overflow=True)
    elif case == "mesh-y-energy":
        steps.append(L.ScatterComptonStep(A=0.2 / c_dt, n=1.0, mec2=4.0))
        tally = L.MeshTallyStep(out_fn, axis="y",
                                edges=np.linspace(-15, 15, 7) * c_dt,
                                value="energy")
    else:
        raise KeyError(case)
    steps.append(tally)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(3)
    n = 3000
    d = rng.normal(size=(3, n))
    s.add_photons(L.generate_photon_state(
        n, E=rng.uniform(0.4, 3.0, n), r=rng.normal(size=(3, n)) * 5 * c_dt,
        v=d / np.linalg.norm(d, axis=0) * c))
    return s, tally


@pytest.mark.parametrize("case", ["spectrum-count", "spectrum-energy-weighted",
                                  "mesh-x-pathlength", "mesh-r-weighted",
                                  "mesh-y-energy"])
def test_tally_rows_and_csv_match_jax(case, tmp_path):
    rows, files = {}, {}
    for P in (J, T):
        files[P] = tmp_path / f"{P.__name__}.csv"
        s, tally = _build(P, case, str(files[P]))
        s.start()
        s.join()
        assert s.used_fused
        rows[P] = np.asarray(tally.data, np.float64)
    jr, tr = rows[J], rows[T]
    assert jr.shape == tr.shape and jr.shape[0] == K
    assert np.array_equal(jr[:, 0], tr[:, 0])  # t
    if case in ("spectrum-count",):
        assert np.array_equal(jr, tr)  # n and every count exactly
    else:
        np.testing.assert_allclose(tr, jr, rtol=RTOL, atol=1e-6)
    jt = np.loadtxt(files[J], delimiter=",", ndmin=2)
    tt = np.loadtxt(files[T], delimiter=",", ndmin=2)
    np.testing.assert_allclose(tt, jt, rtol=RTOL, atol=1e-6)
    if case == "spectrum-count":
        assert files[J].read_bytes() == files[T].read_bytes()


def test_spectrum_counts_sum_to_n():
    s, tally = _build(T, "spectrum-count")
    s.start()
    s.join()
    rows = np.asarray(tally.data)
    assert (rows[:, 2:].sum(1) == rows[:, 1]).all()


@pytest.mark.parametrize("make", [
    lambda P: P.light.SpectrumMeasureStep(edges=[1.0]),
    lambda P: P.light.SpectrumMeasureStep(edges=[2.0, 1.0]),
    lambda P: P.light.SpectrumMeasureStep(edges=[1.0, 2.0], weight="w"),
    lambda P: P.light.MeshTallyStep(axis="q", edges=[0.0, 1.0]),
    lambda P: P.light.MeshTallyStep(edges=[0.0, 1.0], value="dose"),
    lambda P: P.light.MeshTallyStep(axis="r", edges=[-1.0, 1.0]),
])
def test_tally_validation_matches_jax(make):
    with pytest.raises(ValueError) as jerr:
        make(J)
    with pytest.raises(ValueError) as terr:
        make(T)
    assert str(terr.value) == str(jerr.value)


def test_tally_names():
    for P in (J, T):
        st = P.light.MeshTallyStep(edges=[0.0, 1.0, 2.0], underflow=True,
                                   overflow=True)
        assert st.outputs == ("bin0", "bin1", "underflow", "overflow")
