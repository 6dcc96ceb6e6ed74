"""Weighted transport on the port: implicit capture, Russian roulette and
deposition tallies.

The invariants of the JAX package's tests/test_weights.py and
tests/test_media.py, run through the port's ``Simulation`` on the CPU
(its kernel's plain twin), each beside the same run on the JAX package
where the two compare draw for draw:

* implicit capture is deterministic: a monoenergetic beam in a uniform
  absorber keeps every photon and its total weight is N (1-p)^k to float32
  roundoff (1e-4 after 20 iterations; no statistical term);
* roulette keeps the expected total weight and bounds the alive weights
  away from zero;
* deposition is conserved exactly: the energy put in equals the summed
  deposits plus the in-flight sum of w E (rtol 2e-4: float32 per-photon
  products over the run and float32 sums of 2048 terms per iteration);
* Beer-Lambert through a voxel slab: the implicit-capture weight of a
  photon crossing it is the product of (1 - A n_k c dt) over its per-step
  voxel densities, computed independently in numpy (rtol 5e-5), here on a
  float32 grid read straight by the kernel (the JAX test runs a codebook).

Float tallies of the two packages agree within rtol 3e-5: equal per-photon
terms, summed in another order (tests/test_torch_media.py).
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


def _absorber(P, n_phot=4096, p_step=0.1, t_end=0.02, seed=0, E=1.0,
              **del_kw):
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=t_end, seed=seed, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    c = float(P.light.c)
    dele = P.light.ScatterDeleteStep(np.double(1.0),
                                     np.double(p_step / (c * DT)), **del_kw)
    s.add_step(2, dele)
    # every photon flies +x: the weighted +x tally is the total weight
    sign = P.light.ScatterSignMeasureStep(None, True, weighted=True)
    s.add_step(3, sign)
    s.add_photons(P.light.generate_photon_state(n_phot, E=E))
    s.start()
    s.join()
    assert s.used_fused
    return s, dele, np.array(sign.data, dtype=float)


def test_implicit_capture_exact_deterministic_attenuation():
    out = {}
    for P in (J, T):
        _, _, rows = _absorber(P, implicit_capture=True)
        assert (rows[:, 1] == 4096).all()   # nothing is ever killed
        expect = 4096 * (1.0 - 0.1) ** np.arange(1, rows.shape[0] + 1)
        # f32 per-photon multiplies compound ~1 ulp per iteration
        np.testing.assert_allclose(rows[:, 2], expect, rtol=1e-4)
        out[P] = rows
    np.testing.assert_allclose(out[T], out[J], rtol=3e-5)


def test_roulette_unbiased_and_bounded():
    k = 90
    w_min, w_sur = 1e-3, 2e-3
    out = {}
    for P in (J, T):
        s, _, rows = _absorber(P, n_phot=65536, t_end=k * DT + 1e-6, seed=3,
                               implicit_capture=True,
                               roulette=(w_min, w_sur))
        out[P] = (s, rows)
    (js, jrows), (ts, rows) = out[J], out[T]
    expect = 65536 * (1.0 - 0.1) ** rows.shape[0]
    # unbiased: the weight sum within statistical tolerance of the exact
    # value (the roulette draws are the only noise)
    assert abs(rows[-1, 2] / expect - 1) < 0.25
    # roulette culls: far fewer alive than implicit capture alone keeps
    assert rows[-1, 1] < 65536 * 0.2
    alive = ts.sim_state.alive.numpy()
    w = ts.sim_state.w.numpy()[alive]
    assert w.size and w.min() >= w_min * (1 - 0.1) * 0.999
    # the same draws on both packages: the same survivors
    np.testing.assert_array_equal(rows[:, :2], jrows[:, :2])
    np.testing.assert_array_equal(alive, np.asarray(js.sim_state.alive))
    np.testing.assert_allclose(rows[:, 2:], jrows[:, 2:], rtol=3e-5)


@pytest.mark.parametrize("implicit", [True, False],
                         ids=["implicit", "analog"])
def test_energy_deposition_conservation(implicit):
    Es = np.linspace(1.0, 3.0, 2048)
    out = {}
    for P in (J, T):
        s, dele, _ = _absorber(P, n_phot=2048, p_step=0.15, t_end=0.01,
                               seed=2, E=Es, implicit_capture=implicit,
                               measure_deposition=True)
        dep = np.array(dele.data, dtype=float)
        assert dep.shape == (len(s.ts), 2)
        np.testing.assert_array_equal(dep[:, 0], np.asarray(s.ts))
        out[P] = (s, dep)
    s, dep = out[T]
    st = s.sim_state
    alive = st.alive.numpy()
    inflight = float((st.w.double() * st.E.double()).numpy()[alive].sum())
    np.testing.assert_allclose(dep[:, 1].sum() + inflight, Es.sum(),
                               rtol=2e-4)
    np.testing.assert_allclose(dep[:, 1], out[J][1][:, 1], rtol=3e-5)
    if implicit:  # exact expected dose: dep_k = sum(E) p (1-p)^(k-1)
        k = np.arange(1, dep.shape[0] + 1)
        np.testing.assert_allclose(dep[:, 1], Es.sum() * 0.15
                                   * 0.85 ** (k - 1), rtol=1e-3)
        assert alive[:2048].all()   # implicit capture kills nothing
    else:
        assert not alive[:2048].all()


def test_deposition_csv(tmp_path):
    out = tmp_path / "dose.csv"
    s = T.Simulation(until_t=0.003, seed=0, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    dele = T.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.5 / (float(T.light.c) * DT)),
        implicit_capture=True, measure_deposition=True, out_fn=str(out))
    s.add_step(2, dele)
    s.add_photons(T.light.generate_photon_state(64, E=2.0))
    s.start()
    s.join()
    rows = [[float(x) for x in line.split(",")]
            for line in out.read_text().splitlines() if line.strip()]
    np.testing.assert_allclose(rows, dele.data)
    assert len(rows) == 3 and rows[0][1] == pytest.approx(64.0, rel=1e-6)


def test_voxel_beer_lambert_line_integral():
    """Beer-Lambert through a 64^3 two-material slab phantom (float32 grid):
    the implicit-capture weight of a photon crossing the slab equals
    prod_k (1 - A n_k c dt) over its per-step voxel densities."""
    c_dt = float(T.light.c) * DT
    A = 0.1 / c_dt
    grid = np.ones((64, 64, 64), np.float32)
    grid[20:40] = 2.5                      # a dense slab along x
    spacing = 2.0 * c_dt                   # a photon crosses 32 voxels
    # quarter-voxel origin shift: step-end positions land at fx =
    # (k + 1.5) / 2, never on a .5 rounding tie
    nfn = T.light.voxel_density(grid, origin=(-0.5 * c_dt, 0, 0),
                                spacing=spacing)
    assert nfn.spec["kind"] == "voxel" and nfn.spec["flat"].dtype == \
        np.float32
    s = T.Simulation(until_t=0.064 * 0.9999, seed=1, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(
        np.double(1.0), np.double(A), variable_n=True, variable_n_fn=nfn,
        implicit_capture=True))
    s.add_photons(T.light.generate_photon_state(64, E=1.0))
    s.start()
    s.join()
    assert s.used_fused and len(s.ts) == 64
    w_expect = 1.0
    for k in range(64):
        fx = (k + 1.5) / 2.0
        ix = int(np.clip(np.round(fx), 0, 63))
        inside = -0.5 <= fx < 63.5
        n_k = float(grid[ix, 0, 0]) if inside else 0.0
        w_expect *= 1.0 - min(A * n_k * c_dt, 1.0)
    w = s.sim_state.w.double().numpy()
    alive = s.sim_state.alive.numpy()
    assert alive.sum() == 64
    np.testing.assert_allclose(w[alive], w_expect, rtol=5e-5)
