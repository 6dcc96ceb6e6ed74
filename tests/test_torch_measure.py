"""Plane-crossing tallies (``ScatterMeasureStep``): the PyTorch port against
the JAX package on the CPU, through both packages' fused tiers.

Crossing counts are integer records and the ``data`` rows that carry only
counts are exactly equal, and so are the per-photon energy lists of the
list mode (the crossing photons' float32 energies in slot order); weight
sums and energy sums are float records, summed in another order by each
package (XLA's reduction, ``torch.sum``; on the card, a fixed warp/block
tree), so they are held to rtol 1e-5.
"""

import numpy as np
import pytest

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401

RTOL = 1e-5


def _sim(P, t_end, n=100, E=2.5, v=None, r=None, w=None, steps=(), **kw):
    if P is T:
        kw["device"] = "cpu"
    s = P.Simulation(exit=lambda c: c.t >= t_end, seed=4, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    for i, st in enumerate(steps, start=2):
        s.add_step(i, st)
    s.add_photons(P.light.generate_photon_state(n, E=E, v=v, r=r, w=w))
    return s


def _run_both(make):
    out = []
    for P in (J, T):
        s, meas = make(P)
        s.start()
        s.join()
        assert s.used_fused
        out.append((s, meas))
    return out


def test_plane_crossing_exact(tmp_path):
    """tests/test_measure.py:22 on both packages; the CSVs are identical."""
    def make(P):
        c_dt = float(P.light.c) * 0.001
        out = str(tmp_path / f"{P.__name__}.csv")
        meas = P.light.ScatterMeasureStep(out, True,
                                          [[2.5 * c_dt, np.nan, np.nan]])
        return _sim(P, 0.005, steps=[meas]), meas

    (js, jm), (ts, tm) = _run_both(make)
    assert [list(r) for r in tm.data] == [list(r) for r in jm.data]
    assert [r[2] for r in tm.data] == [0, 0, 100, 0, 0]
    assert [r[1] for r in tm.data] == [100] * 5
    assert ((tmp_path / "physicl_tpu_torch.csv").read_bytes()
            == (tmp_path / "physicl_tpu.csv").read_bytes())


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_plane_crossing_each_axis(axis):
    """tests/test_measure.py:36 on every axis, without the n column."""
    def make(P):
        c = float(P.light.c)
        v = np.zeros((3, 1))
        v[axis, 0] = c
        loc = [np.nan] * 3
        loc[axis] = 1.5 * c * 0.001
        meas = P.light.ScatterMeasureStep(None, False, [loc])
        return _sim(P, 0.003, n=50, E=1.0, v=v, steps=[meas]), meas

    (_, jm), (_, tm) = _run_both(make)
    assert [list(r) for r in tm.data] == [list(r) for r in jm.data]
    assert [r[1] for r in tm.data] == [0, 50, 0]


def test_energy_sum_mode():
    """tests/test_measure.py:158: 10 photons of E = 2.5 cross once."""
    def make(P):
        c_dt = float(P.light.c) * 0.001
        meas = P.light.ScatterMeasureStep(
            None, True, [[1.5 * c_dt, np.nan, np.nan]], measure_E=True,
            measure_E_mode="sum")
        return _sim(P, 0.003, n=10, steps=[meas]), meas

    (_, jm), (_, tm) = _run_both(make)
    rows = [(float(r[0]), int(r[1]), int(r[2]), float(r[3]))
            for r in tm.data]
    assert rows == [(float(r[0]), int(r[1]), int(r[2]), float(r[3]))
                    for r in jm.data]
    assert rows[1][2] == 10 and rows[1][3] == 25.0
    assert rows[0][3] == 0.0 and rows[2][3] == 0.0


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["counts", "weighted"])
def test_scattered_beam_tallies(weighted):
    """A scattering population with spread energies and weights through
    planes on three axes: counts exact, weight and energy sums within
    rtol 1e-5 of the JAX package's."""
    rng = np.random.default_rng(11)
    n = 4000
    E = rng.uniform(0.5, 2.0, n)
    w = rng.uniform(0.2, 1.0, n)

    def make(P):
        c_dt = float(P.light.c) * 0.001
        meas = P.light.ScatterMeasureStep(
            None, True, [[2.5 * c_dt, np.nan, np.nan],
                         [np.nan, -0.5 * c_dt, np.nan],
                         [np.nan, np.nan, 0.5 * c_dt]],
            measure_E=True, measure_E_mode="sum", weighted=weighted)
        iso = P.light.ScatterIsotropicStep(A=np.double(0.5),
                                           n=np.double(1e-5))
        return _sim(P, 0.03, n=n, E=E, w=w, steps=[iso, meas],
                    chunk_steps=16), meas

    (_, jm), (_, tm) = _run_both(make)
    got, want = np.asarray(tm.data), np.asarray(jm.data)
    assert got.shape == want.shape == (30, 2 + 2 * 3)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # t, n
    counts, esums = slice(2, None, 2), slice(3, None, 2)
    if weighted:
        np.testing.assert_allclose(got[:, counts], want[:, counts],
                                   rtol=RTOL)
    else:
        np.testing.assert_array_equal(got[:, counts], want[:, counts])
    np.testing.assert_allclose(got[:, esums], want[:, esums], rtol=RTOL)
    assert got[:, counts].sum(axis=0).min() > 0  # every plane was crossed


def _list_rows_equal(got, want, weighted=False):
    """List-mode rows: object arrays of t, n, then per plane a count (or a
    weight sum) and an energy list; t, n, counts and lists exactly equal,
    weight sums within rtol 1e-5. Returns the number of listed energies."""
    assert len(got) == len(want) > 0
    n_lists = 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == object and len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            if isinstance(y, list):
                assert isinstance(x, list) and x == y
                assert all(type(e) is np.float32 for e in x)
                n_lists += len(x)
            elif weighted and i >= 2:
                np.testing.assert_allclose(float(x), float(y), rtol=RTOL)
            else:
                assert x == y
    return n_lists


def test_energy_list_mode_refuses():
    """The list mode, refused before stream planes were ported, now fuses:
    the reference's rows (tests/test_measure.py:259) equal the JAX
    package's list for list, with empty lists where nothing crossed."""
    def make(P):
        c_dt = float(P.light.c) * 0.001
        meas = P.light.ScatterMeasureStep(
            None, True, [[1.5 * c_dt, np.nan, np.nan],
                         [2.5 * c_dt, np.nan, np.nan]], measure_E=True)
        Es = np.linspace(1.0, 2.0, 32)
        return _sim(P, 0.004, n=32, E=Es, steps=[meas]), meas

    (js, jm), (ts, tm) = _run_both(make)
    assert "refused" not in ts.explain_plan()
    assert ts.plan_report.mode == "fused"
    assert _list_rows_equal(tm.data, jm.data) == 64
    assert tm.data[1][3] == [np.float32(e) for e in np.linspace(1, 2, 32)]
    assert tm.data[0][3] == [] and tm.data[2][3] == []


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["counts", "weighted"])
def test_energy_list_mode_scattered_beam_matches_jax(weighted):
    """A scattering, absorbing population through planes on two axes over
    several chunks: every iteration's list holds the crossing photons'
    energies in slot order, as long as the count column, equal to the JAX
    package's lists."""
    rng = np.random.default_rng(12)
    n = 3000
    E = rng.uniform(0.5, 2.0, n)
    w = rng.uniform(0.2, 1.0, n)

    def make(P):
        c_dt = float(P.light.c) * 0.001
        meas = P.light.ScatterMeasureStep(
            None, True, [[2.37 * c_dt, np.nan, np.nan],
                         [np.nan, -0.61 * c_dt, np.nan]], measure_E=True,
            weighted=weighted)
        iso = P.light.ScatterIsotropicStep(A=np.double(0.5),
                                           n=np.double(1e-5))
        dele = P.light.ScatterDeleteStep(np.double(1e-6), np.double(0.5))
        return _sim(P, 0.03, n=n, E=E, w=w, steps=[iso, dele, meas],
                    chunk_steps=8), meas

    (js, jm), (ts, tm) = _run_both(make)
    assert _list_rows_equal(tm.data, jm.data, weighted) > 100
    for row in tm.data:
        if not weighted:  # the list is as long as the count column
            assert len(row[3]) == row[2] and len(row[5]) == row[4]


N_COUNTING = 14  # counting sign tallies: 4 int record columns each


def _counting_signs(P):
    return [P.light.ScatterSignMeasureStep(None, True)
            for _ in range(N_COUNTING)]


def test_record_tile_clamps_the_chunk():
    """The kernel's count tile, [chunk][n_cols] int32 of shared memory (the
    float sums go to global partials), bounds the chunk: a weighted sign
    tally, a weighted two-plane energy tally (float columns, which no
    longer count) and fourteen counting sign tallies (59 int columns)
    overflow it at 1024 iterations: 1024 x 59 x 4 B > 232,448 B. The
    prover shortens the chunk to 984 and says so; the records equal a
    JAX run with the same chunk_steps (the chunk seed follows the chunk
    index, so parity needs the same chunk length), over a chunk boundary.
    Unscattered photons at dt = 2**-10 (``r + v dt`` exact: XLA's FMA
    cannot move a crossing) start on both sides of the chunk boundary's
    crossing iterations; absorption thins them."""
    rng = np.random.default_rng(13)
    n = 2000
    E = rng.uniform(0.5, 2.0, n)
    w = rng.uniform(0.2, 1.0, n)
    dt = 2.0 ** -10
    clamped = 232_448 // (59 * 4)
    # half along +x from x < 0, half along -y from y > 0, crossing their
    # planes at iterations spread over [5, 990]
    start = rng.uniform(5.0, 990.0, n)
    along_x = np.arange(n) < n // 2

    def make(P):
        c = float(P.light.c)
        c_dt = c * dt
        r = np.zeros((3, n))
        r[0] = np.where(along_x, -start * c_dt, 0.0)
        r[1] = np.where(along_x, 0.0, start * c_dt)
        v = np.zeros((3, n))
        v[0] = np.where(along_x, c, 0.0)
        v[1] = np.where(along_x, 0.0, -c)
        kw = {"device": "cpu"} if P is T else {"chunk_steps": clamped}
        s = P.Simulation(until_t=(clamped + 7.5) * dt, seed=4, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(dt)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterDeleteStep(np.double(1e-3 / c_dt),
                                                np.double(1.0)))
        sign = P.light.ScatterSignMeasureStep(None, True, weighted=True)
        s.add_step(3, sign)
        cross = P.light.ScatterMeasureStep(
            None, True, [[0.5 * c_dt, np.nan, np.nan],
                         [np.nan, -0.5 * c_dt, np.nan]], measure_E=True,
            measure_E_mode="sum", weighted=True)
        s.add_step(4, cross)
        counts = _counting_signs(P)
        for i, st in enumerate(counts, start=5):
            s.add_step(i, st)
        s.add_photons(P.light.generate_photon_state(n, E=E, w=w, r=r, v=v))
        return s, (sign, cross, counts[-1])

    (js, (jsign, jcross, jcount)), (ts, (tsign, tcross, tcount)) = \
        _run_both(make)
    assert clamped == 984 and ts.plan_report.chunk == clamped
    assert (f"chunk {clamped}: record count tile (59 int columns"
            in ts.explain_plan())
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(ts.ts) == clamped + 8
    assert np.asarray(tcross.data)[clamped:, 2].sum() > 0  # both chunks
    np.testing.assert_array_equal(np.asarray(tcount.data),
                                  np.asarray(jcount.data))
    for got, want in ((tsign.data, jsign.data), (tcross.data, jcross.data)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, :2], want[:, :2])  # t, n
        np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=RTOL)


def test_record_tile_clamp_keeps_whole_trace_periods():
    """With a trace every 10th iteration the clamped chunk is a whole number
    of periods (980, not 984), so that the sampled iterations stay global
    multiples of 10 across chunk boundaries."""
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    s = T.Simulation(until_t=1.0, seed=0, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterSignMeasureStep(None, True, weighted=True))
    s.add_step(3, T.light.ScatterMeasureStep(
        None, True, [[1.0, np.nan, np.nan], [np.nan, 1.0, np.nan]],
        measure_E=True, measure_E_mode="sum", weighted=True))
    s.add_step(4, T.light.TracePathMeasureStep(None, trace_every=10))
    for i, st in enumerate(_counting_signs(T), start=5):
        s.add_step(i, st)
    s.add_photons(T.light.generate_photon_state(10, E=1.0))
    steps = s._ordered_steps()
    for st in steps:
        st.setup(s)
    plan = try_build_fused(s, steps, s._init_run_state()).plan
    assert plan.n_rec_cols == 59
    assert (plan.chunk, plan.stream_every) == (980, 10)
