"""The main path end to end: the PyTorch port against the JAX package.

Both packages run the same steps through their public API
(``Simulation`` / ``add_step`` / ``add_photons`` / ``start`` / ``join``)
with the same seed on 20,000 photons on the CPU. The JAX package takes its
fused tier through the emulated chunk; the port takes the twin of its CUDA
kernel; both draw from the same counter hash. So:

* ``sim.ts`` is byte-identical (the host clock replay is the same f32 Kahan
  arithmetic);
* every ``ScatterSignMeasureStep.data`` row is equal;
* the final state agrees within rtol 1e-6 + atol 1e-6 * max|field| (XLA's
  CPU backend contracts multiply-adds into FMAs, the twin does not; see
  tests/test_torch_fused.py), with ``alive`` exactly equal.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu.ops import fused as JF
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.ops.pipeline import FusedRefusal

N = 20_000
A = N_DENS = 0.001
DT = 0.001


def _build(P, exit, absorb=False, out_fn=None, **kw):
    s = P.Simulation(exit=exit, seed=7, chunk_steps=64, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    if absorb:
        s.add_step(2, P.light.ScatterDeleteStep(np.double(N_DENS),
                                                np.double(A)))
    else:
        s.add_step(2, P.light.ScatterIsotropicStep(A=np.double(A),
                                                   n=np.double(N_DENS)))
    meas = P.light.ScatterSignMeasureStep(out_fn, True)
    s.add_step(3, meas)
    s.add_photons(P.light.generate_photon_state(N, E=1.0))
    return s, meas


def _run(s):
    s.start()
    s.join()
    return s


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    exit_fn = lambda c: c.t >= 0.2  # noqa: E731 — the README's t-exit form
    js, jm = _build(J, exit_fn, out_fn=str(d / "jax.csv"))
    ts, tm = _build(T, exit_fn, out_fn=str(d / "torch.csv"), device="cpu")
    return _run(js), jm, _run(ts), tm, d


@pytest.fixture(scope="module")
def extinction_runs():
    # both at the default auto_shrink=True: the two compact the population
    # at the same boundaries (tests/test_torch_shrink.py), so the slots,
    # hence the draws, stay the same
    js, jm = _build(J, "extinction", absorb=True)
    ts, tm = _build(T, "extinction", absorb=True, device="cpu")
    return _run(js), jm, _run(ts), tm


def _assert_close(got, want):
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-6 * scale)


def test_main_path_takes_the_fused_tier(main_runs):
    js, _, ts, _, _ = main_runs
    assert js.used_fused and ts.used_fused
    assert len(ts.ts) == len(js.ts) == 200
    # 200 iterations at chunk 64: three full chunks and one partial
    assert [n for _, n, _ in ts.chunk_log] == [64, 64, 64, 8]
    assert all(ev is None for *_, ev in ts.chunk_log)  # no device clock


def test_ts_byte_identical(main_runs):
    js, _, ts, _, _ = main_runs
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())


def test_sign_records_equal(main_runs):
    _, jm, _, tm, _ = main_runs
    assert len(tm.data) == len(jm.data) == 200
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", ["r", "dr", "v", "dv", "E", "w"])
def test_final_state_close(main_runs, field):
    js, _, ts, _, _ = main_runs
    want = np.asarray(jax.device_get(getattr(js.sim_state, field)))
    got = getattr(ts.sim_state, field).numpy()
    assert got.shape == want.shape
    _assert_close(got, want)


def test_provider_call_matches_pipelined_run(main_runs):
    """``FusedProvider.__call__`` (dispatch + immediate harvest) gives the
    records and clock of the engine's pipelined run."""
    _, _, ts, tm, _ = main_runs
    s, _ = _build(T, lambda c: c.t >= 0.2, device="cpu")
    steps = s._ordered_steps()
    state = s._init_run_state()
    provider = s._build_execution(steps, state)
    sign_uid = steps[3]._step_uid
    clock, signs, done = [], [], False
    while not done:
        state, done, records, valid = provider(state)
        clock.extend(records[f"{steps[0]._step_uid}/ts"][valid])
        signs.extend(records[f"{sign_uid}/signs"][valid])
    assert (np.asarray(clock, np.float64).tobytes()
            == np.asarray(ts.ts, np.float64).tobytes())
    np.testing.assert_array_equal(np.asarray(signs),
                                  np.asarray(tm.data)[:, 2:])
    assert torch.equal(state.v, ts.sim_state.v)


def test_final_clock_and_alive_equal(main_runs):
    js, _, ts, _, _ = main_runs
    jst, tst = js.sim_state, ts.sim_state
    np.testing.assert_array_equal(tst.alive.numpy(), np.asarray(jst.alive))
    for f in ("t", "dt", "t_comp"):
        assert float(getattr(tst, f)) == float(getattr(jst, f)), f


def test_measure_csv_identical(main_runs):
    *_, d = main_runs
    assert (d / "torch.csv").read_bytes() == (d / "jax.csv").read_bytes()


def test_bench_parity_law(main_runs):
    """The +x share follows 0.5 + 0.5 (1 - pcoll)^k (bench.py:108-114)."""
    _, _, ts, tm, _ = main_runs
    data = np.asarray(tm.data)
    shares = data[:, 2] / np.maximum(data[:, 1], 1)
    pcoll = A * N_DENS * float(T.light.c) * DT
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, len(data) + 1)
    assert np.abs(shares - expect).max() < 0.02


def test_extinction_parity(extinction_runs):
    js, jm, ts, tm = extinction_runs
    assert js.used_fused and ts.used_fused
    assert len(ts.ts) == len(js.ts) > 0
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data)
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    assert tm.data[-1][1] == 0 and all(row[1] > 0 for row in tm.data[:-1])
    assert not ts.sim_state.alive.any()
    assert ts.get_state()["objects"] == 0
    for field in ("r", "v", "t", "t_comp"):
        _assert_close(getattr(ts.sim_state, field).numpy(),
                      np.asarray(jax.device_get(getattr(js.sim_state,
                                                        field))))


def test_t_exit_on_a_chunk_boundary():
    """An exit that fires right after a full chunk dispatches an empty
    chunk (k_act = 0), which must hand the state on unchanged."""
    exit_fn = lambda c: c.t >= 0.1275  # noqa: E731 — after 128 iterations
    (js, jm), (ts, tm) = (_build(J, exit_fn),
                          _build(T, exit_fn, device="cpu"))
    _run(js), _run(ts)
    assert [n for _, n, _ in ts.chunk_log] == [64, 64, 0]
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) == 128
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    for field in ("r", "v", "t"):
        _assert_close(getattr(ts.sim_state, field).numpy(),
                      np.asarray(jax.device_get(getattr(js.sim_state,
                                                        field))))


def test_wavelength_weighted_parity():
    """lambda^-4 weighting end to end: both packages fold A*n into the same
    per-photon base in ``setup``, so per-photon energies spread the
    collision probability identically (p ~ 2e-5 .. 5e-3 per iteration)."""
    E = np.random.default_rng(6).uniform(0.5, 2.0, N)
    runs = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        s = P.Simulation(exit=lambda c: c.t >= 0.1, seed=11, chunk_steps=64,
                         **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        # (E * wl_base)^4 * c * dt ~ 3e-4 at E = 1: A * n = 1e-9 * (h c)^4
        hc = float(P.light.h) * float(P.light.c)
        s.add_step(2, P.light.ScatterIsotropicStep(
            A=np.double(1e-9 * hc ** 4), n=np.double(1.0),
            wavelength_dep_scattering=True))
        meas = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, meas)
        s.add_photons(P.light.generate_photon_state(N, E=E))
        runs.append((_run(s), meas))
    (js, jm), (ts, tm) = runs
    assert js.used_fused and ts.used_fused and len(tm.data) == 100
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    assert tm.data[-1][2] < 0.99 * N  # scattering happened
    _assert_close(ts.sim_state.v.numpy(),
                  np.asarray(jax.device_get(js.sim_state.v)))


def test_photon_objects_then_bulk_parity():
    """``add_obj(PhotonObject)`` and ``add_photons`` together: both packages
    lay objects first, then bulk photons, in the same slots, so the draws
    and therefore the records and the final state agree."""
    rng = np.random.default_rng(8)
    d = rng.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = rng.normal(size=(300, 3))
    E = rng.uniform(0.5, 2.0, 300)
    runs = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        s = P.Simulation(exit=lambda c: c.t >= 0.05, seed=5, chunk_steps=16,
                         **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterIsotropicStep(A=np.double(A),
                                                   n=np.double(N_DENS)))
        meas = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, meas)
        c = float(P.light.c)
        for i in range(300):
            s.add_obj(P.light.PhotonObject(E=np.double(E[i]), v=d[i] * c,
                                           r=r[i]))
        s.add_photons(P.light.generate_photon_state(1000, E=1.0))
        runs.append((_run(s), meas))
    (js, jm), (ts, tm) = runs
    assert js.used_fused and ts.used_fused and len(tm.data) == 50
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    for field in ("r", "v", "E"):
        _assert_close(getattr(ts.sim_state, field).numpy(),
                      np.asarray(jax.device_get(getattr(js.sim_state,
                                                        field))))


def test_from_numpy_round_trip():
    """A JAX state carried into the port packs to the JAX packed state."""
    from physicl_tpu.state import SimState as JState
    from physicl_tpu_torch.state import SimState as TState

    rng = np.random.default_rng(4)
    bulk = J.light.generate_photon_state(
        3000, E=rng.uniform(0.5, 2, 3000), r=rng.normal(size=(3, 3000)),
        w=rng.uniform(0.1, 1, 3000))
    jst = JState.from_population([], [bulk])
    fields = jax.device_get({f: getattr(jst, f) for f in (
        "r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t", "dt",
        "t_comp", "n_spawned")})
    tst = TState.from_numpy(fields, device="cpu")
    np.testing.assert_array_equal(TF.pack_state(tst).numpy(),
                                  np.asarray(JF.pack_state(jst)))
    back = tst.to_numpy()
    for name, arr in fields.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == np.asarray(arr).dtype, name
    # the port's own host constructor lays the same population out alike
    own = TState.from_population([], [bulk], device="cpu")
    np.testing.assert_array_equal(TF.pack_state(own).numpy(),
                                  np.asarray(JF.pack_state(jst)))


def test_explain_plan_reports_fused():
    s, _ = _build(T, lambda c: c.t >= 0.01, device="cpu")
    text = s.explain_plan()
    assert "execution mode: fused (chunk=64" in text
    assert "t-schedule" in text and "const-norm |dr| = c*dt: on" in text
    assert s.sim_state is None  # planning left no state behind


# case -> (refusal code, the step that draws it)
_REFUSALS = {
    # a torch callable is recorded into a field program; one that leaves
    # torch (numpy on the traced values) cannot be
    "field-fn-callable-n": ("field-fn-callable",
                            lambda P: P.light.ScatterIsotropicStep(
                                A=0.001, n=0.001, variable_n=True,
                                variable_n_fn=lambda r0, r1, r2:
                                np.ones_like(np.asarray(r0)))),
    "field-fn-callable-A": ("field-fn-callable",
                            lambda P: P.light.ScatterDeleteStep(
                                0.001, 0.001,
                                A_fn=lambda E: np.asarray(E) * 0 + 1)),
    # a torch inverse CDF is recorded into the kernel
    # (tests/test_torch_phase.py); one that leaves torch cannot be
    "phase-icdf-callable": ("field-fn-callable",
                            lambda P: P.light.ScatterPhaseFunctionStep(
                                A=0.001, cos_theta_icdf=lambda u:
                                np.asarray(u) * 2 - 1)),
    # the JAX package's polarized step (the port has its own,
    # physicl_tpu_torch.polarization) is a step type the prover does not
    # know
    "polarized-step": ("unsupported-step",
                       lambda P: __import__(
                           "physicl_tpu.polarization").polarization
                       .ScatterPolarizedRayleighStep(A=0.001)),
    "kinematics-acceleration": ("kinematics-acceleration",
                                lambda P: P.newton.NewtonianKinematicsStep(
                                    integrate_acceleration=True)),
    "unsupported-step": ("unsupported-step", lambda P: P.Step()),
}


# case -> what the refused plan does, now that a refusal the JAX prover
# shares falls back to the generic step tier as in the JAX package:
# "refused" where the generic tier lacks a step too (start() raises the
# refusal), "generic" where it runs to completion, or, for a limit of the
# port's kernel (start() raises it, no fallback), the error the generic tier
# raises under fuse="off" (a field callable that leaves torch fails by name
# instead of running on the host)
_OUTCOMES = {
    "field-fn-callable-n": ("limit", TypeError,
                            "variable_n_fn callable .*<lambda> returned "
                            "ndarray"),
    "field-fn-callable-A": ("limit", TypeError,
                            "A_fn callable .*<lambda> returned ndarray"),
    "phase-icdf-callable": ("limit", TypeError,
                            "cos_theta_icdf callable .*<lambda> returned "
                            "ndarray"),
    "polarized-step": "refused",
    "kinematics-acceleration": "generic",
    "unsupported-step": "generic",
}


def _one_fallback_warning(record, code):
    """Exactly one RuntimeWarning, the fallback's, naming ``code``."""
    warned = [w for w in record if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == 1 and f"refused [{code}]" in str(warned[0].message)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_unported_step_options_refuse(case):
    """The refusal surfaces in explain_plan. Where it is a limit of the
    port's kernel or the generic tier lacks the step too, join() re-raises
    it from the run thread (which also reports it as the thread's own);
    otherwise the run falls back to the generic tier with one
    RuntimeWarning."""
    code, make = _REFUSALS[case]
    s, _ = _build(T, lambda c: c.t >= 0.01, device="cpu")
    s.add_step(9, make(T))
    assert f"refused [{code}]" in s.explain_plan()
    outcome = _OUTCOMES[case]
    if outcome == "refused" or outcome[0] == "limit":
        s.start()
        with pytest.raises(FusedRefusal, match=code) as e:
            s.join()
        assert isinstance(e.value, NotImplementedError)
        assert not s.used_fused
        if outcome == "refused":
            assert "the generic step tier lacks" in str(e.value)
            return
        assert "a limit of the port's fused_transport kernel" in str(
            e.value)
        # fuse="off" asks for the generic tier, which names what stops it
        s, _ = _build(T, lambda c: c.t >= 0.01, device="cpu", fuse="off")
        s.add_step(9, make(T))
        with pytest.raises(outcome[1], match=outcome[2]):
            s._run_impl()
        return
    with pytest.warns(RuntimeWarning) as record:
        s._run_impl()
        assert len(s.ts) == 10
    _one_fallback_warning(record, code)
    assert not s.used_fused
    assert s.explain_plan().startswith("execution mode: generic")


@pytest.mark.parametrize("code,kw", [
    ("extinction-without-death", {"exit": "extinction"}),
    ("exit-predicate", {"exit": lambda c: c.t >= 1 and len(c.objects) > 1}),
])
def test_unported_exits_refuse(code, kw):
    """Both exits fall back to the generic tier. The predicate that reads
    len(objects) runs host-exact to its end; nothing can die under the
    extinction exit, so that run would never end, and one chunk of its
    plan shows the fallback: every iteration valid, no exit."""
    s = T.Simulation(seed=0, device="cpu", **kw)
    s.add_step(0, T.UpdateTimeStep(lambda x: 0.001))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_photons(T.light.generate_photon_state(10, E=1.0))
    assert f"refused [{code}]" in s.explain_plan()
    with pytest.warns(RuntimeWarning) as record:
        if code == "exit-predicate":
            s._run_impl()
        else:
            plan = s._build_execution(s._ordered_steps(),
                                      s._init_run_state())
    if code == "exit-predicate":
        assert not s.used_fused and s.chunk_used == 1
        assert abs(len(s.ts) - 1000) <= 1 and s.ts[-1] >= 1.0
        assert "host-exact" in str(record[0].message)
    else:
        _one_fallback_warning(record, code)
        assert plan.provider is None and plan.chunk == 1024
        state, done, _, valid = plan(s.sim_state)
        assert valid.all() and not bool(done)
        assert int(state.n_alive) == 10


@pytest.mark.parametrize("kw", [{"auto_shrink": True}, {"fuse": "off"},
                                {"spatial_sort": 2},
                                {"mesh": ["cpu", "cpu"]}])
def test_unported_simulation_options_refuse(kw, monkeypatch):
    """fuse="off" runs the generic tier (the user's choice: no warning);
    auto_shrink=True, the default as in the JAX package, runs fused;
    spatial_sort=2 runs fused, unsorted, with one ``[no-voxel-table]``
    warning (this plan has no voxel medium to key it on); a one-process
    mesh= runs fused over its shards, and ``init_distributed`` without a
    coordinator (no argument, no torchrun variables) says which one it
    needs."""
    s, _ = _build(T, lambda c: c.t >= 0.01, device="cpu", **kw)
    if kw == {"auto_shrink": True}:
        assert T.Simulation().auto_shrink is True
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            s._run_impl()
        assert s.used_fused and len(s.ts) == 10
        return
    if kw == {"fuse": "off"}:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            s._run_impl()
        assert not s.used_fused and len(s.ts) == 10
        assert "fusion not attempted" in s.explain_plan()
        return
    if kw == {"spatial_sort": 2}:
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            s._run_impl()
        assert [str(w.message).split(":")[0] for w in record] == [
            "spatial_sort disabled [no-voxel-table]"]
        assert s.used_fused and len(s.ts) == 10 and s._sort_fn is None
        return
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s._run_impl()
    assert s.used_fused and len(s.ts) == 10
    assert s.sim_state.capacity == 2 * 16384 and len(s.mesh) == 2
    from physicl_tpu_torch.parallel import init_distributed

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed()
