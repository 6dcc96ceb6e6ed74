"""Polarized transport: the PyTorch port against the JAX package on the CPU
(``polarization.polarized_photon_state``, ``ScatterPolarizedRayleighStep``,
``ScatterPolarizedComptonStep``, ``StokesMeasureStep``, polarized
``PhotonEmitterStep`` sources and the fluorescent del's zeroing of the
Stokes and frame planes).

Both packages run the same ``Simulation`` (same seed, steps and initial
photons) through their fused tiers: the JAX package's emulated chunk
(``auto_shrink=False``, the port's only mode), the port's plain twin of its
CUDA kernel. The polarized ops draw from the same counter hash in the same
order, so ``sim.ts`` is byte-identical and every int record row and the
``alive`` plane are equal. The float32 planes, ``sim_state.extras``'s
``"stokes"`` and ``"pol_ref"`` among them, agree within 1e-4 of each plane's
largest value, as in the earlier slices' scatter tests, on all but a few
lanes: XLA's CPU backend contracts multiply-adds into FMAs, so a bisection
test ``fv < target`` that lies within an ulp flips (about one scatter in 50
under packed angles) and moves that azimuth by 2 pi 2**-17, the Stokes
vector by ~1e-4 and the later path by more; a photon that scatters at
every iteration collects several. Those lanes are counted and their number
bounded (``_MAX_FLIPPED``), and even they stay within 100 times the
tolerance (a wrong formula would not); every other lane holds the
tolerance. The Stokes tally's means (of quantities bounded by 1) agree
within 1e-5, heating and deposition sums within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu.polarization as JP
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
import physicl_tpu_torch.polarization as TP
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.ops.pipeline import FusedRefusal

DT = 1e-3
TOL = 1e-4      # of each plane's largest value
RTOL_F = 1e-5   # float records
# lanes allowed past TOL, as a share of the compared lanes: bisection flips
# (see the module docstring; 1% measured where photons scatter at every
# iteration, the lambda**-4 case)
_MAX_FLIPPED = 0.02


def _pkg(P):
    return JP if P is J else TP


def _photons(P, n, seed, stokes=None, **kw):
    """n polarized photons in seeded directions, energies in [0.5, 2];
    Stokes vectors of random degree unless given."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    if stokes is None:
        s = rng.normal(size=(3, n))
        stokes = s / np.linalg.norm(s, axis=0) * rng.uniform(0, 1, n)
    return _pkg(P).polarized_photon_state(
        n, E=rng.uniform(0.5, 2.0, n), r=rng.normal(size=(3, n)) * 1e4,
        v=d / np.linalg.norm(d, axis=0) * float(P.light.c), stokes=stokes,
        **kw)


def _build(P, case):
    """(sim, {name: measure step}) of one case on package P."""
    PP, L, N = _pkg(P), P.light, P.newton
    c_dt = float(L.c) * DT
    kw = {"device": "cpu"} if P is T else {"auto_shrink": False}
    k, chunk, cap = 48, 16, None
    if case == "multi-chunk-writeback":
        k, chunk = 96, 32
    if case == "emit-pol-directed":
        k, chunk, cap = 96, 16, 4096
    if case == "polarimetry":
        k = chunk = 16
    s = P.Simulation(until_t=DT * (k - 0.5), seed=7, chunk_steps=chunk,
                     capacity=cap, **kw)
    sign = L.ScatterSignMeasureStep(None, True)
    meas = {"sign": sign}
    pol = PP.ScatterPolarizedRayleighStep(A=0.1 / c_dt, n=1.0)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             N.NewtonianKinematicsStep()]
    if case in ("pol", "multi-chunk-writeback"):
        steps += [pol]
    elif case == "pol-wl":
        hc = P.raw_code_value(L.h) * P.raw_code_value(L.c)
        steps += [PP.ScatterPolarizedRayleighStep(
            A=0.1 * hc ** 4 / c_dt, n=1.0, wavelength_dep_scattering=True)]
    elif case == "pol-expr":
        steps += [PP.ScatterPolarizedRayleighStep(
            A=0.1 / c_dt, variable_n=True,
            variable_n_fn=f"fabs(r0[gid]) / {4e7} + 0.5")]
    elif case in ("polc", "polc-kn-dep"):
        comp = PP.ScatterPolarizedComptonStep(
            A=0.1 / c_dt, n=1.0, mec2=0.5,
            kn_cross_section=case == "polc-kn-dep",
            measure_deposition=case == "polc-kn-dep")
        steps += [comp]
        meas["comp"] = comp
    elif case in ("polmeas-w-qu", "polmeas-plain", "polmeas-no-n"):
        steps += [L.ScatterIsotropicStep(A=0.05 / c_dt, n=1.0)]
        meas["stokes"] = PP.StokesMeasureStep(
            None, measure_n=case != "polmeas-no-n",
            weighted=case == "polmeas-w-qu",
            local_qu=case != "polmeas-plain")
        steps += [meas["stokes"]]
    elif case == "pol-polmeas":
        meas["stokes"] = PP.StokesMeasureStep(None, weighted=True)
        steps += [pol, meas["stokes"]]
    elif case == "emit-pol-directed":
        # a polarized source before kinematics; the absorber frees slots
        # that the recycling compaction hands back to it
        steps.insert(1, L.PhotonEmitterStep(
            200, E=1.0, v=(0.0, 0.6 * float(L.c), 0.8 * float(L.c)),
            stokes=(0.6, 0.0, -0.8), pol_ref=(1.0, 1.0, 0.0)))
        steps += [pol, L.ScatterDeleteStep(0.2 / c_dt, 1.0)]
    elif case == "emit-iso-circular":
        steps.insert(1, L.PhotonEmitterStep(
            100, E=1.0, isotropic=True, stokes=(0.0, 0.0, 1.0)))
        steps += [pol]
    elif case == "fluor-pol-planes":
        dele = L.ScatterDeleteStep(0.05 / c_dt, 1.0,
                                   fluorescence=(0.5, 0.8, 0.6),
                                   measure_deposition=True)
        steps += [dele]
        meas["dep"] = dele
    elif case == "mixed-pol":
        steps += [pol, L.ScatterDeleteStep(0.01 / c_dt, 1.0)]
    elif case == "polarimetry":
        # make_polarimetry_nb.py's run: forced (pcoll = 2) polarized Compton
        # at alpha = E / mec2 = 0.5 with the heating tally, then the Stokes
        # tally without local Q and U
        a = np.sqrt(2.0 / c_dt)
        comp = PP.ScatterPolarizedComptonStep(A=a, n=a, mec2=2.0,
                                              measure_deposition=True)
        meas["comp"] = comp
        meas["stokes"] = PP.StokesMeasureStep(None, local_qu=False)
        steps += [comp, meas["stokes"]]
    else:
        raise KeyError(case)
    steps.append(sign)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    if case == "emit-pol-directed":
        s.add_photons(_photons(P, 1000, 1))
    elif case == "emit-iso-circular":
        s.add_photons(_photons(P, 1000, 2, stokes=(0.0, 0.0, 0.0)))
    elif case == "polarimetry":
        s.add_photons(PP.polarized_photon_state(4096, E=1.0,
                                                stokes=(1.0, 0.0, 0.0)))
    else:
        s.add_photons(_photons(P, 2000, 3))
    if case == "mixed-pol":
        # charges at ~c / 3: an ungated polarized scatter would reach them
        rng = np.random.default_rng(4)
        for i in range(200):
            s.add_obj(P.Object(
                r=P.Measurement(rng.normal(size=3) * 1e4, "m**1"),
                v=P.Measurement(rng.normal(size=3) * 1e8, "m**1 s**-1")))
    return s, meas


_CASES = ("pol", "pol-wl", "pol-expr", "polc", "polc-kn-dep",
          "polmeas-w-qu", "polmeas-plain", "polmeas-no-n", "pol-polmeas",
          "emit-pol-directed", "emit-iso-circular", "fluor-pol-planes",
          "mixed-pol", "multi-chunk-writeback", "polarimetry")


@pytest.fixture(scope="module", params=_CASES)
def runs(request):
    out = []
    for P in (J, T):
        s, meas = _build(P, request.param)
        s.start()
        s.join()
        out.append((s, meas))
    return request.param, out


def test_polarized_runs_fused_on_both(runs):
    case, ((js, _), (ts, _)) = runs
    assert js.used_fused and ts.used_fused, ts.explain_plan()
    text = ts.explain_plan()
    if case.startswith("polmeas"):  # the tally reads the planes only
        assert "stokes:0" in text and "writes back" not in text
    else:
        assert "kernel writes back: stokes, pol_ref" in text


def test_polarized_ts_and_int_records_equal(runs):
    _, ((js, jm), (ts, tm)) = runs
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    a, b = tm["sign"].data, jm["sign"].data
    assert len(a) == len(b) == len(ts.ts) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_polarized_alive_and_spawn_equal(runs):
    _, ((js, _), (ts, _)) = runs
    jst, tst = js.sim_state, ts.sim_state
    for name in ("alive", "otype", "n_spawned"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


def _planes(s):
    st = s.sim_state
    get = (lambda x: x.numpy()) if s.__module__.startswith(
        "physicl_tpu_torch") else (lambda x: np.asarray(jax.device_get(x)))
    out = {f: get(getattr(st, f)) for f in ("r", "v", "dv", "E", "w")}
    for name in ("stokes", "pol_ref"):
        out[name] = get(st.extras[name])
    return out


def test_polarized_planes_close(runs):
    """Live slots (dead ones keep drifting under kinematics, unread): every
    plane within TOL of its largest value but on at most _MAX_FLIPPED of
    the lanes, and those within 100 TOL."""
    _, ((js, _), (ts, _)) = runs
    live = np.asarray(js.sim_state.alive)
    want, got = _planes(js), _planes(ts)
    off = np.zeros(int(live.sum()), bool)
    for name in want:
        w = np.atleast_2d(want[name][..., live])
        g = np.atleast_2d(got[name][..., live])
        # dv = v_new - v rounds at the scale of v
        ref = (np.atleast_2d(want["v"][..., live]) if name == "dv" else w)
        for wr, gr, sr in zip(w, g, ref):
            scale = max(float(np.abs(sr).max()), 1e-30)
            diff = np.abs(gr - wr)
            off |= diff > TOL * scale
            assert float(diff.max()) <= 100 * TOL * scale, name
    assert int(off.sum()) <= _MAX_FLIPPED * off.size, (int(off.sum()),
                                                       off.size)


def test_polarized_float_records_close(runs):
    case, ((_, jm), (_, tm)) = runs
    for name in ("stokes", "comp", "dep"):
        if name not in jm or name == "comp" and not jm[name].data:
            continue
        a = np.asarray(tm[name].data, np.float64)
        b = np.asarray(jm[name].data, np.float64)
        assert a.shape == b.shape and a.size > 0, name
        np.testing.assert_array_equal(a[:, 0], b[:, 0])  # t
        if name == "stokes":
            step = tm["stokes"]
            assert a.shape[1] == 3 + step.measure_n + 2 * step.local_qu
            if step.measure_n:
                np.testing.assert_array_equal(a[:, 1], b[:, 1])
            means = a[:, 1 + step.measure_n:] - b[:, 1 + step.measure_n:]
            assert float(np.abs(means).max()) <= RTOL_F, name
        else:
            scale = np.abs(b).max(axis=0, keepdims=True)
            assert np.all(np.abs(a - b) <= RTOL_F * (np.abs(b) + scale)), (
                name, float(np.abs(a - b).max()))


def test_polarized_case_behaviour(runs):
    """What each case is there to show, on the port's own run."""
    case, (_, (ts, tm)) = runs
    st = ts.sim_state
    stokes, frame = st.extras["stokes"].numpy(), st.extras["pol_ref"].numpy()
    alive = st.alive.numpy()
    v = st.v.numpy().astype(np.float64)
    text = ts.explain_plan()
    if any(type(x).__name__.startswith("ScatterPolarized")
           for x in ts.steps.values()):
        # a polarized op re-orthonormalizes every frame each iteration:
        # every live photon's frame is unit and perpendicular to v
        ph = alive & (st.otype.numpy() == 1)
        d = v[:, ph] / np.linalg.norm(v[:, ph], axis=0)
        np.testing.assert_allclose(np.linalg.norm(frame[:, ph], axis=0), 1.0,
                                   atol=1e-5)
        assert float(np.abs((frame[:, ph] * d).sum(0)).max()) < 1e-5
    assert float(np.linalg.norm(stokes, axis=0).max()) <= 1 + 1e-5
    if case == "mixed-pol":
        assert "15 core + stokes:0" in text and "+ otype" in text
        charged = st.otype.numpy() != 1
        assert int((charged & alive).sum()) == 200  # never absorbed
        assert not np.any(st.dv.numpy()[:, charged[:]] != 0)  # never turned
    if case == "emit-pol-directed":
        assert any(e[0] == "recycle" for e in ts.population_log)
    if case == "emit-iso-circular":
        # emitted photons start circular with a zero frame; those not yet
        # scattered keep V = 1
        em = np.arange(stokes.shape[1]) >= 1000
        em &= alive & (np.abs(stokes[2]) == 1.0)
        assert int(em.sum()) > 0
    if case == "fluor-pol-planes":
        assert "kernel writes back: stokes, pol_ref" in text
        relit = alive & (np.abs(st.E.numpy() - 0.8) < 1e-6)
        assert int(relit.sum()) > 0
        assert not np.any(stokes[:, relit]) and not np.any(frame[:, relit])
    if case == "polarimetry":
        # the pure source (p = 1) depolarizes over the first three forced
        # scatters (the Fano matrix's kappa - 2 at alpha = 0.5), then the
        # recoil lowers alpha toward the Thomson limit and the mean purity
        # recovers; test_polarized_float_records_close holds these rows to
        # the JAX package's, so the shape is the reference's too
        rows = np.asarray(tm["stokes"].data, np.float64)
        p_mean = rows[:, 2]
        assert rows.shape == (16, 4) and not np.any(rows[:, 3])  # V = 0
        assert p_mean[0] < 0.97 and p_mean[0] > p_mean[1] > p_mean[2]
        assert np.all(np.diff(p_mean[2:]) > 0)
    if case == "multi-chunk-writeback":
        # three chunks (and the empty one a t-exit on a boundary adds)
        assert [n for _, n, _ in ts.chunk_log if n] == [32, 32, 32]


# -- the population and the steps ---------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"pol_ref": (1.0, 0.0, 0.0)}, {"stokes": (0.3, -0.4, 0.5)},
    {"per_photon": True}], ids=["default", "pol_ref", "stokes", "per-photon"])
def test_polarized_photon_state_matches_jax(kw):
    """Host planes exactly equal (both build them in float64 with numpy)."""
    kw = dict(kw)
    rng = np.random.default_rng(0)
    n = 257
    d = rng.normal(size=(3, n))
    d[:, :5] = [[0.0], [0.0], [1.0]]  # along z: the y-hat default frame
    args = dict(v=d / np.linalg.norm(d, axis=0) * 3e8, E=1.5)
    if kw.pop("per_photon", False):
        s = rng.normal(size=(3, n))
        kw["stokes"] = s / np.linalg.norm(s, axis=0) * 0.7
        kw["pol_ref"] = rng.normal(size=(3, n))
    a = JP.polarized_photon_state(n, **args, **kw)
    b = TP.polarized_photon_state(n, **args, **kw)
    for name in ("stokes", "pol_ref"):
        assert b["extras"][name].dtype == np.float64
        np.testing.assert_array_equal(b["extras"][name], a["extras"][name])
    for name in ("E", "v", "r"):
        np.testing.assert_array_equal(b[name], a[name])


def test_polarized_photon_state_on_a_device():
    """The device path (float32 tensors, no host checks) against the JAX
    package's device path."""
    rng = np.random.default_rng(1)
    d = rng.normal(size=(3, 100))
    kw = dict(E=1.0, v=d / np.linalg.norm(d, axis=0) * 3e8,
              stokes=(0.5, 0.0, 0.5), pol_ref=(0.0, 1.0, 0.0))
    a = JP.polarized_photon_state(100, device=True, **kw)
    b = TP.polarized_photon_state(100, device="cpu", **kw)
    for name in ("stokes", "pol_ref"):
        got = b["extras"][name]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(a["extras"][name]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw, match", [
    ({"stokes": (0.9, 0.5, 0.0)}, "degree of polarization"),
    ({"pol_ref": (1.0, 0.0, 0.0)}, "parallel"),
])
def test_polarized_photon_state_errors_match_jax(kw, match):
    for PP in (JP, TP):
        with pytest.raises(ValueError, match=match):
            PP.polarized_photon_state(4, E=1.0, **kw)


def _sim(P, population, steps):
    s = P.Simulation(until_t=0.005, seed=0, device="cpu")
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    for i, st in enumerate(steps):
        s.add_step(2 + i, st)
    s.add_photons(population)
    return s


_STEPS = {
    "rayleigh": lambda: TP.ScatterPolarizedRayleighStep(A=1.0, n=1.0),
    "compton": lambda: TP.ScatterPolarizedComptonStep(A=1.0, n=1.0),
    "stokes-measure": lambda: TP.StokesMeasureStep(None),
    "emitter": lambda: T.light.PhotonEmitterStep(10, stokes=(0.0, 0.0, 1.0),
                                                 isotropic=True),
}


@pytest.mark.parametrize("name", sorted(_STEPS))
def test_polarization_planes_refusal(name):
    """A population without both planes is refused, as the JAX prover
    refuses it."""
    s = _sim(T, T.light.generate_photon_state(16, E=1.0), [_STEPS[name]()])
    assert "refused [polarization-planes]" in s.explain_plan()
    if name == "emitter":
        # the emitter has a generic apply: the run falls back and fails
        # there by name, as the JAX package's generic scan does
        with pytest.warns(RuntimeWarning, match="polarization-planes"):
            with pytest.raises(ValueError, match="no Stokes planes"):
                s._run_impl()
        return
    with pytest.raises(FusedRefusal, match="polarization-planes"):
        s._run_impl()


@pytest.mark.parametrize("name", sorted(_STEPS))
def test_polarized_steps_fuse_with_the_planes(name):
    s = _sim(T, TP.polarized_photon_state(16, E=1.0), [_STEPS[name]()])
    assert "refused" not in s.explain_plan()


@pytest.mark.parametrize("name", ["rayleigh", "compton", "stokes-measure"])
def test_apply_names_missing_planes_then_the_generic_tier(name):
    from physicl_tpu_torch.state import SimState

    step = _STEPS[name]()
    step.setup(None)
    bare = SimState.from_population(
        [], [T.light.generate_photon_state(4, E=1.0)], device="cpu")
    with pytest.raises(ValueError, match="no Stokes planes") as e:
        step.apply(bare, None)
    assert str(e.value) == TP._MISSING_PLANES_MSG
    full = SimState.from_population(
        [], [TP.polarized_photon_state(4, E=1.0)], device="cpu")
    with pytest.raises(NotImplementedError, match="generic step tier"):
        step.apply(full, None)


def test_step_options_match_jax():
    for PP in (JP, TP):
        with pytest.raises(ValueError, match="unknown option"):
            PP.ScatterPolarizedRayleighStep(g=0.5)
        with pytest.raises(ValueError, match="unknown option"):
            PP.ScatterPolarizedComptonStep(T_e=1e6)
    a = JP.ScatterPolarizedComptonStep(mec2=2.0)
    b = TP.ScatterPolarizedComptonStep(mec2=2.0)
    a.setup(None)
    b.setup(None)
    assert a._inv_mec2 == b._inv_mec2 == 0.5
    a = JP.ScatterPolarizedComptonStep()
    b = TP.ScatterPolarizedComptonStep()
    a.setup(None)
    b.setup(None)
    assert a._inv_mec2 == b._inv_mec2 and a._coef == b._coef


@pytest.mark.parametrize("kw, match", [
    ({"stokes": (1.0, 0.5, 0.0)}, "degree"),
    ({"stokes": (0.5, 0.0, 0.0), "isotropic": True}, "circular"),
    ({"pol_ref": (0.0, 0.0, 1.0)}, "without stokes"),
])
def test_emitter_validation_matches_jax(kw, match):
    for P in (J, T):
        with pytest.raises(ValueError, match=match):
            P.light.PhotonEmitterStep(10, **kw)


@pytest.mark.parametrize("kw", [
    {"stokes": (1.0, 0.0, 0.0)},
    {"stokes": (0.0, 0.6, 0.8), "v": (0.0, 3e8, 0.0),
     "pol_ref": (1.0, 1.0, 1.0)},
    {"stokes": (0.0, 0.0, 1.0), "isotropic": True},
    {"stokes": (0.0, 0.0, 0.5), "v": (0.0, 0.0, 3e8)}])
def test_emitter_frame_matches_jax(kw):
    a = J.light.PhotonEmitterStep(10, **kw)
    b = T.light.PhotonEmitterStep(10, **kw)
    a.setup(None)
    b.setup(None)
    assert a._emit_e1 == b._emit_e1


def test_emitter_parallel_pol_ref_raises_like_jax():
    for P in (J, T):
        step = P.light.PhotonEmitterStep(10, stokes=(1.0, 0.0, 0.0),
                                         pol_ref=(2.0, 0.0, 0.0))
        with pytest.raises(ValueError, match="parallel"):
            step.setup(None)


# -- the azimuth bisection -----------------------------------------------------

_AB = [(0.0, 0.0), (0.3, -0.4), (-0.7, 0.2), (0.999, 0.0), (0.0, -0.999),
       (0.706, 0.706)]


def _us():
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.random(512),
        np.array([0.0, 0.25, 0.5, 0.75, 1.0 - 2 ** -17, 0.249999, 0.250001,
                  0.499999, 0.500001, 0.749999, 0.750001]),
    ]).astype(np.float32)


@pytest.mark.parametrize("iters", [TF.POL_ITERS, TF.POLC_ITERS])
@pytest.mark.parametrize("ab", _AB, ids=str)
def test_bisect_phi_sincos_vs_f64_oracle(ab, iters):
    """The twin's azimuth inversion in u space against the float64 CDF (as
    tests/test_polarization.py pins the JAX one), and the quadruple's
    consistency that the frame algebra relies on."""
    a, b = ab
    us = _us()
    sp, cp, s2p, c2p = (x.double().numpy() for x in TF._bisect_phi_sincos(
        torch.from_numpy(us), torch.tensor(np.float32(a)),
        torch.tensor(np.float32(b)), iters=iters))
    np.testing.assert_allclose(sp * sp + cp * cp, 1.0, atol=1e-5)
    np.testing.assert_allclose(s2p, 2.0 * sp * cp, atol=2e-5)
    np.testing.assert_allclose(c2p, cp * cp - sp * sp, atol=2e-5)
    phi = np.arctan2(sp, cp) % (2.0 * np.pi)
    f_hat = (phi + 0.5 * a * np.sin(2 * phi)
             + 0.5 * b * (1.0 - np.cos(2 * phi))) / (2.0 * np.pi)
    err = np.abs(f_hat - us.astype(np.float64))
    err = np.minimum(err, 1.0 - err)
    assert err.max() < 2.0 * 2.0 ** -iters + 3e-6, (a, b, iters, err.max())


def _uab(n, seed):
    """n uniforms and CDF coefficients (a, b) with |(a, b)| <= 0.95 (a
    density: the CDF is monotone)."""
    rng = np.random.default_rng(seed)
    r, t = rng.uniform(0, 0.95, n), rng.uniform(0, 2 * np.pi, n)
    return (rng.random(n).astype(np.float32),
            (r * np.cos(t)).astype(np.float32),
            (r * np.sin(t)).astype(np.float32))


@pytest.mark.parametrize("iters", [TF.POL_ITERS, TF.POLC_ITERS])
def test_bisect_phi_sincos_matches_jax(iters):
    """Against the JAX kernel's function on the same float32 inputs: within
    2 ulp of 1 (XLA's FMAs and rsqrt), with no lane flipped."""
    from physicl_tpu.ops.fused import _bisect_phi_sincos as jax_bisect

    n = 20_000
    u, a, b = _uab(n, 3)
    want = jax_bisect(jax.numpy.asarray(u), jax.numpy.asarray(a),
                      jax.numpy.asarray(b), iters=iters)
    got = TF._bisect_phi_sincos(torch.from_numpy(u), torch.from_numpy(a),
                                torch.from_numpy(b), iters=iters)
    for w, g in zip(want, got):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 2.4e-7


def test_rot_table_is_the_float32_rounding_of_float64():
    sd, cd = TF.rot_table()
    for k in range(1, TF.POLC_ITERS + 1):
        delta = np.pi / (1 << k)
        assert sd[k] == np.float32(np.sin(2.0 * delta))
        assert cd[k] == np.float32(np.cos(2.0 * delta))


def test_generic_references_agree():
    """The generic tier's torch forms against the JAX package's: the
    bisection and the phase-matrix core on the same inputs (libm sines on
    either side: within 1e-5)."""
    from physicl_tpu.polarization import (_apply_phase_matrix as jax_apm,
                                          _bisect_phi as jax_bisect)
    from physicl_tpu.state import SimState as JState

    rng = np.random.default_rng(5)
    n = 4096
    u, a, b = _uab(n, 6)
    np.testing.assert_allclose(
        TP._bisect_phi(torch.from_numpy(u), torch.from_numpy(a),
                       torch.from_numpy(b)).numpy(),
        np.asarray(jax_bisect(jax.numpy.asarray(u), jax.numpy.asarray(a),
                              jax.numpy.asarray(b))), atol=1e-5)
    s = rng.normal(size=(3, n))
    bulk = JP.polarized_photon_state(
        n, E=1.0, v=rng.normal(size=(3, n)) * 1e8,
        stokes=s / np.linalg.norm(s, axis=0) * rng.uniform(0, 1, n))
    jst = JState.from_population([], [bulk], capacity=n)
    cos_t = rng.uniform(-1, 1, n).astype(np.float32)
    uphi = rng.random(n).astype(np.float32)
    scatter = rng.random(n) < 0.7
    want = jax_apm(jst, jax.numpy.asarray(scatter),
                   jax.numpy.asarray(cos_t), jax.numpy.asarray(uphi),
                   jax.numpy.float32(2.0), 3e8, jax.numpy.float32)
    ex = {k: torch.from_numpy(np.asarray(v)) for k, v in jst.extras.items()}
    got = TP._apply_phase_matrix(
        torch.from_numpy(np.asarray(jst.v)), ex["stokes"], ex["pol_ref"],
        torch.from_numpy(scatter), torch.from_numpy(cos_t),
        torch.from_numpy(uphi), 2.0, 3e8)
    for w, g, scale in zip(want, got, (3e8, 3e8, 1.0, 1.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)


def test_unpack_state_returns_written_back_planes():
    """``unpack_state`` takes the written-back rows into ``extras`` (views
    where the rows lie in order) and keeps the host's other planes."""
    from physicl_tpu_torch.state import SimState

    st = SimState.from_population(
        [], [TP.polarized_photon_state(8, E=1.0)], device="cpu")
    st = st.replace(extras={**st.extras, "tag": torch.arange(
        st.capacity, dtype=torch.float32)})
    names = TF.POL_ROWS + ("tag",)
    packed = TF.pack_state(st, names)
    packed[15:21] += 1.0
    out = TF.unpack_state(packed, st, names, ("stokes", "pol_ref"))
    assert torch.equal(out.extras["stokes"], packed[15:18])
    assert out.extras["pol_ref"].data_ptr() == packed[18].data_ptr()
    assert out.extras["tag"] is st.extras["tag"]
    assert TF.unpack_state(packed, st).extras is st.extras
