"""The continuous photon source and slot recycling: the PyTorch port against
the JAX package.

Both packages run the same ``Simulation`` (same seed, same steps, same
initial photons) on the CPU: the JAX package through its emulated fused
chunk, the port through the plain twin of its CUDA kernel. The emitter's
slots come from the same host-replayed schedule and its draws from the same
counter hash, and recycling compacts at the same chunk boundaries, so:

* ``sim.ts`` is byte-identical and every ``ScatterSignMeasureStep.data``
  row is equal;
* the final spawn mark ``n_spawned`` and the ``alive`` plane are equal;
* the other planes of the live slots agree within rtol 1e-6 + atol 1e-6 *
  max|plane| (XLA's CPU backend contracts multiply-adds into FMAs, the twin
  does not), and sampled energies within the inverse CDF's tolerance
  (test_torch_planck). Dead slots are left out: kinematics keeps moving
  them, and over hundreds of iterations the FMA rounding gap in their
  never-read positions grows past that tolerance (136 ulp after 200
  iterations in the recycling case; live slots stay within 1 ulp).
"""

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
from physicl_tpu.ops import compaction as JC
from physicl_tpu_torch.ops import compaction as TC
from physicl_tpu_torch.ops.pipeline import FusedRefusal

DT = 0.001


def _sampler(P):
    kT = float(P.light.kB.value()) * 5778.0
    return P.light.PlanckSampler(0.1 * kT, 12 * kT, 5778.0, bins=2000)


# name -> (emitter kwargs, steps after the emitter, capacity, t_end,
#          chunk_steps, emitter placed before kinematics)
_CASES = {
    "const-directed": (dict(n_per_step=100, E=2.0), ("kin", "sign"),
                       16384, 0.010, None, True),
    "isotropic": (dict(n_per_step=1000, E=1.0, isotropic=True),
                  ("kin", "del", "sign"), 65536, 0.040, None, True),
    "planck": (dict(n_per_step=2000, E="planck"), ("kin", "iso", "sign"),
               65536, 0.032, None, True),
    "capacity-stop": (dict(n_per_step=10000, E=1.0), ("sign",),
                      16384, 0.010, None, True),
    "recycle-chunk32": (dict(n_per_step=500, E=1.0, isotropic=True),
                        ("kin", "del", "sign"), 16384, 0.2, 32, True),
    "after-kin": (dict(n_per_step=1000, E=1.0, isotropic=True),
                  ("del", "iso", "sign"), 65536, 0.020, None, False),
}


def _build(P, case, **kw):
    emit_kw, after, cap, t_end, chunk, before_kin = _CASES[case]
    s = P.Simulation(exit=lambda c: c.t >= t_end, seed=3, capacity=cap,
                     chunk_steps=chunk, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    emit_kw = dict(emit_kw)
    if emit_kw["E"] == "planck":
        emit_kw["E"] = _sampler(P)
    steps = [P.light.PhotonEmitterStep(**emit_kw)]
    if not before_kin:
        steps.insert(0, P.newton.NewtonianKinematicsStep())
    sign = P.light.ScatterSignMeasureStep(None, True)
    for name in after:
        steps.append({
            "kin": lambda: P.newton.NewtonianKinematicsStep(),
            "del": lambda: P.light.ScatterDeleteStep(np.double(0.001),
                                                     np.double(0.001)),
            "iso": lambda: P.light.ScatterIsotropicStep(A=np.double(0.001),
                                                        n=np.double(0.001)),
            "sign": lambda: sign,
        }[name]())
    for i, st in enumerate(steps, start=1):
        s.add_step(i, st)
    s.add_photons(P.light.generate_photon_state(100, E=1.0))
    return s, sign


def _run(s):
    s.start()
    s.join()
    return s


@pytest.fixture(scope="module", params=sorted(_CASES))
def runs(request):
    case = request.param
    js, jm = _build(J, case)
    ts, tm = _build(T, case, device="cpu")
    return case, _run(js), jm, _run(ts), tm


def _close(got, want, rtol=1e-6):
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want) <= rtol * np.abs(want) + rtol * scale)


def test_emitter_runs_fused_on_both(runs):
    _, js, _, ts, _ = runs
    assert js.used_fused and ts.used_fused


def test_emitter_ts_and_records_equal(runs):
    _, js, jm, ts, tm = runs
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) > 0
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)


def test_emitter_spawn_mark_and_alive_equal(runs):
    _, js, _, ts, _ = runs
    assert int(ts.sim_state.n_spawned) == int(jax.device_get(
        js.sim_state.n_spawned))
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(),
                                  np.asarray(js.sim_state.alive))
    np.testing.assert_array_equal(ts.sim_state.otype.numpy(),
                                  np.asarray(js.sim_state.otype))
    assert len(ts.objects) == len(js.objects)


@pytest.mark.parametrize("field", ["r", "v", "E", "w"])
def test_emitter_planes_close(runs, field):
    case, js, _, ts, _ = runs
    live = np.asarray(js.sim_state.alive)
    want = np.asarray(jax.device_get(getattr(js.sim_state, field)))[...,
                                                                    live]
    got = getattr(ts.sim_state, field).numpy()[..., live]
    # sampled energies: the inverse CDF's Horner chain contracts into FMAs
    # on XLA's CPU backend (test_torch_planck bounds it at 1e-5 relative)
    _close(got, want, 1e-5 if (case == "planck" and field == "E") else 1e-6)


def test_emitter_case_behaviour(runs):
    """What each case is there to show, on the port's own run."""
    case, _, _, ts, tm = runs
    ns = np.array([row[1] for row in tm.data])
    log = [e[0] for e in ts.population_log]
    if case == "const-directed":
        assert list(ns) == [100 + 100 * (i + 1) for i in range(10)]
    elif case == "capacity-stop":
        # 100 + 10000 fits once; the second batch would exceed 16384
        assert len(ts.objects) == 10100 and log == ["capacity-stop"]
    elif case == "recycle-chunk32":
        # the arena (16384 slots) holds ~33 iterations of emission; 200
        # iterations at the fixed point N* = emit (1-p)/p need recycling
        assert log.count("recycle") >= 3
        p = 0.001 * 0.001 * float(T.light.c) * DT
        n_star = 500 * (1 - p) / p
        assert len(ns) == 200
        assert abs(ns[-50:].mean() - n_star) / n_star < 0.1
    elif case == "planck":
        E = ts.sim_state.E.numpy()[ts.sim_state.alive.numpy()][100:]
        s = _sampler(T)
        assert np.all((E >= s.E_min * 0.999) & (E <= s.E_max * 1.001))


@pytest.mark.parametrize("case,const_norm", [("isotropic", True),
                                             ("after-kin", False)])
def test_emitter_const_norm_follows_position(case, const_norm):
    """An emitter before kinematics keeps the |dr| = c dt fast path; one
    after it turns it off (its photons carry dr = 0 for an iteration)."""
    from physicl_tpu.ops.pipeline import try_build_fused as j_build
    from physicl_tpu_torch.ops.pipeline import try_build_fused as t_build

    for P, build, kw in ((J, j_build, {}), (T, t_build, {"device": "cpu"})):
        s, _ = _build(P, case, **kw)
        steps = s._ordered_steps()
        for st in steps:
            st.setup(s)
        provider = build(s, steps, s._init_run_state())
        assert (provider.plan.const_norm_speed is not None) == const_norm


def test_compact_matches_jax():
    """The stable partition moves every plane exactly as the JAX one."""
    from physicl_tpu.state import SimState as JState
    from physicl_tpu_torch.state import SimState as TState

    rng = np.random.default_rng(9)
    n = 3000
    bulk = J.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2, n), r=rng.normal(size=(3, n)),
        v=rng.normal(size=(3, n)), w=rng.uniform(0.1, 1, n))
    jst = JState.from_population([], [bulk])
    jst = jst.replace(alive=jst.alive & jax.numpy.asarray(
        rng.uniform(size=jst.capacity) < 0.4))
    names = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t",
             "dt", "t_comp", "n_spawned")
    fields = jax.device_get({f: getattr(jst, f) for f in names})
    want = jax.device_get(JC.compact(jst))
    got = TC.compact(TState.from_numpy(fields, device="cpu")).to_numpy()
    for f in names:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


# case -> (emitter, the refusal's code). A polarized source is ported; on a
# population without Stokes planes it is refused as the JAX prover refuses
# it (tests/test_torch_polarization.py runs it on one that has them)
_REFUSALS = {
    "emitter-polarized": (lambda: T.light.PhotonEmitterStep(
        10, E=1.0, stokes=(0.0, 0.0, 1.0)), "polarization-planes"),
    "emitter-sampler": (lambda: T.light.PhotonEmitterStep(
        10, E=lambda g, k: torch.rand(k, generator=g)), "emitter-sampler"),
}


@pytest.mark.parametrize("code", sorted(_REFUSALS))
def test_unported_emitters_refuse(code):
    """Both refusals fall back to the generic tier: the sampler's run
    completes with the callable's energies in the emitted slots; the
    polarized source fails there as in the JAX package (no Stokes planes
    to write)."""
    make, refusal = _REFUSALS[code]
    s = T.Simulation(until_t=0.01, seed=0, device="cpu", capacity=16384)
    s.add_step(0, T.UpdateTimeStep(lambda x: 0.001))
    s.add_step(1, make())
    s.add_photons(T.light.generate_photon_state(10, E=1.0))
    assert f"refused [{refusal}]" in s.explain_plan()
    with pytest.warns(RuntimeWarning, match=rf"refused \[{refusal}\]"):
        if code == "emitter-polarized":
            with pytest.raises(ValueError, match="no Stokes planes"):
                s._run_impl()
        else:
            s._run_impl()
    assert not s.used_fused
    if code == "emitter-sampler":
        E = s.sim_state.E.numpy()
        assert int(s.sim_state.n_spawned) == 10 + 10 * len(s.ts)
        assert (E[:10] == 1.0).all()
        emitted = E[10:int(s.sim_state.n_spawned)]
        assert ((emitted >= 0) & (emitted < 1)).all()
        assert len(np.unique(emitted)) == emitted.size


@pytest.mark.parametrize("code,kw", [
    ("extinction-with-emitter", {"exit": "extinction"}),
    ("mixed-species", {"until_t": 0.01}),
])
def test_emitter_plans_refuse(code, kw):
    s = T.Simulation(seed=0, device="cpu", capacity=16384, **kw)
    s.add_step(0, T.UpdateTimeStep(lambda x: 0.001))
    s.add_step(1, T.light.PhotonEmitterStep(10, E=1.0))
    s.add_step(2, T.light.ScatterDeleteStep(0.001, 0.001))
    if code == "mixed-species":
        # an emitter on a non-photon population, refused until the otype
        # gate was ported: the plan is mixed from the start, the emitted
        # slots are photons and the generic object stays one
        s.add_obj(T.Object())
        s._run_impl()
        assert "mixed (otype-plane dispatch)" in s.explain_plan()
        otype = s.sim_state.otype.numpy()
        assert otype[0] == 0 and (otype[1:101] == 1).all()
        assert bool(s.sim_state.alive[0])
    else:
        # falls back to the generic tier, where emission never lets the
        # population die out: one chunk of the plan shows the fallback
        s.add_photons(T.light.generate_photon_state(10, E=1.0))
        assert f"refused [{code}]" in s.explain_plan()
        with pytest.warns(RuntimeWarning, match=rf"refused \[{code}\]"):
            plan = s._build_execution(s._ordered_steps(),
                                      s._init_run_state())
        assert plan.provider is None
        state, done, _, valid = plan(s.sim_state)
        assert valid.all() and not bool(done)
        assert int(state.n_spawned) == 10 + 10 * plan.chunk
    # the generic apply: ten photons at the spawn mark, +x at c
    from physicl_tpu_torch.engine import StepContext

    st = T.SimState.from_population(
        [], [T.light.generate_photon_state(10, E=2.0)], device="cpu")
    step = T.light.PhotonEmitterStep(10)
    out = step.apply(st, StepContext(st.key, None))
    assert int(out.n_spawned) == 20 and out.alive[:20].all()
    assert not out.alive[20:].any()
    np.testing.assert_array_equal(out.E[10:20].numpy(), 1.0)
    np.testing.assert_array_equal(out.v[0, 10:20].numpy(),
                                  np.float32(float(T.light.c)))


def test_device_bulk_population_matches_jax():
    """An initial population made on the port's device (the generation
    kernel's twin and ``generate_photon_state(device=...)``) runs exactly as
    the same energies handed to the JAX package as a host bulk; the
    prover's speed check reduces the device bulk on the device and keeps
    the const-norm fast path."""
    sampler = _sampler(T)
    E0 = sampler.sample_device(5, 3000, device="cpu")
    sims = []
    for P, bulk, kw in (
            (J, J.light.generate_photon_state(3000, E=E0.numpy()), {}),
            (T, T.light.generate_photon_state(3000, E=E0, device="cpu"),
             {"device": "cpu"})):
        s = P.Simulation(until_t=0.0395, seed=6, capacity=16384, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.light.PhotonEmitterStep(200, E=_sampler(P),
                                                isotropic=True))
        s.add_step(2, P.newton.NewtonianKinematicsStep())
        s.add_step(3, P.light.ScatterDeleteStep(np.double(0.001),
                                                np.double(0.001)))
        sign = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(4, sign)
        s.add_photons(bulk)
        sims.append((_run(s), sign))
    (js, jm), (ts, tm) = sims
    assert isinstance(E0, torch.Tensor) and ts.used_fused
    assert "const-norm |dr| = c*dt: on" in ts.explain_plan()
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) == 40
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    assert int(ts.sim_state.n_spawned) == int(jax.device_get(
        js.sim_state.n_spawned))
