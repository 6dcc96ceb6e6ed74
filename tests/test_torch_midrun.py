"""Mid-run population edits: ``add_obj`` / ``add_photons`` / ``remove_obj``
during a run, against the JAX package.

An edit is queued and lands at the next chunk boundary where the engine
maintains the population. A step's ``collect`` runs while chunks are
harvested, with up to ``fused_pipeline_depth`` chunks in flight, so an edit
queued there lands where the pipeline next drains: a deterministic boundary
for a given depth, the same in both packages. The injections below are
queued from a measure step's ``collect`` (an instance attribute, so the
prover still sees the step's own type) and held against the JAX package:

* on the fused tier (the port's twin against the JAX emulated chunk, draw
  for draw) ``sim.ts`` is byte-identical, the int records, the alive mask,
  the spawn mark and the capacity are equal, and the float planes agree
  within the main path's rtol 1e-6 + atol 1e-6 * max|plane| (XLA's FMAs
  and ``rsqrt``, tests/test_torch_fused.py);
* an injection that breaks the fused plan (a non-photon object) sends both
  to the generic tier for the rest of the run, with one maintenance at
  that boundary;
* a removal clears the same slot in both.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.population import PopulationManager

DT = 0.001
N = 4096


def _hook(step, at_call, edit):
    """Run ``edit(sim)`` from ``step.collect`` at its ``at_call``-th call;
    returns the list of ``len(sim.ts)`` at each call."""
    calls = []
    base = step.collect

    def collect(sim, records):
        base(sim, records)
        calls.append(len(sim.ts))
        if len(calls) == at_call:
            edit(sim)

    step.collect = collect
    return calls


def _main(P, iters=192, depth=4, **kw):
    """The main path's steps (scatter at A = n = 1e-3), photons from the
    origin along +x."""
    s = P.Simulation(until_t=(iters - 0.5) * DT, seed=3, chunk_steps=16,
                     fused_pipeline_depth=depth, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.001, n=0.001))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    s.add_photons(P.light.generate_photon_state(N, E=1.0))
    return s, m


def _run(s):
    s.start()
    s.join()
    return s


def _assert_planes_close(js, ts, fields=("r", "dr", "v", "dv", "E", "w")):
    live = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), live)
    for name in fields:
        want = np.asarray(getattr(js.sim_state, name))[..., live]
        got = getattr(ts.sim_state, name).numpy()[..., live]
        scale = float(np.abs(want).max(initial=0.0))
        assert np.all(np.abs(got - want)
                      <= 1e-6 * np.abs(want) + 1e-6 * scale), name


@pytest.mark.parametrize("depth,n_inj", [(4, 3000), (1, 3000), (4, 20000)],
                         ids=["depth4", "depth1", "depth4-grows"])
def test_injection_from_collect_matches_jax(depth, n_inj):
    """3000 photons (E = 2) injected from the measure step's second
    collect; 20000 overflow the 16384-slot pad and grow the capacity."""
    runs = {}
    for name, P, kw in (("jax", J, {}), ("torch", T, {"device": "cpu"})):
        s, m = _main(P, depth=depth, **kw)
        _hook(m, 2, lambda sim, P=P: sim.add_photons(
            P.light.generate_photon_state(n_inj, E=2.0)))
        runs[name] = (_run(s), m)
    (js, jm), (ts, tm) = runs["jax"], runs["torch"]
    assert js.used_fused and ts.used_fused
    assert np.asarray(ts.ts, np.float32).tobytes() == \
        np.asarray(js.ts, np.float32).tobytes()
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    n = np.asarray(tm.data)[:, 1]
    assert n[0] == N and n[-1] == N + n_inj  # the injection shows mid-run
    assert ts.sim_state.capacity == js.sim_state.capacity \
        == (16384 if n_inj < 16384 - N else 32768)
    assert int(ts.sim_state.n_spawned) == int(js.sim_state.n_spawned) \
        == N + n_inj
    E = ts.sim_state.E[ts.sim_state.alive]
    assert int((E == 2.0).sum()) == n_inj  # every injected photon is there
    _assert_planes_close(js, ts)


def test_generic_tier_injection_matches_jax():
    """On the generic tier (``fuse="off"``) every boundary maintains, so an
    injection queued by the second collect lands after chunk 2 and grows
    the capacity; a draw-free plan at dt = 2**-10 (``v * dt`` exact, so
    XLA's FMAs round as the port's separate ops) gives equal records,
    ``sim.ts`` and bitwise planes."""
    dt = 2.0 ** -10
    rng = np.random.default_rng(2)
    d = rng.normal(size=(3, N))
    runs = {}
    for name, P, kw in (("jax", J, {}), ("torch", T, {"device": "cpu"})):
        c = float(P.light.c)
        s = P.Simulation(until_t=(64 - 0.5) * dt, seed=1, chunk_steps=8,
                         fuse="off", auto_shrink=False, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(dt)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        m = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(2, m)
        s.add_photons(P.light.generate_photon_state(
            N, E=1.0, v=d / np.linalg.norm(d, axis=0) * c))
        _hook(m, 2, lambda sim, P=P, c=c: sim.add_photons(
            P.light.generate_photon_state(
                16384, E=2.0, v=-d[:, :1].repeat(16384, 1)
                / np.linalg.norm(d[:, 0]) * c)))
        runs[name] = (_run(s), m)
    (js, jm), (ts, tm) = runs["jax"], runs["torch"]
    assert not js.used_fused and not ts.used_fused
    assert ts.ts == js.ts
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    n = np.asarray(tm.data)[:, 1]
    assert (n[:16] == N).all() and (n[16:] == N + 16384).all()
    assert ts.sim_state.capacity == js.sim_state.capacity == 32768
    for f in ("r", "v", "E", "alive"):
        np.testing.assert_array_equal(getattr(ts.sim_state, f).numpy(),
                                      np.asarray(getattr(js.sim_state, f)))


def test_nonphoton_injection_falls_back_to_generic():
    """A generic object breaks the photon plan: both packages finish the
    run on the generic tier (used_fused False) with the object moving at
    its own speed, and the port maintains once at the fallback boundary."""
    out = {}
    boundaries = []
    real = PopulationManager.maintain

    def watched(self, state, plan):
        boundaries.append(len(self.sim.ts))
        return real(self, state, plan)

    PopulationManager.maintain = watched
    try:
        for name, P, kw in (("jax", J, {}), ("torch", T, {"device": "cpu"})):
            s, m = _main(P, iters=96, **kw)
            obj = P.Object(v=P.Measurement([5.0, 0, 0], "m**1 s**-1"))
            _hook(m, 1, lambda sim, o=obj: sim.add_obj(o))
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                _run(s)
            out[name] = (s, m, [str(x.message) for x in w])
    finally:
        PopulationManager.maintain = real
    (js, jm, _), (ts, tm, tw) = out["jax"], out["torch"]
    assert not js.used_fused and not ts.used_fused
    assert len(js.objects) == len(ts.objects) == N + 1
    assert len(ts.ts) == len(js.ts) == 96
    slow = [o for o in ts.objects if abs(float(o.v[0]) - 5.0) < 1e-3]
    assert len(slow) == 1 and float(slow[0].r[0]) > 0
    assert any("mid-run injection broke" in x for x in tw)
    assert "mid-run injection" in ts.explain_plan()
    # the fallback boundary is maintained once: no two maintenances at the
    # same iteration count
    assert len(boundaries) == len(set(boundaries))
    # the fused chunk before the fallback drew as the JAX package's did
    np.testing.assert_array_equal(np.asarray(tm.data)[:16],
                                  np.asarray(jm.data)[:16])


def _tagged_objects(P, n=20):
    c = float(P.light.c)
    return [P.light.PhotonObject(E=np.double(42.0 if i == 0 else 1.0),
                                 v=np.array([c, 0, 0], dtype=np.double))
            for i in range(n + 1)]


def _kinematics(P, **kw):
    s = P.Simulation(until_t=(64 - 0.5) * DT, seed=0, chunk_steps=8,
                     auto_shrink=False, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(2, m)
    return s, m


def test_remove_obj_matches_jax():
    """``remove_obj`` from the measure step's third collect clears the
    tagged object's slot at the same boundary in both packages."""
    out = {}
    for name, P, kw in (("jax", J, {}), ("torch", T, {"device": "cpu"})):
        s, m = _kinematics(P, **kw)
        objs = _tagged_objects(P)
        for o in objs:
            s.add_obj(o)
        _hook(m, 3, lambda sim, o=objs[0]: sim.remove_obj(o))
        out[name] = (_run(s), m)
    (js, jm), (ts, tm) = out["jax"], out["torch"]
    assert js.used_fused and ts.used_fused
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    n = np.asarray(tm.data)[:, 1]
    assert n[0] == 21 and n[-1] == 20
    assert not bool(ts.sim_state.alive[0])
    assert sorted(float(o.E) for o in ts.objects) == [1.0] * 20
    _assert_planes_close(js, ts, ("r", "v", "E"))


def test_remove_obj_in_the_final_chunk_is_flushed():
    """A removal queued by the last chunk's collect is applied after the
    loop (``PopulationManager.flush_removals``)."""
    s, m = _kinematics(T, device="cpu")
    objs = _tagged_objects(T, 3)
    for o in objs:
        s.add_obj(o)
    base, calls = m.collect, []

    def last(sim, records):
        base(sim, records)
        calls.append(len(sim.ts))
        if len(sim.ts) == 64:
            sim.remove_obj(objs[1])

    m.collect = last
    _run(s)
    assert calls[-1] == 64 and np.asarray(m.data)[-1, 1] == 4
    assert not bool(s.sim_state.alive[1]) and len(s.objects) == 3


@pytest.mark.parametrize("cause", ["auto_shrink", "a continuous source",
                                   "spatial_sort"])
def test_remove_obj_refuses_unstable_slots(cause):
    """Removal needs stable slots; the error names what moves them."""
    kw = {"auto_shrink": cause == "auto_shrink",
          "spatial_sort": int(cause == "spatial_sort")}
    s = T.Simulation(until_t=0.01, seed=0, device="cpu", **kw)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    if cause == "a continuous source":
        s.add_step(1, T.light.PhotonEmitterStep(10, E=1.0))
    o = _tagged_objects(T, 0)[0]
    s.add_obj(o)
    assert s._slot_movers() == [cause]
    s.running = True
    try:
        with pytest.raises(RuntimeError, match=f"stable slots, and {cause}"):
            s.remove_obj(o)
    finally:
        s.running = False


def test_injection_resets_split_snapshots():
    """An injection moves the spawn mark and may grow the arena, so the
    ``at="chunk"`` importance snapshot is dropped: the boundary of the
    injection only re-snapshots, and every other boundary compares."""
    c = float(T.light.c)
    s = T.Simulation(until_t=(64 - 0.5) * DT, seed=1, chunk_steps=8,
                     device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    split = T.light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** torch.floor(x / (20 * c * DT)), at="chunk",
        roulette=False)
    s.add_step(2, split)
    m = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    s.add_photons(T.light.generate_photon_state(1000, E=1.0))
    seen = []
    base = split.boundary_apply

    def boundary_apply(state, ctx):
        seen.append((len(s.ts), split._prev_r is None))
        return base(state, ctx)

    split.boundary_apply = boundary_apply
    _hook(m, 3, lambda sim: sim.add_photons(
        T.light.generate_photon_state(100, E=2.0)))
    _run(s)
    assert s.used_fused
    fresh = [ts for ts, none in seen if none]
    assert len(fresh) == 1 and fresh[0] == 24  # the injection's boundary
    assert int((s.sim_state.E[s.sim_state.alive] == 2.0).sum()) >= 100


def test_emitter_injection_spawn_mark_matches_jax():
    """With an emitter the device spawn mark runs ahead of the host's
    view; injected photons go behind the larger of the two, in both
    packages, and emission continues behind them."""
    out = {}
    for name, P, kw in (("jax", J, {}), ("torch", T, {"device": "cpu"})):
        c = float(P.light.c)
        s = P.Simulation(until_t=(96 - 0.5) * DT, seed=2, chunk_steps=8,
                         capacity=16384, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.light.PhotonEmitterStep(16, E=3.0,
                                                v=(c, 0.0, 0.0)))
        s.add_step(2, P.newton.NewtonianKinematicsStep())
        m = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, m)
        s.add_photons(P.light.generate_photon_state(256, E=1.0))
        _hook(m, 2, lambda sim, P=P: sim.add_photons(
            P.light.generate_photon_state(100, E=2.0)))
        out[name] = (_run(s), m)
    (js, jm), (ts, tm) = out["jax"], out["torch"]
    assert js.used_fused and ts.used_fused
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    assert int(ts.sim_state.n_spawned) == int(js.sim_state.n_spawned) \
        == 256 + 96 * 16 + 100
    E = ts.sim_state.E.numpy()
    np.testing.assert_array_equal(E, np.asarray(js.sim_state.E))
    first = int(np.argmax(E == 2.0))
    assert first > 256 and (E[first:first + 100] == 2.0).all()
    assert (E[first + 100:first + 116] == 3.0).all()  # emission behind


def test_threaded_injection():
    """A user thread injects while the run thread dispatches; the wait
    polls progress against a deadline."""
    s = T.Simulation(until_t=0.2, seed=0, chunk_steps=8, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_photons(T.light.generate_photon_state(100, E=1.0))
    s.start()
    deadline = time.time() + 60.0
    while len(s.ts) < 8 and s.is_alive() and time.time() < deadline:
        time.sleep(0.002)
    assert len(s.ts) >= 8 and s.running, "the run ended before the edit"
    c = float(T.light.c)
    worker = threading.Thread(target=lambda: (
        s.add_photons(T.light.generate_photon_state(50, E=2.0)),
        s.add_obj(T.light.PhotonObject(
            E=np.double(3.0), v=np.array([c, 0, 0], dtype=np.double)))))
    worker.start()
    worker.join(timeout=60.0)
    s.join()
    assert len(s.objects) == 151
    E = s.sim_state.E[s.sim_state.alive].numpy()
    vals, counts = np.unique(E, return_counts=True)
    assert dict(zip(vals.tolist(), counts.tolist())) == {1.0: 100, 2.0: 50,
                                                         3.0: 1}
    r = s.sim_state.r[0].numpy()
    assert r[100] < r[0]  # the injected photons moved less
