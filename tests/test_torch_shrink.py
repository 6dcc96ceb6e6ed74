"""``auto_shrink`` (on by default, as in the JAX package): when fewer than a
quarter of the slots are alive at a chunk boundary, the survivors are
compacted to the front and the capacity cut to their padded count, so the
remaining chunks launch over fewer lanes.

On the fused tier the port's plain twin runs against the JAX package's
emulated chunk, both at their defaults: the two shrink at the same
boundaries to the same capacities, and since the draws are keyed on the
slot, the compacted slots draw the same numbers, so ``sim.ts``, the int
records and the spawn mark stay equal and the planes agree within 1e-6 of
each plane's largest value (XLA's FMAs in the direction's arithmetic). On
the generic tier a deterministic plan (photons leaving an absorbing box)
is compared the same way. A trace (stable slot ids), a user-set capacity
or a continuous source keeps the capacity.
"""


import numpy as np
import pytest
import torch

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu.ops.compaction as JC
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.ops.compaction import compact_shrink
from physicl_tpu_torch.population import ExecPlan, PopulationManager
from physicl_tpu_torch.state import SimState

DT = 2.0 ** -10
TOL = 1e-6


def _bulk(n, seed):
    """n photons at speed c in seeded directions near the origin (host
    arrays, handed to both packages)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    c = float(J.light.c)
    return J.light.generate_photon_state(
        n, E=1.0, r=rng.uniform(-1, 1, (3, n)) * c * DT,
        v=d / np.linalg.norm(d, axis=0) * c)


def _copy(bulk):
    return {k: (dict(v) if isinstance(v, dict) else np.array(v))
            for k, v in bulk.items()}


def _extinction(P, bulk, **kw):
    """Scatter and absorb until every photon is gone (chunks of 8)."""
    c = float(P.light.c)
    s = P.Simulation(exit="extinction", seed=3, chunk_steps=8, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.2 / (c * DT), n=1.0))
    s.add_step(3, P.light.ScatterDeleteStep(np.double(1.0),
                                            np.double(0.1 / (c * DT))))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(4, m)
    s.add_photons(_copy(bulk))
    return s, m


def _escape(P, bulk, **kw):
    """Photons leave an absorbing box (no draw: the generic tiers of both
    packages compute the same function)."""
    c = float(P.light.c)
    s = P.Simulation(exit="extinction", seed=3, chunk_steps=4, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.newton.AbsorbingBoundaryStep(((-40 * c * DT,
                                                   40 * c * DT),) * 3))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    s.add_photons(_copy(bulk))
    return s, m


def _run_both(build, monkeypatch, n, **kw):
    shrinks = []
    real = JC.compact_shrink

    def watched(state, n_alive):
        out = real(state, n_alive)
        if out.capacity != state.capacity:
            shrinks.append((state.capacity, out.capacity))
        return out

    monkeypatch.setattr(JC, "compact_shrink", watched)
    bulk = _bulk(n, 1)
    js, jm = build(J, bulk, **kw)
    js.start()
    js.join()
    ts, tm = build(T, bulk, device="cpu", **kw)
    ts.start()
    ts.join()
    return (js, jm), (ts, tm), shrinks


def _planes_close(js, ts):
    live = np.asarray(js.sim_state.alive)
    for name in ("r", "dr", "v", "dv", "E", "w"):
        want = np.asarray(getattr(js.sim_state, name))[..., live]
        got = getattr(ts.sim_state, name).numpy()[..., live]
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            assert float(np.abs(g - w).max(initial=0.0)) <= TOL * scale, name


@pytest.mark.parametrize("build,fuse,n", [(_extinction, "auto", 40000),
                                          (_escape, "off", 40000)])
def test_shrinks_as_jax(build, fuse, n, monkeypatch):
    (js, jm), (ts, tm), jax_shrinks = _run_both(build, monkeypatch, n,
                                                fuse=fuse)
    assert js.auto_shrink and ts.auto_shrink  # both at their defaults
    assert js.used_fused == ts.used_fused == (fuse == "auto")
    port_shrinks = [(e[2], e[3]) for e in ts.population_log
                    if e[0] == "shrink"]
    assert port_shrinks == jax_shrinks and len(port_shrinks) >= 1
    assert ts.sim_state.capacity == js.sim_state.capacity < 40000
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) > 0
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    assert ts._hwm == js._hwm
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(),
                                  np.asarray(js.sim_state.alive))
    _planes_close(js, ts)


def test_shrink_keeps_the_run_on_its_tier():
    """After a shrink the fused tier plans its next chunk at the new
    capacity (a new packed state, the same kernel plan), and the chunk
    index keeps counting, so the draw keys continue."""
    s, _ = _extinction(T, _bulk(40000, 2), device="cpu")
    s.start()
    s.join()
    shrinks = [e for e in s.population_log if e[0] == "shrink"]
    assert shrinks and shrinks[0][2] == 49152
    assert all(b > a for (_, _, b, a) in shrinks)
    assert s.used_fused and s.sim_state.capacity == shrinks[-1][3]


@pytest.mark.parametrize("case", ["trace", "capacity", "off", "emitter"])
def test_policies_that_keep_the_capacity(case):
    """A trace's rows are slots (stable ids), a user-set capacity is
    intentional, auto_shrink=False asks for none, a continuous source needs
    its headroom: the capacity stays."""
    kw = {"device": "cpu"}
    if case == "capacity":
        kw["capacity"] = 49152
    if case == "off":
        kw["auto_shrink"] = False
    s, _ = _extinction(T, _bulk(40000, 3), **kw)
    if case == "trace":
        s.add_step(5, T.light.TracePathMeasureStep(None))
    if case == "emitter":
        s.exit = T.engine.UntilT(64 * DT * 0.9999)
        s.add_step(5, T.light.PhotonEmitterStep(8, E=1.0))
    assert s._population_policies()[0] is False
    s.start()
    s.join()
    assert not [e for e in s.population_log if e[0] == "shrink"]
    assert s.sim_state.capacity >= 49152


def test_compact_shrink_matches_jax():
    """compact_shrink of the same state: survivors in slot order at the
    front, the padded capacity, every plane equal."""
    bulk = _bulk(40000, 4)
    alive = np.random.default_rng(5).random(40000) < 0.1
    jst = J.SimState.from_population([], [bulk])
    jst = jst.replace(alive=jst.alive.at[:40000].set(alive))
    names = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t",
             "dt", "t_comp", "n_spawned")
    fields = {f: np.asarray(getattr(jst, f)) for f in names}
    fields["extras"] = {"tag": np.arange(jst.capacity, dtype=np.float32)}
    tst = SimState.from_numpy(fields, device="cpu")
    jst = jst.replace(extras={"tag": J.SimState.from_population(
        [], [bulk]).E * 0 + np.arange(jst.capacity, dtype=np.float32)})
    n = int(alive.sum())
    want = JC.compact_shrink(jst, n)
    got = compact_shrink(tst, n)
    assert got.capacity == want.capacity == 16384
    back = got.to_numpy()
    for f in ("r", "v", "E", "alive", "otype", "w", "n_spawned"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(back["extras"]["tag"],
                                  np.asarray(want.extras["tag"]))
    assert compact_shrink(got, n) is got  # at the padded minimum


def test_shrink_resets_the_boundary_snapshot():
    """A shrink moves slots: an ImportanceSplitStep(at="chunk") snapshot
    is dropped, as on a recycle, so the next boundary re-snapshots. (The
    engine itself never shrinks under a split step, which grows the
    population: the policy is forced here.)"""
    sim = T.Simulation(device="cpu")
    split = T.light.ImportanceSplitStep(lambda x, y, z: 1.0 + 0 * x,
                                        at="chunk")
    sim.add_step(0, split)
    st = SimState.from_population([], [_bulk(40000, 6)], device="cpu")
    st = st.replace(alive=torch.arange(st.capacity) < 1000)
    split._prev_r = st.r.clone()
    pop = PopulationManager(sim, [split])
    pop.shrink_ok = True
    sim._host_n_alive = 1000
    rebuilt = []
    sim._build_chunk_fn = lambda *a: rebuilt.append(a) or (lambda s: s)
    plan = ExecPlan(provider=None, chunk_fn=None, exit_traced=True,
                    exit_fn=None, chunk=8)
    out = pop._shrink(st, plan)
    assert out.capacity == 16384 and split._prev_r is None
    assert sim._hwm == 1000 and rebuilt and plan.chunk_fn is not None
    assert sim.population_log[-1][::2] == ("shrink", 49152)
