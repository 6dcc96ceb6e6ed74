"""An 8-shard port mesh against the JAX package's 8-device mesh, on the
fused tier, draw for draw.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port runs ``Simulation(mesh=make_mesh(8, devices=["cpu"]))``, whose shards
launch the CPU twin of ``fused_transport`` on their local planes with the
JAX package's per-shard seeds and emitter shifts. So the integer records
(counts) are equal, ``sim.ts`` is byte-identical, the alive masks are
equal and the float planes agree within 1e-4 of each plane's largest
magnitude (XLA contracts multiply-adds on the CPU; the twin rounds each
operation, as the kernel does).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the skipif condition reads it)

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.parallel import make_mesh as j_mesh

import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.parallel import (PHOTON_AXIS, ShardedState,
                                        init_distributed, is_multiprocess,
                                        make_mesh, make_pod_mesh,
                                        shard_state)
from physicl_tpu_torch.state import SimState

pytestmark = pytest.mark.skipif(
    "jax.device_count() < 8", reason="needs the 8 virtual CPU devices")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: with several test
    workers on the machine, torch's default pool (one thread a core) spends
    most of each small operation waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

C = 299792458.0
DT = 0.001
UNIT = 8 * 16384


def _mesh(P, n=8):
    return j_mesh(n) if P is J else make_mesh(n, devices=["cpu"])


def _sim(P, mesh=True, **kw):
    if P is T:
        kw.setdefault("device", "cpu")
    return P.Simulation(mesh=_mesh(P) if mesh else None, **kw)


def _run(s):
    s.start()
    s.join()
    return s


def _planes(s, name):
    x = s.sim_state
    x = getattr(x, name) if name != "stokes" else x.extras["stokes"]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close_to_max(got, want, what=""):
    """Within 1e-4 of the plane's largest magnitude."""
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert np.abs(got - want).max() <= 1e-4 * scale, what


def _assert_states_match(js, ts, fields=("r", "v", "E", "w")):
    assert ts.sim_state.capacity == js.sim_state.capacity
    np.testing.assert_array_equal(_planes(ts, "alive"), _planes(js, "alive"))
    for name in fields:
        _assert_close_to_max(_planes(ts, name), _planes(js, name), name)


def _assert_ts(js, ts):
    assert np.asarray(ts.ts, np.float32).tobytes() == \
        np.asarray(js.ts, np.float32).tobytes()


def test_mesh_surface(monkeypatch):
    """make_mesh cycles shards over the given devices; shard_state splits
    the particle axis into contiguous spans and replicates the scalars;
    a single process is not a multi-process run, and init_distributed
    without a coordinator (no argument, no torchrun variables) says
    which one it needs."""
    mesh = make_mesh(8, devices=["cpu"])
    assert mesh.size == 8 and mesh.axis_names == (PHOTON_AXIS,)
    assert make_mesh(4, devices=["cpu", "meta"])[3] == torch.device("meta")
    assert make_pod_mesh(devices=["cpu"]) == make_mesh(devices=["cpu"])
    assert not is_multiprocess()
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed()
    st = SimState.from_population(
        [], [T.light.generate_photon_state(100000, E=1.0)], device="cpu",
        capacity=UNIT)
    sh = shard_state(st, mesh)
    assert isinstance(sh, ShardedState) and len(sh.shards) == 8
    assert sh.shards[0].capacity == 16384 and sh.capacity == UNIT
    assert int(sh.n_alive) == 100000
    assert all(int(s.n_spawned) == 100000 for s in sh.shards)
    torch.testing.assert_close(sh.shards[3].r, st.r[:, 3 * 16384:
                                                    4 * 16384])
    assert torch.equal(sh.gather().E, st.E) and torch.equal(sh.r, st.r)
    with pytest.raises(ValueError, match="divisible"):
        shard_state(st, make_mesh(3, devices=["cpu"]))


def _main(P, n=20000, seed=4, delete=False, **kw):
    s = _sim(P, exit=lambda c: c.t >= 0.020, seed=seed, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    if delete:
        s.exit = lambda x: len(x.objects) == 0
        s.add_step(2, P.light.ScatterDeleteStep(np.double(0.001),
                                                np.double(0.001)))
        meas = P.light.ScatterMeasureStep(None, True, [[1e6, np.nan,
                                                        np.nan]])
    else:
        s.add_step(2, P.light.ScatterIsotropicStep(A=0.001, n=0.001))
        meas = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, meas)
    s.add_photons(P.light.generate_photon_state(n, E=1.0))
    return s, meas


@pytest.mark.parametrize("n", [20000, UNIT], ids=["partial", "full"])
def test_main_plan_matches_jax_mesh(n):
    """The main path (kinematics, isotropic scatter, sign tally): counts
    cover every shard and equal the JAX mesh's."""
    (js, jm), (ts, tm) = (_main(P, n=n) for P in (J, T))
    _run(js), _run(ts)
    assert js.used_fused and ts.used_fused
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    assert int(tm.data[0][1]) == n
    _assert_ts(js, ts)
    _assert_states_match(js, ts)


def test_delete_extinction_matches_jax_mesh():
    (js, jm), (ts, tm) = (_main(P, seed=9, delete=True, chunk_steps=16)
                          for P in (J, T))
    _run(js), _run(ts)
    assert js.used_fused and ts.used_fused
    assert len(ts.objects) == 0
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    _assert_ts(js, ts)


def _emitter(P, n_emit, n0, seed=0, fuse="auto", t_end=0.020):
    s = _sim(P, exit=lambda c: c.t >= t_end, seed=seed, capacity=UNIT,
             fuse=fuse)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.light.PhotonEmitterStep(n_emit, E=2.0))
    s.add_step(2, P.newton.NewtonianKinematicsStep())
    sign = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_photons(P.light.generate_photon_state(n0, E=1.0))
    return s, sign


def test_emitter_windows_cross_shards():
    """3000 photons an iteration from slot 10000: the windows straddle the
    16384-slot shard edges and are written piecewise."""
    (js, jm), (ts, tm) = (_emitter(P, 3000, 10000) for P in (J, T))
    _run(js), _run(ts)
    assert js.used_fused and ts.used_fused
    ns = [int(r[1]) for r in tm.data]
    assert ns == [10000 + 3000 * (i + 1) for i in range(20)]
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    E, alive = _planes(ts, "E"), _planes(ts, "alive")
    assert (E[alive] == 2.0).sum() == 60000
    assert (E[alive] == 1.0).sum() == 10000
    assert (_planes(ts, "otype")[alive] == 1).all()
    _assert_states_match(js, ts)


def test_emitter_full_arena_stops_cleanly():
    """A source on a full arena stops: the port's fused and generic mesh
    tiers count what the JAX mesh counts."""
    n0 = UNIT - 25000
    counts = {}
    for P in (J, T):
        for fuse in ("auto", "off"):
            s, sign = _emitter(P, 10000, n0, seed=1, fuse=fuse)
            _run(s)
            assert s.used_fused == (fuse == "auto")
            counts[P, fuse] = [int(r[1]) for r in sign.data]
    assert counts[T, "auto"] == counts[J, "auto"] == counts[T, "off"]
    assert counts[T, "auto"][:3] == [n0 + 10000, n0 + 20000, n0 + 20000]


def test_emitter_recycles_with_absorption():
    """A sustained source with absorption on a full mesh arena keeps
    emitting: the recycling compaction is global (live photons move
    across shards), as the JAX mesh's, and the runs agree draw for
    draw."""
    def build(P):
        s = _sim(P, exit=lambda c: c.t >= 0.040, seed=0, capacity=UNIT,
                 chunk_steps=8)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.light.PhotonEmitterStep(8000, E=2.0))
        s.add_step(2, P.newton.NewtonianKinematicsStep())
        s.add_step(3, P.light.ScatterDeleteStep(np.double(0.001),
                                                np.double(0.001)))
        sign = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(4, sign)
        s.add_photons(P.light.generate_photon_state(1000, E=1.0))
        return s, sign

    (js, jm), (ts, tm) = (build(P) for P in (J, T))
    _run(js), _run(ts)
    assert js.used_fused and ts.used_fused
    # 8000 an iteration for 40 iterations: far past the arena unless
    # slots recycle
    assert [e[0] for e in ts.population_log].count("recycle") >= 1
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    _assert_ts(js, ts)
    _assert_states_match(js, ts)


def test_trace_stream_covers_every_shard():
    """Stream planes (the path trace) come back in global slot order: the
    assembled matrix covers every shard's photons, as the JAX mesh's."""
    n = UNIT
    runs = {}
    for P in (J, T):
        s = _sim(P, exit=lambda c: c.t >= 0.004, seed=0, chunk_steps=4)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterIsotropicStep(A=np.double(0.001),
                                                   n=np.double(0.001)))
        tr = P.light.TracePathMeasureStep(None)
        s.add_step(3, tr)
        s.add_photons(P.light.generate_photon_state(n, E=1.0))
        _run(s)
        assert s.used_fused
        runs[P] = tr.as_arrays()
    (_, jpos, jalive, _), (_, tpos, talive, _) = runs[J], runs[T]
    assert tpos.shape == jpos.shape == (4, 3, n)
    np.testing.assert_array_equal(talive, jalive)
    scale = np.abs(jpos).max()
    assert np.abs(np.asarray(tpos, np.float64) - jpos).max() <= 1e-4 * scale


def test_weighted_reduce_and_implicit_capture():
    """Implicit-capture weight sums cross the shards as one reduction:
    N (1 - p)^k exactly on the mesh and off it, and as the JAX mesh's."""
    n = UNIT
    rows = {}
    for P in (J, T):
        for mesh in (True, False):
            s = _sim(P, mesh=mesh, until_t=0.005, seed=0)
            s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
            s.add_step(1, P.newton.NewtonianKinematicsStep())
            s.add_step(2, P.light.ScatterDeleteStep(
                np.double(1.0), np.double(0.25 / (C * DT)),
                implicit_capture=True))
            red = P.ReduceMeasureStep(None, lambda p: {"W": p.w},
                                      outputs=("W",), measure_n=True)
            s.add_step(3, red)
            s.add_photons(P.light.generate_photon_state(n, E=1.0))
            _run(s)
            assert s.used_fused
            rows[P, mesh] = np.array(red.data, dtype=float)
    for r in rows.values():
        assert (r[:, 1] == n).all()
        np.testing.assert_allclose(
            r[:, 2], n * 0.75 ** np.arange(1, r.shape[0] + 1), rtol=1e-4)
    np.testing.assert_allclose(rows[T, True][:, 2], rows[J, True][:, 2],
                               rtol=1e-5)
    np.testing.assert_allclose(rows[T, True][:, 2], rows[T, False][:, 2],
                               rtol=1e-5)


def test_lorentz_charged_population_matches_single_device():
    """Boris dynamics on the mesh: deterministic, so the 8-shard run
    matches the unsharded port run and the JAX mesh per particle."""
    n = 8 * 2048
    rng = np.random.default_rng(11)
    v0 = rng.normal(size=(3, n))
    r0 = rng.normal(size=(3, n)) * 0.01
    res = {}
    for P, mesh in ((J, True), (T, True), (T, False)):
        s = _sim(P, mesh=mesh, until_t=0.05, seed=2)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.LorentzForceStep(
            E_field=(0.5, 0.0, 0.2), B_field=(0.0, 0.0, 60.0),
            q_over_m=1.0))
        s.add_step(2, P.newton.NewtonianKinematicsStep())
        s.add_particles(P.newton.generate_particle_state(n, v=v0, r=r0))
        _run(s)
        assert s.used_fused
        res[P, mesh] = (_planes(s, "r")[:, :n], _planes(s, "v")[:, :n])
    for i in range(2):
        np.testing.assert_array_equal(res[T, True][i], res[T, False][i])
        _assert_close_to_max(res[T, True][i], res[J, True][i])


def test_lorentz_per_particle_qm_and_extras_planes():
    """Per-particle q/m (a packed extras plane) and ElementwiseStep /
    ReduceMeasureStep extras planes shard with the particles."""
    vv = (5.0, 0.0, 0.0)
    res = {}
    for P, mesh in ((J, True), (T, True), (T, False)):
        s = _sim(P, mesh=mesh, until_t=0.05, seed=4)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.LorentzForceStep(B_field=(0, 0, 200.0)))
        s.add_step(2, P.newton.NewtonianKinematicsStep())
        for i in range(64):
            s.add_obj(P.newton.ChargedObject(
                q=(1.0 if i % 2 == 0 else -1.0), m=1.0,
                v=P.Measurement(list(vv), "m**1 s**-1")))
        _run(s)
        assert s.used_fused
        res[P, mesh] = _planes(s, "v")[:, :64]
    np.testing.assert_array_equal(res[T, True], res[T, False])
    _assert_close_to_max(res[T, True], res[J, True])
    np.testing.assert_allclose(res[T, True][1, 0::2],
                               -res[T, True][1, 1::2], rtol=1e-5)

    n = 8 * 2048
    tau = np.random.default_rng(11).uniform(0.5, 4.0, n)
    out = {}
    for P, mesh in ((J, True), (T, True)):
        exp = np.exp if P is J else torch.exp
        s = _sim(P, mesh=mesh, until_t=0.005, seed=0)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        if P is J:
            import jax.numpy as jnp
            exp = jnp.exp
        s.add_step(2, P.ElementwiseStep(
            lambda p, exp=exp: {"E": p.E * exp(-p.extras["tau"] * p.dt)},
            extras=("tau",)))
        red = P.ReduceMeasureStep(
            None, lambda p: {"Etau": p.E * p.extras["tau"]},
            outputs=("Etau",), extras=("tau",))
        s.add_step(3, red)
        s.add_photons(P.light.generate_photon_state(
            n, E=1.0, extras={"tau": tau}))
        _run(s)
        assert s.used_fused
        out[P] = (_planes(s, "E")[:n], np.array([r[1] for r in red.data]))
    np.testing.assert_allclose(out[T][0], out[J][0], rtol=1e-5)
    np.testing.assert_allclose(out[T][1], out[J][1], rtol=1e-5)


def test_generate_photon_state_extras_matches_jax():
    """``generate_photon_state(extras=)`` (the planes the extras-plane mesh
    case attaches) shapes a scalar, an (n,) array, a 3-vector and a (3, n)
    array as the JAX package's does; on a device, as float32 tensors."""
    n = 5
    extras = {"a": 2.0, "q": np.arange(n, dtype=float), "v": [1.0, 2.0, 3.0],
              "m": np.arange(3 * n, dtype=float).reshape(3, n)}
    tb = T.light.generate_photon_state(n, E=1.0, extras=extras)
    jb = J.light.generate_photon_state(n, E=1.0, extras=extras)
    assert set(tb["extras"]) == set(jb["extras"])
    for k, v in jb["extras"].items():
        np.testing.assert_array_equal(tb["extras"][k], np.asarray(v))
    db = T.light.generate_photon_state(n, E=1.0, device="cpu", extras=extras)
    for k, v in db["extras"].items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            jb["extras"][k], np.float32))
    with pytest.raises(ValueError, match="extras"):
        T.light.generate_photon_state(n, E=1.0, extras={"b": np.ones(4)})
