"""An 8-shard port mesh on the generic step tier and across the engine's
chunk-boundary edits, against the JAX package's 8-device mesh and the
port's own unsharded runs.

The generic tier draws from one generator a shard (the JAX package draws
over the global array), so it agrees with the JAX mesh statistically, at
the JAX tests' tolerances. Every chunk-boundary edit (mid-run injection,
recycling, splitting at a boundary, the spatial sort, checkpoints) acts on
the global planes and re-splits the shards, so draw-free runs match
exactly: the reshard 8 -> 1 -> 4 and back, and ``scan_steps`` on a
sharded state.
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
from physicl_tpu_torch import functional as TFn
from physicl_tpu_torch.parallel import ShardedState, make_mesh, shard_state
from physicl_tpu_torch.state import SimState, pad_capacity

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


def _sim(P, mesh=8, **kw):
    if P is T:
        kw.setdefault("device", "cpu")
    return P.Simulation(mesh=_mesh(P, mesh) if mesh else None, **kw)


def _run(s):
    s.start()
    s.join()
    return s


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _iso(P, mesh=8, fuse="off", seed=4, n=20000, t_end=0.020):
    s = _sim(P, mesh=mesh, exit=lambda c: c.t >= t_end, seed=seed,
             fuse=fuse)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.001, n=0.001))
    meas = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, meas)
    s.add_photons(P.light.generate_photon_state(n, E=1.0))
    return s, meas


def test_generic_tier_matches_statistically():
    """The +x share relaxes as 0.5 + 0.5 (1 - pcoll)^k on the mesh's
    generic tier, the unsharded one and the JAX mesh's, within 0.03 of
    each other (the JAX test's bound)."""
    shares = {}
    for P, mesh in ((J, 8), (T, 8), (T, None)):
        s, meas = _iso(P, mesh=mesh)
        _run(s)
        assert not s.used_fused
        shares[P, mesh] = np.array([r[2] / r[1] for r in meas.data])
        assert int(meas.data[0][1]) == 20000
    assert len(shares[T, 8]) == len(shares[J, 8]) == 20
    assert np.abs(shares[T, 8] - shares[T, None]).max() < 0.03
    assert np.abs(shares[T, 8] - shares[J, 8]).max() < 0.03
    pcoll = 0.001 * 0.001 * C * DT
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, 21)
    assert np.abs(shares[T, 8] - expect).max() < 0.03


def test_generic_tier_draws_per_shard():
    """Each shard draws from its own generator (seeded per shard, kept
    across chunks): a mesh run repeats itself, and differs from the
    unsharded run's draws."""
    runs = [_run(_iso(T, mesh=m, n=4096, t_end=0.004, seed=1)[0])
            for m in (8, 8, None)]
    v = [_np(s.sim_state.v)[:, :4096] for s in runs]
    np.testing.assert_array_equal(v[0], v[1])
    assert not np.array_equal(v[0], v[2])


def test_generic_records_combine_by_rule():
    """Counts and sums add across shards, the clock is taken once, the
    Stokes means (a step that declares no shard rules) are taken over the
    gathered planes, and a trace's per-photon channels join in global slot
    order: the mesh's generic records equal the unsharded run's on a
    draw-free plan."""
    from physicl_tpu_torch import polarization as pol

    def build(mesh):
        s = _sim(T, mesh=mesh, until_t=0.0035, seed=0, fuse="off")
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.light.ScatterDeleteStep(
            np.double(1.0), np.double(0.2 / (C * DT)),
            implicit_capture=True, measure_deposition=True))
        st = pol.StokesMeasureStep(None, weighted=True)
        s.add_step(3, st)
        red = T.ReduceMeasureStep(None, lambda p: {"W": p.w},
                                  outputs=("W",), measure_n=True)
        s.add_step(4, red)
        tr = T.light.TracePathMeasureStep(None)
        s.add_step(5, tr)
        rng = np.random.default_rng(2)
        stokes = rng.uniform(-0.5, 0.5, (3, 20000))
        bulk = pol.polarized_photon_state(20000, E=1.0, stokes=stokes)
        bulk["w"] = rng.uniform(0.5, 1.5, 20000)
        s.add_photons(bulk)
        return _run(s), st, red, tr

    (sm, stm, redm, trm), (s1, st1, red1, tr1) = build(8), build(None)
    assert len(sm.ts) == len(s1.ts) == 4
    np.testing.assert_allclose(np.array(stm.data, float),
                               np.array(st1.data, float), rtol=2e-6)
    np.testing.assert_allclose(np.array(redm.data, float),
                               np.array(red1.data, float), rtol=2e-6)
    np.testing.assert_allclose(np.array(sm.steps[2].data, float),
                               np.array(s1.steps[2].data, float), rtol=2e-6)
    am, a1 = trm.as_arrays(), tr1.as_arrays()
    np.testing.assert_array_equal(am[1][..., :20000], a1[1][..., :20000])
    np.testing.assert_array_equal(am[2][:, :20000], a1[2][:, :20000])


def test_scan_steps_on_sharded_state_is_exact():
    """scan_steps on a sharded state runs shard by shard and matches the
    unsharded run exactly for deterministic dynamics; records combine."""
    n = 8 * 2048
    v0 = np.random.default_rng(3).normal(size=(3, n))

    def state():
        return SimState.from_population(
            [], [T.newton.generate_particle_state(n, v=v0)], device="cpu")

    def steps():
        return [T.UpdateTimeStep(lambda x: 1e-3),
                T.newton.LorentzForceStep(E_field=(0.5, 0, 0),
                                          B_field=(0, 0, 60.0),
                                          q_over_m=1.0),
                T.newton.NewtonianKinematicsStep(),
                T.ReduceMeasureStep(None, lambda p: {"vx": p.vx},
                                    outputs=("vx",), measure_n=True)]

    plain, prec = TFn.scan_steps(steps(), state(), 50, record=True)
    sharded = shard_state(state(), make_mesh(8, devices=["cpu"]))
    out, mrec = TFn.scan_steps(steps(), sharded, 50, record=True)
    assert isinstance(out, ShardedState) and len(out.shards) == 8
    assert torch.equal(out.r, plain.r) and torch.equal(out.v, plain.v)
    assert torch.equal(mrec["s0/ts"], prec["s0/ts"])
    assert torch.equal(mrec["s3/n"], prec["s3/n"])
    torch.testing.assert_close(mrec["s3/vx"], prec["s3/vx"], rtol=1e-5,
                               atol=1e-3)
    # and against the JAX package's sharded scan
    from physicl_tpu import functional as JFn
    from physicl_tpu.parallel import shard_state as j_shard
    from physicl_tpu.state import SimState as JState

    jsteps = [J.UpdateTimeStep(lambda x: 1e-3),
              J.newton.LorentzForceStep(E_field=(0.5, 0, 0),
                                        B_field=(0, 0, 60.0), q_over_m=1.0),
              J.newton.NewtonianKinematicsStep()]
    jout = JFn.scan_steps(jsteps, j_shard(JState.from_population(
        [], [J.newton.generate_particle_state(n, v=v0)]), j_mesh()), 50)
    np.testing.assert_allclose(out.r.numpy(), np.asarray(jout.r),
                               rtol=1e-5, atol=1e-6)


def test_remat_on_sharded_state_replays_each_shards_draws():
    """A checkpointed scan over a sharded state with draws (roulette)
    gives the plain scan's gradient bitwise."""
    n = 8 * 512
    A0 = 0.04 / (C * DT)
    mesh = make_mesh(8, devices=["cpu"])

    def grad(remat):
        st = shard_state(SimState.from_population(
            [], [T.light.generate_photon_state(n, E=1.0)], device="cpu",
            capacity=UNIT), mesh)
        A = torch.tensor(A0, dtype=torch.float32, requires_grad=True)
        steps = [T.UpdateTimeStep(lambda x: DT),
                 T.newton.NewtonianKinematicsStep(),
                 T.light.ScatterDeleteStep(n=1.0, A=A, implicit_capture=True,
                                           roulette=(0.5, 1.0))]
        out = TFn.scan_steps(steps, st, 30, key=5, remat=remat)
        (g,) = torch.autograd.grad((out.w * out.alive).sum() / n, A)
        return float(g), int(out.n_alive)

    (g0, n0), (g1, n1) = grad(False), grad(True)
    assert n0 == n1 < n and g0 == g1 and g0 < 0


def _layered(P, t_end, mesh, restore=None, capacity=None):
    c_dt = C * DT
    nfn = P.light.layered_density(np.array([0.5, 3.5, 6.5]) * c_dt,
                                  [1.0, 2.0])
    s = _sim(P, mesh=mesh, until_t=t_end * 0.9999, seed=0,
             capacity=capacity)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.2 / c_dt), variable_n=True,
        variable_n_fn=nfn, implicit_capture=True))
    if restore is None:
        s.add_photons(P.light.generate_photon_state(512, E=1.0))
    else:
        s.restore_checkpoint(restore)
    return s


def test_checkpoint_reshard_8_to_1_to_4_and_back(tmp_path):
    """A checkpoint written on 8 shards resumes on 1 and on 4 (and a
    one-device one on 8) with the uninterrupted 8-shard run's weights and
    positions, exactly; the JAX mesh's reference agrees to rounding."""
    ref = _run(_layered(T, 0.008, 8))
    w_ref = ref.sim_state.w.numpy()[:512]
    r_ref = ref.sim_state.r.numpy()[:, :512]
    jref = _run(_layered(J, 0.008, 8))
    np.testing.assert_allclose(w_ref, np.asarray(jref.sim_state.w)[:512],
                               rtol=1e-6)
    first = _run(_layered(T, 0.004, 8))
    ck = str(tmp_path / "mesh8.npz")
    first.save_checkpoint(ck)
    for mesh in (None, 4):
        resumed = _run(_layered(T, 0.008, mesh, restore=ck))
        assert resumed.sim_state.capacity % (pad_capacity(1)
                                             * (mesh or 1)) == 0
        np.testing.assert_array_equal(resumed.sim_state.w.numpy()[:512],
                                      w_ref)
        np.testing.assert_array_equal(
            resumed.sim_state.r.numpy()[:, :512], r_ref)
        assert len(resumed.ts) == len(ref.ts) == 8
    solo = _run(_layered(T, 0.004, None))
    ck1 = str(tmp_path / "solo.npz")
    solo.save_checkpoint(ck1)
    grown = _run(_layered(T, 0.008, 8, restore=ck1))
    assert grown.sim_state.capacity == UNIT
    np.testing.assert_array_equal(grown.sim_state.w.numpy()[:512], w_ref)


def _hook(step, at_call, edit):
    base = step.collect
    calls = []

    def collect(sim, records):
        base(sim, records)
        calls.append(1)
        if len(calls) == at_call:
            edit(sim)

    step.collect = collect


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_midrun_injection_matches_jax_mesh(fuse):
    """add_photons and add_obj from a collect land at the next boundary,
    re-split over the shards and counted exactly; on the fused tier the
    run equals the JAX mesh's draw for draw, the capacity grown to whole
    shard units where the injection overflows."""
    runs = {}
    for P in (J, T) if fuse == "auto" else (T,):
        s, m = _iso(P, fuse=fuse, n=UNIT - 200, t_end=0.016, seed=0)
        s.chunk_steps = 4
        s.fused_pipeline_depth = 1
        _hook(m, 1, lambda sim, P=P: (
            sim.add_photons(P.light.generate_photon_state(500, E=2.0)),
            sim.add_obj(P.light.PhotonObject(
                E=np.double(3.0), v=np.array([C, 0, 0], np.double)))))
        runs[P] = (_run(s), m)
    ts, tm = runs[T]
    ns = [int(r[1]) for r in tm.data]
    assert ns[0] == UNIT - 200 and ns[-1] == UNIT + 301
    assert ts.sim_state.capacity == 2 * UNIT
    E, alive = _np(ts.sim_state.E), _np(ts.sim_state.alive)
    assert (E[alive] == 2.0).sum() == 500 and (E[alive] == 3.0).sum() == 1
    if fuse == "auto":
        js, jm = runs[J]
        assert ts.used_fused and js.used_fused
        np.testing.assert_array_equal(np.asarray(tm.data),
                                      np.asarray(jm.data))
        np.testing.assert_array_equal(alive, _np(js.sim_state.alive))


def test_remove_obj_on_mesh():
    """A mid-run removal clears the object's global slot."""
    s = _sim(T, until_t=0.0115, seed=0, chunk_steps=4, auto_shrink=False,
             fused_pipeline_depth=1)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    meas = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(2, meas)
    objs = [T.light.PhotonObject(E=np.double(1.0 + i),
                                 v=np.array([C, 0, 0], np.double))
            for i in range(40)]
    s.add_objs(objs)
    _hook(meas, 1, lambda sim: sim.remove_obj(objs[7]))
    _run(s)
    assert [int(r[1]) for r in meas.data][-1] == 39
    alive = _np(s.sim_state.alive)
    assert not alive[7] and alive[:40].sum() == 39


def _wsum(s):
    w, alive = _np(s.sim_state.w), _np(s.sim_state.alive)
    return float(w[alive].astype(np.float64).sum()), int(alive.sum())


def test_split_step_copies_take_global_free_slots():
    """ImportanceSplitStep at "step" on the mesh's generic tier: the
    copies fill global slots from the spawn mark across shard edges, and
    weight is conserved exactly (the JAX mesh test, at 1024 photons)."""
    K = 5
    s = _sim(T, until_t=K * DT * 0.9999, seed=0, capacity=UNIT)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** torch.floor(x / (C * DT) + 0.5),
        roulette=False))
    s.add_photons(T.light.generate_photon_state(1024, E=1.0))
    with pytest.warns(RuntimeWarning):
        _run(s)
    wsum, n = _wsum(s)
    assert n == 1024 * 2 ** K
    np.testing.assert_allclose(wsum, 1024.0, rtol=1e-5)
    # the copies are contiguous from slot 1024 over shard edges
    assert _np(s.sim_state.alive)[:n].all()


def test_chunk_boundary_split_on_mesh_keeps_fused():
    K = 16
    s = _sim(T, until_t=3 * K * DT * 0.9999, seed=5, capacity=UNIT,
             chunk_steps=K)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** torch.floor(x / (K * C * DT) + 0.5),
        roulette=False, at="chunk"))
    s.add_photons(T.light.generate_photon_state(1024, E=1.0))
    _run(s)
    assert s.used_fused
    wsum, n = _wsum(s)
    assert n == 1024 * 2 ** 2
    np.testing.assert_allclose(wsum, 1024.0, rtol=1e-5)


def test_spatial_sort_on_mesh_is_the_global_sort():
    """The mesh's sort is the single-device sort of the global planes: a
    voxel-medium run with spatial_sort on 8 shards equals the unsharded
    run with it (draw-free implicit capture)."""
    c_dt = C * DT
    grid = np.broadcast_to((1.0 + np.arange(16, dtype=np.float32) / 4.0)
                           [:, None, None], (16, 8, 8)).copy()
    rng = np.random.default_rng(7)
    d = rng.normal(size=(3, 4096))
    v = d / np.linalg.norm(d, axis=0) * C
    r0 = rng.uniform(0, 8 * c_dt, (3, 4096))
    res = {}
    for mesh in (8, None):
        nfn = T.light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt)
        s = _sim(T, mesh=mesh, until_t=0.010 * 0.9999, seed=3,
                 chunk_steps=4, spatial_sort=1, capacity=UNIT)
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.light.ScatterDeleteStep(
            np.double(1.0), np.double(0.05 / c_dt), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(T.light.generate_photon_state(4096, E=1.0, v=v,
                                                    r=r0))
        _run(s)
        assert s.used_fused
        res[mesh] = {k: _np(getattr(s.sim_state, k)) for k in
                     ("r", "w", "alive")}
    for k in ("r", "w", "alive"):
        np.testing.assert_array_equal(res[8][k], res[None][k], err_msg=k)
    assert not np.allclose(res[8]["w"][:4096], 1.0)


def test_mesh_refuses_a_process_group_and_pads_capacity():
    """The capacity pads to whole 16384-slot shards; auto_shrink is off on
    a mesh; explain_plan names the run's device."""
    s, _ = _iso(T, mesh=4, fuse="auto", n=1000, t_end=0.002)
    _run(s)
    assert s.sim_state.capacity == 4 * 16384
    assert s.device == torch.device("cpu")
    assert not s._population_policies()[0]
    plan = s.explain_plan()
    assert "fused" in plan and "mesh: 4 shards" in plan


def test_clock_reads_the_global_alive_count():
    """A dt function that reads n_objects sees the mesh's global count (the
    clock advances once an iteration, on the first shard): the 8-shard
    run's clock equals the unsharded run's byte for byte while an
    absorbing wall empties half the population."""
    n = 8 * 1024
    x0 = np.zeros((3, n))
    x0[0, : n // 2] = 50 * C * DT  # the first half starts past the wall
    ts = {}
    for mesh in (8, None):
        s = _sim(T, mesh=mesh, until_t=0.0199, seed=0, fuse="off")
        s.add_step(0, T.UpdateTimeStep(lambda x: torch.where(
            x.n_objects > n * 3 // 4, 2e-3, 1e-3)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.newton.AbsorbingBoundaryStep(
            ((-1e9, 40 * C * DT), (-1e9, 1e9), (-1e9, 1e9))))
        s.add_photons(T.light.generate_photon_state(n, E=1.0, r=x0))
        _run(s)
        ts[mesh] = np.asarray(s.ts, np.float32)
        assert int(s.sim_state.alive.sum()) == n // 2
    assert ts[8].tobytes() == ts[None].tobytes()
    assert ts[8][0] == np.float32(2e-3) and ts[8][1] - ts[8][0] < 1.5e-3


def _capture_sim(P, mesh, step):
    """Draw-free implicit capture in a layered medium, 4096 photons in
    random directions (so weights differ photon to photon), with ``step``
    after the capture."""
    c_dt = C * DT
    nfn = P.light.layered_density(np.array([0.5, 3.5, 6.5]) * c_dt,
                                  [1.0, 2.0])
    d = np.random.default_rng(11).normal(size=(3, 4096))
    s = _sim(P, mesh=mesh, until_t=0.006 * 0.9999, seed=0, fuse="auto",
             capacity=UNIT)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.2 / c_dt), variable_n=True,
        variable_n_fn=nfn, implicit_capture=True))
    s.add_step(3, step)
    s.add_photons(P.light.generate_photon_state(
        4096, E=1.0, v=d / np.linalg.norm(d, axis=0) * C))
    return s


def test_recording_kernelstep_on_mesh_matches_jax_mesh():
    """An elementwise KernelStep whose record_fn takes a mean over the
    particles (refused by the fused tier, kernelstep-records) records the
    global mean on the mesh: equal to the unsharded run's and to the JAX
    8-device run's, not a sum of shard means."""
    import physicl_tpu.kernels as JK
    from physicl_tpu_torch import kernels as TK

    def wmean(st):
        return {"wmean": (st.w * st.alive).sum() / st.alive.sum()}

    means = {}
    for P, K, mesh in ((T, TK, 8), (T, TK, None), (J, JK, 8)):
        k = K.KernelStep(lambda st, ctx: st, record_fn=wmean,
                         elementwise=True)
        s = _capture_sim(P, mesh, k)
        with pytest.warns(RuntimeWarning, match="kernelstep-records"):
            _run(s)
        assert not s.used_fused
        means[P, mesh] = np.array([float(r["wmean"]) for r in k.data])
    assert len(means[T, 8]) == 6 and means[T, 8][-1] < 0.999
    np.testing.assert_array_equal(means[T, 8], means[T, None])
    np.testing.assert_allclose(means[T, 8], means[J, 8], rtol=1e-6)


def test_undeclared_user_step_applies_to_the_global_state():
    """A user Step that renormalises the weights by their global sum, and
    a subclass of a shard-local built-in step that overrides apply, apply
    once to the gathered planes on a mesh: the mesh run equals the
    unsharded one (per shard, each shard would renormalise to the total)."""
    from physicl_tpu_torch.parallel.sharding import _declared

    class Renormalise(T.Step):
        def apply(self, state, ctx):
            live = state.w * state.alive
            ctx.record(self, "total", live.sum())
            return state.replace(w=state.w * (4096.0 / live.sum()))

    class Kinematics(T.newton.NewtonianKinematicsStep):
        def apply(self, state, ctx):
            ctx.record(self, "mean_x", (state.r[0] * state.alive).mean())
            return super().apply(state, ctx)

    assert _declared(Kinematics(), "mesh_records") is None
    assert _declared(T.newton.NewtonianKinematicsStep(),
                     "mesh_records") == {}
    out = {}
    for mesh in (8, None):
        step = Renormalise()
        s = _capture_sim(T, mesh, step)
        s.add_step(4, Kinematics())
        _run(s)
        assert not s.used_fused
        out[mesh] = (_np(s.sim_state.w)[:4096], np.array(s.ts))
    np.testing.assert_array_equal(out[8][0], out[None][0])
    np.testing.assert_allclose(out[8][0].sum(), 4096.0, rtol=1e-5)
    assert out[8][1].tobytes() == out[None][1].tobytes()


def test_a_shard_record_without_a_rule_raises():
    """A step declared shard-local that records a name its mesh_records
    does not cover fails the mesh run, naming the record: shards never
    guess how to combine."""

    class Tally(T.Step):
        mesh_records = {"n_live": "sum"}

        def apply(self, state, ctx):
            ctx.record(self, "n_live", state.alive.sum())
            ctx.record(self, "w_max", state.w.max())
            return state

    s = _capture_sim(T, 8, Tally())
    s.start()
    with pytest.raises(ValueError, match="'w_max'.*no combine rule"):
        s.join()


def test_scan_steps_generator_key_advances_on_a_mesh():
    """A torch.Generator key seeds a sharded scan from its current state
    and advances, as on one device: two calls with one generator draw
    differently, and a generator seeded alike repeats the first call."""
    mesh = make_mesh(8, devices=["cpu"])

    def run(gen):
        st = shard_state(SimState.from_population(
            [], [T.light.generate_photon_state(8 * 256, E=1.0)],
            device="cpu", capacity=UNIT), mesh)
        steps = [T.UpdateTimeStep(lambda x: DT),
                 T.newton.NewtonianKinematicsStep(),
                 T.light.ScatterIsotropicStep(A=0.5 / (C * DT), n=1.0)]
        return TFn.scan_steps(steps, st, 4, key=gen).v

    g = torch.Generator().manual_seed(9)
    first, second = run(g), run(g)
    assert not torch.equal(first, second)
    assert torch.equal(first, run(torch.Generator().manual_seed(9)))
