"""Checkpoints shared with the JAX package.

The port writes and reads the JAX package's ``.npz`` format: the same
fields, ``extra.<name>`` planes and ``__meta__`` (``ts``, ``seed``,
``initial_count``, ``key_impl``, ``hwm``). ``key`` holds the raw data of
``jax.random.PRNGKey(seed)``, which the JAX package can use, and the
port's ``torch.Generator`` state rides under a name the JAX package does
not read. So:

* a file from either package loads in the other with every plane, the
  extras, ``t`` / ``dt`` / ``t_comp``, ``n_spawned``, ``ts`` and ``hwm``
  exactly equal;
* a run restored on the fused tier restarts the chunk index at 0 in both
  packages and the counter hash never reads ``key``, so the port's
  restore of a JAX checkpoint draws as the JAX restore does: the int
  records are equal, ``sim.ts`` byte-identical and the planes within the
  main path's rtol 1e-6 + atol 1e-6 * max|plane|;
* a resumed run equals a straight run where the physics is deterministic.

A restored run goes back onto the fused tier in the port: its prover reads
the species, speeds and planes from the restored state's live slots. The
JAX prover reads them from the pending population only, so a JAX restore
with nothing added is refused ``empty-population`` and runs on the generic
scan; the cross-package comparison hands the JAX restore the same bulk,
which its state build ignores and its prover reads.
"""

import json

import numpy as np
import pytest
import torch

import jax

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.utils import checkpoint as JC
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.utils import checkpoint as TC

DT = 0.001
PLANES = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t", "dt",
          "t_comp", "n_spawned")


def _scatter_sim(P, iters, restore=None, seed=5, **kw):
    """The main path's steps on a bulk of 3000 photons with a per-photon
    ``tag`` extras plane, or on a restored checkpoint."""
    s = P.Simulation(until_t=(iters - 0.5) * DT, seed=seed, chunk_steps=16,
                     auto_shrink=False, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.001, n=0.001))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    if restore is None:
        bulk = P.light.generate_photon_state(3000, E=1.0)
        bulk["extras"] = {"tag": np.linspace(0.0, 1.0, 3000,
                                             dtype=np.float32)}
        s.add_photons(bulk)
    else:
        s.restore_checkpoint(restore)
    return s, m


def _run(s):
    s.start()
    s.join()
    return s


def _host(P, state):
    if P is J:
        host = {f: np.asarray(jax.device_get(getattr(state, f)))
                for f in PLANES}
        host["extras"] = {k: np.asarray(v) for k, v in state.extras.items()}
        return host
    return state.to_numpy()


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_checkpoint_loads_in_the_other_package(writer, reader, tmp_path):
    path = str(tmp_path / "ck.npz")
    kw = {"device": "cpu"} if writer is T else {}
    s, _ = _scatter_sim(writer, 40, **kw)
    _run(s)
    s.save_checkpoint(path)
    if reader is T:
        state, meta = TC.load_checkpoint(path, device="cpu")
    else:
        state, meta = JC.load_checkpoint(path)
    want, got = _host(writer, s.sim_state), _host(reader, state)
    for f in PLANES:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert set(got["extras"]) == {"tag"}
    np.testing.assert_array_equal(got["extras"]["tag"],
                                  want["extras"]["tag"])
    assert meta["ts"] == [float(t) for t in s.ts] and len(meta["ts"]) == 40
    assert meta["hwm"] == 3000 and meta["initial_count"] == 3000
    assert meta["seed"] == 5 and meta["key_impl"] is None
    if writer is T:
        # JAX can use the key the port wrote
        with np.load(path) as z:
            np.testing.assert_array_equal(
                z["key"], np.asarray(jax.random.PRNGKey(5)))
            assert "torch_generator.cpu" in z.files


def test_restore_of_a_jax_checkpoint_draws_as_jax(tmp_path):
    """Both packages restore the same JAX file onto the fused tier and run
    48 more iterations: the chunk seeds restart at chunk 0 in both."""
    path = str(tmp_path / "jax.npz")
    s, _ = _scatter_sim(J, 40)
    _run(s)
    s.save_checkpoint(path)
    js, jm = _scatter_sim(J, 88, restore=path)
    js.add_photons(J.light.generate_photon_state(3000, E=1.0))  # see above
    ts, tm = _scatter_sim(T, 88, restore=path, device="cpu")
    _run(js)
    _run(ts)
    assert js.used_fused and ts.used_fused
    assert len(tm.data) == len(jm.data) == 48
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    assert np.asarray(ts.ts, np.float32).tobytes() == \
        np.asarray(js.ts, np.float32).tobytes()
    assert len(ts.ts) == 88
    live = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), live)
    for f in ("r", "dr", "v", "E"):
        want = np.asarray(getattr(js.sim_state, f))[..., live]
        got = getattr(ts.sim_state, f).numpy()[..., live]
        scale = float(np.abs(want).max())
        assert np.all(np.abs(got - want)
                      <= 1e-6 * np.abs(want) + 1e-6 * scale), f
    np.testing.assert_array_equal(ts.sim_state.extras["tag"].numpy(),
                                  np.asarray(js.sim_state.extras["tag"]))


def _kinematics_sim(iters, restore=None, **kw):
    s = T.Simulation(until_t=(iters - 0.5) * DT, seed=0, device="cpu", **kw)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    if restore is None:
        rng = np.random.default_rng(0)
        d = rng.normal(size=(3, 500))
        s.add_photons(T.light.generate_photon_state(
            500, E=1.0, v=d / np.linalg.norm(d, axis=0) * float(T.light.c)))
    else:
        s.restore_checkpoint(restore)
    return s


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_resume_equals_straight_run(fuse, tmp_path):
    """Kinematics only: ten iterations straight equal five, a checkpoint,
    and five more, planes and clock bit for bit."""
    path = str(tmp_path / "ck.npz")
    a = _run(_kinematics_sim(10, fuse=fuse))
    b = _run(_kinematics_sim(5, fuse=fuse))
    b.save_checkpoint(path)
    c = _kinematics_sim(10, restore=path, fuse=fuse)
    _run(c)
    assert c.used_fused == (fuse == "auto")
    assert len(c.ts) == len(a.ts) == 10 and c.ts == a.ts
    for f in ("r", "v", "t", "t_comp"):
        assert torch.equal(getattr(c.sim_state, f), getattr(a.sim_state, f))


def test_generic_restore_continues_the_generator(tmp_path):
    """On the generic tier the restored generator continues the saved
    stream: a run split by a checkpoint equals the straight run."""
    path = str(tmp_path / "ck.npz")

    def sim(iters, restore=None):
        s = T.Simulation(until_t=(iters - 0.5) * DT, seed=9, fuse="off",
                         chunk_steps=4, auto_shrink=False, device="cpu")
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.light.ScatterIsotropicStep(A=0.001, n=0.001))
        if restore is None:
            s.add_photons(T.light.generate_photon_state(1000, E=1.0))
        else:
            s.restore_checkpoint(restore)
        return s

    a = _run(sim(16))
    b = _run(sim(8))
    b.save_checkpoint(path)
    c = _run(sim(16, restore=path))
    assert torch.equal(c.sim_state.v, a.sim_state.v)
    # a file without the generator state (the JAX package's) seeds it
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("torch_")}
    np.savez(path, **kept)
    d = _run(sim(16, restore=path))
    assert not torch.equal(d.sim_state.v, a.sim_state.v)
    assert d.ts == a.ts


def test_restore_repads_and_clamps_the_spawn_mark(tmp_path):
    """A 16384-slot snapshot restored with capacity=40000 runs at 49152
    slots (the pad); restored at its own size it keeps 16384; the spawn
    mark comes from the file."""
    path = str(tmp_path / "ck.npz")
    b = _run(_kinematics_sim(5))
    b.save_checkpoint(path)
    c = _run(_kinematics_sim(8, restore=path, capacity=40000))
    assert c.sim_state.capacity == 49152 and c._hwm == 500
    assert c._initial_count == 500 and len(c.ts) == 8
    assert int(c.sim_state.alive.sum()) == 500
    d = _kinematics_sim(8, restore=path)
    assert "fused" in d.explain_plan()  # the plan keeps the pending restore
    _run(d)
    assert d.sim_state.capacity == 16384 and len(d.ts) == 8


def test_repad_state():
    s = _run(_kinematics_sim(2))
    st = s.sim_state
    grown = TC.repad_state(st, 32768)
    assert grown.capacity == 32768
    assert torch.equal(grown.r[:, :16384], st.r)
    assert not bool(grown.alive[16384:].any())
    assert bool((grown.w[16384:] == 1.0).all())
    assert bool((grown.E[16384:] == 0.0).all())
    back = TC.repad_state(grown, 16384, hwm=500)
    assert torch.equal(back.r, st.r) and back.capacity == 16384
    assert TC.repad_state(st, 16384) is st
    with pytest.raises(ValueError, match="used slots"):
        TC.repad_state(grown, 16384, hwm=20000)
    moved = grown.replace(alive=grown.alive.clone())
    moved.alive[20000] = True
    with pytest.raises(ValueError, match="live particles"):
        TC.repad_state(moved, 16384, hwm=500)


def test_meta_and_key_format(tmp_path):
    """The meta JSON has the JAX package's keys, and the key field is
    PRNGKey(seed)'s data for any seed."""
    for seed in (0, 7, 2 ** 31 - 1, 2 ** 32 + 3):
        np.testing.assert_array_equal(TC.jax_key_data(seed),
                                      np.asarray(jax.random.PRNGKey(seed)))
    path = str(tmp_path / "pre.npz")
    s = T.Simulation(seed=11, device="cpu")
    s.add_photons(T.light.generate_photon_state(10, E=1.0))
    s.save_checkpoint(path)  # before start(): the pending population
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
    assert set(meta) >= {"ts", "seed", "initial_count", "key_impl", "hwm"}
    state, _ = JC.load_checkpoint(path)
    assert int(np.asarray(state.alive).sum()) == 10


def test_restored_run_fuses_unlike_jax(tmp_path):
    """The port's restore keeps the fused tier with nothing added; the JAX
    package's falls back (``empty-population``: its prover reads the
    species from the pending population)."""
    path = str(tmp_path / "ck.npz")
    s, _ = _scatter_sim(T, 16, device="cpu")
    _run(s)
    s.save_checkpoint(path)
    ts, tm = _scatter_sim(T, 32, restore=path, device="cpu")
    js, _ = _scatter_sim(J, 32, restore=path)
    assert "empty-population" in js.explain_plan()
    assert "execution mode: fused" in ts.explain_plan()
    assert "const-norm |dr| = c*dt: on" in ts.explain_plan()
    _run(ts)
    assert ts.used_fused and len(tm.data) == 16
    assert np.asarray(tm.data)[0, 1] == 3000


def test_restore_ignores_the_added_population(tmp_path):
    """A restored state ignores objects added before ``start()``, as the
    JAX package's does, and so do the prover and the identity registry:
    a generic object added to a restored photon run neither moves the run
    off the fused tier nor gets a slot for ``remove_obj``; the records
    equal those of the same restore with nothing added."""
    path = str(tmp_path / "ck.npz")
    s, _ = _scatter_sim(T, 16, device="cpu")
    _run(s)
    s.save_checkpoint(path)
    plain, pm = _scatter_sim(T, 32, restore=path, device="cpu")
    added, am = _scatter_sim(T, 32, restore=path, device="cpu")
    extra = T.Object(v=T.Measurement([5.0, 0, 0], "m**1 s**-1"))
    added.add_obj(extra)
    _run(plain)
    _run(added)
    assert plain.used_fused and added.used_fused
    assert added._slot_of == {}
    assert added.ts == plain.ts
    np.testing.assert_array_equal(np.asarray(am.data), np.asarray(pm.data))
