"""``Simulation(spatial_sort=K)``: the population reordered by the flat
voxel index of its nearest voxel every K dispatches, against the JAX
package.

* ``make_spatial_sort`` is held to the JAX one on identical inputs: the
  same permutation, exactly (the key is ``round((r - o) / s)``, with no
  product a compiler could contract);
* at run level the port's fused and generic tiers, both sorting at the
  same boundaries, agree slot for slot on a draw-free plan (implicit
  capture), and sorting changes only the slot order (the weights as a
  multiset). Run-level comparison with the JAX package would be
  statistical only: XLA's FMAs move positions by an ulp, which can flip a
  key at a voxel face;
* the refusals ``[stable-ids]``, ``[host-exact]`` and ``[no-voxel-table]``
  each warn and leave the run unsorted.

Four places where the port keeps the intended contract and the JAX
package does not (each test names the difference):

* a sort drops the ``ImportanceSplitStep(at="chunk")`` snapshot, so a
  boundary never compares one particle's position with another's (JAX
  keeps the snapshot across the permutation);
* in host-exact mode the port warns ``[host-exact]`` and its plan report
  names no sort (JAX adds a "spatial sort" note for a sort that never
  runs);
* a refused sort does not block ``remove_obj``, and the error names
  ``spatial_sort`` where an active sort is the cause (JAX counts a refused
  sort as moving slots, and its message does not name it);
* any ``voxel_density`` medium keys the sort (JAX refuses
  ``[no-voxel-table]`` for grids past its in-VMEM table caps, which the
  port's kernel does not have).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.ops.compaction import make_spatial_sort as jax_sort
from physicl_tpu.state import SimState as JState
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.ops.compaction import make_spatial_sort
from physicl_tpu_torch.state import SimState

DT = 0.001
SPEC = {"shape": (16, 16, 16), "origin": (0.0, 0.0, 0.0),
        "spacing": (1.0, 1.0, 1.0)}


def _grid16():
    ii = np.arange(16, dtype=np.float32) % 8
    return np.broadcast_to((1.0 + ii / 8.0)[:, None, None],
                           (16, 16, 16)).copy()


def _population(cap=512, n_sp=300, seed=0):
    """Host planes: positions over (and past) the grid, about 70% of the
    spawned slots alive, E the slot's index (an identity tag), an extras
    plane."""
    rng = np.random.default_rng(seed)
    alive = np.zeros(cap, bool)
    alive[:n_sp] = rng.uniform(size=n_sp) < 0.7
    return {
        "r": rng.uniform(-2.0, 18.0, (3, cap)).astype(np.float32),
        "v": rng.normal(size=(3, cap)).astype(np.float32),
        "E": np.arange(cap, dtype=np.float32),
        "w": rng.uniform(0.1, 1.0, cap).astype(np.float32),
        "alive": alive, "n_spawned": np.int32(n_sp),
        "extras": {"tag": rng.uniform(size=cap).astype(np.float32),
                   "vec": rng.uniform(size=(3, cap)).astype(np.float32)},
    }


def _torch_state(p):
    cap = p["E"].shape[0]
    z = np.zeros((3, cap), np.float32)
    fields = {"r": p["r"], "dr": z, "v": p["v"], "dv": z, "a": z,
              "E": p["E"], "alive": p["alive"], "otype": np.ones(cap,
                                                                 np.int32),
              "w": p["w"], "t": np.float32(0.5), "dt": np.float32(1e-3),
              "n_spawned": p["n_spawned"], "extras": p["extras"]}
    return SimState.from_numpy(fields, "cpu")


def test_make_spatial_sort_slot_contract():
    """Alive particles in voxel order, then the spawned dead, then the
    free tail in its order; n_spawned and the scalars untouched; every
    plane, the extras included, under one permutation."""
    p = _population()
    st = _torch_state(p)
    out = make_spatial_sort(SPEC)(st)
    n_sp, alive = int(p["n_spawned"]), p["alive"]
    assert int(out.n_spawned) == n_sp
    assert float(out.t) == 0.5 and out.key is st.key
    n_alive = int(alive.sum())
    alive_o = out.alive.numpy()
    assert alive_o[:n_alive].all() and not alive_o[n_alive:].any()
    ro = out.r.numpy()
    idx = np.clip(np.round(ro), 0, 15).astype(int)
    flat = (idx[0] * 16 + idx[1]) * 16 + idx[2]
    assert (np.diff(flat[:n_alive]) >= 0).all()
    perm = out.E.numpy().astype(int)
    assert sorted(perm.tolist()) == list(range(perm.size))
    np.testing.assert_array_equal(ro, p["r"][:, perm])
    np.testing.assert_array_equal(out.w.numpy(), p["w"][perm])
    np.testing.assert_array_equal(out.extras["vec"].numpy(),
                                  p["extras"]["vec"][:, perm])
    # spawned dead behind the alive block, the free tail at the back
    assert set(perm[n_alive:n_sp]) == set(np.nonzero(~alive[:n_sp])[0])
    np.testing.assert_array_equal(perm[n_sp:], np.arange(n_sp, perm.size))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_spatial_sort_matches_jax(seed):
    """The same permutation as the JAX package's sort, on identical inputs
    (offset grid, unequal spacings, particles outside the grid)."""
    spec = {"shape": (12, 16, 8), "origin": (-1.5, 0.25, 2.0),
            "spacing": (1.25, 0.75, 2.5)}
    p = _population(cap=1024, n_sp=900, seed=seed)
    out = make_spatial_sort(spec)(_torch_state(p))
    cap = p["E"].shape[0]
    js = JState.zeros(cap).replace(
        r=jnp.asarray(p["r"]), v=jnp.asarray(p["v"]), E=jnp.asarray(p["E"]),
        w=jnp.asarray(p["w"]), alive=jnp.asarray(p["alive"]),
        n_spawned=jnp.int32(p["n_spawned"]),
        extras={k: jnp.asarray(v) for k, v in p["extras"].items()})
    jo = jax_sort(spec)(js)
    np.testing.assert_array_equal(out.E.numpy(), np.asarray(jo.E))
    np.testing.assert_array_equal(out.r.numpy(), np.asarray(jo.r))
    np.testing.assert_array_equal(out.extras["tag"].numpy(),
                                  np.asarray(jo.extras["tag"]))


def _run(fuse, sort, *, seed=3, n=512, chunk=4, trace=False, grid=None,
         split=None, iters=10):
    c_dt = float(T.light.c) * DT
    nfn = T.light.voxel_density(_grid16() if grid is None else grid,
                                origin=(0, 0, 0), spacing=c_dt)
    s = T.Simulation(until_t=(iters - 0.5) * DT, seed=seed, fuse=fuse,
                     spatial_sort=sort, chunk_steps=chunk, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.05 / c_dt), variable_n=True,
        variable_n_fn=nfn, implicit_capture=True))
    if trace:
        s.add_step(3, T.light.TracePathMeasureStep(None))
    if split is not None:
        s.add_step(4, split)
    rng = np.random.default_rng(7)
    r0 = rng.uniform(0, 15 * c_dt, (3, n)).astype(np.float32)
    E = np.arange(1, n + 1, dtype=np.float64)  # one tag per photon
    s.add_photons(T.light.generate_photon_state(n, E=E, r=r0))
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        s.start()
        s.join()
    s.warned = [str(x.message) for x in wl]
    return s


def test_spatial_sort_fused_generic_parity_and_neutral():
    """Both tiers sort at the same boundaries and agree slot for slot; the
    sort only reorders (the weights as a multiset match the unsorted
    run); the final order tracks the voxel index."""
    w0 = _run("auto", 0).sim_state.w.numpy()
    s1 = _run("auto", 1)
    s2 = _run("off", 1)
    assert s1.used_fused and not s2.used_fused
    assert s1._sort_tick >= 3 and s2._sort_tick >= 3
    for name in ("w", "E", "r", "alive"):
        np.testing.assert_array_equal(getattr(s1.sim_state, name).numpy(),
                                      getattr(s2.sim_state, name).numpy())
    w1 = s1.sim_state.w.numpy()
    np.testing.assert_array_equal(np.sort(w0), np.sort(w1))
    assert not np.array_equal(w0, w1)  # the sort moved slots
    st = s1.sim_state
    alive = st.alive.numpy()
    r = st.r.numpy()[:, alive] / (float(T.light.c) * DT)
    idx = np.clip(np.round(r), 0, 15).astype(int)
    flat = (idx[0] * 16 + idx[1]) * 16 + idx[2]
    assert np.corrcoef(flat, np.arange(flat.size))[0, 1] > 0.8
    assert "spatial sort" in s1.explain_plan()


def test_spatial_sort_every_k_dispatches():
    """spatial_sort=2 sorts on dispatches 0, 2, 4, ... only."""
    fired = []
    s = T.Simulation(until_t=(10 - 0.5) * DT, seed=0, spatial_sort=2,
                     chunk_steps=2, device="cpu")
    s._maybe = s._maybe_spatial_sort

    def watched(state, pop, provider=None):
        before = s._sort_tick
        out = s._maybe(state, pop, provider)
        fired.append((before, out is not state))
        return out

    s._maybe_spatial_sort = watched
    c_dt = float(T.light.c) * DT
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.05 / c_dt), variable_n=True,
        variable_n_fn=T.light.voxel_density(_grid16(), spacing=c_dt),
        implicit_capture=True))
    s.add_photons(T.light.generate_photon_state(64, E=1.0))
    s.start()
    s.join()
    assert len(fired) >= 5
    assert all(did == (tick % 2 == 0) for tick, did in fired)


def test_spatial_sort_refusals():
    """[no-voxel-table] (no voxel medium), [stable-ids] (a trace) and
    [host-exact] (an exit checked on the host) each warn, leave the sort
    off and run to the end."""
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        s = T.Simulation(until_t=0.0015, seed=0, spatial_sort=1,
                         device="cpu")
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.light.ScatterDeleteStep(np.double(0.0),
                                                np.double(0.0)))
        s.add_photons(T.light.generate_photon_state(64, E=1.0))
        s.start()
        s.join()
    assert any("[no-voxel-table]" in str(x.message) for x in wl)
    assert s._sort_fn is None and len(s.ts) == 2

    s = _run("auto", 1, trace=True)
    assert any("[stable-ids]" in m for m in s.warned)
    assert s._sort_fn is None and len(s.ts) == 10


def test_host_exact_refuses_and_reports_no_sort():
    """In host-exact mode the sort never runs: the port warns
    ``[host-exact]`` and its plan report names no sort. (The JAX package
    warns nothing and adds its "spatial sort" note all the same.)"""
    c_dt = float(T.light.c) * DT
    s = T.Simulation(seed=0, spatial_sort=1, device="cpu")
    s.exit = lambda x: all(float(o.r[0]) > 2.5 * c_dt for o in x.objects)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.0), variable_n=True,
        variable_n_fn=T.light.voxel_density(_grid16(), spacing=c_dt),
        implicit_capture=True))
    for _ in range(3):
        s.add_obj(T.light.PhotonObject(
            E=np.double(1.0), v=np.array([float(T.light.c), 0, 0])))
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        s.start()
        s.join()
    assert s.chunk_used == 1 and len(s.ts) == 3
    assert any("spatial_sort disabled [host-exact]" in str(x.message)
               for x in wl)
    assert s._sort_fn is None
    assert "spatial sort" not in s.explain_plan()


def test_refused_sort_keeps_slots_stable():
    """A refused sort moves no slot: ``remove_obj`` works during the run.
    (The JAX package's ``_slots_stable`` counts the requested knob, so it
    refuses this removal.)"""
    s = T.Simulation(until_t=(40 - 0.5) * DT, seed=0, spatial_sort=1,
                     chunk_steps=8, auto_shrink=False, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    m = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(2, m)
    c = float(T.light.c)
    objs = [T.light.PhotonObject(E=np.double(1.0 + i),
                                 v=np.array([c, 0, 0])) for i in range(4)]
    for o in objs:
        s.add_obj(o)
    base, errors = m.collect, []

    def collect(sim, records):
        base(sim, records)
        if len(sim.ts) == 8:
            try:
                sim.remove_obj(objs[2])
            except RuntimeError as e:  # pragma: no cover - the failure
                errors.append(e)

    m.collect = collect
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # [no-voxel-table]
        s.start()
        s.join()
    assert s._sort_resolved and s._sort_fn is None
    assert not errors and not s._slot_movers()
    assert sorted(float(o.E) for o in s.objects) == [1.0, 2.0, 4.0]
    # before the run resolves it the requested sort counts as moving slots
    s2 = T.Simulation(spatial_sort=1, auto_shrink=False, device="cpu")
    s2.add_obj(objs[0])
    s2.running = True
    try:
        with pytest.raises(RuntimeError, match="spatial_sort may move"):
            s2.remove_obj(objs[0])
    finally:
        s2.running = False


def test_sort_drops_the_split_snapshot():
    """A sort permutes slots, so an ``ImportanceSplitStep(at="chunk")``
    snapshot taken before it would compare one particle's old position
    with another's new one. The port drops the snapshot whenever the sort
    fires: every comparison the split makes is between positions of the
    same particle (checked through each slot's E tag). (The JAX package
    keeps the snapshot across the sort.)"""
    c_dt = float(T.light.c) * DT
    split = T.light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** torch.floor(x / (4 * c_dt)), at="chunk",
        roulette=False, max_split=2)
    tags, compared = {}, []
    base_q, base_apply = split._q, split.boundary_apply

    def boundary_apply(state, ctx):
        out = base_apply(state, ctx)
        tags["E"] = out.E.clone()  # the snapshot's particles
        return out

    def q(state, r_prev):
        if r_prev is split._prev_r and "E" in tags:
            both = state.alive & (tags["E"] != 0)
            compared.append(bool(torch.equal(state.E[both],
                                             tags["E"][both])))
        return base_q(state, r_prev)

    split.boundary_apply, split._q = boundary_apply, q
    s = _run("auto", 2, split=split, chunk=2, iters=16)
    assert s.used_fused and s._sort_fn is not None
    assert compared and all(compared)
    assert len(s.objects) > 512  # the split did split


def test_any_voxel_grid_keys_the_sort():
    """A 32**3 grid of 32768 distinct densities is past every in-VMEM
    table cap of the JAX package, which refuses it ``[no-voxel-table]``;
    the port keys the sort on it (its kernel reads any grid from device
    memory)."""
    grid = np.random.default_rng(3).uniform(1.0, 2.0, (32, 32, 32))
    c_dt = float(J.light.c) * DT
    jfn = J.light.voxel_density(grid, spacing=c_dt)
    assert getattr(jfn, "vox_spec", None) is None
    js = J.Simulation(until_t=0.01, seed=0, spatial_sort=1)
    js.add_step(0, J.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.0), variable_n=True,
        variable_n_fn=jfn, implicit_capture=True))
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        assert js._setup_spatial_sort(js._ordered_steps()) is None
    assert any("[no-voxel-table]" in str(x.message) for x in wl)

    s = _run("auto", 1, grid=grid.astype(np.float32))
    assert s.used_fused and s._sort_fn is not None
    assert not any("spatial_sort disabled" in m for m in s.warned)
    assert "spatial sort" in s.explain_plan()


def test_fused_sort_permutes_the_packed_planes():
    """On the fused tier the sort gathers the provider's packed planes in
    one step (no repack at the next dispatch): every sort there takes that
    route and gives, plane for plane and bitwise, what ``permute_state``
    gives on the same state and permutation, an extras plane the kernel
    does not write back included. No sort runs before the t-exit's
    dispatch, which runs no iteration."""
    from physicl_tpu_torch.ops import compaction
    from physicl_tpu_torch.ops.pipeline import FusedProvider

    base = FusedProvider.permute
    seen = []

    def permute(self, state, perm):
        want = compaction.permute_state(state, perm)
        out = base(self, state, perm)
        seen.append((out is not None, self._last_packed is not None
                     and out is self._last_state))
        if out is None:
            return out
        for f in ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f
        assert torch.equal(out.extras["tag"], want.extras["tag"])
        return out

    c_dt = float(T.light.c) * DT
    s = T.Simulation(until_t=(8 - 0.5) * DT, seed=2, spatial_sort=1,
                     chunk_steps=2, auto_shrink=False, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.05 / c_dt), variable_n=True,
        variable_n_fn=T.light.voxel_density(_grid16(), spacing=c_dt),
        implicit_capture=True))
    rng = np.random.default_rng(4)
    bulk = T.light.generate_photon_state(
        300, E=1.0, r=rng.uniform(0, 15 * c_dt, (3, 300)))
    bulk["extras"] = {"tag": np.arange(300, dtype=np.float32)}
    s.add_photons(bulk)
    FusedProvider.permute = permute
    try:
        s.start()
        s.join()
    finally:
        FusedProvider.permute = base
    assert s.used_fused
    # four chunks: four sorts, the first on the state built from the
    # population (no packed planes yet), the others on the packed cache
    assert seen == [(False, False)] + [(True, True)] * 3
    tag = s.sim_state.extras["tag"]
    assert sorted(tag[:300].tolist()) == list(range(300))
