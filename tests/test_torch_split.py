"""Population control in the port: ImportanceSplitStep / WeightWindowStep
on both tiers, mirroring ``tests/test_split.py``.

``at="step"`` runs on the generic tier; ``at="chunk"`` is a boundary op
between dispatches, so the transport keeps the fused tier (its twin on the
CPU). The invariants are the JAX package's: a split conserves total weight
exactly (float32 rounding: rtol 1e-5 over a run), capacity clipping keeps
it conserved, ``max_split`` caps the copies, roulette is unbiased in
expectation, window bands hold, copies inherit the kinematics, and no
boundary pass runs after the final iteration. The draw-for-draw parity of
the split against the JAX ``apply`` is in
``tests/test_torch_generic_steps.py``.

The repair of slot recycling under chunk-boundary splitting: compaction
moves slots, so it drops the boundary snapshots and the next boundary
re-snapshots (``test_recycle_resets_the_boundary_snapshot``).
"""

import numpy as np
import pytest
import torch

import physicl_tpu_torch as T
import physicl_tpu_torch.light as light

C_CODE = float(light.c)
DT = 1e-3


def _base(n_photons, capacity, seed=0, T_end=0.02, **kw):
    s = T.Simulation(until_t=T_end * 0.9999, seed=seed, capacity=capacity,
                     device="cpu", **kw)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(n_photons, E=1.0))
    return s


def _run(s):
    s.start()
    s.join()
    return s


def _wsum(s):
    st = s.sim_state
    w = st.w.double().numpy()
    alive = st.alive.numpy()
    return float(w[alive].sum()), int(alive.sum())


def _doubling(per):
    return lambda x, y, z: 2.0 ** torch.floor(x / (per * C_CODE * DT) + 0.5)


def test_split_conserves_total_weight_exactly():
    """Importance doubles every flight segment: every particle splits in
    two each iteration; sum(w) is conserved and the population doubles."""
    s = _base(64, capacity=65536, T_end=0.005)
    s.add_step(2, light.ImportanceSplitStep(_doubling(1), roulette=False))
    _run(s)
    wsum, n = _wsum(s)
    assert not s.used_fused
    assert n == 64 * 2 ** 5  # 5 iterations, clean doubling
    np.testing.assert_allclose(wsum, 64.0, rtol=1e-5)
    w = s.sim_state.w.numpy()[s.sim_state.alive.numpy()]
    np.testing.assert_allclose(w, 1.0 / 2 ** 5, rtol=1e-6)


def test_split_does_not_change_implicit_capture_observable():
    """Splitting under implicit capture: the weighted survival sum is the
    analytic N (1 - p)^k, with and without population control."""
    p, k = 0.02, 20
    A = np.double(p / (C_CODE * DT))
    ref = _base(256, capacity=16384, seed=1, T_end=DT * k)
    ref.add_step(2, light.ScatterDeleteStep(A, np.double(1.0),
                                            implicit_capture=True))
    _run(ref)
    s = _base(256, capacity=65536, seed=1, T_end=DT * k)
    s.add_step(2, light.ScatterDeleteStep(A, np.double(1.0),
                                          implicit_capture=True))
    s.add_step(3, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** torch.floor(x / (4 * C_CODE * DT)),
        roulette=False))
    _run(s)
    w_ref, n_ref = _wsum(ref)
    w_spl, n_spl = _wsum(s)
    expect = 256 * (1 - p) ** k
    np.testing.assert_allclose(w_ref, expect, rtol=1e-4)
    np.testing.assert_allclose(w_spl, expect, rtol=1e-4)
    assert n_spl > 4 * n_ref


def test_capacity_clipping_keeps_weight_conserved():
    """The arena fills: copies that do not fit are not made, the survivor
    keeps the larger share, total weight stays exact."""
    s = _base(128, capacity=16384, T_end=0.02)  # 128 * 2^20 >> capacity
    s.add_step(2, light.ImportanceSplitStep(_doubling(1), roulette=False))
    _run(s)
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 128.0, rtol=1e-4)
    assert n == 16384  # arena exactly full


def test_max_split_caps_copies():
    s = _base(64, capacity=65536, T_end=0.002)  # one split iteration
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: torch.where(x > 0, 100.0, 1.0), max_split=4,
        roulette=False))
    _run(s)
    wsum, n = _wsum(s)
    assert n == 64 * 4
    np.testing.assert_allclose(wsum, 64.0, rtol=1e-5)


def test_roulette_unbiased_in_expectation():
    """Down-importance roulette conserves the expected total weight."""
    s = _base(20000, capacity=32768, T_end=0.005, seed=7)
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 0.5 ** torch.floor(x / (C_CODE * DT) + 0.5)))
    _run(s)
    wsum, n = _wsum(s)
    assert n < 20000 / 16  # 5 halvings: ~20000 / 32 survive
    np.testing.assert_allclose(wsum, 20000.0, rtol=0.05)


def test_weight_window_splits_heavy_sources():
    s = T.Simulation(until_t=0.003 * 0.9999, seed=3, capacity=65536,
                     device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, light.WeightWindowStep(w_lo=0.25, w_hi=4.0, w_target=1.0,
                                         max_split=16))
    s.add_photons(light.generate_photon_state(100, E=1.0, w=32.0))
    _run(s)
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 3200.0, rtol=1e-4)
    w = s.sim_state.w.numpy()[s.sim_state.alive.numpy()]
    # q = 32 capped at 16: one split to w = 2, inside the window
    assert n == 1600 and np.all(w <= 4.0) and np.all(w >= 0.25)
    np.testing.assert_allclose(w, 2.0)


def test_weight_window_roulettes_light_particles():
    """Light particles (w = 0.05 < w_lo) play roulette up to w_target:
    the expected total weight is kept and the survivors sit at it."""
    s = T.Simulation(until_t=0.002 * 0.9999, seed=5, capacity=65536,
                     device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, light.WeightWindowStep(w_lo=0.25, w_hi=4.0, w_target=1.0))
    s.add_photons(light.generate_photon_state(20000, E=1.0, w=0.05))
    _run(s)
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 1000.0, rtol=0.2)  # 5 sigma: ~0.14
    w = s.sim_state.w.numpy()[s.sim_state.alive.numpy()]
    np.testing.assert_allclose(w, 1.0, rtol=1e-6)


def test_weight_window_validation():
    with pytest.raises(ValueError):
        light.WeightWindowStep(w_lo=2.0, w_hi=1.0)
    with pytest.raises(TypeError):
        light.ImportanceSplitStep(importance=3.0)
    with pytest.raises(ValueError):
        light.ImportanceSplitStep(lambda x, y, z: 1.0, max_split=1)


def test_split_runs_generic_with_structured_refusal():
    s = _base(64, capacity=16384, T_end=0.002)
    s.add_step(2, light.ImportanceSplitStep(lambda x, y, z: 1.0))
    with pytest.warns(RuntimeWarning, match="unsupported-step"):
        s._run_impl()
    assert not s.used_fused
    rep = s.explain_plan()
    assert "ImportanceSplitStep" in rep and "refused [unsupported-step]" in rep


def test_split_copies_inherit_kinematics():
    s = _base(32, capacity=16384, T_end=0.004)
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: torch.where((x > C_CODE * DT * 1.5)
                                    & (x < C_CODE * DT * 2.5), 2.0, 1.0),
        roulette=False))
    _run(s)
    st = s.sim_state
    alive = st.alive.numpy()
    assert alive.sum() == 64
    np.testing.assert_allclose(st.r[0].numpy()[alive], 4 * C_CODE * DT,
                               rtol=1e-5)
    np.testing.assert_allclose(st.E.numpy()[alive], 1.0)


def test_at_validation():
    with pytest.raises(ValueError, match="at"):
        light.WeightWindowStep(0.5, 2.0, at="sometimes")


# -- at="chunk": between fused dispatches ---------------------------------------

def test_chunk_boundary_importance_split_keeps_fused():
    """The transport runs the fused twin; the split applies between
    dispatches against the last boundary's snapshot: each interior
    boundary doubles the population at w / 2."""
    K = 16
    s = T.Simulation(until_t=4 * K * DT * 0.9999, seed=0, capacity=65536,
                     chunk_steps=K, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ImportanceSplitStep(_doubling(K), roulette=False,
                                            at="chunk"))
    s.add_photons(light.generate_photon_state(512, E=1.0))
    _run(s)
    assert s.used_fused, s.explain_plan()
    assert "chunk-boundary population control" in s.explain_plan()
    wsum, n = _wsum(s)
    assert n == 512 * 2 ** 3  # after chunks 1..3, none after the last
    np.testing.assert_allclose(wsum, 512.0, rtol=1e-5)


def test_chunk_boundary_window_keeps_fused():
    K = 8
    s = T.Simulation(until_t=3 * K * DT * 0.9999, seed=2, capacity=65536,
                     chunk_steps=K, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(np.double(0.0), np.double(0.0)))
    s.add_step(3, light.WeightWindowStep(0.25, 4.0, w_target=1.0,
                                         max_split=16, at="chunk"))
    s.add_photons(light.generate_photon_state(100, E=1.0, w=32.0))
    _run(s)
    assert s.used_fused, s.explain_plan()
    wsum, n = _wsum(s)
    np.testing.assert_allclose(wsum, 3200.0, rtol=1e-4)
    w = s.sim_state.w.numpy()[s.sim_state.alive.numpy()]
    assert n == 1600 and np.all(w == 2.0)


def test_chunk_boundary_matches_per_step_on_smooth_importance():
    """For a ballistic beam the boundary ratio telescopes: the same total
    weight, and chunk mode lags per-step mode by the last crossing."""
    K = 8
    pops = {}
    for at in ("step", "chunk"):
        s = T.Simulation(until_t=3 * K * DT * 0.9999, seed=4,
                         capacity=65536, chunk_steps=K, device="cpu")
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ImportanceSplitStep(_doubling(K), roulette=False,
                                                at=at))
        s.add_photons(light.generate_photon_state(256, E=1.0))
        if at == "chunk":
            _run(s)
        else:
            with pytest.warns(RuntimeWarning, match="unsupported-step"):
                s._run_impl()
        assert s.used_fused == (at == "chunk")
        pops[at] = _wsum(s)
    assert pops["step"][0] == pytest.approx(256.0, rel=1e-5)
    assert pops["chunk"][0] == pytest.approx(256.0, rel=1e-5)
    assert pops["step"][1] == 256 * 2 ** 3
    assert pops["chunk"][1] == 256 * 2 ** 2


def test_no_boundary_pass_after_final_iteration_host_exact():
    """Host-exact mode (chunk 1): the exit is checked before maintenance,
    so no boundary pass runs after the final iteration."""
    K = 5
    s = T.Simulation(
        exit=lambda c: c.t >= K * DT * 0.9999 and len(c.objects) > -1,
        seed=0, capacity=65536, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ImportanceSplitStep(_doubling(1), roulette=False,
                                            at="chunk"))
    s.add_photons(light.generate_photon_state(16, E=1.0))
    with pytest.warns(RuntimeWarning, match="host-exact"):
        s._run_impl()
    assert not s.used_fused and s.chunk_used == 1
    wsum, n = _wsum(s)
    assert n == 16 * 2 ** (K - 1)
    np.testing.assert_allclose(wsum, 16.0, rtol=1e-5)


def test_chunk_boundary_generic_matches_fused_population():
    """A t-exit on a chunk edge triggers no trailing boundary pass on
    either tier: the same population law."""
    K = 16
    pops = {}
    for fuse in ("auto", "off"):
        s = T.Simulation(until_t=3 * K * DT * 0.9999, seed=1,
                         capacity=65536, chunk_steps=K, fuse=fuse,
                         device="cpu")
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ImportanceSplitStep(_doubling(K), roulette=False,
                                                at="chunk"))
        s.add_photons(light.generate_photon_state(64, E=1.0))
        _run(s)
        assert s.used_fused == (fuse == "auto")
        pops[fuse] = _wsum(s)
    assert pops["auto"][1] == pops["off"][1] == 64 * 2 ** 2
    assert pops["auto"][0] == pytest.approx(64.0, rel=1e-5)
    assert pops["off"][0] == pytest.approx(64.0, rel=1e-5)


# -- the repair: recycling resets the boundary snapshots --------------------------

class _Watched(light.ImportanceSplitStep):
    """Notes, at every boundary pass, how many recycles the run has made
    and whether the snapshot was dropped."""

    def __init__(self, sim, *a, **k):
        super().__init__(*a, **k)
        self.sim, self.calls = sim, []

    def boundary_apply(self, state, ctx):
        n_recycles = sum(1 for e in self.sim.population_log
                         if e[0] == "recycle")
        self.calls.append((n_recycles, self._prev_r is None))
        return super().boundary_apply(state, ctx)


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_recycle_resets_the_boundary_snapshot(fuse):
    """An emitter fills the arena; photons die past x = 20.5 c dt; the
    importance doubles past x = 3.5 c dt, so a photon splits once, at the
    first boundary after it crossed. The engine recycles (compacts) several
    times: each time the boundary that follows re-snapshots (a snapshot kept
    across a compaction would compare a photon with whatever held its new
    slot before), every other boundary compares, and every weight stays 1
    or 1/2."""
    K = 8
    s = T.Simulation(until_t=48 * K * DT * 0.9999, seed=6, capacity=16384,
                     chunk_steps=K, fuse=fuse, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, light.PhotonEmitterStep(160, E=1.0))
    s.add_step(2, T.newton.NewtonianKinematicsStep())
    s.add_step(3, T.newton.AbsorbingBoundaryStep(
        ((-1.0, 20.5 * C_CODE * DT), (-1.0, 1.0), (-1.0, 1.0))))
    split = _Watched(s, lambda x, y, z: torch.where(
        x > 3.5 * C_CODE * DT, 2.0, 1.0), roulette=False, at="chunk")
    s.add_step(4, split)
    s.add_photons(light.generate_photon_state(16, E=1.0))
    _run(s) if fuse == "auto" else s._run_impl()
    assert s.used_fused == (fuse == "auto")
    recycles = [e for e in s.population_log if e[0] == "recycle"]
    assert len(recycles) >= 3, s.population_log
    # primed from the initial positions: the first pass compares
    prev = 0
    for n_rec, dropped in split.calls:
        assert dropped == (n_rec > prev), split.calls
        prev = n_rec
    assert sum(d for _, d in split.calls) == len(recycles)
    st = s.sim_state
    w = st.w.numpy()[st.alive.numpy()]
    x = st.r[0].numpy()[st.alive.numpy()]
    assert set(np.unique(w).tolist()) <= {1.0, 0.5}, np.unique(w)
    assert (w[x < 3.5 * C_CODE * DT] == 1.0).all()
    assert (w == 0.5).sum() > 500  # the split did run between recycles
