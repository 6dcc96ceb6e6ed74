"""The scatter families, media, polarization and a mixed photon/charge
population on an 8-shard port mesh,
against the JAX package's 8-device mesh, on the fused tier.

Each case is a JAX mesh test (test_compton.py, test_fluorescence.py,
test_media.py, test_polarization.py, test_polarization_compton.py) run
through both packages from the same population: the shards draw what the
JAX package's shards draw, so the integer records and alive masks are
equal, the float planes agree within 1e-4 of their largest magnitude, and
each test's own physics law holds on the port's run.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the skipif condition reads it)

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu.polarization  # noqa: F401
from physicl_tpu.parallel import make_mesh as j_mesh

import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
import physicl_tpu_torch.polarization  # noqa: F401
from physicl_tpu_torch.parallel import make_mesh

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


def _sim(P, mesh=True, **kw):
    if P is T:
        kw.setdefault("device", "cpu")
    m = (j_mesh() if P is J else make_mesh(8, devices=["cpu"])) if mesh \
        else None
    s = P.Simulation(mesh=m, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    return s


def _run(s):
    s.start()
    s.join()
    assert s.used_fused
    return s


def _np(x, dtype=None):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x if dtype is None else x.astype(dtype)


def _close_to_max(got, want):
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert np.abs(got - want).max() <= 1e-4 * scale


def _match(js, ts, fields=("r", "v", "E", "w")):
    np.testing.assert_array_equal(_np(ts.sim_state.alive),
                                  _np(js.sim_state.alive))
    for f in fields:
        _close_to_max(_np(getattr(ts.sim_state, f)),
                      _np(getattr(js.sim_state, f)))


def test_compton_heating_reduces_globally():
    """The heating channel sums over every shard: the energy budget closes
    on the global population, and the mesh runs agree."""
    n = 131072
    runs = {}
    for P in (J, T):
        s = _sim(P, until_t=0.004, seed=2, capacity=n)
        comp = P.light.ScatterComptonStep(
            A=np.double(0.25 / (C * DT)), n=np.double(1.0), mec2=2.0,
            measure_deposition=True)
        s.add_step(2, comp)
        s.add_photons(P.light.generate_photon_state(n, E=1.0))
        runs[P] = (_run(s), comp)
    (js, jc), (ts, tc) = runs[J], runs[T]
    E = _np(ts.sim_state.E, np.float64)[:n]
    dep = np.array(tc.data, dtype=float)[:, 1]
    np.testing.assert_allclose(E.sum() + dep.sum(), float(n), rtol=1e-5)
    np.testing.assert_allclose(dep, np.array(jc.data, float)[:, 1],
                               rtol=1e-4)
    _match(js, ts)


def test_fluorescence_energy_budget_and_two_state():
    """Fluorescent re-emission on the mesh: the energy identity holds
    globally and the two-state populations follow the closed forms."""
    N, p, Y, k, E0 = 65536, 0.1, 0.6, 10, 2.0
    runs = {}
    for P in (J, T):
        s = _sim(P, until_t=k * DT, seed=2)
        dele = P.light.ScatterDeleteStep(
            np.double(1.0), np.double(p / (C * DT)),
            fluorescence=(Y, 1.0), fluorescence_edge=1.5,
            measure_deposition=True)
        s.add_step(2, dele)
        s.add_photons(P.light.generate_photon_state(N, E=E0))
        runs[P] = (_run(s), dele)
    (js, jd), (ts, td) = runs[J], runs[T]
    alive = _np(ts.sim_state.alive)
    E = _np(ts.sim_state.E, np.float64)
    deposited = float(np.array(td.data, dtype=float)[:, 1].sum())
    np.testing.assert_allclose(float(E[alive].sum()) + deposited, N * E0,
                               rtol=1e-4)
    n_src = int((alive & (E == E0)).sum())
    n_line = int((alive & (E == 1.0)).sum())
    np.testing.assert_allclose(n_src, N * (1 - p) ** k, rtol=0.05)
    np.testing.assert_allclose(n_line, N * Y * p * k * (1 - p) ** (k - 1),
                               rtol=0.05)
    _match(js, ts)


def test_voxel_density_on_mesh_matches_single_device():
    """A voxel medium on 8 shards gives the unsharded run's per-photon
    weights exactly, and the JAX mesh's to rounding."""
    c_dt = C * DT
    ii = np.arange(16, dtype=np.float32)
    grid = np.broadcast_to((1.0 + ii / 4.0)[:, None, None],
                           (16, 8, 8)).copy()
    ws = {}
    for P, mesh in ((J, True), (T, True), (T, False)):
        nfn = P.light.voxel_density(grid, origin=(0, 0, 0), spacing=c_dt)
        s = _sim(P, mesh=mesh, until_t=0.010 * 0.9999, seed=3,
                 capacity=16384 * (8 if mesh else 1))
        s.add_step(2, P.light.ScatterDeleteStep(
            np.double(1.0), np.double(0.05 / c_dt), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        s.add_photons(P.light.generate_photon_state(512, E=1.0))
        ws[P, mesh] = _np(_run(s).sim_state.w, np.float64)[:512]
    np.testing.assert_array_equal(ws[T, True], ws[T, False])
    np.testing.assert_allclose(ws[T, True], ws[J, True], rtol=1e-6)
    assert not np.allclose(ws[T, True], 1.0)


def test_polarized_rayleigh_shards_stokes_planes():
    """Stokes planes shard with the photons and are written back: the
    single-scatter law Q = (c^2 - 1) / (1 + c^2) holds on every shard."""
    a = np.sqrt(2.0 / (C * DT))  # pcoll = 2: every photon scatters
    n = 32768
    runs = {}
    for P in (J, T):
        s = _sim(P, exit=lambda c: c.t >= 0.001, seed=29)
        s.add_step(2, P.polarization.ScatterPolarizedRayleighStep(
            n=np.double(a), A=np.double(a)))
        s.add_photons(P.polarization.polarized_photon_state(n, E=1.0))
        runs[P] = _run(s)
    js, ts = runs[J], runs[T]
    st = _np(ts.sim_state.extras["stokes"], np.float64)
    v = _np(ts.sim_state.v, np.float64)
    alive = _np(ts.sim_state.alive)
    c = v[0, alive] / np.linalg.norm(v[:, alive], axis=0)
    np.testing.assert_allclose(st[0, alive], (c ** 2 - 1) / (1 + c ** 2),
                               atol=2e-5)
    _close_to_max(st, _np(js.sim_state.extras["stokes"]))
    _match(js, ts)


def test_polarized_compton_q_law_and_heating():
    """Polarized Compton on the mesh: the exact Q law holds for every
    shard's photons and the heating sum is global."""
    a = np.sqrt(2.0 / (C * DT))
    n = 32768
    runs = {}
    for P in (J, T):
        s = _sim(P, until_t=0.001, seed=23)
        step = P.polarization.ScatterPolarizedComptonStep(
            A=np.double(a), n=np.double(a), mec2=1.0,
            measure_deposition=True)
        s.add_step(2, step)
        s.add_photons(P.polarization.polarized_photon_state(
            n, E=1.0, stokes=(0.0, 0.0, 0.0)))
        runs[P] = (_run(s), step)
    (js, jstep), (ts, tstep) = runs[J], runs[T]
    st = _np(ts.sim_state.extras["stokes"], np.float64)[:, :n]
    v = _np(ts.sim_state.v, np.float64)[:, :n]
    E = _np(ts.sim_state.E, np.float64)[:n]
    cm = v[0] / np.linalg.norm(v, axis=0)
    sc = E < 1.0 - 1e-9
    eta = 1.0 / E[sc]
    kap = eta + 1.0 / eta
    s2 = 1.0 - cm[sc] ** 2
    np.testing.assert_allclose(st[0][sc], -s2 / (kap - s2), atol=1e-6)
    rows = np.array(tstep.data, dtype=float)
    np.testing.assert_allclose(rows[0, 1], (1.0 - E[sc]).sum(), rtol=2e-4)
    np.testing.assert_allclose(rows[:, 1], np.array(jstep.data, float)[:, 1],
                               rtol=1e-4)
    _match(js, ts)


@pytest.mark.parametrize("kind", ["hg", "rayl", "compton_thermal"])
def test_anisotropic_families_on_mesh(kind):
    """The anisotropic and thermal scatter ops shard like the rest of the
    family: each keeps its defining moment, and equals the JAX mesh."""
    n = 8 * 4096
    runs = {}
    for P in (J, T):
        s = _sim(P, until_t=0.001, seed=13)
        if kind == "hg":
            s.add_step(2, P.light.ScatterHenyeyGreensteinStep(A=1.0, n=1.0,
                                                              g=0.6))
        elif kind == "rayl":
            s.add_step(2, P.light.ScatterRayleighStep(A=1.0, n=1.0))
        else:
            s.add_step(2, P.light.ScatterComptonStep(
                A=0.3 / (C * DT), n=1.0, mec2=1e9, theta_e=0.01))
        s.add_photons(P.light.generate_photon_state(n, E=1.0))
        runs[P] = _run(s)
    js, ts = runs[J], runs[T]
    ct = _np(ts.sim_state.v)[0, :n] / C
    E = _np(ts.sim_state.E)[:n]
    if kind == "hg":
        assert abs(ct.mean() - 0.6) < 0.02
    elif kind == "rayl":
        assert abs((ct ** 2).mean() - 0.4) < 0.02
    else:
        scat = E != np.float32(1.0)
        assert 0.2 < scat.mean() < 0.4
        assert abs(E[scat].mean() - 1.04) < 0.01
    _match(js, ts)


def test_mixed_population_on_mesh():
    """A photon/charge population (the otype plane packed and gating the
    photon ops per particle) on the mesh, with an emitter adding photons
    across shard edges: the JAX mesh's records, alive masks and planes."""
    n = 8 * 2048
    rng = np.random.default_rng(17)
    v0 = rng.normal(size=(3, n))
    runs = {}
    for P in (J, T):
        s = _sim(P, until_t=0.012 * 0.9999, seed=6, capacity=8 * 16384,
                 chunk_steps=4)
        s.add_step(2, P.newton.LorentzForceStep(
            E_field=(0.5, 0.0, 0.0), B_field=(0.0, 0.0, 40.0),
            q_over_m=1.0))
        s.add_step(3, P.light.ScatterIsotropicStep(A=0.2 / (C * DT), n=1.0))
        s.add_step(4, P.light.ScatterDeleteStep(np.double(1.0),
                                                np.double(0.1 / (C * DT))))
        s.add_step(5, P.light.PhotonEmitterStep(5000, E=2.0))
        sign = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(6, sign)
        s.add_particles(P.newton.generate_particle_state(n, v=v0))
        s.add_photons(P.light.generate_photon_state(n, E=1.0))
        runs[P] = (_run(s), np.asarray(sign.data))
    (js, jd), (ts, td) = runs[J], runs[T]
    np.testing.assert_array_equal(td, jd)
    otype = _np(ts.sim_state.otype)
    alive = _np(ts.sim_state.alive)
    assert (alive & (otype == 0)).sum() == n  # no charge dies
    assert int(ts.sim_state.n_spawned) == 2 * n + 12 * 5000
    _match(js, ts)
