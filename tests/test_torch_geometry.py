"""The remaining geometry: the PyTorch port against the JAX package on the
CPU.

``state.mod_floor`` is bitwise equal to the JAX package's. The twin of the
CUDA kernel (``fused_chunk_reference``) and the JAX package's emulated
chunk agree on the ``reflect``, ``periodic``, ``sabsorb`` and ``scross``
ops: int records exactly, float records within 3e-5 (two float32
reductions in different orders), positions (and the ``dr`` a reflection
derives from them) within one ulp of the plane's largest value per
iteration, every other plane within rtol 1e-6 + 1e-6 * max|plane|. XLA's
CPU backend contracts ``r + v * dt`` and the sine polynomial into FMAs and
the twin does not, so positions drift by ulps; photons start away from
the walls and the sphere radii are off the c dt lattice, so that no fold
or crossing decision sits on a rounding tie that the drift could flip.

Whole ``Simulation`` runs with each new step give byte-identical
``sim.ts`` and equal ``data`` rows on both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu.ops import fused as JF
from physicl_tpu.state import mod_floor as j_mod_floor
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.state import mod_floor as t_mod_floor

C_LIGHT = 299792458.0
DT = 2.0 ** -10  # c dt is exact: no FMA drift in r + v * dt
C_DT = C_LIGHT * DT
L_BOX = 64 * C_DT
CAP = 2 * 16384
CHUNK = 64
K_ACT = 50
SEED = 2024


# -- mod_floor ---------------------------------------------------------------

@pytest.mark.parametrize("L", [1.0, 3.0, L_BOX, 2 * L_BOX, 0.1],
                         ids=["1", "3", "box", "2box", "0.1"])
def test_mod_floor_bitwise_equal_to_jax(L):
    L32 = np.float32(L)
    edges = [-0.0, 0.0, L32, -L32, 2 * L32, -2 * L32, 3 * L32, -7 * L32,
             np.nextafter(np.float32(0), np.float32(-1)),
             np.float32(-1e-7) * L32, np.float32(-1e-3) * L32,
             np.nextafter(L32, np.float32(0)),
             np.nextafter(L32, np.float32(2 * L32)),
             np.nextafter(-L32, np.float32(0)),
             np.nextafter(2 * L32, np.float32(0)),
             np.float32(0.5) * L32, np.float32(1e-30)]
    rng = np.random.default_rng(3)
    x = np.concatenate([np.asarray(edges, np.float32),
                        (rng.uniform(-5, 5, 4000) * L).astype(np.float32)])
    want = np.asarray(j_mod_floor(jnp.asarray(x), jnp.float32(L32)))
    got = t_mod_floor(torch.from_numpy(x),
                      torch.tensor(L32, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert ((got >= 0) & (got < L32)).all()


# -- the twin against the JAX emulated chunk ---------------------------------

def _packed(seed, C=CAP, lo=0.1, hi=0.9):
    rng = np.random.default_rng(seed)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.uniform(lo, hi, (3, C)) * L_BOX
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * C_LIGHT
    p[12] = rng.uniform(0.5, 2.0, C)
    p[13] = rng.uniform(size=C) < 0.9
    p[14] = rng.uniform(0.2, 1.0, C)
    return p


def _sched():
    s = np.zeros((5, CHUNK), np.float32)
    s[0] = DT
    return s


_BOX = ((0.0, L_BOX),) * 3
_MID = 0.5 * L_BOX
# op kind -> keyword arguments, shared by both packages' _Op
_OPS = {
    "kin": {},
    "iso": dict(coef=0.08 / C_DT, c_val=C_LIGHT),
    "del": dict(coef=0.01 / C_DT),
    "reflect": dict(bounds=_BOX),
    "periodic": dict(bounds=_BOX),
    "scross-w": dict(sphere=(_MID, _MID, _MID, 0.31 * L_BOX), cols=(1, 0),
                     weighted=True),
    "sabsorb-in": dict(sphere=(_MID, _MID, _MID, 0.113 * L_BOX),
                       inside=True),
    "sabsorb": dict(sphere=(_MID, _MID, _MID, 0.437 * L_BOX)),
    "scross": dict(sphere=(_MID, _MID, _MID, 0.383 * L_BOX), cols=(1, 2)),
}
_PLANS = {
    "kin-iso-reflect": ("kin", "iso", "reflect"),
    "kin-iso-periodic": ("kin", "iso", "periodic"),
    "kin-iso-del-scross_w-sabsorb_in": ("kin", "iso", "del", "scross-w",
                                        "sabsorb-in"),
    "kin-sabsorb-scross": ("kin", "sabsorb", "scross"),
}


def _plans(names, const_norm=True):
    jops, tops = [], []
    for name in names:
        kind = name.split("-")[0]
        jops.append(JF._Op(kind, **_OPS[name]))
        tops.append(TF._Op(kind, **_OPS[name]))
    speed = C_LIGHT if const_norm else None
    jplan = JF.FusedPlan(ops=jops, n_rec_cols=3, chunk=CHUNK, tile_rows=128,
                         interpret=True, const_norm_speed=speed,
                         packed_angles=True, fast_trig=True)
    tplan = TF.FusedPlan(ops=tops, n_rec_cols=3, chunk=CHUNK,
                         const_norm_speed=speed, n_frec_cols=1)
    return jplan, tplan


def _assert_planes_close(got, want, k, alive):
    """Live slots: r within k ulp of max|r| (k iterations), dr within twice
    that (a reflection derives it from two positions), the rest within
    rtol 1e-6 + 1e-6 * max|plane|."""
    got, want = got[:, alive], want[:, alive]
    r_tol = k * np.spacing(np.float32(np.abs(want[0:3]).max()))
    for p in range(15):
        scale = np.abs(want[p]).max()
        tol = (r_tol if p < 3 else 2 * r_tol if p < 6
               else 1e-6 * np.abs(want[p]) + 1e-6 * scale)
        bad = np.abs(got[p] - want[p]) > tol
        assert not bad.any(), f"plane {p}: {bad.sum()} slots off"


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_twin_matches_jax_emulated_chunk(name):
    jplan, tplan = _plans(_PLANS[name])
    packed = _packed(7)
    run = JF._build_emulated_chunk(jplan, CAP)
    j_out, j_rec, j_recf = jax.device_get(run(
        jnp.asarray(packed), _sched(), np.zeros((1, CHUNK), np.int32), SEED,
        K_ACT))
    t_out, t_rec, t_recf = TF.fused_chunk_reference(
        torch.from_numpy(packed), torch.from_numpy(_sched()), SEED, K_ACT,
        tplan)
    np.testing.assert_array_equal(t_rec.numpy(), j_rec)
    np.testing.assert_allclose(t_recf.numpy(), j_recf, rtol=3e-5, atol=0)
    alive = j_out[13] > 0
    np.testing.assert_array_equal(t_out.numpy()[13], j_out[13])
    _assert_planes_close(t_out.numpy(), j_out, K_ACT, alive)
    if "reflect" in name or "periodic" in name:
        r = t_out.numpy()[0:3, alive]
        assert (r >= 0).all() and (r <= L_BOX).all()
    if "reflect" in name:  # walls were hit: some velocities flipped
        assert (np.sign(t_out.numpy()[6:9]) != np.sign(packed[6:9])).any()
    if "scross" in name:
        col = 0 if "scross_w" in name else 2
        recs = t_recf.numpy() if "scross_w" in name else t_rec.numpy()
        assert recs[:K_ACT, col].sum() > 0
    if "sabsorb" in name:
        assert j_rec[K_ACT - 1, 0] < j_rec[0, 0]


# -- whole runs ----------------------------------------------------------------

_CASES = {
    # steps after kinematics and isotropic scattering
    "reflect": ("reflect", "sign"),
    "periodic": ("periodic", "sign"),
    "escape-sphere": ("shell", "sphere"),
    "absorber-weighted": ("del", "shell-w", "sphere-in", "sign"),
}


def _build(P, case, **kw):
    s = P.Simulation(until_t=79.5 * DT, seed=21, chunk_steps=32, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.08 / C_DT, n=1.0))
    meas = {}
    for i, name in enumerate(_CASES[case], start=3):
        if name == "reflect":
            step = P.newton.ReflectingBoundaryStep(_BOX)
        elif name == "periodic":
            step = P.newton.PeriodicBoundaryStep(_BOX)
        elif name == "del":
            step = P.light.ScatterDeleteStep(1.0, 0.01 / C_DT)
        elif name.startswith("shell"):
            w = name == "shell-w"
            step = meas[name] = P.light.SphericalShellMeasureStep(
                None, radius=(0.31 if w else 0.383) * L_BOX,
                center=(_MID,) * 3, weighted=w)
        elif name.startswith("sphere"):
            inside = name == "sphere-in"
            step = P.newton.AbsorbingSphereStep(
                (0.113 if inside else 0.437) * L_BOX, center=(_MID,) * 3,
                kill_inside=inside)
        else:
            step = meas["sign"] = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(i, step)
    rng = np.random.default_rng(5)
    n = 3000
    r = rng.uniform(0.15, 0.85, (3, n)) * L_BOX
    d = rng.normal(size=(3, n))
    v = d / np.linalg.norm(d, axis=0) * float(P.light.c)
    E = rng.uniform(1.0, 2.0, n)
    s.add_photons(P.light.generate_photon_state(n, E=E, v=v, r=r))
    return s, meas


@pytest.fixture(scope="module", params=sorted(_CASES))
def geometry_run(request):
    case = request.param
    js, jm = _build(J, case)
    ts, tm = _build(T, case, device="cpu")
    for s in (js, ts):
        s.start()
        s.join()
    return case, js, jm, ts, tm


def test_geometry_runs_fused_ts_and_rows_equal(geometry_run):
    case, js, jm, ts, tm = geometry_run
    assert js.used_fused and ts.used_fused
    text = ts.explain_plan()
    assert "execution mode: fused" in text and "refused" not in text
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    for name, step in tm.items():
        got, want = np.asarray(step.data), np.asarray(jm[name].data)
        assert got.shape == want.shape and got.shape[0] == len(ts.ts)
        if name == "shell-w":  # t, n exact; the weight sum is a float
            np.testing.assert_array_equal(got[:, :2], want[:, :2])
            np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=3e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=case)


def test_geometry_final_state_close(geometry_run):
    case, js, _, ts, _ = geometry_run
    alive = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), alive)
    got = TF.pack_state(ts.sim_state).numpy()
    want = np.asarray(JF.pack_state(js.sim_state))
    _assert_planes_close(got, want, len(ts.ts), alive)


def test_geometry_case_behaviour(geometry_run):
    """What each case is there to show, on the port's own run."""
    case, _, _, ts, tm = geometry_run
    st = ts.sim_state
    r = st.r.numpy()[:, st.alive.numpy()]
    if case in ("reflect", "periodic"):
        assert len(ts.objects) == 3000
        assert (r >= 0).all() and (r <= L_BOX).all()
    if case == "escape-sphere":
        d = np.linalg.norm(r - _MID, axis=0)
        assert (d <= 0.437 * L_BOX).all() and len(ts.objects) < 3000
        assert np.asarray(tm["shell"].data)[:, 2].sum() > 0
    if case == "absorber-weighted":
        d = np.linalg.norm(r - _MID, axis=0)
        assert (d > 0.113 * L_BOX).all()
        assert np.asarray(tm["shell-w"].data)[:, 2].sum() > 0


# -- the const-norm rule, validation ------------------------------------------

@pytest.mark.parametrize("order,const_norm", [
    (("kin", "reflect", "iso"), False),
    (("kin", "iso", "reflect"), True),
    (("kin", "periodic", "iso"), True),
], ids=["reflect-before-iso", "reflect-after-iso", "periodic-before-iso"])
def test_const_norm_rule_follows_reflections(order, const_norm):
    """A reflection between kinematics and a scatter op folds dr, so |dr|
    is no longer c dt there: both provers then drop the const-norm path."""
    from physicl_tpu.ops.pipeline import try_build_fused as j_build
    from physicl_tpu_torch.ops.pipeline import try_build_fused as t_build

    for P, build, kw in ((J, j_build, {}), (T, t_build, {"device": "cpu"})):
        s = P.Simulation(until_t=0.01, seed=0, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        for i, kind in enumerate(order, start=1):
            s.add_step(i, {
                "kin": lambda: P.newton.NewtonianKinematicsStep(),
                "iso": lambda: P.light.ScatterIsotropicStep(A=1e-3, n=1e-3),
                "reflect": lambda: P.newton.ReflectingBoundaryStep(_BOX),
                "periodic": lambda: P.newton.PeriodicBoundaryStep(_BOX),
            }[kind]())
        s.add_photons(P.light.generate_photon_state(
            100, E=1.0, r=(_MID, _MID, _MID)))
        steps = s._ordered_steps()
        for st in steps:
            st.setup(s)
        provider = build(s, steps, s._init_run_state())
        assert (provider.plan.const_norm_speed is not None) == const_norm


def test_step_validation_matches_jax():
    for P in (J, T):
        with pytest.raises(ValueError, match="radius must be positive"):
            P.newton.AbsorbingSphereStep(0.0)
        with pytest.raises(ValueError, match="radius must be positive"):
            P.light.SphericalShellMeasureStep(None, radius=-1.0)
        step = P.newton.AbsorbingSphereStep(2.0, center=[1, 2, 3],
                                            kill_inside=1)
        assert step.center == (1.0, 2.0, 3.0) and step.kill_inside is True


def test_sim_bounds_default_for_boxes():
    """``bounds=None`` takes ``sim.bounds`` (a box [0, b] per axis)."""
    for kind, x_end in (("Reflecting", 0.1), ("Periodic", 1.6)):
        s = T.Simulation(until_t=2.5 * DT, seed=0, device="cpu")
        s.bounds = np.array([1.7, 2.5, 3.5]) * C_DT
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, getattr(T.newton, f"{kind}BoundaryStep")())
        s.add_photons(T.light.generate_photon_state(
            10, E=1.0, r=(0.3 * C_DT, 0.5 * C_DT, 0.5 * C_DT)))
        s.start()
        s.join()
        # three steps of c dt along +x from 0.3 c dt in a 1.7 c dt box: a
        # reflection at 2.3 folds to 1.1 and turns back; a wrap lands at 0.6
        assert len(s.ts) == 3
        np.testing.assert_allclose(s.sim_state.r[0, :10].numpy(),
                                   x_end * C_DT, rtol=1e-5)
        assert ((s.sim_state.v[0, :10] < 0).all()
                == (kind == "Reflecting"))
