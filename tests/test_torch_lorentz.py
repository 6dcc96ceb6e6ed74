"""Charged particles and mixed populations: the PyTorch port against the JAX
package on the CPU (``LorentzForceStep``, ``ChargedObject``, the extras
planes and the otype gate of a mixed photon/charged population).

Both packages run the same ``Simulation`` (same seed, steps and initial
particles) through their fused tiers: the JAX package's emulated chunk, the
port's plain twin of its CUDA kernel. The Boris push draws nothing and the
photon ops draw from the same counter hash, so ``sim.ts`` is byte-identical,
every int record row and the ``alive`` and ``otype`` planes are equal, and
the float32 planes agree within 1e-5 of each plane's largest value (XLA's
CPU backend contracts the push's multiply-adds into FMAs; the twin, like
the kernel, rounds each product). The JAX side runs with
``auto_shrink=False`` on both sides (a shrink would reorder the slots
the final planes are compared by).

The rest holds the invariants of ``tests/test_lorentz.py`` on the twin, the
refusals, and the extras planes of ``SimState`` against the JAX package's.
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
from physicl_tpu.ops import fused as JF
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.ops.pipeline import FusedRefusal

DT = 1e-3
RTOL = 1e-5
C_LIGHT = 299792458.0


def _charged(P, n, seed, per_particle=False, speed=1.0):
    """n charged objects with seeded positions and velocities (components
    ~ N(0, speed)); with ``per_particle`` each carries its own q and m
    (ChargedObject)."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(3, n)) * 0.01
    v = rng.normal(size=(3, n)) * speed
    q = rng.choice([-2.0, -1.0, 1.0, 3.0], n)
    m = rng.uniform(0.5, 2.0, n)
    out = []
    for i in range(n):
        kw = dict(r=P.Measurement(r[:, i], "m**1"),
                  v=P.Measurement(v[:, i], "m**1 s**-1"))
        out.append(P.newton.ChargedObject(q=q[i], m=m[i], **kw)
                   if per_particle else P.Object(**kw))
    return out


def _photons(P, n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    return P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n), r=rng.normal(size=(3, n)) * 1e3,
        v=d / np.linalg.norm(d, axis=0) * float(P.light.c))


def _build(P, case):
    """(sim, sign step) of one case on package P."""
    c = float(P.light.c)
    N, L = P.newton, P.light
    kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
    k = 48
    if case == "varying-dt":
        s = P.Simulation(until_t=0.02, seed=2, **kw)
    else:
        s = P.Simulation(until_t=DT * k * 0.9999, seed=5, chunk_steps=32,
                         **kw)
    sign = L.ScatterSignMeasureStep(None, True)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT))]
    if case == "species-EB":
        steps += [N.LorentzForceStep(E_field=(0.5, -0.2, 0.1),
                                     B_field=(0.3, -0.1, 40.0),
                                     q_over_m=-1.5),
                  N.NewtonianKinematicsStep(),
                  N.ReflectingBoundaryStep(((-0.5, 0.5),) * 3), sign]
        s.add_particles(N.generate_particle_state(
            3000, v=np.random.default_rng(1).normal(size=(3, 3000)),
            r=np.random.default_rng(2).normal(size=(3, 3000)) * 0.01))
    elif case == "per-particle-B":
        steps += [N.LorentzForceStep(B_field=(0.0, 0.0, 200.0)),
                  N.NewtonianKinematicsStep(), sign]
        for o in _charged(P, 300, 3, per_particle=True) + [P.Object(
                v=P.Measurement([5.0, 0, 0], "m**1 s**-1"))]:
            s.add_obj(o)
    elif case == "photon-noop":
        steps += [N.LorentzForceStep(E_field=(1e6, 0, 0),
                                     B_field=(0, 0, 1e4), q_over_m=1e8),
                  N.NewtonianKinematicsStep(),
                  L.ScatterIsotropicStep(A=0.02 / (c * DT), n=1.0), sign]
        s.add_photons(_photons(P, 2000, 4))
    elif case == "varying-dt":
        # [Lorentz, UpdateTime, Kin]: the push takes the dt before the
        # update (schedule row 4)
        steps = [N.LorentzForceStep(E_field=(2.0, 0, 0),
                                    B_field=(0.0, 0.0, 30.0), q_over_m=1.0),
                 P.UpdateTimeStep(lambda x: 1e-3 * (1.0 + 200.0 * x.t)),
                 N.NewtonianKinematicsStep(), sign]
        for o in _charged(P, 200, 6):
            s.add_obj(o)
    elif case in ("mixed", "mixed-qm"):
        steps += [N.LorentzForceStep(B_field=(0, 0, 200.0),
                                     q_over_m=None if case == "mixed-qm"
                                     else 1.0),
                  N.NewtonianKinematicsStep(),
                  L.ScatterIsotropicStep(A=0.02 / (c * DT), n=1.0),
                  L.ScatterDeleteStep(np.double(0.01 / (c * DT)),
                                      np.double(1.0)), sign]
        s.add_photons(_photons(P, 2000, 7))
        # charges at ~c / 3: ungated, scattering and absorption would
        # reach them
        for o in _charged(P, 200, 8, per_particle=case == "mixed-qm",
                          speed=1e8):
            s.add_obj(o)
    elif case == "emitter-on-charged":
        # an emitter turns a charged population mixed: its photons scatter
        # and die, the charges gyrate
        steps += [L.PhotonEmitterStep(40, E=1.0, isotropic=True),
                  N.LorentzForceStep(E_field=(0.0, 1.0, 0.0),
                                     B_field=(0, 0, 100.0), q_over_m=2.0),
                  N.NewtonianKinematicsStep(),
                  L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  L.ScatterDeleteStep(np.double(0.02 / (c * DT)),
                                      np.double(1.0)), sign]
        for o in _charged(P, 500, 9, speed=1e8):
            s.add_obj(o)
    else:
        raise KeyError(case)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    return s, sign


_CASES = ("species-EB", "per-particle-B", "photon-noop", "varying-dt",
          "mixed", "mixed-qm", "emitter-on-charged")


@pytest.fixture(scope="module", params=_CASES)
def runs(request):
    out = []
    for P in (J, T):
        s, sign = _build(P, request.param)
        s.start()
        s.join()
        out.append((s, sign))
    return request.param, out


def test_lorentz_runs_fused_on_both(runs):
    _, ((js, _), (ts, _)) = runs
    assert js.used_fused and ts.used_fused, ts.explain_plan()


def test_lorentz_ts_and_records_equal(runs):
    _, ((js, jm), (ts, tm)) = runs
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) > 0
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)


def test_lorentz_alive_otype_spawn_equal(runs):
    _, ((js, _), (ts, _)) = runs
    jst, tst = js.sim_state, ts.sim_state
    for name in ("alive", "otype", "n_spawned"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


@pytest.mark.parametrize("field", ["r", "v", "dv", "E", "w"])
def test_lorentz_planes_close(runs, field):
    """Live slots (dead ones keep drifting under kinematics, unread)."""
    _, ((js, _), (ts, _)) = runs
    live = np.asarray(js.sim_state.alive)
    want = np.asarray(jax.device_get(getattr(js.sim_state, field)))
    got = getattr(ts.sim_state, field).numpy()
    want, got = want[..., live], got[..., live]
    # dv = v_new - v rounds at the scale of v, not of the small difference
    ref = (np.asarray(jax.device_get(js.sim_state.v))[..., live]
           if field == "dv" else want)
    for w, g, s in zip(np.atleast_2d(want), np.atleast_2d(got),
                       np.atleast_2d(ref)):
        scale = max(float(np.abs(s).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= RTOL * scale, field


def test_lorentz_case_behaviour(runs):
    """What each case is there to show, on the port's own run."""
    case, (_, (ts, tm)) = runs
    st = ts.sim_state
    v, otype, alive = st.v.numpy(), st.otype.numpy(), st.alive.numpy()
    charged = (otype != 1) & alive
    plan = ts.explain_plan()
    if case == "photon-noop":
        assert "population species: photon" in plan
        assert "const-norm |dr| = c*dt: off" in plan  # lorentz turns it off
        np.testing.assert_allclose(np.linalg.norm(v[:, alive], axis=0),
                                   C_LIGHT, rtol=1e-6)
    elif case == "mixed-qm":
        assert "15 core + otype + qm" in plan
    elif case == "mixed":
        assert "15 core + otype" in plan and "qm" not in plan.split(
            "packed per-particle planes")[1].splitlines()[0]
    elif case == "per-particle-B":
        assert "15 core + qm" in plan
        # the plain Object (last slot) has q = m = 0: never pushed
        np.testing.assert_array_equal(v[:, 300], [5.0, 0.0, 0.0])
    elif case == "emitter-on-charged":
        assert "mixed (otype-plane dispatch)" in plan
        assert int((otype[:500] != 1).sum()) == 500  # charges stay charges
        assert int(((otype == 1) & alive).sum()) > 0   # photons were emitted
        assert int(charged.sum()) == 500               # no charge died
    if case in ("mixed", "mixed-qm"):
        assert int(charged.sum()) == 200  # the del op spares the charges
    if case in ("mixed", "per-particle-B", "mixed-qm"):
        # pure B: every charge (the objects, in the first slots) keeps its
        # speed
        v0 = np.linalg.norm(np.asarray(
            [np.asarray(o.v, np.float64) for o in ts._pending_objects]).T,
            axis=0)
        got = np.linalg.norm(v[:, :len(v0)].astype(np.float64), axis=0)
        np.testing.assert_allclose(got, v0, rtol=3e-5)


# -- recorded fields ----------------------------------------------------------

def _mirror(xp, L=2.0, B0=100.0):
    """examples/make_lorentz_nb.py's axial magnetic mirror."""
    def mirror_B(rx, ry, rz):
        fac = B0 / (L * L)
        return (-fac * rx * rz, -fac * ry * rz, B0 * (1.0 + (rz / L) ** 2))
    return mirror_B


def _crossed(xp):
    """E and B both callable; a Python-number component and a 0 * x one."""
    def E(rx, ry, rz):
        return (2.0 * xp.cos(rx * 3.0), 0.5, 0 * rz)

    def B(rx, ry, rz):
        return (ry * 0.5, 1.0 + 0 * rx, 30.0 / (1.0 + rz * rz))
    return {"E_field": E, "B_field": B}


def _field_sim(P, case):
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=DT * 64 * 0.9999, seed=1, chunk_steps=32,
                     auto_shrink=False, **kw)
    xp = torch if P is T else jax.numpy
    fields = ({"B_field": _mirror(xp)} if case == "mirror"
              else _crossed(xp))
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.LorentzForceStep(q_over_m=1.0, **fields))
    s.add_step(2, P.newton.NewtonianKinematicsStep())
    rng = np.random.default_rng(0)
    s.add_particles(P.newton.generate_particle_state(
        2000, v=rng.normal(size=(3, 2000)),
        r=rng.normal(size=(3, 2000)) * 0.1))
    return s


@pytest.mark.parametrize("case", ["mirror", "E-and-B"])
def test_recorded_fields_match_jax(case):
    """A callable E / B is recorded, one program of three outputs, and
    evaluated at the particle's position: the port's twin against the JAX
    package's emulated chunk with the jnp callables, as the constant-field
    cases above; in the mirror's pure B field the push keeps |v|."""
    runs = []
    for P in (J, T):
        s = _field_sim(P, case)
        s.start()
        s.join()
        assert s.used_fused, s.explain_plan()
        runs.append(s)
    js, ts = runs
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    for name in ("r", "v"):
        want = np.asarray(jax.device_get(getattr(js.sim_state, name)))
        got = getattr(ts.sim_state, name).numpy()
        for w, g in zip(want, got):
            assert float(np.abs(g - w).max()) <= RTOL * float(
                np.abs(w).max()), name
    if case == "mirror":
        v0 = np.linalg.norm(np.random.default_rng(0).normal(size=(3, 2000)),
                            axis=0)
        v = ts.sim_state.v.numpy()[:, :2000].astype(np.float64)
        np.testing.assert_allclose(np.linalg.norm(v, axis=0), v0, rtol=3e-5)


def test_record_field_three_components():
    """record_field(ncomp=3): one program with three outputs (the callable
    traced once); a Python number is a constant output, 0 * x stays the
    product (exact as JAX computes it, NaN included); the program's plain
    run equals the callable; the mirror's shared subexpressions are
    computed once."""
    from physicl_tpu_torch.ops import record as RC

    E = _crossed(torch)["E_field"]
    fn = RC.record_field(E, ("r0", "r1", "r2"), "E_field", ncomp=3)
    prog = fn.spec["prog"]
    assert fn.spec["n_out"] == 3
    assert [ins[4] for ins in prog.ins if ins[0] == RC.U_ST] == [0, 1, 2]
    const = {ins[1]: ins[4] for ins in prog.ins if ins[0] == RC.U_CONST}
    st = {ins[4]: ins[2] for ins in prog.ins if ins[0] == RC.U_ST}
    assert const[st[1]] == 0.5
    codes = [ins[0] for ins in prog.ins]
    assert codes.count(RC.U_COS) == 1 and RC.U_MUL in codes
    x = [torch.from_numpy(np.random.default_rng(i).normal(size=64).astype(
        np.float32)) for i in range(3)]
    for got, want in zip(fn(*x), E(*x)):
        torch.testing.assert_close(got.expand(64), torch.as_tensor(
            want, dtype=torch.float32).expand(64), rtol=0, atol=0)
    mirror = RC.record_field(_mirror(torch), ("r0", "r1", "r2"), "B",
                             ncomp=3)
    for got, want in zip(mirror(*x), _mirror(torch)(*x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the three components' loads are shared: one load of each variable
    assert [ins[0] for ins in mirror.spec["prog"].ins].count(RC.U_LD) == 3
    with pytest.raises(RC.Refused, match="2 components"):
        RC.record_field(lambda a, b, c: (a, b), ("r0", "r1", "r2"), "E",
                        ncomp=3)


# -- the state's extras ------------------------------------------------------

def _extras_population(P):
    objs = _charged(P, 5, 11, per_particle=True)
    objs.append(P.Object(spin=P.Measurement([0.0, 1.0, 2.0], "m**1"),
                         tag=7.5))
    bulk = P.newton.generate_particle_state(4, v=(1.0, 0.0, 0.0))
    bulk["extras"] = {"tag": np.arange(4.0) + 0.1,
                      "q": np.full(4, -1.0)}
    return objs, [bulk]


def test_from_population_extras_match_jax():
    """Scalars become (C,) planes and 3-vectors (3, C), objects' attributes
    first, then bulks' "extras", zero where a slot lacks one."""
    from physicl_tpu.state import SimState as JState
    from physicl_tpu_torch.state import SimState as TState

    jst = JState.from_population(*_extras_population(J))
    tst = TState.from_population(*_extras_population(T), device="cpu")
    assert list(tst.extras) == list(jst.extras) == ["q", "m", "spin", "tag"]
    for name, arr in jst.extras.items():
        got = tst.extras[name]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(arr),
                                      err_msg=name)


def test_from_numpy_carries_charges_and_packs_like_jax():
    """A JAX state with q/m extras crosses over by from_numpy, round-trips
    through to_numpy, and packs the otype and qm planes as the JAX package
    does, plane for plane."""
    from physicl_tpu.state import SimState as JState
    from physicl_tpu_torch.state import SimState as TState

    objs = _charged(J, 40, 12, per_particle=True) + [J.Object()]
    bulk = J.light.generate_photon_state(30, E=1.0)
    jst = JState.from_population(objs, [bulk])
    names = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t",
             "dt", "t_comp", "n_spawned")
    fields = jax.device_get({f: getattr(jst, f) for f in names})
    fields["extras"] = jax.device_get(dict(jst.extras))
    tst = TState.from_numpy(fields, device="cpu")
    back = tst.to_numpy()
    for name in ("q", "m"):
        np.testing.assert_array_equal(back["extras"][name],
                                      fields["extras"][name])
    extras = ("otype", "qm")
    got = TF.pack_state(tst, extras).numpy()
    want = np.asarray(JF.pack_state(jst, extras))
    assert got.shape == want.shape == (17, jst.capacity)
    for i in range(got.shape[0]):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"plane {i}")
    # q/m of the uncharged object and the photons is 0, not NaN
    assert got[16, 40] == 0.0 and got[16, 41] == 0.0


# -- refusals ----------------------------------------------------------------

_REFUSALS = {
    "lorentz-per-particle": (lambda: T.newton.LorentzForceStep(
        B_field=(0, 0, 1.0)), "objects"),
    # a callable that leaves torch cannot be recorded (a torch one fuses:
    # test_recorded_fields_match_jax)
    "field-fn-callable": (lambda: T.newton.LorentzForceStep(
        B_field=lambda rx, ry, rz: (0 * rx, 0 * rx,
                                    np.asarray(rx) * 0 + 1),
        q_over_m=1.0), "objects"),
    "photon-only-op": (lambda: T.light.ScatterIsotropicStep(A=0.001,
                                                            n=0.001),
                       "particles"),
    # the JAX prover fuses it ungated and scatters the particles
    "photon-only-op-phase": (lambda: T.light.ScatterPhaseFunctionStep(
        A=0.001, phase_table=T.light.mie_phase_table(5.0)[:2]),
        "particles"),
}


# case -> the refused plan's outcome now that a refusal the JAX prover
# shares falls back to the generic tier: it runs ("generic"), the generic
# tier lacks the step too ("refused"), or the generic step raises as the JAX
# package's does (an object without q and m gives the per-particle push
# nothing to read). An E/B callable the recorder cannot take is a limit of
# the port's kernel (the JAX kernel runs it): refused with no fallback; the
# generic tier, where fuse="off" asks for it, names the callable that left
# torch ("limit")
_OUTCOMES = {
    "lorentz-per-particle": (ValueError, "needs per-particle charge/mass"),
    "field-fn-callable": ("limit", TypeError,
                          "B_field callable .*<lambda> returned ndarray"),
    "photon-only-op": "generic",
    "photon-only-op-phase": "generic",
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_charged_plans_refuse(case):
    make, population = _REFUSALS[case]
    code = case.replace("-phase", "")

    def sim(fuse="auto"):
        s = T.Simulation(until_t=0.005, seed=0, device="cpu", fuse=fuse)
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, make())
        s.add_step(2, T.newton.NewtonianKinematicsStep())
        if population == "objects":
            s.add_obj(T.Object())
        else:
            s.add_particles(T.newton.generate_particle_state(10))
        return s

    s = sim()
    assert f"refused [{code}]" in s.explain_plan()
    outcome = _OUTCOMES[case]
    if outcome == "refused" or outcome[0] == "limit":
        with pytest.raises(FusedRefusal, match=code):
            s._run_impl()
        if outcome[0] == "limit":
            s = sim(fuse="off")
            with pytest.raises(outcome[1], match=outcome[2]):
                s._run_impl()
            assert not s.used_fused
        return
    with pytest.warns(RuntimeWarning, match=rf"refused \[{code}\]"):
        if outcome == "generic":
            s._run_impl()
            assert len(s.ts) == 5
        else:
            with pytest.raises(outcome[0], match=outcome[1]):
                s._run_impl()
    assert not s.used_fused


def test_lorentz_apply_names_the_generic_tier():
    """The generic tier's push: a Boris rotation keeps |v| to rounding, a
    +x charge in +z B turns toward -y, and a = dv / dt."""
    from physicl_tpu_torch.engine import StepContext

    state = T.SimState.from_population(
        [], [T.newton.generate_particle_state(4, v=(1.0, 0.0, 0.0))],
        device="cpu").replace(dt=torch.tensor(DT))
    step = T.newton.LorentzForceStep(B_field=(0.0, 0.0, 100.0),
                                     q_over_m=1.0)
    out = step.apply(state, StepContext(state.key, None))
    v = out.v[:, :4]
    np.testing.assert_allclose(torch.linalg.norm(v, dim=0).numpy(), 1.0,
                               rtol=1e-6)
    assert (v[1] < 0).all() and (out.v[:, 4:] == 0).all()
    np.testing.assert_allclose(out.a.numpy(), (out.dv / DT).numpy(),
                               rtol=1e-6)


# -- the invariants of tests/test_lorentz.py on the twin ---------------------

def _port(steps, objs, n_steps, bulk=None, **kw):
    s = T.Simulation(until_t=DT * n_steps * 0.9999, seed=0, device="cpu",
                     **kw)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    for i, st in enumerate(steps):
        s.add_step(1 + i, st)
    for o in objs:
        s.add_obj(o)
    if bulk is not None:
        s.add_particles(bulk)
    s.start()
    s.join()
    assert s.used_fused
    n = len(objs)
    return s, s.sim_state.r.numpy()[:, :n], s.sim_state.v.numpy()[:, :n]


def test_pure_E_accelerates_exactly():
    k = 50
    _, r, v = _port(
        [T.newton.LorentzForceStep(E_field=(3.0, 0.0, 0.0), q_over_m=2.0),
         T.newton.NewtonianKinematicsStep()], [T.Object()], k)
    np.testing.assert_allclose(v[0, 0], 2.0 * 3.0 * DT * k, rtol=1e-5)
    assert v[1, 0] == 0.0 and v[2, 0] == 0.0
    np.testing.assert_allclose(r[0, 0], 6.0 * DT * DT * k * (k + 1) / 2,
                               rtol=1e-5)


def test_gyro_orbit_speed_exact_and_phase():
    B0, qm, v0, k = 200.0, 1.0, 7.0, 500
    _, _, v = _port(
        [T.newton.LorentzForceStep(B_field=(0.0, 0.0, B0), q_over_m=qm),
         T.newton.NewtonianKinematicsStep()],
        [T.Object(v=T.Measurement([v0, 0, 0], "m**1 s**-1"))], k)
    np.testing.assert_allclose(np.linalg.norm(v[:, 0]), v0, rtol=2e-5)
    theta = 2.0 * np.arctan(0.5 * qm * B0 * DT)
    got = np.arctan2(v[1, 0], v[0, 0])
    np.testing.assert_allclose(np.exp(1j * got), np.exp(-1j * k * theta),
                               atol=2e-4)
    assert v[2, 0] == 0.0


def test_exb_drift():
    E0, B0, k = 4.0, 200.0, 4000
    _, r, _ = _port(
        [T.newton.LorentzForceStep(E_field=(E0, 0.0, 0.0),
                                   B_field=(0.0, 0.0, B0), q_over_m=1.0),
         T.newton.NewtonianKinematicsStep()], [T.Object()], k)
    np.testing.assert_allclose(r[:, 0] / (k * DT), [0.0, -E0 / B0, 0.0],
                               atol=0.02 * E0 / B0)


def test_per_particle_charge_sign_and_a_kept():
    """Opposite charges gyrate in opposite senses, an uncharged Object is
    not pushed, and ``state.a`` keeps its initial value (no a plane)."""
    B0, v0 = 200.0, 5.0
    vv = T.Measurement([v0, 0, 0], "m**1 s**-1")
    a0 = T.Measurement([1.0, 2.0, 3.0], "m**1 s**-2")
    s, _, v = _port(
        [T.newton.LorentzForceStep(B_field=(0.0, 0.0, B0)),
         T.newton.NewtonianKinematicsStep()],
        [T.newton.ChargedObject(q=1.0, m=1.0, v=vv, a=a0),
         T.newton.ChargedObject(q=-1.0, m=1.0, v=vv),
         T.Object(v=vv)], 100)
    assert v[1, 0] < -0.1 * v0 and v[1, 1] > 0.1 * v0
    np.testing.assert_allclose(v[1, 0], -v[1, 1], rtol=1e-5)
    np.testing.assert_allclose(v[:, 2], [v0, 0.0, 0.0], rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(v[:, :2], axis=0), v0,
                               rtol=2e-5)
    np.testing.assert_array_equal(s.sim_state.a.numpy()[:, 0], [1, 2, 3])


def test_photons_never_pushed():
    c = float(T.light.c)
    s = T.Simulation(until_t=0.005, seed=0, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.LorentzForceStep(E_field=(1e6, 0, 0),
                                            B_field=(0, 0, 1e3),
                                            q_over_m=1.0))
    s.add_step(2, T.newton.NewtonianKinematicsStep())
    s.add_obj(T.light.PhotonObject(E=np.double(1.0),
                                   v=np.array([c, 0, 0], np.double)))
    s.add_obj(T.Object())
    s.start()
    s.join()
    v = s.sim_state.v.numpy()[:, :2]
    np.testing.assert_allclose(v[:, 0], [c, 0.0, 0.0], rtol=1e-6)
    assert abs(v[0, 1]) > 0


def test_charged_object_validation():
    with pytest.raises(ValueError):
        T.newton.ChargedObject(q=1.0)
    with pytest.raises(ValueError):
        T.newton.ChargedObject(q=1.0, m=0.0)


def test_bad_field_vector_names_the_field():
    with pytest.raises(ValueError, match="B_field"):
        T.newton.LorentzForceStep(B_field=(1.0, 2.0), q_over_m=1.0)
    with pytest.raises(ValueError, match="E_field"):
        T.newton.LorentzForceStep(E_field="up", q_over_m=1.0)


def test_bulk_particles_all_equal_under_exb():
    """generate_particle_state: every particle starts alike, so every lane
    of the twin ends bitwise alike (the chip smoke's ExB gate, small)."""
    bulk = T.newton.generate_particle_state(1000, v=(1.0, 0.0, 0.0))
    s, _, _ = _port(
        [T.newton.LorentzForceStep(E_field=(4.0, 0, 0), B_field=(0, 0, 200.0),
                                   q_over_m=1.0),
         T.newton.NewtonianKinematicsStep()], [], 64, bulk=bulk)
    v = s.sim_state.v[:, :1000]
    assert bool((v == v[:, :1]).all()) and float(v[1, 0]) != 0.0
