"""Recorded inverse CDFs and the wider plan tables on the fused tier.

``ScatterPhaseFunctionStep(cos_theta_icdf=<torch callable>)``: the prover
records the callable into an expression program over ``u``
(``ops/record.py:record_field``), which the kernel evaluates at the draw
where the table route reads its knots (its form library's straight-line
field function, ``ops/codegen.py:field_c``), clipped to [-1, 1] as the JAX
kernel clips it (``physicl_tpu/ops/fused.py:1023-1026``). Both packages run
the same ``Simulation`` (the JAX package's emulated chunk with the jnp
callable, the port's plain twin with the torch one): ``sim.ts`` is
byte-identical, every int record row and the ``alive`` plane are equal,
and the float32 planes agree within 1e-4 of each plane's largest value
(XLA's FMAs, amplified near cos theta = +-1: the HG/Rayleigh parity note of
``ROADMAP.md``). The same callable runs on the generic tier under
``fuse="off"``, where the first moment of one forced scatter holds on both
tiers within 5 sigma.

Plan tables sized for each plan: a plan past each of the first limits (17
ops, 9 fields, 65 instructions) and one past the later 32 ops, 32 crossing
planes, 16 fields and 256 expression instructions (40, 40, 20, a 600-term
string and a ``torch.where`` A(E)) fuse and match the JAX package the same
way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.ops import fields as FL
from physicl_tpu_torch.ops import record as RC

DT = 2.0 ** -10  # c dt is exact: no FMA drift in r + v * dt
TOL = 1e-4


def _linear(xp, a=0.6):
    """tests/test_phase.py's exact inverse CDF of (1 + a mu) / 2."""
    def icdf(u):
        disc = 1.0 - a * (2.0 - a - 4.0 * u)
        return (xp.sqrt(xp.maximum(disc, 0.0 * disc)) - 1.0) / a
    return icdf


def _hg(xp, g=0.7):
    """The Henyey-Greenstein inverse CDF, an integer power and divides."""
    def icdf(u):
        s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
        return (1.0 + g * g - s ** 2) / (2.0 * g)
    return icdf


def _powf(xp):
    """A forward-peaked law through a non-integer power (powf)."""
    def icdf(u):
        return 1.0 - 2.0 * u ** 1.7
    return icdf


_ICDF = {"linear": _linear, "hg": _hg, "powf": _powf}


def _sim(P, icdf, n=4096, k=32, seed=3, **kw):
    c = float(P.light.c)
    kw = dict(kw, device="cpu") if P is T else kw
    s = P.Simulation(until_t=k * DT * 0.9999, seed=seed, chunk_steps=16,
                     auto_shrink=False, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterPhaseFunctionStep(
        A=0.3 / (c * DT), n=1.0, cos_theta_icdf=icdf))
    s.add_step(3, P.light.ScatterDeleteStep(np.double(1.0),
                                            np.double(0.02 / (c * DT))))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(4, m)
    s.add_photons(P.light.generate_photon_state(n, E=1.0))
    return s, m


def _same_run(js, jm, ts, tm):
    assert js.used_fused and ts.used_fused, ts.explain_plan()
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) > 0
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    live = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), live)
    for name in ("r", "v", "dv", "E", "w"):
        want = np.asarray(getattr(js.sim_state, name))[..., live]
        got = getattr(ts.sim_state, name).numpy()[..., live]
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            assert float(np.abs(g - w).max(initial=0.0)) <= TOL * scale, name


@pytest.mark.parametrize("case", sorted(_ICDF))
def test_recorded_icdf_matches_jax(case):
    js, jm = _sim(J, _ICDF[case](jnp))
    js.start()
    js.join()
    ts, tm = _sim(T, _ICDF[case](torch))
    ts.start()
    ts.join()
    _same_run(js, jm, ts, tm)


def test_recorded_icdf_is_a_kernel_field():
    """The prover hands the kernel an expression field over u in place of
    the knot table: the plan's phase op points at it through fld[0]."""
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    s, _ = _sim(T, _hg(torch))
    state = s._init_run_state()
    steps = s._ordered_steps()
    for st in steps:
        st.setup(s)
    plan = try_build_fused(s, steps, state).plan
    op = next(o for o in plan.ops if o.kind == "phase")
    assert op.phase_knots is None and op.phase_fn.spec["vars"] == ("u",)
    assert plan.has_fields
    ps, _, _ = TF._plan_struct(plan, torch.device("cpu"))
    i = [o.kind for o in plan.ops].index("phase")
    assert ps.ops[i].fld[0] == 0 and ps.ops[i].fld[1] == -1
    shape, consts = FL.field_layout(op.phase_fn.spec)
    fd = ps.fields[0]
    assert (fd.kind, fd.shape, fd.off, fd.len) == (1, shape, 0, len(consts))
    assert list(ps.fk[:fd.len]) == consts
    assert RC.U_IPOW in [ins[0] for ins in op.phase_fn.spec["prog"].ins]


def _first_moment(P, fuse, icdf, n=1 << 14):
    """One forced scatter from +x: <v_x> / c is the sampled <cos theta>."""
    c = float(P.light.c)
    kw = {"device": "cpu", "fuse": fuse} if P is T else {}
    s = P.Simulation(until_t=DT * 0.9999, seed=0, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterPhaseFunctionStep(
        A=1.0 / (c * DT), n=1.0, cos_theta_icdf=icdf))
    s.add_photons(P.light.generate_photon_state(n, E=1.0))
    s.start()
    s.join()
    v = np.asarray(s.sim_state.v, np.float64)[:, :n]
    return s, v


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_exact_icdf_linear_phase_first_moment(fuse):
    """tests/test_phase.py's law on the port: p(mu) = (1 + a mu) / 2 has
    <mu> = a / 3, within 5 sigma; |v| = c. Fused (the plan's recorded
    program) and on the generic tier (the torch callable)."""
    a = 0.6
    s, v = _first_moment(T, fuse, _linear(torch, a))
    assert s.used_fused == (fuse == "auto")
    mu = v[0] / np.linalg.norm(v, axis=0)
    assert abs(mu.mean() - a / 3) < 5 * mu.std() / np.sqrt(mu.size)
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), float(T.light.c),
                               rtol=3e-5)


def test_fused_and_generic_agree():
    """The same plan on both tiers: the +x counts of every iteration and
    the survivors within 5 combined sigma."""
    rows = {}
    for fuse in ("auto", "off"):
        s, m = _sim(T, _hg(torch), n=8192, k=16, fuse=fuse)
        s.start()
        s.join()
        assert s.used_fused == (fuse == "auto")
        rows[fuse] = np.asarray(m.data, np.float64)
    a, b = rows["auto"], rows["off"]
    assert a.shape == b.shape
    for col in (1, 2, 3, 4):  # n, then the +x, +y, +z counts
        x, y = a[:, col].sum(), b[:, col].sum()
        assert abs(x - y) <= 5 * np.sqrt(x + y), (col, x, y)


# -- wider plan tables -------------------------------------------------------

def _wide(P):
    """17 ops, 9 distinct fields, 71 expression instructions."""
    c = float(P.light.c)
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=16 * DT * 0.9999, seed=4, chunk_steps=8,
                     auto_shrink=False, **kw)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             P.newton.NewtonianKinematicsStep()]
    for k in range(8):
        steps.append(P.light.ScatterIsotropicStep(
            A=0.02 / (c * DT), variable_n=True,
            variable_n_fn=f"1.0 + 0.25 * cos(r{k % 3}[gid] * {k + 1}e-6)"))
    steps.append(P.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.01 / (c * DT)),
        A_fn="pow(E[gid], -1.5) * 0.5 + 0.5"))
    for g in (0.1, 0.3, 0.5, 0.7, -0.2, -0.4):
        steps.append(P.light.ScatterHenyeyGreensteinStep(
            A=0.02 / (c * DT), n=1.0, g=g))
    m = P.light.ScatterSignMeasureStep(None, True)
    steps.append(m)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(8)
    s.add_photons(P.light.generate_photon_state(
        4096, E=rng.uniform(0.5, 2.0, 4096)))
    return s, m


def test_wide_plan_fuses_and_matches_jax():
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    ts, tm = _wide(T)
    state = ts._init_run_state()
    steps = ts._ordered_steps()
    for st in steps:
        st.setup(ts)
    plan = try_build_fused(ts, steps, state).plan
    specs, _ = TF.plan_fields(plan.ops)
    n_ins = sum(len(sp["prog"].ins) for sp in specs)
    assert len(plan.ops) >= 17 and len(specs) == 9 and n_ins >= 65
    # the kernel's Plan is sized for the plan: its ops, no crossing plane,
    # its fields and their constants
    ps = TF._plan_struct(plan, torch.device("cpu"))[0]
    n_k = sum(len(FL.field_layout(sp)[1]) for sp in specs)
    assert type(ps).dims == (len(plan.ops), 1, 9, n_k)
    ts, tm = _wide(T)
    ts.start()
    ts.join()
    js, jm = _wide(J)
    js.start()
    js.join()
    _same_run(js, jm, ts, tm)


# -- a plan past the later caps ------------------------------------------------

def _past_caps(P, xp, n=4096):
    """40 ops, 40 crossing planes, 20 distinct fields: kin; 17 iso with
    string densities (one of them ``past_caps_expr``); a del with a string
    n(r) and a ``where`` A(E); 17 hg, one with a string n(r); a rayl; two
    crossing tallies of 20 planes each; a sign."""
    c = float(P.light.c)
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=16 * DT * 0.9999, seed=6, chunk_steps=8,
                     auto_shrink=False, **kw)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             P.newton.NewtonianKinematicsStep()]
    for k in range(17):
        n_r = (cs.past_caps_expr() if k == 0 else
               f"1.0 + 0.25 * cos(r{k % 3}[gid] * {k + 1}e-6)")
        steps.append(P.light.ScatterIsotropicStep(
            A=0.01 / (c * DT), variable_n=True, variable_n_fn=n_r))
    steps.append(P.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.01 / (c * DT)), variable_n=True,
        variable_n_fn="1.0 + 0.5 * sin(r2[gid] * 1e-6)",
        A_fn=lambda E: xp.where(E > 1.0, E, 1.0)))
    for k in range(17):
        if k == 0:
            steps.append(P.light.ScatterHenyeyGreensteinStep(
                A=0.01 / (c * DT), g=0.3, variable_n=True,
                variable_n_fn="fmax(0.5, 1.0 - r0[gid] * 1e-8)"))
        else:
            steps.append(P.light.ScatterHenyeyGreensteinStep(
                A=0.01 / (c * DT), n=1.0, g=0.05 * k - 0.4))
    steps.append(P.light.ScatterRayleighStep(A=0.01 / (c * DT), n=1.0))
    tallies = []
    for axis in (0, 1):
        locs = []
        for j in range(20):
            loc = [np.nan] * 3
            loc[axis] = (j - 9.5) * 0.4 * c * DT
            locs.append(tuple(loc))
        tallies.append(P.light.ScatterMeasureStep(None, True, locs))
    steps += tallies
    m = P.light.ScatterSignMeasureStep(None, True)
    steps.append(m)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(9)
    s.add_photons(P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n),
        r=rng.uniform(-3, 3, (3, n)) * c * DT))
    return s, m, tallies


def test_past_caps_plan_fuses_and_matches_jax():
    """A plan past the kernel's former 32 ops, 32 crossing planes, 16
    fields and 256 expression instructions over 16 stack levels, with a
    recorded ``torch.where``: the prover fuses it (a Plan sized for it) and
    it matches the JAX package: sim.ts, the sign rows and every plane's
    count row equal, the planes within 1e-4 of each plane's max."""
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    ts, tm, tt = _past_caps(T, torch)
    state = ts._init_run_state()
    steps = ts._ordered_steps()
    for st in steps:
        st.setup(ts)
    plan = try_build_fused(ts, steps, state).plan
    specs, _ = TF.plan_fields(plan.ops)
    n_ax = sum(len(op.axes) for op in plan.ops)
    longest = max(len(sp["prog"].ins) for sp in specs)
    assert (len(plan.ops), n_ax, len(specs)) == (40, 40, 20)
    assert 560 <= longest <= 700, longest
    where = next(op.a_fn for op in plan.ops if op.a_fn is not None)
    assert RC.U_SEL in [ins[0] for ins in where.spec["prog"].ins]
    ts.start()
    ts.join()
    js, jm, jt = _past_caps(J, jnp)
    js.start()
    js.join()
    _same_run(js, jm, ts, tm)
    for a, b in zip(tt, jt):
        assert len(a.data) == len(b.data) > 0
        for x, y in zip(a.data, b.data):
            np.testing.assert_array_equal(np.asarray(x, np.float64),
                                          np.asarray(y, np.float64))
