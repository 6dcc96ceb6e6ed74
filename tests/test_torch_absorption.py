"""The exponential transform, fluorescence and the refractive interface: the
PyTorch port against the JAX package on the CPU.

``ScatterDeleteStep(stretch=, fluorescence=)`` validates and normalises its
options as the JAX constructor does (the same ``ValueError`` messages, the
same stored tuples). One chunk per op form, the twin against the JAX
emulated chunk at dt = 2**-10 (``tests/test_torch_scatter.py``'s
harness): int records and the alive plane equal, the deposition tally
within rtol 3e-5, live planes within 1e-5 times each plane's largest value
(at most 3.4e-6 measured, the interface's remainder arithmetic under XLA's
FMAs), positions also within one ulp of the largest |r| per iteration and
dr two (dr = r' - r0 after a crossing). Photons start a fraction of c dt off the interface, so no crossing
sits on a rounding tie.

Whole ``Simulation`` runs (an absorbing slab under the exponential
transform, Fe K-alpha fluorescence, a glass slab, the tissue plan kin ->
fresnel -> hg -> implicit capture -> absorbing box -> plane tally, and an
interface with ``match_speed``) give byte-identical ``sim.ts``, equal int
rows and float rows within rtol 3e-5. Physics on the twin: the Fresnel
reflectance and total internal reflection, the weighted transmission of
the exponential transform against Beer-Lambert, and the two-rate closed
form of fluorescence with line self-absorption.
"""

import numpy as np
import pytest
import torch

import physicl_tpu as J
import physicl_tpu.light as JL
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light as TL
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu.ops import fused as JF
from physicl_tpu_torch.ops import fused as TF

from test_torch_scatter import (C_DT, C_LIGHT, DT, L_BOX, _packed, _plans,
                                assert_chunks_close, assert_planes_close,
                                run_chunk_pair)

LOC = 0.5 * L_BOX + 0.37 * C_DT  # the interface, off the c dt lattice


# -- ScatterDeleteStep's options -------------------------------------------------

_BAD = {
    "stretch-zero": dict(stretch=0.0),
    "stretch-one": dict(stretch=1.0),
    "stretch-dir-zero": dict(stretch=0.5, stretch_dir=(0.0, 0.0, 0.0)),
    "stretch-dir-shape": dict(stretch=0.5, stretch_dir=(1.0, 0.0)),
    "stretch-capture": dict(stretch=0.5, implicit_capture=True),
    "fluor-yield": dict(fluorescence=(0.0, 1.0)),
    "fluor-yield-high": dict(fluorescence=(1.5, 1.0)),
    "fluor-energy": dict(fluorescence=(0.5, -1.0)),
    "fluor-edge-below": dict(fluorescence=(0.5, 1.0), fluorescence_edge=0.5),
    "fluor-capture": dict(fluorescence=(0.5, 1.0), implicit_capture=True),
    "fluor-stretch": dict(fluorescence=(0.5, 1.0), stretch=0.5),
    "edge-alone": dict(fluorescence_edge=1.0),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_delete_step_validation_matches_jax(case):
    with pytest.raises(ValueError) as ej:
        JL.ScatterDeleteStep(1.0, 1.0, **_BAD[case])
    with pytest.raises(ValueError) as et:
        TL.ScatterDeleteStep(1.0, 1.0, **_BAD[case])
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [
    dict(stretch=0.7),
    dict(stretch=0.3, stretch_dir=(1.0, 2.0, -2.0)),
    dict(fluorescence=(0.34, 6.4)),
    dict(fluorescence=(1.0, 6.4), fluorescence_edge=7.11),
], ids=["stretch", "stretch-dir", "fluor", "fluor-edge"])
def test_delete_step_stores_what_jax_stores(kw):
    j, t = JL.ScatterDeleteStep(1.0, 2.0, **kw), TL.ScatterDeleteStep(
        1.0, 2.0, **kw)
    assert t.stretch == j.stretch and t.fluorescence == j.fluorescence
    assert t._c == j._c and t._coef == j._coef
    if t.stretch:
        assert abs(np.linalg.norm(t.stretch[1:]) - 1.0) < 1e-12


# -- the twin against the JAX emulated chunk -------------------------------------

_CASES = {
    "fresnel-z": ("fresnel", dict(c_val=C_LIGHT,
                                  iface=(2, LOC, 1.0, 1.5, False)), True),
    "fresnel-x-glass-air": ("fresnel", dict(
        c_val=C_LIGHT, iface=(0, LOC, 1.5, 1.0, False)), True),
    "fresnel-match": ("fresnel", dict(c_val=C_LIGHT,
                                      iface=(1, LOC, 1.0, 1.33, True)),
                      False),
    "del-stretch-dep": ("del", dict(coef=0.05 / C_DT,
                                    stretch=(0.7, 0.6, 0.0, 0.8),
                                    cols=(0,)), True),
    "del-fluor-dep": ("del", dict(coef=0.05 / C_DT, fluor=(0.5, 0.9, 1.2),
                                  c_val=C_LIGHT, cols=(0,)), True),
    "del-fluor-yield-1": ("del", dict(coef=0.1 / C_DT, fluor=(1.0, 0.6, 0.6),
                                      c_val=C_LIGHT), True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_twin_matches_jax_emulated_chunk(case):
    kind, kw, const_norm = _CASES[case]
    jplan, tplan = _plans(kind, kw, {}, {}, const_norm=const_norm)
    if kind == "fresnel":  # scatter first: photons cross at every angle
        for plan, mod in ((jplan, JF), (tplan, TF)):
            plan.ops.insert(1, mod._Op("iso", coef=0.1 / C_DT,
                                       c_val=C_LIGHT))
    packed = _packed(11)
    want, got = run_chunk_pair(jplan, tplan, packed)
    assert_chunks_close(want, got, 1e-5)
    out = got[0]
    alive = out[13] > 0
    if kind == "fresnel":
        axis = kw["iface"][0]
        speed = np.linalg.norm(out[6:9, alive].astype(np.float64), axis=0)
        if kw["iface"][4]:  # c / n on each side after a crossing
            assert (np.abs(speed / (C_LIGHT / 1.33) - 1) < 1e-5).any()
        else:
            np.testing.assert_allclose(speed, C_LIGHT, rtol=3e-6)
        moved = (out[axis] != packed[axis]) & alive
        assert moved.any()
    elif "fluor" in case:
        E_f = kw["fluor"][1]
        assert ((out[12] == np.float32(E_f)) & alive).sum() > 50
    else:  # survivors carry likelihood ratios around 1
        w = out[14, alive] / packed[14, alive]
        assert (w > 1).any() and (w < 1).any()


# -- whole runs ----------------------------------------------------------------------

def _photons(P, n, seed, lo=0.1, hi=0.9, v=None):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)) if v is None else np.asarray(v)
    return P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n),
        v=d / np.linalg.norm(d, axis=0) * float(P.light.c),
        r=rng.uniform(lo, hi, (3, n)) * L_BOX)


def _build(P, case, **kw):
    s = P.Simulation(until_t=59.5 * DT, seed=41, chunk_steps=32, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    meas = {}
    if case == "stretch":
        meas["dep"] = P.light.ScatterDeleteStep(
            1.0, 0.05 / C_DT, stretch=0.6, stretch_dir=(1.0, 1.0, 0.0),
            measure_deposition=True)
        s.add_step(2, meas["dep"])
        meas["sign"] = P.light.ScatterSignMeasureStep(None, True,
                                                      weighted=True)
        s.add_step(3, meas["sign"])
    elif case == "fluorescence":
        s.add_step(2, P.light.ScatterIsotropicStep(A=0.05 / C_DT, n=1.0))
        meas["dep"] = P.light.ScatterDeleteStep(
            1.0, 0.02 / C_DT, A_fn="(2.0 / E[gid])**3",
            fluorescence=(0.34, 0.64), fluorescence_edge=0.711,
            measure_deposition=True)
        s.add_step(3, meas["dep"])
        meas["sign"] = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(4, meas["sign"])
    elif case in ("glass", "match"):
        match = case == "match"
        s.add_step(2, P.light.ScatterIsotropicStep(A=0.05 / C_DT, n=1.0))
        s.add_step(3, P.light.RefractiveInterfaceStep(
            LOC, 1.0, 1.5, axis=0, match_speed=match))
        s.add_step(4, P.light.RefractiveInterfaceStep(
            LOC + 9.3 * C_DT, 1.5, 1.0, axis=0, match_speed=match))
        meas["cross"] = P.light.ScatterMeasureStep(
            None, True, [(LOC + 20.1 * C_DT, np.nan, np.nan),
                         (LOC - 10.1 * C_DT, np.nan, np.nan)])
        s.add_step(5, meas["cross"])
    else:  # tissue: a refractive surface over a scattering absorber
        s.add_step(2, P.light.RefractiveInterfaceStep(LOC, 1.0, 1.4, axis=2))
        s.add_step(3, P.light.ScatterHenyeyGreensteinStep(
            A=0.1 / C_DT, n=1.0, g=0.9))
        meas["dep"] = P.light.ScatterDeleteStep(
            1.0, 0.01 / C_DT, implicit_capture=True,
            measure_deposition=True)
        s.add_step(4, meas["dep"])
        s.add_step(5, P.newton.AbsorbingBoundaryStep(
            ((0.0, L_BOX),) * 3))
        meas["cross"] = P.light.ScatterMeasureStep(
            None, True, [(np.nan, np.nan, LOC - 5.1 * C_DT)], weighted=True,
            measure_E=True, measure_E_mode="sum")
        s.add_step(6, meas["cross"])
    s.add_photons(_photons(P, 3000, 7))
    return s, meas


@pytest.fixture(scope="module",
                params=["stretch", "fluorescence", "glass", "match",
                        "tissue"])
def absorption_run(request):
    case = request.param
    js, jm = _build(J, case)
    ts, tm = _build(T, case, device="cpu")
    for s in (js, ts):
        s.start()
        s.join()
    return case, js, jm, ts, tm


def test_runs_fused_ts_and_rows_equal(absorption_run):
    case, js, jm, ts, tm = absorption_run
    assert js.used_fused and ts.used_fused
    text = ts.explain_plan()
    assert "execution mode: fused" in text
    assert ("const-norm |dr| = c*dt: on" in text) == (
        case in ("stretch", "fluorescence"))
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    for name, step in tm.items():
        got, want = np.asarray(step.data), np.asarray(jm[name].data)
        assert got.shape == want.shape and got.shape[0] == len(ts.ts) == 60
        floats = (name == "dep" or (name == "sign" and case == "stretch")
                  or (name == "cross" and case == "tissue"))
        if floats:  # t (and n) exact; sums of float32 terms
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=3e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=case)


def test_final_state_close(absorption_run):
    case, js, _, ts, _ = absorption_run
    alive = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), alive)
    rtol = 2e-4 if case == "tissue" else 1e-5  # hg at g = 0.9
    assert_planes_close(TF.pack_state(ts.sim_state).numpy(),
                        np.asarray(JF.pack_state(js.sim_state)), rtol,
                        len(ts.ts))


def test_case_behaviour(absorption_run):
    """What each case is there to show, on the port's own run."""
    case, _, _, ts, tm = absorption_run
    st = ts.sim_state
    alive = st.alive.numpy()
    if case == "fluorescence":  # line photons die fast (A(E) ~ E^-3)
        E = st.E.numpy()[alive]
        assert (E == np.float32(0.64)).sum() > 0
    if case == "match":
        speed = np.linalg.norm(st.v.numpy()[:, alive].astype(np.float64),
                               axis=0)
        inside = ((st.r.numpy()[0, alive] > LOC)
                  & (st.r.numpy()[0, alive] < LOC + 9.3 * C_DT))
        assert inside.any()
        # photons that crossed into the glass since their last scatter
        # move at c / 1.5 there
        assert (np.abs(speed[inside] * 1.5 / C_LIGHT - 1) < 1e-5).any()
    if case in ("stretch", "tissue"):
        assert np.asarray(tm["dep"].data)[:, 1].sum() > 0


# -- physics on the twin ---------------------------------------------------------------

def _interface_pass(theta_deg, n1, n2, n=1 << 17, match=False):
    """Photons in medium n1 hit the plane x = LOC at theta once: the
    reflected share, and the packed state after."""
    th = np.deg2rad(theta_deg)
    p = np.zeros((15, n), np.float32)
    p[0] = LOC - 0.5 * np.cos(th) * C_DT
    p[1] = 0.5 * L_BOX
    p[6] = np.cos(th) * C_LIGHT
    p[7] = np.sin(th) * C_LIGHT
    p[12], p[13], p[14] = 1.0, 1.0, 1.0
    plan = TF.FusedPlan(ops=[
        TF._Op("kin"), TF._Op("fresnel", c_val=C_LIGHT,
                              iface=(0, LOC, n1, n2, match))],
        n_rec_cols=1, chunk=1, const_norm_speed=None if match else C_LIGHT)
    s = np.zeros((5, 1), np.float32)
    s[0] = DT
    out, _, _ = TF.fused_chunk_reference(torch.from_numpy(p),
                                         torch.from_numpy(s), 13, 1, plan)
    out = out.numpy()
    return (out[6] < 0).mean(), out


def _fresnel_R(theta_deg, n1, n2):
    ci = np.cos(np.deg2rad(theta_deg))
    st2 = (n1 / n2) ** 2 * (1 - ci ** 2)
    if st2 > 1:
        return 1.0
    ct = np.sqrt(1 - st2)
    rs = (n1 * ci - n2 * ct) / (n1 * ci + n2 * ct)
    rp = (n1 * ct - n2 * ci) / (n1 * ct + n2 * ci)
    return 0.5 * (rs * rs + rp * rp)


@pytest.mark.parametrize("theta,n1,n2", [(45.0, 1.0, 1.5), (30.0, 1.5, 1.0),
                                         (0.0, 1.0, 1.33), (70.0, 1.0, 1.5)])
def test_fresnel_reflectance(theta, n1, n2):
    refl, out = _interface_pass(theta, n1, n2)
    R = _fresnel_R(theta, n1, n2)
    n = out.shape[1]
    assert abs(refl - R) < 5 * np.sqrt(R * (1 - R) / n) + 1e-6
    # Snell: the transmitted photons bend to n1 sin_i = n2 sin_t
    t = out[6] > 0
    sin_t = out[7, t] / np.linalg.norm(out[6:9, t], axis=0)
    np.testing.assert_allclose(sin_t, n1 / n2 * np.sin(np.deg2rad(theta)),
                               atol=2e-6)


def test_total_internal_reflection():
    refl, out = _interface_pass(60.0, 1.5, 1.0)  # beyond 41.8 degrees
    assert refl == 1.0
    assert (out[0] < LOC).all()  # every photon retraced back into the glass


def test_match_speed_sets_c_over_n():
    _, out = _interface_pass(20.0, 1.0, 1.5, match=True)
    speed = np.linalg.norm(out[6:9].astype(np.float64), axis=0)
    t = out[6] > 0
    np.testing.assert_allclose(speed[t], C_LIGHT / 1.5, rtol=1e-6)
    np.testing.assert_allclose(speed[~t], C_LIGHT, rtol=1e-6)


def _beam(plan, n, k, seed):
    p = np.zeros((15, n), np.float32)
    p[6] = C_LIGHT
    p[12], p[13], p[14] = 1.0, 1.0, 1.0
    s = np.zeros((5, k), np.float32)
    s[0] = DT
    return TF.fused_chunk_reference(torch.from_numpy(p), torch.from_numpy(s),
                                    seed, k, plan)


def test_exponential_transform_is_unbiased():
    """A +x beam through a pure absorber with the transform along +x: the
    weighted transmission equals Beer-Lambert N (1 - p)^k within 5 sigma of
    its own variance, while far fewer photons die than analog."""
    n, k, p = 1 << 16, 64, 0.02
    plan = TF.FusedPlan(ops=[
        TF._Op("kin"), TF._Op("del", coef=p / C_DT,
                              stretch=(0.7, 1.0, 0.0, 0.0), cols=(0,)),
        TF._Op("sign", cols=(1, 1), weighted=True)],
        n_rec_cols=2, chunk=k, const_norm_speed=C_LIGHT, n_frec_cols=4)
    out, rec, rec_f = _beam(plan, n, k, 3)
    W = rec_f[:k, 1].double().numpy()
    pb = p * 0.3
    steps = np.arange(1, k + 1)
    mean = n * (1 - p) ** steps
    # E[w^2] per photon: survive (1 - pb)^k carrying ((1-p)/(1-pb))^k
    var = n * ((1 - p) ** (2 * steps) / (1 - pb) ** steps
               - (1 - p) ** (2 * steps))
    assert (np.abs(W - mean) <= 5 * np.sqrt(var)).all()
    assert rec[k - 1, 1] > n * (1 - pb) ** k * 0.95  # survivors, unweighted
    # deposits (w E p / p' per kill) plus the in-flight weight are the
    # beam's energy in expectation (0.63% off measured on this seed)
    total = rec_f[:k, 0].double().sum() + out[14][out[13] > 0].double().sum()
    assert abs(float(total) / n - 1) < 0.02


def test_fluorescence_two_rate_closed_form():
    """Fe K-alpha with line self-absorption (examples/make_fluorescence_nb
    .py, scaled): the source and line populations follow N (1 - pA)^k and
    N pA Y ((1 - pA)^k - (1 - pB)^k) / (pB - pA); deposits and the energy
    in flight add up to the beam's energy."""
    n, k = 1 << 17, 40
    E0, E_ka, E_edge, Y, P20 = 20.0, 6.40, 7.11, 0.34, 0.004
    plan = TF.FusedPlan(ops=[
        TF._Op("kin"),
        TF._Op("del", coef=P20 / C_DT, c_val=C_LIGHT,
               a_fn=TL._compile_field_expr("(20.0 / E[gid])**3", ("E",),
                                           "A_fn"),
               fluor=(Y, E_ka, E_edge), cols=(0,))],
        n_rec_cols=1, chunk=k, const_norm_speed=C_LIGHT, n_frec_cols=1)
    p = np.zeros((15, n), np.float32)
    p[6] = C_LIGHT
    p[12], p[13], p[14] = E0, 1.0, 1.0
    s = np.zeros((5, k), np.float32)
    s[0] = DT
    out, rec, rec_f = TF.fused_chunk_reference(
        torch.from_numpy(p), torch.from_numpy(s), 17, k, plan)
    alive = out[13].numpy() > 0
    E = out[12].numpy()
    pA, pB = P20, P20 * (E0 / E_ka) ** 3
    nA = n * (1 - pA) ** k
    nB = n * pA * Y * ((1 - pA) ** k - (1 - pB) ** k) / (pB - pA)
    gotA = (alive & (E == np.float32(E0))).sum()
    gotB = (alive & (E == np.float32(E_ka))).sum()
    assert abs(gotA - nA) < 5 * np.sqrt(nA)
    assert abs(gotB - nB) < 5 * np.sqrt(nB)
    budget = (float(rec_f[:k, 0].double().sum())
              + float(out[12][out[13] > 0].double().sum())) / (n * E0)
    assert abs(budget - 1) < 1e-4
