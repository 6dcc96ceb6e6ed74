"""Anisotropic and energy-changing scatter: the PyTorch port against the JAX
package on the CPU (Henyey-Greenstein, Rayleigh, tabulated Mie phase
functions, Compton off electrons at rest and thermal ones).

Helpers on the same inputs: the fast ``log2``/``exp2``/``-2 ln`` forms, the
fast Rayleigh root, the fast sigma_KN ratio, the tabulated inverse CDF and
the fast Box-Muller normals are bitwise equal to the JAX package's;
``mie_phase_table`` gives equal arrays and ``g``. XLA's CPU backend
contracts Horner chains and products into FMAs and the port does not, so
the Klein-Nishina sampler on the same draws differs on a few lanes by a
few ulp (eta, cos theta within rtol 2e-6, the accepted masks equal) and
the libm forms by their libraries' rounding (rtol 1e-5).

One chunk per op form, the twin (``fused_chunk_reference``) against the
JAX emulated chunk at dt = 2**-10 (``r + v dt`` exact): int records and
the alive plane equal, the heating tally within rtol 3e-5 (two float32
reductions), and live planes within ``rtol`` times each plane's largest
value (positions also within one ulp of the largest |r| per iteration, dr
two): 1e-4 for ``hg`` at g = 0.9 and ``rayl``, whose near-forward and
near-backward angles turn an ulp of drift in cos theta into a much larger
one in sin theta = sqrt(1 - cos^2) (5.9e-5 and 4.1e-5 measured), 1e-5 for
the rest (at most 2.1e-6 measured). No Kahn acceptance flipped on these
seeds: the scatter masks and every record are equal.

Whole ``Simulation`` runs with each new step give byte-identical
``sim.ts``, equal sign-count rows and heating rows within rtol 3e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import physicl_tpu as J
import physicl_tpu.light as JL
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light as TL
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu.ops import fused as JF
from physicl_tpu_torch.ops import fused as TF

C_LIGHT = 299792458.0
DT = 2.0 ** -10  # c dt is exact: no FMA drift in r + v * dt
C_DT = C_LIGHT * DT
L_BOX = 64 * C_DT
CAP = 16384
CHUNK = 32
K_ACT = 24
SEED = 77


def _np(x):
    return np.asarray(jax.device_get(x))


def _both(fj, ft, *arrays):
    """fj on jnp arrays, ft on torch tensors, both as numpy."""
    want = fj(*[jnp.asarray(a) for a in arrays])
    got = ft(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
    return got, want


# -- helpers -----------------------------------------------------------------

def _uniforms(n, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, n).astype(
        np.float32)


@pytest.mark.parametrize("name", ["log2", "exp2", "neg2log"])
def test_fast_math_bitwise_equal_to_jax(name):
    rng = np.random.default_rng(1)
    if name == "log2":
        x = np.concatenate([np.exp(rng.uniform(-80, 80, 20000)),
                            [2.0 ** -126, 1.0, 2.0, 3.0, 1e30]])
        fj, ft = JF._fast_log2, TF._fast_log2
    elif name == "exp2":
        x = np.concatenate([rng.uniform(-125, 126, 20000),
                            [-125.5, 0.0, 0.5, 1.0, 126.9]])
        fj, ft = JF._fast_exp2, TF._fast_exp2
    else:
        x = np.concatenate([rng.uniform(0, 1, 20000), 2.0 ** -rng.uniform(
            0, 32, 2000), [1.0, 2.0 ** -32, 1e-12]])
        fj, ft = JF._fast_neg2log, TF._fast_neg2log
    x = x.astype(np.float32)
    got, want = _both(fj, ft, x)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  _np(want).view(np.int32))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "libm"])
def test_kn_sigma_ratio_matches_jax(fast):
    rng = np.random.default_rng(2)
    a = np.concatenate([np.exp(rng.uniform(np.log(1e-5), np.log(1e4),
                                           20000)),
                        [0.0, 0.00999, 0.01, 0.4999, 0.5, 1.0, 2.73]])
    a = a.astype(np.float32)
    got, want = _both(lambda x: JL._kn_sigma_ratio(x, jnp.float32,
                                                   fast=fast),
                      lambda x: TL._kn_sigma_ratio(x, fast=fast), a)
    if fast:
        np.testing.assert_array_equal(got.numpy(), _np(want))
    else:  # libm's log against XLA's: 8.9e-7 measured near alpha = 0.54
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "libm"])
def test_rayleigh_cos_theta_matches_jax(fast):
    u = np.concatenate([_uniforms(20000, 3), [0.0, 0.25, 0.5, 0.75,
                                              0.99998474]]).astype(
        np.float32)
    got, want = _both(lambda x: JL._rayleigh_cos_theta(x, jnp.float32,
                                                       fast=fast),
                      lambda x: TL._rayleigh_cos_theta(x, fast=fast), u)
    if fast:
        np.testing.assert_array_equal(got.numpy(), _np(want))
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "libm"])
@pytest.mark.parametrize("span", [(1e-4, 1.0), (1.0, 2.5), (2.5, 500.0)],
                         ids=["kahn-low", "kahn", "koblinger"])
def test_kn_cos_eta_same_triples(span, fast):
    """Kahn's and Koblinger's samplers on the same draws: accepted masks
    equal, eta and cos theta within rtol 2e-6 (XLA's FMAs; few lanes)."""
    rng = np.random.default_rng(4)
    n = 20000
    alpha = np.exp(rng.uniform(*np.log(span), n)).astype(np.float32)
    triples = [tuple(_uniforms(n, 10 + 3 * i + j) for j in range(3))
               for i in range(12)]
    want = JL._kn_cos_eta(jnp.asarray(alpha),
                          [tuple(jnp.asarray(t) for t in tr)
                           for tr in triples], jnp.float32, fast=fast)
    got = TL._kn_cos_eta(torch.from_numpy(alpha),
                         [tuple(torch.from_numpy(t) for t in tr)
                          for tr in triples], fast=fast)
    cos_w, eta_w, ok_w = (_np(x) for x in want)
    cos_g, eta_g, ok_g = (x.numpy() for x in got)
    np.testing.assert_array_equal(ok_g, ok_w)
    np.testing.assert_allclose(eta_g, eta_w, rtol=2e-6)
    np.testing.assert_allclose(cos_g, cos_w, rtol=2e-6, atol=2e-6)
    assert ok_g.mean() > 0.99
    if span[0] >= 2.5:  # Koblinger: always accepted, eta in [1, 1 + 2a]
        assert ok_g.all() and (eta_g <= 1 + 2 * alpha + 1e-3).all()


def test_gauss3_fast_bitwise_and_thermal_scatter_close():
    """The fast Box-Muller normals are bitwise; one thermal scatter on the
    same uniforms agrees to rtol 1e-5 (the boosts' products and sums are
    FMA-contracted by XLA)."""
    n = 20000
    u4 = [np.clip(_uniforms(n, 20 + i), 1e-9, None) for i in range(4)]
    g_j = JL._gauss3_from_uniform(tuple(jnp.asarray(u) for u in u4),
                                  jnp.float32, fast_trig=True)
    g_t = TL._gauss3_from_uniform(tuple(torch.from_numpy(u) for u in u4),
                                  fast_trig=True)
    for a, b in zip(g_t, g_j):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    rng = np.random.default_rng(6)
    d = rng.normal(size=(3, n))
    nhat = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    E = rng.uniform(0.5, 2.0, n).astype(np.float32)
    triples = [tuple(_uniforms(n, 40 + 3 * i + j) for j in range(3))
               for i in range(12)]
    u_phi = _uniforms(n, 99)
    want = JL._ic_thermal_scatter(
        jnp.asarray(E), tuple(jnp.asarray(x) for x in nhat), 0.02, 0.01,
        tuple(jnp.asarray(u) for u in u4),
        lambda a: JL._kn_cos_eta(a, [tuple(jnp.asarray(t) for t in tr)
                                     for tr in triples], jnp.float32,
                                 fast=True),
        jnp.asarray(u_phi), jnp.float32, fast_trig=True)
    got = TL._ic_thermal_scatter(
        torch.from_numpy(E), tuple(torch.from_numpy(x) for x in nhat), 0.02,
        0.01, tuple(torch.from_numpy(u) for u in u4),
        lambda a: TL._kn_cos_eta(a, [tuple(torch.from_numpy(t) for t in tr)
                                     for tr in triples], fast=True),
        torch.from_numpy(u_phi), fast_trig=True)
    E_w, n_w, a_w, flux_w, ok_w = want
    E_g, n_g, a_g, flux_g, ok_g = got
    np.testing.assert_array_equal(ok_g.numpy(), _np(ok_w))
    for g_, w_ in ((E_g, E_w), (a_g, a_w), (flux_g, flux_w)):
        np.testing.assert_allclose(g_.numpy(), _np(w_), rtol=1e-5)
    for g_, w_ in zip(n_g, n_w):
        np.testing.assert_allclose(g_.numpy(), _np(w_), rtol=0, atol=1e-5)


@pytest.mark.parametrize("x,bins", [(5.0, 64), (0.3, 16), (12.0, 128)])
def test_mie_table_and_phase_knots_match_jax(x, bins):
    mu, pdf, g = JL.mie_phase_table(x)
    mu_t, pdf_t, g_t = TL.mie_phase_table(x)
    np.testing.assert_array_equal(mu_t, mu)
    np.testing.assert_array_equal(pdf_t, pdf)
    assert g_t == g
    icdf = JL._tabulated_cos_icdf(mu, pdf, bins)
    m0, dm = TL.phase_knots(mu, pdf, bins)
    u = np.concatenate([_uniforms(20000, 7), np.arange(bins) / bins,
                        [1.0 - 2.0 ** -16]]).astype(np.float32)
    got = TL.phase_icdf(torch.from_numpy(u), m0, dm).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _np(icdf(jnp.asarray(u))).view(np.int32))
    # the table's own first moment is its asymmetry parameter
    assert abs(float(np.mean(got[:20000])) - g) < 0.02


def test_phase_knots_validation_matches_jax():
    for bad in (([0.0], [1.0]), ([0.5, 0.2], [1.0, 1.0]),
                ([-1.0, 1.0], [-1.0, 1.0]), ([-1.0, 1.0], [0.0, 0.0])):
        with pytest.raises(ValueError) as ej:
            JL._tabulated_cos_icdf(*bad)
        with pytest.raises(ValueError) as et:
            TL.phase_knots(*bad)
        assert str(et.value) == str(ej.value)


# -- the twin against the JAX emulated chunk ---------------------------------

def _packed(seed, C=CAP):
    rng = np.random.default_rng(seed)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.uniform(0.1, 0.9, (3, C)) * L_BOX
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


_MIE = JL.mie_phase_table(5.0)
# case -> (op kind, shared keywords, JAX-only, port-only, plane rtol)
_CASES = {
    "hg": ("hg", dict(coef=0.3 / C_DT, c_val=C_LIGHT, g=0.9), {}, {}, 1e-4),
    "hg-backward": ("hg", dict(coef=0.3 / C_DT, c_val=C_LIGHT, g=-0.5), {},
                    {}, 1e-4),
    "hg-isotropic": ("hg", dict(coef=0.3 / C_DT, c_val=C_LIGHT), {}, {},
                     1e-5),
    "rayl": ("rayl", dict(coef=0.3 / C_DT, c_val=C_LIGHT), {}, {}, 1e-4),
    "rayl-wl": ("rayl", dict(coef=1.0, wl_base=(0.3 / C_DT) ** 0.25,
                             c_val=C_LIGHT), {}, {}, 1e-4),
    "phase-mie": ("phase", dict(coef=0.3 / C_DT, c_val=C_LIGHT),
                  {"custom_fn": JL._tabulated_cos_icdf(*_MIE[:2], 64)},
                  {"phase_knots": TL.phase_knots(*_MIE[:2], 64)}, 1e-5),
    "compton-kahn-kn-dep": ("compton", dict(
        coef=0.5 / C_DT, c_val=C_LIGHT, inv_mec2=1.0, kn_xsec=True,
        kn_tries=12, cols=(0,)), {}, {}, 1e-5),
    "compton-koblinger-dep": ("compton", dict(
        coef=0.5 / C_DT, c_val=C_LIGHT, inv_mec2=5.0, kn_tries=12,
        cols=(0,)), {}, {}, 1e-5),
    "compton-3-tries": ("compton", dict(
        coef=0.5 / C_DT, c_val=C_LIGHT, inv_mec2=0.7, kn_tries=3), {}, {},
        1e-5),
    "compton-thermal-kn-dep": ("compton", dict(
        coef=0.3 / C_DT, c_val=C_LIGHT, inv_mec2=1e-3, kn_tries=12,
        theta_e=0.01, kn_xsec=True, cols=(0,)), {}, {}, 1e-5),
}


def _plans(kind, kw, jkw, tkw, const_norm=True, extra=()):
    jops = [JF._Op("kin"), JF._Op(kind, **kw, **jkw),
            *[JF._Op(k, **a) for k, a in extra],
            JF._Op("sign", cols=(1, 2))]
    tops = [TF._Op("kin"), TF._Op(kind, **kw, **tkw),
            *[TF._Op(k, **a) for k, a in extra],
            TF._Op("sign", cols=(1, 2))]
    speed = C_LIGHT if const_norm else None
    jplan = JF.FusedPlan(ops=jops, n_rec_cols=5, chunk=CHUNK, tile_rows=128,
                         interpret=True, const_norm_speed=speed,
                         packed_angles=True, fast_trig=True)
    tplan = TF.FusedPlan(ops=tops, n_rec_cols=5, chunk=CHUNK,
                         const_norm_speed=speed, n_frec_cols=1)
    return jplan, tplan


def run_chunk_pair(jplan, tplan, packed, k_act=K_ACT):
    """Both chunks on the same inputs: (JAX out, rec, rec_f), (twin ...)."""
    run = JF._build_emulated_chunk(jplan, packed.shape[1])
    want = jax.device_get(run(jnp.asarray(packed), _sched(),
                              np.zeros((1, CHUNK), np.int32), SEED, k_act))
    got = TF.fused_chunk_reference(torch.from_numpy(packed),
                                   torch.from_numpy(_sched()), SEED, k_act,
                                   tplan)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def assert_planes_close(got, want, rtol, k):
    """Live planes within rtol of each plane's largest value; positions
    also within k ulp of the largest |r| and dr within 2k (an interface
    derives dr from two positions that XLA's FMAs round differently)."""
    alive = want[13] > 0
    got, want = got[:, alive], want[:, alive]
    ulp = np.spacing(np.float32(np.abs(want[0:3]).max()))
    for p in range(15):
        tol = rtol * np.abs(want[p]).max()
        tol += k * ulp if p < 3 else 2 * k * ulp if p < 6 else 0.0
        bad = np.abs(got[p] - want[p]) > tol
        assert not bad.any(), f"plane {p}: {bad.sum()} live slots off"


def assert_chunks_close(want, got, rtol, k_act=K_ACT):
    (j_out, j_rec, j_recf), (t_out, t_rec, t_recf) = want, got
    np.testing.assert_array_equal(t_rec, j_rec)
    np.testing.assert_array_equal(t_out[13], j_out[13])
    np.testing.assert_allclose(t_recf[:k_act, 0], j_recf[:k_act, 0],
                               rtol=3e-5, atol=0)
    assert_planes_close(t_out, j_out, rtol, k_act)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_twin_matches_jax_emulated_chunk(case):
    kind, kw, jkw, tkw, rtol = _CASES[case]
    jplan, tplan = _plans(kind, kw, jkw, tkw)
    packed = _packed(3)
    want, got = run_chunk_pair(jplan, tplan, packed)
    assert_chunks_close(want, got, rtol)
    t_out = got[0]
    alive = t_out[13] > 0
    scattered = (t_out[9:12] != 0).any(axis=0) & alive
    assert scattered.sum() > 100
    # |v| stays c; compton changes energies, the rest keep them
    speed = np.linalg.norm(t_out[6:9, alive].astype(np.float64), axis=0)
    np.testing.assert_allclose(speed, C_LIGHT, rtol=3e-6)
    changed = (t_out[12] != packed[12]) & alive
    assert changed.any() == (kind == "compton")
    if "dep" in case:
        heat = got[2][:K_ACT, 0]
        assert (heat < 0).any() if "thermal" in case else (heat > 0).all()


@pytest.mark.parametrize("kind", ["hg", "rayl", "phase"])
def test_scatter_family_keeps_energy_and_weight(kind):
    """Outside compton the rotation family moves directions only."""
    tkw = {"phase_knots": TL.phase_knots(*_MIE[:2], 32)} \
        if kind == "phase" else {}
    _, tplan = _plans(kind, dict(coef=0.5 / C_DT, c_val=C_LIGHT,
                                 g=0.3 if kind == "hg" else 0.0), {}, tkw)
    packed = _packed(9, C=4096)
    out, rec, _ = TF.fused_chunk_reference(
        torch.from_numpy(packed), torch.from_numpy(_sched()), 5, 16, tplan)
    np.testing.assert_array_equal(out[12].numpy(), packed[12])
    np.testing.assert_array_equal(out[14].numpy(), packed[14])
    assert int(rec[15, 0]) == int((packed[13] > 0).sum())


# -- statistics on the twin ----------------------------------------------------

def _one_scatter(kind, n=1 << 17, **kw):
    """Every photon scatters once (pcoll >= 1): cos theta of each."""
    op = TF._Op(kind, coef=2.0 / C_DT, c_val=C_LIGHT, **kw)
    plan = TF.FusedPlan(ops=[TF._Op("kin"), op], n_rec_cols=1, chunk=1,
                        const_norm_speed=C_LIGHT)
    p = np.zeros((15, n), np.float32)
    rng = np.random.default_rng(8)
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    p[6:9] = d * C_LIGHT
    p[12], p[13], p[14] = 1.0, 1.0, 1.0
    s = np.zeros((5, 1), np.float32)
    s[0] = DT
    out, _, _ = TF.fused_chunk_reference(torch.from_numpy(p),
                                         torch.from_numpy(s), 3, 1, plan)
    v = out[6:9].double().numpy() / C_LIGHT
    return (v * d).sum(axis=0), out


@pytest.mark.parametrize("g", [0.9, 0.5, -0.3, 0.0])
def test_hg_mean_cosine_is_g(g):
    cos, _ = _one_scatter("hg", g=g)
    sigma = cos.std() / np.sqrt(cos.size)
    assert abs(cos.mean() - g) < 5 * sigma + 1e-3


def test_rayleigh_second_moment():
    cos, _ = _one_scatter("rayl")
    c2 = cos ** 2
    assert abs(c2.mean() - 0.4) < 5 * c2.std() / np.sqrt(c2.size)
    assert abs(cos.mean()) < 5 * cos.std() / np.sqrt(cos.size)


def test_phase_mean_cosine_is_table_g():
    mu, pdf, g = TL.mie_phase_table(5.0)
    cos, _ = _one_scatter("phase", phase_knots=TL.phase_knots(mu, pdf, 64))
    assert abs(cos.mean() - g) < 5e-3


def test_cold_compton_energy_angle_relation():
    """E' = E / (1 + alpha (1 - cos theta)) for electrons at rest."""
    cos, out = _one_scatter("compton", inv_mec2=2.0, kn_tries=12)
    E = out[12].double().numpy()
    np.testing.assert_allclose(E, 1.0 / (1.0 + 2.0 * (1.0 - cos)),
                               rtol=3e-5, atol=3e-5)


# -- whole runs ----------------------------------------------------------------

def _build(P, case, **kw):
    s = P.Simulation(until_t=59.5 * DT, seed=31, chunk_steps=32, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    heat = None
    if case == "hg":
        step = P.light.ScatterHenyeyGreensteinStep(A=0.1 / C_DT, n=1.0,
                                                   g=0.8)
    elif case == "rayleigh":
        step = P.light.ScatterRayleighStep(A=0.1 / C_DT, n=1.0)
    elif case == "phase":
        mu, pdf, _ = P.light.mie_phase_table(3.0)
        step = P.light.ScatterPhaseFunctionStep(A=0.1 / C_DT, n=1.0,
                                                phase_table=(mu, pdf),
                                                table_bins=32)
    elif case == "compton":
        step = heat = P.light.ScatterComptonStep(
            A=0.1 / C_DT, n=1.0, mec2=0.5, kn_cross_section=True,
            measure_deposition=True)
    else:
        step = heat = P.light.ScatterComptonStep(
            A=0.2 / C_DT, n=1.0, mec2=100.0, theta_e=0.02,
            measure_deposition=True)
    s.add_step(2, step)
    sign = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    rng = np.random.default_rng(5)
    n = 3000
    d = rng.normal(size=(3, n))
    s.add_photons(P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n),
        v=d / np.linalg.norm(d, axis=0) * float(P.light.c),
        r=rng.uniform(0.1, 0.9, (3, n)) * L_BOX))
    return s, sign, heat


@pytest.fixture(scope="module",
                params=["hg", "rayleigh", "phase", "compton", "thermal"])
def scatter_run(request):
    case = request.param
    js, jsign, jheat = _build(J, case)
    ts, tsign, theat = _build(T, case, device="cpu")
    for s in (js, ts):
        s.start()
        s.join()
    return case, (js, jsign, jheat), (ts, tsign, theat)


def test_scatter_runs_fused_ts_and_rows_equal(scatter_run):
    case, (js, jsign, jheat), (ts, tsign, theat) = scatter_run
    assert js.used_fused and ts.used_fused
    text = ts.explain_plan()
    assert "execution mode: fused" in text and "const-norm |dr| = c*dt: on" \
        in text
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    got, want = np.asarray(tsign.data), np.asarray(jsign.data)
    assert got.shape == want.shape == (60, 5)
    np.testing.assert_array_equal(got, want, err_msg=case)
    if theat is not None:
        hg, hw = np.asarray(theat.data), np.asarray(jheat.data)
        assert hg.shape == hw.shape == (60, 2)
        np.testing.assert_array_equal(hg[:, 0], hw[:, 0])
        np.testing.assert_allclose(hg[:, 1], hw[:, 1], rtol=3e-5)


def test_scatter_run_final_state_close(scatter_run):
    case, (js, _, _), (ts, _, _) = scatter_run
    alive = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), alive)
    rtol = 1e-5 if case in ("phase", "compton", "thermal") else 2e-4
    assert_planes_close(TF.pack_state(ts.sim_state).numpy(),
                        np.asarray(JF.pack_state(js.sim_state)), rtol,
                        len(ts.ts))


# -- the prover ------------------------------------------------------------------

def _prove(P, kinds, match_speed=False):
    from physicl_tpu.ops.pipeline import try_build_fused as j_build
    from physicl_tpu_torch.ops.pipeline import try_build_fused as t_build

    build = j_build if P is J else t_build
    s = P.Simulation(until_t=0.01, seed=0,
                     **({} if P is J else {"device": "cpu"}))
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    mu, pdf, _ = P.light.mie_phase_table(2.0)
    make = {
        "kin": lambda: P.newton.NewtonianKinematicsStep(),
        "hg": lambda: P.light.ScatterHenyeyGreensteinStep(A=1e-3, g=0.5),
        "rayl": lambda: P.light.ScatterRayleighStep(A=1e-3),
        "phase": lambda: P.light.ScatterPhaseFunctionStep(
            A=1e-3, phase_table=(mu, pdf)),
        "compton": lambda: P.light.ScatterComptonStep(A=1e-3, mec2=1.0),
        "fresnel": lambda: P.light.RefractiveInterfaceStep(
            0.5 * L_BOX, 1.0, 1.5, match_speed=match_speed),
        "reflect": lambda: P.newton.ReflectingBoundaryStep(
            ((0.0, L_BOX),) * 3),
    }
    for i, kind in enumerate(kinds, start=1):
        s.add_step(i, make[kind]())
    s.add_photons(P.light.generate_photon_state(
        100, E=1.0, r=(0.3 * L_BOX,) * 3))
    steps = s._ordered_steps()
    for st in steps:
        st.setup(s)
    plan = build(s, steps, s._init_run_state()).plan
    return plan.const_norm_speed is not None


@pytest.mark.parametrize("order,const_norm", [
    (("kin", "hg"), True),
    (("kin", "rayl", "compton"), True),
    (("kin", "fresnel", "hg"), False),
    (("kin", "hg", "fresnel"), True),
    (("kin", "fresnel"), True),
    (("kin", "reflect", "compton"), False),
], ids=["hg", "rayl-compton", "fresnel-before-hg", "fresnel-after-hg",
        "fresnel-alone", "reflect-before-compton"])
def test_const_norm_rule_matches_jax(order, const_norm):
    """|dr| consumers downstream of an interface's kink use the computed
    norm, on both packages."""
    assert _prove(J, order) == const_norm
    assert _prove(T, order) == const_norm


def test_match_speed_turns_const_norm_off():
    assert not _prove(J, ("kin", "hg", "fresnel"), match_speed=True)
    assert not _prove(T, ("kin", "hg", "fresnel"), match_speed=True)


def test_phase_is_a_norm_consumer_unlike_jax():
    """A reference fault the port does not copy: the JAX prover leaves
    "phase" out of its |dr| consumers although its op reads |dr|, so after
    an interface it charges phase c dt where the generic path charges the
    kinked |dr|; and with "phase" the only scatter op it finds no consumer
    and drops the fast path. The port treats "phase" as it treats "hg"."""
    assert _prove(J, ("kin", "fresnel", "phase"))
    assert not _prove(T, ("kin", "fresnel", "phase"))
    assert not _prove(J, ("kin", "fresnel", "hg"))
    assert not _prove(J, ("kin", "phase"))
    assert _prove(T, ("kin", "phase"))


def test_phase_resample_speed_checked_unlike_jax():
    """The JAX prover never checks "phase"'s resample speed against the
    population's; the port does (a population at c / 2, absorbed, then
    resampled at c: the JAX plan keeps |dr| = c/2 dt for the absorption
    of photons that move at c after their first scatter)."""
    for P, keeps in ((J, True), (T, False)):
        s = P.Simulation(until_t=0.01, seed=0,
                         **({} if P is J else {"device": "cpu"}))
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterDeleteStep(1.0, 1e-3))
        mu, pdf, _ = P.light.mie_phase_table(2.0)
        s.add_step(3, P.light.ScatterPhaseFunctionStep(
            A=1e-3, phase_table=(mu, pdf)))
        s.add_photons(P.light.generate_photon_state(
            10, E=1.0, v=(0.5 * C_LIGHT, 0.0, 0.0)))
        steps = s._ordered_steps()
        for st in steps:
            st.setup(s)
        from physicl_tpu.ops.pipeline import try_build_fused as j_build
        from physicl_tpu_torch.ops.pipeline import try_build_fused as t_b
        plan = (j_build if P is J else t_b)(s, steps,
                                            s._init_run_state()).plan
        assert (plan.const_norm_speed is not None) == keeps


# -- options ---------------------------------------------------------------------

def test_step_options_match_jax():
    for P in (J, T):
        with pytest.raises(ValueError, match="g must be in"):
            P.light.ScatterHenyeyGreensteinStep(g=1.0)
        with pytest.raises(ValueError, match="exactly one"):
            P.light.ScatterPhaseFunctionStep(A=1.0)
        with pytest.raises(ValueError, match="unknown option"):
            P.light.ScatterPhaseFunctionStep(phase_table=([-1, 1], [1, 1]),
                                             g=0.3)
        with pytest.raises(ValueError, match="lambda"):
            P.light.ScatterComptonStep(wavelength_dep_scattering=True)
        with pytest.raises(ValueError, match="not both"):
            P.light.ScatterComptonStep(theta_e=0.01, T_e=1e7)
        with pytest.raises(ValueError, match="kn_max_tries"):
            P.light.ScatterComptonStep(kn_max_tries=0)
        with pytest.raises(ValueError, match="unknown option"):
            P.light.ScatterComptonStep(kn_cross_sections=True)
        with pytest.warns(RuntimeWarning, match="Maxwell"):
            P.light.ScatterComptonStep(theta_e=0.1)
        with pytest.raises(ValueError, match="refractive indices"):
            P.light.RefractiveInterfaceStep(0.0, 0.0, 1.5)
        with pytest.raises(ValueError, match="axis"):
            P.light.RefractiveInterfaceStep(0.0, 1.0, 1.5, axis=3)
        step = P.light.ScatterComptonStep(T_e=5.93e7)
        step.setup(None)
        assert np.isclose(step._theta_e, 0.01, rtol=0.01)
    j = JL.ScatterComptonStep(T_e=5.93e7, mec2=2.0)
    t = TL.ScatterComptonStep(T_e=5.93e7, mec2=2.0)
    j.setup(None)
    t.setup(None)
    assert (t._theta_e, t._inv_mec2) == (j._theta_e, j._inv_mec2)


@pytest.mark.parametrize("cls", ["ScatterHenyeyGreensteinStep",
                                 "ScatterRayleighStep", "ScatterComptonStep",
                                 "RefractiveInterfaceStep"])
def test_apply_names_the_generic_tier(cls):
    """Each step's generic-tier apply runs (tests/test_torch_generic_steps.py
    holds it against the JAX one): a forced scatter turns every photon at
    |v| = c, and a photon crossing the interface into a denser medium
    bends toward the normal."""
    from physicl_tpu_torch.engine import StepContext
    from physicl_tpu_torch.state import SimState

    C = float(TL.c)
    c_dt = C * DT
    bulk = TL.generate_photon_state(
        256, E=1.0, r=(0.0, 0.0, 0.5 * c_dt),
        v=(0.6 * C, 0.0, 0.8 * C))
    state = SimState.from_population([], [bulk], device="cpu")
    state = state.replace(dr=torch.tensor([0.6, 0.0, 0.8])[:, None].expand(
        3, state.capacity) * c_dt)
    kw = {"mec2": 1.0} if cls == "ScatterComptonStep" else {}
    step = (getattr(TL, cls)(0.0, 1.0, 1.5) if cls.startswith("Refr")
            else getattr(TL, cls)(A=1.0 / c_dt, n=1.0, **kw))
    assert step.generic_missing is None
    gen = torch.Generator().manual_seed(1)
    out = step.apply(state, StepContext(gen, None, "cpu"))
    v = out.v[:, :256].double()
    np.testing.assert_allclose(torch.linalg.norm(v, dim=0).numpy(), C,
                               rtol=1e-6)
    if cls.startswith("Refr"):
        # refracted: sin_t = sin_i / 1.5; reflected (R = 0.044): mirrored
        up = v[2] > 0
        np.testing.assert_allclose((v[0] / C)[up].numpy(), 0.4, rtol=1e-6)
        np.testing.assert_allclose((v[0] / C)[~up].numpy(), 0.6, rtol=1e-6)
        assert 0 < int((~up).sum()) < 40
    else:  # Compton: a lane whose 12 Kahn tries all fail keeps its v
        turned = (out.v[:, :256] != state.v[:, :256]).any(dim=0)
        assert int(turned.sum()) >= (250 if kw else 256)
