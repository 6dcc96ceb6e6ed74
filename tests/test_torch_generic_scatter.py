"""The scatter family and the polarized steps on the generic tier against
the same plan on the fused tier (the kernel's plain twin), statistically.

Each plan runs a +x beam of N photons through a few iterations of one
scatter step (and, for the polarized steps, the Stokes tally) under
``fuse="off"`` and ``fuse="auto"``. The two tiers draw from different
streams (torch's generator, the kernel's counter hash) and the fused tier
uses the polynomial sines and logs where the generic tier calls libm, so
they agree in distribution only: each per-photon observable's mean (the
direction cosines, the energy, the Stokes components and the degree of
polarization) and each tally's per-iteration totals agree within 5
combined standard errors. Each ``apply`` is held against the JAX one lane
for lane in ``tests/test_torch_generic_steps.py``.
"""

import numpy as np
import pytest
import torch

import physicl_tpu_torch as T
import physicl_tpu_torch.light as TL
import physicl_tpu_torch.polarization as TP

DT = 2.0 ** -10
N = 8192
K = 6


def _linear_icdf(u):
    a = 0.6
    return (torch.sqrt(torch.clamp(1.0 - a * (2.0 - a - 4.0 * u),
                                   min=0.0)) - 1.0) / a


_PLANS = {
    "hg": lambda A: TL.ScatterHenyeyGreensteinStep(A=A, n=1.0, g=0.7),
    "rayleigh": lambda A: TL.ScatterRayleighStep(A=A, n=1.0),
    "phase-table": lambda A: TL.ScatterPhaseFunctionStep(
        A=A, n=1.0, phase_table=TL.mie_phase_table(2.0)[:2]),
    "phase-callable": lambda A: TL.ScatterPhaseFunctionStep(
        A=A, n=1.0, cos_theta_icdf=_linear_icdf),
    "compton": lambda A: TL.ScatterComptonStep(A=A, n=1.0, mec2=1.0,
                                               kn_cross_section=True),
    "compton-thermal": lambda A: TL.ScatterComptonStep(
        A=A, n=1.0, mec2=4.0, theta_e=0.02),
    "refractive": lambda A: TL.RefractiveInterfaceStep(
        2.5 * float(TL.c) * DT, 1.0, 1.5, axis=0),
    "polarized-rayleigh": lambda A: TP.ScatterPolarizedRayleighStep(A=A,
                                                                    n=1.0),
    "polarized-compton": lambda A: TP.ScatterPolarizedComptonStep(
        A=A, n=1.0, mec2=1.0),
}


def _run(case, fuse, seed):
    c = float(TL.c)
    s = T.Simulation(until_t=K * DT * 0.9999, seed=seed, device="cpu",
                     fuse=fuse, chunk_steps=K)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, _PLANS[case](0.3 / (c * DT)))
    polar = case.startswith("polarized")
    tally = (TP.StokesMeasureStep(None) if polar
             else TL.ScatterSignMeasureStep(None, True))
    s.add_step(3, tally)
    rng = np.random.default_rng(seed)
    if polar:
        st = rng.normal(size=(3, N))
        st *= rng.uniform(0.3, 1.0, N) / np.linalg.norm(st, axis=0)
        bulk = TP.polarized_photon_state(N, E=1.0, stokes=st)
    else:
        bulk = TL.generate_photon_state(N, E=rng.uniform(0.5, 2.0, N))
    if case == "refractive":  # a beam tilted onto the plane x = 2.5 c dt
        d = np.stack([np.full(N, 0.8), rng.uniform(-0.6, 0.6, N),
                      np.zeros(N)])
        bulk["v"] = d / np.linalg.norm(d, axis=0) * c
    s.add_photons(bulk)
    s.start()
    s.join()
    assert s.used_fused == (fuse == "auto"), s.explain_plan()
    st = s.sim_state
    live = st.alive.numpy()[:N]
    v = st.v.numpy()[:, :N].astype(np.float64)[:, live] / c
    obs = {"vx": v[0], "vy": v[1], "vz": v[2],
           "E": st.E.numpy()[:N].astype(np.float64)[live]}
    if polar:
        sk = st.extras["stokes"].numpy()[:, :N].astype(np.float64)[:, live]
        obs.update(Q=sk[0], U=sk[1], V=sk[2],
                   p=np.sqrt((sk * sk).sum(axis=0)))
    return obs, np.asarray(tally.data, np.float64)


@pytest.mark.parametrize("case", sorted(_PLANS))
def test_generic_against_fused(case):
    (a, ra), (b, rb) = _run(case, "off", 1), _run(case, "auto", 2)
    for name in a:
        x, y = a[name], b[name]
        se = np.sqrt(x.var() / x.size + y.var() / y.size)
        assert abs(x.mean() - y.mean()) <= 5 * se + 1e-12, (
            name, x.mean(), y.mean(), se)
    assert ra.shape == rb.shape == (K, ra.shape[1])
    if not case.startswith("polarized"):
        # counts: n and the +x, +y, +z movers, binomial
        for col in (1, 2, 3, 4):
            x, y = ra[:, col], rb[:, col]
            assert (np.abs(x - y) <= 5 * np.sqrt(x + y + 1)).all(), (col,
                                                                     x, y)
