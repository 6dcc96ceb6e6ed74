"""The port's differentiable runs (``physicl_tpu_torch.functional``) against
the JAX package's ``physicl_tpu.functional.scan_steps``.

The same numpy-seeded photons go through both. Implicit-capture weighted
transport is draw-free, so the transmission ``T = (1 - p)^K`` and its
derivative ``dT/dA = -K c dt (1 - p)^(K - 1)`` (``p = A n c dt``) match
between the packages at rtol 1e-5 and the closed form at rtol 1e-4 (the
JAX test's tolerance). Runs with draws are held statistically (the two
packages' streams differ) and, within the port, bitwise: a checkpointed
(``remat``) gradient equals the plain one on a configuration whose
weights depend on draws (implicit capture with roulette).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu import functional as JFn
from physicl_tpu.state import SimState as JState

import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch import functional as TFn
from physicl_tpu_torch.state import SimState as TState


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
DT = 1e-3
N = 512
K = 40


def _bulk(P, n=N, seed=0):
    """``n`` photons from the origin in numpy-seeded directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    v = d / np.linalg.norm(d, axis=0) * C
    return P.light.generate_photon_state(n, E=1.0, v=v)


def _jstate(n=N):
    return JState.from_population([], [_bulk(J, n)])


def _tstate(n=N):
    return TState.from_population([], [_bulk(T, n)], device="cpu")


def _steps(P, A, **del_kw):
    return [P.UpdateTimeStep(lambda x: DT),
            P.newton.NewtonianKinematicsStep(),
            P.light.ScatterDeleteStep(n=1.0, A=A, implicit_capture=True,
                                      **del_kw)]


def _t_transmission(A, state, n_iters=K, **kw):
    out = TFn.scan_steps(_steps(T, A), state, n_iters, **kw)
    return (out.w * out.alive).sum() / N


def _j_transmission(A, state):
    out = JFn.scan_steps(_steps(J, A), state, K)
    return jnp.sum(out.w * out.alive) / N


def _closed_form_grad(p):
    return -K * C * DT * (1 - p) ** (K - 1)


@pytest.mark.parametrize("p", [0.005, 0.015, 0.02])
def test_transmission_and_grad_match_jax_and_closed_form(p):
    A0 = p / (C * DT)
    A = torch.tensor(A0, dtype=torch.float32, requires_grad=True)
    t_T = _t_transmission(A, _tstate())
    (t_g,) = torch.autograd.grad(t_T, A)
    js = _jstate()
    j_T = float(_j_transmission(jnp.float32(A0), js))
    j_g = float(jax.grad(_j_transmission)(jnp.float32(A0), js))
    t_T = t_T.detach()
    np.testing.assert_allclose(float(t_T), j_T, rtol=1e-5)
    np.testing.assert_allclose(float(t_g), j_g, rtol=1e-5)
    np.testing.assert_allclose(float(t_T), (1 - p) ** K, rtol=1e-5)
    np.testing.assert_allclose(float(t_g), _closed_form_grad(p), rtol=1e-4)


def test_parameter_folding():
    """A tensor that needs no grad folds to a host float (the plan can
    hash it); one that requires grad stays a tensor, and so does the
    property derived from it."""
    plain = T.light.ScatterDeleteStep(n=1.0, A=torch.tensor(2.0))
    assert isinstance(plain.A, float) and isinstance(plain._coef, float)
    A = torch.tensor(2.0, requires_grad=True)
    traced = T.light.ScatterDeleteStep(n=3.0, A=A)
    assert traced.A is A and traced._coef.requires_grad
    qm = torch.tensor(2.0, requires_grad=True)
    assert T.newton.LorentzForceStep(E_field=(1, 0, 0),
                                     q_over_m=qm).q_over_m is qm
    assert T.newton.LorentzForceStep(
        E_field=(1, 0, 0), q_over_m=torch.tensor(2.0)).q_over_m == 2.0
    # the Klein-Nishina constants fold on the host: a traced mec2 or T_e
    # is refused, as the JAX package refuses a tracer there
    for kw in ({"mec2": torch.tensor(1.0, requires_grad=True)},
               {"mec2": 1e9, "T_e": torch.tensor(1e5, requires_grad=True)}):
        with pytest.raises(TypeError, match="host constant"):
            T.light.ScatterComptonStep(A=1.0, n=1.0, **kw).setup(None)
    # the refractive plane's loc stays in the graph
    loc = torch.tensor(0.5, requires_grad=True)
    assert T.light.RefractiveInterfaceStep(loc, 1.0, 1.5).loc is loc


def test_engine_refuses_a_traced_parameter_on_the_fused_tier():
    """A Simulation handed a step with a grad tensor runs it on the
    generic tier (a plan never holds a tensor), and the gradient flows."""
    A = torch.tensor(0.02 / (C * DT), requires_grad=True)
    s = T.Simulation(until_t=(8 - 0.5) * DT, seed=0, device="cpu")
    for i, st in enumerate(_steps(T, A)):
        s.add_step(i, st)
    s.add_photons(_bulk(T))
    with pytest.warns(RuntimeWarning, match="unsupported-step"):
        s.start()
        s.join()
    assert not s.used_fused
    w = s.sim_state.w[:N]
    (g,) = torch.autograd.grad(w.sum() / N, A)
    np.testing.assert_allclose(float(g), -8 * C * DT * 0.98 ** 7, rtol=1e-4)


def test_charged_dynamics_grad_matches_jax():
    """Boris dynamics under a constant E: v_x = qm E0 t, so dv/d(q/m) =
    E0 K dt, in both packages."""
    def steps(P, qm):
        return [P.UpdateTimeStep(lambda x: DT),
                P.newton.LorentzForceStep(E_field=(3.0, 0, 0), q_over_m=qm),
                P.newton.NewtonianKinematicsStep()]

    rng = np.random.default_rng(5)
    v0 = rng.normal(size=(3, 4))
    tst = TState.from_population(
        [], [T.newton.generate_particle_state(4, v=v0)], device="cpu")
    jst = JState.from_population(
        [], [J.newton.generate_particle_state(4, v=v0)])
    qm = torch.tensor(2.0, requires_grad=True)
    out = TFn.scan_steps(steps(T, qm), tst, K)
    (g,) = torch.autograd.grad(out.v[0, 0], qm)
    j_g = float(jax.grad(lambda q: JFn.scan_steps(
        steps(J, q), jst, K).v[0, 0])(jnp.float32(2.0)))
    np.testing.assert_allclose(float(g), j_g, rtol=1e-5)
    np.testing.assert_allclose(float(g), 3.0 * K * DT, rtol=1e-5)


def test_records_and_engine_parity():
    """record=True stacks each iteration's records; the clock is byte for
    byte the JAX scan's and the port engine's, and the absorbing wall
    empties the population in both packages."""
    def steps(P):
        return [P.UpdateTimeStep(lambda x: np.double(DT)),
                P.newton.NewtonianKinematicsStep(),
                P.newton.AbsorbingBoundaryStep(
                    ((-1e9, C * DT * 10.5), (-1e9, 1e9), (-1e9, 1e9)))]

    x_bulk = {P: P.light.generate_photon_state(N, E=1.0) for P in (J, T)}
    t_out, t_recs = TFn.scan_steps(
        steps(T), TState.from_population([], [x_bulk[T]], device="cpu"), K,
        record=True)
    j_out, j_recs = JFn.scan_steps(
        steps(J), JState.from_population([], [x_bulk[J]]), K, record=True)
    assert set(t_recs) == set(j_recs) == {"s0/ts"}
    ts = t_recs["s0/ts"].numpy()
    assert ts.shape == (K,)
    assert ts.tobytes() == np.asarray(j_recs["s0/ts"], np.float32).tobytes()
    assert int(t_out.alive.sum()) == int(jnp.sum(j_out.alive)) == 0

    s = T.Simulation(until_t=DT * K * 0.9999, seed=0, device="cpu")
    for i, st in enumerate(steps(T)):
        s.add_step(i, st)
    s.add_photons(T.light.generate_photon_state(N, E=1.0))
    s.start()
    s.join()
    assert int(s.sim_state.alive.sum()) == 0
    assert np.asarray(s.ts, np.float32).tobytes() == ts.tobytes()


def test_gradient_descent_recovers_cross_section():
    """Calibration: recover the A that produced a 'measured'
    transmission by gradient descent through the port, within 2%."""
    state = _tstate()
    A_true = 0.02 / (C * DT)
    T_obs = float(_t_transmission(torch.tensor(A_true), state))

    def grad(a):
        A = torch.tensor(a, dtype=torch.float32, requires_grad=True)
        loss = (_t_transmission(A, state) - T_obs) ** 2
        (g,) = torch.autograd.grad(loss, A)
        return float(g)

    a = 0.5 * A_true
    lr = 0.4 * A_true / abs(grad(a) + 1e-30)
    for _ in range(60):
        a = a - lr * grad(a)
    assert abs(a - A_true) < 0.02 * A_true, (a, A_true)


def test_vmap_over_cross_section():
    """torch.func.vmap maps one run over a batch of A, as jax.vmap does."""
    state = _tstate()
    ps = (0.005, 0.01, 0.02)
    As = torch.tensor(ps, dtype=torch.float32) / (C * DT)
    Ts = torch.func.vmap(lambda a: _t_transmission(a, state))(As)
    j_Ts = jax.vmap(lambda a: _j_transmission(a, _jstate()))(
        jnp.asarray(ps, jnp.float32) / (C * DT))
    np.testing.assert_allclose(Ts.numpy(), np.asarray(j_Ts), rtol=1e-5)
    np.testing.assert_allclose(Ts.numpy(), [(1 - p) ** K for p in ps],
                               rtol=1e-5)
    # with draws (roulette): randomness="same" gives each member what its
    # own run with the same key gives
    def roulette_T(a):
        out = TFn.scan_steps(_steps(T, a, roulette=(0.5, 1.0)), state, K,
                             key=3)
        return (out.w * out.alive).sum() / N

    Tr = torch.func.vmap(roulette_T, randomness="same")(As)
    assert Tr.tolist() == [float(roulette_T(a)) for a in As]
    # the grad of each member through torch.func.grad, vmapped
    gs = torch.func.vmap(torch.func.grad(
        lambda a: _t_transmission(a, state)))(As)
    np.testing.assert_allclose(gs.numpy(),
                               [_closed_form_grad(p) for p in ps],
                               rtol=1e-4)


def test_seed_ensemble_binomial_spread():
    """Analog kills over 16 seeds (a loop over ``key``: vmap does not take
    draws from an explicit generator): independent realizations whose
    survival spread is binomial, as the JAX ensemble's is."""
    A = 0.02 / (C * DT)
    state = _tstate()

    def survivors(key):
        steps = [T.UpdateTimeStep(lambda x: DT),
                 T.newton.NewtonianKinematicsStep(),
                 T.light.ScatterDeleteStep(n=1.0, A=A)]
        return int(TFn.scan_steps(steps, state, K, key=key).alive.sum())

    ns = np.array([survivors(7 * 1000 + i) for i in range(16)], float)
    p = (1 - 0.02) ** K
    mu, sd = N * p, np.sqrt(N * p * (1 - p))
    assert ns.std() > 0
    assert abs(ns.mean() - mu) < 4 * sd / np.sqrt(16)
    assert sd / 3 < ns.std() < 3 * sd
    # a torch.Generator key is the same stream as its seed
    g = torch.Generator().manual_seed(7000)
    steps = [T.UpdateTimeStep(lambda x: DT),
             T.newton.NewtonianKinematicsStep(),
             T.light.ScatterDeleteStep(n=1.0, A=A)]
    assert int(TFn.scan_steps(steps, state, K, key=g).alive.sum()) == ns[0]


def test_functional_sim_seed_seeds_the_scan():
    st = _tstate(256)

    def steps():
        return [T.UpdateTimeStep(lambda x: DT),
                T.newton.NewtonianKinematicsStep(),
                T.light.ScatterIsotropicStep(n=1.0, A=2.0 / C / DT)]

    out7 = TFn.scan_steps(steps(), st, 8, sim=TFn.FunctionalSim(seed=7))
    key7 = TFn.scan_steps(steps(), st, 8, key=7)
    out0 = TFn.scan_steps(steps(), st, 8, sim=TFn.FunctionalSim(seed=0))
    assert torch.equal(out7.v, key7.v)
    assert not torch.equal(out7.v, out0.v)


@pytest.mark.parametrize("roulette", [None, (0.5, 1.0)],
                         ids=["draw-free", "roulette"])
def test_remat_gradients_identical(roulette):
    """Rematerialization changes memory, not values: the checkpointed
    gradient equals the plain one bitwise, also where the weights depend
    on draws (roulette), whose recomputation must replay the run's
    generator."""
    A0 = 0.04 / (C * DT)
    state = _tstate(4096)

    def grad(remat):
        A = torch.tensor(A0, dtype=torch.float32, requires_grad=True)
        out = TFn.scan_steps(_steps(T, A, roulette=roulette), state, K,
                             key=11, remat=remat)
        (g,) = torch.autograd.grad((out.w * out.alive).sum() / 4096, A)
        return float(g), int(out.alive.sum())

    (g0, n0), (g1, n1) = grad(False), grad(True)
    assert n0 == n1
    assert g0 == g1, (g0, g1)
    assert g0 < 0
    if roulette is not None:
        assert n0 < 4096  # roulette killed: the draws shaped the weights


def test_remat_leaves_the_generator_where_a_plain_run_does():
    """After a checkpointed run, a generator key has moved exactly as far
    as after a plain one (the next draw is the same)."""
    state = _tstate(1024)
    A = torch.tensor(0.04 / (C * DT), requires_grad=True)
    nxt = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(3)
        TFn.scan_steps(_steps(T, A, roulette=(0.5, 1.0)), state, 5, key=g,
                       remat=remat)
        nxt.append(torch.rand(4, generator=g))
    assert torch.equal(nxt[0], nxt[1])
