"""The declarative kernel bridge (``KernelInput`` / ``KernelOutput`` /
``KernelProgram``) against the JAX package's.

The same program body, written once over array operations both packages
share (``+``, ``*``, comparisons, ``abs``), runs on identical states:

* without draws the outputs are equal exactly, and so are the tracked
  indices;
* with draws (``np.random.random() * k`` or a callable sampler) the two
  streams differ (a torch generator is not threefry), so the draws are held
  to U[0, k) by their moments and a KS distance, and two runs of one
  program draw differently while two programs with one seed agree;
* the errors have JAX's types and messages.

``run()`` launches no hand-written kernel in either package.
"""

import numpy as np
import pytest
import torch

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu import kernels as JK
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch import kernels as TK
from physicl_tpu_torch.ops import fused as F

DT = 0.001


def _sims(n=3000):
    """Both packages after three kinematics iterations of the same photons
    and charges (a tag plane on the charges)."""
    out = {}
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        s = P.Simulation(until_t=2.5 * DT, seed=4, auto_shrink=False, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        rng = np.random.default_rng(1)
        d = rng.normal(size=(3, n))
        s.add_photons(P.light.generate_photon_state(
            n, E=rng.uniform(0.5, 2.0, n),
            v=d / np.linalg.norm(d, axis=0) * float(P.light.c)))
        charges = P.newton.generate_particle_state(
            500, v=(1.0, 2.0, 0.5), r=rng.uniform(-1, 1, (3, 500)))
        charges["extras"] = {"tag": np.arange(500, dtype=np.float32)}
        s.add_particles(charges)
        s.start()
        s.join()
        out[P] = s
    return out[J], out[T]


def _program(K, sim, body, ins, outs):
    prog = K.KernelProgram(sim, "p", body)
    prog.prep_metadata = [K.KernelInput(**kw) for kw in ins]
    prog.output_metadata = [K.KernelOutput(**kw) for kw in outs]
    return prog.build_kernel()


INS = [
    {"name": "photon_check", "type": "obj_action",
     "code": "if type(obj) != physicl.light.PhotonObject: continue"},
    {"name": "d0", "type": "obj", "obj_attr": "dr[0]"},
    {"name": "d1", "type": "obj", "obj_attr": "dr[1]"},
    {"name": "E", "type": "obj", "obj_attr": "E"},
    {"name": "A", "type": "const", "const_value": "0.5"},
    {"name": "pht", "type": "obj_track", "obj_track": "obj"},
]


def _body(valid, d0, d1, E, A):
    score = abs(d0) * A + d1 * d1 * 1e-9 + E
    return {"score": score * valid, "hit": (score > A * 1e5) & valid}


def test_program_without_draws_matches_jax():
    js, ts = _sims()
    outs = [{"name": "score"}, {"name": "hit", "ctype": "int"}]
    jo = _program(JK, js, _body, INS, outs).run()
    tp = _program(TK, ts, _body, INS, outs)
    to = tp.run()
    assert set(to) == set(jo) == {"score", "hit"}
    for k in jo:
        assert to[k].dtype == jo[k].dtype
        np.testing.assert_array_equal(to[k], jo[k])
    assert to["score"].shape == (ts.sim_state.capacity,)
    # the photon filter: 3000 photons tracked, the charges are not
    np.testing.assert_array_equal(tp.pht, np.arange(3000))
    assert 0 < int(to["hit"].sum()) < 3000


def test_program_on_extras_and_vectors_matches_jax():
    """Whole vectors, an extras plane and a callable filter."""
    js, ts = _sims(256)

    def body(valid, r, tag, **kw):
        return {"x": (r[0] + tag) * valid}

    ins = [{"name": "r", "type": "obj", "obj_attr": "r"},
           {"name": "tag", "type": "obj", "obj_attr": "tag"},
           {"name": "charged", "type": "obj_action",
            "code": lambda st: st.otype == 0},
           {"name": "sel", "type": "obj_track"}]
    jp = _program(JK, js, body, ins, [{"name": "x"}])
    tp = _program(TK, ts, body, ins, [{"name": "x"}])
    np.testing.assert_array_equal(tp.run()["x"], jp.run()["x"])
    np.testing.assert_array_equal(tp.sel, jp.sel)
    np.testing.assert_array_equal(tp.sel, np.arange(256, 756))


@pytest.mark.parametrize("obj_def,k", [
    ("np.random.random()", 1.0),
    ("np.random.random() * 2 * np.pi", 2 * np.pi),
    (None, 3.0)], ids=["literal", "scaled", "callable"])
def test_program_draws(obj_def, k):
    """U[0, k) draws, one per slot, from the program's generator: mean,
    variance and the KS distance within 5 sigma of U[0, k) at 16384 slots
    (the JAX package's draws checked the same way)."""
    if obj_def is None:
        def obj_def(gen, n):
            return torch.rand((n,), generator=gen, device=gen.device) * 3.0

    def body(valid, u, **kw):
        return {"u": u}

    st = T.SimState.from_population(
        [], [T.light.generate_photon_state(16384, E=1.0)])
    prog = _program(TK, None, body,
                    [{"name": "u", "type": "obj_def", "obj_def": obj_def}],
                    [{"name": "u"}])
    u = prog.run(st)["u"].astype(np.float64)
    n = u.size
    assert u.min() >= 0 and u.max() < k
    assert abs(u.mean() - k / 2) < 5 * k / np.sqrt(12 * n)
    assert abs(u.var() - k * k / 12) < 5 * k * k * np.sqrt(1 / 180 / n)
    ks = np.abs(np.sort(u) / k - (np.arange(n) + 0.5) / n).max()
    assert ks < 1.63 / np.sqrt(n) + 1 / (2 * n)  # 1% KS critical value
    again = prog.run(st)["u"]
    assert not np.array_equal(again, u)  # a new stream every run
    other = _program(TK, None, body,
                     [{"name": "u", "type": "obj_def", "obj_def": obj_def}],
                     [{"name": "u"}])
    np.testing.assert_array_equal(other.run(st)["u"], u)  # one seed, one
    if isinstance(obj_def, str):
        jst = J.SimState.from_population(
            [], [J.light.generate_photon_state(16384, E=1.0)])
        ju = _program(JK, None, body, [{"name": "u", "type": "obj_def",
                                        "obj_def": obj_def}],
                      [{"name": "u"}]).run(jst)["u"].astype(np.float64)
        assert abs(ju.mean() - u.mean()) < 5 * k / np.sqrt(6 * n)


def test_program_reads_the_pending_population():
    """Before start() the program runs on the added particles."""
    s = T.Simulation(device="cpu")
    s.add_photons(T.light.generate_photon_state(10, E=2.0))
    prog = _program(TK, s, lambda valid, E: {"E": E * valid},
                    [{"name": "E", "type": "obj", "obj_attr": "E"}],
                    [{"name": "E"}])
    out = prog.run()
    assert out["E"].shape == (16384,) and out["E"].sum() == 20.0


def test_program_launches_no_kernel():
    _, ts = _sims(64)
    F.fused_transport.launches = 0
    _program(TK, ts, _body, INS, [{"name": "score"}]).run()
    assert F.fused_transport.launches == 0


@pytest.mark.parametrize("case", ["attr-spec", "attr-unknown", "attr-scalar",
                                  "obj-def", "obj-action", "missing-name",
                                  "missing-output"])
def test_errors_match_jax(case):
    """The same exception type and message in both packages."""
    errors = {}
    for K, P in ((JK, J), (TK, T)):
        st = P.SimState.from_population(
            [], [P.light.generate_photon_state(8, E=1.0)])
        ins = [{"name": "x", "type": "obj", "obj_attr": {
            "attr-spec": "r[0]x", "attr-unknown": "q",
            "attr-scalar": "E[0]"}.get(case, "E")}]
        outs = [{"name": "y"}]
        if case == "obj-def":
            ins = [{"name": "x", "type": "obj_def",
                    "obj_def": "random.gauss(0, 1)"}]
        elif case == "obj-action":
            ins.append({"name": "f", "type": "obj_action", "code": "x > 0"})
        elif case == "missing-output":
            outs = [{"name": "z"}]

        def body(valid, x, **kw):
            return {"y": x}

        try:
            if case == "missing-name":
                K.KernelInput(type="obj")
            _program(K, None, body, ins, outs).run(st)
        except Exception as e:  # noqa: BLE001 — compared below
            # the samplers' signatures differ by package (a JAX key, a
            # torch generator); the rest of the message is the same
            errors[K] = (type(e), str(e).replace(
                "f(key, n) -> (n,) array", "f(generator, n) -> (n,) tensor"))
    assert errors[TK] == errors[JK], errors
    assert errors[TK][0] in (ValueError, KeyError)
