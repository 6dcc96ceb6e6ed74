"""Every generic-tier ``apply`` of the port against the JAX package's, by
draw replay.

One state is made from a numpy seed and carried into both packages
(``SimState.from_numpy``). The JAX step's ``apply`` runs eagerly on the CPU
(``jax.disable_jit``) with ``jax.random.uniform`` wrapped so that each draw
is recorded in call order; the port's ``apply`` then runs with a
:class:`ReplayContext` that hands those arrays back in that order. The test
asserts that the port asks for the same number of draws with the same
shapes and dtypes, that every int and bool plane and int record is equal,
and that float planes and records agree within TOL of the plane's largest
magnitude.

TOL = 1e-6, a hundredth of the 1e-4 the fused-tier parity tests allow (for
XLA's FMA contraction inside jitted code). Here both sides run op by op (no
contraction: JAX runs eagerly), so what remains are the libm-level
differences of XLA's and torch's transcendentals (sin, cos; sqrt is
correctly rounded on both) and float sums reduced in a different order
(the record sums). Every case passes at 2e-7 and fails somewhere at 1e-7,
about one float32 ulp of the plane's largest value; TOL keeps a factor of
five above that.

A bool plane may differ where a float compare sits exactly at an ulp of its
threshold. Every case here is checked with zero such lanes allowed
(FLIPS = 0): the collision, roulette and split tests compare operands both
sides compute with the same correctly rounded operations.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import physicl_tpu as J
import physicl_tpu.kernels as JK
import physicl_tpu.light as JL
import physicl_tpu.newton as JN
from physicl_tpu.engine import StepContext as JCtx
from physicl_tpu.state import SimState as JState
import physicl_tpu_torch as T
import physicl_tpu_torch.kernels as TK
import physicl_tpu_torch.light as TL
import physicl_tpu_torch.newton as TN
from physicl_tpu_torch.engine import StepContext
from physicl_tpu_torch.state import SimState as TState

TOL = 1e-6
FLIPS = 0
C = 4096
C_CODE = float(TL.c)
DT = 1e-3
_FIELDS = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t", "dt",
           "t_comp", "n_spawned")


class ReplayContext(StepContext):
    """A StepContext whose draws are the JAX apply's, in order."""

    def __init__(self, draws, sim=None):
        super().__init__(None, sim, "cpu")
        self.draws = list(draws)
        self.asked = []

    def uniform(self, shape, dtype=torch.float32):
        shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
        self.asked.append((shape, dtype))
        assert self.draws, f"the port asks for an extra draw {shape}"
        arr = self.draws.pop(0)
        assert arr.shape == shape, (arr.shape, shape)
        return torch.from_numpy(arr)


def _fields(seed=0, n_spawned=C - 512, extras=None, photons=0.9):
    """A state's host arrays: positions over a few c*dt, short segments,
    speed c in random directions, a few dead and non-photon slots."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, C))
    d /= np.linalg.norm(d, axis=0)
    L = 8 * C_CODE * DT
    f = {
        "r": rng.uniform(-L, L, (3, C)),
        "dr": d * C_CODE * DT * rng.uniform(0.2, 1.0, C),
        "v": d * C_CODE,
        "dv": np.where(rng.random((1, C)) < 0.3, rng.normal(size=(3, C)), 0.0),
        "a": rng.normal(size=(3, C)) * 1e3,
        "E": rng.uniform(0.5, 2.0, C),
        "alive": rng.random(C) < 0.85,
        "otype": (rng.random(C) < photons).astype(np.int32),
        "w": rng.uniform(0.05, 2.0, C),
        "t": np.float32(0.01), "dt": np.float32(DT),
        "t_comp": np.float32(1e-10), "n_spawned": np.int32(n_spawned),
    }
    f = {k: np.asarray(v, np.float32) if k not in ("alive", "otype",
                                                    "n_spawned") else v
         for k, v in f.items()}
    f["extras"] = {k: np.asarray(v, np.float32)
                   for k, v in (extras or {}).items()}
    return f


def _jstate(f):
    return JState(key=jax.random.PRNGKey(0), **{
        k: jnp.asarray(f[k]) for k in _FIELDS}, extras={
            k: jnp.asarray(v) for k, v in f["extras"].items()})


def _run_jax(step, f, monkeypatch, boundary=False):
    """The JAX apply, eagerly, recording every uniform draw."""
    draws = []
    real = jax.random.uniform

    def recording(key, shape=(), dtype=jnp.float32, *a, **k):
        out = real(key, shape, dtype, *a, **k)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "uniform", recording)
    sim = types.SimpleNamespace(bounds=np.zeros(3), seed=0)
    with jax.disable_jit():
        st = _jstate(f)
        if boundary:
            out = step.boundary_apply(st, jax.random.PRNGKey(3))
            recs = {}
        else:
            ctx = JCtx(jax.random.PRNGKey(1), sim)
            out = step.apply(st, ctx)
            recs = ctx.records
    monkeypatch.setattr(jax.random, "uniform", real)
    return out, recs, draws


def _run_port(step, f, draws, boundary=False):
    st = TState.from_numpy(f, device="cpu")
    ctx = ReplayContext(draws, types.SimpleNamespace(bounds=np.zeros(3)))
    out = (step.boundary_apply(st, ctx) if boundary
           else step.apply(st, ctx))
    return out, ctx


def _close(got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        bad = int((got != want).sum())
        assert bad <= FLIPS, f"{what}: {bad} lanes differ"
        return
    want = want.astype(np.float64)
    got = got.astype(np.float64)
    scale = max(float(np.nanmax(np.abs(want))) if want.size else 0.0, 1e-30)
    both_nan = np.isnan(got) & np.isnan(want)
    err = np.where(both_nan, 0.0, np.abs(got - want))
    assert not np.isnan(err).any(), f"{what}: NaN where the other is not"
    assert float(err.max(initial=0.0)) <= TOL * scale, (
        what, float(err.max()), scale)


def _compare(step_j, step_t, f, monkeypatch, boundary=False, setup=True):
    if setup:
        for s in (step_j, step_t):
            s._step_uid = "s0"
            if hasattr(s, "setup"):
                s.setup(types.SimpleNamespace(bounds=np.zeros(3)))
    out_j, recs_j, draws = _run_jax(step_j, f, monkeypatch, boundary)
    out_t, ctx = _run_port(step_t, f, [d.copy() for d in draws], boundary)
    assert [(tuple(d.shape), str(d.dtype)) for d in draws] == [
        (s, str(dt).replace("torch.", "")) for s, dt in ctx.asked], (
        "draw sequence differs")
    assert not ctx.draws
    for k in _FIELDS:
        _close(getattr(out_t, k).numpy(), jax.device_get(getattr(out_j, k)),
               k)
    assert set(out_t.extras) == set(out_j.extras)
    for k in out_j.extras:
        _close(out_t.extras[k].numpy(), np.asarray(out_j.extras[k]), k)
    recs_t = ctx.records if not boundary else {}
    assert set(recs_t) == set(recs_j)
    for k, v in recs_j.items():
        got = recs_t[k]
        got = (got.float() if got.dtype == torch.bfloat16 else got).numpy()
        want = np.asarray(jnp.asarray(v, jnp.float32)
                          if v.dtype == jnp.bfloat16 else v)
        _close(got, want, k)
    return out_t, draws


def _both(name, *a, **k):
    """The step ``name`` of each package, built with the same arguments;
    ``J.<module>`` / ``T.<module>`` by the prefix of ``name``."""
    mod, cls = name.split(".")
    jm = {"light": JL, "newton": JN, "engine": J}[mod]
    tm = {"light": TL, "newton": TN, "engine": T}[mod]
    return getattr(jm, cls)(*a, **k), getattr(tm, cls)(*a, **k)


# -- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("fn", ["const", "n_objects"])
def test_update_time(fn, monkeypatch):
    if fn == "const":
        fj = ft = lambda x: np.double(0.0013)
    else:
        fj = lambda x: 1e-3 + x.n_objects * 1e-9
        ft = lambda x: 1e-3 + x.n_objects * 1e-9
    sj, st = J.UpdateTimeStep(fj), T.UpdateTimeStep(ft)
    _compare(sj, st, _fields(1), monkeypatch)


def test_step_base_is_the_identity(monkeypatch):
    _compare(J.Step(), T.Step(), _fields(2), monkeypatch)


# -- newton --------------------------------------------------------------------

@pytest.mark.parametrize("acc", [False, True])
def test_kinematics(acc, monkeypatch):
    _compare(*_both("newton.NewtonianKinematicsStep", acc), _fields(3),
             monkeypatch)


_BOX = ((-4 * C_CODE * DT, 5 * C_CODE * DT),) * 3


@pytest.mark.parametrize("name", ["AbsorbingBoundaryStep",
                                  "ReflectingBoundaryStep",
                                  "PeriodicBoundaryStep"])
def test_boxes(name, monkeypatch):
    _compare(*_both(f"newton.{name}", _BOX), _fields(4), monkeypatch)


@pytest.mark.parametrize("inside", [False, True])
def test_sphere(inside, monkeypatch):
    _compare(*_both("newton.AbsorbingSphereStep", 6 * C_CODE * DT,
                    center=(0.1, 0.0, -0.2), kill_inside=inside),
             _fields(5), monkeypatch)


@pytest.mark.parametrize("case", ["const", "per-particle", "callable"])
def test_lorentz(case, monkeypatch):
    rng = np.random.default_rng(6)
    ex = {}
    kw = {"E_field": (4.0, 0.0, 1.0), "B_field": (0.0, 50.0, 200.0),
          "q_over_m": 2.0}
    if case == "per-particle":
        ex = {"q": rng.normal(size=C), "m": np.where(
            rng.random(C) < 0.1, 0.0, rng.uniform(0.5, 2.0, C))}
        kw["q_over_m"] = None
    f = _fields(6, extras=ex, photons=0.3)
    f["v"] = (rng.normal(size=(3, C)) * 10).astype(np.float32)
    if case == "callable":
        sj = JN.LorentzForceStep(
            E_field=lambda x, y, z: (jnp.sin(x), 0.5 * y, 1.0 + 0 * z),
            B_field=lambda x, y, z: (0 * x, 10.0 + 0 * y, 20.0 * jnp.cos(z)),
            q_over_m=2.0)
        st = TN.LorentzForceStep(
            E_field=lambda x, y, z: (torch.sin(x), 0.5 * y, 1.0 + 0 * z),
            B_field=lambda x, y, z: (0 * x, 10.0 + 0 * y,
                                     20.0 * torch.cos(z)),
            q_over_m=2.0)
    else:
        sj, st = _both("newton.LorentzForceStep", **kw)
    _compare(sj, st, f, monkeypatch)


# -- light: scatter and absorption --------------------------------------------

def _n_fns():
    """(JAX, port) density fields over (r0, r1, r2)."""
    s = "1.0 + 0.5 * cos(r0[gid] * 1e-6) * exp(-fabs(r1[gid]) * 1e-7)"
    return {"expr": (s, s),
            "callable": (lambda x, y, z: 1.0 + 0.5 * jnp.cos(x * 1e-6),
                         lambda x, y, z: 1.0 + 0.5 * torch.cos(x * 1e-6)),
            "layered": (JL.layered_density([-1e7, 0.0, 1e7], [0.5, 2.0]),
                        TL.layered_density([-1e7, 0.0, 1e7], [0.5, 2.0]))}


@pytest.mark.parametrize("case", ["plain", "expr", "callable", "layered",
                                  "wavelength"])
def test_isotropic(case, monkeypatch):
    A = 0.4 / (C_CODE * DT)
    kw = {"A": A, "n": 1.3}
    if case == "wavelength":
        kw = {"A": A * 1e-25, "n": 1.0, "wavelength_dep_scattering": True}
    if case in ("expr", "callable", "layered"):
        nj, nt = _n_fns()[case]
        sj = JL.ScatterIsotropicStep(A=A, variable_n=True, variable_n_fn=nj)
        st = TL.ScatterIsotropicStep(A=A, variable_n=True, variable_n_fn=nt)
    else:
        sj, st = _both("light.ScatterIsotropicStep", **kw)
    f = _fields(7)
    if case == "wavelength":
        f["E"] = (f["E"] * 1e-18).astype(np.float32)
    _compare(sj, st, f, monkeypatch)


_DEL = {
    "plain": {},
    "A_fn": {"A_fn": "pow(E[gid], -1.5)"},
    "A_fn-callable": {},
    "variable_n": {"variable_n": True},
    "implicit": {"implicit_capture": True, "measure_deposition": True},
    "roulette": {"implicit_capture": True, "roulette": (0.3, 0.9),
                 "measure_deposition": True},
    "stretch": {"stretch": 0.6, "stretch_dir": (1.0, 1.0, 0.0),
                "measure_deposition": True},
    "fluorescence": {"fluorescence": (0.7, 0.8), "fluorescence_edge": 1.0,
                     "measure_deposition": True},
    "deposition": {"measure_deposition": True},
}


@pytest.mark.parametrize("case", sorted(_DEL))
def test_delete(case, monkeypatch):
    A = 0.5 / (C_CODE * DT)
    kw = dict(_DEL[case])
    if case == "variable_n":
        nj, nt = _n_fns()["expr"]
        sj = JL.ScatterDeleteStep(1.0, A, variable_n_fn=nj, **kw)
        st = TL.ScatterDeleteStep(1.0, A, variable_n_fn=nt, **kw)
    elif case == "A_fn-callable":
        sj = JL.ScatterDeleteStep(1.0, A, A_fn=lambda E: 1.0 / (E * E))
        st = TL.ScatterDeleteStep(1.0, A, A_fn=lambda E: 1.0 / (E * E))
    else:
        sj, st = _both("light.ScatterDeleteStep", 1.0, A, **kw)
    ex = {}
    if case == "fluorescence":
        rng = np.random.default_rng(8)
        ex = {"stokes": rng.uniform(-0.5, 0.5, (3, C)),
              "pol_ref": rng.normal(size=(3, C)), "dose": rng.random(C)}
    _compare(sj, st, _fields(8, extras=ex), monkeypatch)


def test_delete_reference(monkeypatch):
    """The bridge-built absorber of the JAX package against the port's
    plain twin of it (one draw of C float32 uniforms)."""
    A = 0.5 / (C_CODE * DT)
    _compare(*_both("light.ScatterDeleteStepReference", 1.3, A),
             _fields(9), monkeypatch)


@pytest.mark.parametrize("case", ["directed", "v", "isotropic", "polarized",
                                  "sampler", "full"])
def test_emitter(case, monkeypatch):
    ex = {}
    n_sp = C - 512
    kw = {"E": 1.5, "r": (1.0, 2.0, 3.0)}
    if case == "v":
        kw["v"] = (0.0, C_CODE, 0.0)
    elif case == "isotropic":
        kw["isotropic"] = True
    elif case == "polarized":
        kw.update(stokes=(0.6, 0.0, 0.0), v=(0.0, 0.0, C_CODE))
        ex = {"stokes": np.ones((3, C)), "pol_ref": np.ones((3, C)),
              "dose": np.ones(C)}
    elif case == "full":
        n_sp = C - 50  # 64 do not fit: nothing is written
    sj, st = _both("light.PhotonEmitterStep", 64, **kw)
    if case == "sampler":
        # a deterministic callable: the energies do not come from the
        # replayed draws (the port's takes the generator)
        sj.E = lambda key, k: jnp.linspace(0.5, 2.0, k)
        st.E = lambda gen, k: torch.linspace(0.5, 2.0, k)
    out, _ = _compare(sj, st, _fields(10, n_spawned=n_sp, extras=ex),
                      monkeypatch)
    assert int(out.n_spawned) == (n_sp if case == "full" else n_sp + 64)


# -- light: measures -------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_sign(weighted, monkeypatch):
    _compare(*_both("light.ScatterSignMeasureStep", None, True,
                    weighted=weighted), _fields(11), monkeypatch)


@pytest.mark.parametrize("case", ["counts", "weighted", "sum", "list"])
def test_planes(case, monkeypatch):
    locs = [(0.0, np.nan, np.nan), (np.nan, 1e6, np.nan),
            (np.nan, np.nan, -2e5)]
    kw = {"weighted": case == "weighted",
          "measure_E": case in ("sum", "list"),
          "measure_E_mode": "sum" if case == "sum" else "list"}
    _compare(*_both("light.ScatterMeasureStep", None, True, locs, **kw),
             _fields(12), monkeypatch)


@pytest.mark.parametrize("weighted", [False, True])
def test_shell(weighted, monkeypatch):
    _compare(*_both("light.SphericalShellMeasureStep", None,
                    radius=3 * C_CODE * DT, center=(1e5, 0.0, 0.0),
                    weighted=weighted), _fields(13), monkeypatch)


@pytest.mark.parametrize("kw", [{}, {"trace_dv": True},
                                {"trace_dtype": "bfloat16"}])
def test_trace(kw, monkeypatch):
    _compare(*_both("light.TracePathMeasureStep", None, **kw),
             _fields(14), monkeypatch)


# -- user code -------------------------------------------------------------------

def _decay(xp):
    def fn(p):
        u = p.uniform()
        hit = (u < 0.3 * xp.exp(-p.t) * p.E) & p.alive
        return {"alive": ~hit, "dose": p.extras["dose"] + hit * p.E,
                "vx": p.vx * 0.5, "w": p.w * (1.0 + p.uniform())}
    return fn


def _moments(p):
    return {"E": p.E, "r2": p.rx * p.rx + p.ry * p.ry, "d": p.extras["dose"]}


def test_elementwise(monkeypatch):
    ex = {"dose": np.random.default_rng(15).random(C)}
    sj = J.ElementwiseStep(_decay(jnp), extras_write=("dose",))
    st = T.ElementwiseStep(_decay(torch), extras_write=("dose",))
    _compare(sj, st, _fields(15, extras=ex), monkeypatch)


def test_reduce(monkeypatch):
    ex = {"dose": np.random.default_rng(16).random(C)}
    sj, st = (P.ReduceMeasureStep(None, _moments, outputs=("E", "r2", "d"),
                                  measure_n=True, extras=("dose",))
              for P in (J, T))
    _compare(sj, st, _fields(16, extras=ex), monkeypatch)


def test_spectrum_and_mesh(monkeypatch):
    edges = np.linspace(0.5, 2.0, 7)
    for P_j, P_t in ((JL.SpectrumMeasureStep(None, edges, weighted=True),
                      TL.SpectrumMeasureStep(None, edges, weighted=True)),
                     (JL.MeshTallyStep(None, "y", np.linspace(-1e7, 1e7, 5),
                                       weighted=True),
                      TL.MeshTallyStep(None, "y", np.linspace(-1e7, 1e7, 5),
                                       weighted=True))):
        _compare(P_j, P_t, _fields(17), monkeypatch)


def _kick(xp, draw):
    def fn(state, ctx):
        u = draw(ctx, state)
        return state.replace(v=state.v * (1.0 - 1e-3 * u),
                             E=state.E - xp.mean(state.E) * 1e-3,
                             alive=state.alive & (u > 0.05))
    return fn


def test_kernelstep(monkeypatch):
    """A KernelStep that is not elementwise (a mean), draws from the
    context and records: the generic tier's route."""
    sj = JK.KernelStep(_kick(jnp, lambda ctx, s: jax.random.uniform(
        ctx.next_key(), s.E.shape, s.E.dtype)),
        record_fn=lambda s: {"E": jnp.sum(s.E), "n": s.n_alive})
    st = TK.KernelStep(_kick(torch, lambda ctx, s: ctx.uniform(
        s.E.shape, s.E.dtype)),
        record_fn=lambda s: {"E": s.E.sum(), "n": s.n_alive})
    _compare(sj, st, _fields(18), monkeypatch)


def test_kernelstep_elementwise_only_clears(monkeypatch):
    fn = lambda s, ctx: s.replace(alive=~s.alive)  # noqa: E731
    _compare(JK.KernelStep(fn, elementwise=True),
             TK.KernelStep(fn, elementwise=True), _fields(19), monkeypatch)


# -- population control ---------------------------------------------------------

_IMP = (lambda x, y, z: 2.0 ** jnp.floor(x / (2 * C_CODE * DT) + 0.5),
        lambda x, y, z: 2.0 ** torch.floor(x / (2 * C_CODE * DT) + 0.5))


@pytest.mark.parametrize("case", ["split", "split-roulette", "max-split",
                                  "clip", "window"])
def test_split(case, monkeypatch):
    n_sp = C - 1500 if case != "clip" else C - 40
    if case == "window":
        sj, st = _both("light.WeightWindowStep", 0.2, 0.8, max_split=4)
    else:
        kw = {"roulette": case == "split-roulette",
              "max_split": 2 if case == "max-split" else 8}
        sj = JL.ImportanceSplitStep(_IMP[0], **kw)
        st = TL.ImportanceSplitStep(_IMP[1], **kw)
    f = _fields(20, n_spawned=n_sp)
    f["alive"][n_sp:] = False  # the arena past the spawn mark is free
    out, _ = _compare(sj, st, f, monkeypatch)
    w_in = (f["w"] * f["alive"]).astype(np.float64).sum()
    w_out = out.w.double()[out.alive].sum().item()
    if case in ("split", "max-split", "clip"):  # no roulette: exact
        np.testing.assert_allclose(w_out, w_in, rtol=1e-5)
    assert int(out.n_spawned) > n_sp


def test_split_boundary(monkeypatch):
    """at="chunk": the boundary op against the snapshot, in both packages
    (the snapshot taken from the same positions)."""
    f = _fields(21, n_spawned=C - 1500)
    f["alive"][C - 1500:] = False
    sj = JL.ImportanceSplitStep(_IMP[0], at="chunk")
    st = TL.ImportanceSplitStep(_IMP[1], at="chunk")
    prev = _fields(22)["r"]
    sj._prev_r = jnp.asarray(prev)
    st._prev_r = torch.from_numpy(prev)
    _compare(sj, st, f, monkeypatch, boundary=True, setup=False)
    np.testing.assert_array_equal(st._prev_r.numpy(),
                                  np.asarray(sj._prev_r))
