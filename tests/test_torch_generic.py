"""The generic step tier end to end: the port against the JAX package.

* Deterministic plans (no draws: kinematics, the four boundaries, plane,
  shell and sign tallies, trace) run with ``fuse="off"`` in both packages
  and give byte-identical ``sim.ts``, equal records and trace rows, the same
  chunks with the same valid prefixes and the same final state, under a
  traced exit that fires mid-chunk, the extinction probe and a host-exact
  predicate. dt = 2**-10, so ``v * dt`` is exact and XLA's FMA contraction
  of ``r + v * dt`` cannot move a position; the box edges are off the
  ``c dt`` lattice.
* The Kahan clock of ``tests/test_clock.py`` on the device: byte-identical
  to the host's float32 replay and within one iteration of the exact
  crossing (a quarter-million iterations: slow, as in the JAX package).
* Every refusal the JAX prover shares falls back to the generic tier; a
  limit of the port's kernel and a step the generic tier lacks stop the
  run by name; a kernel build failure is never taken for a refusal.
* float64 on the generic tier (``tests/test_x64.py``'s checks).
* The main-path steps on the generic tier against the fused twin,
  statistically (5 sigma), in the pattern of ``tests/test_light_stats.py``.
"""

import warnings

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
from physicl_tpu_torch.kernels import KernelStep
from physicl_tpu_torch.ops.pipeline import FusedRefusal

C_LIGHT = 299792458.0
DT = 2.0 ** -10  # c dt is exact
C_DT = C_LIGHT * DT
L_BOX = 16.37 * C_DT
N = 2048
CHUNK = 16


class _Chunks:
    """A measure that keeps each chunk's valid length (both packages)."""

    def __init__(self, P):
        step = P.light.ScatterSignMeasureStep(None, True)
        lengths = []
        collect = step.collect

        def counting(sim, records):
            lengths.append(len(records["t"]))
            collect(sim, records)

        step.collect = counting
        self.step, self.lengths = step, lengths


def _photons(P, n, seed, beam=False):
    rng = np.random.default_rng(seed)
    if beam:
        r = np.stack([np.full(n, 0.2 * L_BOX),
                      *rng.uniform(0.1, 0.9, (2, n)) * L_BOX])
        v = np.array([1.0, 0.0, 0.0])[:, None] * C_LIGHT * np.ones(n)
        v[0] *= rng.choice([1.0, -1.0, 0.5], n)
        v = v / np.linalg.norm(v, axis=0) * C_LIGHT
    else:
        r = rng.uniform(0.1, 0.9, (3, n)) * L_BOX
        d = rng.normal(size=(3, n))
        v = d / np.linalg.norm(d, axis=0) * C_LIGHT
    return P.light.generate_photon_state(n, E=rng.uniform(0.5, 2.0, n),
                                         r=r, v=v)


def _plan(P, case):
    """(steps, data steps) of a deterministic plan."""
    mid = 0.5 * L_BOX
    box = ((0.0, L_BOX),) * 3
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             P.newton.NewtonianKinematicsStep()]
    if case == "traced":
        steps += [P.newton.ReflectingBoundaryStep(box),
                  P.light.ScatterMeasureStep(
                      None, True, [(0.31 * L_BOX, np.nan, np.nan),
                                   (np.nan, np.nan, 0.77 * L_BOX)]),
                  P.light.SphericalShellMeasureStep(
                      None, radius=0.383 * L_BOX, center=(mid, mid, mid)),
                  P.light.TracePathMeasureStep(None, trace_dv=True)]
    elif case == "extinction":
        steps += [P.newton.AbsorbingBoundaryStep(box),
                  P.light.ScatterMeasureStep(
                      None, True, [(0.61 * L_BOX, np.nan, np.nan)],
                      measure_E=True)]
    else:  # host-exact
        steps += [P.newton.PeriodicBoundaryStep(box),
                  P.newton.AbsorbingSphereStep(0.113 * L_BOX,
                                               center=(mid, mid, mid),
                                               kill_inside=True),
                  P.light.SphericalShellMeasureStep(
                      None, radius=0.31 * L_BOX, center=(mid, mid, mid),
                      weighted=True)]
    counter = _Chunks(P)
    steps.append(counter.step)
    return steps, counter


_EXITS = {
    "traced": lambda c: c.t >= 37.5 * DT,
    "extinction": lambda x: len(x.objects) == 0,
    "host-exact": lambda c: c.t >= 41.5 * DT or len(c.objects) < N // 2,
}
_TIERS = {"traced": "traced", "extinction": "extinction-probe",
          "host-exact": "host-exact"}


def _deterministic(P, case):
    kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
    s = P.Simulation(exit=_EXITS[case], seed=3, chunk_steps=CHUNK,
                     fuse="off", **kw)
    steps, counter = _plan(P, case)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    s.add_photons(_photons(P, N, 5, beam=case == "extinction"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s.start()
        s.join()
    return s, steps, counter


def _norm(x):
    """A data row as nested tuples of Python values, NaN as a marker, so
    that rows compare with ``==`` whatever their array types."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_norm(y) for y in x)
    if isinstance(x, (float, np.floating)) and np.isnan(x):
        return "nan"
    return x.item() if isinstance(x, np.generic) else x


def _rows_equal(a, b):
    assert _norm(a) == _norm(b)


@pytest.mark.parametrize("case", sorted(_EXITS))
def test_deterministic_plans_match_jax(case):
    js, jsteps, jc = _deterministic(J, case)
    ts, tsteps, tc = _deterministic(T, case)
    assert not js.used_fused and not ts.used_fused
    assert f"exit handling: {_TIERS[case]}" in ts.explain_plan()
    assert js.chunk_used == ts.chunk_used == (1 if case == "host-exact"
                                              else CHUNK)
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    # the same chunks with the same valid prefixes
    assert tc.lengths == jc.lengths and sum(tc.lengths) == len(ts.ts)
    if case == "traced":
        assert tc.lengths == [16, 16, 6]  # the exit fires mid-chunk
    for a, b in zip(tsteps, jsteps):
        if isinstance(a, T.light.TracePathMeasureStep):
            _, pj, aj, fj = b.as_arrays()
            _, pt, at, ft = a.as_arrays()
            np.testing.assert_array_equal(at, aj)
            np.testing.assert_array_equal(pt, pj)
            np.testing.assert_array_equal(ft, fj)
            assert len(a.data) == len(b.data) == 1 + N
            for ra, rb in zip(a.data[1:], b.data[1:]):
                _rows_equal(ra, rb)
        elif hasattr(a, "data"):
            assert len(a.data) == len(b.data) > 0
            for ra, rb in zip(a.data, b.data):
                _rows_equal(ra, rb)
    for f in ("r", "dr", "v", "dv", "E", "w", "alive", "otype", "t", "dt",
              "t_comp", "n_spawned"):
        np.testing.assert_array_equal(
            getattr(ts.sim_state, f).numpy(),
            np.asarray(jax.device_get(getattr(js.sim_state, f))), err_msg=f)


@pytest.mark.parametrize("case", ["traced", "extinction"])
def test_deterministic_plans_fused_equals_generic(case):
    """The same plans on the port's fused twin and its generic tier (the
    pattern of tests/test_measure.py and tests/test_boundaries.py): the
    same clock, records and trace rows (no draw, no contraction on either
    side)."""
    runs = []
    for fuse in ("auto", "off"):
        s = T.Simulation(exit=_EXITS[case], seed=3, chunk_steps=CHUNK,
                         fuse=fuse, device="cpu")
        steps, _ = _plan(T, case)
        for i, st in enumerate(steps):
            s.add_step(i, st)
        s.add_photons(_photons(T, N, 5, beam=case == "extinction"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            s.start()
            s.join()
        assert s.used_fused == (fuse == "auto")
        runs.append((s, steps))
    (fs, fsteps), (gs, gsteps) = runs
    assert (np.asarray(fs.ts, np.float64).tobytes()
            == np.asarray(gs.ts, np.float64).tobytes())
    for a, b in zip(fsteps, gsteps):
        if hasattr(a, "data"):
            assert len(a.data) == len(b.data) > 0
            for ra, rb in zip(a.data, b.data):
                _rows_equal(ra, rb)
    np.testing.assert_array_equal(fs.sim_state.alive.numpy(),
                                  gs.sim_state.alive.numpy())


def test_host_exact_predicate_over_objects_matches_jax():
    """A host-exact predicate that iterates ``sim.objects`` (materialized
    from the state every iteration), against the JAX package."""
    runs = []
    for P in (J, T):
        kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
        s = P.Simulation(
            exit=lambda x: all(o.r[0] > 0.5 * L_BOX for o in x.objects),
            seed=1, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        for i in range(12):
            s.add_obj(P.light.PhotonObject(
                E=np.double(1.0), v=np.array([C_LIGHT, 0.0, 0.0]),
                r=np.array([0.01 * i * L_BOX, 0.0, 0.0])))
        with pytest.warns(RuntimeWarning, match="host-exact"):
            s.start()
            s.join()
        runs.append(s)
    js, ts = runs
    assert ts.chunk_used == 1 and not ts.used_fused
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    objs = list(ts.objects)
    assert len(objs) == 12 and all(o.r[0] > 0.5 * L_BOX for o in objs)
    assert isinstance(objs[0], T.light.PhotonObject)


# -- the clock ----------------------------------------------------------------

def _kahan_f32(dt, n):
    """The float32 Kahan clock replayed on the host (numpy)."""
    f32 = np.float32
    t, comp, out = f32(0), f32(0), []
    for _ in range(n):
        y = f32(f32(dt) - comp)
        t_new = f32(t + y)
        comp = f32(f32(t_new - t) - y)
        t = t_new
        out.append(t)
    return out


def _crossing_f64(dt, T_end, n):
    acc = np.add.accumulate(np.full(n, dt, np.float64))
    return int(np.argmax(acc >= T_end)) + 1


def _clock_run(dt, T_end):
    s = T.Simulation(until_t=T_end, seed=0, chunk_steps=4096, fuse="off",
                     device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_photons(T.light.generate_photon_state(8, E=1.0))
    s.start()
    s.join()
    return s


def test_generic_kahan_clock():
    """The device clock (three tensor ops an iteration) is the host
    replay's float32 arithmetic bit for bit, and exits within one
    iteration of the exact f64 crossing of the float32-rounded dt, at a
    CPU-sized count (20,000 iterations)."""
    dt, T_end = 1e-6, 0.02
    s = _clock_run(dt, T_end)
    assert not s.used_fused
    want = _kahan_f32(dt, len(s.ts))
    assert (np.asarray(s.ts, np.float32).tobytes()
            == np.asarray(want, np.float32).tobytes())
    expected = _crossing_f64(float(np.float32(dt)), T_end, 40_000)
    assert abs(len(s.ts) - expected) <= 1
    assert s.ts[-1] >= T_end - 1e-6


@pytest.mark.slow
def test_generic_quarter_million_iterations_kahan_clock():
    s = _clock_run(1e-6, 0.25)
    assert not s.used_fused
    expected = _crossing_f64(float(np.float32(1e-6)), 0.25, 300_000)
    assert abs(len(s.ts) - expected) <= 1
    assert s.ts[-1] >= 0.25 - 1e-6


# -- fallback ------------------------------------------------------------------

def _base(dt_fn=lambda x: np.double(1e-3), n=512, **kw):
    s = T.Simulation(until_t=0.02, seed=0, device="cpu", **kw)
    s.add_step(0, T.UpdateTimeStep(dt_fn))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    return s


def _case(name):
    """A sim whose plan the prover refuses with code ``name`` (or the
    user's own fuse="off"), with the generic tier able to run it."""
    if name == "fuse-off":
        s = _base(fuse="off")
    elif name == "dt-fn-not-t-only":
        s = _base(lambda x: 1e-3 + 0 * x.n_objects)
    elif name == "exit-predicate":
        s = _base()
        s.exit = lambda c: c.t >= 0.02 and len(c.objects) > 0
    elif name == "kinematics-acceleration":
        s = _base()
        s.steps[1] = T.newton.NewtonianKinematicsStep(True)
    elif name == "lorentz-per-particle":
        # q and m in a bulk's extras planes, no object declaring them
        s = _base()
        s.add_step(2, T.newton.LorentzForceStep(B_field=(0, 0, 100.0)))
        bulk = T.newton.generate_particle_state(64, v=(1.0, 0.0, 0.0))
        bulk["extras"] = {"q": np.ones(64), "m": np.full(64, 2.0)}
        s.add_particles(bulk)
        return s
    elif name == "emitter-sampler":
        s = _base(capacity=32768)
        s.add_step(2, T.light.PhotonEmitterStep(
            8, E=lambda g, k: 1.0 + torch.rand(k, generator=g,
                                               device=g.device)))
    elif name == "unsupported-step":
        s = _base()
        s.add_step(2, KernelStep(lambda st, ctx: st.replace(
            E=st.E * (1 + 0.01 * ctx.uniform(st.E.shape)))))
    elif name == "dtype":
        s = _base(dtype=torch.float64)
    s.add_photons(T.light.generate_photon_state(512, E=1.0))
    return s


_FALLBACKS = ["fuse-off", "dt-fn-not-t-only", "exit-predicate",
              "kinematics-acceleration", "lorentz-per-particle",
              "emitter-sampler", "unsupported-step", "dtype"]


@pytest.mark.parametrize("name", _FALLBACKS)
def test_refusals_run_on_the_generic_tier(name):
    s = _case(name)
    text = s.explain_plan()
    if name == "fuse-off":
        assert "refused" not in text and "fusion not attempted" in text
    else:
        assert f"refused [{name}]" in text
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        s._run_impl()
    warned = [w for w in record if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == (0 if name == "fuse-off" else 1)
    if name == "exit-predicate":
        assert "host-exact" in str(warned[0].message)
    elif warned:
        assert f"refused [{name}]" in str(warned[0].message)
    assert not s.used_fused and abs(len(s.ts) - 20) <= 1
    assert s.sim_state.r.device.type == "cpu"
    if name == "dtype":
        assert s.sim_state.r.dtype == torch.float64
    if name == "lorentz-per-particle":
        v = s.sim_state.v[:, :64]
        np.testing.assert_allclose(torch.linalg.norm(v, dim=0).numpy(), 1.0,
                                   rtol=1e-6)
        assert (v[1] != 0).all()  # q/m = 0.5 turned every particle


class _NoApply(T.Step):
    """A step that declares it has no generic-tier apply."""

    generic_missing = "a test step without apply"


def test_missing_generic_apply_stops_by_name():
    """A step without apply and a dt the prover refuses: the run falls
    back, and stops on the step the generic tier lacks; explain_plan shows
    both. Every step of the port has its apply: a test step declares it has
    none."""
    s = _base(lambda x: 1e-3 + 0 * x.n_objects)
    s.add_step(2, _NoApply())
    s.add_photons(T.light.generate_photon_state(64, E=1.0))
    text = s.explain_plan()
    assert "refused [dt-fn-not-t-only]" in text
    assert "lacks _NoApply.apply" in text
    assert "a test step without apply" in text
    with pytest.raises(FusedRefusal, match="a test step without apply") as e:
        s._run_impl()
    assert isinstance(e.value, NotImplementedError)
    s = _base(fuse="off")
    s.add_step(2, _NoApply())
    s.add_photons(T.light.generate_photon_state(64, E=1.0))
    with pytest.raises(NotImplementedError,
                       match="_NoApply.apply.*a test step without apply"):
        s._run_impl()


def test_kernel_limits_do_not_fall_back():
    """A refusal code that only the port's kernel has is raised on
    fuse="auto", with no fallback and no warning; every code the JAX
    prover returns (read from its source) falls back. fuse="off" runs the
    refused plan on the generic tier."""
    import inspect
    import re

    from physicl_tpu.ops import pipeline as JP
    from physicl_tpu_torch.ops import pipeline as TP
    from physicl_tpu_torch.ops.pipeline import is_kernel_limit

    literal = r'_no\(\s*"([a-z0-9-]+)"'
    jax_codes = set(re.findall(literal, inspect.getsource(JP)))
    reasons = set(re.findall(r'return \("([a-z-]+)"',
                             inspect.getsource(JP)))
    assert len(jax_codes) >= 15 and len(reasons) >= 8
    assert not any(is_kernel_limit(c) for c in jax_codes)
    assert not any(is_kernel_limit(f"{p}-{r}") for r in reasons
                   for p in ("elementwise", "reduce", "kernelstep"))
    port_codes = set(re.findall(literal, inspect.getsource(TP)))
    assert {c for c in port_codes
            if not is_kernel_limit(c)} == (jax_codes & port_codes) | {"dtype"}
    for code in ("field-expr-unsupported", "field-fn-callable",
                 "elementwise-op-unsupported", "reduce-op-unsupported",
                 "kernelstep-op-unsupported"):
        assert is_kernel_limit(code), code
    # lifted: the kernel evaluates a recorded inverse CDF, a voxel grid
    # past its int32 index falls back with the JAX prover's code, each
    # plan's user programs are compiled for it, of any length, and so are
    # its fields, into a Plan sized for its ops, planes and fields
    for code in ("phase-icdf-callable", "voxel-grid-size",
                 "user-program-size", "user-program-regs", "op-count",
                 "cross-planes", "field-count", "field-expr-length"):
        assert code not in port_codes, code
    assert "user-program" not in inspect.getsource(TP)
    assert not is_kernel_limit("field-fn-gather")
    # a string construct outside the field IR (an integer floor division
    # by a value that may be 0, which the reference evaluates)
    for fuse in ("auto", "off"):
        s = _base(fuse=fuse)
        s.add_step(2, T.light.ScatterIsotropicStep(
            A=1.0, variable_n=True,
            variable_n_fn="(((r0[gid] > 0) * 3) // ((r1[gid] > 0) * 1)) "
                          "+ 1.0"))
        s.add_photons(T.light.generate_photon_state(64, E=1.0))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            if fuse == "off":  # the generic tier evaluates the field
                with pytest.raises(NotImplementedError,
                                   match="integer floor division"):
                    s._run_impl()
                assert not s.used_fused
                continue
            with pytest.raises(FusedRefusal,
                               match=r"field-expr-unsupported.*a limit of "
                                     r"the port's fused_transport kernel"):
                s._run_impl()
        assert s.plan_report.mode == "unsupported"
        assert "Simulation(fuse='off') runs the plan" in s.explain_plan()


def _modulo_sim(P, fuse):
    """A modulo density (the field IR once refused it) under implicit
    capture, which draws nothing: the deterministic plan of this file's
    first tests with a ScatterDeleteStep reading ``r0 % 2 + 1``."""
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=40 * DT * 0.9999, seed=0, chunk_steps=CHUNK,
                     fuse=fuse, auto_shrink=False, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterDeleteStep(
        1.0, 0.01 / C_DT, variable_n=True,
        variable_n_fn="r0[gid] % 2.0 + 1.0", implicit_capture=True))
    m = P.light.ScatterSignMeasureStep(None, True, weighted=True)
    s.add_step(3, m)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(3, 512))
    s.add_photons(P.light.generate_photon_state(
        512, E=1.0, r=rng.uniform(0, 8, (3, 512)) * C_DT,
        v=d / np.linalg.norm(d, axis=0) * C_LIGHT))
    return s, m


@pytest.mark.parametrize("fuse", ["auto", "off"])
def test_modulo_field_runs_on_both_tiers(fuse):
    """``r0[gid] % 2.0 + 1.0``, refused on both tiers before jnp's
    remainder joined the field IR, runs on each and matches the JAX
    package on the same tier: sim.ts equal, the weighted sign rows within
    rtol 1e-5, the weights within 1e-5 of their largest."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts, tm = _modulo_sim(T, fuse)
        ts.start()
        ts.join()
    assert ts.used_fused == (fuse == "auto")
    js, jm = _modulo_sim(J, fuse)
    js.start()
    js.join()
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    np.testing.assert_allclose(np.asarray(tm.data), np.asarray(jm.data),
                               rtol=1e-5, atol=0)
    w_t, w_j = ts.sim_state.w.numpy(), np.asarray(js.sim_state.w)
    assert float(np.abs(w_t - w_j).max()) <= 1e-5 * float(w_j.max())
    assert float(w_j.min()) < 0.9  # the field attenuated the weights


def _ninety_terms(P, n=1024):
    """A 90-term density (past the former 256-instruction program) on a
    scattering run with a sign tally."""
    kw = {"device": "cpu"} if P is T else {}
    c_dt = float(P.light.c) * 1e-3
    s = P.Simulation(until_t=0.0315, seed=2, auto_shrink=False, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(
        A=0.002 / (180 * c_dt * c_dt), variable_n=True,
        variable_n_fn=" + ".join(["r0[gid] * 2.0"] * 90)))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    s.add_photons(P.light.generate_photon_state(
        n, E=1.0, r=np.random.default_rng(3).uniform(1, 2, (3, n)) * c_dt))
    return s, m


def test_former_length_limit_fuses_and_matches_jax():
    """The 90-term expression the kernel once refused (field-expr-length)
    fuses with no warning and matches the JAX package: sim.ts and the sign
    rows equal, the alive plane equal, the live planes within 1e-4 of each
    plane's max."""
    runs = []
    for P in (J, T):
        s, m = _ninety_terms(P)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            s.start()
            s.join()
        assert s.used_fused
        runs.append((s, m))
    (js, jm), (ts, tm) = runs
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) > 0
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_array_equal(a, b)
    live = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), live)
    for nm in ("r", "v", "E", "w"):
        want = np.asarray(getattr(js.sim_state, nm))[..., live]
        got = getattr(ts.sim_state, nm).numpy()[..., live]
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            assert float(np.abs(g - w).max(initial=0.0)) <= 1e-4 * scale, nm


def test_kernel_build_failure_does_not_fall_back(monkeypatch):
    """Only a prover refusal reaches the generic tier: a kernel that fails
    to build or launch propagates from the dispatch."""
    from physicl_tpu_torch.ops import fused as F

    def broken(*a, **k):
        raise RuntimeError("nvcc: fused_transport.cu failed to build")

    monkeypatch.setattr(F, "fused_chunk", broken)
    s = _base()
    s.add_photons(T.light.generate_photon_state(64, E=1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="failed to build"):
            s._run_impl()
    assert s.used_fused and s.plan_report.mode == "fused"


def test_explain_plan_leaves_the_run_stream_alone():
    """The dry pass of explain_plan (its probe iteration included) plans on
    a state and generator of its own: a run after it draws exactly what a
    run without it draws."""
    rows = []
    for explain in (False, True):
        s = T.Simulation(until_t=0.0095, seed=4, fuse="off", device="cpu")
        s.add_step(0, T.UpdateTimeStep(lambda x: np.double(1e-3)))
        s.add_step(1, T.newton.NewtonianKinematicsStep())
        s.add_step(2, T.light.ScatterIsotropicStep(A=0.3 / (C_LIGHT * 1e-3),
                                                   n=1.0))
        m = T.light.ScatterSignMeasureStep(None, True)
        s.add_step(3, m)
        s.add_photons(T.light.generate_photon_state(2048, E=1.0))
        if explain:
            assert "execution mode: generic (chunk=1024" in s.explain_plan()
        s.start()
        s.join()
        rows.append(np.asarray(m.data))
        # the snapshot's generator is the run's own (documented)
        assert s.sim_state.key is not None
    np.testing.assert_array_equal(rows[0], rows[1])


# -- float64 (tests/test_x64.py) ----------------------------------------------

def test_float64_generic_tier():
    s = T.Simulation(exit=lambda c: c.t >= 0.005, seed=0, fuse="off",
                     dtype=torch.float64, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    meas = T.light.ScatterMeasureStep(None, True,
                                      [[2.5 * C_LIGHT * 1e-3, np.nan,
                                        np.nan]])
    s.add_step(2, meas)
    s.add_photons(T.light.generate_photon_state(100, E=1.0))
    s.start()
    s.join()
    assert s.sim_state.r.dtype == torch.float64
    assert s.sim_state.t.dtype == torch.float64
    r = float(s.sim_state.r[0, 0])
    assert abs(r - 5 * C_LIGHT * 1e-3) < 1e-6  # far below f32 resolution
    assert [int(row[2]) for row in meas.data] == [0, 0, 100, 0, 0]

    # the exponential transform and an importance split in float64: the
    # weight law per photon, split factors exact
    s = T.Simulation(until_t=0.01 * 0.9999, seed=1, fuse="off",
                     dtype=torch.float64, capacity=65536, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.1 / (C_LIGHT * 1e-3)), stretch=0.8))
    s.add_step(3, T.light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** torch.floor(x / (4 * C_LIGHT * 1e-3) + 0.5),
        roulette=False))
    s.add_photons(T.light.generate_photon_state(2000, E=1.0))
    s.start()
    s.join()
    st = s.sim_state
    assert st.w.dtype == torch.float64
    w, alive = st.w.numpy(), st.alive.numpy()
    k = len(s.ts)
    wl = ((1 - 0.1) / (1 - 0.1 * 0.2)) ** k
    ws = np.unique(np.round(np.log2(w[alive] / wl)))
    assert np.allclose(ws, np.round(ws))
    exp_w = 2000 * (1 - 0.1) ** k
    assert abs(w[alive].sum() - exp_w) / exp_w < 0.05


# -- the main path's steps, generic against the fused twin ---------------------

def _stats_run(fuse, kind, seed):
    n = 16384
    p = 0.02
    s = T.Simulation(until_t=40 * 1e-3 * 0.9999, seed=seed, fuse=fuse,
                     chunk_steps=40, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    A = p / (C_LIGHT * 1e-3)
    if kind == "iso":
        s.add_step(2, T.light.ScatterIsotropicStep(A=A, n=1.0))
    else:
        s.add_step(2, T.light.ScatterDeleteStep(1.0, A))
    m = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    s.add_photons(T.light.generate_photon_state(n, E=1.0))
    s.start()
    s.join()
    assert s.used_fused == (fuse == "auto")
    return np.asarray(m.data, np.float64), n, p


@pytest.mark.parametrize("kind", ["iso", "del"])
def test_main_path_steps_generic_against_fused(kind):
    """Absorption: the alive count follows N (1 - p)^k on both tiers
    (binomial 5 sigma at every iteration). Isotropic scatter: a +x beam's
    +y count grows as the scattered fraction 1 - (1 - p)^k times 1/2 (the
    angle-uniform resample: sin theta sin phi > 0 half the time)."""
    for fuse, seed in (("off", 1), ("auto", 2)):
        data, n, p = _stats_run(fuse, kind, seed)
        k = np.arange(1, len(data) + 1)
        q = (1 - p) ** k
        if kind == "del":
            got, mean, var = data[:, 1], n * q, n * q * (1 - q)
        else:
            pp = 0.5 * (1 - q)
            got, mean, var = data[:, 3], n * pp, n * pp * (1 - pp)
        z = np.abs(got - mean) / np.sqrt(var)
        assert z.max() < 5, (fuse, z.max())
