"""User code on the fused tier (kernel 1i): ``ElementwiseStep``,
``ReduceMeasureStep`` and ``KernelStep(elementwise=True)``, held against the
JAX package on the CPU.

Both packages run the same ``Simulation`` (seed, steps, initial particles;
the callables written once in torch and once in jnp). The JAX package traces
its callables into its emulated chunk; the port records the torch callables
into register programs (``physicl_tpu_torch.ops.record``) that its twin
runs. Both draw from the same counter hash in the same order, so ``sim.ts``,
the int records and the ``alive`` planes are equal, the float planes agree
within 1e-5 of each plane's largest value and the float records within
rtol 1e-5 (XLA contracts multiply-adds into FMAs and computes
transcendentals with its own polynomials). The JAX side runs with
``auto_shrink=False`` on both sides (a shrink would reorder the slots
the final planes are compared by).

Three cases sit past the limits the port's interpreter once had (48
registers, 64 draws, 1024 instructions a plan): each plan's programs are
compiled for it now (``ops/codegen.py``), so they fuse as in JAX.

The rest holds the recorded program against a direct call of the torch
callable, the refusal codes against the JAX prover's, and the draw order.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.special  # noqa: F401

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.kernels import KernelStep as JKernelStep
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.kernels import KernelStep as TKernelStep
from physicl_tpu_torch.ops import record as RC
from physicl_tpu_torch.ops.pipeline import FusedRefusal, is_kernel_limit

DT = 1e-3
RTOL = 1e-5
K = 40


def _np(P):
    return torch if P is T else jnp


def _photons(P, n, seed, extras=None, E=None):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    c = float(P.light.c)
    bulk = P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n) if E is None else E,
        r=rng.normal(size=(3, n)) * 30 * c * DT,
        v=d / np.linalg.norm(d, axis=0) * c, w=rng.uniform(0.5, 1.0, n))
    if extras:
        bulk["extras"] = extras
    return bulk


def _sim(P, until_iters=K, chunk=16, seed=7):
    kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
    return P.Simulation(until_t=DT * until_iters * 0.9999, seed=seed,
                        chunk_steps=chunk, **kw)


def _build(P, case):
    """(sim, the steps whose data rows compare) of one case on package P."""
    xp = _np(P)
    c = float(P.light.c)
    N, L = P.newton, P.light
    KS = TKernelStep if P is T else JKernelStep
    s = _sim(P)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             N.NewtonianKinematicsStep()]
    measures = []
    if case == "user-path":
        # the user path of chip_smoke.py at 2048 photons: drag, a decay with
        # a draw, t, dt and a written-back dose, the moments tally
        def drag(state, ctx):
            return state.replace(v=state.v * (1.0 - 1e-3))

        def decay(p):
            u = p.uniform()
            hit = (u < 10.0 * xp.exp(-p.t) * p.dt) & p.alive
            return {"alive": ~hit, "dose": p.extras["dose"] + hit * p.E}

        def moments(p):
            r2 = p.rx ** 2 + p.ry ** 2 + p.rz ** 2
            return {"E_total": p.E, "r2": r2, "dose": p.extras["dose"]}

        red = P.ReduceMeasureStep(None, moments,
                                  outputs=("E_total", "r2", "dose"),
                                  measure_n=True, extras=("dose",))
        steps += [L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  KS(drag, elementwise=True),
                  P.ElementwiseStep(decay, extras_write=("dose",)), red]
        measures.append(red)
        s.add_photons(_photons(P, 2048, 1,
                               {"dose": np.zeros(2048, np.float32)}))
    elif case == "extras-3row":
        # a 3-row extras plane read and written, a 1-row one written, both
        # before the UpdateTimeStep (t and dt of the previous iteration)
        def spin(p):
            sx, sy, sz = p.extras["spin"]
            norm = xp.sqrt(sx * sx + sy * sy + sz * sz)
            hit = (p.uniform() < 0.05) & p.alive
            return {"spin": (sy / norm, -sx / norm, sz * 0.99),
                    "dose": p.extras["dose"] + xp.where(hit, p.E, 0.0),
                    "alive": ~hit, "E": p.E * (1.0 - p.t * 0.01)}

        steps = [P.ElementwiseStep(spin, extras=("spin",),
                                   extras_write=("dose", "spin"))] + steps
        rng = np.random.default_rng(5)
        s.add_photons(_photons(P, 1500, 2, {
            "spin": rng.uniform(-0.5, 0.5, (3, 1500)),
            "dose": np.zeros(1500)}))
    elif case == "kstate-mixed":
        # a KernelStep reading otype on a photon/charge population
        def fn(state, ctx):
            ph = (state.otype == 1).astype(jnp.float32) if P is J else \
                (state.otype == 1).to(torch.float32)
            return state.replace(v=state.v * (1.0 - 1e-4 * (1.0 - ph)),
                                 w=state.w * (1.0 + 0.01 * ph))

        sign = L.ScatterSignMeasureStep(None, True)
        steps += [N.LorentzForceStep(B_field=(0.0, 0.0, 100.0),
                                     q_over_m=1.0),
                  L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  KS(fn, elementwise=True), sign]
        measures.append(sign)
        s.add_photons(_photons(P, 1200, 3))
        rng = np.random.default_rng(4)
        d = rng.normal(size=(3, 400))
        s.add_particles(N.generate_particle_state(
            400, v=d / np.linalg.norm(d, axis=0) * c / 3,
            r=rng.normal(size=(3, 400)) * c * DT))
    elif case == "reduce-weighted":
        # run_all.py:494-505's weighted tally under implicit capture and
        # roulette
        red = P.ReduceMeasureStep(None, lambda p: {"W": p.w}, outputs=("W",),
                                  measure_n=True)
        steps += [L.ScatterDeleteStep(np.double(1.0),
                                      np.double(0.05 / (c * DT)),
                                      implicit_capture=True,
                                      roulette=(0.6, 0.8)), red]
        measures.append(red)
        s.add_photons(_photons(P, 3000, 6))
    elif case == "fluor-callable":
        # examples/make_fluorescence_nb.py:57: A(E) a callable
        def A_fn(E):
            return (xp.float32(20.0) / E) ** 3 if P is J else \
                (torch.tensor(20.0) / E) ** 3

        dep = L.ScatterDeleteStep(n=1.0, A=0.05 / (c * DT), A_fn=A_fn,
                                  fluorescence=(0.34, 6.40),
                                  fluorescence_edge=7.11,
                                  measure_deposition=True)
        red = P.ReduceMeasureStep(None, lambda p: {"src": p.E == 20.0,
                                                   "ka": p.E == 6.40},
                                  outputs=("src", "ka"))
        steps += [dep, red]
        measures += [dep, red]
        s.add_photons(_photons(P, 2000, 8, E=20.0))
    elif case == "elementwise-atan2":
        # once refused as elementwise-op-unsupported: the azimuth of v
        # weighted into the dose plane (no feedback between iterations)
        sign = L.ScatterSignMeasureStep(None, True)
        steps += [L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  P.ElementwiseStep(lambda p: {
                      "dose": p.extras["dose"]
                      + xp.arctan2(p.vy, p.vx) * p.E},
                      extras_write=("dose",)), sign]
        measures.append(sign)
        s.add_photons(_photons(P, 2048, 11,
                               {"dose": np.zeros(2048, np.float32)}))
    elif case == "reduce-erf":
        # once refused as reduce-op-unsupported
        erf = torch.erf if P is T else jax.scipy.special.erf
        red = P.ReduceMeasureStep(None, lambda p: {"x": erf(p.E - 1.0)},
                                  outputs=("x",), measure_n=True)
        steps += [L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  L.ScatterDeleteStep(1.0, 0.01 / (c * DT)), red]
        measures.append(red)
        s.add_photons(_photons(P, 2048, 12))
    elif case in _PAST_LIMITS:
        # the result in the dose plane (no feedback between iterations)
        sign = L.ScatterSignMeasureStep(None, True)
        steps += [L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  P.ElementwiseStep(_PAST_LIMITS[case],
                                    extras_write=("dose",)), sign]
        measures.append(sign)
        s.add_photons(_photons(P, 1024, 10,
                               {"dose": np.zeros(1024, np.float32)}))
    elif case == "draw-unused":
        # u1 and u2 are drawn and never used: u3 is the op's third draw
        def fn(p):
            p.uniform()
            p.uniform()
            u3 = p.uniform()
            return {"alive": ~((u3 < 0.02) & (p.E > 0.8))}

        sign = L.ScatterSignMeasureStep(None, True)
        steps += [L.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0),
                  P.ElementwiseStep(fn), sign]
        measures.append(sign)
        s.add_photons(_photons(P, 2500, 9))
    else:
        raise KeyError(case)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    return s, measures


def _many_live(p):
    """60 values live at once (computed before any is summed)."""
    vals = [p.E * (i + 1.5) for i in range(60)]
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    return {"dose": total / 1860.0}


def _draws_70(p):
    return {"dose": sum(p.uniform() for _ in range(70))}


def _long_chain(p):
    """A program of over 1200 instructions: x / 2 + k E, 600 times (the
    halving is exact, so an FMA of it rounds as the product and sum do)."""
    x = p.w
    for i in range(600):
        x = x * 0.5 + p.E * float(i % 5 + 1)
    return {"dose": x}


# past the port's former kernel limits: registers, draws, instructions
_PAST_LIMITS = {"past-48-registers": _many_live, "70-draws": _draws_70,
                "past-1024-instructions": _long_chain}


def _state_np(P, s):
    st = s.sim_state
    if P is T:
        out = {k: getattr(st, k).numpy() for k in ("r", "v", "E", "w",
                                                   "alive")}
        out.update({f"x:{k}": v.numpy() for k, v in st.extras.items()})
    else:
        out = {k: np.asarray(getattr(st, k)) for k in ("r", "v", "E", "w",
                                                       "alive")}
        out.update({f"x:{k}": np.asarray(v) for k, v in st.extras.items()})
    return out


def _run(P, case):
    s, measures = _build(P, case)
    s.start()
    s.join()
    assert s.used_fused, f"{P.__name__} {case}: not fused"
    return s, [np.asarray(m.data, np.float64) for m in measures]


@pytest.mark.parametrize("case", ["user-path", "extras-3row", "kstate-mixed",
                                  "reduce-weighted", "fluor-callable",
                                  "draw-unused", "elementwise-atan2",
                                  "reduce-erf", *_PAST_LIMITS])
def test_user_code_matches_jax(case):
    js, jrows = _run(J, case)
    ts, trows = _run(T, case)
    assert np.array_equal(np.asarray(js.ts, np.float32),
                          np.asarray(ts.ts, np.float32))
    for jr, tr in zip(jrows, trows):
        assert jr.shape == tr.shape
        # int columns (n) exact; float sums within rtol
        np.testing.assert_allclose(tr, jr, rtol=RTOL, atol=1e-6)
    jst, tst = _state_np(J, js), _state_np(T, ts)
    assert np.array_equal(jst["alive"], tst["alive"])
    live = jst["alive"]
    for k in jst:
        if k == "alive":
            continue
        a, b = jst[k][..., live], tst[k][..., live]
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, k


def test_user_plan_uses_the_user_instantiation():
    s, _ = _build(T, "user-path")
    s.explain_plan()
    text = s.explain_plan()
    assert "kernel writes back: dose" in text
    assert "const-norm |dr| = c*dt: off" in text  # custom rescales speeds
    state = s._init_run_state()
    steps = s._ordered_steps()
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    plan = try_build_fused(s, steps, state).plan
    assert [op.kind for op in plan.ops] == ["kin", "iso", "kstate",
                                           "custom", "reduce"]
    assert plan.has_user and not plan.has_pol
    assert plan.extras == ("dose",) and plan.extras_writeback == ("dose",)
    # the plan's form library compiles its three programs in
    # (ops/codegen.py), each the body of its op's Form::user
    from physicl_tpu_torch.ops import codegen as CG

    src = CG.form_source(plan)
    assert "#define PHYSICL_FORM 1\n" in src
    assert CG.plan_form(plan)["kExtras"] == 1
    assert [i for i, _ in CG.user_ops(plan)] == [2, 3, 4]
    for i in (2, 3, 4):
        assert (f"void user_op_{i}(" in src
                and f"std::integral_constant<int, {i}>" in src)


def test_programs_past_the_former_limits():
    """The three cases above record past the interpreter's old limits: 60
    live values (48 registers), 70 draws (64; the placeholder is sized to
    the callable, each draw at its own index) and over 1200 instructions
    (1024 a plan)."""
    many = RC.record_particle_fn(_many_live, "ElementwiseStep",
                                 (("dose", 15, 1),), writable=("dose",))
    assert many.n_regs >= 60
    draws = RC.record_particle_fn(_draws_70, "ElementwiseStep",
                                  (("dose", 15, 1),), writable=("dose",))
    unifs = [y for code, *_, y, _ in draws.ins if code == RC.U_UNIF]
    assert draws.n_draws == 70 and unifs == list(range(70))
    chain = RC.record_particle_fn(_long_chain, "ElementwiseStep",
                                  (("dose", 15, 1),), writable=("dose",))
    assert len(chain.ins) > 1200


# -- the recorded program against a direct call ------------------------------


def _view(n, seed, extras=()):
    rng = np.random.default_rng(seed)
    f = {name: torch.from_numpy(rng.uniform(0.2, 3.0, n).astype(np.float32))
         for name in T.ParticleView._FIELDS}
    f["alive"] = torch.from_numpy(rng.uniform(size=n) < 0.8)
    f["vx"] = f["vx"] - 1.6  # both signs
    ex = {name: torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32))
          for name in extras}
    draws = torch.from_numpy(rng.uniform(size=(4, n)).astype(np.float32))
    return f, ex, draws


def _program_values(fn, names, extras=(), n=4096, seed=0):
    """The per-particle values the recorded program computes for each
    output (through a store into a scratch plane), and the direct call's."""
    from physicl_tpu_torch.ops import fused as F

    f, ex, draws = _view(n, seed, extras)
    t = torch.tensor(0.3125, dtype=torch.float32)
    dt = torch.tensor(0.0625, dtype=torch.float32)
    it = iter(draws)
    direct = fn(T.ParticleView(f, t, dt, lambda: next(it), extras=ex))
    # each output written to its own scratch extras plane
    ve = tuple((name, 15 + i, 1) for i, name in enumerate(extras))
    scratch = tuple((f"o{j}", 15 + len(extras) + j, 1)
                    for j in range(len(names)))

    def as_update(p):
        out = fn(p)
        return {f"o{j}": out[name] for j, name in enumerate(names)}

    prog = RC.record_particle_fn(as_update, "ElementwiseStep", ve + scratch,
                                 writable=tuple(s[0] for s in scratch))
    planes = [f[name].to(torch.float32) for name in T.ParticleView._FIELDS]
    planes += [ex[name] for name in extras]
    planes += [torch.full((n,), np.nan) for _ in names]
    rng = F._HashRng(0, 0, torch.zeros(n, dtype=torch.int64))
    rng.uniform_at = lambda i: draws[i - 1]
    RC.run_user_program(prog, planes, f["alive"], t, dt, rng)
    got = {name: planes[15 + len(extras) + j] for j, name in enumerate(names)}
    return {k: torch.as_tensor(direct[k]).to(torch.float32).expand(n)
            for k in names}, got


def test_program_matches_direct_call_bitwise():
    """+ - * /, sqrt, compares, where and logic: the program and torch give
    the same bits."""
    def fn(p):
        a = (p.rx * p.ry - p.rz) / (p.E + 0.5)
        b = (p.w * 3.0) + 1.0 / p.dvx - (2.5 - p.vy)
        m = ((p.vx > 0) & (p.E <= 1.7)) | ~p.alive ^ (p.drx >= p.dry)
        u = p.uniform()
        return {"a": a, "b": b, "m": m, "sel": torch.where(m, a, b),
                "sel0": torch.where(p.vx < 0, p.E, 0.0),
                "clamp": torch.clamp(p.drz - 1.5, -0.5, 0.5),
                "mix": m * p.E + (u < 0.5) * 1.0,
                "mx": torch.maximum(p.rx, p.ry) - torch.minimum(p.rz, p.E),
                "sq": p.E ** 2 * p.w ** 3 / (p.rx ** -1),
                "t": p.t * p.dt + p.E / p.dt, "abs": (p.vx * p.vz).abs(),
                "neg": -p.ry, "fl": torch.floor(p.rx * 3) + torch.ceil(p.ry)}

    names = ("a", "b", "m", "sel", "sel0", "clamp", "mix", "mx", "sq", "t",
             "abs", "neg", "fl")
    direct, got = _program_values(fn, names)
    for k in names:
        assert torch.equal(got[k], direct[k]), k


def _ulps(a, b):
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def test_program_matches_direct_call_within_2_ulp():
    """exp, log, sin, cos and pow: within 2 ulp of torch's own; and sqrt,
    which the program rounds correctly, as the kernel's sqrtf, while
    torch's vectorised float32 sqrt on the CPU misses by an ulp on ~0.5% of
    inputs."""
    def fn(p):
        return {"exp": torch.exp(-p.E * p.t), "log": torch.log(p.w + 0.1),
                "sqrt": torch.sqrt(p.w * 3.0),
                "sin": torch.sin(p.rx * 2.0), "cos": torch.cos(p.ry - p.rz),
                "pow": p.E ** 2.5, "pow4": p.w ** 4,
                "ipow-neg": p.rz ** -3, "log10": torch.log10(p.E)}

    names = ("exp", "log", "sqrt", "sin", "cos", "pow", "pow4",
             "ipow-neg", "log10")
    direct, got = _program_values(fn, names)
    for k in names:
        assert _ulps(got[k], direct[k]) <= 2, k


def test_component_axis_ops_record():
    """The facade's 3-row values: index, unbind, stack, sum(0) and
    linalg.norm(dim=0) are per particle."""
    def fn(state, ctx):
        vx, vy, vz = state.v.unbind(0)
        speed = torch.linalg.norm(state.v, dim=0)
        e = (state.v * state.v).sum(0)
        return state.replace(v=torch.stack([vy, -vx, vz]) / speed,
                             E=e + state.r[0], w=state.w * speed)

    prog = RC.record_kernelstep(fn)
    stores = sorted(prog.stores())
    assert stores == [6, 7, 8, 12, 14]
    assert prog.n_draws == 0


def _three_draws(p):
    p.uniform()
    p.uniform()
    return {"alive": p.uniform() < 0.5}


def test_unused_draw_shifts_later_draws():
    """A draw made but never used still counts (the JAX order): the third
    p.uniform() is the op's draw 2, and the op takes three draws."""
    prog = RC.record_particle_fn(_three_draws, "ElementwiseStep")
    unifs = [y for code, *_, y, _ in prog.ins if code == RC.U_UNIF]
    assert unifs == [2] and prog.n_draws == 3


# -- refusals ---------------------------------------------------------------


def _code_T(s):
    m = re.search(r"refused \[([\w-]+)\]", s.explain_plan())
    return m.group(1) if m else None


def _code_J(s):
    """The JAX prover's first refusal (its explain_plan would also build
    the generic scan, which raises on some of these fns)."""
    from physicl_tpu.ops.pipeline import try_build_fused

    report = []
    try_build_fused(s, s._ordered_steps(), s._init_run_state(), report)
    return report[0][0] if report else None


def _refusing(P, make):
    s = _sim(P)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, make(P))
    s.add_photons(_photons(P, 64, 0, {"dose": np.zeros(64)}))
    return s


def _ew(fn_t, fn_j=None, **kw):
    return lambda P: P.ElementwiseStep(fn_t if P is T else (fn_j or fn_t),
                                       **kw)


def _red(fn_t, fn_j=None, outputs=("x",), **kw):
    return lambda P: P.ReduceMeasureStep(
        None, fn_t if P is T else (fn_j or fn_t), outputs=outputs, **kw)


def _ks(fn_t, fn_j=None, **kw):
    return lambda P: (TKernelStep if P is T else JKernelStep)(
        fn_t if P is T else (fn_j or fn_t), elementwise=True, **kw)


def _branchy(p):
    if (p.E > 1.0).any():
        return {"E": p.E * 2}
    return {"E": p.E}


# case -> (the port's code, the JAX prover's code or None where the JAX
# package has none: it fuses, or fails later when it traces the kernel)
_REFUSALS = {
    "elementwise-not-elementwise-mean": (
        _ew(lambda p: {"E": p.E - p.E.mean()},
            lambda p: {"E": p.E - jnp.mean(p.E)}),
        "elementwise-not-elementwise", "elementwise-not-elementwise"),
    "elementwise-not-elementwise-roll": (
        _ew(lambda p: {"E": torch.roll(p.E, 1)},
            lambda p: {"E": jnp.roll(p.E, 1)}),
        "elementwise-not-elementwise", "elementwise-not-elementwise"),
    "elementwise-not-elementwise-capacity": (
        _ew(lambda p: {"E": p.E / p.E.shape[0]}),
        "elementwise-not-elementwise", "elementwise-not-elementwise"),
    "elementwise-trace": (_ew(_branchy), "elementwise-trace", None),
    # the ops the kernel has no instruction for (ROADMAP.md section 3:
    # jnp has no erfcx, no bessel_y0 and no modified_bessel_k0)
    "elementwise-op-unsupported": (
        _ew(lambda p: {"E": torch.special.bessel_y0(p.E + 1.0)}),
        "elementwise-op-unsupported", None),
    "elementwise-probe-error": (
        _ew(lambda p: {"E": p.extras["nope"]}, extras=("dose",)),
        "elementwise-probe-error", "elementwise-probe-error"),
    "elementwise-shape": (
        _ew(lambda p: {"vx": torch.stack([p.vx, p.vy, p.vz])},
            lambda p: {"vx": p.vx}),
        "elementwise-shape", None),
    "extras-missing": (_ew(lambda p: {"E": p.E}, extras=("nope",)),
                       "extras-missing", "extras-missing"),
    "reduce-not-elementwise": (
        _red(lambda p: {"x": p.E * 0 + p.E.sum()},
             lambda p: {"x": p.E * 0 + jnp.sum(p.E)}),
        "reduce-not-elementwise", "reduce-not-elementwise"),
    "reduce-op-unsupported": (
        _red(lambda p: {"x": torch.special.modified_bessel_k0(p.E + 1.0)}),
        "reduce-op-unsupported", None),
    "kernelstep-op-unsupported": (
        _ks(lambda s, ctx: s.replace(E=torch.special.erfcx(s.E * 0.25))),
        "kernelstep-op-unsupported", None),
    "kernelstep-ctx": (
        _ks(lambda s, ctx: s.replace(E=s.E * ctx.next_key())),
        "kernelstep-ctx", "kernelstep-ctx"),
    "kernelstep-state-a": (_ks(lambda s, ctx: s.replace(v=s.v + s.a)),
                           "kernelstep-state", "kernelstep-state"),
    "kernelstep-state-extras": (
        _ks(lambda s, ctx: s.replace(E=s.extras["dose"])),
        "kernelstep-state", "kernelstep-state"),
    "kernelstep-trace": (
        _ks(lambda s, ctx: s if bool((s.E > 1).any()) else s.replace(
            E=s.E * 2)), "kernelstep-trace", "kernelstep-trace"),
    "kernelstep-return": (_ks(lambda s, ctx: {"E": s.E}),
                          "kernelstep-return", "kernelstep-return"),
    "kernelstep-shape": (_ks(lambda s, ctx: s.replace(E=s.E[:10])),
                         "kernelstep-shape", "kernelstep-shape"),
    "kernelstep-ignored-write": (
        _ks(lambda s, ctx: s.replace(t=s.t + 1.0)),
        "kernelstep-ignored-write", "kernelstep-ignored-write"),
    "kernelstep-not-elementwise": (
        _ks(lambda s, ctx: s.replace(E=s.E - s.E.mean()),
            lambda s, ctx: s.replace(E=s.E - jnp.mean(s.E))),
        "kernelstep-not-elementwise", "kernelstep-not-elementwise"),
    "kernelstep-records": (
        _ks(lambda s, ctx: s, record_fn=lambda s: {"n": s.E.sum()}),
        "kernelstep-records", "kernelstep-records"),
}


# the refused cases whose fn fails on the generic tier too, with the error
# it raises there (as the JAX package's generic scan raises on them); every
# other refused case runs there to completion
_GENERIC_ERRORS = {
    "elementwise-probe-error": (KeyError, "nope"),
    "elementwise-shape": (RuntimeError, "stack expects each tensor"),
    "extras-missing": (ValueError, "carries no 'nope' plane"),
    # ctx.next_key is the JAX package's API; the port's is ctx.uniform
    "kernelstep-ctx": (AttributeError, "next_key"),
    "kernelstep-return": (AttributeError, "replace"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_user_refusals(case):
    """Each refusal carries its code. A code the JAX prover shares falls
    back to the generic tier with one RuntimeWarning naming it; a limit of
    the port's recorder (``*-op-unsupported``: the JAX kernel runs these)
    is raised with no fallback, and the plan runs on the generic tier
    where fuse="off" asks for it."""
    make, code_t, code_j = _REFUSALS[case]
    assert _code_T(_refusing(T, make)) == code_t
    if code_j is not None:
        assert _code_J(_refusing(J, make)) == code_j
    s = _refusing(T, make)
    if is_kernel_limit(code_t):
        assert code_t.endswith("-op-unsupported")
        with pytest.raises(FusedRefusal, match=code_t):
            s._run_impl()
        s = _refusing(T, make)
        s.fuse = "off"
        s._run_impl()
        assert not s.used_fused
        assert len(s.ts) >= 1 and float(s.sim_state.t) >= s.exit.T
        return
    with pytest.warns(RuntimeWarning) as record:
        if case in _GENERIC_ERRORS:
            exc, match = _GENERIC_ERRORS[case]
            with pytest.raises(exc, match=match):
                s._run_impl()
        else:
            s._run_impl()
            assert len(s.ts) >= 1 and float(s.sim_state.t) >= s.exit.T
    warned = [w for w in record if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == 1 and f"refused [{code_t}]" in str(
        warned[0].message)
    assert not s.used_fused


@pytest.mark.parametrize("code,A_fn", [
    ("field-fn-callable", lambda E: np.asarray(E) * 2.0),
])
def test_callable_field_refusals(code, A_fn):
    s = _refusing(T, lambda P: P.light.ScatterDeleteStep(1.0, 1.0,
                                                         A_fn=A_fn))
    assert _code_T(s) == code


def _nested_17(xp):
    """17 nested sums: past the former interpreter's 16 stack levels."""
    return lambda E: E * (E + 1 * (E + 2 * (E + 3 * (E + 4 * (E + 5 * (
        E + 6 * (E + 7 * (E + 8 * (E + 9 * (E + 10 * (E + 11 * (E + 12 * (
            E + 13 * (E + 14 * (E + 15 * (E + 16 * (E + 17))))))))))))))))) \
        * 1e-15


# recorded A(E) callables the former interpreter refused: a select
# (field-expr-unsupported) and a nesting past its stack (field-expr-length)
_LIFTED_A = {
    "where": lambda xp: (lambda E: xp.where(E > 1.0, E, 1.0)),
    "nested-17": _nested_17,
}


@pytest.mark.parametrize("name", sorted(_LIFTED_A))
def test_lifted_callable_fields_match_jax(name):
    """The A(E) callable records into one field program (its select kept)
    and fuses; the run matches the JAX package: sim.ts and the sign rows
    equal, the alive plane equal, the live planes within 1e-4 of each
    plane's max."""
    runs = []
    for P in (J, T):
        s = _sim(P)
        c = float(P.light.c)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterIsotropicStep(A=0.02 / (c * DT),
                                                   n=1.0))
        s.add_step(3, P.light.ScatterDeleteStep(
            1.0, 0.02 / (c * DT), A_fn=_LIFTED_A[name](_np(P))))
        m = P.light.ScatterSignMeasureStep(None, True)
        s.add_step(4, m)
        s.add_photons(_photons(P, 2048, 5))
        s.start()
        s.join()
        assert s.used_fused, s.explain_plan()
        runs.append((s, np.asarray(m.data, np.float64)))
    (js, jrow), (ts, trow) = runs
    assert (np.asarray(js.ts, np.float64).tobytes()
            == np.asarray(ts.ts, np.float64).tobytes())
    np.testing.assert_array_equal(trow, jrow)
    jst, tst = _state_np(J, js), _state_np(T, ts)
    assert np.array_equal(jst["alive"], tst["alive"])
    live = jst["alive"]
    for k in ("r", "v", "E", "w"):
        want, got = jst[k][..., live], tst[k][..., live]
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            assert float(np.abs(g - w).max(initial=0.0)) <= 1e-4 * scale, k
    if name == "where":
        fn = RC.record_field(_LIFTED_A[name](torch), ("E",), "A_fn")
        assert RC.U_SEL in [ins[0] for ins in fn.spec["prog"].ins]


def test_contract_errors_raise_as_in_jax():
    """An unknown update field or a missing declared output is an error
    when the fn is recorded, as when the JAX package traces it."""
    s = _refusing(T, _ew(lambda p: {"nope": p.E}))
    with pytest.raises(ValueError, match="unknown fields"):
        s.explain_plan()
    s = _refusing(T, _red(lambda p: {"y": p.E}))
    with pytest.raises(ValueError, match="declared outputs"):
        s.explain_plan()


def test_identity_fn_records_an_empty_program():
    """Updates that return a plane as it is store nothing: the program is
    empty, takes no draw, and the run equals one without the step."""
    prog = RC.record_particle_fn(lambda p: {"E": p.E, "alive": p.alive},
                                 "ElementwiseStep")
    assert prog.ins == () and prog.n_draws == 0
    rows = []
    for extra in (False, True):
        s = _sim(T)
        c = float(T.light.c)
        steps = [T.UpdateTimeStep(lambda x: np.double(DT)),
                 T.newton.NewtonianKinematicsStep(),
                 T.light.ScatterIsotropicStep(A=0.05 / (c * DT), n=1.0)]
        if extra:
            steps.append(T.ElementwiseStep(lambda p: {"E": p.E}))
        sign = T.light.ScatterSignMeasureStep(None, True)
        for i, st in enumerate(steps + [sign]):
            s.add_step(i, st)
        s.add_photons(_photons(T, 500, 3))
        s.start()
        s.join()
        rows.append(np.asarray(sign.data))
    assert np.array_equal(rows[0], rows[1])
