"""Heterogeneous media: the PyTorch port against the JAX package.

Field values: ``voxel_density`` (nearest, trilinear, ``quantize=``),
``layered_density`` (x, y, z, r) and C-expression fields evaluate to the
same float32 numbers as the JAX callables on the same points, edges of the
coverage, half-way points and NaN / +-inf coordinates included. Exactly
equal where no transcendental is involved (the expression compiler folds
literals as Python and JAX do, integer exponents are ``lax.integer_pow``'s
products); within a few ulp where one is (XLA's and torch's ``exp``,
``pow``, ``sin`` ... round differently).

Whole runs: the same ``Simulation`` (same seed, steps and photons) on both
packages on the CPU, the JAX package through its emulated fused chunk and
the port through the plain twin of its CUDA kernel, for each field kind and
option of the media path (implicit capture with and without roulette,
deposition tallies, the absorbing box, weighted sign and plane tallies):

* ``sim.ts`` byte-identical, int records and the alive plane equal;
* float records within rtol 3e-5: the per-photon terms are equal, but
  XLA's float32 reduction over the 4096 photons rounds differently from
  torch's (up to 1.3e-5 measured on a weighted sign tally, where every
  photon contributes);
* live planes ``v``, ``w``, ``E`` within rtol 1e-6 + 1e-6 * max|plane|,
  and ``r`` within one ulp of the plane's largest value per iteration:
  XLA's CPU backend contracts ``r + v * dt`` into an FMA and the twin does
  not, so each iteration may round a position differently, and a photon
  flying straight drifts the same way every time (~100 m after 96
  iterations at 3e7 m). The fields are smooth, so the densities read at
  the drifted positions agree to far below the collision probabilities'
  resolution. Photons start a fraction of a voxel off the coverage's edges
  so that no sample lands on a rounding tie that the drift could flip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.ops import fields as FL
from physicl_tpu_torch.ops import record as RC
from physicl_tpu_torch.ops.pipeline import FusedRefusal, is_kernel_limit

DT = 1e-3
C_DT = float(T.light.c) * DT
S = 4 * C_DT          # voxel spacing: 4 flight steps per voxel
NG = 12               # grid side
N = 4096


def _points(seed, n=20000, lo=-2.0, hi=NG + 1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (3, n)) * S).astype(np.float32)


def _eval_both(jfn, tfn, pts):
    want = jfn(*[jnp.asarray(p) for p in pts])
    want = np.broadcast_to(np.asarray(want, np.float32), pts[0].shape)
    got = tfn(*[torch.from_numpy(np.ascontiguousarray(p)) for p in pts])
    return got.numpy(), want


def _special_points(shape, spacing, origin=(0.0, 0.0, 0.0)):
    """Voxel centres, half-way points, the coverage's edges (both
    interpolation modes) and NaN / +-inf coordinates."""
    coords = []
    for n in shape:
        k = np.arange(-1, n + 1, dtype=np.float64)
        coords.append(np.concatenate([k, k + 0.5, [-0.5, n - 0.5, n - 1.0,
                                                    0.0, -1e-7, n - 1 + 1e-7,
                                                    np.nan, np.inf, -np.inf]]))
    rng = np.random.default_rng(5)
    m = 4000
    pts = np.stack([rng.choice(c, m) for c in coords])
    o = np.asarray(origin)[:, None]
    return (o + pts * spacing).astype(np.float32)


def smooth_grid(n=NG, seed=0):
    """Three Gaussian blobs over a background of 1, values in ~[1, 3]."""
    rng = np.random.default_rng(seed)
    x = np.stack(np.meshgrid(*[np.linspace(0, 1, n)] * 3, indexing="ij"))
    g = np.ones((n, n, n))
    for _ in range(3):
        c = rng.uniform(0.2, 0.8, (3, 1, 1, 1))
        g += rng.uniform(0.5, 1.0) * np.exp(-((x - c) ** 2).sum(0) / 0.08)
    return g.astype(np.float32)


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_voxel_values_equal_jax(interp):
    grid = (0.5 + np.random.default_rng(1).uniform(0, 2.5, (9, 7, 5))
            ).astype(np.float32)
    kw = dict(origin=(0.3 * S, -S, 2 * S), spacing=(0.7 * S, 1.1 * S, 0.9 * S),
              interp=interp, outside=0.25)
    jf, tf = J.light.voxel_density(grid, **kw), T.light.voxel_density(grid,
                                                                     **kw)
    assert tf.spec["kind"] == "voxel" and tf.spec["interp"] == interp
    for pts in (_points(2, lo=-1.0, hi=10.0),
                _special_points(grid.shape, np.array([[0.7], [1.1], [0.9]])
                                * S, kw["origin"])):
        got, want = _eval_both(jf, tf, pts)
        np.testing.assert_array_equal(got, want)
        assert 0.05 < (got != 0.25).mean() < 0.99   # inside and outside


def test_voxel_quantize_equal_jax():
    grid = smooth_grid(10, seed=3)
    jf = J.light.voxel_density(grid, spacing=S, interp="trilinear",
                               quantize=12)
    tf = T.light.voxel_density(grid, spacing=S, interp="trilinear",
                               quantize=12)
    assert tf.quantize_err == jf.quantize_err > 0
    assert np.unique(tf.spec["flat"]).size <= 12
    got, want = _eval_both(jf, tf, _points(4, lo=-0.5, hi=10.5))
    np.testing.assert_array_equal(got, want)


def test_voxel_grid_refusals():
    with pytest.raises(ValueError, match="at least 2 voxels"):
        T.light.voxel_density(np.ones((1, 4, 4)), interp="trilinear")
    with pytest.raises(ValueError, match="quantize"):
        T.light.voxel_density(np.ones((4, 4, 4)), quantize=1)


@pytest.mark.parametrize("axis", ["x", "y", "z", "r"])
def test_layered_values_equal_jax(axis):
    edges = np.array([0.5, 2.0, 2.5, 4.0, 7.25, 9.0]) * S
    values = [0.5, 3.0, 1.25, 2.0, 0.75]
    kw = dict(axis=axis, center=(5 * S, 4 * S, 6 * S), outside=0.125)
    jf = J.light.layered_density(edges, values, **kw)
    tf = T.light.layered_density(edges, values, **kw)
    pts = _points(6)
    # edges themselves, and NaN / inf coordinates
    pts[0, :6] = pts[1, :6] = pts[2, :6] = edges.astype(np.float32)
    pts[:, 6:9] = np.array([np.nan, np.inf, -np.inf], np.float32)
    got, want = _eval_both(jf, tf, pts)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist()) & set(values)) == len(values)


# transcendental-free: exact (0); with exp/pow/log/sin/...: each
# transcendental within an ulp or two, which a sum with cancellation can
# magnify, hence a tolerance relative to the largest value (1)
_EXPRS = {
    "literal-fold-first": ("2.0 * 1e-3 * r2[gid] + 1.0", 0),
    "literal-fold-last": ("r2[gid] * 2.0 * 1e-3 + 1.0", 0),
    "int-pow": ("r1[gid] ** 3 - r2[gid] ** -2 + pow(r0[gid], 5) * (1 + 2) "
                "/ 7", 0),
    "min-floor": ("fmin(r0[gid], r1[gid]) / 3.0 - floor(r2[gid])", 0),
    "sqrt-ceil-consts": ("sqrt(fabs(r1[gid]) + M_PI) - r0[gid] + "
                         "ceil(r1[gid]) * M_E", 0),
    "fmax-square": ("fmax(r0[gid], 0.25) ** 2 * 1e-1 + (1/3) * r1[gid] "
                    "+ 10 ** -2", 0),
    "int-literal-call": ("pow(2, 3) * r0[gid] + 1.5", 0),
    "exp": ("exp(-r0[gid] * 0.5) * 2.0 + exp(1.0)", 1),
    "float-pow": ("pow(fabs(r1[gid]) + 1.0, 0.5) + fabs(r2[gid]) ** 1.5", 1),
    "trig-log": ("log(fabs(r2[gid]) + 1) * sin(r0[gid]) * cos(r1[gid]) "
                 "+ log10(fabs(r0[gid]) + 2) + tan(r1[gid] * 0.1)", 1),
    # jnp.remainder and jnp.floor_divide, a comparison promoted where it
    # meets arithmetic, booleans combined, an integer from a boolean
    "mod-floordiv": ("r0[gid] % 0.7 - r1[gid] // 0.3 + (r2[gid] % -2) "
                     "* (7 // 2) + 2 % (fabs(r0[gid]) + 0.5)", 0),
    "compare-logic": ("((r0[gid] > 0) & (r1[gid] <= 0.5)) * 2.0 + "
                      "(~(r2[gid] == 1.0) | (r0[gid] != r1[gid])) * 0.25 "
                      "+ ((r1[gid] < 0) ^ True) + (r2[gid] >= 0) * 3", 0),
    "checkerboard": ("1e-3 * (1.0 + 0.5 * ((floor(r0[gid] / 0.05) + "
                     "floor(r1[gid] / 0.05)) % 2 == 0))", 0),
    "int-from-bool": ("((r0[gid] > 0) + 1) % 2 * 0.5 + ((r1[gid] < 0) * -3)"
                      " // 2 + (r2[gid] > 1) ** 2", 0),
}


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_expression_values_match_jax(name):
    expr, transcendental = _EXPRS[name]
    jf = J.light._compile_variable_n(expr)
    tf = T.light._compile_variable_n(expr)
    assert tf.spec["kind"] == "expr" and tf.spec["error"] is None
    # one straight-line program, its output stored last
    assert tf.spec["n_out"] == 1 and tf.spec["prog"].ins[-1][0] == RC.U_ST
    pts = np.random.default_rng(7).uniform(-3, 3, (3, 20000)).astype(
        np.float32)
    got, want = _eval_both(jf, tf, pts)
    if not transcendental:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=4e-7,
                                   atol=4e-7 * np.abs(want).max())


def test_expression_over_energy_matches_jax():
    expr = "(2.0 / E[gid]) ** 3 + 0.5 * E[gid]"
    jf = J.light._compile_field_expr(expr, ("E",), "A_fn")
    tf = T.light._compile_field_expr(expr, ("E",), "A_fn")
    E = np.random.default_rng(8).uniform(0.5, 3.0, 5000).astype(np.float32)
    got = tf(torch.from_numpy(E)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf(jnp.asarray(E))))


def test_expression_grammar_errors():
    with pytest.raises(ValueError, match="unknown symbol 'r3'"):
        T.light._compile_variable_n("r3[gid] * 2")
    with pytest.raises(ValueError, match="unknown symbol 'hypot'"):
        T.light._compile_variable_n("hypot(r0[gid], 1.0)")
    # an integer floor division by a value that may be 0: the reference
    # evaluates it, XLA's result there is implementation-defined
    fn = T.light._compile_variable_n("((r0[gid] > 0) * 3) // "
                                     "((r1[gid] > 0) * 1)")
    assert fn.spec["error"] is not None and fn.spec["raises"] is None
    with pytest.raises(NotImplementedError, match="integer floor division"):
        fn(torch.zeros(3), torch.zeros(3), torch.zeros(3))
    # what the reference's eval over jnp raises on raises as it does
    for expr, exc in (("0 < r0[gid] < 1", ValueError),
                      ("-(r0[gid] > 0)", TypeError),
                      ("~r0[gid]", TypeError),
                      ("2**40 * r0[gid]", OverflowError)):
        fn = T.light._compile_variable_n(expr)
        assert fn.spec["raises"] is exc, expr
        with pytest.raises(exc):
            fn(torch.zeros(3), torch.zeros(3), torch.zeros(3))
        x = jnp.zeros(3, jnp.float32)
        with pytest.raises(exc):
            J.light._compile_variable_n(expr)(x, x, x)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def _field(P, kind):
    if kind == "voxel-trilinear":
        return P.light.voxel_density(smooth_grid(), spacing=S,
                                     interp="trilinear")
    if kind == "voxel-nearest":
        return P.light.voxel_density(smooth_grid(seed=1), spacing=S,
                                     outside=0.5)
    if kind == "voxel-quantize":
        return P.light.voxel_density(smooth_grid(seed=2), spacing=S,
                                     interp="trilinear", quantize=16)
    if kind == "layered-z":
        return P.light.layered_density(np.array([0.1, 3.3, 7.6, 10.9]) * S,
                                       [1.0, 2.5, 1.5], axis="z")
    if kind == "layered-r":
        return P.light.layered_density(np.array([0.0, 2.3, 4.4, 30.0]) * S,
                                       [2.5, 1.0, 0.5], axis="r",
                                       center=(5.6 * S, 5.4 * S, 5.7 * S))
    assert kind == "expr"
    # n in [1, 3], transcendental-free
    return "1.0 + 2.5e-7 * fabs(r1[gid] - 1.6e7) + floor(r2[gid] * 2e-7) * 0.1"


# case -> (field, del options, extra steps, exit)
_CASES = {
    "trilinear-capture-roulette": (
        "voxel-trilinear", dict(implicit_capture=True, roulette=(0.5, 0.8),
                                measure_deposition=True),
        ("absorb", "cross-w", "sign-w"), "t"),
    "nearest-analog-deposition": (
        "voxel-nearest", dict(measure_deposition=True), ("cross", "sign"),
        "t"),
    "quantize-capture": (
        "voxel-quantize", dict(implicit_capture=True, measure_deposition=True),
        ("absorb", "sign-w"), "t"),
    "layered-z-analog": ("layered-z", {}, ("absorb", "sign"), "t"),
    "layered-r-capture": ("layered-r", dict(implicit_capture=True,
                                            roulette=(0.6, 0.9)),
                          ("sign-w",), "t"),
    "expr-and-A_fn": ("expr", dict(A_fn="(1.5 / E[gid]) ** 2",
                                   measure_deposition=True),
                      ("cross", "sign"), "t"),
    "absorb-extinction": ("voxel-trilinear", {}, ("absorb", "sign"), "n0"),
}


def _build(P, case, **kw):
    field, del_kw, extra, exit_mode = _CASES[case]
    nfn = _field(P, field)
    if exit_mode == "t":
        s = P.Simulation(until_t=0.0955, seed=9, chunk_steps=32, **kw)
    else:
        s = P.Simulation(exit="extinction", seed=9, chunk_steps=32, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(
        A=0.02 / C_DT, variable_n=True, variable_n_fn=nfn))
    dele = P.light.ScatterDeleteStep(np.double(1.0), np.double(0.01 / C_DT),
                                     variable_n=True, variable_n_fn=nfn,
                                     **del_kw)
    s.add_step(3, dele)
    meas = {"dep": dele}
    for i, name in enumerate(extra, start=4):
        if name == "absorb":
            step = P.newton.AbsorbingBoundaryStep(((-S, NG * S),) * 3)
        elif name.startswith("cross"):
            step = meas["cross"] = P.light.ScatterMeasureStep(
                None, True, [((NG - 1.3) * S, np.nan, np.nan),
                             (np.nan, 6.1 * S, np.nan)],
                weighted=name == "cross-w", measure_E=True,
                measure_E_mode="sum")
        else:
            step = meas["sign"] = P.light.ScatterSignMeasureStep(
                None, True, weighted=name == "sign-w")
        s.add_step(i, step)
    rng = np.random.default_rng(3)
    r = np.stack([np.full(N, -0.6 * S),
                  rng.uniform(0.1, NG - 1.1, N) * S,
                  rng.uniform(0.1, NG - 1.1, N) * S])
    E = rng.uniform(1.0, 2.0, N)
    s.add_photons(P.light.generate_photon_state(N, E=E, r=r))
    return s, meas


def _run(s):
    s.start()
    s.join()
    return s


@pytest.fixture(scope="module", params=sorted(_CASES))
def media(request):
    case = request.param
    kw = {} if _CASES[case][3] == "t" else {"auto_shrink": False}
    js, jm = _build(J, case, **kw)
    ts, tm = _build(T, case, device="cpu", **kw)
    return case, _run(js), jm, _run(ts), tm


def _int_cols(name, step):
    """Columns of a step's data rows that hold exact integers (the t
    column is compared exactly too)."""
    if name == "dep":
        return [0]
    if name == "sign":
        return [0, 1] if step.weighted else [0, 1, 2, 3, 4]
    # cross: t, n, then (count, Esum) per plane
    return [0, 1] if step.weighted else [0, 1, 2, 4]


def test_media_runs_fused_on_both(media):
    _, js, _, ts, _ = media
    assert js.used_fused and ts.used_fused
    assert "fused" in ts.explain_plan()


def test_media_ts_and_int_records_equal(media):
    case, js, jm, ts, tm = media
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    for name, step in tm.items():
        got, want = np.asarray(step.data), np.asarray(jm[name].data)
        if name == "dep" and not step.measure_deposition:
            assert got.size == want.size == 0
            continue
        assert got.shape == want.shape and got.shape[0] == len(ts.ts)
        cols = _int_cols(name, step)
        np.testing.assert_array_equal(got[:, cols], want[:, cols],
                                      err_msg=f"{case} {name}")


def test_media_float_records_close(media):
    case, _, jm, _, tm = media
    n_float = 0
    for name, step in tm.items():
        got, want = np.asarray(step.data), np.asarray(jm[name].data)
        if got.size == 0:
            continue
        cols = [c for c in range(got.shape[1])
                if c not in _int_cols(name, step)]
        for c in cols:
            scale = np.abs(want[:, c]).max()
            assert np.all(np.abs(got[:, c] - want[:, c])
                          <= 3e-5 * np.abs(want[:, c]) + 1e-7 * scale), \
                f"{case} {name} column {c}"
            n_float += 1
    assert n_float > 0 or case in ("layered-z-analog", "absorb-extinction")


def test_media_alive_equal(media):
    case, js, _, ts, _ = media
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(),
                                  np.asarray(js.sim_state.alive))
    assert len(ts.objects) == len(js.objects)
    if case == "absorb-extinction":
        assert len(ts.objects) == 0 and len(ts.ts) > 50


@pytest.mark.parametrize("field", ["r", "v", "w", "E"])
def test_media_live_planes_close(media, field):
    _, js, _, ts, _ = media
    live = np.asarray(js.sim_state.alive)
    want = np.asarray(jax.device_get(getattr(js.sim_state, field)))[...,
                                                                    live]
    got = getattr(ts.sim_state, field).numpy()[..., live]
    if not live.any():
        return
    scale = np.abs(want).max()
    if field == "r":  # one ulp per iteration (see the module docstring)
        tol = len(ts.ts) * np.spacing(np.float32(scale))
    else:
        tol = 1e-6 * np.abs(want) + 1e-6 * scale
    assert np.all(np.abs(got - want) <= tol)


def test_media_case_behaviour(media):
    """What each case is there to show, on the port's own run."""
    case, _, _, ts, tm = media
    w = ts.sim_state.w.numpy()[ts.sim_state.alive.numpy()]
    if case in ("trilinear-capture-roulette", "layered-r-capture"):
        w_min = _CASES[case][1]["roulette"][0]
        assert w.size and (w < 1).all() and w.min() >= w_min * 0.9
        assert len(ts.objects) < N  # roulette killed photons
    if case == "quantize-capture":
        assert (w < 1).all()
    if "dep" in tm and tm["dep"].measure_deposition:
        dep = np.asarray(tm["dep"].data)[:, 1]
        assert dep.sum() > 0 and (dep >= 0).all()
    if case in ("layered-z-analog", "nearest-analog-deposition"):
        # the box (or absorption) removed photons
        assert len(ts.objects) < N


# ---------------------------------------------------------------------------
# repaired folds, the absorbing box, refusals
# ---------------------------------------------------------------------------

def test_variable_n_replaces_constant_n_in_folds():
    """``variable_n`` replaces the constant n: ``ScatterDeleteStep._coef``
    is A alone, and ``ScatterIsotropicStep.setup`` folds A alone into
    ``coef`` and ``wl_base`` — as the JAX package does."""
    for P in (J, T):
        d = P.light.ScatterDeleteStep(3.0, 2.0, variable_n=True,
                                      variable_n_fn="r0[gid]")
        assert d._coef == 2.0
        assert P.light.ScatterDeleteStep(3.0, 2.0)._coef == 6.0
    for kw in ({}, {"wavelength_dep_scattering": True}):
        got, want = [], []
        for P, out in ((J, want), (T, got)):
            s = P.light.ScatterIsotropicStep(A=2.0, n=3.0, variable_n=True,
                                             variable_n_fn="r0[gid]", **kw)
            s.setup(None)
            out.append((s._coef, s._wl_base))
        assert got == want
    iso = T.light.ScatterIsotropicStep(A=2.0, n=3.0, variable_n=True,
                                       variable_n_fn="1.0")
    iso.setup(None)
    assert iso._coef == 2.0


def test_simulation_bounds_and_absorbing_box():
    """``Simulation.bounds`` defaults to zeros(3) (a box [0, 0]^3) and
    ``AbsorbingBoundaryStep(bounds=None)`` reads it; explicit bounds take
    a 3-vector (box [0, b]) or (3, 2) pairs; the walls are inclusive."""
    from physicl_tpu_torch.newton import _static_bounds

    for P in (J, T):
        s = P.Simulation(until_t=0.003, seed=0)
        assert np.array_equal(s.bounds, np.zeros(3))
    s = T.Simulation(until_t=0.003, seed=0, bounds=np.array([1.0, 2.0, 3.0]),
                     device="cpu")
    step = T.newton.AbsorbingBoundaryStep()
    step.setup(s)
    assert _static_bounds(step, s) == ((0.0, 1.0), (0.0, 2.0), (0.0, 3.0))
    assert _static_bounds(T.newton.AbsorbingBoundaryStep(
        [(-1, 1), (-2, 2), (-3, 3)]), s)[2] == (-3.0, 3.0)
    with pytest.raises(ValueError, match="bounds"):
        _static_bounds(T.newton.AbsorbingBoundaryStep([1.0, 2.0]), s)
    # photons exactly on the walls survive; one past a wall dies
    runs = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        sim = P.Simulation(until_t=0.0015, seed=0, **kw)
        sim.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        sim.add_step(1, P.newton.AbsorbingBoundaryStep(((0.0, 1.0),) * 3))
        sign = P.light.ScatterSignMeasureStep(None, True)
        sim.add_step(2, sign)
        r = np.array([[0.0, 1.0, 0.5, 1.0 + 1e-6, -1e-6],
                      [0.5, 1.0, 0.0, 0.5, 0.5],
                      [0.5, 0.0, 1.0, 0.5, 0.5]])
        sim.add_photons(P.light.generate_photon_state(5, E=1.0, r=r))
        runs.append((_run(sim), sign))
    (js, jm), (ts, tm) = runs
    assert ts.used_fused and js.used_fused
    np.testing.assert_array_equal(np.asarray(tm.data), np.asarray(jm.data))
    assert [row[1] for row in tm.data] == [3, 3]


def test_absorb_counts_as_death_for_extinction():
    """An extinction exit needs a step that can remove photons: the
    absorbing box is one (the JAX prover counts it too)."""
    s = T.Simulation(exit="extinction", seed=0, device="cpu")
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.newton.AbsorbingBoundaryStep(((-1.0, 3.5 * C_DT),) * 3))
    sign = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_photons(T.light.generate_photon_state(100, E=1.0))
    _run(s)
    assert s.used_fused and len(s.objects) == 0
    assert [row[1] for row in sign.data] == [100, 100, 100, 0]


def _refusing_sim(step, fuse="auto"):
    s = T.Simulation(until_t=0.01, seed=0, device="cpu", fuse=fuse)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, step)
    s.add_photons(T.light.generate_photon_state(10, E=1.0))
    return s


# each field refusal is a limit of the port's kernel (the JAX kernel runs
# these plans), so the run stops by name and does not fall back. With
# fuse="off" the generic tier calls the field: a layered density as
# A_fn(E) has the wrong arguments, and an expression outside the grammar
# raises when evaluated, as in the JAX package
_FIELD_ERRORS = {
    "field-fn-callable": (TypeError, "missing 2 required positional"),
    "field-expr-unsupported": (NotImplementedError,
                               "integer floor division by a value"),
}


@pytest.mark.parametrize("code,make", [
    ("field-fn-callable", lambda: T.light.ScatterDeleteStep(
        1.0, 1.0, A_fn=T.light.layered_density([0, 1], [1]))),
    # an integer floor division by a value that may be 0 (the reference
    # evaluates it; XLA's result there is implementation-defined)
    ("field-expr-unsupported", lambda: T.light.ScatterIsotropicStep(
        A=1.0, variable_n=True,
        variable_n_fn="((r0[gid] > 0) * 3) // ((r1[gid] > 0) * 1)")),
])
def test_field_refusals(code, make):
    s = _refusing_sim(make())
    assert is_kernel_limit(code)
    assert f"refused [{code}]" in s.explain_plan()
    with pytest.raises(FusedRefusal, match=code):
        s._run_impl()
    s = _refusing_sim(make(), fuse="off")
    exc, match = _FIELD_ERRORS[code]
    with pytest.raises(exc, match=match):
        s._run_impl()
    assert not s.used_fused


def _metre_sim(P, n_r, fuse="auto", n=1024):
    """A density string over positions of a few metres: dt = 2**-30 (c dt
    ~ 0.28 m; v dt is exact, so XLA's contraction of r + v dt moves no
    position), 64 iterations of kinematics, then on the fused tier an
    isotropic scatter of A = 0.05 per metre, and on the generic tier
    (``fuse="off"``, which draws from another stream in each package)
    implicit capture of A = 0.05 per metre, which draws nothing; a
    weighted sign tally. Photons start inside (0, 4)^3 m in isotropic
    directions: a modulo of 2 m cuts the paths far from the ulps the two
    packages' positions may differ by."""
    kw = {"device": "cpu"} if P is T else {}
    dt = 2.0 ** -30
    s = P.Simulation(until_t=64 * dt * 0.9999, seed=5, chunk_steps=32,
                     auto_shrink=False, fuse=fuse, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    if fuse == "auto":
        s.add_step(2, P.light.ScatterIsotropicStep(
            A=0.05, variable_n=True, variable_n_fn=n_r))
    else:
        s.add_step(2, P.light.ScatterDeleteStep(
            1.0, 0.05, variable_n=True, variable_n_fn=n_r,
            implicit_capture=True))
    m = P.light.ScatterSignMeasureStep(None, True, weighted=True)
    s.add_step(3, m)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(3, n))
    s.add_photons(P.light.generate_photon_state(
        n, E=1.0, r=rng.uniform(0, 4, (3, n)),
        v=d / np.linalg.norm(d, axis=0) * float(P.light.c)))
    return s, m


def _same_runs(ts, tm, js, jm, tol=1e-4, rtol=0.0):
    """sim.ts equal, the sign rows equal (within ``rtol`` for weight
    sums), the alive plane equal, the live planes within ``tol`` of each
    plane's max."""
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    assert len(tm.data) == len(jm.data) > 0
    for a, b in zip(tm.data, jm.data):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
    live = np.asarray(js.sim_state.alive)
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(), live)
    for nm in ("r", "v", "E", "w"):
        want = np.asarray(getattr(js.sim_state, nm))[..., live]
        got = getattr(ts.sim_state, nm).numpy()[..., live]
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
            assert float(np.abs(g - w).max(initial=0.0)) <= tol * scale, nm


# strings the port's field IR refused before it took jnp's remainder,
# floor division, comparisons and boolean logic: a checkerboard and a
# lattice of rods, as shielding and CT phantoms are written
_FORMERLY_REFUSED = {
    "modulo": "r0[gid] % 2",
    "checkerboard": "1.0 + 0.5 * ((floor(r0[gid] / 0.5) + floor(r1[gid] "
                    "/ 0.5)) % 2 == 0)",
    "rods": "0.2 + 1.5 * (((r0[gid] % 1.0) < 0.3) & ((r1[gid] // 1.0) "
            "!= 2) | ~(r2[gid] < 3.5))",
}


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("name", sorted(_FORMERLY_REFUSED))
def test_formerly_refused_strings_match_jax(name, fuse):
    """The strings run on both tiers (the fused kernel's twin, and the
    generic tier calling the field) and match the JAX package on the same
    tier: sim.ts equal, weight sums within rtol 1e-5, the rest as
    ``_same_runs``."""
    expr = _FORMERLY_REFUSED[name]
    assert T.light._compile_variable_n(expr).spec["error"] is None
    ts, tm = _metre_sim(T, expr, fuse)
    ts.start()
    ts.join()
    assert ts.used_fused == (fuse == "auto"), ts.explain_plan()
    js, jm = _metre_sim(J, expr, fuse)
    js.start()
    js.join()
    _same_runs(ts, tm, js, jm, rtol=1e-5)


def _long_sim(P, n_r, n=1024):
    """A density string through a whole run: 64 iterations of kinematics,
    an isotropic scatter at ~2% a step and a sign tally, photons starting
    inside (1, 3)^3 c dt."""
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=64 * DT * 0.9999, seed=5, chunk_steps=32,
                     auto_shrink=False, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.02 / C_DT, variable_n=True,
                                               variable_n_fn=n_r))
    m = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    r = np.random.default_rng(4).uniform(1, 3, (3, n)) * C_DT
    s.add_photons(P.light.generate_photon_state(n, E=1.0, r=r))
    return s, m


# former kernel limits, lifted: past the interpreter's 256 instructions
# (90 terms) and past its 16 stack levels (16 nested products)
_LONG = {
    "90-terms": " + ".join(f"r{k % 3}[gid] * {1.0 / (90 * C_DT)!r}"
                           for k in range(90)),
    "16-deep": "(1.0 + r0[gid] * 1e-7 * " * 16
               + "(r1[gid] * r2[gid] * 1e-12 + 1.0)" + ")" * 16,
}


@pytest.mark.parametrize("name", sorted(_LONG))
def test_lifted_field_limits_match_jax(name):
    """A string past the former program length or stack depth fuses (its
    form library compiles it to straight-line code; the twin runs its
    program) and the run matches the JAX package: sim.ts and the sign rows
    equal, the alive plane equal, the live planes within 1e-4 of each
    plane's max."""
    ts, tm = _long_sim(T, _LONG[name])
    spec = T.light._compile_variable_n(_LONG[name]).spec
    assert spec["error"] is None
    ts.start()
    ts.join()
    assert ts.used_fused, ts.explain_plan()
    js, jm = _long_sim(J, _LONG[name])
    js.start()
    js.join()
    _same_runs(ts, tm, js, jm)


def test_voxel_grid_size_refusal(monkeypatch):
    """The kernel's flat voxel index is int32: a grid of 2**31 voxels or
    more (the limit is lowered here to test it) is refused with the JAX
    prover's code for a grid its kernel cannot hold, ``field-fn-gather``,
    and the run falls back to the generic tier with one warning, which
    reads the grid there; fuse="off" runs it there too."""
    monkeypatch.setattr(FL, "MAX_VOXELS", 63)
    nfn = T.light.voxel_density(np.ones((4, 4, 4)))
    s = _refusing_sim(T.light.ScatterIsotropicStep(
        A=1.0, variable_n=True, variable_n_fn=nfn))
    assert not is_kernel_limit("field-fn-gather")
    with pytest.warns(RuntimeWarning) as record:
        s._run_impl()
    warned = [w for w in record if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == 1
    assert "refused [field-fn-gather]" in str(warned[0].message)
    assert "flat index is int32" in str(warned[0].message)
    assert not s.used_fused and len(s.ts) == 10
    s = _refusing_sim(T.light.ScatterIsotropicStep(
        A=1.0, variable_n=True, variable_n_fn=nfn), fuse="off")
    s._run_impl()
    assert not s.used_fused and len(s.ts) == 10


def test_shared_field_is_one_kernel_field():
    """iso and del sharing a callable share one kernel field (one device
    grid); the plan struct points both ops at it."""
    from physicl_tpu_torch.ops import fused as F

    nfn = T.light.voxel_density(smooth_grid(4), spacing=S)
    other = T.light.layered_density([0, S], [1.0])
    ops = [F._Op("iso", n_fn=nfn), F._Op("del", n_fn=nfn, a_fn=None),
           F._Op("del", n_fn=other,
                 a_fn=T.light._compile_field_expr("E[gid]", ("E",), "A_fn"))]
    specs, per_op = F.plan_fields(ops)
    assert len(specs) == 3 and per_op == [(0, -1), (0, -1), (1, 2)]
    assert FL.grid_on(nfn.spec, "cpu") is FL.grid_on(nfn.spec, "cpu")
