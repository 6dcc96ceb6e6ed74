"""Typed values in kernel 1i's and the field programs
(``physicl_tpu_torch/ops/record.py``: int32, int64 and float64 values;
``ops/fields.py``: int32 values of the strings), on the CPU.

* Integers end to end: an ElementwiseStep and a ReduceMeasureStep whose
  integer arithmetic passes 2**24 and wraps an int32, on both tiers of the
  port (the fused plan's twin and the generic tier) against the JAX
  package's jnp int32 counterpart: ``sim.ts``, the int records and the
  float columns (sums of small integers, exact) equal, the planes the
  ElementwiseStep writes equal.
* One case per typed operation at its edges (shift amounts of 0, the width
  less 1, the width, past it and negative; int32's wrap; the most negative
  value; divisors of -1 and of a negative constant; a float past an
  integer's range and NaN converted): the recorded program's plain version
  (``record.run_field``) against eager torch where torch defines the
  result, and against jnp in int32 (x64 off) where jnp computes it,
  bitwise; a float64 case against eager torch bitwise and jnp's float32
  within 1e-6.
* The voxel-index path of ``chip_smoke.py`` (a 512**3 phantom's int64
  voxel index from r, its bits tallied, a detector smear ``sigma *
  ndtri(u)``, an ``i0e`` weight) at 2**12 photons x 64 iterations: the
  port against the JAX package (int32 there), ``sim.ts`` and the alive
  counts equal, the bit tallies within 2 counts a row and the smear's
  and weights' sums within 1e-5 of their scale (a scatter's rotation
  rounds differently in the two packages), and the port's last row equal
  to a host recomputation from its final planes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.scipy.special as jsp

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.ops import record as RC

DT = 1e-3
N_INT = 1 << 10
K_INT = 12


# -- integers end to end ------------------------------------------------------


def _int_steps(P):
    """The ElementwiseStep writing dvx, dvy, dvz from integer arithmetic of
    the planes (past 2**24, an int32 wrap, the bitwise ops; no draw: the
    generic tier draws from its own generator) and the ReduceMeasureStep
    tallying integer functions of them."""
    if P is T:
        def mark(p):
            a = (p.w * 128.0).int() + 16777216
            idx = a.long() * 3 + (p.E > 1.0).long()
            wrap = a * 2147483647 + (p.w > 0.5).int()
            return {"dvx": (idx % 64).float(), "dvy": (wrap >> 27).float(),
                    "dvz": ((idx >> 3) & 7).float()}

        def tally(p):
            big = (p.E * 1e6).int() * 16777 + 2147483000
            return {"m": p.dvx, "hi": p.dvy,
                    "bits": ((p.dvx.int() ^ p.dvz.int()) & 5).float(),
                    "wrap": (big & 1023).float()}
    else:
        i32 = jnp.int32

        def mark(p):
            a = (p.w * 128.0).astype(i32) + 16777216
            idx = a * 3 + (p.E > 1.0).astype(i32)
            wrap = a * 2147483647 + (p.w > 0.5).astype(i32)
            return {"dvx": (idx % 64).astype(jnp.float32),
                    "dvy": (wrap >> 27).astype(jnp.float32),
                    "dvz": ((idx >> 3) & 7).astype(jnp.float32)}

        def tally(p):
            big = (p.E * 1e6).astype(i32) * 16777 + 2147483000
            return {"m": p.dvx, "hi": p.dvy,
                    "bits": ((p.dvx.astype(i32) ^ p.dvz.astype(i32))
                             & 5).astype(jnp.float32),
                    "wrap": (big & 1023).astype(jnp.float32)}
    red = P.ReduceMeasureStep(None, tally, outputs=("m", "hi", "bits",
                                                    "wrap"), measure_n=True)
    return [P.UpdateTimeStep(lambda x: np.double(DT)),
            P.ElementwiseStep(mark), red], red


def _int_run(P, fuse="auto"):
    kw = {"device": "cpu", "fuse": fuse} if P is T else {}
    s = P.Simulation(until_t=(K_INT - 0.5) * DT, seed=11, chunk_steps=4,
                     auto_shrink=False, **kw)
    steps, red = _int_steps(P)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(5)
    s.add_photons(P.light.generate_photon_state(
        N_INT, E=rng.uniform(0.5, 2.0, N_INT), w=rng.uniform(0, 1, N_INT)))
    s.start()
    s.join()
    return s, np.asarray(red.data, np.float64)


def test_integer_arithmetic_matches_jax_on_both_tiers():
    """Integers past 2**24 stay exact and an int32 wraps, in the fused
    plan (recorded, its twin run) and on the generic tier, as in the JAX
    package's int32: every row and plane equal."""
    js, jrow = _int_run(J)
    jst = {k: np.asarray(getattr(js.sim_state, k)) for k in ("dv", "alive")}
    # every photon's idx % 64 in [0, 64); its wrapped value's top bits
    # -1 (a even: -a) or 15 (a odd: 2**31 - a)
    assert (jrow[:, 2] < 64 * N_INT).all()
    assert (np.abs(jrow[:, 3]) < 15 * N_INT).all()
    for fuse in ("auto", "off"):
        ts, trow = _int_run(T, fuse)
        assert ts.used_fused == (fuse == "auto"), ts.explain_plan()
        assert (np.asarray(ts.ts, np.float64).tobytes()
                == np.asarray(js.ts, np.float64).tobytes())
        np.testing.assert_array_equal(trow, jrow)
        np.testing.assert_array_equal(ts.sim_state.dv.numpy(), jst["dv"])
        np.testing.assert_array_equal(ts.sim_state.alive.numpy(),
                                      jst["alive"])


# -- one typed operation at a time --------------------------------------------

_I32 = jnp.int32


def _amount(x, xp):
    """A shift amount in [-10, 69] from x: negative, in range and past
    both widths."""
    k = (x * 10) if xp is jnp else x * 10
    k = k.astype(_I32) if xp is jnp else k.int()
    return k % 80 - 10


# name -> (torch fn, jnp fn or None, whether eager torch defines the result)
_TYPED = {
    "i32-add-wrap": (lambda x: (x > 0).int() * 2147483647 + (x > -1).int(),
                     lambda x: (x > 0).astype(_I32) * 2147483647
                     + (x > -1).astype(_I32), True),
    "i32-mul-wrap": (lambda x: (x * 1000).int() * 4000037,
                     lambda x: (x * 1000).astype(_I32) * 4000037, True),
    "i32-past-2-24": (lambda x: ((x > 0).int() * 16777217
                                 + (x > 1).int()) % 16,
                      lambda x: ((x > 0).astype(_I32) * 16777217
                                 + (x > 1).astype(_I32)) % 16, True),
    "i32-compare-past-2-24": (
        lambda x: ((x > 0).int() * 16777217 == 16777216).float(),
        lambda x: ((x > 0).astype(_I32) * 16777217 == 16777216).astype(
            jnp.float32), True),
    "i32-neg-abs-min": (
        lambda x: torch.where(x > 0, (x > 0).int() * -2147483647 - 1,
                              (x * 9).int()).abs() - (-(x * 5).int()),
        lambda x: jnp.abs(jnp.where(x > 0, (x > 0).astype(_I32)
                                    * -2147483647 - 1,
                                    (x * 9).astype(_I32)))
        - (-(x * 5).astype(_I32)), True),
    "shl": (lambda x: (x * 1e4).int() << _amount(x, torch),
            lambda x: (x * 1e4).astype(_I32) << _amount(x, jnp), True),
    "shr": (lambda x: (x * 1e4).int() >> _amount(x, torch),
            lambda x: (x * 1e4).astype(_I32) >> _amount(x, jnp), True),
    "shift-literal-edges": (
        lambda x: ((x * 100).int() << 31) + ((x * 100).int() >> 31)
        + ((x * 100).int() << 0),
        lambda x: ((x * 100).astype(_I32) << 31)
        + ((x * 100).astype(_I32) >> 31) + ((x * 100).astype(_I32) << 0),
        True),
    "i64-shifts": (lambda x: ((x * 1e4).long() << (_amount(x, torch) + 10))
                   + ((x * 1e9).long() * 99991 >> _amount(x, torch)),
                   None, True),
    "bitwise": (lambda x: ((x * 1e4).int() & 0x5555) ^ ((x * 1e3).int()
                                                        | 0x0F0F)
                + ~(x * 7).int(),
                lambda x: ((x * 1e4).astype(_I32) & 0x5555)
                ^ ((x * 1e3).astype(_I32) | 0x0F0F)
                + ~(x * 7).astype(_I32), True),
    "floordiv-mod-negative": (
        lambda x: (x * 1e4).int() // -7 + (x * 1e4).int() % -13,
        lambda x: (x * 1e4).astype(_I32) // -7
        + (x * 1e4).astype(_I32) % -13, True),
    "floordiv-minus-one-wrap": (
        lambda x: ((x > 0).int() * -2147483647 - 1) // -1,
        lambda x: ((x > 0).astype(_I32) * -2147483647 - 1) // -1, False),
    "mod-maybe-zero": (lambda x: (x * 10).int() % ((x > 0).int() * 3),
                       lambda x: (x * 10).astype(_I32)
                       % ((x > 0).astype(_I32) * 3), False),
    "ipow-wrap": (lambda x: ((x * 1000).int() + 1) ** 3,
                  lambda x: ((x * 1000).astype(_I32) + 1) ** 3, True),
    "i64-ipow": (lambda x: (x * 4096).long() ** 5, None, True),
    "i64-to-f32-rounding": (
        lambda x: ((x > 0).long() * (2 ** 53 + 1) + (x * 1000).long()),
        None, True),
    "cvt-saturate-nan": (
        lambda x: torch.where(x.abs() < 0.3, float("nan"), x * 1e10).int(),
        lambda x: jnp.where(jnp.abs(x) < 0.3, jnp.nan, x * 1e10).astype(
            _I32), False),
    "bitcast": (lambda x: x.view(torch.int32) >> 20,
                lambda x: jnp.asarray(x).view(_I32) >> 20, True),
    "f64": (lambda x: (x.double() * 0.1).exp() / 3 + torch.float_power(
        x.abs() + 1, 2.5), lambda x: jnp.exp(x * 0.1) / 3
        + (jnp.abs(x) + 1) ** 2.5, True),
}


def _typed_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, 4096).astype(np.float32)
    x[:6] = [0.0, -0.0, 1.0, -1.0, 0.5, -3.0]
    return x


@pytest.mark.parametrize("name", sorted(_TYPED))
def test_typed_op_matches_torch_and_jnp(name):
    t_fn, j_fn, torch_defined = _TYPED[name]
    fn = RC.record_field(lambda x: t_fn(x).float(), ("x",), name)
    assert fn.spec["prog"].typed()
    x = _typed_inputs()
    got = fn(torch.from_numpy(x)).numpy()
    if torch_defined:
        want = t_fn(torch.from_numpy(x)).float().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    if j_fn is not None:
        want = np.asarray(j_fn(jnp.asarray(x)), np.float32)
        if name == "f64":  # jnp computes in float32 (x64 off)
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("expr,want", [
    # int32 strings: exact past 2**24, wrapping, the bitwise ops
    ("((r0[gid] > 0) * 16777217 + (r1[gid] > 0)) % 16", 2.0),
    ("((r0[gid] > 0) * 2147483647 + (r1[gid] > 0)) >> 31", -1.0),
    ("(((r0[gid] > 0) * 5) << 32) + (((r0[gid] > 0) * -5) >> 40)", -1.0),
    ("~((r0[gid] > 0) * 6) & 13", 9.0),
])
def test_integer_strings_are_exact(expr, want):
    """The strings' integers are int32 as jnp's eval gives them: a value
    past 2**24, a wrap, a shift past the width, the bitwise ops."""
    from physicl_tpu_torch.ops import fields as FL

    one = torch.ones(3)
    fn = FL.compile_expr(expr, ("r0", "r1", "r2"), "variable_n_fn")
    assert fn.spec["error"] is None and fn.spec["prog"].typed()
    assert fn(one, one, one).tolist() == [want] * 3
    x = jnp.ones(3, jnp.float32)
    assert np.asarray(J.light._compile_variable_n(expr)(x, x, x),
                      np.float32).tolist() == [want] * 3


# -- the voxel-index path -----------------------------------------------------

VOX_NV, VOX_H, VOX_SIGMA = 512, 2.0, 0.05


def _voxel_steps(P, c_dt):
    """chip_smoke.py's voxel-index path (``voxel_sim``), in each package:
    the index in int64 (int32 in the JAX package, x64 off)."""
    h, half = VOX_H * c_dt, VOX_NV * VOX_H * c_dt / 2
    if P is T:
        def axis(x):
            return ((x + half) / h).long().clamp(0, VOX_NV - 1)

        def detector(p):
            u = p.uniform() * (1.0 - 2.0 ** -23) + 2.0 ** -24
            return {"dE": VOX_SIGMA * torch.special.ndtri(u),
                    "wt": torch.special.i0e(torch.atan2(p.vy, p.vx))}
        f32 = torch.Tensor.float
    else:
        def axis(x):
            return jnp.clip(((x + half) / h).astype(_I32), 0, VOX_NV - 1)

        def detector(p):
            u = p.uniform() * (1.0 - 2.0 ** -23) + 2.0 ** -24
            return {"dE": VOX_SIGMA * jsp.ndtri(u),
                    "wt": jsp.i0e(jnp.arctan2(p.vy, p.vx))}

        def f32(v):
            return v.astype(jnp.float32)

    def tally(p):
        idx = (axis(p.rx) * VOX_NV + axis(p.ry)) * VOX_NV + axis(p.rz)
        dE = p.extras["dE"]
        return {"bit0": f32(idx & 1), "bit9": f32((idx >> 9) & 1), "dE": dE,
                "dE2": dE * dE, "wt": p.extras["wt"] * p.w}

    red = P.ReduceMeasureStep(None, tally, outputs=(
        "bit0", "bit9", "dE", "dE2", "wt"), measure_n=True,
        extras=("dE", "wt"))
    return [P.UpdateTimeStep(lambda x: np.double(DT)),
            P.newton.NewtonianKinematicsStep(),
            P.light.ScatterIsotropicStep(A=0.01 / c_dt, n=1.0),
            P.ElementwiseStep(detector, extras_write=("dE", "wt")), red], red


def _voxel_run(P, n=1 << 12, iters=64):
    c = float(P.light.c)
    c_dt = c * DT
    kw = {"device": "cpu"} if P is T else {}
    s = P.Simulation(until_t=(iters - 0.5) * DT, seed=4, chunk_steps=32,
                     auto_shrink=False, **kw)
    steps, red = _voxel_steps(P, c_dt)
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(9)
    d = rng.normal(size=(3, n))
    half = VOX_NV * VOX_H * c_dt / 2
    bulk = P.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n), r=rng.uniform(-half, half, (3, n)),
        v=d / np.linalg.norm(d, axis=0) * c)
    bulk["extras"] = {"dE": np.zeros(n, np.float32),
                      "wt": np.zeros(n, np.float32)}
    s.add_photons(bulk)
    s.start()
    s.join()
    assert s.used_fused, s.explain_plan()
    return s, np.asarray(red.data, np.float64), c_dt


def test_voxel_index_path_matches_jax():
    ts, trow, c_dt = _voxel_run(T)
    js, jrow, _ = _voxel_run(J)
    assert (np.asarray(ts.ts, np.float64).tobytes()
            == np.asarray(js.ts, np.float64).tobytes())
    np.testing.assert_array_equal(trow[:, :2], jrow[:, :2])  # t, n
    assert (np.abs(trow[:, 2:4] - jrow[:, 2:4]) <= 2).all()
    scale = np.abs(jrow[:, 4:]).max(axis=0)
    assert (np.abs(trow[:, 4:] - jrow[:, 4:]) <= 1e-5 * scale).all()
    # the port's last row against its own final planes, exactly
    r = ts.sim_state.r.numpy()
    h = np.float32(VOX_H) * np.float32(c_dt)
    half = np.float32(VOX_NV * VOX_H / 2) * np.float32(c_dt)
    ax = [np.clip(np.trunc((x + half) / h).astype(np.int64), 0, VOX_NV - 1)
          for x in r]
    idx = (ax[0] * VOX_NV + ax[1]) * VOX_NV + ax[2]
    assert trow[-1, 2:4].tolist() == [float((idx & 1).sum()),
                                      float(((idx >> 9) & 1).sum())]
    from physicl_tpu_torch.ops.pipeline import try_build_fused

    plan = try_build_fused(ts, ts._ordered_steps(),
                           ts._init_run_state()).plan
    assert [op.kind for op in plan.ops] == ["kin", "iso", "custom",
                                           "reduce"]
    assert plan.ops[3].prog.typed()  # the index in int64


# -- an integer plane ------------------------------------------------------------


OTYPE_PLANE = 15


def _otype_program(fn):
    return RC.record_kernelstep(fn, otype_plane=OTYPE_PLANE)


def _run_otype(prog, otype, E):
    n = otype.shape[0]
    f = [torch.zeros(n) for _ in range(OTYPE_PLANE + 1)]
    f[12], f[13], f[14] = E.clone(), torch.ones(n), torch.ones(n)
    f[OTYPE_PLANE] = otype.to(torch.float32)
    class _Rng:  # no draws
        idx = 0

    RC.run_user_program(prog, f, torch.ones(n, dtype=torch.bool),
                        torch.zeros(()), torch.full((), DT), _Rng())
    return f


@pytest.mark.parametrize("case", ["compare", "arithmetic"])
def test_otype_plane_reads_as_its_float(case):
    """The otype plane (a float32 holding an exact int32) compared with a
    small constant or another read of it records its float32 load and no
    conversion, as before integers had a type; integer arithmetic on it
    converts it, exactly. Both against eager torch on int32 values."""
    otype = torch.tensor([0, 1, 2, 1, -3, 7, 16777216, -1], dtype=torch.int32)
    E = torch.linspace(0.5, 2.0, otype.shape[0])
    if case == "compare":
        def fn(state, ctx):
            ph = (state.otype == 1).to(torch.float32)
            lo = (state.otype <= 2).to(torch.float32) * (state.otype >= 0)
            return state.replace(E=state.E * (1.0 + ph) + lo
                                 + state.otype.float())
    else:
        def fn(state, ctx):
            k = state.otype * 16777217 + 3
            return state.replace(E=state.E + (k % 1024).float()
                                 + (k >> 20).float())
    prog = _otype_program(fn)
    assert prog.typed() == (case == "arithmetic")
    assert (RC.U_CVT in [ins[0] for ins in prog.ins]) == (case == "arithmetic")

    class S:
        pass

    st = S()
    st.otype, st.E = otype, E.clone()
    st.replace = lambda **kw: kw
    want = fn(st, None)["E"]
    got = _run_otype(prog, otype, E)[12]
    assert torch.equal(got, want.to(torch.float32))
