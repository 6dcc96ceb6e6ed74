"""Path tracing (``TracePathMeasureStep``): the PyTorch port against the JAX
package's fused path on the CPU.

Both packages trace into their chunk's stream buffer and assemble the
reference's matrix on the host. The same seeded ``Simulation`` gives:

* the same ``t`` row, death iterations (NaN padding) and ``trace_dv``
  frequencies exactly;
* positions within one ulp of the largest position per iteration (XLA's
  CPU backend contracts the sine polynomial of the isotropic resample into
  FMAs, so directions differ by an ulp and positions drift); runs without
  scattering, at a power-of-two dt (``r + v * dt`` is then exact), are
  bitwise equal, bfloat16 traces included;
* the stride, dtype and chunk the prover derives from ``max_record_bytes``.

The engine-side faults this slice repairs are held here too: a traced run
never recycles slots, and the valid-prefix trim hands stream records
through without copying them.
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
from physicl_tpu.ops import fused as JF
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.ops import pipeline as TP

DT = 2.0 ** -10  # c dt is exact: no FMA drift in r + v * dt
C_DT = 299792458.0 * DT
L = 64 * C_DT
BOX = ((0.0, L),) * 3


def _sim(P, n_iter, n=400, chunk=16, seed=3, scatter=True, absorb=0.004,
         trace_kw=None, hold=None, emitter=False, **kw):
    if P is T:
        kw["device"] = "cpu"
    s = P.Simulation(until_t=(n_iter - 0.5) * DT, seed=seed,
                     chunk_steps=chunk, **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    if emitter:
        s.add_step(1, P.light.PhotonEmitterStep(
            200, E=1.5, isotropic=True, r=(0.5 * L,) * 3))
    s.add_step(2, P.newton.NewtonianKinematicsStep())
    if scatter:
        s.add_step(3, P.light.ScatterIsotropicStep(A=0.1 / C_DT, n=1.0))
    if absorb:
        s.add_step(4, P.light.ScatterDeleteStep(1.0, absorb / C_DT))
    s.add_step(5, P.newton.ReflectingBoundaryStep(BOX))
    tr = P.light.TracePathMeasureStep(None, **(trace_kw or {}))
    if hold is not None:
        tr.device_hold_bytes = hold
    s.add_step(6, tr)
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.1, 0.9, (3, n)) * L
    d = rng.normal(size=(3, n))
    v = d / np.linalg.norm(d, axis=0) * float(P.light.c)
    s.add_photons(P.light.generate_photon_state(n, E=1.0, v=v, r=r))
    return s, tr


def _run(s):
    s.start()
    s.join()
    assert s.used_fused
    return s


def _both(*args, **kw):
    out = []
    for P in (J, T):
        s, tr = _sim(P, *args, **kw)
        out.append((_run(s), tr))
    return out


def _assert_rows_match(got, want, n_iter=0):
    """Matrix rows: ids, frequencies, death iterations and NaN padding
    equal; positions within one ulp of the largest position per iteration
    of ``n_iter`` (0: bitwise)."""
    assert got[0] == want[0]  # the t row
    assert len(got) == len(want)
    tol = n_iter * np.spacing(np.float32(L))
    for a, b in zip(got[1:], want[1:]):
        assert len(a) == len(b) and a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(y, np.ndarray):
                assert isinstance(x, np.ndarray) and x.dtype == y.dtype
                assert np.all(np.abs(x - y) <= tol), (x, y)
            elif isinstance(y, float) and np.isnan(y):
                assert isinstance(x, float) and np.isnan(x)
            else:
                assert x == y  # the trace_dv frequency


def test_trace_matrix_matches_jax_with_nan_padding_and_dv():
    """Scattering, absorption and a reflecting box over 3 chunks: the
    reference matrix row for row, NaN padding after death and scatter
    frequencies included."""
    (js, jt), (ts, tt) = _both(40, absorb=0.02, trace_kw={"trace_dv": True})
    assert ts.ts == js.ts
    rows, want = tt.data, jt.data
    _assert_rows_match(rows, want, len(ts.ts))
    assert len(rows) == 1 + 400  # one row per slot up to the spawn mark
    freq = np.array([r[1] for r in rows[1:401]])
    assert freq.sum() > 100 and (freq == np.array(
        [r[1] for r in want[1:401]])).all()
    dead = [r for r in rows[1:401] if isinstance(r[-1], float)]
    assert 0 < len(dead) < 400  # some photons died: NaN-padded tails
    assert all(np.isnan(x) for x in dead[0][-3:])


def test_as_arrays_shapes_and_dense_parity():
    (js, jt), (ts, tt) = _both(20, trace_kw={"trace_dv": True})
    jts, jpos, jalive, jfreq = jt.as_arrays()
    tts, tpos, talive, tfreq = tt.as_arrays()
    assert tpos.shape == jpos.shape == (20, 3, 16384)
    assert talive.shape == (20, 16384) and tfreq.shape == (16384,)
    assert tpos.dtype == np.float32 and tfreq.dtype == np.int64
    assert tts == jts == ts.ts
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_array_equal(tfreq, jfreq)
    tol = 20 * np.spacing(np.float32(L))
    assert np.all(np.abs(tpos - jpos)[np.broadcast_to(
        talive[:, None], tpos.shape)] <= tol)
    assert np.isnan(tpos[:, :, 400:]).all() and not talive[:, 400:].any()


def test_trace_every_across_chunk_boundaries():
    """trace_every=4 over chunks of 8 and a ragged 30-iteration run: the
    sampled rows and the t row equal JAX's, and equal every 4th row of the
    port's own unstrided trace bitwise."""
    (js, jt), (ts, tt) = _both(30, chunk=8, trace_kw={"trace_every": 4})
    s_full, full = _sim(T, 30, chunk=8)
    _run(s_full)
    jts, jpos, jalive, _ = jt.as_arrays()
    tts, tpos, talive, _ = tt.as_arrays()
    fts, fpos, falive, _ = full.as_arrays()
    assert tts == jts == list(np.asarray(ts.ts)[::4]) and len(tts) == 8
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_array_equal(tpos, fpos[::4])
    np.testing.assert_array_equal(talive, falive[::4])
    _assert_rows_match(tt.data, jt.data, len(ts.ts))


@pytest.mark.parametrize("every", [1, 2], ids=["every1", "every2"])
def test_bfloat16_trace_bitwise_equal_to_jax(every):
    """No scattering at a power-of-two dt: both packages move photons
    bitwise alike, so the bfloat16 traces (NaN after absorption) are
    bitwise equal, and equal the float32 trace rounded to nearest even."""
    kw = dict(scatter=False, absorb=0.05, chunk=16)
    (js, jt), (ts, tt) = _both(
        36, trace_kw={"trace_dtype": "bfloat16", "trace_every": every}, **kw)
    _, jpos, jalive, _ = jt.as_arrays()
    _, tpos, talive, _ = tt.as_arrays()
    np.testing.assert_array_equal(talive, jalive)
    np.testing.assert_array_equal(tpos, jpos)  # NaN where NaN
    assert np.isnan(tpos).any() and talive.any()
    s32, f32 = _sim(T, 36, **kw)
    _run(s32)
    _, pos32, _, _ = f32.as_arrays()
    rounded = torch.from_numpy(pos32[::every]).to(torch.bfloat16).float()
    np.testing.assert_array_equal(tpos, rounded.numpy())
    _assert_rows_match(tt.data, jt.data)


def test_twin_stream_matches_jax_emulated_stream():
    """The twin's stream buffer against the JAX emulated chunk's, plane for
    plane: trace positions and flags (float32) and bfloat16 positions every
    3rd iteration (rows past ceil(k_act / 3) NaN on both)."""
    C, chunk, k_act = 16384, 32, 29
    rng = np.random.default_rng(4)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.uniform(0.1, 0.9, (3, C)) * L
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * 299792458.0
    p[12] = 1.0
    p[13] = rng.uniform(size=C) < 0.8
    p[14] = 1.0
    sched = np.zeros((5, chunk), np.float32)
    sched[0] = DT
    for dtype, every, scat in (("float32", 1, True), ("bfloat16", 3, False)):
        ops = [("kin", {}), ("del", dict(coef=0.02 / C_DT)),
               ("reflect", dict(bounds=BOX)),
               ("trace", dict(stream0=0, stream_scat=scat,
                              stream_every=every))]
        n_stream = 4 if scat else 3
        jplan = JF.FusedPlan(
            ops=[JF._Op(k, **kw) for k, kw in ops], n_rec_cols=1,
            chunk=chunk, tile_rows=128, interpret=True, packed_angles=True,
            fast_trig=True, n_stream=n_stream, stream_every=every,
            stream_dtype=dtype)
        tplan = TF.FusedPlan(
            ops=[TF._Op(k, **kw) for k, kw in ops], n_rec_cols=1,
            chunk=chunk, n_stream=n_stream, stream_every=every,
            stream_dtype=dtype)
        run = JF._build_emulated_chunk(jplan, C)
        *_, j_stream = jax.device_get(run(
            jnp.asarray(p), sched, np.zeros((1, chunk), np.int32), 9, k_act))
        *_, t_stream = TF.fused_chunk_reference(
            torch.from_numpy(p), torch.from_numpy(sched), 9, k_act, tplan)
        assert t_stream.dtype == tplan.stream_torch_dtype
        assert t_stream.shape == j_stream.shape == (
            -(-chunk // every), n_stream, C)
        np.testing.assert_array_equal(t_stream.float().numpy(),
                                      np.asarray(j_stream, np.float32))
        assert np.isnan(t_stream[-(-k_act // every):].float().numpy()).all()


# -- the prover's stride, dtype and chunk -------------------------------------

_PROVER_CASES = {
    "f32": ([{}], None, 8),
    "bf16": ([{"trace_dtype": "bfloat16"}], None, 8),
    "gcd-lcm": ([{"trace_every": 4}, {"trace_every": 6}], None, 8),
    "bf16-with-E-list": ([{"trace_dtype": "bfloat16"}], "list", 8),
    "stride-over-chunk": ([{"trace_every": 5000}], None, 2),
    "budget-only": ([{"trace_every": 3}], None, 40),
}


@pytest.mark.parametrize("case", sorted(_PROVER_CASES))
def test_prover_stream_plan_matches_jax(case):
    from physicl_tpu.ops.pipeline import try_build_fused as j_build
    from physicl_tpu.state import SimState as JState

    traces, e_mode, rows = _PROVER_CASES[case]
    plans = []
    for P in (J, T):
        kw = {} if P is J else {"device": "cpu"}
        s = P.Simulation(until_t=1.0, seed=0, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        for i, tkw in enumerate(traces, start=2):
            s.add_step(i, P.light.TracePathMeasureStep(None, **tkw))
        if e_mode:
            s.add_step(9, P.light.ScatterMeasureStep(
                None, True, [(1.0, np.nan, np.nan)], measure_E=True))
        s.add_photons(P.light.generate_photon_state(2048, E=1.0))
        steps = s._ordered_steps()
        for st in steps:
            st.setup(s)
        if P is J:
            state = JState.from_population(s._pending_objects,
                                           s._pending_bulk)
            planes = sum(3 for _ in traces) + (1 if e_mode else 0)
            s.max_record_bytes = rows * planes * state.capacity * 4
            plan = j_build(s, steps, state).plan
        else:
            s.max_record_bytes = plans[0][4]
            plan = TP.try_build_fused(s, steps, s._init_run_state()).plan
        plans.append((plan.chunk, plan.stream_every, plan.stream_dtype,
                      plan.n_stream, s.max_record_bytes))
    assert plans[0] == plans[1]


def test_max_record_bytes_default_and_override():
    s = T.Simulation(device="cpu")
    assert s.max_record_bytes == 2 << 30  # the CPU: host memory
    s.max_record_bytes = 512 << 20
    assert s.max_record_bytes == 512 << 20
    assert T.Simulation(device="cpu",
                        max_record_bytes=1 << 20).max_record_bytes == 1 << 20


# -- spilling, emitters, the engine's contracts --------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spill_keeps_the_rows(dtype):
    """A hold smaller than one chunk's buffer moves every chunk but the
    newest to host memory; the matrix is the same as unspilled, and as
    JAX's."""
    kw = dict(chunk=8, trace_kw={"trace_dtype": dtype, "trace_dv":
                                 dtype == "float32"})
    hold = 5 << 19  # f32 with flags: 2 MiB per chunk; bf16: 0.75 MiB
    s_big, big = _sim(T, 30, **kw)
    s_small, small = _sim(T, 30, hold=hold, **kw)
    _run(s_big), _run(s_small)
    assert all(isinstance(x.buf, torch.Tensor) for x in big._pos)
    spilled = [isinstance(x.buf, np.ndarray) for x in small._pos]
    assert spilled[0] and not spilled[-1] and len(spilled) == 4
    assert sum(x.buf.nbytes for x in small._pos
               if isinstance(x.buf, torch.Tensor) is False) > 0
    for a, b in zip(small.as_arrays(), big.as_arrays()):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    js, jt = _sim(J, 30, hold=hold, **kw)
    _run(js)
    _assert_rows_match(small.data, jt.data, len(js.ts))


def test_trace_with_emitter_never_recycles():
    """A trace's rows are slots, so an emitter under a trace stops at
    capacity instead of recycling (the JAX package's rule): spawn marks,
    alive planes and trace rows agree with JAX's."""
    (js, jt), (ts, tt) = _both(100, n=100, chunk=8, emitter=True,
                               absorb=0.05, scatter=False,
                               capacity=16384)
    kinds = [e[0] for e in ts.population_log]
    assert kinds == ["capacity-stop"]
    assert "recycle" not in kinds
    assert int(ts.sim_state.n_spawned) == int(jax.device_get(
        js.sim_state.n_spawned)) == 100 + 81 * 200
    np.testing.assert_array_equal(ts.sim_state.alive.numpy(),
                                  np.asarray(js.sim_state.alive))
    assert ts._hwm == js._hwm == 100 + 81 * 200
    rows, want = tt.data, jt.data
    assert len(rows) == len(want) == 1 + 100 + 81 * 200
    _assert_rows_match(rows[:300], want[:300], len(ts.ts))


def test_stable_ids_guard_recycling():
    """``_population_policies`` (``(shrink_ok, recycle_ok,
    emit_per_iter)``, the JAX package's triple): an emitter recycles slots
    unless a step needs stable ids, and never shrinks."""
    s, _ = _sim(T, 10, emitter=True)
    assert s._population_policies() == (False, False, 200)
    s.remove_step(6)
    assert s._population_policies() == (False, True, 200)


def test_collect_records_passes_stream_records_through():
    """The engine's valid-prefix trim hands a stream record on as a bound
    (same buffer, no copy), and slices host arrays as views."""
    got = {}

    class Probe(T.Step):
        def collect(self, sim, records):
            got.update(records)

    sim = T.Simulation(device="cpu")
    probe = Probe()
    probe._step_uid = "s0"
    buf = torch.zeros((4, 3, 128))
    raw = TP._TraceRaw(hold=TP._StreamHold(buf), p0=0, scat=False, every=2)
    t = np.arange(8, dtype=np.float32)
    sim._collect_records([probe], {"s0/traceraw": raw, "s0/t": t}, 5)
    assert got["traceraw"].n_valid == 5 and got["traceraw"].buf is buf
    assert got["t"].base is t and len(got["t"]) == 5
    with pytest.raises(TypeError, match="prefix"):
        raw[1:3]


def test_extinction_trims_the_trace_to_valid_iterations():
    """An extinction run ends mid-chunk: the trace keeps only the valid
    iterations (its sampled count follows them, not the chunk)."""
    rows = {}
    for P in (J, T):
        kw = dict(auto_shrink=False, **({} if P is J else {"device": "cpu"}))
        s = P.Simulation(exit="extinction", seed=2, chunk_steps=16, **kw)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        s.add_step(2, P.light.ScatterDeleteStep(1.0, 0.15 / C_DT))
        tr = P.light.TracePathMeasureStep(None, trace_every=2)
        s.add_step(3, tr)
        s.add_photons(P.light.generate_photon_state(64, E=1.0))
        _run(s)
        rows[P] = (s, tr)
    (js, jt), (ts, tt) = rows[J], rows[T]
    assert ts.ts == js.ts and len(ts.ts) % 16
    assert tt._seen == len(ts.ts)
    assert tt.as_arrays()[0] == list(np.asarray(ts.ts)[::2])
    _assert_rows_match(tt.data, jt.data)
