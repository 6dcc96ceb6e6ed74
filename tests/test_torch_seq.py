"""The op-sequence instantiations of ``fused_transport`` on the CPU: which
plans select them, and their integer collision test.

The CUDA kernel runs the main path's plans, ``[kin, iso, sign]`` and
``[kin, del, sign]``, through instantiations with the op sequence fixed at
compile time (``FusedPlan.kernel_seq``, variants 64 and 65), which test a
collision as ``(b >> 8) <= T`` with ``T = scatter_threshold(pcoll)`` per
iteration instead of ``pcoll >= unit24(b)``. The kernel itself is held
against the twin and the plan's form library on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``); here:

* the bench.py plan selects variant 64 and the extinction plan 65, and
  every near miss runs its form library (``FORM_VARIANT``);
* ``T(pcoll)`` agrees with the float compare for every 24-bit draw;
* the host's per-iteration ``pcoll`` is the twin's, bit for bit, and the
  integer test on the twin's draws picks exactly the photons the twin and
  the JAX package's emulated chunk scatter.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import physicl_tpu_torch as phys
from physicl_tpu.ops import fused as JF
from physicl_tpu_torch.ops import fused as TF
from physicl_tpu_torch.ops.pipeline import try_build_fused

C_LIGHT = 299792458.0
N = 1 << 12
CHUNK = 16


def _sim(absorb=False, chunk=CHUNK):
    """The bench.py steps (or the extinction run's, ``absorb``) at 2**12
    photons on the CPU, in chunks of ``chunk`` iterations."""
    light = phys.light
    sim = phys.Simulation(exit="extinction" if absorb else
                          (lambda s: s.t >= 0.0635), seed=3,
                          chunk_steps=chunk, device="cpu")
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    A = n = np.double(0.001)
    sim.add_step(2, light.ScatterDeleteStep(A, n) if absorb
                 else light.ScatterIsotropicStep(A=A, n=n))
    sim.add_step(3, light.ScatterSignMeasureStep(None, True))
    sim.add_photons(light.generate_photon_state(N, E=1.0))
    return sim


def _plan(sim):
    sim.explain_plan()
    return try_build_fused(sim, sim._ordered_steps(),
                           sim._init_run_state()).plan


@pytest.mark.parametrize("absorb,seq,variant",
                         [(False, ("kin", "iso", "sign"), 64),
                          (True, ("kin", "del", "sign"), 65)],
                         ids=["bench", "extinction"])
def test_main_plans_select_the_sequence_instantiation(absorb, seq, variant):
    plan = _plan(_sim(absorb))
    assert plan.kernel_seq == seq and TF.kernel_variant(plan) == variant
    assert TF.SEQ_VARIANTS[seq] == variant
    generic = dataclasses.replace(plan, specialize=False)
    assert generic.kernel_seq is None
    assert TF.kernel_variant(generic) == TF.FORM_VARIANT


def _main(**kw):
    """The bench plan's FusedPlan with ``kw`` replaced (a near miss)."""
    ops = [TF._Op("kin"), TF._Op("iso", coef=1e-6, c_val=C_LIGHT),
           TF._Op("sign", cols=(1, 2))]
    plan = TF.FusedPlan(ops=ops, n_rec_cols=5, chunk=CHUNK,
                        const_norm_speed=C_LIGHT)
    return dataclasses.replace(plan, **kw)


def _del(**kw):
    return TF._Op("del", coef=1e-6, c_val=C_LIGHT, **kw)


def _field():
    return phys.light._compile_variable_n("1.0")


NEAR_MISSES = {
    "weighted-sign": lambda: _main(
        ops=[TF._Op("kin"), TF._Op("iso", coef=1e-6, c_val=C_LIGHT),
             TF._Op("sign", cols=(1, 0), weighted=True)],
        n_rec_cols=2, n_frec_cols=3),
    "sign-without-alive-column": lambda: _main(
        ops=[TF._Op("kin"), TF._Op("iso", coef=1e-6, c_val=C_LIGHT),
             TF._Op("sign", cols=(-1, 1))], n_rec_cols=4),
    "wavelength-iso": lambda: _main(
        ops=[TF._Op("kin"), TF._Op("iso", coef=1.0, c_val=C_LIGHT,
                                   wl_base=4e-2),
             TF._Op("sign", cols=(1, 2))]),
    "field-iso": lambda: _main(
        ops=[TF._Op("kin"), TF._Op("iso", coef=1e-6, c_val=C_LIGHT,
                                   n_fn=_field()),
             TF._Op("sign", cols=(1, 2))]),
    "del-field": lambda: _main(ops=[TF._Op("kin"), _del(n_fn=_field()),
                                    TF._Op("sign", cols=(1, 2))]),
    "del-cross-section": lambda: _main(ops=[TF._Op("kin"),
                                            _del(a_fn=_field()),
                                            TF._Op("sign", cols=(1, 2))]),
    "del-capture": lambda: _main(ops=[TF._Op("kin"),
                                      _del(implicit_capture=True),
                                      TF._Op("sign", cols=(1, 2))]),
    "del-roulette": lambda: _main(ops=[TF._Op("kin"),
                                       _del(implicit_capture=True,
                                            roulette=(0.1, 0.5)),
                                       TF._Op("sign", cols=(1, 2))]),
    "del-stretch": lambda: _main(ops=[TF._Op("kin"),
                                      _del(stretch=(0.5, 1.0, 0.0, 0.0)),
                                      TF._Op("sign", cols=(1, 2))]),
    "del-fluorescence": lambda: _main(ops=[TF._Op("kin"),
                                           _del(fluor=(0.3, 0.5, 0.8)),
                                           TF._Op("sign", cols=(1, 2))]),
    "del-deposition": lambda: _main(ops=[TF._Op("kin"), _del(cols=(0,)),
                                         TF._Op("sign", cols=(1, 2))],
                                    n_frec_cols=1),
    "emitter": lambda: _main(
        ops=[TF._Op("emit", emit_n=64, emit_E=1.0, c_val=C_LIGHT),
             TF._Op("kin"), TF._Op("iso", coef=1e-6, c_val=C_LIGHT),
             TF._Op("sign", cols=(1, 2))]),
    "stream-plane": lambda: _main(n_stream=1),
    "extras": lambda: _main(extras=("dose",)),
    "speeds-not-const-norm": lambda: _main(const_norm_speed=None),
    "generic-requested": lambda: _main(specialize=False),
    # 32 B of shared memory an iteration: 7264 iterations fill a block's
    "chunk-over-shared-memory": lambda: _main(
        chunk=TF.MAX_SMEM_BYTES // TF.SEQ_SMEM_PER_ITER + 1),
}


@pytest.mark.parametrize("name", sorted(NEAR_MISSES))
def test_near_misses_keep_their_generic_instantiation(name):
    """A near miss runs its form's library, the same one as with
    ``specialize=False``."""
    from physicl_tpu_torch.ops import codegen as CG

    plan = NEAR_MISSES[name]()
    assert plan.kernel_seq is None
    assert TF.kernel_variant(plan) == TF.FORM_VARIANT
    generic = dataclasses.replace(plan, specialize=False)
    assert CG.form_source(generic) == CG.form_source(plan)


def test_the_bench_form_alone_selects_it():
    assert TF.kernel_variant(_main()) == 64
    assert TF.kernel_variant(_main(ops=[TF._Op("kin"), _del(),
                                        TF._Op("sign", cols=(1, 2))])) == 65
    assert TF.kernel_variant(_main(chunk=7264)) == 64


def test_bench_plan_at_chunk_8192_keeps_the_generic_instantiation():
    """The pipeline sizes a chunk by the form kernel's count tile (20 B an
    iteration for the bench plan's five columns), so chunk_steps = 8192
    stays 8192; the op-sequence launch would need 256 KB of shared memory
    there, so the plan runs its form library, which fits."""
    plan = _plan(_sim(chunk=8192))
    assert plan.chunk == 8192 and plan.n_rec_cols == 5
    assert plan.kernel_seq is None
    assert TF.kernel_variant(plan) == TF.FORM_VARIANT
    assert 8192 * plan.n_rec_cols * 4 <= TF.MAX_SMEM_BYTES


@pytest.mark.parametrize("pcoll", [0.0, -0.0, 2.0 ** -30, 2.0 ** -24, 0.3,
                                   1 - 2.0 ** -24, 1.0, 1.5, np.inf, -1.0,
                                   np.nan],
                         ids=["0", "-0", "2^-30", "2^-24", "0.3", "1-2^-24",
                              "1", "1.5", "inf", "-1", "nan"])
def test_threshold_agrees_with_the_float_compare(pcoll):
    """(b >> 8) <= T(pcoll) exactly where pcoll >= unit24(b), for every
    m = b >> 8 in [0, 2**24)."""
    t = int(TF.scatter_threshold(torch.tensor([pcoll],
                                              dtype=torch.float32))[0])
    m = np.arange(1 << 24, dtype=np.int64)
    unit = m.astype(np.float32) * np.float32(1.0 / (1 << 24))
    want = np.float32(pcoll) >= unit
    np.testing.assert_array_equal(m <= t, want)


def test_pcoll_row_is_the_twins_pcoll():
    """coef * (const_speed * dt) in float32, as the twin's dr_norm rounds
    it, at every iteration of the bench plan's first chunk; the schedule
    here mixes dt values so that roundings differ between iterations."""
    _, sched, _, _, plan, _ = chip_smoke.first_chunk_inputs(_sim(), TF)
    dt = np.random.default_rng(4).uniform(1e-4, 3e-3, CHUNK).astype(
        np.float32)
    sched = sched.clone()
    sched[0] = torch.from_numpy(dt)
    got = TF.pcoll_row(plan, sched).numpy()
    coef = np.float32(plan.ops[1].coef)
    speed = np.float32(plan.const_norm_speed)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  (coef * (speed * dt)).view(np.uint32))


def test_integer_test_picks_the_scattered_photons():
    """On the bench plan's first chunk, iteration by iteration, the photons
    the integer test (b >> 8) <= T picks are those the twin scatters (dv is
    non-zero only after a scatter); at the chunk's last iteration also those
    the JAX package's emulated chunk scatters."""
    packed, sched, seed, _, plan, _ = chip_smoke.first_chunk_inputs(
        _sim(), TF)
    thr = TF.scatter_threshold(TF.pcoll_row(plan, sched))
    lin = TF._slot_term(torch.arange(packed.shape[1], dtype=torch.int64))
    alive = packed[13] > 0
    picked = 0
    for k in range(CHUNK):
        bits = TF._HashRng(seed, k, lin).bits_at(1)
        want = alive & ((bits >> 8) <= int(thr[k]))
        out, _, _ = TF.fused_chunk_reference(packed, sched, seed, k + 1,
                                             plan)
        got = (out[9:12] != 0).any(dim=0) & alive
        assert torch.equal(got, want), k
        picked += int(want.sum())
    assert 0 < picked < CHUNK * int(alive.sum())
    jplan = JF.FusedPlan(
        ops=[JF._Op("kin"), JF._Op("iso", coef=plan.ops[1].coef,
                                   c_val=plan.ops[1].c_val),
             JF._Op("sign", cols=plan.ops[2].cols)],
        n_rec_cols=plan.n_rec_cols, chunk=CHUNK, tile_rows=128,
        interpret=True, const_norm_speed=plan.const_norm_speed,
        packed_angles=True, fast_trig=True)
    run = JF._build_emulated_chunk(jplan, packed.shape[1])
    j_out, _, _ = jax.device_get(run(
        jnp.asarray(packed.numpy()), sched.numpy(),
        np.zeros((1, CHUNK), np.int32), seed, CHUNK))
    np.testing.assert_array_equal((j_out[9:12] != 0).any(axis=0)
                                  & alive.numpy(), want.numpy())
