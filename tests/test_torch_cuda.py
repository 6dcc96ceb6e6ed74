"""The CUDA kernels ``fused_transport`` and ``planck_gen`` against their
plain PyTorch twins.

Needs a CUDA device and ``nvcc``: every test here is marked ``cuda`` and
skips without a device. This file imports neither JAX nor the JAX package,
so it runs on a machine that has only torch with CUDA (tests/conftest.py
imports JAX, hence ``--noconftest``):

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and twin round every product and sum the same way (the kernel is
built with ``--fmad=false`` and spells ``1.0f / sqrtf``), so int records,
float planes and Planck energies are asserted bitwise equal. Float records
(``rec_f``) are sums in another order (the kernel's fixed warp/block tree,
``torch.sum`` in the twin): equal within rtol 1e-5 + atol 1e-6 * the
column's largest value, and bitwise equal between two runs of the kernel.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops import planck as P

pytestmark = pytest.mark.cuda

C_LIGHT = 299792458.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    return torch.device("cuda")


def _inputs(dev, C=1 << 16, chunk=64, seed=2):
    rng = np.random.default_rng(seed)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.normal(size=(3, C)) * 1e3
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * C_LIGHT
    p[12] = rng.uniform(0.5, 2.0, C)
    p[13] = rng.uniform(size=C) < 0.9
    p[14] = 1.0
    s = np.zeros((5, chunk), np.float32)
    s[0] = 0.001
    return torch.from_numpy(p).to(dev), torch.from_numpy(s).to(dev)


def _plan(kinds, const_norm, chunk=64, wl_base=None):
    ops = []
    for k in kinds:
        if k in ("iso", "del"):
            ops.append(F._Op(k, coef=1e-6 if wl_base is None else 1.0,
                             c_val=C_LIGHT,
                             wl_base=wl_base if k == "iso" else None))
        elif k == "sign":
            ops.append(F._Op(k, cols=(1, 2)))
        else:
            ops.append(F._Op(k))
    return F.FusedPlan(ops=ops, n_rec_cols=5, chunk=chunk,
                       const_norm_speed=C_LIGHT if const_norm else None)


@pytest.mark.parametrize("const_norm", [True, False], ids=["cnorm", "norm"])
@pytest.mark.parametrize("kinds", [("kin", "iso", "sign"),
                                   ("kin", "del", "iso", "sign")],
                         ids=["kin-iso-sign", "kin-del-iso-sign"])
def test_kernel_matches_twin(dev, kinds, const_norm):
    packed, sched = _inputs(dev)
    plan = _plan(kinds, const_norm)
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, 12345, 50, plan)
    ref, ref_rec, _ = F.fused_chunk_reference(packed, sched, 12345, 50,
                                              plan)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref)
    assert not rec_f.any()


# -- the op-sequence instantiations (variants 64 and 65) ---------------------

def _seq_plan(mid, chunk, coef=1e-6, speed=C_LIGHT):
    return F.FusedPlan(ops=[F._Op("kin"), F._Op(mid, coef=coef, c_val=C_LIGHT),
                            F._Op("sign", cols=(1, 2))],
                       n_rec_cols=5, chunk=chunk, const_norm_speed=speed)


# dt rows that make pcoll = dt (coef = const_speed = 1): 0, 2**-25,
# 1 - 2**-24, 1 and 1.5 in turn
EDGE_PCOLL = (0.0, 2.0 ** -25, 1 - 2.0 ** -24, 1.0, 1.5)


@pytest.mark.parametrize("edge", [False, True], ids=["main", "edge"])
@pytest.mark.parametrize("mid", ["iso", "del"])
def test_sequence_kernel_matches_generic_and_twin(dev, mid, edge):
    """At 2**20 x 256 the op-sequence instantiation gives the generic
    variant 0's and the twin's planes and int records, bit for bit, on the
    main plan's schedule and on one whose pcoll hits the threshold's
    edges."""
    K = 256
    packed, sched = _inputs(dev, C=1 << 20, chunk=K, seed=5)
    if edge:
        plan = _seq_plan(mid, K, coef=1.0, speed=1.0)
        if mid == "del":  # every photon dies at pcoll >= 1 - 2**-24
            row = ([0.0, 2.0 ** -25] * K)[:K - 3] + list(EDGE_PCOLL[2:])
        else:
            row = list(EDGE_PCOLL) * (K // 5 + 1)
        sched[0] = torch.tensor(row[:K], dtype=torch.float32, device=dev)
    else:
        plan = _seq_plan(mid, K, coef=1e-6 if mid == "iso" else 1e-8)
    generic = dataclasses.replace(plan, specialize=False)
    assert plan.kernel_variant == (64 if mid == "iso" else 65)
    assert generic.kernel_variant == 0
    before = F.fused_transport.seq_launches
    outs = [torch.empty_like(packed) for _ in range(2)]
    recs = [F.fused_transport(packed, o, sched, 99, K, p)[0]
            for o, p in zip(outs, (plan, generic))]
    ref, ref_rec, _ = F.fused_chunk_reference(packed, sched, 99, K, plan)
    torch.cuda.synchronize()
    assert F.fused_transport.seq_launches == before + 1
    assert torch.equal(recs[0], recs[1]) and torch.equal(recs[0], ref_rec)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], ref)
    assert ref_rec[K - 1, 0] > 0 or mid == "del"


@pytest.mark.parametrize("chunk", [7264, 8192])
def test_long_chunks_launch_and_match_twin(dev, chunk):
    """The bench plan at 7264 iterations (the most whose op-sequence
    launch fits a block's 227 KB of shared memory) runs variant 64, and at
    8192 (which the pipeline allows: 20 B of generic tile an iteration)
    the generic variant 0; both launch and equal the twin bit for bit."""
    packed, sched = _inputs(dev, C=1 << 12, chunk=chunk, seed=7)
    plan = _seq_plan("iso", chunk)
    assert plan.kernel_variant == (64 if chunk == 7264 else 0)
    before = F.fused_transport.seq_launches
    out = torch.empty_like(packed)
    rec, _ = F.fused_transport(packed, out, sched, 31, chunk, plan)
    ref, ref_rec, _ = F.fused_chunk_reference(packed, sched, 31, chunk, plan)
    torch.cuda.synchronize()
    assert F.fused_transport.seq_launches == before + (chunk == 7264)
    assert torch.equal(rec, ref_rec) and torch.equal(out, ref)


def test_sequence_kernel_reciprocal_root_is_exact(dev):
    """rsqrt_rn_near1 equals 1.0f / sqrtf on every float32 of [0.5, 2),
    and every draw pair's squared norm lies there."""
    got = F.rsqrt_near1_check(dev)
    assert got["mismatches"] == 0 and got["out_of_range"] == 0, got
    assert 0.99 < got["n2_min"] <= got["n2_max"] < 1.01


def test_kernel_wavelength_weighting_and_in_place(dev):
    packed, sched = _inputs(dev, seed=3)
    plan = _plan(("kin", "iso", "sign"), True, wl_base=4e-2)
    ref, ref_rec, _ = F.fused_chunk_reference(packed, sched, 7, 64, plan)
    before = F.fused_transport.launches
    out, rec, _ = F.fused_chunk(packed, sched, 7, 64, plan)  # in place
    torch.cuda.synchronize()
    assert F.fused_transport.launches == before + 1
    assert out.data_ptr() == packed.data_ptr()
    assert torch.equal(rec, ref_rec) and torch.equal(out, ref)


def test_kernel_empty_chunk_copies_the_state(dev):
    """k_act = 0 (a t-exit on a chunk boundary) still writes ``out``."""
    packed, sched = _inputs(dev, seed=4)
    plan = _plan(("kin", "iso", "sign"), True)
    out = torch.full_like(packed, float("nan"))
    before = F.fused_transport.launches
    rec, _ = F.fused_transport(packed, out, sched, 7, 0, plan)
    torch.cuda.synchronize()
    assert F.fused_transport.launches == before + 1
    assert torch.equal(out, packed) and not rec.any()


def test_kernel_refuses_bad_inputs(dev):
    packed, sched = _inputs(dev)
    plan = _plan(("kin", "sign"), False)
    with pytest.raises(ValueError, match="contiguous float32"):
        F.fused_transport(packed.double(), packed.double(), sched, 0, 4,
                          plan)
    with pytest.raises(ValueError, match="k_act"):
        F.fused_transport(packed, packed, sched, 0, 65, plan)


K_B = 1.380649e-23


def _planck_table(window=(0.1, 12.0)):
    """The fit table of the chip_smoke window, built by the port's own
    host math (no JAX on the card's machine)."""
    import physicl_tpu_torch.light as light

    kT = K_B * 5778.0
    return P.icdf_table(light._planck_poly_data(window[0] * kT,
                                                window[1] * kT, 5778.0,
                                                2000))


@pytest.mark.parametrize("window", [(0.1, 12.0), (0.1, 30.0)], ids=str)
def test_planck_gen_matches_twin(dev, window):
    table = _planck_table(window)
    before = P.planck_gen.launches
    got = P.planck_gen(99, 300_001, table, 1.0, dev)
    want = P.planck_gen_reference(99, 300_001, table, 1.0, dev)
    torch.cuda.synchronize()
    assert P.planck_gen.launches == before + 1
    assert torch.equal(got, want) or (
        torch.equal(torch.isnan(got), torch.isnan(want))
        and torch.equal(got.nan_to_num(), want.nan_to_num()))
    scaled = P.planck_gen(99, 1000, table, 100.0, dev)
    assert torch.equal(scaled, P.planck_gen_reference(99, 1000, table,
                                                      100.0, dev))


def _emit_plan(chunk, sampled, table):
    """[emit(Planck or const), kin, iso, del, cross] with energy sums, or
    [emit(const, directed), kin, cross(weighted)]."""
    if sampled:
        ops = [F._Op("emit", emit_n=1000, c_val=C_LIGHT, emit_table=table,
                     emit_scale=1.0, emit_r=(1.0, 2.0, 3.0)),
               F._Op("kin"),
               F._Op("iso", coef=1e-7, c_val=C_LIGHT),
               F._Op("del", coef=1e-8),
               F._Op("cross", cols=(1,), axes=(
                   (0, 3e5, 2, 0), (1, -3e5, 3, 1), (2, 1e5, 4, 2)))]
        return F.FusedPlan(ops=ops, n_rec_cols=5, chunk=chunk,
                           const_norm_speed=C_LIGHT, n_frec_cols=3)
    ops = [F._Op("emit", emit_n=500, emit_E=2.0,
                 emit_v=(0.0, C_LIGHT, 0.0)),
           F._Op("kin"),
           F._Op("cross", cols=(-1,), weighted=True,
                 axes=((1, 3e5, 0, 1), (0, 3e5, 2, 3)))]
    return F.FusedPlan(ops=ops, n_rec_cols=1, chunk=chunk, n_frec_cols=4)


def _emit_schedule(dev, plan, C, first):
    k = plan.chunk
    starts = torch.full((1, k), -(2 ** 30), dtype=torch.int32)
    n = plan.ops[0].emit_n
    fits = min(k, (C - first) // n)
    starts[0, :fits] = first + n * torch.arange(fits, dtype=torch.int32)
    return starts.to(dev)


def _close_f(got, want):
    scale = want.abs().amax(dim=0, keepdim=True)
    return bool(((got - want).abs() <= 1e-5 * want.abs()
                 + 1e-6 * scale).all())


@pytest.mark.parametrize("sampled", [True, False], ids=["planck", "const"])
def test_emit_cross_plans_match_twin(dev, sampled):
    packed, sched = _inputs(dev, seed=6)
    packed[13, 40000:] = 0.0  # free slots for the emitter
    plan = _emit_plan(64, sampled, _planck_table() if sampled else None)
    starts = _emit_schedule(dev, plan, packed.shape[1], 40000)
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, 4242, 60, plan,
                                   emit_starts=starts)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, 4242, 60,
                                                  plan, starts)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref)
    assert _close_f(rec_f, ref_f)
    assert rec_f[:60, :plan.n_frec_cols].abs().sum() > 0
    assert (ref[13] > 0).sum() > (packed[13] > 0).sum()  # emitted


def test_rec_f_is_deterministic(dev):
    """Float records come from a fixed summation order: two runs of the
    same chunk agree bitwise."""
    packed, sched = _inputs(dev, C=1 << 18, seed=8)
    plan = _emit_plan(64, True, _planck_table())
    starts = _emit_schedule(dev, plan, packed.shape[1], 1 << 17)
    packed[13, 1 << 17:] = 0.0
    runs = [F.fused_transport(packed, torch.empty_like(packed), sched, 5,
                              64, plan, emit_starts=starts)
            for _ in range(3)]
    torch.cuda.synchronize()
    for rec, rec_f in runs[1:]:
        assert torch.equal(rec, runs[0][0])
        assert torch.equal(rec_f, runs[0][1])


# -- media plans: fields, implicit capture, roulette, deposition, absorb --

@pytest.mark.parametrize("name", ["media-voxel-trilinear-capture",
                                  "media-voxel-nearest-analog",
                                  "media-layered-r-z", "media-expr"])
def test_media_plans_match_twin(dev, name):
    """The four media plans ``chip_smoke.py`` holds at 2**20 x 256, here at
    2**16 x 64 on 16**3 grids."""
    import physicl_tpu_torch.light as light
    from chip_smoke import media_packed, media_plans

    S = 4 * C_LIGHT * 0.001
    packed = torch.from_numpy(media_packed(1 << 16, S, 16, 10)).to(dev)
    sched = torch.zeros((5, 64), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    plan = media_plans(F, light, 64, S, 16)[name]
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, 77, 60, plan)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, 77, 60,
                                                  plan)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref)
    assert _close_f(rec_f, ref_f)
    if plan.n_frec_cols:
        assert rec_f[:60, :plan.n_frec_cols].abs().sum() > 0
    # something happened: scattering moved photons off their directions
    assert not torch.equal(out[6:9], packed[6:9])
    if name == "media-voxel-trilinear-capture":
        w = out[14][out[13] > 0]
        assert (w < 1).any() and int(rec[59, 0]) < int(rec[0, 0])


# -- stream planes and the remaining geometry --

@pytest.mark.parametrize("name", ["geom-reflect-trace-f32-dv",
                                  "geom-periodic-trace-bf16-every4",
                                  "geom-del-scross-w-sabsorb-in-cross-ecap",
                                  "geom-sabsorb-scross"])
@pytest.mark.parametrize("k_act", [60, 64], ids=["k60", "k64"])
def test_geometry_plans_match_twin(dev, name, k_act):
    """The four geometry plans ``chip_smoke.py`` holds at 2**20 x 256, here
    at 2**16 x 64: int records equal, planes and stream buffers bitwise
    (NaN for NaN), the rows past ceil(k_act / stride) NaN."""
    from chip_smoke import geometry_packed, geometry_plans, stream_equal

    L = 64 * C_LIGHT * 0.001
    packed = torch.from_numpy(geometry_packed(1 << 16, L, 12)).to(dev)
    sched = torch.zeros((5, 64), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    plan = geometry_plans(F, 64, L)[name]
    out = torch.empty_like(packed)
    got = F.fused_transport(packed, out, sched, 91, k_act, plan)
    want = F.fused_chunk_reference(packed, sched, 91, k_act, plan)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[1])
    assert torch.equal(out, want[0])
    assert _close_f(got[1], want[2])
    if plan.n_stream:
        assert stream_equal(got[2], want[3])
        filled = -(-k_act // plan.stream_every)
        assert torch.isnan(got[2][filled:].float()).all()
        assert not torch.isnan(got[2][:filled].float()).all()
    else:
        assert len(got) == 2


# -- the rotation family, the interface and the del variants --

@pytest.mark.parametrize("name", ["rot-hg", "rot-rayl-wl", "rot-phase-mie",
                                  "rot-compton-kn-dep",
                                  "rot-compton-thermal", "rot-fresnel",
                                  "rot-fresnel-match", "rot-del-stretch-w",
                                  "rot-del-fluor-dep"])
def test_scatter_plans_match_twin(dev, name):
    """The nine plans ``chip_smoke.py`` holds at 2**20 x 256, here at 2**16
    x 64: int records equal, planes bitwise, rec_f within tolerance; the
    plans run the rotation instantiation."""
    import physicl_tpu_torch.light as light
    from chip_smoke import geometry_packed, scatter_plans

    L = 64 * C_LIGHT * 0.001
    packed = torch.from_numpy(geometry_packed(1 << 16, L, 12)).to(dev)
    sched = torch.zeros((5, 64), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    plan = scatter_plans(F, light, 64, L)[name]
    assert plan.kernel_variant & 4
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, 91, 60, plan)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, 91, 60,
                                                  plan)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref)
    assert _close_f(rec_f, ref_f)
    assert not torch.equal(out, packed)


# -- charged particles and mixed populations --

@pytest.mark.parametrize("name", ["lor-species-EB", "lor-qm-B",
                                  "lor-photon-noop", "lor-before-update",
                                  "mixed", "mixed-emit-qm"])
def test_lorentz_plans_match_twin(dev, name):
    """The six plans ``chip_smoke.py`` holds at 2**20 x 256, here at 2**16
    x 64 over a growing-dt schedule: int records equal, every plane (the
    extras included) bitwise, in place equal to out of place; the plans
    run the mixed instantiation."""
    from chip_smoke import lorentz_inputs, lorentz_plans

    plan, photons = lorentz_plans(F, 64)[name]
    assert plan.kernel_variant & 8
    packed, sched, starts = lorentz_inputs(torch, plan, photons, 1 << 16,
                                           64, dev, 5)
    out = torch.empty_like(packed)
    rec, _ = F.fused_transport(packed, out, sched, 91, 60, plan,
                               emit_starts=starts)
    ref, ref_rec, _ = F.fused_chunk_reference(packed, sched, 91, 60, plan,
                                              starts)
    inplace = packed.clone()
    F.fused_transport(inplace, inplace, sched, 91, 60, plan,
                      emit_starts=starts)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref) and torch.equal(inplace, ref)
    assert not torch.equal(out[6:9], packed[6:9])
    if starts is not None:  # emitted slots became photons
        half = packed.shape[1] // 2
        assert bool((out[15, half:half + 2048] == 1).all())


def test_record_tile_plan_matches_twin(dev):
    """The record-tile plan (3 int + 7 float record columns) as its
    provider hands it over: the chunk clamped to 984, the kernel equal to
    the twin on chunk 0."""
    import physicl_tpu_torch as phys
    from chip_smoke import first_chunk_inputs, tile_sim

    packed, sched, seed, k, plan, _ = first_chunk_inputs(
        tile_sim(phys, 1 << 16, dev, 1000)[0], F)
    assert plan.chunk == k == 984
    assert (plan.n_rec_cols, plan.n_frec_cols) == (3, 7)
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, seed, k, plan)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, seed, k,
                                                  plan)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref)
    assert _close_f(rec_f, ref_f)
    assert rec_f[:k, :7].abs().sum() > 0


# -- polarized transport --

@pytest.mark.parametrize("name", ["pol", "pol-wl", "pol-expr", "polc",
                                  "polc-kn-dep", "polmeas-w-qu",
                                  "pol-polmeas", "emit-pol-directed",
                                  "emit-iso-circular", "fluor-pol-planes",
                                  "mixed-pol"])
def test_polarized_plans_match_twin(dev, name):
    """The eleven plans ``chip_smoke.py`` holds at 2**20 x 256, here at
    2**16 x 64: int records equal, every plane (the Stokes and frame rows
    included) bitwise, rec_f within tolerance, in place equal to out of
    place; the plans run the polarization instantiation."""
    import physicl_tpu_torch as phys
    from chip_smoke import pol_inputs, pol_plans

    plan, photons = pol_plans(F, phys.light, 64)[name]
    assert plan.kernel_variant & 24 == 24
    packed, sched, starts = pol_inputs(torch, plan, photons, 1 << 16, 64,
                                       dev, 5)
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, 91, 60, plan,
                                   emit_starts=starts)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, 91, 60,
                                                  plan, starts)
    inplace = packed.clone()
    F.fused_transport(inplace, inplace, sched, 91, 60, plan,
                      emit_starts=starts)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref) and torch.equal(inplace, ref)
    assert _close_f(rec_f, ref_f)
    if plan.extras_writeback:
        assert not torch.equal(out[15:21], packed[15:21])


def test_polarized_simulation_card_equals_cpu(dev):
    """A polarized Simulation (a polarized source, Rayleigh and Compton
    scatter, the Stokes tally, recycling) on the card and on the CPU twin:
    equal ``sim.ts``, records and final planes."""
    import physicl_tpu_torch as phys
    import physicl_tpu_torch.polarization as pol

    runs = {}
    for where in ("cuda", "cpu"):
        c_dt = float(phys.light.c) * 1e-3
        s = phys.Simulation(until_t=0.0955, seed=4, capacity=8192,
                            chunk_steps=16, device=where)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, phys.light.PhotonEmitterStep(
            100, E=1.0, stokes=(1.0, 0.0, 0.0)))
        s.add_step(2, phys.newton.NewtonianKinematicsStep())
        s.add_step(3, pol.ScatterPolarizedRayleighStep(A=0.1 / c_dt, n=1.0))
        s.add_step(4, pol.ScatterPolarizedComptonStep(
            A=0.05 / c_dt, n=1.0, mec2=1.0, measure_deposition=True))
        s.add_step(5, phys.light.ScatterDeleteStep(0.1 / c_dt, 1.0))
        meas = pol.StokesMeasureStep(None, weighted=True)
        s.add_step(6, meas)
        s.add_photons(pol.polarized_photon_state(2000, E=1.0,
                                                 stokes=(0.0, 0.6, 0.8)))
        s.start()
        s.join()
        st = s.sim_state
        runs[where] = (s.ts, np.asarray(meas.data), st.alive.cpu(),
                       torch.cat([st.v, st.extras["stokes"],
                                  st.extras["pol_ref"]]).cpu(),
                       s.population_log)
    (gt, gm, ga, gp, gl), (ct, cm, ca, cp, cl) = runs["cuda"], runs["cpu"]
    assert gt == ct and gl == cl and any(e[0] == "recycle" for e in gl)
    assert torch.equal(ga, ca)
    assert torch.equal(gp[:, ga], cp[:, ca])
    np.testing.assert_array_equal(gm[:, :2], cm[:, :2])
    np.testing.assert_allclose(gm, cm, rtol=1e-5, atol=1e-6)


# -- user code (kernel 1i) --

@pytest.mark.parametrize("case", ["custom", "custom-draws", "custom-extras",
                                  "reduce-n", "mesh-x-path",
                                  "mesh-r-weighted", "kstate-mixed",
                                  "reduce-weighted", "fluor-callable",
                                  "past-limits"])
def test_user_plans_match_twin(dev, case):
    """The ten plans ``chip_smoke.py`` holds at 2**20 x 256 (recorded user
    programs, the histogram tallies, a recorded A(E) field, a program past
    the former interpreter's limits), here at 2**16 x 64 as their providers
    hand them over: int records equal, every plane (the written-back
    extras included) bitwise, rec_f within tolerance, in place equal to out
    of place; the user plans run the user instantiation of a library
    generated for the plan (``ops/codegen.py``)."""
    import physicl_tpu_torch as phys
    from chip_smoke import first_chunk_inputs, user_plan_sim

    packed, sched, seed, k, plan, starts = first_chunk_inputs(
        user_plan_sim(phys, case, dev, n=1 << 16, chunk=64), F)
    assert plan.kernel_variant & 40 == 40 or case == "fluor-callable"
    if plan.has_user:
        name = os.path.basename(F._library(plan)._name)
        assert name.startswith("libfused_plan_")
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, seed, k, plan)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, seed, k,
                                                  plan)
    inplace = packed.clone()
    F.fused_transport(inplace, inplace, sched, seed, k, plan)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref) and torch.equal(inplace, ref)
    assert _close_f(rec_f, ref_f)


def test_user_simulation_card_equals_cpu(dev):
    """The user path (drag, decay with a written-back dose, the moments
    tally) and the spectrum path at 2**14 photons on the card and on the
    CPU twin: equal ``sim.ts``, records and final planes."""
    import physicl_tpu_torch as phys
    from chip_smoke import spectrum_sim, user_sim

    for build in (lambda where: user_sim(phys, 1 << 14, where, iters=96,
                                         chunk=32),
                  lambda where: spectrum_sim(phys, 1 << 14, where,
                                             iters=70)):
        runs = {}
        for where in ("cuda", "cpu"):
            sim, *tallies = build(torch.device(where))
            sim.start()
            sim.join()
            st = sim.sim_state
            planes = [st.v, st.E[None]] + [
                x.reshape(-1, x.shape[-1]) for x in st.extras.values()]
            runs[where] = (sim.ts, [np.asarray(t.data) for t in tallies],
                           st.alive.cpu(), torch.cat(planes).cpu())
        (gt, gm, ga, gp), (ct, cm, ca, cp) = runs["cuda"], runs["cpu"]
        assert gt == ct
        assert torch.equal(ga, ca)
        assert torch.equal(gp, cp)
        for g, c in zip(gm, cm):
            np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-6)


# -- recorded fields and inverse CDFs, shrink --

@pytest.mark.parametrize("name", ["mirror-B", "recorded-E-B",
                                  "phase-icdf-linear", "phase-icdf-hg",
                                  "wide-17-ops-9-fields"])
def test_recorded_plans_match_twin(dev, name):
    """The plans ``chip_smoke.py`` holds at 2**20 x 256 (recorded E / B
    components, recorded inverse CDFs, a plan past the old table limits),
    here at 2**16 x 64 as their providers hand them over: bitwise."""
    import physicl_tpu_torch as phys
    from chip_smoke import crossed_EB, hg_icdf, mirror_sim, phase_sim, \
        first_chunk_inputs, wide_sim

    n, k = 1 << 16, 64
    sim = {"mirror-B": lambda: mirror_sim(phys, n, dev, iters=k,
                                          chunk=k)[0],
           "recorded-E-B": lambda: mirror_sim(phys, n, dev, iters=k, chunk=k,
                                              fields=crossed_EB(torch))[0],
           "phase-icdf-linear": lambda: phase_sim(phys, n, dev, iters=k,
                                                  chunk=k)[0],
           "phase-icdf-hg": lambda: phase_sim(phys, n, dev, icdf=hg_icdf,
                                              iters=k, chunk=k)[0],
           "wide-17-ops-9-fields": lambda: wide_sim(phys, n, dev,
                                                    chunk=k)}[name]()
    packed, sched, seed, k_act, plan, _ = first_chunk_inputs(sim, F)
    assert plan.has_fields and plan.kernel_variant & 1
    out = torch.empty_like(packed)
    rec, rec_f = F.fused_transport(packed, out, sched, seed, k_act, plan)
    ref, ref_rec, ref_f = F.fused_chunk_reference(packed, sched, seed,
                                                  k_act, plan)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec)
    assert torch.equal(out, ref)


def test_shrink_card_equals_cpu(dev):
    """An extinction run at the default auto_shrink on the card and on the
    CPU twin: the same shrinks, ``sim.ts``, records and final planes."""
    import physicl_tpu_torch as phys

    runs = {}
    for where in ("cuda", "cpu"):
        light = phys.light
        sim = phys.Simulation(exit="extinction", seed=5, chunk_steps=16,
                              device=where)
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        sim.add_step(1, phys.newton.NewtonianKinematicsStep())
        sim.add_step(2, light.ScatterIsotropicStep(A=0.001, n=0.001))
        sim.add_step(3, light.ScatterDeleteStep(
            np.double(0.02 / (float(light.c) * 0.001)), np.double(1.0)))
        meas = light.ScatterSignMeasureStep(None, True)
        sim.add_step(4, meas)
        sim.add_photons(light.generate_photon_state(1 << 17, E=1.0))
        sim.start()
        sim.join()
        st = sim.sim_state
        runs[where] = (sim.ts, np.asarray(meas.data),
                       [e for e in sim.population_log if e[0] == "shrink"],
                       torch.cat([st.r, st.v, st.alive[None]]).cpu())
    (gt, gm, gs, gp), (ct, cm, cs, cp) = runs["cuda"], runs["cpu"]
    assert gs == cs and gs
    assert gt == ct
    np.testing.assert_array_equal(gm, cm)
    assert torch.equal(gp, cp)


def _midrun_sim(case, where, ck=None):
    """chip_smoke's card-against-CPU runs at 2**14 photons and 256
    iterations: an injection, a removal, a non-photon injection (the
    fallback to the generic tier) or a restore of ``ck``."""
    import physicl_tpu_torch as phys
    from chip_smoke import collect_hook, main_plan_sim

    light = phys.light
    n = 1 << 14
    dirs = np.random.default_rng(41).normal(size=(3, n))
    dirs /= np.linalg.norm(dirs, axis=0)
    if case == "restore":
        sim, meas = main_plan_sim(phys, 0, where, 256, 32, seed=8)
        sim.restore_checkpoint(ck)
        return sim, meas
    sim, meas = main_plan_sim(phys, n, where, 256, 32, seed=6,
                              scatter=case != "fallback", dirs=dirs)
    if case == "inject":
        collect_hook(meas, 2, lambda s: s.add_photons(
            light.generate_photon_state(1024, E=2.0, device=where,
                                        v=dirs[:, :1024] * float(light.c))))
    elif case == "remove":
        objs = [light.PhotonObject(E=np.double(5.0 + i),
                                   v=np.array([float(light.c), 0.0, 0.0]))
                for i in range(16)]
        for o in objs:
            sim.add_obj(o)
        collect_hook(meas, 2, lambda s: s.remove_obj(objs[3]))
    else:
        collect_hook(meas, 2, lambda s: s.add_obj(phys.Object(
            v=phys.Measurement([5.0, 0, 0], "m**1 s**-1"))))
    return sim, meas


@pytest.mark.parametrize("case", ["inject", "remove", "fallback", "restore"])
def test_midrun_edits_card_equal_cpu(dev, case, tmp_path):
    """Mid-run edits and a restored run on the card and on the CPU twin:
    ``sim.ts``, records and final planes bitwise equal (the fallback's
    generic part is draw-free)."""
    import warnings

    import physicl_tpu_torch as phys
    from chip_smoke import main_plan_sim

    ck = None
    if case == "restore":
        ck = str(tmp_path / "ck.npz")
        first, _ = main_plan_sim(phys, 1 << 14, "cuda", 128, 32, seed=8)
        first.start()
        first.join()
        first.save_checkpoint(ck)
    runs = {}
    for where in ("cuda", "cpu"):
        sim, meas = _midrun_sim(case, where, ck)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the fallback's warning
            sim.start()
            sim.join()
        runs[where] = (sim, np.asarray(meas.data),
                       F.pack_state(sim.sim_state).cpu())
    (gs, gd, gp), (cs, cd, cp) = runs["cuda"], runs["cpu"]
    assert gs.used_fused == cs.used_fused == (case != "fallback")
    assert gs.ts == cs.ts and len(gs.ts) == 256
    np.testing.assert_array_equal(gd, cd)
    assert torch.equal(gp, cp)


def test_load_checkpoint_defaults_to_the_card(dev, tmp_path):
    """load_checkpoint / state_from_checkpoint put the state on the card
    unless asked for the CPU, as Simulation does."""
    import physicl_tpu_torch as phys
    from physicl_tpu_torch.utils import checkpoint as TC

    ck = str(tmp_path / "ck.npz")
    sim = phys.Simulation(seed=3)
    sim.add_photons(phys.light.generate_photon_state(1024, E=1.0))
    sim.save_checkpoint(ck)
    state, meta = TC.load_checkpoint(ck)
    assert state.r.device.type == "cuda" and state.key.device.type == "cuda"
    assert TC.state_from_checkpoint(ck).E.device.type == "cuda"
    assert TC.load_checkpoint(ck, device="cpu")[0].r.device.type == "cpu"
    assert meta["seed"] == 3


def test_spatial_sort_card_equals_cpu(dev):
    """make_spatial_sort's permutation on the card equals the CPU's."""
    from physicl_tpu_torch.ops.compaction import make_spatial_sort
    from physicl_tpu_torch.state import SimState

    rng = np.random.default_rng(3)
    C = 1 << 16
    alive = np.zeros(C, bool)
    alive[:60000] = rng.uniform(size=60000) < 0.8
    spec = {"shape": (32, 16, 8), "origin": (-1.0, 0.5, 0.0),
            "spacing": (0.5, 1.25, 2.0)}
    fields = {k: rng.uniform(-5, 20, (3, C)).astype(np.float32)
              for k in ("r", "dr", "v", "dv", "a")}
    fields.update(E=np.arange(C, dtype=np.float32), alive=alive,
                  otype=np.ones(C, np.int32), w=np.ones(C, np.float32),
                  t=np.float32(0.0), dt=np.float32(1e-3),
                  n_spawned=np.int32(60000))
    outs = [make_spatial_sort(spec)(SimState.from_numpy(fields, where)).E
            .cpu() for where in ("cuda", "cpu")]
    assert torch.equal(outs[0], outs[1])


def test_kernel_program_card_equals_cpu(dev):
    """KernelProgram.run without draws: the card's outputs and tracked
    indices equal the CPU's."""
    import physicl_tpu_torch as phys
    from physicl_tpu_torch import kernels as K

    rng = np.random.default_rng(5)
    n = 1 << 16
    bulk = phys.light.generate_photon_state(
        n, E=rng.uniform(0.5, 2.0, n), r=rng.uniform(-1e6, 1e6, (3, n)))

    def body(valid, r0, E, A):
        score = abs(r0) * A + E
        return {"score": score * valid, "hit": (score > A * 5e5) & valid}

    outs = []
    for where in ("cuda", "cpu"):
        prog = K.KernelProgram(None, "p", body)
        prog.prep_metadata = [
            K.KernelInput(name="r0", type="obj", obj_attr="r[0]"),
            K.KernelInput(name="E", type="obj", obj_attr="E"),
            K.KernelInput(name="A", type="const", const_value=0.5),
            K.KernelInput(name="sel", type="obj_track")]
        prog.output_metadata = [K.KernelOutput(name="score"),
                                K.KernelOutput(name="hit", ctype="int")]
        st = phys.SimState.from_population([], [bulk], device=where)
        outs.append((prog.build_kernel().run(st), prog.sel))
    (g, gsel), (c, csel) = outs
    for k in c:
        np.testing.assert_array_equal(g[k], c[k])
    np.testing.assert_array_equal(gsel, csel)


def _mesh_main(where, n=1 << 16, iters=128, chunk=64):
    """The main plan over an 8-shard mesh on ``where`` (bench.py's steps,
    photons in numpy-seeded directions)."""
    import physicl_tpu_torch as T
    from physicl_tpu_torch.parallel import make_mesh

    d = np.random.default_rng(9).normal(size=(3, n))
    v = d / np.linalg.norm(d, axis=0) * C_LIGHT
    s = T.Simulation(until_t=(iters - 0.5) * 1e-3, seed=5, chunk_steps=chunk,
                     mesh=make_mesh(8, devices=[where]))
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterIsotropicStep(A=np.double(0.001),
                                               n=np.double(0.001)))
    m = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, m)
    s.add_photons(T.light.generate_photon_state(n, E=1.0, v=v))
    s.start()
    s.join()
    return s, np.asarray(m.data)


def test_mesh_main_plan_card_equals_cpu_twin(dev):
    """The 8-shard fused main plan: every launch the op-sequence
    instantiation over one shard's planes, and sim.ts, the records and the
    final planes bitwise the CPU twin's 8-shard run."""
    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    cs, cd = _mesh_main(dev)
    launches = F.fused_transport.launches
    hs, hd = _mesh_main("cpu")
    assert cs.used_fused and hs.used_fused
    # two chunks, and the t-exit's empty dispatch: 8 launches each
    assert launches == F.fused_transport.seq_launches == 8 * 3
    assert np.asarray(cs.ts, np.float32).tobytes() == \
        np.asarray(hs.ts, np.float32).tobytes()
    np.testing.assert_array_equal(cd, hd)
    for k in ("r", "v", "E", "w", "alive"):
        assert torch.equal(getattr(cs.sim_state, k).cpu(),
                           getattr(hs.sim_state, k)), k


def test_scan_steps_gradient_card_equals_cpu(dev):
    """functional.scan_steps' dT/dA on the card: the closed form within
    1e-4 and the CPU's gradient within 1e-5; a checkpointed run with
    roulette draws gives the plain gradient bitwise (the card's generator
    replayed in the recomputation)."""
    import physicl_tpu_torch as T
    from physicl_tpu_torch import functional as Fn
    from physicl_tpu_torch.state import SimState

    p, K, n = 0.01, 100, 1 << 16
    A0 = p / (C_LIGHT * 1e-3)

    def grad(where, remat=False, roulette=None):
        st = SimState.from_population(
            [], [T.light.generate_photon_state(n, E=1.0)], device=where)
        A = torch.tensor(A0, dtype=torch.float32, device=where,
                         requires_grad=True)
        steps = [T.UpdateTimeStep(lambda x: 1e-3),
                 T.newton.NewtonianKinematicsStep(),
                 T.light.ScatterDeleteStep(n=1.0, A=A, implicit_capture=True,
                                           roulette=roulette)]
        out = Fn.scan_steps(steps, st, K, key=3, remat=remat)
        (g,) = torch.autograd.grad((out.w * out.alive).sum() / n, A)
        return float(g)

    g_card, g_cpu = grad(dev), grad("cpu")
    expect = -K * C_LIGHT * 1e-3 * (1 - p) ** (K - 1)
    assert abs(g_card - expect) <= 1e-4 * abs(expect)
    assert abs(g_card - g_cpu) <= 1e-5 * abs(g_cpu)
    assert grad(dev, False, (0.5, 1.0)) == grad(dev, True, (0.5, 1.0))
