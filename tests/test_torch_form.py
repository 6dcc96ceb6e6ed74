"""The plan forms of the transport kernel (``physicl_tpu_torch/ops/
codegen.py``: ``plan_form``, ``form_source``; ``csrc/plan.cuh``:
``form_matches``) on the CPU, where there is no ``nvcc``.

* Every plan the port's CPU tests build through the prover (chip_smoke.py's
  media, geometry, scatter, Lorentz, polarized plan lists, and the plans
  of its paths and user plans, planned at 2**10 photons) gets a form
  source, and the source is deterministic.
* Two plans that differ only in numbers share a source and a build key;
  each single change of structure gives another.
* The main path's plans keep variants 64 and 65 and get no form source.
* ``form_matches``, built for the host with ``g++`` (``plan.cuh`` is plain
  C++), accepts each plan's own ``PlanStruct`` bytes, refuses each single
  structural mutation, and accepts changes of numbers.
* The emitter's draw offsets per op equal the twin's draw order: a prefix
  of the plan's ops run through the twin for one iteration ends at the
  next op's offset.
* The shared field read: the media plan's ``del`` reuses ``iso``'s read of
  the phantom; a ``reflect`` or ``periodic`` (or a ``kin``) between them
  ends the sharing.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
import physicl_tpu_torch as T
from physicl_tpu_torch.ops import _build
from physicl_tpu_torch.ops import codegen as CG
from physicl_tpu_torch.ops import fused as F

CSRC = os.path.join(os.path.dirname(F.__file__), os.pardir, "csrc")
N = 1 << 10
C_LIGHT = cs.C_LIGHT
_I = {name: i for i, name in enumerate(CG.OP_FORM)}


def _explicit():
    L = 3e6
    light = T.light
    plans = dict(cs.media_plans(F, light, 64, 4 * C_LIGHT * 1e-3, 8))
    plans.update(cs.geometry_plans(F, 64, L))
    plans.update(cs.scatter_plans(F, light, 64, L))
    plans.update({k: p for k, (p, _) in cs.lorentz_plans(F, 64).items()})
    plans.update({k: p for k, (p, _) in cs.pol_plans(F, light, 64).items()})
    return plans


def _sampler():
    a, b = cs.planck_window()
    return T.light.PlanckSampler(a, b, cs.T_SUN, bins=2000)


_PLANS = {}


def _plans():
    """``{name: plan}``: the explicit lists and the planned path and user
    plans (built once per process)."""
    if not _PLANS:
        torch.set_num_threads(1)
        _PLANS.update({f"list:{k}": p for k, p in _explicit().items()})
        sims = {**cs.user_plan_sims(T, "cpu", N),
                **cs.path_sims(T, "cpu", N, _sampler())}
        _PLANS.update({f"path:{k}": cs.planned(sim)[1].plan
                       for k, sim in sims.items()})
    return _PLANS


PLAN_NAMES = sorted(
    [f"list:{k}" for k in (
        "media-voxel-trilinear-capture", "media-voxel-nearest-analog",
        "media-layered-r-z", "media-expr",
        "geom-reflect-trace-f32-dv", "geom-periodic-trace-bf16-every4",
        "geom-del-scross-w-sabsorb-in-cross-ecap", "geom-sabsorb-scross",
        "rot-hg", "rot-rayl-wl", "rot-phase-mie", "rot-compton-kn-dep",
        "rot-compton-thermal", "rot-fresnel", "rot-fresnel-match",
        "rot-del-stretch-w", "rot-del-fluor-dep",
        "lor-species-EB", "lor-qm-B", "lor-photon-noop", "lor-before-update",
        "mixed", "mixed-emit-qm",
        "pol", "pol-wl", "pol-expr", "polc", "polc-kn-dep", "polmeas-w-qu",
        "pol-polmeas", "emit-pol-directed", "emit-iso-circular",
        "fluor-pol-planes", "mixed-pol")]
    + [f"path:{k}" for k in (
        "custom", "custom-draws", "custom-extras", "reduce-n", "mesh-x-path",
        "mesh-r-weighted", "kstate-mixed", "reduce-weighted", "past-limits",
        "user", "spectrum", "binned-edges", "shield-analog",
        "shield-split_chunk", "planck",
        "media", "beer-lambert", "media-layered", "escape", "escape-closure",
        "cavity-bfloat16", "cavity-float32", "gamma", "glass", "thermal",
        "stretch", "fluor", "exb", "mixed", "record-tile", "polarized",
        "polarimetry", "mirror", "recorded-E-B", "phase-icdf",
        "phase-icdf-hg", "wide", "past-caps")])


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_every_plan_gets_a_deterministic_form_source(name):
    plan = _plans()[name]
    assert plan.kernel_seq is None
    src = CG.form_source(plan)
    again = dataclasses.replace(plan, _cache={})
    assert CG.form_source(again) == src
    assert src.startswith("// Generated by physicl_tpu_torch/ops/codegen.py")
    assert "#define PHYSICL_FORM 1\n" in src
    form = CG.plan_form(plan)
    assert len(form["ops"]) == len(plan.ops)
    assert [op[_I["kind"]] for op in form["ops"]] == [
        F.OP_CODES[op.kind] for op in plan.ops]


# -- numbers and structure ----------------------------------------------------

def _base():
    """A plan with many members: a directed emitter, kin, a field iso,
    capture and roulette, a box, a weighted cross with an energy sum, a
    sign."""
    return F.FusedPlan(ops=[
        F._Op("emit", emit_n=64, emit_E=1.5, c_val=C_LIGHT,
              emit_v=(C_LIGHT, 0.0, 0.0)),
        F._Op("kin"),
        F._Op("iso", coef=1e-6, c_val=C_LIGHT,
              n_fn=T.light._compile_variable_n("1.0 + r0 * 0.0")),
        F._Op("del", coef=1e-7, c_val=C_LIGHT, implicit_capture=True,
              roulette=(0.1, 0.5), cols=(0,)),
        F._Op("absorb", bounds=((-1.0, 1.0),) * 3),
        F._Op("cross", cols=(1,), weighted=True,
              axes=((0, 0.5, 1, 2), (1, -0.5, 3, -1))),
        F._Op("sign", cols=(2, 3))], n_rec_cols=6, chunk=64,
        const_norm_speed=C_LIGHT, n_frec_cols=4)


def _with(plan, i, **kw):
    ops = list(plan.ops)
    ops[i] = dataclasses.replace(ops[i], **kw)
    return dataclasses.replace(plan, ops=ops, _cache={})


NUMBERS = {
    "coef": lambda p: _with(p, 2, coef=3e-6),
    "c_val": lambda p: _with(p, 2, c_val=0.5 * C_LIGHT),
    "roulette": lambda p: _with(p, 3, roulette=(0.2, 0.7)),
    "box": lambda p: _with(p, 4, bounds=((-2.0, 2.0),) * 3),
    "plane": lambda p: _with(p, 5, axes=((0, 0.25, 1, 2), (1, -0.75, 3, -1))),
    "columns": lambda p: _with(p, 5, axes=((0, 0.5, 2, 1), (1, -0.5, 3, -1))),
    "emit": lambda p: _with(p, 0, emit_n=32, emit_E=2.0, emit_r=(1, 2, 3)),
    "speed": lambda p: dataclasses.replace(p, const_norm_speed=2 * C_LIGHT,
                                           _cache={}),
    "chunk": lambda p: dataclasses.replace(p, chunk=256, _cache={}),
    "field-numbers": lambda p: _with(
        p, 2, n_fn=T.light._compile_variable_n("2.5 + r0 * 0.0")),
}

STRUCTURE = {
    "op-kind": lambda p: _with(p, 2, kind="hg"),
    "wavelength": lambda p: _with(p, 2, wl_base=1e-2),
    "no-field": lambda p: _with(p, 2, n_fn=None),
    "field-kind": lambda p: _with(
        p, 2, n_fn=T.light.voxel_density(np.ones((4, 4, 4)), spacing=1.0)),
    "capture": lambda p: _with(p, 3, implicit_capture=False, roulette=()),
    "no-roulette": lambda p: _with(p, 3, roulette=()),
    "no-deposition": lambda p: dataclasses.replace(
        _with(p, 3, cols=()), _cache={}),
    "unweighted": lambda p: _with(p, 5, weighted=False),
    "no-energy-sum": lambda p: _with(p, 5, axes=((0, 0.5, 1, -1),
                                                 (1, -0.5, 3, -1))),
    "axis": lambda p: _with(p, 5, axes=((2, 0.5, 1, 2), (1, -0.5, 3, -1))),
    "planes": lambda p: _with(p, 5, axes=((0, 0.5, 1, 2),)),
    "no-n-column": lambda p: _with(p, 6, cols=(-1, 3)),
    "isotropic-emit": lambda p: _with(p, 0, emit_v=None),
    "sampled-emit": lambda p: _with(
        p, 0, emit_table=np.zeros(360, np.float32)),
    "op-order": lambda p: dataclasses.replace(
        p, ops=[p.ops[0], p.ops[1], p.ops[3], p.ops[2], *p.ops[4:]],
        _cache={}),
    "no-const-norm": lambda p: dataclasses.replace(
        p, const_norm_speed=None, _cache={}),
    "int-columns": lambda p: dataclasses.replace(p, n_rec_cols=7, _cache={}),
    "float-columns": lambda p: dataclasses.replace(p, n_frec_cols=5,
                                                   _cache={}),
    "extras": lambda p: dataclasses.replace(p, extras=("dose",), _cache={}),
}


def test_numbers_share_a_source_and_build_key():
    base = _base()
    src = CG.form_source(base)
    for name, change in NUMBERS.items():
        other = CG.form_source(change(base))
        assert other == src, name
        assert _build.plan_key(other) == _build.plan_key(src), name


def _field_plans(B0, L, g):
    """The mirror's plan with a recorded B(r) of strength B0 and length L,
    and the callable phase function's with an HG inverse CDF at g."""
    def B(rx, ry, rz):
        fac = B0 / (L * L)
        return (-fac * rx * rz, -fac * ry * rz, B0 * (1.0 + (rz / L) ** 2))

    def icdf(u):
        s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
        return (1.0 + g * g - s ** 2) / (2.0 * g)

    mirror = cs.mirror_sim(T, N, "cpu", iters=16, chunk=16,
                           fields=(None, B))[0]
    phase = cs.phase_sim(T, N, "cpu", icdf=icdf, iters=16, chunk=16)[0]
    return [cs.planned(sim)[1].plan for sim in (mirror, phase)]


def test_field_constants_share_a_source_and_build_key():
    """Recorded fields that differ only in their constants (a sweep over
    B0 and L, over g) share one source and build key: the program's shape
    is the form's, its constants are the runtime Plan's (``fk``)."""
    base = _field_plans(100.0, 2.0, 0.7)
    for other in (_field_plans(250.0, 3.0, 0.3), _field_plans(80.0, 1.5,
                                                               -0.45)):
        for a, b in zip(base, other):
            src = CG.form_source(a)
            assert CG.form_source(b) == src
            assert _build.plan_key(CG.form_source(b)) == _build.plan_key(src)
            fa, fb = _struct(a), _struct(b)
            assert fa.fields[0].shape == fb.fields[0].shape
            assert list(fa.fk) != list(fb.fk)
    # a field of another shape (one more operation) gives another source
    def B2(rx, ry, rz):
        return (rx * 0.5, ry * 0.5, rz * 0.5 + 1.0)

    def B3(rx, ry, rz):
        return (rx * 0.5, ry * 0.5, (rz * 0.5 + 1.0) * 2.0)

    srcs = [CG.form_source(cs.planned(cs.mirror_sim(
        T, N, "cpu", iters=16, chunk=16, fields=(None, B))[0])[1].plan)
        for B in (B2, B3)]
    assert srcs[0] != srcs[1]


def test_a_plan_past_the_parameter_room_takes_the_buffer_route():
    """The Plan is sized for its plan: 260 ops make it larger than a
    kernel parameter may be (``codegen.PLAN_PARAM_BYTES``), and its form
    takes the Plan from a device buffer; a small plan keeps the parameter
    unless it asks for the buffer (``plan_buffer``), which is part of the
    form."""
    base = _base()
    big = dataclasses.replace(base, ops=[F._Op("kin")] + [
        F._Op("absorb", bounds=((-1.0, 1.0),) * 3)] * 259, n_rec_cols=1,
        n_frec_cols=0, const_norm_speed=None, _cache={})
    ps = _struct(big)
    assert type(ps).dims == (260, 1, 1, 1)
    assert ctypes.sizeof(ps) > CG.PLAN_PARAM_BYTES
    assert CG.plan_in_buffer(big)
    assert "kPlanInBuffer = 1;" in CG.form_source(big)
    assert "#define PHYSICL_PLAN_DIMS 260, 1, 1, 1" in CG.form_source(big)
    assert not CG.plan_in_buffer(base)
    forced = dataclasses.replace(base, plan_buffer=True, _cache={})
    assert CG.plan_in_buffer(forced)
    assert CG.form_source(forced) != CG.form_source(base)


@pytest.mark.parametrize("name", sorted(STRUCTURE))
def test_each_change_of_structure_gives_another_source(name):
    base = _base()
    src = CG.form_source(base)
    other = CG.form_source(STRUCTURE[name](base))
    assert other != src
    assert _build.plan_key(other) != _build.plan_key(src)


@pytest.mark.parametrize("absorb,variant", [(False, 64), (True, 65)],
                         ids=["bench", "extinction"])
def test_main_path_plans_keep_their_sequence_kernel(absorb, variant):
    light = T.light
    sim = T.Simulation(until_t=0.0635, seed=3, chunk_steps=16, device="cpu")
    sim.add_step(0, T.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, T.newton.NewtonianKinematicsStep())
    A = n = np.double(0.001)
    sim.add_step(2, light.ScatterDeleteStep(A, n) if absorb
                 else light.ScatterIsotropicStep(A=A, n=n))
    sim.add_step(3, light.ScatterSignMeasureStep(None, True))
    sim.add_photons(light.generate_photon_state(N, E=1.0))
    plan = cs.planned(sim)[1].plan
    assert F.kernel_variant(plan) == variant
    with pytest.raises(ValueError, match="op-sequence form"):
        CG.form_source(plan)
    form = dataclasses.replace(plan, specialize=False)
    assert F.kernel_variant(form) == F.FORM_VARIANT
    assert "struct Form {" in CG.form_source(form)


# -- form_matches on the host -------------------------------------------------

_MATCH_PLANS = (
    ["list:geom-del-scross-w-sabsorb-in-cross-ecap", "list:rot-compton-thermal",
     "list:rot-fresnel-match", "list:rot-del-fluor-dep", "list:lor-qm-B",
     "list:mixed-emit-qm", "list:pol-expr", "list:polc-kn-dep",
     "list:emit-pol-directed", "list:media-layered-r-z",
     "list:media-voxel-nearest-analog", "list:geom-periodic-trace-bf16-every4"]
    + ["path:planck", "path:media", "path:user", "path:spectrum",
       "path:escape-closure", "path:mirror", "path:phase-icdf", "path:wide",
       "path:past-caps", "path:recorded-E-B",
       "path:kstate-mixed", "path:record-tile"])


@pytest.fixture(scope="module")
def match_lib(tmp_path_factory):
    """A host library with ``matches_<i>(const Plan*)`` for each plan of
    ``_MATCH_PLANS``: ``form_matches<Form>`` of its own form."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    plans = _plans()
    parts = ["#include \"plan.cuh\"", "using namespace physicl;"]
    for i, name in enumerate(_MATCH_PLANS):
        parts += [f"namespace f{i} {{",
                  CG.form_struct(plans[name], bodies=False), "}",
                  f'extern "C" int matches_{i}(const void* p) {{',
                  f"  using P = FormPlan<f{i}::Form>;",
                  f"  return form_matches<f{i}::Form>(*(const P*)p);", "}",
                  f'extern "C" int size_{i}() {{',
                  f"  return (int)sizeof(FormPlan<f{i}::Form>);", "}"]
    tmp = str(tmp_path_factory.mktemp("form_matches"))
    src = os.path.join(tmp, "matches.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts) + "\n")
    so = os.path.join(tmp, "libmatches.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    "-o", so, src], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(so)
    for i in range(len(_MATCH_PLANS)):
        getattr(lib, f"matches_{i}").argtypes = [ctypes.c_void_p]
    return lib, plans


def test_form_plan_has_the_plans_own_sizes(match_lib):
    """Each form's Plan type (``FormPlan<Form>``, the tables sized for its
    ops, planes, fields and field constants) is as large as the plan's
    ctypes struct."""
    lib, plans = match_lib
    for i, name in enumerate(_MATCH_PLANS):
        ps = _struct(plans[name])
        assert getattr(lib, f"size_{i}")() == ctypes.sizeof(ps), name


def _struct(plan):
    return F._plan_struct(plan, torch.device("cpu"))[0]


def _copy(ps):
    return type(ps).from_buffer_copy(ps)


def _first(ps, kinds):
    return next((i for i in range(ps.n_ops) if ps.ops[i].kind in kinds),
                None)


def _op_mutation(kinds, fn):
    """A mutation of the first op of one of ``kinds`` (None where the plan
    has none)."""
    def apply(ps):
        i = _first(ps, [F.OP_CODES[k] for k in kinds] if kinds
                   else range(24))
        if i is None:
            return None
        fn(ps.ops[i])
        return ps
    return apply


def _set(name, value=None, delta=None):
    def fn(o):
        if delta is not None:
            setattr(o, name, getattr(o, name) + delta)
        else:
            setattr(o, name, value(getattr(o, name)) if callable(value)
                    else value)
    return fn


def _fld(o):
    o.fld[0] = o.fld[0] + 1


def _box1(o):
    o.box[1] = 0.0 if o.box[1] > 0 else 0.01


def _plan_level(name, fn):
    def apply(ps):
        fn(ps)
        return ps
    return apply


def _axis_mut(member):
    def apply(ps):
        n_ax = sum(ps.ops[i].n_ax for i in range(ps.n_ops)
                   if ps.ops[i].kind == F.OP_CODES["cross"])
        if not n_ax:
            return None
        a = ps.axes[0]
        if member == "axis":
            a.axis = (a.axis + 1) % 3
        else:
            setattr(a, member, -1 if getattr(a, member) >= 0 else 0)
        return ps
    return apply


def _field_mut(member):
    def apply(ps):
        n_fields = len(ps.fields)
        if member in ("shape", "constants"):
            j = next((j for j in range(n_fields)
                      if ps.fields[j].kind == 1), None)
            if j is None:
                return None
            fd = ps.fields[j]
            if member == "shape":
                fd.shape ^= 1
            else:
                fd.len += 1
            return ps
        i = next((i for i in range(ps.n_ops)
                  for f in (ps.ops[i].nf, ps.ops[i].af) if f >= 0), None)
        if i is None:
            return None
        fd = ps.fields[max(ps.ops[i].nf, ps.ops[i].af)]
        if member == "kind":
            fd.kind = fd.kind % 3 + 1
        elif member == "interp" and fd.kind == 3:
            fd.interp = 1 - fd.interp
        elif member == "axis" and fd.kind == 2:
            fd.axis = (fd.axis + 1) % 4
        else:
            return None
        return ps
    return apply


def _binned_mut(binned):
    """A reduce's binned bit flipped: on the first binned reduce (a
    histogram tally's, ``binned``) or on the first that sums each output."""
    def apply(ps):
        i = next((i for i in range(ps.n_ops)
                  if ps.ops[i].kind == F.OP_CODES["reduce"]
                  and bool(ps.ops[i].flag & F.USER_BINNED) == binned), None)
        if i is None:
            return None
        ps.ops[i].flag ^= F.USER_BINNED
        return ps
    return apply


MUTATIONS = {
    "op-kind": _op_mutation(None, _set("kind", delta=1)),
    "op-flag": _op_mutation(None, _set("flag", delta=8)),
    "del-capture": _op_mutation(["del"], _set("capture", lambda v: 1 - v)),
    "del-roulette": _op_mutation(
        ["del"], _set("w_sur", lambda v: 0.0 if v > 0 else 0.5)),
    "col0-presence": _op_mutation(
        ["del", "sign", "cross", "scross", "compton", "polc", "polmeas",
         "reduce"], _set("col0", lambda v: -1 if v >= 0 else 0)),
    "lorentz-qm-plane": _op_mutation(["lorentz"], _set("col0", delta=1)),
    "fresnel-axis": _op_mutation(["fresnel"],
                                 _set("col1", lambda v: (v + 1) % 3)),
    "n-field": _op_mutation(["iso", "del", "hg", "rayl", "phase", "compton",
                             "pol", "polc"], _set("nf", delta=1)),
    "a-field": _op_mutation(["del"], _set("af", delta=1)),
    "recorded-field": _op_mutation(["lorentz", "phase"], _fld),
    "emit-sampled": _op_mutation(
        ["emit"], _set("icdf", lambda v: -1 if v >= 0 else 0)),
    "emit-scale": _op_mutation(
        ["emit"], _set("emit_scale", lambda v: 2.0 if v == 1.0 else 1.0)),
    "emit-polarized": _op_mutation(["emit"], _set("capture",
                                                  lambda v: 1 - v)),
    "compton-thermal": _op_mutation(["compton"], _box1),
    "kahn-tries": _op_mutation(["compton", "polc"], _set("emit_n", delta=1)),
    "user-draws": _op_mutation(["custom", "reduce", "kstate"],
                               _set("emit_row", delta=1)),
    "cross-planes": _op_mutation(["cross"], _set("n_ax", delta=-1)),
    "cross-first-plane": _op_mutation(["cross"], _set("ax0", delta=1)),
    "binned-to-sums": _binned_mut(True),
    "sums-to-binned": _binned_mut(False),
    "plane-axis": _axis_mut("axis"),
    "plane-energy-sum": _axis_mut("ecol"),
    "plane-energy-capture": _axis_mut("ecap"),
    "field-kind": _field_mut("kind"),
    "field-interp": _field_mut("interp"),
    "field-layered-axis": _field_mut("axis"),
    "field-shape": _field_mut("shape"),
    "field-constants": _field_mut("constants"),
    "n-ops": _plan_level("n_ops", lambda ps: setattr(ps, "n_ops",
                                                     ps.n_ops - 1)),
    "n-cols": _plan_level("n_cols", lambda ps: setattr(ps, "n_cols",
                                                       ps.n_cols + 1)),
    "n-fcols": _plan_level("n_fcols", lambda ps: setattr(ps, "n_fcols",
                                                         ps.n_fcols + 1)),
    "const-norm": _plan_level("const_norm", lambda ps: setattr(
        ps, "const_norm", 1 - ps.const_norm)),
    "stream": _plan_level("n_stream", lambda ps: setattr(
        ps, "n_stream", 0 if ps.n_stream else 1)),
    "stream-bf16": _plan_level("stream_bf16", lambda ps: setattr(
        ps, "stream_bf16", 1 - ps.stream_bf16)),
    "n-extras": _plan_level("n_extras", lambda ps: setattr(
        ps, "n_extras", ps.n_extras + 1)),
    "otype-plane": _plan_level("otype_x", lambda ps: setattr(
        ps, "otype_x", ps.otype_x + 1)),
    "writeback-mask": _plan_level("wb_mask", lambda ps: setattr(
        ps, "wb_mask", ps.wb_mask ^ 1)),
    "user-writeback-mask": _plan_level("uwb_mask", lambda ps: setattr(
        ps, "uwb_mask", ps.uwb_mask ^ 2)),
}


def _check_each(lib, plans, mutate, want):
    hit = 0
    for i, name in enumerate(_MATCH_PLANS):
        ps = mutate(_copy(_struct(plans[name])))
        if ps is None:
            continue
        hit += 1
        got = getattr(lib, f"matches_{i}")(ctypes.addressof(ps))
        assert bool(got) == want, name
    return hit


def test_form_matches_accepts_each_plans_own_struct(match_lib):
    lib, plans = match_lib
    assert _check_each(lib, plans, lambda ps: ps, True) == len(_MATCH_PLANS)
    # numbers: coefficients, boxes, column indices, stride, rotation table
    def numbers(ps):
        for i in range(ps.n_ops):
            o = ps.ops[i]
            o.coef, o.c_val, o.wl_base = 2 * o.coef, 3.0, 0.5
            o.box[0], o.w_min = o.box[0] + 1.0, 0.01
            o.col1 = o.col1 + (o.kind != F.OP_CODES["fresnel"])
            o.emit_E, o.emit_row = 7.0, (o.emit_row if o.kind in (21, 22, 23)
                                         else o.emit_row + 1)
            if o.col0 >= 0 and o.kind != F.OP_CODES["lorentz"]:
                o.col0 += 1
        ps.stream_every += 1
        ps.const_speed *= 2
        ps.rot_sd[3] = 0.25
        ps.axes[0].L += 1.0
        ps.fields[0].outside = 9.0
        ps.fk[0] = ps.fk[0] + 0.5  # an expression field's constant
        return ps
    assert _check_each(lib, plans, numbers, True) == len(_MATCH_PLANS)


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_form_matches_refuses_each_structural_mutation(match_lib, name):
    lib, plans = match_lib
    assert _check_each(lib, plans, MUTATIONS[name], False) > 0


# -- draw offsets against the twin --------------------------------------------

def _twin_draws(plan, packed, sched, starts):
    """The draws the twin makes in one iteration of ``plan``: the counter's
    index when the iteration ends."""
    seen = []
    base = F._HashRng

    class Counting(base):
        def __init__(self, *a):
            super().__init__(*a)
            seen.append(self)

    F._HashRng = Counting
    try:
        F.fused_chunk_reference(packed, sched, 3, 1, plan, starts)
    finally:
        F._HashRng = base
    return seen[-1].idx


@pytest.mark.parametrize("name", [
    "list:rot-compton-thermal", "list:rot-compton-kn-dep",
    "list:rot-del-fluor-dep", "list:rot-fresnel", "list:rot-hg",
    "list:polc-kn-dep", "list:pol-polmeas", "list:emit-iso-circular",
    "list:media-voxel-trilinear-capture", "path:planck", "path:user",
    "path:custom-draws", "path:glass", "path:stretch", "path:thermal",
    "path:mixed", "path:past-limits"])
def test_draw_offsets_follow_the_twin(name):
    plan = _plans()[name]
    form = CG.plan_form(plan)
    draw0 = [op[_I["draw0"]] for op in form["ops"]]
    counts = CG.draw_counts(plan)
    assert draw0 == [sum(counts[:i]) for i in range(len(counts))]
    C = 256
    rng = np.random.default_rng(5)
    packed = torch.zeros((plan.n_planes, C), dtype=torch.float32)
    packed[0:3] = torch.from_numpy(rng.normal(size=(3, C))).float()
    d = rng.normal(size=(3, C))
    packed[6:9] = torch.from_numpy(d / np.linalg.norm(d, axis=0)
                                   * C_LIGHT).float()
    packed[12] = 1.0
    packed[13] = 1.0
    packed[14] = 1.0
    if "otype" in plan.extras:
        packed[F._NF + plan.extras.index("otype")] = 1.0
    sched = torch.full((5, plan.chunk), 1e-3, dtype=torch.float32)
    starts = (torch.full((plan.n_emit, plan.chunk), 0, dtype=torch.int32)
              if plan.n_emit else None)
    for m in range(1, len(plan.ops) + 1):
        prefix = dataclasses.replace(plan, ops=plan.ops[:m], _cache={})
        want = draw0[m] if m < len(plan.ops) else sum(counts)
        assert _twin_draws(prefix, packed, sched, starts) == want, (
            name, [op.kind for op in plan.ops[:m]])


# -- the shared field read ----------------------------------------------------

def _media(between=None):
    fn = T.light.voxel_density(np.ones((4, 4, 4)), spacing=1.0)
    ops = [F._Op("kin"), F._Op("iso", coef=1e-6, c_val=C_LIGHT, n_fn=fn)]
    if between is not None:
        ops.append(between)
    ops += [F._Op("del", coef=1e-7, c_val=C_LIGHT, n_fn=fn,
                  implicit_capture=True), F._Op("sign", cols=(1, 2))]
    return F.FusedPlan(ops=ops, n_rec_cols=5, chunk=16,
                       const_norm_speed=C_LIGHT)


def _shared(plan):
    return [op[_I["nf_shared"]] for op in CG.plan_form(plan)["ops"]]


def test_media_plan_reads_its_phantom_once():
    media = _plans()["path:media"]
    assert [op.kind for op in media.ops] == ["kin", "iso", "del", "absorb",
                                             "cross"]
    assert _shared(media) == [0, 0, 1, 0, 0]
    assert cs.field_shares(media) == [False, False, True, False, False]
    src = CG.form_source(media)
    row = next(line for line in src.splitlines() if line.endswith("// 2: del"))
    assert row.rstrip(",  // 2: del").endswith(", 1}")
    assert _shared(_media()) == [0, 0, 1, 0]


@pytest.mark.parametrize("kind", ["reflect", "periodic", "kin"])
def test_a_move_between_the_reads_ends_the_sharing(kind):
    op = (F._Op(kind, bounds=((-1.0, 1.0),) * 3) if kind != "kin"
          else F._Op("kin"))
    assert _shared(_media(op)) == [0, 0, 0, 0, 0]


def test_an_op_that_does_not_move_keeps_the_sharing():
    op = F._Op("absorb", bounds=((-1.0, 1.0),) * 3)
    assert _shared(_media(op)) == [0, 0, 0, 1, 0]
