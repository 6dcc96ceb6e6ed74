"""Kernel 1i's binned reduce: ``SpectrumMeasureStep`` and ``MeshTallyStep``
lowered to one bin index and one grouped sum a slot, held against the JAX
package's comparisons on the CPU, where there is no ``nvcc``.

* The bin index of the plain version (``ops/record.py:bin_columns``) and of
  the generated C (``ops/codegen.py:binned_c`` with ``csrc/binned.cuh``'s
  search of the edges' table, built for the host with ``g++``) equals the
  column that the JAX step's own masks
  pick (its ``contributions`` on jnp arrays) and the port's ``_binned``
  masks, slot for slot: every float32 edge and its two neighbours, values
  between a float64 edge and its float32 rounding, edges that collide in
  float32, +-inf, NaN, dead slots and 2**12 random values. The sums: counts
  exactly, values within rtol 1e-5 of the JAX masked sums (float32 against
  the host's float64).
* The plans of a spectrum and of the mesh tallies carry a binned reduce,
  and their generated programs have no per-bin record sum.
* A plan that mixes a binned tally with a user ``ReduceMeasureStep`` matches
  the JAX package row for row: counts exactly, sums within rtol 1e-5.
"""

import ctypes
import os
import shutil
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.engine import ParticleView
from physicl_tpu_torch.ops import codegen as CG
from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops import record as RC

CSRC = os.path.join(os.path.dirname(F.__file__), os.pardir, "csrc")
FIELDS = ParticleView._FIELDS
N_RANDOM = 1 << 12
RTOL = 1e-5
DT = 1e-3

_HARNESS = r"""
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#include "binned.cuh"
using namespace physicl;
// CUDA's correctly rounded fused multiply-add (U_FMA): the C library's
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float ipow(float x, int y) {
  if (y == 0) return 1.0f;
  const bool neg = y < 0;
  unsigned u = neg ? (unsigned)(-y) : (unsigned)y;
  float acc = 0.0f;
  bool have = false;
  while (u) {
    if (u & 1u) {
      acc = have ? acc * x : x;
      have = true;
    }
    u >>= 1;
    if (u) x = x * x;
  }
  return neg ? 1.0f / acc : acc;
}
// the runtime Plan's constants
struct Plan {
  const float* fk;
};
// the warp's grouped sum: here each slot's column, and a float64 sum per
// column (the kernel's own bin index, on the table in fk)
struct HostBins {
  const float* fk;
  int* cols;
  double* sums;
  int g;
  template <class B>
  void binned(bool alive, float c, float v) {
    const int n = bin_count_search<B::kLevels>(fk + B::kTable, c);
    const int col = bin_column<B>(n, c, alive);
    cols[g] = col;
    if (col >= 0) sums[B::kCol0 + col] += v;
  }
};
template <class Fn>
void run_slots(Fn fn, int n, const float* fk, const float* f,
               const float* x, const uint8_t* alive, int* cols,
               double* sums) {
  const Plan plan{fk};
  HostBins acc{fk, cols, sums, 0};
  for (int g = 0; g < n; ++g) {
    float fl[15], xl[8];
    for (int p = 0; p < 15; ++p) fl[p] = f[p * n + g];
    for (int p = 0; p < 8; ++p) xl[p] = x[p * n + g];
    acc.g = g;
    fn(plan, fl, xl, alive[g] != 0, acc);
  }
}
"""


def host_library(entries: dict, tmp):
    """``g++``-built library of ``{name: (plan, op index)}``: ``run_<name>``
    runs the op's generated binned function (its plan's ``BinForm``) on
    every slot; ``fk_<name>`` is the plan's ``Plan::fk``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    parts, fks = [_HARNESS], {}
    for name, (plan, i) in entries.items():
        ps = F._plan_struct(plan, torch.device("cpu"))[0]
        fks[name] = np.array(ps.fk[:], np.float32)
        bform, k0 = CG.plan_form(plan, ps)["bins"][i]
        parts.append(CG.binned_c(plan.ops[i], f"binned_{name}", bform, k0))
        parts.append(
            f'extern "C" void run_{name}(int n, const float* fk, '
            "const float* f, const float* x, const uint8_t* alive, "
            "int* cols, double* sums) { "
            f"run_slots(binned_{name}<HostBins>, n, fk, f, x, alive, cols, "
            "sums); }")
    src = os.path.join(tmp, "binned.cpp")
    with open(src, "w") as f:
        f.write("\n".join(parts))
    so = os.path.join(tmp, "libbinned.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", so, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.fks = fks
    return lib


def run_host(lib, name, planes, alive):
    """The host run of ``run_<name>`` on ``planes`` ((23, N) float32: the
    15 core planes and 8 extras) and ``alive``: (each slot's column or -1,
    the float64 sums of the 128 columns)."""
    n = planes.shape[1]
    f = np.ascontiguousarray(planes[:15], np.float32)
    x = np.ascontiguousarray(planes[15:23], np.float32)
    a = np.ascontiguousarray(alive, np.uint8)
    cols = np.zeros(n, np.int32)
    sums = np.zeros(128, np.float64)
    fk = lib.fks[name]
    vp = ctypes.c_void_p
    getattr(lib, f"run_{name}")(
        ctypes.c_int(n), vp(fk.ctypes.data), vp(f.ctypes.data),
        vp(x.ctypes.data), vp(a.ctypes.data), vp(cols.ctypes.data),
        vp(sums.ctypes.data))
    return cols, sums


# -- the tallies, their plans and their inputs ---------------------------------

# float64 edges: none exact in float32 but -1 and 2.5; 0.1 and 0.1 + 1e-10,
# and 1 and 1 + 2e-8, collide in float32; 1e30 far out
EDGES = np.array([-1.0, -1.0 / 3.0, 0.1, 0.1 + 1e-10, 1.0 / 3.0, 1.0,
                  1.0 + 2e-8, 2.5, 1e30])
R_EDGES = np.array([0.0, 0.1, 1.0 / 3.0, 0.5, 0.5 + 1e-9, 2.0])
CASES = {
    # name: (constructor, kwargs, the coordinate's plane or "r")
    "spectrum-count": ("SpectrumMeasureStep",
                       dict(edges=EDGES, underflow=True, overflow=True), 12),
    "spectrum-energy-weighted": (
        "SpectrumMeasureStep", dict(edges=EDGES, weight="energy",
                                    weighted=True, overflow=True), 12),
    "mesh-y-count": ("MeshTallyStep", dict(axis="y", edges=EDGES,
                                           underflow=True), 1),
    "mesh-x-energy": ("MeshTallyStep", dict(axis="x", edges=EDGES,
                                            value="energy"), 0),
    "mesh-r-pathlength-weighted": (
        "MeshTallyStep", dict(axis="r", edges=R_EDGES, value="pathlength",
                              weighted=True, center=(0.25, -0.5, 0.125),
                              underflow=True, overflow=True), "r"),
}


def _step(P, case):
    ctor, kw, _ = CASES[case]
    return getattr(P.light, ctor)(None, **kw)


def _edge_values(edges):
    """Every float32 edge, its neighbours either side, each float64 edge's
    rounding to the other side of it (the float32 value next to the
    rounded edge), +-inf, NaN, +-0 and the extremes."""
    e32 = edges.astype(np.float32)
    out = []
    for e in np.unique(e32):
        out += [e, np.nextafter(e, np.float32(-np.inf)),
                np.nextafter(e, np.float32(np.inf))]
    for e64, e in zip(edges, e32):
        # the float32 values either side of the float64 edge
        lo = e if float(e) <= e64 else np.nextafter(e, np.float32(-np.inf))
        hi = e if float(e) >= e64 else np.nextafter(e, np.float32(np.inf))
        out += [lo, hi]
    out += [np.inf, -np.inf, np.nan, 0.0, -0.0,
            np.finfo(np.float32).max, -np.finfo(np.float32).max,
            np.finfo(np.float32).tiny]
    return np.asarray(out, np.float32)


def _planes(case, seed=0):
    """(23, N) float32 planes: the edge values on the coordinate's plane
    (for "r", along x about the centre), then 2**12 random values over the
    edges and beyond; w in (0.2, 1), dr random, ~80% alive, and every edge
    value once dead as well."""
    rng = np.random.default_rng(seed)
    _, kw, plane = CASES[case]
    edges = np.asarray(kw["edges"])
    ev = _edge_values(edges)
    span = edges[:-1] if edges[-1] > 1e20 else edges
    lo, hi = float(span.min()), float(span.max())
    pad = 0.25 * (hi - lo)
    rand = rng.uniform(lo - pad, hi + pad, N_RANDOM).astype(np.float32)
    coord = np.concatenate([ev, ev, rand])
    n = coord.size
    p = rng.uniform(-1.0, 1.0, (23, n)).astype(np.float32)
    p[12] = rng.uniform(0.1, 3.0, n)
    p[14] = rng.uniform(0.2, 1.0, n)
    alive = rng.uniform(size=n) < 0.8
    alive[:ev.size] = True
    alive[ev.size:2 * ev.size] = False
    if plane == "r":
        c = np.asarray(kw["center"], np.float32)
        p[0:3] = c[:, None]
        with np.errstate(invalid="ignore"):
            p[0] = c[0] + coord
        p[1:3, 2 * ev.size:] += rng.uniform(-0.3, 0.3, (2, N_RANDOM))
    else:
        p[plane] = coord
    p[13] = alive
    return p, alive


def _jax_columns(case, planes, alive):
    """Each slot's column that the JAX step's masks pick (-1: none; at most
    one mask a slot), the JAX masked sums per column (over alive slots,
    float64), and the port's ``_binned`` masks' columns."""
    cols = {}
    for P, arr in ((J, jnp.asarray), (T, torch.from_numpy)):
        st = _step(P, case)
        view = types.SimpleNamespace(**{
            name: arr(planes[i] if name != "alive" else alive)
            for i, name in enumerate(FIELDS)})
        out = st.fn(view)
        masks, vals = [], []
        for name in st.outputs:
            v = np.asarray(out[name])
            masks.append(v != 0 if v.dtype == bool else None)
            vals.append(v.astype(np.float64))
        if masks[0] is None:  # a value: the masks of its count
            ctor, kw, _ = CASES[case]
            kw = dict(kw, **({"weight": "count"} if ctor.startswith("Spec")
                             else {"value": "count"}))
            kw.pop("weighted", None)
            mo = getattr(P.light, ctor)(None, **kw).fn(view)
            masks = [np.asarray(mo[name]) for name in st.outputs]
        m = np.stack(masks)
        assert (m.sum(0) <= 1).all(), f"{P.__name__}: two bins for a slot"
        col = np.where(m.any(0) & alive, m.argmax(0), -1)
        sums = np.where(alive, np.stack(vals), 0.0).sum(1)
        cols[P] = (col, sums)
    return cols


def _plan(case, n=16):
    """The fused plan of [UpdateTime, Kinematics, the case's tally] on the
    CPU, as ``start()`` plans it, and the tally's op index."""
    import chip_smoke as cs

    sim = T.Simulation(until_t=15.5 * DT, seed=1, chunk_steps=16,
                       device="cpu", auto_shrink=False)
    sim.add_step(0, T.UpdateTimeStep(lambda s: np.double(DT)))
    sim.add_step(1, T.newton.NewtonianKinematicsStep())
    sim.add_step(2, _step(T, case))
    sim.add_photons(T.light.generate_photon_state(n, E=1.0))
    plan = cs.planned(sim)[1].plan
    return plan, next(i for i, op in enumerate(plan.ops)
                      if op.kind == "reduce")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    entries = {}
    for case in CASES:
        plan, i = _plan(case)
        entries[case.replace("-", "_")] = (plan, i)
    return host_library(entries, str(tmp_path_factory.mktemp("binned"))), \
        entries


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_index_equals_the_jax_comparisons(lib, case):
    lib_, entries = lib
    plan, i = entries[case.replace("-", "_")]
    op = plan.ops[i]
    assert op.bins is not None and op.cols[1] == 0
    planes, alive = _planes(case)
    ref = _jax_columns(case, planes, alive)
    want, jax_sums = ref[J]
    assert np.array_equal(ref[T][0], want)  # the port's _binned masks
    # the plain version's index
    f = [torch.from_numpy(p) for p in planes]
    f[13] = torch.from_numpy(alive).float()
    out = RC.run_field(op.prog, f, 1 + (not op.bins.count))
    coord = out if op.bins.count else out[0]
    edges = torch.tensor(op.bins.edges, dtype=torch.float32)
    twin = RC.bin_columns(coord, torch.from_numpy(alive), edges,
                          op.bins.underflow, op.bins.overflow).numpy()
    assert np.array_equal(twin, want)
    # the generated C
    cols, sums = run_host(lib_, case.replace("-", "_"), planes, alive)
    assert np.array_equal(cols, want)
    nc = op.bins.n_cols
    if op.bins.count:
        assert np.array_equal(sums[:nc], jax_sums)
    else:
        np.testing.assert_allclose(sums[:nc], jax_sums, rtol=RTOL, atol=1e-6)
    # the plain version's sums
    row = torch.zeros(128)
    RC.run_binned(op.bins, op.prog, f, torch.from_numpy(alive), row)
    if op.bins.count:
        assert np.array_equal(row[:nc].double().numpy(), jax_sums)
    else:
        np.testing.assert_allclose(row[:nc].numpy(), jax_sums, rtol=RTOL,
                                   atol=1e-6)


def test_edge_cases_land_where_the_reference_puts_them():
    """The named cases, on the spectrum's float32 edges: a value on an
    edge in the upper bin, float64 edges colliding in float32 leave their
    bin empty, +inf in overflow, -inf in underflow, NaN and a dead slot in
    none."""
    b = F.Bins(tuple(float(np.float32(e)) for e in EDGES), True, True)
    e = torch.tensor(b.edges, dtype=torch.float32)
    nb = len(EDGES) - 1
    c = torch.tensor([e[1], e[2], e[5], np.inf, -np.inf, np.nan, e[1]],
                     dtype=torch.float32)
    alive = torch.tensor([True] * 6 + [False])
    got = RC.bin_columns(c, alive, e, True, True).tolist()
    # e[2] == e[3] (0.1 and 0.1 + 1e-10): bin 2 is empty, e[2] is in bin 3
    assert got == [1, 3, 6 if e[5] == e[6] else 5, nb + 1, nb, -1, -1]
    assert float(e[5]) == float(e[6]) == 1.0


def test_search_table_is_the_edges_in_order():
    """The table's in-order walk is the edges, then NaN; a search of it
    (binned.cuh's descent, here in Python) counts the edges at or below
    each value, as ``searchsorted`` does."""
    for n in (2, 3, 7, 8, 31, 57, 100):
        edges = np.sort(np.random.default_rng(n).uniform(-5, 5, n))
        b = F.Bins(tuple(float(np.float32(x)) for x in edges))
        t = b.search_table()
        assert t.size == (1 << b.levels) - 1 >= n > (1 << (b.levels - 1)) - 1
        order = []

        def walk(i):
            if i < t.size:
                walk(2 * i + 1)
                order.append(t[i])
                walk(2 * i + 2)

        walk(0)
        o = np.asarray(order, np.float32)
        assert np.array_equal(o[:n], np.asarray(b.edges, np.float32))
        assert np.isnan(o[n:]).all()
        for c in np.random.default_rng(0).uniform(-6, 6, 64).astype(
                np.float32):
            i = 0
            for _ in range(b.levels):
                i = 2 * i + 1 + int(t[i] <= c)
            assert i - t.size == np.searchsorted(np.asarray(b.edges,
                                                            np.float32),
                                                 c, side="right")


def test_plans_carry_a_binned_reduce():
    """chip_smoke.py's spectrum and mesh-tally plans lower every tally to
    a binned reduce: no per-bin record sum in their generated source; the
    user path's moments tally keeps its sums."""
    import chip_smoke as cs

    sims = {"spectrum": cs.spectrum_sim(T, 256, "cpu", iters=16)[0],
            "mesh-x-path": cs.user_plan_sim(T, "mesh-x-path", "cpu", n=256,
                                            chunk=16),
            "mesh-r-weighted": cs.user_plan_sim(T, "mesh-r-weighted", "cpu",
                                                n=256, chunk=16),
            "user": cs.user_sim(T, 256, "cpu", iters=16, chunk=16)[0]}
    for name, sim in sims.items():
        plan = cs.planned(sim)[1].plan
        src = CG.form_source(plan)
        reduces = [op for op in plan.ops if op.kind == "reduce"]
        assert reduces, name
        if name == "user":
            assert all(op.bins is None for op in reduces)
            assert "user_sum(acc, " in src
            continue
        assert all(op.bins is not None for op in reduces), name
        assert "user_sum(" not in src and "binned_op_" in src, name
        for op in reduces:
            assert not any(code == RC.U_ACC for code, *_ in op.prog.ins)
            assert op.bins.n_cols == len(op.bins.edges) - 1 + \
                op.bins.underflow + op.bins.overflow


def _mixed(P, out_fns=(None, None, None)):
    kw = dict(auto_shrink=False, **({"device": "cpu"} if P is T else {}))
    s = P.Simulation(until_t=DT * 32 * 0.9999, seed=5, chunk_steps=16, **kw)
    L = P.light
    c = float(L.c)
    c_dt = c * DT
    spec = L.SpectrumMeasureStep(out_fns[0], edges=np.exp(np.linspace(
        -1.0, 1.0, 13)), measure_n=True, underflow=True, overflow=True)

    def moments(p):
        return {"E": p.E, "r2": p.rx ** 2 + p.ry ** 2 + p.rz ** 2}

    user = P.ReduceMeasureStep(out_fns[1], moments, outputs=("E", "r2"),
                               measure_n=True)
    mesh = L.MeshTallyStep(out_fns[2], axis="r",
                           edges=np.linspace(0, 30, 11) * c_dt,
                           value="pathlength", weighted=True, overflow=True)
    steps = [P.UpdateTimeStep(lambda x: np.double(DT)),
             P.newton.NewtonianKinematicsStep(),
             L.ScatterComptonStep(A=0.2 / c_dt, n=1.0, mec2=4.0,
                                  theta_e=0.01),
             L.ScatterDeleteStep(1.0, 0.05 / c_dt, implicit_capture=True),
             spec, user, mesh]
    for i, st in enumerate(steps):
        s.add_step(i, st)
    rng = np.random.default_rng(7)
    n = 2048
    d = rng.normal(size=(3, n))
    s.add_photons(L.generate_photon_state(
        n, E=rng.uniform(0.4, 3.0, n), r=rng.normal(size=(3, n)) * 5 * c_dt,
        v=d / np.linalg.norm(d, axis=0) * c))
    return s, (spec, user, mesh)


def test_mixed_plan_matches_jax():
    """A spectrum (binned), a user moments tally (its sums) and a weighted
    path-length mesh tally (binned) in one plan, against the JAX package:
    t, n and the spectrum's counts exactly, the sums within rtol 1e-5."""
    rows = {}
    for P in (J, T):
        s, steps = _mixed(P)
        s.start()
        s.join()
        assert s.used_fused
        rows[P] = [np.asarray(st.data, np.float64) for st in steps]
    plan = _mixed(T)[0]
    import chip_smoke as cs

    ops = [op for op in cs.planned(plan)[1].plan.ops if op.kind == "reduce"]
    assert [op.bins is not None for op in ops] == [True, False, True]
    (js, ju, jm), (ts, tu, tm) = rows[J], rows[T]
    assert js.shape == ts.shape and js.shape[0] == 32
    assert np.array_equal(js, ts)  # t, n and every count
    assert ju.shape == tu.shape and np.array_equal(ju[:, :2], tu[:, :2])
    np.testing.assert_allclose(tu, ju, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tm, jm, rtol=RTOL, atol=1e-6)
    assert (ts[:, 2:].sum(1) == ts[:, 1]).all()
