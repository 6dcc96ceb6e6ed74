"""Meshes across processes: two processes over gloo, two CPU shards each,
held against the port's one-process four-shard mesh and the JAX package's.

A module fixture writes a one-process checkpoint, starts the two workers
(this file run as a script: ``--worker RANK WORLD PORT OUTDIR CKPT``; they
import torch and the port, never JAX), computes the one-process references
while they run, and then waits for their results. Each scenario below is a
test case of its own that reads them: the fused main plan, generic
extinction and a generic plan with an undeclared drawing step bitwise
against the one-process mesh; the divergence guard on a one-sided injection
and on identical injections issued at different times; chunk-boundary
splits; an emitter recycling past arena exhaustion; the E-list on both
tiers; a shard-local trace; a restore; the placement and fetch helpers of
``parallel.distributed``. The fused scenarios (the main plan, splits,
recycling, the fused E-list, the trace and the restore) are also held
against the JAX package's one-process four-device mesh: integer records
equal, planes within 1e-4 of each plane's largest magnitude. Unit cases in
one process follow.
"""

import hashlib
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
import types
import warnings

import numpy as np
import pytest
import torch

if __name__ == "__main__":  # a worker: the repo root, not tests/
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import physicl_tpu_torch as T  # noqa: E402
import physicl_tpu_torch.light  # noqa: E402,F401
import physicl_tpu_torch.newton  # noqa: E402,F401
from physicl_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    fetch_to_every_host,
    init_distributed,
    is_multiprocess,
    local_shard_np,
    make_mesh,
    make_pod_mesh,
    process_local_slice,
    shard_state,
    shard_state_multiprocess,
)
from physicl_tpu_torch.parallel.sharding import shard_seed  # noqa: E402
from physicl_tpu_torch.state import SimState  # noqa: E402

WORLD = 2
SHARDS = 2               # per process
UNIT = WORLD * SHARDS * 16384
C = 299792458.0
DT = 0.001
STEP = C * DT
WORKER_LIMIT = 300       # seconds for the workers, the spawn included
COLLECTIVE_LIMIT = 90    # seconds a worker's collective waits


def _run(s):
    s.start()
    s.join()
    return s


def _sim(mesh, ctx, **kw):
    """A Simulation of the port on the CPU, or of the JAX package where
    ``ctx["P"]`` names it."""
    P = ctx.get("P", T)
    if P is not T:
        return P.Simulation(mesh=mesh, **kw)
    return T.Simulation(device="cpu", mesh=mesh, **kw)


def _planes(s, names=("r", "v", "E", "w", "alive")):
    st = s.sim_state
    return {k: np.array(getattr(st, k)) for k in names}


# -- the scenarios: each builds and runs one Simulation on ``mesh`` ----------
# (``ctx["P"]``, where given, is the package to build it from: the fused
# scenarios also run on the JAX package's mesh)


def sc_main(mesh, ctx):
    P = ctx.get("P", T)
    s = _sim(mesh, ctx, exit=lambda c: c.t >= 0.020, seed=4)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterIsotropicStep(A=0.001, n=0.001))
    meas = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, meas)
    s.add_photons(P.light.generate_photon_state(20000, E=1.0))
    _run(s)
    return {"data": np.asarray(meas.data), "ts": list(s.ts),
            "fused": s.used_fused, "planes": _planes(s)}


def sc_extinction(mesh, ctx):
    s = _sim(mesh, ctx, seed=1, fuse="off", chunk_steps=16)
    s.exit = lambda x: len(x.objects) == 0
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_step(2, T.light.ScatterDeleteStep(np.double(0.001),
                                            np.double(0.001)))
    meas = T.light.ScatterMeasureStep(None, True, [[1e6, np.nan, np.nan]])
    s.add_step(3, meas)
    s.add_photons(T.light.generate_photon_state(20000, E=1.0))
    _run(s)
    return {"data": np.asarray(meas.data), "ts": list(s.ts),
            "fused": s.used_fused, "left": len(s.objects)}


def sc_undeclared(mesh, ctx):
    """The generic tier with an emitter (undeclared: it takes global slots
    and draws its directions on the gathered planes with shard 0's
    generator) between shard-local steps that draw per shard."""
    s = _sim(mesh, ctx, until_t=10 * DT * 0.9999, seed=9, fuse="off",
             capacity=UNIT)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.light.PhotonEmitterStep(300, E=2.0, isotropic=True))
    s.add_step(2, T.newton.NewtonianKinematicsStep())
    s.add_step(3, T.light.ScatterIsotropicStep(A=0.001, n=0.001))
    meas = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(4, meas)
    s.add_photons(T.light.generate_photon_state(5000, E=1.0))
    _run(s)
    return {"data": np.asarray(meas.data), "ts": list(s.ts),
            "fused": s.used_fused, "planes": _planes(s)}


def _wait_running(s):
    while not s.running and s.is_alive():
        time.sleep(0.001)


def sc_guard_one_sided(mesh, ctx):
    """Rank 0 alone injects mid-run: the guard never applies it and, after
    ``divergence_patience`` stalled boundaries, raises on every process."""
    s = _sim(mesh, ctx, exit=lambda c: c.t >= 1.0, seed=2, chunk_steps=2,
             divergence_patience=20)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    s.add_photons(T.light.generate_photon_state(4096, E=1.0))
    s.start()
    _wait_running(s)
    if ctx["rank"] == 0:
        s.add_photons(T.light.generate_photon_state(4096, E=2.0))
    try:
        s.join()
    except RuntimeError as e:
        return {"error": str(e), "iterations": len(s.ts)}
    return {"error": None, "iterations": len(s.ts)}


def sc_guard_staggered(mesh, ctx):
    """Each process injects the same photons once its own clock passes a
    threshold of its own (25 boundaries apart): they apply at one boundary
    on both, and no unapplied-edit warning is given."""
    n = 4096
    s = _sim(mesh, ctx, exit=lambda c: c.t >= 0.2, seed=3, chunk_steps=2)
    s.add_step(0, T.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, T.newton.NewtonianKinematicsStep())
    sign = T.light.ScatterSignMeasureStep(None, True)
    s.add_step(2, sign)
    s.add_photons(T.light.generate_photon_state(n, E=1.0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s.start()
        threshold = 0.05 if ctx["rank"] == 0 else 0.1
        while float(s.get_state()["t"]) < threshold and s.is_alive():
            time.sleep(0.002)
        s.add_photons(T.light.generate_photon_state(n, E=2.0))
        s.join()
    return {"counts": np.array([int(r[1]) for r in sign.data]),
            "iterations": len(s.ts), "n": n, "fused": s.used_fused,
            "warnings": [str(w.message) for w in caught
                         if issubclass(w.category, RuntimeWarning)]}


def sc_split(mesh, ctx):
    P, floor = ctx.get("P", T), ctx.get("floor", torch.floor)
    K = 8
    s = _sim(mesh, ctx, until_t=3 * K * DT * 0.9999, seed=7, chunk_steps=K,
             capacity=UNIT)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** floor(x / (K * STEP) + 0.5),
        roulette=False, at="chunk"))
    s.add_photons(P.light.generate_photon_state(1024, E=1.0))
    _run(s)
    out = _planes(s)
    out.update(fused=s.used_fused, ts=list(s.ts))
    return out


def sc_recycle(mesh, ctx):
    """Emission of 100 x 2048 photons, three arenas, where every photon
    dies the iteration it moves: only recycling keeps the source going,
    and the census before the kill is exact."""
    P = ctx.get("P", T)
    s = _sim(mesh, ctx, until_t=100 * DT * 0.9999, seed=11, capacity=UNIT,
             chunk_steps=8)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.light.PhotonEmitterStep(2048, E=2.0))
    s.add_step(2, P.newton.NewtonianKinematicsStep())
    sign = P.light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_step(4, P.light.ScatterDeleteStep(np.double(1.0),
                                            np.double(1.0)))
    s.add_photons(P.light.generate_photon_state(1024, E=1.0))
    _run(s)
    return {"data": np.asarray(sign.data), "fused": s.used_fused,
            "log": list(getattr(s, "population_log", ()))}


E_TAG = (1.0 + np.arange(UNIT, dtype=np.float64) * 2.0 ** -16).astype(
    np.float32)  # f32-exact: the list's sum pins every photon


def sc_elist(mesh, ctx):
    P = ctx.get("P", T)
    out = {}
    for fuse in ctx.get("fuse", ("auto", "off")):
        s = _sim(mesh, ctx, until_t=6 * DT * 0.9999, seed=13, fuse=fuse)
        s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
        s.add_step(1, P.newton.NewtonianKinematicsStep())
        cross = P.light.ScatterMeasureStep(
            None, True, measure_locs=[np.array([2.5 * STEP, np.nan,
                                                np.nan])],
            measure_E=True)
        s.add_step(2, cross)
        s.add_photons(P.light.generate_photon_state(UNIT, E=E_TAG))
        _run(s)
        out[fuse] = {"counts": [int(r[2]) for r in cross.data],
                     "E": [np.asarray(r[3], np.float32) for r in cross.data],
                     "fused": s.used_fused}
    return out


TRACE_N = 36864  # both processes' spans hold photons


def sc_trace(mesh, ctx):
    P = ctx.get("P", T)
    x0 = np.arange(TRACE_N, dtype=np.float32)
    s = _sim(mesh, ctx, until_t=4 * DT * 0.9999, seed=17)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    path = (os.path.join(ctx["outdir"], f"trace{ctx['tag']}.csv")
            if P is T else None)  # the JAX reference: arrays only
    trace = P.light.TracePathMeasureStep(path)
    s.add_step(2, trace)
    z = np.zeros(TRACE_N, np.float32)
    s.add_photons(P.light.generate_photon_state(
        TRACE_N, E=1.0, r=np.stack([x0, z, z])))
    _run(s)
    ts, pos, alive, _ = trace.as_arrays()
    out = {"pos": np.asarray(pos), "alive": np.asarray(alive),
           "ts": list(s.ts), "fused": s.used_fused}
    if P is T:
        rows = trace.data
        suffix = f".p{ctx['rank']}" if mesh.spans_processes else ""
        out.update(col0=trace.col0, n_rows=len(rows), first_id=rows[1][0],
                   csv=os.path.exists(path + suffix))
    return out


def _layered(mesh, t_end, restore=None, ctx=None):
    ctx = ctx or {}
    P = ctx.get("P", T)
    nfn = P.light.layered_density(np.array([0.5, 3.5, 6.5]) * STEP,
                                  [1.0, 2.0])
    s = _sim(mesh, ctx, until_t=t_end * 0.9999, seed=0)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(DT)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(2, P.light.ScatterDeleteStep(
        np.double(1.0), np.double(0.2 / STEP), variable_n=True,
        variable_n_fn=nfn, implicit_capture=True))
    if restore is None:
        s.add_photons(P.light.generate_photon_state(512, E=1.0))
    else:
        s.restore_checkpoint(restore)
    return s


def sc_restore(mesh, ctx):
    s = _run(_layered(mesh, 0.008, restore=ctx["ckpt"], ctx=ctx))
    st = s.sim_state
    out = {"w": np.array(st.w)[:512], "r": np.array(st.r)[:, :512],
           "alive": np.array(st.alive)[:512], "ts": list(s.ts),
           "capacity": st.capacity, "fused": s.used_fused}
    if ctx.get("P", T) is not T:
        return out
    try:
        s.save_checkpoint(os.path.join(ctx["outdir"], f"re{ctx['tag']}.npz"))
        out["save"] = "saved"
    except NotImplementedError as e:
        out["save"] = str(e)
    return out


def sc_helpers(mesh, ctx):
    """``fetch_to_every_host``, ``local_shard_np`` and
    ``shard_state_multiprocess`` on ``mesh``: a channel whose columns are
    their global slot ids, and a population placed with a seed."""
    lo, size = process_local_slice(mesh, (UNIT,))
    ids = torch.arange(lo, lo + size, dtype=torch.int64).reshape(1, -1)
    host, col0 = local_shard_np(ids, mesh)
    st = SimState.from_population(
        [], [T.light.generate_photon_state(
            20000, E=np.arange(20000, dtype=np.float32))],
        device="cpu", capacity=UNIT)
    sh = shard_state_multiprocess(st, mesh, seed=5)
    return {"every": fetch_to_every_host(ids, mesh), "local": host,
            "col0": col0, "span": (lo, size),
            "E": [s.E.numpy().copy() for s in sh.shards],
            "draws": [torch.rand(4, generator=s.key).numpy()
                      for s in sh.shards],
            "same": shard_state_multiprocess(sh, mesh) is sh,
            "routed": [s.E.numpy().copy()
                       for s in shard_state(st, mesh, seed=5).shards]}


SCENARIOS = {"main": sc_main, "extinction": sc_extinction,
             "undeclared": sc_undeclared,
             "guard_one_sided": sc_guard_one_sided,
             "guard_staggered": sc_guard_staggered, "split": sc_split,
             "recycle": sc_recycle, "elist": sc_elist, "trace": sc_trace,
             "restore": sc_restore, "helpers": sc_helpers}
# the ones with a one-process reference
REFERENCED = ("main", "extinction", "undeclared", "split", "recycle",
              "elist", "trace", "restore")
# the ones also run on the JAX package's four-device mesh (fused tier)
JAX_REFERENCED = ("main", "split", "recycle", "elist", "trace", "restore")


def _each(names, mesh, ctx):
    out = {}
    for name in names:
        try:
            out[name] = SCENARIOS[name](mesh, ctx)
        except Exception:  # noqa: BLE001 - the case reading it fails
            out[name] = {"traceback": traceback.format_exc()}
    return out


def _worker(rank, world, port, outdir, ckpt):
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", world, rank,
                     timeout=COLLECTIVE_LIMIT)
    mesh = make_pod_mesh(devices=["cpu"] * SHARDS)
    info = {"mesh": repr(mesh), "local": (mesh.local.start, mesh.local.stop),
            "multiprocess": is_multiprocess()}
    ctx = {"rank": rank, "outdir": outdir, "ckpt": ckpt, "tag": ""}
    res = _each(SCENARIOS, mesh, ctx)
    res["info"] = info
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


# -- the fixture --------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Run:
    def __init__(self, procs, outdir, refs, jax_refs):
        self.procs, self.outdir = procs, outdir
        self.refs, self.jax_refs = refs, jax_refs
        self._res = None

    def results(self):
        if self._res is None:
            deadline = time.monotonic() + WORKER_LIMIT
            outs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    pytest.fail(f"the workers ran past {WORKER_LIMIT} s")
                outs.append(out)
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"worker {r} failed:\n{out}"
            self._res = []
            for r in range(WORLD):
                with open(os.path.join(self.outdir, f"rank{r}.pkl"),
                          "rb") as f:
                    self._res.append(pickle.load(f))
        return self._res

    def scenario(self, name):
        """The scenario's result on each rank; a worker's traceback fails
        the case."""
        got = [r[name] for r in self.results()]
        for r, g in enumerate(got):
            assert "traceback" not in g, f"rank {r}:\n{g['traceback']}"
        return got

    def ref(self, name):
        g = self.refs[name]
        assert "traceback" not in g, g["traceback"]
        return g

    def jax(self, name):
        g = self.jax_refs[name]
        assert "traceback" not in g, g["traceback"]
        return g


def _jax_refs(ctx):
    """The fused scenarios on the JAX package's one-process four-device
    mesh (the conftest's virtual CPU devices)."""
    try:
        import jax.numpy as jnp

        import physicl_tpu as J
        import physicl_tpu.light  # noqa: F401
        import physicl_tpu.newton  # noqa: F401
        from physicl_tpu.parallel import make_mesh as j_mesh
    except Exception:  # noqa: BLE001 - each case reading it fails
        tb = traceback.format_exc()
        return {n: {"traceback": tb} for n in JAX_REFERENCED}
    jctx = dict(ctx, P=J, floor=jnp.floor, fuse=("auto",))
    return _each(JAX_REFERENCED, j_mesh(WORLD * SHARDS), jctx)


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mp"))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ckpt = os.path.join(outdir, "solo.npz")
        _run(_layered(None, 0.004)).save_checkpoint(ckpt)
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(WORLD), str(port), outdir, ckpt],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(WORLD)]
        try:
            # the one-process references while the workers run
            ctx = {"rank": 0, "outdir": outdir, "ckpt": ckpt, "tag": "-ref"}
            refs = _each(REFERENCED, make_mesh(WORLD * SHARDS,
                                               devices=["cpu"]), ctx)
            jax_refs = _jax_refs(dict(ctx, tag="-jax"))
        except BaseException:
            for p in procs:
                p.kill()
            raise
        yield _Run(procs, outdir, refs, jax_refs)
        for p in procs:
            if p.poll() is None:
                p.kill()
    finally:
        torch.set_num_threads(n_threads)


# -- the scenarios' cases ----------------------------------------------------


def _same_on_both_ranks(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_on_both_ranks(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_on_both_ranks(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _assert_close_to_max(got, want, what=""):
    """Within 1e-4 of the plane's largest magnitude (NaN, a trace's dead
    slot, where the other has NaN)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    got, want = got[~nan], want[~nan]
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert np.abs(got - want).max(initial=0.0) <= 1e-4 * scale, what


def _same_clock(got, want):
    assert (np.asarray(got, np.float32).tobytes()
            == np.asarray(want, np.float32).tobytes())


def _close_to_jax(got, want):
    """Planes against the JAX package's: integer and boolean planes equal,
    float planes within 1e-4 of each plane's largest magnitude."""
    assert got.keys() == want.keys()
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            _assert_close_to_max(g, w, k)


def test_mesh_spans_both_processes(mp):
    """Each worker holds a contiguous half of the four-shard pod mesh."""
    infos = [r["info"] for r in mp.results()]
    assert [i["local"] for i in infos] == [(0, 2), (2, 4)]
    assert all(i["multiprocess"] for i in infos)
    assert "owners=[0, 0, 1, 1]" in infos[0]["mesh"]


def test_fused_main_plan_matches_one_process_and_jax(mp):
    """The sign records, sim.ts and final planes equal the one-process
    mesh's bitwise on both ranks; the integer records equal the JAX
    package's four-device mesh's and the planes agree with it within 1e-4
    of each plane's largest magnitude."""
    a, b = mp.scenario("main")
    ref = mp.ref("main")
    _same_on_both_ranks(a, b)
    assert a["fused"] and ref["fused"]
    np.testing.assert_array_equal(a["data"], ref["data"])
    assert a["ts"] == ref["ts"]
    _same_on_both_ranks(a["planes"], ref["planes"])
    assert int(a["data"][0][1]) == 20000
    jx = mp.jax("main")
    assert jx["fused"]
    np.testing.assert_array_equal(a["data"], jx["data"])
    _same_clock(a["ts"], jx["ts"])
    _close_to_jax(a["planes"], jx["planes"])


def test_generic_extinction_matches_one_process(mp):
    a, b = mp.scenario("extinction")
    ref = mp.ref("extinction")
    _same_on_both_ranks(a, b)
    assert not a["fused"] and a["left"] == 0
    assert a["ts"] == ref["ts"]
    np.testing.assert_array_equal(a["data"], ref["data"])
    assert int(a["data"][-1][1]) == 0 and len(a["ts"]) > 16


def test_undeclared_drawing_step_matches_one_process(mp):
    """An emitter on the generic tier draws on the gathered planes with
    shard 0's generator, broadcast from its owner: the run equals the
    one-process mesh's bitwise."""
    a, b = mp.scenario("undeclared")
    ref = mp.ref("undeclared")
    _same_on_both_ranks(a, b)
    assert not a["fused"]
    np.testing.assert_array_equal(a["data"], ref["data"])
    _same_on_both_ranks(a["planes"], ref["planes"])
    assert int(a["data"][-1][1]) == 5000 + 10 * 300


def test_one_sided_injection_raises_on_both(mp):
    for g in mp.scenario("guard_one_sided"):
        assert g["error"] is not None and "divergence" in g["error"], g
        assert "(1, 0), (0, 0)" in g["error"]


def test_staggered_identical_injections_apply_at_one_boundary(mp):
    a, b = mp.scenario("guard_staggered")
    for g in (a, b):
        assert g["fused"] and g["iterations"] == 200
        assert not g["warnings"], g["warnings"]
        c, n = g["counts"], g["n"]
        assert c[0] == n and c[-1] == 2 * n
        assert set(np.unique(c)) == {n, 2 * n}
        # the count steps N -> 2N exactly once
        assert int((np.diff(c) != 0).sum()) == 1
    np.testing.assert_array_equal(a["counts"], b["counts"])


def test_chunk_boundary_split_matches_one_process(mp):
    a, b = mp.scenario("split")
    ref = mp.ref("split")
    _same_on_both_ranks(a, b)
    assert a["fused"]
    _same_on_both_ranks(a, ref)
    assert int(a["alive"].sum()) == 1024 * 2 ** 2
    np.testing.assert_allclose(a["w"][a["alive"]].sum(), 1024.0, rtol=1e-5)
    jx = mp.jax("split")
    assert jx["fused"]
    _same_clock(a["ts"], jx["ts"])
    _close_to_jax({k: a[k] for k in ("r", "v", "E", "w", "alive")},
                  {k: jx[k] for k in ("r", "v", "E", "w", "alive")})


def test_emitter_recycles_past_arena_exhaustion(mp):
    a, b = mp.scenario("recycle")
    ref = mp.ref("recycle")
    _same_on_both_ranks(a, b)
    assert a["fused"]
    ns = [int(r[1]) for r in a["data"]]
    assert len(ns) == 100 and ns[0] == 1024 + 2048
    assert ns[1:] == [2048] * 99
    assert [e[0] for e in a["log"]].count("recycle") >= 2
    np.testing.assert_array_equal(a["data"], ref["data"])
    assert a["log"] == ref["log"]
    jx = mp.jax("recycle")
    assert jx["fused"]
    np.testing.assert_array_equal(a["data"], jx["data"])


def test_elist_complete_on_every_rank(mp):
    a, b = mp.scenario("elist")
    ref = mp.ref("elist")
    _same_on_both_ranks(a, b)
    for fuse in ("auto", "off"):
        g = a[fuse]
        assert g["fused"] == (fuse == "auto")
        assert g["counts"] == [0, 0, UNIT, 0, 0, 0]
        Es = g["E"][2].astype(np.float64)
        assert Es.shape == (UNIT,)
        assert Es.sum() == E_TAG.astype(np.float64).sum()
        np.testing.assert_array_equal(g["E"][2], E_TAG)  # global slot order
        _same_on_both_ranks(g, ref[fuse])
    jx = mp.jax("elist")["auto"]
    assert jx["fused"] and jx["counts"] == a["auto"]["counts"]
    for got, want in zip(a["auto"]["E"], jx["E"]):
        np.testing.assert_array_equal(got, want)


def test_trace_is_shard_local(mp):
    """Each rank assembles its span with global slot ids, writes its own
    .p{rank} CSV, and its columns equal the one-process trace's."""
    ref = mp.ref("trace")
    jx = mp.jax("trace")
    span = UNIT // WORLD
    for rank, g in enumerate(mp.scenario("trace")):
        lo = rank * span
        assert jx["fused"] and jx["pos"].shape == (4, 3, UNIT)
        _same_clock(g["ts"], jx["ts"])
        np.testing.assert_array_equal(g["alive"],
                                      jx["alive"][:, lo:lo + span])
        _assert_close_to_max(g["pos"], jx["pos"][..., lo:lo + span])
        assert g["fused"] and g["csv"]
        assert g["col0"] == rank * span
        assert g["pos"].shape == (4, 3, span)
        lo = g["col0"]
        np.testing.assert_array_equal(g["pos"], ref["pos"][..., lo:lo + span])
        np.testing.assert_array_equal(g["alive"],
                                      ref["alive"][:, lo:lo + span])
        n_own = min(TRACE_N, lo + span) - lo
        assert g["n_rows"] == 1 + n_own
        assert g["first_id"] == str(lo)
        assert g["alive"][:, :n_own].all() and not g["alive"][:, n_own:].any()


def test_restore_onto_two_processes_equals_uninterrupted(mp):
    """A one-process checkpoint restored onto the pod mesh continues as
    the uninterrupted run (implicit capture: no draw); saving the run's
    state across processes is refused by name, as in the JAX package."""
    a, b = mp.scenario("restore")
    ref = mp.ref("restore")
    _same_on_both_ranks(a, b)
    assert ref["save"] == "saved"
    assert "spans processes" in a["save"]
    assert a["capacity"] == UNIT and len(a["ts"]) == 8
    unbroken = _run(_layered(make_mesh(WORLD * SHARDS, devices=["cpu"]),
                             0.008))
    np.testing.assert_array_equal(a["w"], unbroken.sim_state.w.numpy()[:512])
    np.testing.assert_array_equal(a["r"],
                                  unbroken.sim_state.r.numpy()[:, :512])
    assert a["ts"] == list(unbroken.ts)
    # the JAX package runs a restored run on its generic scan (its prover
    # refuses it as "empty-population": no objects were added); implicit
    # capture draws nothing, so the tiers agree
    jx = mp.jax("restore")
    assert a["fused"] and jx["capacity"] == UNIT
    _same_clock(a["ts"], jx["ts"])
    _close_to_jax({k: a[k] for k in ("r", "w", "alive")},
                  {k: jx[k] for k in ("r", "w", "alive")})


def test_placement_and_fetch_helpers_across_processes(mp):
    """``local_shard_np`` gives each rank its span and its first global
    column, ``fetch_to_every_host`` the whole channel on every rank, and
    ``shard_state_multiprocess`` (which ``shard_state`` routes to) each
    rank's shards of the replicated population with the one-process mesh's
    generators; an already placed state comes back as it is."""
    one = make_mesh(WORLD * SHARDS, devices=["cpu"])
    st = SimState.from_population(
        [], [T.light.generate_photon_state(
            20000, E=np.arange(20000, dtype=np.float32))],
        device="cpu", capacity=UNIT)
    whole = shard_state(st, one, seed=5)
    span = UNIT // WORLD
    for rank, g in enumerate(mp.scenario("helpers")):
        assert g["span"] == (rank * span, span) and g["col0"] == rank * span
        np.testing.assert_array_equal(
            g["local"], np.arange(rank * span, (rank + 1) * span)[None])
        np.testing.assert_array_equal(g["every"], np.arange(UNIT)[None])
        assert g["same"] and len(g["E"]) == SHARDS
        for j, (E, routed) in enumerate(zip(g["E"], g["routed"])):
            ref = whole.shards[rank * SHARDS + j]
            np.testing.assert_array_equal(E, ref.E.numpy())
            np.testing.assert_array_equal(routed, ref.E.numpy())
            want = torch.rand(4, generator=SimState.make_key(
                shard_seed(5, rank * SHARDS + j), "cpu")).numpy()
            np.testing.assert_array_equal(g["draws"][j], want)


# -- unit cases in one process ------------------------------------------------


def test_helpers_in_one_process_fetch_and_place_everything():
    """Off a mesh that spans processes the helpers make no collective:
    the whole channel from column 0, and ``shard_state``'s placement."""
    x = torch.arange(12).reshape(3, 4)
    mesh = make_mesh(4, devices=["cpu"])
    for m in (None, mesh):
        np.testing.assert_array_equal(fetch_to_every_host(x, m), x.numpy())
        host, col0 = local_shard_np(x, m)
        assert col0 == 0
        np.testing.assert_array_equal(host, x.numpy())
    st = SimState.from_population(
        [], [T.light.generate_photon_state(100, E=1.0)], device="cpu",
        capacity=UNIT)
    a, b = shard_state_multiprocess(st, mesh, seed=3), shard_state(st, mesh,
                                                                   seed=3)
    assert len(a.shards) == len(b.shards) == 4
    for x, y in zip(a.shards, b.shards):
        assert torch.equal(x.r, y.r) and torch.equal(x.alive, y.alive)
        assert torch.equal(x.key.get_state(), y.key.get_state())
    with pytest.raises(ValueError, match="does not divide"):
        shard_state_multiprocess(st, make_mesh(3, devices=["cpu"]))


def test_pod_mesh_outside_a_group_is_make_mesh():
    assert not is_multiprocess()
    assert make_pod_mesh(devices=["cpu"]) == make_mesh(devices=["cpu"])
    mesh = make_pod_mesh(devices=["cpu", "cpu"])
    assert not mesh.spans_processes and list(mesh.local) == [0, 1]


def test_process_local_slice_refusals():
    assert process_local_slice(make_mesh(4, devices=["cpu"]),
                               (UNIT,)) == (0, UNIT)
    pod = Mesh(["cpu"] * 4, owners=[0, 0, 1, 1], rank=1)
    assert process_local_slice(pod, (UNIT,)) == (UNIT // 2, UNIT // 2)
    with pytest.raises(ValueError, match="does not divide"):
        process_local_slice(make_mesh(3, devices=["cpu"]), (UNIT,))
    scattered = types.SimpleNamespace(owners=(0, 1, 0, 1), rank=0)
    with pytest.raises(ValueError, match="ICI-major"):
        process_local_slice(scattered, (UNIT,))
    with pytest.raises(ValueError, match="contiguous"):
        Mesh(["cpu"] * 4, owners=[0, 1, 0, 1])


def test_hash_edits_is_deterministic():
    from physicl_tpu_torch.population import PopulationManager

    def digest(items, removes):
        h = hashlib.blake2b(digest_size=8)
        PopulationManager._hash_edits(h, items, removes)
        return h.hexdigest()

    bulk = T.light.generate_photon_state(64, E=1.0)
    same = T.light.generate_photon_state(64, E=1.0)
    other = T.light.generate_photon_state(64, E=2.0)
    obj = T.light.PhotonObject(r=np.zeros(3), v=np.array([C, 0.0, 0.0]),
                               E=1.0)
    assert (digest([("bulk", bulk), ("obj", obj)], [3, 1])
            == digest([("bulk", same), ("obj", obj)], [1, 3]))
    assert digest([("bulk", bulk)], []) != digest([("bulk", other)], [])
    assert digest([("bulk", bulk)], []) != digest([], [])
    assert digest([], [1]) != digest([], [2])


@pytest.mark.parametrize("how", ["arguments", "torchrun-variables"])
def test_init_distributed_maps_its_arguments(how, monkeypatch):
    """A one-process gloo group from ``"host:port"`` or from torchrun's
    variables, torn down after."""
    from physicl_tpu_torch.parallel import distributed as D

    port = _free_port()
    dist = torch.distributed
    try:
        if how == "arguments":
            init_distributed(f"localhost:{port}", 1, 0, timeout=30)
        else:
            for k, v in (("MASTER_ADDR", "localhost"),
                         ("MASTER_PORT", str(port)), ("RANK", "0"),
                         ("WORLD_SIZE", "1")):
                monkeypatch.setenv(k, v)
            init_distributed(timeout=30)
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_rank() == 0 and dist.get_backend() == "gloo"
        assert not is_multiprocess() and not D.device_collectives()
        assert make_pod_mesh(devices=["cpu"]) == make_mesh(devices=["cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_distributed_needs_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        r, w, p, out, ck = sys.argv[2:7]
        _worker(int(r), int(w), int(p), out, ck)
