"""Profiling: ``utils.profiling.trace`` and ``ChunkTimerStep``.

``ChunkTimerStep`` records ``(iterations, wall seconds, photon-steps/s)``
per engine chunk. The fused prover of either package has no op for it and
refuses it with the same code, ``unsupported-step``, so a run with one
takes the generic tier in both. ``trace(log_dir)`` records a
``torch.profiler`` trace (the CPU here, the CUDA kernels too on a card)
and writes it as a Chrome trace into ``log_dir``.
"""

import json
import os
import warnings

import numpy as np
import pytest

import physicl_tpu as J
import physicl_tpu.light  # noqa: F401
import physicl_tpu.newton  # noqa: F401
from physicl_tpu.utils.profiling import ChunkTimerStep as JTimer
import physicl_tpu_torch as T
import physicl_tpu_torch.light  # noqa: F401
import physicl_tpu_torch.newton  # noqa: F401
from physicl_tpu_torch.utils import profiling


def _sim(P, timer, **kw):
    s = P.Simulation(exit=lambda c: c.t >= 0.005, seed=0, chunk_steps=2,
                     **kw)
    s.add_step(0, P.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, P.newton.NewtonianKinematicsStep())
    s.add_step(9, timer)
    s.add_photons(P.light.generate_photon_state(500, E=1.0))
    return s


def test_chunk_timer_rows_and_tier():
    """One row per chunk, their iterations summing to the run's; both
    packages refuse the step with the same code and run it generic."""
    out = {}
    for P, Timer, kw in ((J, JTimer, {}),
                         (T, profiling.ChunkTimerStep, {"device": "cpu"})):
        timer = Timer()
        s = _sim(P, timer, **kw)
        with warnings.catch_warnings(record=True) as wl:
            warnings.simplefilter("always")
            s.start()
            s.join()
        out[P] = (s, timer, [str(x.message) for x in wl])
    (js, jt, jw), (ts, tt, tw) = out[J], out[T]
    assert not js.used_fused and not ts.used_fused
    assert any("[unsupported-step]: ChunkTimerStep" in m for m in jw)
    assert any("[unsupported-step]: ChunkTimerStep" in m for m in tw)
    assert [r[0] for r in tt.data] == [r[0] for r in jt.data] == [2, 2, 1]
    assert sum(r[0] for r in tt.data) == len(ts.ts) == 5
    for iters, wall, rate in tt.data:
        assert wall > 0 and rate == pytest.approx(500 * iters / wall)


def test_trace_writes_a_chrome_trace(tmp_path):
    """A run driven on the calling thread (``sim.run()``, the thread's
    body) shows its generic tier's ops in the file; one driven through
    ``start()`` / ``join()`` still writes a trace (torch's CPU activity
    follows the thread that started the profiler, its CUDA activity every
    thread)."""
    log_dir = str(tmp_path / "prof")
    s = _sim(T, profiling.ChunkTimerStep(), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # [unsupported-step]
        with profiling.trace(log_dir) as prof:
            s.run()
        assert len(s.ts) == 5 and prof.key_averages() is not None
        files = os.listdir(log_dir)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(os.path.join(log_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::" in e.get("name", "") for e in events)
        s = _sim(T, profiling.ChunkTimerStep(), device="cpu")
        with profiling.trace(log_dir):
            s.start()
            s.join()
    assert len(os.listdir(log_dir)) == 2 and len(s.ts) == 5
