"""Profiling: a device trace and a per-chunk timer.

Counterpart of ``physicl_tpu/utils/profiling.py``:

* :func:`trace` — a context manager around ``torch.profiler`` that records
  the host and, on a card, the CUDA kernels of everything run inside, and
  writes a Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``;
* :class:`ChunkTimerStep` — a step that records the wall time of each
  engine chunk (one host timestamp per chunk).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch

from physicl_tpu_torch.engine import Step

__all__ = ["trace", "ChunkTimerStep"]


@contextlib.contextmanager
def trace(log_dir: str):
    """``with profiling.trace("prof"): sim.start(); sim.join()`` writes
    ``prof/trace_<pid>_<ns>.json``. The profiler object is yielded
    (``key_averages()`` and the other ``torch.profiler.profile``
    accessors). CUDA activity (the kernels, on every thread) is recorded
    when a card is present; torch records host operators on the thread
    that entered the context only, so a run whose host side should show
    is driven there with ``sim.run()`` instead of ``start()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class ChunkTimerStep(Step):
    """Records ``(iterations, wall_s, photon_steps_per_s)`` per engine
    chunk. A host-side observer: ``apply`` is an identity that records one
    scalar so that the engine counts the valid iterations, and the timing
    happens in ``collect``. The fused prover has no op for it (code
    ``unsupported-step``, as the JAX prover's), so a run with one takes
    the generic tier in both packages."""

    mesh_records = {"tick": "once"}

    def __init__(self):
        super().__init__()
        self.data: List[tuple] = []
        self._last = None

    def setup(self, sim):
        self._last = time.perf_counter()

    def apply(self, state, ctx):
        ctx.record(self, "tick", state.t)
        return state

    def collect(self, sim, records):
        now = time.perf_counter()
        iters = len(records["tick"])
        wall = now - self._last
        self._last = now
        if iters:
            self.data.append(
                (iters, wall, sim._host_n_alive * iters / max(wall, 1e-9)))
